#!/usr/bin/env python3
"""Drive the PyTorch port (``calfkit_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failed check raises, so the exit code is non-zero and
the final ``ok`` line is never printed:

1. print the card's name and power limit; build the hand-written kernels
   from ``calfkit_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. kernel phase: every kernel against its plain PyTorch version on the card
   at the serving paths' shapes (the prefill kernel on whole prompts, on
   the chunk lane's 512-token chunks at offsets 0, 512 and 1024 of a
   bucket's scratch, and at the draft model's one-token forwards of 16 rows
   over its 2048 window), with its time, the plain version's time,
   one PyTorch library call computing the same function
   (``scaled_dot_product_attention``; for the paged kernel, which no single
   call matches, SDPA on a window gathered beforehand and gather + SDPA) and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the type's peak rate);
3. exactness phase: the engine at Llama-3-8B widths, f32, 4 layers, greedy:
   dense overlapped and lockstep streams are identical and equal a
   step-by-step greedy recompute through ``model.forward`` with the plain
   attention; then the paged engine (page 64, chunk 128, chunked prefill,
   prefix cache, ragged waves) serves requests sharing a 256-token prefix in
   two bursts, the second reusing the first's pages, and its streams equal
   the dense lockstep engine's and the recompute;
4. serving phase: the full ``llama-3-8b`` preset in bf16 with random weights
   from a seed, dense KV: 6 concurrent requests through the dense decode and
   prefill kernels (launch counts reset just before and read just after),
   then the same 6 with a stop token on one; prints TTFT and decode tokens/s;
5. paged serving phase: the same model, paged KV with the prefix cache and
   chunked ragged admission, agent-shaped traffic: 4 requests of one shared
   1024-token instruction prefix, then, while those decode, 4 more of it and
   2 unrelated prompts; the paged decode and prefill kernels run (counts
   reset just before, read just after), the second burst reuses the prefix
   pages, and after ``stop()`` every page is free or cached; it prints the
   prefill kernel's launches tallied by (B, Sq, Skv) and the paged decode
   kernel's by (B, wpages);
6. speculative serving phases, the same model: the paged phase again with
   ``SpecConfig(k=4)`` and the target's own weights as the draft model
   (every verify through the paged ragged kernel, no decode kernel), then
   dense KV with the n-gram drafter, the serving phase's 6 requests (every
   verify through the dense ragged kernel); each prints TTFT, tokens/s, the
   acceptance rate, tokens per verify dispatch and the ragged launches
   tallied by shape (B, S, window);
7. the paged decode kernel and each ragged kernel against its plain
   version again, at the shape its serving phase launched most, with the kv
   lengths of that shape's last launch and q in bf16, as serving passes it:
   the case the ``kernels`` line reports.

The kernel phase also holds the ragged multi-query kernels (speculative
verify shapes S = 5, a mixed-row case with prefill-kind and fresh rows, page
16, f32) against their plain versions, and times the fixed cases the
split-window decode and ragged kernels are judged on from tree to tree: the
dense spec phase's path shape (B=8, S=5, W=2048 at ``PATH_LENS``) and a lone
agent turn (B=1, len 2000 of a 2048 window), each with f32 q and with q in
bf16 as serving passes it.  The decode kernels and the paged ragged kernel
are also held at their serving shapes with bf16 q (the ``kernels`` line
reports the dense decode kernel there), and the paged kernels at their
serving paths' shapes (``PAGED_PATH_LENS``, ``SPEC_PAGED_PATH_LENS``: fixed
copies of a run's, so two trees are timed on the same inputs) and at
skewed batches (``WALK_LENS``), which their walk balances by length.  The
exactness phase serves the
dense and the paged+prefix configurations again with speculation on (draft
model = target), whose streams must equal the spec-off streams.

The line before the last is ``nvidia-smi``'s name and power limit; the
``kernels`` JSON line precedes it; the last line is the ``ok`` JSON object.
``--out`` also writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from calfkit_tpu_torch import kernels
from calfkit_tpu_torch.inference import attention as A
from calfkit_tpu_torch.inference import model as M
from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig, preset
from calfkit_tpu_torch.inference.engine import EngineStats, InferenceEngine
from calfkit_tpu_torch.inference.sampler import SamplingParams

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor-core bf16; f32 CUDA cores
SOURCES = {
    "decode_attention": (
        "calfkit_tpu_torch/csrc/decode_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:60",
    ),
    "paged_decode_attention": (
        "calfkit_tpu_torch/csrc/decode_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:153",
    ),
    "prefill_attention": (
        "calfkit_tpu_torch/csrc/prefill_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:687",
    ),
    "ragged_attention": (
        "calfkit_tpu_torch/csrc/ragged_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:357",
    ),
    "ragged_attention_paged": (
        "calfkit_tpu_torch/csrc/ragged_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:467",
    ),
}
# kernel vs plain version: both accumulate in f32 from the same inputs; the
# tolerances cover the sum order over up to 2048 positions, and for a bf16
# prefill the kernel's bf16 rounding of the probabilities it feeds the
# tensor cores (2**-9 relative each) plus one bf16 rounding of the output
# (2**-8 relative)
DECODE_TOL = dict(atol=1e-4, rtol=1e-4)
PREFILL_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, after two warm-up calls: CUDA events
    around each of ``iters`` calls, with the L2 cache flushed before each,
    as the serving path finds it after the other layers' reads.  Host-side
    launch cost is not included."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > 50 MB of L2
    for _ in range(2):
        fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    torch.cuda.synchronize()
    # hold the card while the host enqueues every call, so no host-side
    # launch cost falls between a pair of events
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _sdpa_ms(q, k, v, mask=None, causal=False) -> float:
    return time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True
    ))


# --------------------------------------------------------------------------- #
# kernel phase
# --------------------------------------------------------------------------- #


def decode_case(dev, dtype, B, K, G, hd, W, lens, seed, q_dtype=torch.float32):
    """The dense decode kernel on a [:, :, :W] view of a longer cache, q in
    ``q_dtype`` (f32 unless noted in the shape; serving passes the model's
    dtype)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, G, hd), generator=g, device=dev).to(q_dtype)
    # the engine passes a [:, :, :W] view of a longer cache: so does this
    cache = torch.randn((2, B, K, 2 * W, hd), generator=g, device=dev).to(dtype)
    k, v = cache[0, :, :, :W], cache[1, :, :, :W]
    base = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, base)
    ref = A.decode_attention_reference(q, k, v, base)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    valid = sum(min(n, W) for n in lens)
    nbytes = 2 * valid * K * hd * cache.element_size() + _nbytes(q, base, *out)
    ops = 4 * hd * G * K * valid
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    mask = (torch.arange(W, device=dev)[None, :] < base[:, None])[:, None, None, :]
    qs = q.reshape(B, 1, K * G, hd).transpose(1, 2).to(dtype)
    shape = dict(B=B, K=K, G=G, hd=hd, W=W, dtype=str(dtype))
    if q_dtype != torch.float32:
        shape["q_dtype"] = str(q_dtype)
    if B == 1:
        shape["lens"] = list(lens)
    return dict(
        name="decode_attention", shape=shape,
        max_abs_err=err, tol=DECODE_TOL,
        ms=time_ms(lambda: A.decode_attention(q, k, v, base)),
        plain_ms=time_ms(lambda: A.decode_attention_reference(q, k, v, base), iters=5),
        library_ms=_sdpa_ms(qs, k, v, mask=mask),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def _shuffled_pool(dev, dtype, g, K, hd, page, lens, wpages, seed):
    """A 2-layer pool of random values whose rows' pages are shuffled,
    non-contiguous ids (the trash page past each row's pages) → (pool_k,
    pool_v, tables [B, wpages], n_pages)."""
    B = len(lens)
    n_pages = 1 + B * wpages
    pool_k = torch.randn((2, n_pages, K, page, hd), generator=g, device=dev).to(dtype)
    pool_v = torch.randn((2, n_pages, K, page, hd), generator=g, device=dev).to(dtype)
    ids = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    tables = np.zeros((B, wpages), np.int32)
    for b, n in enumerate(lens):
        need = -(-n // page)
        tables[b, :need] = ids[b * wpages:b * wpages + need]
    return pool_k, pool_v, torch.from_numpy(tables).to(dev), n_pages


def paged_decode_case(dev, dtype, B, K, G, hd, page, lens, wpages, seed, layer=1,
                      q_dtype=torch.float32, rows=None):
    """The paged kernel on a shuffled 2-layer pool, at layer 1; q in
    ``q_dtype``, as :func:`decode_case`; ``rows`` labels the row lengths
    where they are not ``PAGED_LENS``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, G, hd), generator=g, device=dev).to(q_dtype)
    pool_k, pool_v, tables, n_pages = _shuffled_pool(dev, dtype, g, K, hd, page, lens, wpages, seed)
    base = torch.tensor(lens, dtype=torch.int32, device=dev)

    def kernel():
        return A.paged_decode_attention(q, pool_k, pool_v, layer, tables, base, wpages=wpages)

    def plain():
        return A.paged_decode_attention_reference(
            q, pool_k, pool_v, layer, tables, base, wpages=wpages
        )

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    W = wpages * page
    valid = sum(min(n, W) for n in lens)
    table_bytes = 4 * sum(-(-min(n, W) // page) for n in lens)
    nbytes = 2 * valid * K * hd * pool_k.element_size() + table_bytes + _nbytes(q, base, *out)
    ops = 4 * hd * G * K * valid
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    mask = (torch.arange(W, device=dev)[None, :] < base[:, None])[:, None, None, :]
    qs = q.reshape(B, 1, K * G, hd).transpose(1, 2).to(dtype)

    def gather():
        return (
            M.gather_window_paged(pool_k[layer], tables, wpages),
            M.gather_window_paged(pool_v[layer], tables, wpages),
        )

    kw, vw = gather()
    shape = dict(B=B, K=K, G=G, hd=hd, page=page, wpages=wpages, pool_pages=n_pages,
                 dtype=str(dtype))
    if rows:
        shape["rows"] = rows
    if q_dtype != torch.float32:
        shape["q_dtype"] = str(q_dtype)
    return dict(
        name="paged_decode_attention", shape=shape,
        max_abs_err=err, tol=DECODE_TOL,
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        # no single PyTorch call reads K/V through block tables
        library_ms=None,
        sdpa_gathered_ms=_sdpa_ms(qs, kw, vw, mask=mask),  # gather excluded
        gather_sdpa_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, *gather(), attn_mask=mask, enable_gqa=True
        )),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def prefill_case(dev, dtype, R, S, H, K, hd, seed, offset=0, Skv=None, lens=None):
    """``R`` rows of ``S`` queries at positions ``offset``.. against a cache
    of ``Skv`` positions (default ``S``), ``offset + S`` of them valid: a
    whole prompt from position 0, or a chunk of the chunk lane, whose
    scratch holds the wave's whole bucket.  With ``lens`` (one a row), row
    b's queries end at its len instead (a row of len 0 sees nothing) and
    K/V are a layer of a [2, R, K, Skv, hd] cache: the draft model's
    forwards over its window."""
    Skv = S if Skv is None else Skv
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((R, S, H, hd), generator=g, device=dev).to(dtype)
    if lens is None:
        k = torch.randn((R, K, Skv, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((R, K, Skv, hd), generator=g, device=dev).to(dtype)
        pos = (offset + torch.arange(S, dtype=torch.int32, device=dev)).expand(R, S).contiguous()
        lens_t = torch.full((R,), offset + S, dtype=torch.int32, device=dev)
    else:
        cache = torch.randn((2, R, K, Skv, hd), generator=g, device=dev).to(dtype)
        k, v = cache[0], cache[1]
        pos = torch.tensor([[max(n, S) - S + j for j in range(S)] for n in lens],
                           dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = A.prefill_attention(q, k, v, pos, lens_t)
    ref = A.prefill_attention_reference(q, k, v, pos, lens_t)
    torch.cuda.synchronize()
    # query (b, s) keeps min(q_pos + 1, len, Skv) positions; row b reads
    # the K/V of the most any of its queries keeps.  A query that keeps none
    # gives 0 (the kernels' law; an earlier tree's plain version gave the
    # mean of v there), so the plain version is held on the others
    seen = torch.minimum(pos + 1, lens_t.clamp(max=Skv)[:, None]).clamp(min=0)
    blind = seen == 0
    assert torch.all(out[blind] == 0), "a query that sees no position must give 0"
    err = float((out[~blind].float() - ref[~blind].float()).abs().max())
    torch.testing.assert_close(out[~blind].float(), ref[~blind].float(), **PREFILL_TOL[dtype])
    ops = 4 * hd * H * int(seen.sum())
    kv_bytes = 2 * K * int(seen.max(dim=1).values.sum()) * hd * k.element_size()
    bytes_ms = (kv_bytes + _nbytes(q, pos, lens_t, out)) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    if lens is None:
        # SDPA over the valid positions; its causal flag aligns the diagonal
        # top-left, so a chunk at an offset takes an explicit mask
        n = offset + S
        mask = None if offset == 0 else (
            torch.arange(n, device=dev)[None, :] <= pos[0, :, None]
        )[None, None]
        library_ms = _sdpa_ms(q.transpose(1, 2), k[:, :, :n], v[:, :, :n], mask=mask,
                              causal=offset == 0)
        shape = dict(R=R, S=S, q_pos0=offset, Skv=Skv, H=H, K=K, hd=hd, dtype=str(dtype))
    else:
        w = torch.arange(Skv, device=dev)[None, None, :]
        mask = ((w <= pos[:, :, None]) & (w < lens_t[:, None, None]))[:, None]
        library_ms = _sdpa_ms(q.transpose(1, 2), k, v, mask=mask)
        shape = dict(R=R, S=S, lens=list(lens), Skv=Skv, H=H, K=K, hd=hd, dtype=str(dtype))
    return dict(
        name="prefill_attention", shape=shape, max_abs_err=err, tol=PREFILL_TOL[dtype],
        ms=time_ms(lambda: A.prefill_attention(q, k, v, pos, lens_t), iters=5),
        plain_ms=time_ms(lambda: A.prefill_attention_reference(q, k, v, pos, lens_t), iters=3),
        library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def _ragged_limits(starts, lens, S, W) -> "list[list[int]]":
    """Each row's visible kv length per query: min(kv_len, start + j + 1),
    within the window."""
    return [[max(0, min(n, st + j + 1, W)) for j in range(S)] for st, n in zip(starts, lens)]


def _ragged_bound(limits, K, G, hd, kv_size, dtype, io_bytes):
    """(bound ms, bound_by): the K/V bytes of the positions some query of a
    row sees, read once, plus ``io_bytes`` (q, the row arrays, the table
    entries read and the outputs, each once); against 4*hd operations per
    (query, head, visible position)."""
    seen = sum(max(row) for row in limits)
    nbytes = 2 * seen * K * hd * kv_size + io_bytes
    ops = 4 * hd * K * G * sum(sum(row) for row in limits)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _ragged_sdpa_args(q, limits, W, dtype):
    """q [B, K, S, G, hd] as SDPA's [B, H, S, hd] (head k * G + g) and the
    explicit mask [B, 1, S, W] of the ragged law."""
    B, K, S, G, hd = q.shape
    qs = q.permute(0, 1, 3, 2, 4).reshape(B, K * G, S, hd).to(dtype)
    lim = torch.tensor(limits, dtype=torch.int32, device=q.device)  # [B, S]
    return qs, (torch.arange(W, device=q.device)[None, None, :] < lim[:, :, None])[:, None]


def ragged_case(dev, dtype, B, K, S, G, hd, W, starts, lens, seed, rows=None,
                q_dtype=torch.float32):
    """The dense ragged kernel on a [:, :, :W] view of a longer cache;
    ``rows`` labels the case's row lengths where they are not plain verify
    rows of the kernel plan; q in ``q_dtype``, as :func:`decode_case`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, S, G, hd), generator=g, device=dev).to(q_dtype)
    cache = torch.randn((2, B, K, 2 * W, hd), generator=g, device=dev).to(dtype)
    k, v = cache[0, :, :, :W], cache[1, :, :, :W]
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = A.ragged_attention(q, k, v, st, ln)
    ref = A.ragged_attention_reference(q, k, v, st, ln)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    limits = _ragged_limits(starts, lens, S, W)
    bound_ms, bound_by = _ragged_bound(
        limits, K, G, hd, cache.element_size(), dtype, _nbytes(q, st, ln, *out)
    )
    qs, mask = _ragged_sdpa_args(q, limits, W, dtype)
    shape = dict(B=B, K=K, S=S, G=G, hd=hd, W=W, dtype=str(dtype))
    if rows:
        shape["rows"] = rows
    if q_dtype != torch.float32:
        shape["q_dtype"] = str(q_dtype)
    return dict(
        name="ragged_attention", shape=shape, max_abs_err=err, tol=DECODE_TOL,
        ms=time_ms(lambda: A.ragged_attention(q, k, v, st, ln)),
        plain_ms=time_ms(lambda: A.ragged_attention_reference(q, k, v, st, ln), iters=5),
        library_ms=_sdpa_ms(qs, k, v, mask=mask), bound_ms=bound_ms, bound_by=bound_by,
    )


def ragged_paged_case(dev, dtype, B, K, S, G, hd, page, lens, wpages, seed, layer=1, rows=None,
                      q_dtype=torch.float32):
    """The paged ragged kernel at verify rows (start = kv_len) on a shuffled
    2-layer pool, at layer 1; ``rows`` labels the row lengths and q is in
    ``q_dtype``, as :func:`ragged_case`'s."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, S, G, hd), generator=g, device=dev).to(q_dtype)
    pool_k, pool_v, tables, n_pages = _shuffled_pool(dev, dtype, g, K, hd, page, lens, wpages, seed)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)

    def kernel():
        return A.ragged_attention_paged(q, pool_k, pool_v, layer, tables, ln, ln, wpages=wpages)

    def plain():
        return A.ragged_attention_paged_reference(
            q, pool_k, pool_v, layer, tables, ln, ln, wpages=wpages
        )

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    W = wpages * page
    limits = _ragged_limits(lens, lens, S, W)
    table_bytes = 4 * sum(-(-max(row) // page) for row in limits)
    bound_ms, bound_by = _ragged_bound(  # one lens tensor is both starts and kv_lens
        limits, K, G, hd, pool_k.element_size(), dtype, _nbytes(q, ln, *out) + table_bytes
    )
    qs, mask = _ragged_sdpa_args(q, limits, W, dtype)

    def gather():
        return (
            M.gather_window_paged(pool_k[layer], tables, wpages),
            M.gather_window_paged(pool_v[layer], tables, wpages),
        )

    kw, vw = gather()
    shape = dict(B=B, K=K, S=S, G=G, hd=hd, page=page, wpages=wpages, pool_pages=n_pages,
                 dtype=str(dtype))
    if rows:
        shape["rows"] = rows
    if q_dtype != torch.float32:
        shape["q_dtype"] = str(q_dtype)
    return dict(
        name="ragged_attention_paged", shape=shape,
        max_abs_err=err, tol=DECODE_TOL,
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        # no single PyTorch call reads K/V through block tables
        library_ms=None,
        sdpa_gathered_ms=_sdpa_ms(qs, kw, vw, mask=mask),  # gather excluded
        gather_sdpa_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, *gather(), attn_mask=mask, enable_gqa=True
        )),
        bound_ms=bound_ms, bound_by=bound_by,
    )


# the paged serving shape: B=16 rows, lens 17-2048 and one fresh row
PAGED_LENS = [0, 17, 100, 255, 256, 300, 511, 640, 777, 1024, 1300, 1500, 1600, 1800, 2000,
              2048]
# the dense spec serving phase's most launched ragged shape (B=8, S=5,
# W=2048): the kv lengths of its last launch in one run of the phase
PATH_LENS = [0, 0, 1530, 1130, 725, 509, 155, 48]
# the paged serving phase's most launched paged decode shape (B=16,
# wpages=32) and the spec paged phase's most launched verify shape (B=16,
# S=5, wpages=32): the kv lengths of their last launch in one run of each
PAGED_PATH_LENS = [0, 0, 0, 0, 0, 0, 724, 57, 1452, 1382, 1272, 1192, 1472, 1402, 1322, 1172]
SPEC_PAGED_PATH_LENS = [0, 0, 0, 0, 0, 0, 732, 62, 1446, 1380, 1267, 1190, 1472, 1403, 1322,
                        1174]
# skewed batches of the paged kernels, which the walk balances across
# blocks by their lengths: one long row and fifteen empty ones, every row
# full, a lone agent turn
WALK_LENS = {"one long, 15 empty": [2048] + [0] * 15, "all full": [2048] * 16,
             "one row": [2000]}
# the case of each kernel that the line of ``kernels`` reports: the dense
# decode kernel at the dense serving phase's batch and window, with q in the
# model's dtype, as serving passes it; the prefill kernel at the paged
# serving phase's last chunk of a 1536-token bucket.  The paged decode
# kernel's and the ragged kernels' cases are made after their serving
# phases, at the shape those phases launched most (:func:`path_case`).
MAIN_SHAPES = {
    "decode_attention": dict(B=8, K=8, G=4, hd=128, W=2048, dtype="torch.bfloat16",
                             q_dtype="torch.bfloat16"),
    "prefill_attention": dict(R=4, S=512, q_pos0=1024, Skv=1536, H=32, K=8, hd=128,
                              dtype="torch.bfloat16"),
}


def kernel_plan() -> "list[tuple[str, object, tuple]]":
    """Every kernel-phase case as (kernel name, case function, its
    arguments after the device)."""
    ragged = {256: [0, 1, 31, 64, 100, 200, 255, 256],
              2048: [17, 300, 777, 1024, 1500, 1600, 2000, 2048]}
    plan = []
    for dtype in (torch.bfloat16, torch.float32):
        for W in (256, 2048):
            plan.append(("decode_attention", decode_case, (dtype, 8, 8, 4, 128, W, ragged[W], W)))
    plan.append(("decode_attention", decode_case,
                 (torch.bfloat16, 8, 4, 8, 64, 2048, ragged[2048], 7)))
    # the dense serving shape with q in the model's dtype, as serving passes it
    plan.append(("decode_attention", decode_case,
                 (torch.bfloat16, 8, 8, 4, 128, 2048, ragged[2048], 2048, torch.bfloat16)))
    for dtype, K, G, hd, page, seed in (
        (torch.bfloat16, 8, 4, 128, 64, 11), (torch.bfloat16, 8, 4, 128, 16, 12),
        (torch.float32, 8, 4, 128, 64, 13), (torch.bfloat16, 4, 8, 64, 64, 14),
    ):
        plan.append(("paged_decode_attention", paged_decode_case,
                     (dtype, 16, K, G, hd, page, PAGED_LENS, 2048 // page, seed)))
    # the paged serving shape with q in the model's dtype (pages 64 and 16)
    for page, seed in ((64, 15), (16, 16)):
        plan.append(("paged_decode_attention", paged_decode_case,
                     (torch.bfloat16, 16, 8, 4, 128, page, PAGED_LENS, 2048 // page, seed, 1,
                      torch.bfloat16)))
    for dtype in (torch.bfloat16, torch.float32):
        for R in (1, 4):
            for S in (512, 2048):
                plan.append(("prefill_attention", prefill_case,
                             (dtype, R, S, 32, 8, 128, R * S)))
    plan.append(("prefill_attention", prefill_case, (torch.bfloat16, 4, 2048, 32, 4, 64, 3)))
    # the dense serving phase's largest prefill wave: two prompts in the 1536 bucket
    plan.append(("prefill_attention", prefill_case, (torch.bfloat16, 2, 1536, 32, 8, 128, 5)))
    # the paged serving phase's chunks of 512: a wave of 4 in the 1536
    # bucket at each offset, and one row in the 1024 bucket at offset 512
    for R, offset, Skv in ((4, 0, 1536), (4, 512, 1536), (4, 1024, 1536), (1, 512, 1024)):
        plan.append(("prefill_attention", prefill_case,
                     (torch.bfloat16, R, 512, 32, 8, 128, 20 + offset, offset, Skv)))
    # the draft model's most launched forward in the spec paged phase: one
    # token a row for the 16 rows over its 2048-position window
    plan.append(("prefill_attention", prefill_case,
                 (torch.bfloat16, 16, 1, 32, 8, 128, 6, 0, 2048, PAGED_LENS)))
    # a lone agent turn: one row of 2000 positions in a 2048 window, f32 q
    # and q in the model's dtype
    for q_dtype in (torch.float32, torch.bfloat16):
        plan.append(("decode_attention", decode_case,
                     (torch.bfloat16, 1, 8, 4, 128, 2048, [2000], 8, q_dtype)))
    # verify rows (start = kv_len) at k = 4 with every draft kept: S = 5
    plan.append(("ragged_attention", ragged_case,
                 (torch.bfloat16, 8, 8, 5, 4, 128, 2048, ragged[2048], ragged[2048], 30)))
    # the dense n-gram spec phase's most launched shape, at the kv lengths
    # of its last launch in one run (PATH_LENS); and the lone agent turn's verify
    for q_dtype in (torch.float32, torch.bfloat16):
        plan.append(("ragged_attention", ragged_case,
                     (torch.bfloat16, 8, 8, 5, 4, 128, 2048, PATH_LENS, PATH_LENS, 37,
                      "spec dense path", q_dtype)))
        plan.append(("ragged_attention", ragged_case,
                     (torch.bfloat16, 1, 8, 5, 4, 128, 2048, [2000], [2000], 38, "one row",
                      q_dtype)))
    # mixed rows: verify, prefill-kind (start < kv_len), fresh, prefill-kind
    # ending at the window; S*G = 64 query rows, two query tiles
    plan.append(("ragged_attention", ragged_case,
                 (torch.bfloat16, 4, 8, 16, 4, 128, 2048, [1000, 300, 0, 2032],
                  [1000, 316, 0, 2048], 31, "mixed")))
    for dtype, page, seed in ((torch.bfloat16, 64, 32), (torch.bfloat16, 16, 33),
                              (torch.float32, 64, 34)):
        plan.append(("ragged_attention_paged", ragged_paged_case,
                     (dtype, 16, 8, 5, 4, 128, page, PAGED_LENS, 2048 // page, seed)))
    # q in the model's dtype, as the spec serving phases pass it
    for page, seed in ((64, 39), (16, 40)):
        plan.append(("ragged_attention_paged", ragged_paged_case,
                     (torch.bfloat16, 16, 8, 5, 4, 128, page, PAGED_LENS, 2048 // page, seed, 1,
                      None, torch.bfloat16)))
    # the paged kernels at their serving paths' shapes and at skewed
    # batches, q in the model's dtype
    plan.append(("paged_decode_attention", paged_decode_case,
                 (torch.bfloat16, 16, 8, 4, 128, 64, PAGED_PATH_LENS, 32, 42, 1, torch.bfloat16,
                  "paged path")))
    plan.append(("ragged_attention_paged", ragged_paged_case,
                 (torch.bfloat16, 16, 8, 5, 4, 128, 64, SPEC_PAGED_PATH_LENS, 32, 43, 1,
                  "spec paged path", torch.bfloat16)))
    for i, (label, lens) in enumerate(WALK_LENS.items()):
        plan.append(("paged_decode_attention", paged_decode_case,
                     (torch.bfloat16, len(lens), 8, 4, 128, 64, lens, 32, 50 + i, 1,
                      torch.bfloat16, label)))
        plan.append(("ragged_attention_paged", ragged_paged_case,
                     (torch.bfloat16, len(lens), 8, 5, 4, 128, 64, lens, 32, 60 + i, 1, label,
                      torch.bfloat16)))
    return plan


def run_cases(dev, plan) -> "list[dict]":
    """Run and print each case of ``plan`` (as :func:`kernel_plan` gives)."""
    cases = []
    for _, case_fn, args in plan:
        c = case_fn(dev, *args)
        sdpa = (
            f"sdpa_ms {c['library_ms']:.4f}" if c["library_ms"] is not None else
            f"sdpa_gathered_ms {c['sdpa_gathered_ms']:.4f} "
            f"gather_sdpa_ms {c['gather_sdpa_ms']:.4f}"
        )
        print(
            f"  {c['name']} {c['shape']}: max_abs_err {c['max_abs_err']:.3e} "
            f"(tol {c['tol']}) ms {c['ms']:.4f} plain_ms {c['plain_ms']:.4f} "
            f"{sdpa} bound_ms {c['bound_ms']:.4f} ({c['bound_by']})"
        )
        cases.append(c)
    return cases


def kernel_phase(dev) -> "tuple[list[dict], dict]":
    """→ (every measured case, the case of each kernel at its
    ``MAIN_SHAPES`` shape)."""
    cases = run_cases(dev, kernel_plan())
    main = {
        name: next(c for c in cases if c["name"] == name and c["shape"] == shape)
        for name, shape in MAIN_SHAPES.items()
    }
    return cases, main


@contextlib.contextmanager
def _tally(name: str, key):
    """While the block runs, tally the calls of the wrapper ``A.name`` by
    ``key(q, args, kw)`` and keep a copy of the kv lengths (its last
    argument) of the last call at each → {key: [calls, kv_lens]}.  The
    wrapper's callers look it up at every call, so each call passes through
    here; the wrapper and its launch count are unchanged."""
    inner = getattr(A, name)
    tally: dict = {}

    def tallied(q, *args, **kw):
        entry = tally.setdefault(key(q, args, kw), [0, None])
        entry[0] += 1
        entry[1] = args[-1].clone()  # kv_lens, on the device: no sync
        return inner(q, *args, **kw)

    setattr(A, name, tallied)
    try:
        yield tally
    finally:
        setattr(A, name, inner)


def verify_shapes(name: str):
    """Tally the ragged wrapper ``A.name``'s calls by (B, S, window: W
    positions dense, wpages paged), as :func:`_tally` does;
    ``verify_attention(_paged)`` looks the wrapper up at every call."""
    if name == "ragged_attention_paged":
        return _tally(name, lambda q, args, kw: (q.shape[0], q.shape[2], kw["wpages"]))
    return _tally(name, lambda q, args, kw: (q.shape[0], q.shape[2], args[0].shape[2]))


def decode_shapes():
    """Tally the paged decode wrapper's calls by (B, 1, wpages), as
    :func:`_tally` does; ``merged_paged_decode_attention`` looks the wrapper
    up at every call."""
    return _tally("paged_decode_attention", lambda q, args, kw: (q.shape[0], 1, kw["wpages"]))


def prefill_shapes():
    """Tally the prefill wrapper's calls by (B, Sq, Skv), as :func:`_tally`
    does; ``model.prefill_attention`` looks the wrapper up at every call."""
    return _tally("prefill_attention", lambda q, args, kw: (q.shape[0], q.shape[1], args[0].shape[2]))


def _shape_rows(tally) -> "list[dict]":
    """A :func:`_tally` tally as JSON rows, most calls first (S: queries a
    row; window: W or Skv positions, or wpages)."""
    rows = [dict(B=B, S=S, window=w, launches=n, last_kv_lens=lens.tolist())
            for (B, S, w), (n, lens) in tally.items()]
    return sorted(rows, key=lambda r: (-r["launches"], -r["S"]))


def path_case(dev, name: str, shapes: "list[dict]") -> dict:
    """The paged decode or a ragged kernel ``name`` against its plain version
    at the shape its serving phase launched most (``shapes`` as
    :func:`_shape_rows` gives), with the kv lengths of that shape's last
    launch: (for the ragged kernels verify rows, start = kv_len) the 8B
    model's K=8, G=4, hd=128, bf16 cache and q."""
    top = shapes[0]
    bf16 = torch.bfloat16
    lens = top["last_kv_lens"]
    if name == "paged_decode_attention":
        label = f"paged serving, {top['launches']} launches"
        args = (bf16, top["B"], 8, 4, 128, PAGED_RUNTIME.page_size, lens, top["window"], 41, 1,
                bf16, label)
        return run_cases(dev, [(name, paged_decode_case, args)])[0]
    label = f"spec serving, {top['launches']} launches"
    if name == "ragged_attention":
        args = (bf16, top["B"], 8, top["S"], 4, 128, top["window"], lens, lens, 35, label, bf16)
        return run_cases(dev, [(name, ragged_case, args)])[0]
    args = (bf16, top["B"], 8, top["S"], 4, 128, PAGED_RUNTIME.page_size, lens,
            top["window"], 36, 1, label, bf16)
    return run_cases(dev, [(name, ragged_paged_case, args)])[0]


# --------------------------------------------------------------------------- #
# engine phases
# --------------------------------------------------------------------------- #


async def _stream(engine, prompt, n, t0, ttft, **kw):
    out = []
    async for tok in engine.generate(prompt, max_new_tokens=n, **kw):
        if not out:
            ttft.append(time.perf_counter() - t0)
        out.append(tok)
    return out


async def serve(engine, jobs) -> "tuple[list[list[int]], list[float], float]":
    """Run ``jobs`` = [(prompt, max_new, kwargs)] concurrently on a started
    engine → (streams, first-token seconds per stream, wall seconds)."""
    ttft: list[float] = []
    t0 = time.perf_counter()
    streams = await asyncio.gather(*[_stream(engine, p, n, t0, ttft, **kw) for p, n, kw in jobs])
    torch.cuda.synchronize()
    return streams, ttft, time.perf_counter() - t0


def _check_recompute(cfg, params, prompts, streams, dev) -> None:
    """Each greedy stream equals a step-by-step recompute: a fresh forward
    over prompt + tokens so far with the plain attention, argmax of the
    last position."""
    for prompt, stream in zip(prompts, streams):
        seq = list(prompt)
        for step, token in enumerate(stream):
            n = len(seq)
            cache = M.make_empty_cache(cfg, 1, n, device=dev)
            tokens = torch.tensor([seq], dtype=torch.int32, device=dev)
            pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
            logits, _ = M.forward(
                params, cfg, tokens, pos, cache,
                torch.tensor([n], dtype=torch.int32, device=dev), attn_impl="plain",
            )
            expect = int(torch.argmax(logits[0, -1]))
            assert token == expect, (
                f"prompt of {len(prompt)}: step {step} engine {token} vs recompute {expect}"
            )
            seq.append(token)


async def _serve_fresh(
    cfg, rt, params, dev, bursts, draft_params=None
) -> "tuple[list[list[int]], EngineStats]":
    """A fresh engine serves ``bursts`` (lists of jobs) one after the other
    → (streams in job order, the engine's stats)."""
    engine = InferenceEngine(cfg, rt, params=params, device=dev, draft_params=draft_params)
    await engine.start()
    try:
        streams = []
        for jobs in bursts:
            streams += (await serve(engine, jobs))[0]
    finally:
        await engine.stop()
    return streams, engine.stats


async def exactness_phase(dev) -> dict:
    cfg = preset("llama-3-8b", n_layers=4, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(1)
    params = M.init_params(cfg, g)
    rng = np.random.default_rng(1)
    dense_rt = dict(
        max_batch_size=4, max_seq_len=1024, prefill_chunk=128, decode_steps_per_dispatch=8
    )
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 77, 300)]
    jobs = [(p, 12, {}) for p in prompts]
    streams = {}
    for overlap in (True, False):
        rt = RuntimeConfig(**dense_rt, overlap_dispatch=overlap)
        streams[overlap], _ = await _serve_fresh(cfg, rt, params, dev, [jobs])
    assert streams[True] == streams[False], "overlapped and lockstep streams differ"
    assert [len(s) for s in streams[True]] == [12] * 3
    _check_recompute(cfg, params, prompts, streams[True], dev)
    print("  exactness: 3 greedy streams x 12 tokens, overlap == lockstep == recompute")

    # the paged path: requests sharing a 256-token prefix in two bursts;
    # the second burst reuses the first's pages, and an unrelated prompt's
    # chunks ride the decode dispatches
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).tolist()  # noqa: E731
    bursts = [
        [(prefix + tail(40), 12, {}), (prefix + tail(90), 12, {})],
        [(prefix + tail(60), 12, {}), (prefix + tail(20), 12, {}), (tail(50), 12, {})],
    ]
    paged_rt = RuntimeConfig(
        **dense_rt, kv_layout="paged", page_size=64, chunked_prefill=True,
        prefix_cache=True,
    )
    paged, stats = await _serve_fresh(cfg, paged_rt, params, dev, bursts)
    lockstep, _ = await _serve_fresh(
        cfg, RuntimeConfig(**dense_rt, overlap_dispatch=False), params, dev, bursts
    )
    assert paged == lockstep, "paged streams differ from the dense lockstep engine's"
    assert [len(s) for s in paged] == [12] * 5
    assert stats.prefix_hits == 2 and stats.prefix_reused_tokens == 2 * 256, stats
    assert stats.unified_dispatches >= 1, stats
    _check_recompute(cfg, params, [p for jobs in bursts for p, _, _ in jobs], paged, dev)
    print(
        "  exactness, paged: 5 greedy streams x 12 tokens over two bursts, paged == "
        f"dense lockstep == recompute; prefix hits {stats.prefix_hits} "
        f"({stats.prefix_reused_tokens} tokens), unified dispatches {stats.unified_dispatches}"
    )

    # speculation, the draft model being the target (its own tensors,
    # shared): the same streams, every verify through the ragged kernels
    spec = SpecConfig(k=4, draft=cfg)
    spec_stats = {}
    for name, rt, served, want, kernel in (
        ("dense", RuntimeConfig(**dense_rt, speculative=spec), [jobs], streams[True],
         "ragged_attention"),
        ("paged", replace(paged_rt, speculative=spec), bursts, paged, "ragged_attention_paged"),
    ):
        A.reset_launch_counts()
        got, st = await _serve_fresh(cfg, rt, params, dev, served, draft_params=params)
        launches = dict(A.launch_counts)
        assert got == want, f"{name}: spec-on streams differ from spec-off"
        assert launches[kernel] > 0 and launches["decode_attention"] == 0, launches
        assert launches["paged_decode_attention"] == 0, launches
        assert st.acceptance_rate > 0.9, vars(st)
        if name == "paged":
            assert st.prefix_hits == 2, vars(st)
        spec_stats[name] = dict(vars(st), acceptance_rate=st.acceptance_rate,
                                tokens_per_dispatch=st.tokens_per_dispatch, launches=launches)
        print(
            f"  exactness, spec {name} (k=4, draft = target): spec-on == spec-off; acceptance "
            f"{st.acceptance_rate:.3f}, tokens/dispatch {st.tokens_per_dispatch:.2f}, "
            f"launches {launches}"
        )
    return dict(streams=streams[True], paged_streams=paged, paged_stats=vars(stats),
                spec=spec_stats)


SERVING_RUNTIME = RuntimeConfig(
    max_batch_size=8, max_seq_len=2048, prefill_chunk=512, decode_steps_per_dispatch=8
)


def serving_jobs(vocab_size: int) -> "tuple[list[list[int]], list[tuple]]":
    """The serving workload, from seed 0: 6 prompts of 17-1500 tokens
    (prefill buckets 512, 1024, 1536), 32 new tokens each, request 1
    sampled with its own seed → (prompts, [(prompt, max_new, kwargs)])."""
    rng = np.random.default_rng(0)
    lengths = (17, 130, 480, 700, 1100, 1500)
    prompts = [rng.integers(0, vocab_size, n).tolist() for n in lengths]
    sampled = dict(sampling=SamplingParams(temperature=0.8, top_p=0.95), seed=7)
    return prompts, [(p, 32, sampled if i == 1 else {}) for i, p in enumerate(prompts)]


async def serving_phase(dev) -> dict:
    cfg = preset("llama-3-8b")
    rt = SERVING_RUNTIME
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, rt, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, jobs = serving_jobs(cfg.vocab_size)
    await engine.start()
    try:
        await serve(engine, [([1, 2, 3, 4, 5, 6, 7, 8], 2, {})])  # warm-up
        engine.stats = type(engine.stats)()
        A.reset_launch_counts()
        streams, ttft, wall = await serve(engine, jobs)
        launches = dict(A.launch_counts)
        stats = engine.stats
        round1 = dict(
            decode_tokens=stats.decode_tokens, decode_time_s=stats.decode_time_s,
            decode_tok_s=stats.tokens_per_second, decode_dispatches=stats.decode_dispatches,
            mean_occupancy=stats.mean_occupancy, prefill_waves=stats.prefill_waves,
            prefill_time_s=stats.prefill_time_s,
        )
        assert [len(s) for s in streams] == [32] * 6, [len(s) for s in streams]
        assert launches["decode_attention"] > 0 and launches["prefill_attention"] > 0, launches
        assert launches["paged_decode_attention"] == 0, launches  # not on the dense path
        assert len(engine._free) == rt.max_batch_size and not engine._active
        # the same six again, request 3 with a stop token from its own stream:
        # identical schedule up to the stop, so its stream ends right there
        stop = streams[3][10]
        cut = streams[3].index(stop)
        jobs[3] = (prompts[3], 32, dict(stop_tokens=frozenset({stop})))
        again, _, _ = await serve(engine, jobs)
        assert again[3] == streams[3][:cut], (again[3], streams[3], stop)
        assert again[1] == streams[1], "the seeded sampled stream changed"
        assert len(engine._free) == rt.max_batch_size and not engine._active
    finally:
        await engine.stop()
    result = dict(
        init_s=init_s, wall_s=wall, ttft_ms=sorted(x * 1e3 for x in ttft),
        ttft_median_ms=statistics.median(ttft) * 1e3, ttft_max_ms=max(ttft) * 1e3,
        **round1, launches=launches,
        launches_per_request={k: n / len(jobs) for k, n in launches.items()},
        stop_cut=cut,
    )
    print(
        f"  serving llama-3-8b bf16, 6 requests x 32 tokens: init {init_s:.2f} s, "
        f"TTFT median {result['ttft_median_ms']:.1f} ms max {result['ttft_max_ms']:.1f} ms, "
        f"decode {result['decode_tok_s']:.1f} tok/s over {result['decode_dispatches']} dispatches, "
        f"launches {launches}"
    )
    return result


PAGED_RUNTIME = RuntimeConfig(
    max_batch_size=16, max_seq_len=2048, kv_layout="paged", page_size=64,
    prefill_chunk=512, chunked_prefill=True, prefix_cache=True,
    decode_steps_per_dispatch=8,
)


def paged_serving_jobs(vocab_size: int) -> "tuple[list[list[int]], list[list[int]]]":
    """Agent-shaped traffic, from seed 2: burst A is 4 requests of one shared
    1024-token instruction prefix plus unique 100-400-token suffixes; burst
    B is 4 more of the same prefix with other suffixes, plus 2 unrelated
    prompts of 17 and 700 tokens → (burst A prompts, burst B prompts)."""
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab_size, 1024).tolist()

    def agent(n):
        return prefix + rng.integers(0, vocab_size, n).tolist()

    burst_a = [agent(n) for n in (100, 250, 330, 400)]
    burst_b = [agent(n) for n in (120, 200, 310, 380)]
    burst_b += [rng.integers(0, vocab_size, n).tolist() for n in (17, 700)]
    return burst_a, burst_b


async def paged_serving_phase(dev, speculative: bool = False) -> dict:
    """The paged serving drive; with ``speculative``, ``SpecConfig(k=4)``
    with the target's own weights as the draft model."""
    cfg = preset("llama-3-8b")
    rt = PAGED_RUNTIME
    new_tokens = 48
    t0 = time.perf_counter()
    if speculative:
        rt = replace(rt, speculative=SpecConfig(k=4, draft=cfg))
        g = torch.Generator(device=dev).manual_seed(0)
        params = M.init_params(cfg, g)  # shared by target and draft: one copy
        engine = InferenceEngine(cfg, rt, params=params, draft_params=params, device=dev)
        del params
    else:
        engine = InferenceEngine(cfg, rt, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    burst_a, burst_b = paged_serving_jobs(cfg.vocab_size)

    async def stream(prompt, t_submit, ttft, out):
        async for tok in engine.generate(prompt, max_new_tokens=new_tokens):
            if not out:
                ttft.append(time.perf_counter() - t_submit)
            out.append(tok)

    await engine.start()
    try:
        await serve(engine, [([1, 2, 3, 4, 5, 6, 7, 8], 2, {})])  # warm-up
        engine.stats = EngineStats()
        A.reset_launch_counts()
        with verify_shapes("ragged_attention_paged") as tally, prefill_shapes() as prefills, \
                decode_shapes() as decodes:
            started = time.perf_counter()
            ttft_a: list[float] = []
            ttft_b: list[float] = []
            out_a: list[list[int]] = [[] for _ in burst_a]
            out_b: list[list[int]] = [[] for _ in burst_b]
            tasks = [
                asyncio.create_task(stream(p, started, ttft_a, o))
                for p, o in zip(burst_a, out_a)
            ]
            while not all(len(o) >= 2 for o in out_a):  # burst A is decoding
                if any(t.done() for t in tasks):
                    await asyncio.gather(*tasks)  # surfaces a failure; else one ended early
                    raise AssertionError("a burst-A stream ended before burst B arrived")
                await asyncio.sleep(0.002)
            at_b = time.perf_counter()
            tasks += [
                asyncio.create_task(stream(p, at_b, ttft_b, o)) for p, o in zip(burst_b, out_b)
            ]
            await asyncio.gather(*tasks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - started
            launches = dict(A.launch_counts)
        stats = engine.stats
    finally:
        await engine.stop()
    assert [len(o) for o in out_a + out_b] == [new_tokens] * 10
    assert all(0 <= tok < cfg.vocab_size for o in out_a + out_b for tok in o)
    assert launches["prefill_attention"] > 0, launches
    assert launches["decode_attention"] == 0, launches  # the dense kernel is not on this path
    if speculative:  # every token through a verify, none through decode
        assert launches["ragged_attention_paged"] > 0, launches
        assert launches["paged_decode_attention"] == 0, launches
        assert stats.tokens_per_dispatch > 1.5, vars(stats)
    else:
        assert launches["paged_decode_attention"] > 0, launches
        assert launches["ragged_attention_paged"] == 0, launches
        assert stats.unified_dispatches >= 1, vars(stats)
    assert stats.prefix_hits >= 4 and stats.prefix_reused_tokens >= 4096, vars(stats)
    shapes = _shape_rows(tally)
    assert sum(r["launches"] for r in shapes) == launches["ragged_attention_paged"], shapes
    prefill_rows = _shape_rows(prefills)
    assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"], prefill_rows
    decode_rows = _shape_rows(decodes)
    assert sum(r["launches"] for r in decode_rows) == launches["paged_decode_attention"], decode_rows
    # the no-leak law: every page free or held by the prefix cache, every slot free
    free_pages, cached = engine._page_alloc.free_pages, engine._prefix.size
    assert free_pages + cached == rt.pool_pages() - 1, (free_pages, cached)
    assert len(engine._free) == rt.max_batch_size and not engine._active
    result = dict(
        init_s=init_s, wall_s=wall,
        ttft_a_ms=sorted(x * 1e3 for x in ttft_a), ttft_b_ms=sorted(x * 1e3 for x in ttft_b),
        ttft_a_median_ms=statistics.median(ttft_a) * 1e3, ttft_a_max_ms=max(ttft_a) * 1e3,
        ttft_b_median_ms=statistics.median(ttft_b) * 1e3, ttft_b_max_ms=max(ttft_b) * 1e3,
        decode_tokens=stats.decode_tokens, decode_time_s=stats.decode_time_s,
        decode_tok_s=stats.tokens_per_second, decode_dispatches=stats.decode_dispatches,
        mean_occupancy=stats.mean_occupancy, prefill_waves=stats.prefill_waves,
        prefill_time_s=stats.prefill_time_s, prefix_hits=stats.prefix_hits,
        prefix_reused_tokens=stats.prefix_reused_tokens,
        prefix_evictions=stats.prefix_evictions, alloc_stalls=stats.alloc_stalls,
        prefill_absorbed_tokens=stats.prefill_absorbed_tokens,
        unified_dispatches=stats.unified_dispatches, launches=launches,
        pages_free=free_pages, pages_cached=cached,
        spec_proposed=stats.spec_proposed, spec_accepted=stats.spec_accepted,
        spec_emitted=stats.spec_emitted, spec_rows=stats.spec_rows,
        acceptance_rate=stats.acceptance_rate, tokens_per_dispatch=stats.tokens_per_dispatch,
        tok_s_wall=stats.decode_tokens / wall, verify_shapes=shapes, prefill_shapes=prefill_rows,
        decode_shapes=decode_rows,
    )
    spec_note = (
        f", spec k=4 draft = target: acceptance {stats.acceptance_rate:.3f}, tokens/dispatch "
        f"{stats.tokens_per_dispatch:.2f}" if speculative else ""
    )
    print(
        f"  paged serving llama-3-8b bf16{spec_note}, 10 requests x {new_tokens} tokens: init "
        f"{init_s:.2f} s, TTFT burst A median {result['ttft_a_median_ms']:.1f} ms max "
        f"{result['ttft_a_max_ms']:.1f} ms, burst B median {result['ttft_b_median_ms']:.1f} "
        f"ms max {result['ttft_b_max_ms']:.1f} ms, decode {result['decode_tok_s']:.1f} tok/s "
        f"over {result['decode_dispatches']} dispatches ({result['tok_s_wall']:.1f} tok/s over "
        f"the run's wall), prefix hits {stats.prefix_hits} "
        f"({stats.prefix_reused_tokens} tokens), unified dispatches "
        f"{stats.unified_dispatches}, launches {launches}, pages free {free_pages} + "
        f"cached {cached} of {rt.pool_pages() - 1}"
        + (f", ragged launches by (B, S, wpages) "
           f"{[(r['B'], r['S'], r['window'], r['launches']) for r in shapes]}"
           if speculative else "")
        + f", prefill launches by (B, Sq, Skv) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}"
        + ("" if speculative else f", paged decode launches by (B, wpages) "
           f"{[(r['B'], r['window'], r['launches']) for r in decode_rows]}")
    )
    return result


async def spec_serving_phase(dev) -> dict:
    """Dense serving with the n-gram drafter: the serving phase's six
    requests (32 new tokens each, request 1 sampled), every token through a
    verify dispatch and the dense ragged kernel."""
    cfg = preset("llama-3-8b")
    rt = replace(SERVING_RUNTIME, speculative=SpecConfig(k=4))
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, rt, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _, jobs = serving_jobs(cfg.vocab_size)
    await engine.start()
    try:
        await serve(engine, [([1, 2, 3, 4, 5, 6, 7, 8], 2, {})])  # warm-up
        engine.stats = EngineStats()
        A.reset_launch_counts()
        with verify_shapes("ragged_attention") as tally:
            streams, ttft, wall = await serve(engine, jobs)
            launches = dict(A.launch_counts)
        stats = engine.stats
    finally:
        await engine.stop()
    assert [len(s) for s in streams] == [32] * 6, [len(s) for s in streams]
    shapes = _shape_rows(tally)
    assert sum(r["launches"] for r in shapes) == launches["ragged_attention"], shapes
    assert launches["ragged_attention"] > 0 and launches["prefill_attention"] > 0, launches
    assert launches["decode_attention"] == 0, launches  # every token through a verify
    assert launches["paged_decode_attention"] == launches["ragged_attention_paged"] == 0
    assert len(engine._free) == rt.max_batch_size and not engine._active
    result = dict(
        init_s=init_s, wall_s=wall, ttft_ms=sorted(x * 1e3 for x in ttft),
        ttft_median_ms=statistics.median(ttft) * 1e3, ttft_max_ms=max(ttft) * 1e3,
        decode_tokens=stats.decode_tokens, decode_time_s=stats.decode_time_s,
        decode_tok_s=stats.tokens_per_second, decode_dispatches=stats.decode_dispatches,
        spec_proposed=stats.spec_proposed, spec_accepted=stats.spec_accepted,
        spec_emitted=stats.spec_emitted, spec_rows=stats.spec_rows,
        acceptance_rate=stats.acceptance_rate, tokens_per_dispatch=stats.tokens_per_dispatch,
        tok_s_wall=stats.decode_tokens / wall, launches=launches, verify_shapes=shapes,
    )
    print(
        f"  spec serving llama-3-8b bf16, n-gram k=4, 6 requests x 32 tokens: init "
        f"{init_s:.2f} s, TTFT median {result['ttft_median_ms']:.1f} ms max "
        f"{result['ttft_max_ms']:.1f} ms, decode {result['decode_tok_s']:.1f} tok/s over "
        f"{result['decode_dispatches']} verify dispatches ({result['tok_s_wall']:.1f} tok/s "
        f"over the run's wall), acceptance "
        f"{stats.acceptance_rate:.3f}, tokens/dispatch {stats.tokens_per_dispatch:.2f}, "
        f"launches {launches}, ragged launches by (B, S, W) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in shapes]}"
    )
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    built = kernels.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    print("kernel phase")
    cases, main_cases = kernel_phase(dev)
    print("exactness phase")
    exact = asyncio.run(exactness_phase(dev))
    torch.cuda.empty_cache()
    print("serving phase")
    serving = asyncio.run(serving_phase(dev))
    torch.cuda.empty_cache()
    print("paged serving phase")
    paged = asyncio.run(paged_serving_phase(dev))
    torch.cuda.empty_cache()
    print("speculative serving phases")
    spec_paged = asyncio.run(paged_serving_phase(dev, speculative=True))
    torch.cuda.empty_cache()
    spec_dense = asyncio.run(spec_serving_phase(dev))
    torch.cuda.empty_cache()
    print("paged decode and ragged kernels at their serving phases' shapes")
    for name, shapes in (("paged_decode_attention", paged["decode_shapes"]),
                         ("ragged_attention", spec_dense["verify_shapes"]),
                         ("ragged_attention_paged", spec_paged["verify_shapes"])):
        main_cases[name] = path_case(dev, name, shapes)
        cases.append(main_cases[name])

    # each kernel's launches from the path it serves, beside its case at a
    # shape of that path (MAIN_SHAPES, path_case): the dense decode kernel
    # from the dense serving phase; the paged decode and prefill kernels
    # from the paged serving phase; the ragged kernels from the speculative
    # phases
    launch_source = {"decode_attention": serving, "paged_decode_attention": paged,
                     "prefill_attention": paged, "ragged_attention": spec_dense,
                     "ragged_attention_paged": spec_paged}
    line = {"kernels": []}
    for name, c in main_cases.items():
        source, replaces = SOURCES[name]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launch_source[name]["launches"][name], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"], shape=c["shape"],
        )
        if name in ("paged_decode_attention", "ragged_attention_paged"):
            entry.update(sdpa_gathered_ms=c["sdpa_gathered_ms"], gather_sdpa_ms=c["gather_sdpa_ms"])
        line["kernels"].append(entry)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, cases=cases, exactness=exact, serving=serving,
                           paged_serving=paged, spec_paged_serving=spec_paged,
                           spec_serving=spec_dense, kernels=line["kernels"]), f, indent=1,
                      default=str)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
