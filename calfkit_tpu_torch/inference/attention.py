"""Attention kernels of the serving path and their plain PyTorch versions.

Hand-written CUDA kernels (sources in ``calfkit_tpu_torch/csrc/``) take the
place of the JAX package's Pallas kernels on this path:

- :func:`decode_attention` ← ``pallas_attention.decode_attention_pallas``:
  single-query GQA decode over the dense cache window → (o unnormalized,
  m, z), folded with the fresh-token ring by :func:`merged_decode_attention`;
- :func:`paged_decode_attention` ←
  ``pallas_attention.paged_decode_attention_pallas``: the same contract,
  with K/V read page by page through block tables out of the whole pool,
  folded with the ring by :func:`merged_paged_decode_attention`;
- :func:`prefill_attention` ← ``pallas_attention.prefill_attention_pallas``:
  causal GQA flash attention → normalized output in q's dtype;
- :func:`ragged_attention` ← ``pallas_attention.ragged_attention_pallas``:
  multi-query attention under the ragged mask law over the dense window
  → (o, m, z), folded with the speculative verify chunk by
  :func:`verify_attention`;
- :func:`ragged_attention_paged` ←
  ``pallas_attention.ragged_attention_paged_pallas``: the same through block
  tables out of the whole pool, folded by :func:`verify_attention_paged`.

Each wrapper runs its kernel when the tensors lie on a CUDA device and its
plain version (``*_reference``) when they lie on the CPU; there is no
switch in between and no fallback from the kernel.  ``launch_counts``
counts kernel launches, so a run can show it went through the kernels.
"""

from __future__ import annotations

import math

import torch

from calfkit_tpu_torch import kernels

launch_counts: dict[str, int] = {
    "decode_attention": 0, "paged_decode_attention": 0, "prefill_attention": 0,
    "ragged_attention": 0, "ragged_attention_paged": 0,
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_DECODE_GROUP = 8


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises when the tensors mix
    devices or lie on a device no kernel here serves."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"attention inputs lie on several devices: {devices}")
    kind = next(iter(devices)).type
    if kind == "cpu":
        return True
    if kind != "cuda":
        raise ValueError(f"no attention kernel for device type {kind!r}")
    return False


def _check_kv(name: str, k_cache: torch.Tensor, v_cache: torch.Tensor) -> None:
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"{name}: K/V must share a dtype among float32/bfloat16 "
            f"(got {k_cache.dtype}, {v_cache.dtype})"
        )
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"{name}: K/V shapes differ: {k_cache.shape} vs {v_cache.shape}")
    if k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError(f"{name}: K/V head_dim must be the unit-stride axis")


def _check_aligned16(name: str, *tensors: torch.Tensor) -> None:
    """The kernels copy 16 bytes at a time: every address and every stride
    (of an axis longer than 1) must be a multiple of 16 bytes."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(
            stride * size % 16 for stride, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1
        ):
            raise ValueError(f"{name}: tensors must be 16-byte aligned in address and strides")


_STATUS = {-1: "shape or type not supported", -2: "a TMA tensor map could not be encoded"}


def _check_status(name: str, status: int) -> None:
    """Raise on a C entry point's non-zero status: a CUDA error code, or
    one of ``_STATUS``."""
    if status != 0:
        reason = _STATUS.get(status, "CUDA error")
        raise RuntimeError(f"{name} kernel launch failed (status {status}: {reason})")


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #


def _launch_stats(name: str, q: torch.Tensor, call) -> tuple:
    """The launch shared by the kernels that return (o, m, z) statistics
    (decode and ragged): ``call(qf, o, m, z, scale, stream)`` runs the C
    entry point on q in f32 (contiguous) and three fresh f32 outputs, on the
    current stream → (o shaped like q, m and z shaped like q[..., 0])."""
    hd = q.shape[-1]
    qf = q.to(torch.float32).contiguous()
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    z = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the launching thread's current device
        status = call(
            qf, o, m, z, 1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream
        )
    _check_status(name, status)
    launch_counts[name] += 1
    return o, m, z


def _grouped(q: torch.Tensor, K: int) -> torch.Tensor:
    """[B, 1, H, hd] decode queries → [B, K, G, hd] by kv head."""
    B, _, H, hd = q.shape
    return q.reshape(B, K, H // K, hd)


def _merge_with_ring(
    q: torch.Tensor,  # [B, 1, H, hd]
    qg: torch.Tensor,  # q as [B, K, G, hd]
    source: tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # (o, m, z) of the main cache
    ring_k: torch.Tensor,  # [T, B, K, hd]
    ring_v: torch.Tensor,
    t: int,
) -> torch.Tensor:
    """Fold the (tiny) fresh-token ring into a main-cache source with the
    shared logsumexp merge → [B, 1, H, hd] in q's dtype."""
    from calfkit_tpu_torch.inference.model import logsumexp_merge, ring_attention_source

    o1, m1, z1 = source
    out = logsumexp_merge(
        (o1, m1[..., None], z1[..., None]), ring_attention_source(qg, ring_k, ring_v, t)
    )
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_reference(
    q: torch.Tensor,  # [B, K, G, hd]
    k_cache: torch.Tensor,  # [B, K, W, hd]
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the decode kernel, in f32 like the kernel:
    → (o [B,K,G,hd] unnormalized, m [B,K,G], z [B,K,G])."""
    from calfkit_tpu_torch.inference.model import masked_attention_source

    W = k_cache.shape[2]
    valid = torch.arange(W, device=q.device)[None, :] < base_lens[:, None]
    o, m, z = masked_attention_source(
        q.float(), k_cache.float(), v_cache.float(), valid
    )
    return o, m[..., 0], z[..., 0]


def decode_attention(
    q: torch.Tensor,  # [B, K, G, hd]
    k_cache: torch.Tensor,  # [B, K, W, hd], any strides with a unit last axis
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,  # [B] valid kv per row
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (o [B,K,G,hd] f32 unnormalized, m [B,K,G] f32, z [B,K,G] f32).

    Masks kv positions >= base_lens[b] to -1e30 and floors m at -1e29, as
    the Pallas kernel does.  The cache window is read through its strides
    (a ``[:, :, :W]`` view of the engine's cache is never copied)."""
    if _on_cpu(q, k_cache, v_cache, base_lens):
        return decode_attention_reference(q, k_cache, v_cache, base_lens)
    B, K, G, hd = q.shape
    W = k_cache.shape[2]
    _check_kv("decode_attention", k_cache, v_cache)
    if k_cache.shape != (B, K, W, hd) or base_lens.shape != (B,):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"lens {tuple(base_lens.shape)} do not agree"
        )
    if hd not in _HEAD_DIMS or not 1 <= G <= _MAX_DECODE_GROUP:
        raise ValueError(f"decode_attention: hd={hd}, G={G} not supported")
    _check_aligned16("decode_attention", k_cache, v_cache)
    fn = kernels.function("decode_attention")
    lens = base_lens.to(torch.int32).contiguous()
    ks, vs = k_cache.stride(), v_cache.stride()
    return _launch_stats("decode_attention", q, lambda qf, o, m, z, scale, stream: fn(
        _DTYPE_CODES[k_cache.dtype], hd,
        qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        o.data_ptr(), m.data_ptr(), z.data_ptr(),
        B, K, G, W, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, stream,
    ))


def merged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_cache: torch.Tensor,  # [B, K, W, hd] main pages (stale within dispatch)
    v_cache: torch.Tensor,
    ring_k: torch.Tensor,  # [T, B, K, hd] this layer's ring
    ring_v: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
    t: int,  # current ring step (slots 0..t valid)
) -> torch.Tensor:
    """Softmax over (main cache ⊕ ring): the main-cache source from
    :func:`decode_attention`, the (tiny) ring folded in with the shared
    logsumexp merge → [B, 1, H, hd] in q's dtype."""
    qg = _grouped(q, k_cache.shape[1])
    return _merge_with_ring(
        q, qg, decode_attention(qg, k_cache, v_cache, base_lens), ring_k, ring_v, t
    )


# --------------------------------------------------------------------------- #
# paged decode
# --------------------------------------------------------------------------- #


def paged_decode_attention_reference(
    q: torch.Tensor,  # [B, K, G, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd] the whole pool
    pool_v: torch.Tensor,
    layer: int,
    tables: torch.Tensor,  # [B, Pmax] block tables
    base_lens: torch.Tensor,  # [B]
    *,
    wpages: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the paged decode kernel: gather each row's
    window of ``wpages`` pages, then the plain decode attention in f32
    → (o [B,K,G,hd] unnormalized, m [B,K,G], z [B,K,G])."""
    from calfkit_tpu_torch.inference.model import gather_window_paged

    return decode_attention_reference(
        q,
        gather_window_paged(pool_k[layer], tables, wpages),
        gather_window_paged(pool_v[layer], tables, wpages),
        base_lens,
    )


def paged_decode_attention(
    q: torch.Tensor,  # [B, K, G, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd] the whole pool (never sliced)
    pool_v: torch.Tensor,
    layer: int,  # which layer's pages to read
    tables: torch.Tensor,  # [B, Pmax] int32 block tables
    base_lens: torch.Tensor,  # [B] valid kv per row
    *,
    wpages: int,  # pages per attention window
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged decode attention, the contract of :func:`decode_attention` over
    the window of ``wpages`` pages that ``tables[b]`` names in layer
    ``layer`` of the pool → (o f32 unnormalized, m, z).

    On CUDA the kernel reads each page in place through the block table:
    the layer is a strided view of the pool and no window is gathered."""
    if _on_cpu(q, pool_k, pool_v, tables, base_lens):
        return paged_decode_attention_reference(
            q, pool_k, pool_v, layer, tables, base_lens, wpages=wpages
        )
    B, K, G, hd = q.shape
    _check_kv("paged_decode_attention", pool_k, pool_v)
    L, N, _, page = pool_k.shape[:4]
    if (
        pool_k.shape != (L, N, K, page, hd) or tables.dim() != 2
        or tables.shape[0] != B or base_lens.shape != (B,)
    ):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)}, pool {tuple(pool_k.shape)}, "
            f"tables {tuple(tables.shape)}, lens {tuple(base_lens.shape)} do not agree"
        )
    if not 0 <= layer < L or not 1 <= wpages <= tables.shape[1]:
        raise ValueError(
            f"paged_decode_attention: layer {layer} of {L}, wpages {wpages} of "
            f"{tables.shape[1]} table entries"
        )
    if hd not in _HEAD_DIMS or not 1 <= G <= _MAX_DECODE_GROUP:
        raise ValueError(f"paged_decode_attention: hd={hd}, G={G} not supported")
    k_layer, v_layer = pool_k[layer], pool_v[layer]  # views: nothing is copied
    _check_aligned16("paged_decode_attention", k_layer, v_layer)
    fn = kernels.function("paged_decode_attention")
    tab = tables.to(torch.int32).contiguous()
    lens = base_lens.to(torch.int32).contiguous()
    ks, vs = k_layer.stride(), v_layer.stride()
    return _launch_stats("paged_decode_attention", q, lambda qf, o, m, z, scale, stream: fn(
        _DTYPE_CODES[pool_k.dtype], hd,
        qf.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(), tab.data_ptr(),
        lens.data_ptr(), o.data_ptr(), m.data_ptr(), z.data_ptr(),
        B, K, G, wpages, page, tab.stride(0),
        ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, stream,
    ))


def merged_paged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd]
    pool_v: torch.Tensor,
    layer: int,
    tables: torch.Tensor,  # [B, Pmax]
    ring_k: torch.Tensor,  # [T, B, K, hd] this layer's ring
    ring_v: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
    t: int,  # current ring step (slots 0..t valid)
    *,
    wpages: int,
) -> torch.Tensor:
    """The paged counterpart of :func:`merged_decode_attention`: the
    main-cache source from :func:`paged_decode_attention`, the ring folded in
    with the shared logsumexp merge → [B, 1, H, hd] in q's dtype."""
    qg = _grouped(q, pool_k.shape[2])
    source = paged_decode_attention(qg, pool_k, pool_v, layer, tables, base_lens, wpages=wpages)
    return _merge_with_ring(q, qg, source, ring_k, ring_v, t)


# --------------------------------------------------------------------------- #
# prefill
# --------------------------------------------------------------------------- #


def prefill_attention_reference(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k_cache: torch.Tensor,  # [B, K, Skv, hd]
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,  # [B, Sq]
    seq_lens: torch.Tensor,  # [B]
) -> torch.Tensor:
    """The plain version of the prefill kernel: the plain attention in f32,
    cast to q's dtype.  A query that sees no position (seq_lens[b] = 0, or
    q_pos < 0) gives 0, as the kernels and the Pallas kernel do (the running
    max floored at -1e29 makes every p 0), where a softmax over nothing but
    -1e30 scores would give the mean of v."""
    from calfkit_tpu_torch.inference.model import attention_xla

    out = attention_xla(q.float(), k_cache.float(), v_cache.float(), q_pos, seq_lens)
    blind = torch.minimum(q_pos + 1, seq_lens[:, None]) <= 0  # [B, Sq]
    return out.masked_fill(blind[:, :, None, None], 0.0).to(q.dtype)


def prefill_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k_cache: torch.Tensor,  # [B, K, Skv, hd], any strides with a unit last axis
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,  # [B, Sq] absolute positions
    seq_lens: torch.Tensor,  # [B] valid kv per row
) -> torch.Tensor:
    """Causal GQA flash prefill → [B, Sq, H, hd] normalized, in q's dtype.
    Query (b, s) attends kv positions w <= q_pos[b, s] with w < seq_lens[b].
    Any Sq and Skv; no block divisibility is required."""
    if _on_cpu(q, k_cache, v_cache, q_pos, seq_lens):
        return prefill_attention_reference(q, k_cache, v_cache, q_pos, seq_lens)
    B, Sq, H, hd = q.shape
    K, Skv = k_cache.shape[1], k_cache.shape[2]
    _check_kv("prefill_attention", k_cache, v_cache)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"prefill_attention: q dtype {q.dtype} not supported")
    if (
        k_cache.shape != (B, K, Skv, hd) or q_pos.shape != (B, Sq)
        or seq_lens.shape != (B,) or H % K
    ):
        raise ValueError(
            f"prefill_attention: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"q_pos {tuple(q_pos.shape)}, lens {tuple(seq_lens.shape)} do not agree"
        )
    # a block holds 64 query rows (the M of the bf16 kernel's warpgroup
    # products): 64 / G positions x the G heads of one kv head
    if hd not in _HEAD_DIMS or 64 % (H // K):
        raise ValueError(f"prefill_attention: hd={hd}, G={H // K} not supported")
    if q.stride(-1) != 1:
        raise ValueError("prefill_attention: q's head_dim must be the unit-stride axis")
    if q.dtype == k_cache.dtype == torch.bfloat16:  # the tensor-core kernel
        _check_aligned16("prefill_attention", q, k_cache, v_cache)
    fn = kernels.function("prefill_attention")
    pos = q_pos.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    qs, ks, vs = q.stride(), k_cache.stride(), v_cache.stride()
    with torch.cuda.device(q.device):  # the launching thread's current device
        status = fn(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], hd,
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, Sq, H, K, Skv,
            qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], pos.stride(0),
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check_status("prefill_attention", status)
    launch_counts["prefill_attention"] += 1
    return out


# --------------------------------------------------------------------------- #
# ragged multi-query attention (the speculative verify's main-cache source)
# --------------------------------------------------------------------------- #


def ragged_attention_reference(
    q: torch.Tensor,  # [B, K, S, G, hd]
    k_cache: torch.Tensor,  # [B, K, W, hd]
    v_cache: torch.Tensor,
    q_starts: torch.Tensor,  # [B]
    kv_lens: torch.Tensor,  # [B]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the ragged kernel: the ragged source in f32,
    with f32 probabilities as the kernel keeps them → (o [B,K,S,G,hd]
    unnormalized, m [B,K,S,G], z [B,K,S,G])."""
    from calfkit_tpu_torch.inference.model import ragged_attention_source

    o, m, z = ragged_attention_source(
        q.float().transpose(1, 2), k_cache.float(), v_cache.float(), q_starts, kv_lens
    )  # the merge layout [B, K, G, S, ·] → the kernel's [B, K, S, G, ·]
    return o.transpose(2, 3), m[..., 0].transpose(2, 3), z[..., 0].transpose(2, 3)


def _check_ragged_q(name: str, q: torch.Tensor, B: int, *rows: torch.Tensor) -> None:
    if q.dim() != 5 or q.shape[0] != B or any(r.shape != (B,) for r in rows):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} must be [B, K, S, G, hd] with B = {B} and "
            f"starts/lens {[tuple(r.shape) for r in rows]} of shape [B]"
        )
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: hd={q.shape[-1]} not supported")


def ragged_attention(
    q: torch.Tensor,  # [B, K, S, G, hd] kv-head-major ragged queries
    k_cache: torch.Tensor,  # [B, K, W, hd], any strides with a unit last axis
    v_cache: torch.Tensor,
    q_starts: torch.Tensor,  # [B] absolute position of each row's query 0
    kv_lens: torch.Tensor,  # [B] valid kv length each row may attend
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (o [B,K,S,G,hd] f32 unnormalized, m [B,K,S,G] f32, z [B,K,S,G] f32).

    Query j of row b attends kv positions < min(kv_lens[b], q_starts[b] + j
    + 1), masked to -1e30 otherwise, m floored at -1e29, as the Pallas
    kernel does.  Any S and G; the window is read through its strides."""
    if _on_cpu(q, k_cache, v_cache, q_starts, kv_lens):
        return ragged_attention_reference(q, k_cache, v_cache, q_starts, kv_lens)
    name = "ragged_attention"
    _check_kv(name, k_cache, v_cache)
    _check_ragged_q(name, q, k_cache.shape[0], q_starts, kv_lens)
    B, K, S, G, hd = q.shape
    W = k_cache.shape[2]
    if k_cache.shape != (B, K, W, hd):
        raise ValueError(f"{name}: q {tuple(q.shape)} and cache {tuple(k_cache.shape)} differ")
    _check_aligned16(name, k_cache, v_cache)
    fn = kernels.function(name)
    starts = q_starts.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    ks, vs = k_cache.stride(), v_cache.stride()
    return _launch_stats(name, q, lambda qf, o, m, z, scale, stream: fn(
        _DTYPE_CODES[k_cache.dtype], hd,
        qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), starts.data_ptr(),
        lens.data_ptr(), o.data_ptr(), m.data_ptr(), z.data_ptr(),
        B, K, S, G, W, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, stream,
    ))


def ragged_attention_paged_reference(
    q: torch.Tensor,  # [B, K, S, G, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd]
    pool_v: torch.Tensor,
    layer: int,
    tables: torch.Tensor,  # [B, Pmax]
    q_starts: torch.Tensor,  # [B]
    kv_lens: torch.Tensor,  # [B]
    *,
    wpages: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the paged ragged kernel: gather each row's
    window of ``wpages`` pages, then :func:`ragged_attention_reference`."""
    from calfkit_tpu_torch.inference.model import gather_window_paged

    return ragged_attention_reference(
        q,
        gather_window_paged(pool_k[layer], tables, wpages),
        gather_window_paged(pool_v[layer], tables, wpages),
        q_starts, kv_lens,
    )


def ragged_attention_paged(
    q: torch.Tensor,  # [B, K, S, G, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd] the whole pool (never sliced)
    pool_v: torch.Tensor,
    layer: int,  # which layer's pages to read
    tables: torch.Tensor,  # [B, Pmax] int32 block tables
    q_starts: torch.Tensor,  # [B]
    kv_lens: torch.Tensor,  # [B]
    *,
    wpages: int,  # pages per attention window
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged ragged attention, the contract of :func:`ragged_attention` over
    the window of ``wpages`` pages that ``tables[b]`` names in layer
    ``layer`` of the pool → (o, m, z).  On CUDA the kernel reads each page
    in place through the block table; no window is gathered."""
    if _on_cpu(q, pool_k, pool_v, tables, q_starts, kv_lens):
        return ragged_attention_paged_reference(
            q, pool_k, pool_v, layer, tables, q_starts, kv_lens, wpages=wpages
        )
    name = "ragged_attention_paged"
    _check_kv(name, pool_k, pool_v)
    B = tables.shape[0] if tables.dim() == 2 else -1
    _check_ragged_q(name, q, B, q_starts, kv_lens)
    _, K, S, G, hd = q.shape
    L, N, _, page = pool_k.shape[:4]
    if pool_k.shape != (L, N, K, page, hd):
        raise ValueError(f"{name}: q {tuple(q.shape)} and pool {tuple(pool_k.shape)} differ")
    if not 0 <= layer < L or not 1 <= wpages <= tables.shape[1]:
        raise ValueError(
            f"{name}: layer {layer} of {L}, wpages {wpages} of {tables.shape[1]} table entries"
        )
    k_layer, v_layer = pool_k[layer], pool_v[layer]  # views: nothing is copied
    _check_aligned16(name, k_layer, v_layer)
    fn = kernels.function(name)
    tab = tables.to(torch.int32).contiguous()
    starts = q_starts.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    ks, vs = k_layer.stride(), v_layer.stride()
    return _launch_stats(name, q, lambda qf, o, m, z, scale, stream: fn(
        _DTYPE_CODES[pool_k.dtype], hd,
        qf.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(), tab.data_ptr(),
        starts.data_ptr(), lens.data_ptr(), o.data_ptr(), m.data_ptr(), z.data_ptr(),
        B, K, S, G, wpages, page, tab.stride(0),
        ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, stream,
    ))


def _merge_with_chunk(
    q: torch.Tensor,  # [B, S, H, hd]
    qg: torch.Tensor,  # q as [B, S, K, G, hd]
    source: tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # ragged (o, m, z), kernel layout
    chunk_k: torch.Tensor,  # [S, B, K, hd]
    chunk_v: torch.Tensor,
) -> torch.Tensor:
    """Fold the verify chunk's causal self-attention into a main-cache
    ragged source with the shared logsumexp merge → [B, S, H, hd] in q's
    dtype."""
    from calfkit_tpu_torch.inference.model import logsumexp_merge, verify_chunk_source

    o1, m1, z1 = source  # [B, K, S, G, ·] → merge layout [B, K, G, S, ·]
    out = logsumexp_merge(
        (o1.transpose(2, 3), m1.transpose(2, 3)[..., None], z1.transpose(2, 3)[..., None]),
        verify_chunk_source(qg, chunk_k, chunk_v),
    )  # [B, K, G, S, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)


def verify_attention(
    q: torch.Tensor,  # [B, S, H, hd] the verify chunk's queries
    k_cache: torch.Tensor,  # [B, K, W, hd] main-cache window (read-only)
    v_cache: torch.Tensor,
    chunk_k: torch.Tensor,  # [S, B, K, hd] this layer's chunk K (ring layout)
    chunk_v: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Multi-query verify attention: ONE :func:`ragged_attention` call
    scores all S queries against the window (verify rows: start = kv_len =
    base_lens), and the chunk's causal self-attention folds in with the
    shared logsumexp merge → [B, S, H, hd] in q's dtype."""
    B, S, H, hd = q.shape
    K = k_cache.shape[1]
    qg = q.reshape(B, S, K, H // K, hd)
    source = ragged_attention(qg.transpose(1, 2), k_cache, v_cache, base_lens, base_lens)
    return _merge_with_chunk(q, qg, source, chunk_k, chunk_v)


def verify_attention_paged(
    q: torch.Tensor,  # [B, S, H, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd]
    pool_v: torch.Tensor,
    layer: int,
    tables: torch.Tensor,  # [B, Pmax]
    chunk_k: torch.Tensor,  # [S, B, K, hd]
    chunk_v: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
    *,
    wpages: int,
) -> torch.Tensor:
    """The paged counterpart of :func:`verify_attention`: one
    :func:`ragged_attention_paged` call reads each page once for all S
    queries; the chunk folds in as the second source."""
    B, S, H, hd = q.shape
    K = pool_k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    source = ragged_attention_paged(
        qg.transpose(1, 2), pool_k, pool_v, layer, tables, base_lens, base_lens, wpages=wpages
    )
    return _merge_with_chunk(q, qg, source, chunk_k, chunk_v)
