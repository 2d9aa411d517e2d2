#!/usr/bin/env python3
"""Drive the PyTorch port (``calfkit_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failed check raises, so the exit code is non-zero and
the final ``ok`` line is never printed:

1. print the card's name and power limit; build the hand-written kernels
   from ``calfkit_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. kernel phase: every kernel against its plain PyTorch version on the card
   at the serving path's shapes, with its time, the plain version's time,
   one PyTorch library call computing the same function
   (``scaled_dot_product_attention``) and the least time the card could
   take (bytes over 3.35 TB/s or operations over the type's peak rate);
3. exactness phase: the engine at Llama-3-8B widths, f32, 4 layers, greedy:
   overlapped and lockstep streams are identical and equal a step-by-step
   greedy recompute through ``model.forward`` with the plain attention;
4. serving phase: the full ``llama-3-8b`` preset in bf16 with random weights
   from a seed, 6 concurrent requests through both kernels (launch counts
   reset just before and read just after), then the same 6 with a stop
   token on one; prints TTFT and decode tokens/s.

The line before the last is ``nvidia-smi``'s name and power limit; the
``kernels`` JSON line precedes it; the last line is the ``ok`` JSON object.
``--out`` also writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from calfkit_tpu_torch import kernels
from calfkit_tpu_torch.inference import attention as A
from calfkit_tpu_torch.inference import model as M
from calfkit_tpu_torch.inference.config import RuntimeConfig, preset
from calfkit_tpu_torch.inference.engine import InferenceEngine
from calfkit_tpu_torch.inference.sampler import SamplingParams

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor-core bf16; f32 CUDA cores
SOURCES = {
    "decode_attention": (
        "calfkit_tpu_torch/csrc/decode_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:60",
    ),
    "prefill_attention": (
        "calfkit_tpu_torch/csrc/prefill_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:687",
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


def decode_case(dev, dtype, B, K, G, hd, W, lens, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, G, hd), generator=g, device=dev)
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
    return dict(
        name="decode_attention", shape=dict(B=B, K=K, G=G, hd=hd, W=W, dtype=str(dtype)),
        max_abs_err=err, tol=DECODE_TOL,
        ms=time_ms(lambda: A.decode_attention(q, k, v, base)),
        plain_ms=time_ms(lambda: A.decode_attention_reference(q, k, v, base), iters=5),
        library_ms=_sdpa_ms(qs, k, v, mask=mask),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def prefill_case(dev, dtype, R, S, H, K, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((R, S, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((R, K, S, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((R, K, S, hd), generator=g, device=dev).to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(R, S).contiguous()
    lens = torch.full((R,), S, dtype=torch.int32, device=dev)
    out = A.prefill_attention(q, k, v, pos, lens)
    ref = A.prefill_attention_reference(q, k, v, pos, lens)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    torch.testing.assert_close(out.float(), ref.float(), **PREFILL_TOL[dtype])
    kept = R * S * (S + 1) // 2  # causal (query, key) pairs
    ops = 4 * hd * H * kept
    bytes_ms = _nbytes(q, k, v, pos, lens, out) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    return dict(
        name="prefill_attention", shape=dict(R=R, S=S, H=H, K=K, hd=hd, dtype=str(dtype)),
        max_abs_err=err, tol=PREFILL_TOL[dtype],
        ms=time_ms(lambda: A.prefill_attention(q, k, v, pos, lens), iters=5),
        plain_ms=time_ms(lambda: A.prefill_attention_reference(q, k, v, pos, lens), iters=3),
        library_ms=_sdpa_ms(q.transpose(1, 2), k, v, causal=True),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def kernel_phase(dev) -> "tuple[list[dict], dict]":
    """→ (every measured case, the case of each kernel at a shape the
    serving phase gives it: its decode batch and window, its largest
    prefill wave)."""
    ragged = {256: [0, 1, 31, 64, 100, 200, 255, 256],
              2048: [17, 300, 777, 1024, 1500, 1600, 2000, 2048]}
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for W in (256, 2048):
            cases.append(decode_case(dev, dtype, 8, 8, 4, 128, W, ragged[W], seed=W))
    cases.append(decode_case(dev, torch.bfloat16, 8, 4, 8, 64, 2048, ragged[2048], seed=7))
    for dtype in (torch.bfloat16, torch.float32):
        for R in (1, 4):
            for S in (512, 2048):
                cases.append(prefill_case(dev, dtype, R, S, 32, 8, 128, seed=R * S))
    cases.append(prefill_case(dev, torch.bfloat16, 4, 2048, 32, 4, 64, seed=3))
    # the serving phase's largest prefill wave: two prompts in the 1536 bucket
    cases.append(prefill_case(dev, torch.bfloat16, 2, 1536, 32, 8, 128, seed=5))
    for c in cases:
        print(
            f"  {c['name']} {c['shape']}: max_abs_err {c['max_abs_err']:.3e} "
            f"(tol {c['tol']}) ms {c['ms']:.4f} plain_ms {c['plain_ms']:.4f} "
            f"sdpa_ms {c['library_ms']:.4f} bound_ms {c['bound_ms']:.4f} ({c['bound_by']})"
        )
    main = {
        "decode_attention": next(
            c for c in cases if c["name"] == "decode_attention"
            and c["shape"] == dict(B=8, K=8, G=4, hd=128, W=2048, dtype="torch.bfloat16")
        ),
        "prefill_attention": next(
            c for c in cases if c["name"] == "prefill_attention"
            and c["shape"] == dict(R=2, S=1536, H=32, K=8, hd=128, dtype="torch.bfloat16")
        ),
    }
    return cases, main


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


async def exactness_phase(dev) -> dict:
    cfg = preset("llama-3-8b", n_layers=4, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(1)
    params = M.init_params(cfg, g)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 77, 300)]
    jobs = [(p, 12, {}) for p in prompts]
    streams = {}
    for overlap in (True, False):
        rt = RuntimeConfig(
            max_batch_size=4, max_seq_len=1024, prefill_chunk=128,
            decode_steps_per_dispatch=8, overlap_dispatch=overlap,
        )
        engine = InferenceEngine(cfg, rt, params=params, device=dev)
        await engine.start()
        try:
            streams[overlap], _, _ = await serve(engine, jobs)
        finally:
            await engine.stop()
        del engine
    assert streams[True] == streams[False], "overlapped and lockstep streams differ"
    for prompt, stream in zip(prompts, streams[True]):
        assert len(stream) == 12
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
    print("  exactness: 3 greedy streams x 12 tokens, overlap == lockstep == recompute")
    return dict(streams=streams[True])


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
        assert all(n > 0 for n in launches.values()), launches
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

    line = {"kernels": []}
    for name, c in main_cases.items():
        source, replaces = SOURCES[name]
        line["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=serving["launches"][name], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
        ))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, cases=cases, exactness=exact, serving=serving,
                           kernels=line["kernels"]), f, indent=1, default=str)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
