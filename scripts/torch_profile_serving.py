#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes, on one CUDA card.

    python3 scripts/torch_profile_serving.py [--out PATH] [--preset NAME]
        [--device cuda|cpu]
        [--workload dense|paged|spec-paged|spec-dense|north-int8|north-bf16|north-int4]

Serves one of ``chip_smoke.py``'s serving workloads twice on one engine: the
first round warms up, the second runs under ``torch.profiler``.  ``dense``
(the default) is ``serving_jobs`` on ``SERVING_RUNTIME``: the ``llama-3-8b``
preset in bf16 with random weights from seed 0, 6 concurrent requests of
17–1500 prompt tokens, 32 new tokens each, one sampled.  ``paged`` is
``paged_serving_jobs`` on ``PAGED_RUNTIME`` (paged KV, prefix cache, chunked
ragged admission): both bursts at once, 48 new tokens each; the warm-up
round fills the prefix cache, so in the profiled round every prompt
reuses its cached pages.  ``spec-paged`` is ``paged`` with
``SpecConfig(k=4)`` and the target's own weights as the draft model;
``spec-dense`` is ``dense`` with the n-gram drafter (``SpecConfig(k=4)``).
``north-int8``, ``north-bf16`` and ``north-int4`` are the north-star drive
(``NORTH_STAR_RUNTIME``, ``north_star_jobs``: 32 requests of 64 + 128
tokens, the preset at ``max_seq_len`` 1024) with int8 or int4 weights built
on the host (``north_star_params``) or bf16 from the engine's random init.
Prints one JSON object: the profiled window's wall
time, the device's busy time (union of kernel intervals) and idle share,
launches and device time per kernel family, the top kernels by device time,
the round's decode dispatches and tokens, and the engine's CUDA graph
captures and replays over both rounds (the first round captures each
dispatch key, the profiled one replays).  ``--device cpu --preset debug`` rehearses the
script on the CPU (no device metrics then).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dataclasses import replace  # noqa: E402

from calfkit_tpu_torch.inference import model as M  # noqa: E402
from calfkit_tpu_torch.inference.config import SpecConfig, preset  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from chip_smoke import (  # noqa: E402
    NORTH_STAR_RUNTIME,
    PAGED_RUNTIME,
    SERVING_RUNTIME,
    north_star_jobs,
    north_star_params,
    paged_serving_jobs,
    serving_jobs,
)

FAMILIES = (  # kernel-name substring → family, first match wins
    ("paged_walk_attn", "decode or ragged attention kernel"),  # bf16 pools
    ("split_attn", "decode or ragged attention kernel"),  # dense caches, f32 pools
    ("ragged_paged_attn", "paged ragged attention kernel"),
    ("ragged_attn", "ragged attention kernel"),
    ("paged_decode_attn", "paged decode attention kernel"),
    ("decode_attn", "decode attention kernel"),
    ("prefill_attn", "prefill attention kernel"),
    ("nvjet", "matmul (cuBLAS)"),
    ("gemm", "matmul (cuBLAS)"),
    ("xmma", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
)


def family(name: str) -> str:
    for key, fam in FAMILIES:
        if key.lower() in name.lower():
            return fam
    return "other elementwise/reduction"


def busy_us(intervals: "list[tuple[float, float]]") -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


async def serve(engine, jobs):
    async def one(p, n, kw):
        return [t async for t in engine.generate(p, max_new_tokens=n, **kw)]
    return await asyncio.gather(*[one(p, n, kw) for p, n, kw in jobs])


async def run(args) -> dict:
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    cfg = preset(args.preset)
    if args.workload in ("paged", "spec-paged"):
        rt = PAGED_RUNTIME
        burst_a, burst_b = paged_serving_jobs(cfg.vocab_size)
        jobs = [(p, 48, {}) for p in burst_a + burst_b]
    else:
        rt = SERVING_RUNTIME
        _, jobs = serving_jobs(cfg.vocab_size)
    if args.workload.startswith("north-"):
        quantization = {"north-int8": "int8", "north-int4": "int4"}.get(args.workload)
        cfg = preset(args.preset, max_seq_len=NORTH_STAR_RUNTIME.max_seq_len)
        rt = replace(NORTH_STAR_RUNTIME, quantization=quantization)
        jobs = north_star_jobs()
        engine = InferenceEngine(
            cfg, rt, params=north_star_params(cfg, quantization), seed=0, device=dev
        )
    elif args.workload == "spec-paged":  # the draft model reads the target's tensors
        rt = replace(rt, speculative=SpecConfig(k=4, draft=cfg))
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        engine = InferenceEngine(cfg, rt, params=params, draft_params=params, device=dev)
        del params
    else:
        if args.workload == "spec-dense":
            rt = replace(rt, speculative=SpecConfig(k=4))
        engine = InferenceEngine(cfg, rt, seed=0, device=dev)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    await engine.start()
    try:
        await serve(engine, jobs)  # warm-up round
        engine.stats = type(engine.stats)()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            await serve(engine, jobs)
            if cuda:
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        stats = engine.stats
    finally:
        await engine.stop()
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    by_family: dict[str, list] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        dt = e.time_range.end - e.time_range.start
        for table, key in ((by_family, family(e.name)), (by_name, e.name)):
            entry = table.setdefault(key, [0, 0.0])
            entry[0] += 1
            entry[1] += dt
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6
    # a verify dispatch is one step; a decode dispatch decode_steps_per_dispatch
    steps = stats.decode_dispatches * (1 if rt.speculative else rt.decode_steps_per_dispatch)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(
        device=torch.cuda.get_device_name(0) if cuda else "cpu (no device metrics)",
        card=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip() if cuda else None,
        preset=args.preset, workload=args.workload, wall_s=wall_s,
        device_busy_s=busy if cuda else None,
        device_idle_share=(1.0 - busy / wall_s) if cuda else None,
        by_family={
            k: dict(launches=c, device_s=t / 1e6) for k, (c, t) in sorted(by_family.items())
        },
        top_kernels=[dict(name=n[:90], calls=c, device_s=t / 1e6) for n, (c, t) in top],
        kernel_launches=len(kernels),
        decode_dispatches=stats.decode_dispatches, decode_steps=steps,
        decode_time_s=stats.decode_time_s, decode_tokens=stats.decode_tokens,
        decode_tok_s=stats.tokens_per_second, prefill_waves=stats.prefill_waves,
        prefill_device_s=stats.device_prefill_s + stats.device_mixed_s,
        prefix_hits=stats.prefix_hits,
        unified_dispatches=stats.unified_dispatches, spec_rows=stats.spec_rows,
        acceptance_rate=stats.acceptance_rate, tokens_per_dispatch=stats.tokens_per_dispatch,
        # the compiled-dispatch layer's counts over both rounds (absent
        # from a tree that has no such layer)
        graphs=dict(engine._graphs.stats) if hasattr(engine, "_graphs") else None,
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out")
    parser.add_argument("--preset", default="llama-3-8b")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--workload", default="dense", choices=(
        "dense", "paged", "spec-paged", "spec-dense", "north-int8", "north-bf16", "north-int4"))
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_profile_serving: no CUDA device", file=sys.stderr)
        return 2
    result = asyncio.run(run(args))
    line = json.dumps(result, default=str)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
