#!/usr/bin/env python3
"""The device's idle in one benchmark cell, from the engine's dispatch
timeline and from ``torch.profiler``, over the same slices of one run.

    python3 scripts/torch_idle_check.py --workload <cell> --seed <n>
        [--slice S] [--out PATH]

Builds the cell's engine and traffic as ``loadbench`` does, runs the
traffic past its ramp, and reads three slices of ``S`` seconds (3 by
default) in turn: untraced, under ``torch.profiler`` (CUDA activity, its
start and stop holding graph replays as the benchmark's traced phase
does), and untraced again.  For each slice it prints the timeline's idle
between dispatches (``device_gap_s`` over the slice) and device time by
kind; for the traced slice also the profiler's idle (one less the union of
the kernels' intervals over the slice, the benchmark's ``idle_share``),
split by the length of each hole between kernels, so that the holes inside
a dispatch's graph (a few µs between dependent kernels) stand apart from
the idle between dispatches, and the slice's ends that no kernel covers
(``head_s``: its first traced host call to its first kernel; ``tail_s``:
its last kernel to its last traced host call).  Also the engine's
dispatch-gap histogram over the run.  One JSON object on standard output and to
``--out``.  Run from the repository's root on a CUDA card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the holes between kernels, by length (µs): their count and seconds
BINS = (5.0, 50.0, 500.0, 5000.0, float("inf"))
TIMELINE = ("device_decode_s", "device_mixed_s", "device_prefill_s", "device_gap_s",
            "gap_schedule_s", "gap_loop_s", "gap_prep_s", "gap_launch_s", "gap_land_s",
            "gap_drained_s", "decode_steps")


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in TIMELINE}


def _shares(d: dict, seconds: float) -> dict:
    out = dict(d, seconds=seconds)
    out["gap_share_pct"] = 100.0 * d["device_gap_s"] / seconds
    out["device_s"] = d["device_decode_s"] + d["device_mixed_s"] + d["device_prefill_s"]
    return out


def holes(slice_) -> dict:
    """The profiler's idle over the slice: the holes between the union of
    the device operations, binned by length, and the slice's ends that no
    operation covers."""
    from loadbench.trace import busy_us, gaps_us

    spans = [(s, e) for _, s, e in slice_.device_ops]
    window_us = slice_.window_s * 1e6
    busy = busy_us(spans)
    found = gaps_us(spans)
    bins = {f"<{b:g}us": [0, 0.0] for b in BINS}
    for s, e in found:
        width = e - s
        for b in BINS:
            if width < b:
                entry = bins[f"<{b:g}us"]
                entry[0] += 1
                entry[1] += width / 1e6
                break
    inner = sum(e - s for s, e in found)
    # the slice's ends on the profiler's clock, from the host's traced calls
    host = [(s, e) for _, s, e in slice_.host_ops]
    out = dict(
        idle_share_pct=100.0 * (1.0 - busy / window_us) if window_us > 0 else None,
        holes=bins, holes_s=inner / 1e6,
        uncovered_ends_s=(window_us - busy - inner) / 1e6,
    )
    if spans and host:
        out.update(
            head_s=(min(s for s, _ in spans) - min(s for s, _ in host)) / 1e6,
            tail_s=(max(e for _, e in host) - max(e for _, e in spans)) / 1e6,
        )
    return out


async def _measure(cell: dict, config: dict, spec: dict, seed: int, seconds: float) -> dict:
    import torch

    from loadbench import drive, harness
    from loadbench.trace import reduce

    device = torch.device("cuda", 0)
    horizon = spec["ramp_s"] + 3 * seconds + 10
    engine, gen, plan, _ = harness.build(cell, config, spec, seed, horizon, device, False,
                                         sys.stderr)
    # the profiler's first start sets up its device tracing: do it idle
    warm = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    warm.start()
    warm.stop()
    await engine.start()
    start_at = time.perf_counter() + 0.05
    ctx = drive.Context(engine, start_at, start_at + horizon)
    task = asyncio.ensure_future(gen.drive(plan, ctx))
    out: dict = {}
    try:
        await ctx.sleep_until(start_at + spec["ramp_s"])
        t0, c0 = time.perf_counter(), engine.stats.counters()
        await asyncio.sleep(seconds)
        t1, c1 = time.perf_counter(), engine.stats.counters()
        out["untraced_before"] = _shares(_delta(c0, c1), t1 - t0)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with harness.replay_gate() as gate:
            with gate:
                prof.start()
            t_a, c_a = time.perf_counter(), engine.stats.counters()
            await asyncio.sleep(seconds)
            with gate:
                torch.cuda.synchronize(device)
                t_b, c_b = time.perf_counter(), engine.stats.counters()
                prof.stop()
        out["traced"] = _shares(_delta(c_a, c_b), t_b - t_a)
        out["traced"].update(holes(reduce(prof, t_a, t_b)))
        out["profiler_stop_s"] = time.perf_counter() - t_b
        # the device idled while the stop held the event loop: that gap
        # settles at the next landing, before the next slice starts
        await asyncio.sleep(1.0)
        t2, c2 = time.perf_counter(), engine.stats.counters()
        await asyncio.sleep(seconds)
        t3, c3 = time.perf_counter(), engine.stats.counters()
        out["untraced_after"] = _shares(_delta(c2, c3), t3 - t2)
    finally:
        await engine.stop()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
    hist = engine.latency["dispatch_gap_ms"]
    out["dispatch_gap_ms"] = dict(count=hist.count, sum=hist.sum,
                                  p50=hist.percentile(0.5), p99=hist.percentile(0.99))
    out["device"] = torch.cuda.get_device_name(device)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--slice", type=float, default=3.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("idle_check: needs a CUDA device", file=sys.stderr)
        return 3
    from loadbench import configs, manifest, traffic

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, args.workload)
    out = asyncio.run(_measure(cell, configs.load(cell["config"]),
                               traffic.load(cell["traffic"]), args.seed, args.slice))
    out.update(workload=args.workload, seed=args.seed)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
