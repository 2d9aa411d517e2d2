#!/usr/bin/env python3
"""Find the highest rate an open-loop cell sustains: hold its traffic at
each of a few fixed rates on one engine and see whether a backlog grows.

    python3 loadbench/sweep.py --workload <cell> --seed <n> --rates 2,3,4 --hold 40

One process builds the cell's engine once, then for each rate runs the
cell's traffic with ``sessions_per_s`` set to it for ``--hold`` seconds and
drains it.  Per rate it prints one JSON line: the requests due and
finished, TTFT and turn time (p50, p95) of the requests due in the hold's
first and second halves, the requests waiting for their first token at the
hold's end, and the tokens served per second.  A rate is sustained where
the second half's TTFT is not above the first's and nothing piles up.  The
benchmark's runs never run it; the rate chosen goes into the traffic file.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _summary(records: list, lo: float, hi: float) -> dict:
    from loadbench.harness import percentile

    done = [r for r in records if lo <= r.due < hi and r.complete]
    if not done:
        return {"finished": 0}
    return dict(
        finished=len(done),
        ttft_p50_ms=percentile([(r.times[0] - r.due) * 1e3 for r in done], 50),
        ttft_p95_ms=percentile([(r.times[0] - r.due) * 1e3 for r in done], 95),
        turn_p50_ms=percentile([(r.times[-1] - r.due) * 1e3 for r in done], 50),
        turn_p95_ms=percentile([(r.times[-1] - r.due) * 1e3 for r in done], 95),
    )


async def sweep(cell: dict, rates: list, hold: float, seed: int, device) -> None:
    from loadbench import configs, drive, harness, traffic

    config = configs.load(cell["config"])
    spec = traffic.load(cell["traffic"])
    engine, gen, plan, _ = harness.build(cell, config, spec, seed, hold, device, False, sys.stderr)
    await engine.start()
    try:
        for i, rate in enumerate(rates):
            plan = gen.plan(dict(spec, sessions_per_s=rate), seed + i, config["vocab_size"],
                            config["runtime"]["max_seq_len"], hold)
            start = drive.Context.now() + 0.05
            ctx = drive.Context(engine, start, start + hold)
            task = asyncio.ensure_future(gen.drive(plan, ctx))
            await ctx.sleep_until(ctx.stop_at)
            waiting = sum(1 for r in ctx.records if not r.times)
            tokens = sum(1 for r in ctx.records for t in r.times if t < ctx.stop_at)
            await task
            records = ctx.records
            print(json.dumps(dict(
                rate=rate, hold_s=hold, due=len(records),
                waiting_at_end=waiting, served_tok_s=tokens / hold,
                first_half=_summary(records, start, start + hold / 2),
                second_half=_summary(records, start + hold / 2, start + hold),
            )), flush=True)
    finally:
        await engine.stop()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--hold", type=float, default=40.0)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from loadbench import manifest

    import torch

    if not torch.cuda.is_available():
        print("loadbench: the sweep needs a CUDA device", file=sys.stderr)
        return 3
    cell = manifest.cell(manifest.load(ROOT), args.workload)
    rates = [float(x) for x in args.rates.split(",")]
    asyncio.run(sweep(cell, rates, args.hold, args.seed, torch.device("cuda", 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
