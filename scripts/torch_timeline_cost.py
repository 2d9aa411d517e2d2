#!/usr/bin/env python3
"""The host cost of the port engine's dispatch timeline on a CUDA card,
timed directly, two ways.

    python3 scripts/torch_timeline_cost.py --workload <cell> --seed <n>
        [--seconds S] [--out PATH]

1. Alone: the timeline's bookkeeping of one engine tick (the worker hop's
   and the landing's phase stamps, a dispatch's two marks, the staged
   mark, the landing's sync that reads both marks, the gap flag), run
   20,000 times around a small kernel on one thread, against the same loop
   without it; the difference per tick is the bookkeeping's host time.
2. In a cell: every method of
   :class:`~calfkit_tpu_torch.inference.timeline.DispatchTimeline` and the
   engine's ``_note_admitted`` wrapped in a ``time.perf_counter``
   accumulator through one run of ``<cell>`` (``loadbench/run.py``, its
   result line on standard output as usual).  This is wall time on the
   dispatch thread, so it also holds the waits for the interpreter's lock
   while the event loop runs; the wrapper's own cost per call (an empty
   method wrapped alike) is taken off.

Prints one JSON object on standard error and to ``--out``.  Run from the
repository's root.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from calfkit_tpu_torch.inference import engine as E  # noqa: E402
from calfkit_tpu_torch.inference.timeline import DispatchTimeline, EventClock  # noqa: E402

METHODS = ("phase", "idle", "flag_next", "begin", "end", "mark", "sync", "drained")


def alone(device: torch.device, n: int = 20_000) -> dict:
    """Host µs per tick of the bookkeeping, on one thread, against the same
    loop of kernel launches and syncs without it."""
    x = torch.zeros(1 << 12, device=device)
    timeline = DispatchTimeline(EventClock(device), E.EngineStats())

    def tick(book: bool) -> None:
        if book:
            timeline.phase("loop")  # the hop out
            timeline.phase("prep")  # the worker starts
            timeline.flag_next()
            rec = timeline.begin()
            timeline.phase("launch")
        x.add_(1.0)
        if book:
            timeline.end(rec, "decode")
            mark = timeline.mark()
            timeline.phase("land")
        torch.cuda.current_stream(device).synchronize()
        if book:
            timeline.sync(mark)
            timeline.phase("loop")  # the worker returns
            timeline.phase("schedule")  # the pass resumes

    out = {}
    for _ in range(2):  # the first round warms both loops up
        for book in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                tick(book)
            out[book] = (time.perf_counter() - t0) / n
    return dict(ticks=n, plain_us=1e6 * out[False], with_bookkeeping_us=1e6 * out[True],
                us_per_tick=1e6 * (out[True] - out[False]))


def _wrap(owner: type, name: str, spent: dict, calls: dict) -> None:
    original = getattr(owner, name)

    @functools.wraps(original)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            spent[name] += time.perf_counter() - t0
            calls[name] += 1

    setattr(owner, name, timed)


def _wrapper_cost(n: int = 200_000) -> float:
    """Seconds one call of an empty method costs through the wrapper,
    beyond a plain call."""

    class Empty:
        def f(self):
            return None

    spent, calls = {"f": 0.0}, {"f": 0}
    e = Empty()
    t0 = time.perf_counter()
    for _ in range(n):
        e.f()
    plain = time.perf_counter() - t0
    _wrap(Empty, "f", spent, calls)
    t0 = time.perf_counter()
    for _ in range(n):
        e.f()
    return max(0.0, (time.perf_counter() - t0 - plain) / n)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=51)
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("timeline_cost: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    isolated = alone(device)
    overhead = _wrapper_cost()
    names = (*METHODS, "_note_admitted")
    spent, calls = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for name in METHODS:
        _wrap(DispatchTimeline, name, spent, calls)
    _wrap(E.InferenceEngine, "_note_admitted", spent, calls)
    from loadbench import run

    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "0"])
    dispatches = calls["begin"]
    total = sum(spent.values()) - overhead * sum(calls.values())
    out = dict(
        device=torch.cuda.get_device_name(device), alone=isolated,
        workload=args.workload, seed=args.seed, dispatches=dispatches,
        wrapper_us_per_call=overhead * 1e6,
        wall_us_per_dispatch=1e6 * total / dispatches if dispatches else None,
        methods={n: dict(calls=calls[n], us=1e6 * (spent[n] - overhead * calls[n]))
                 for n in names},
    )
    text = json.dumps(out)
    print("timeline_cost: " + text, file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
