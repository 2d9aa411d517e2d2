#!/usr/bin/env python3
"""Run one cell of the benchmark on this machine's card.

    python3 loadbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root (or a checkout of it).  ``<cell>`` is a
``workloads`` entry of ``BENCHMARK.json``.  Prints the numbers it compared
with their limits as the last lines of standard error, and one JSON object
as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``.  Exits non-zero, printing no result,
without enough CUDA devices, with an invalid ``BENCHMARK.json``, or if the
JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# a run that has not ended by then prints every thread's stack and exits
# non-zero, inside the 360 s a run of a cell may take
RUN_LIMIT_S = 330


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _STARTED


def parse(argv: "list[str] | None") -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def caches() -> None:
    """Every build and kernel cache at a fixed directory of the checkout."""
    base = ROOT / "loadbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def report(result: dict, diagnostics: dict, log=sys.stderr) -> None:
    """Diagnostics, then each compared number beside its limit as the last
    lines of standard error; the result as the last line of standard output."""
    print("loadbench: " + json.dumps(diagnostics, default=str), file=log)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=log)
    log.flush()
    print(json.dumps(result), flush=True)


def main(argv: "list[str] | None" = None, control: bool = False) -> int:
    args = parse(argv)
    started = process_start()
    faulthandler.dump_traceback_later(RUN_LIMIT_S - (time.perf_counter() - started), exit=True)
    caches()
    sys.path.insert(0, str(ROOT))
    from loadbench import guard, manifest

    try:
        bench = manifest.load(ROOT)
        cell = manifest.cell(bench, args.workload)
    except manifest.ManifestError as exc:
        print(f"loadbench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"loadbench: cell {cell['name']} needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 3
    from loadbench import harness

    result, diagnostics = harness.run(
        bench, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
        started, control=control,
    )
    found = guard.forbidden()
    if found:
        print(f"loadbench: loaded modules of the JAX package or JAX: {found}", file=sys.stderr)
        return 4
    report(result, diagnostics)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
