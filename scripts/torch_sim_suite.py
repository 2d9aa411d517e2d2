#!/usr/bin/env python3
"""The port's pinned fleet-simulation suite against the committed report.

    python3 scripts/torch_sim_suite.py [--out PATH] [--scenario NAME ...]

Runs every scenario of ``calfkit_tpu_torch.sim.suite.PINNED_SUITE`` (or the
named ones) full-size through ``calfkit_tpu_torch.sim.SimRunner`` on the
host, under ``PYTHONHASHSEED=0`` as the suite's report is captured, and
holds each against the repo's ``SIM.json`` and ``SIM_BASELINE.json``:

- the verdicts: the scenario's, and each of its checks', equal SIM.json's;
- the bands: every gated metric within its baseline entry's band,
  ``max(|value| x rel_tol, abs_tol)`` (the tolerance policy of the
  baseline file).

Prints one JSON object (per scenario: seconds of host time, verdicts,
gated metrics against their bands, and how many of the report's metrics
equal SIM.json's exactly) and exits 1 if a verdict differs or a metric
leaves its band.  Host time only: no device is used.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

if os.environ.get("PYTHONHASHSEED") != "0":  # the suite's report is captured so
    os.execve(sys.executable, [sys.executable, *sys.argv],
              dict(os.environ, PYTHONHASHSEED="0"))

from calfkit_tpu_torch.sim import SimRunner  # noqa: E402
from calfkit_tpu_torch.sim.report import flatten_metrics  # noqa: E402
from calfkit_tpu_torch.sim.suite import PINNED_SUITE  # noqa: E402


def check_scenario(report: dict, committed: dict, baseline: dict) -> dict:
    """One scenario's report against its SIM.json entry and baseline."""
    checks = {c["name"]: c["passed"] for c in report["checks"]}
    want_checks = {c["name"]: c["passed"] for c in committed["checks"]}
    gated = {}
    flat = flatten_metrics(report["metrics"])
    for metric, entry in baseline.items():
        value = flat.get(metric)
        band = max(abs(entry["value"]) * entry["rel_tol"], entry["abs_tol"])
        gated[metric] = dict(value=value, baseline=entry["value"], band=band,
                             within=value is not None and abs(value - entry["value"]) <= band)
    mine, theirs = flat, flatten_metrics(committed["metrics"])
    return dict(
        passed=report["passed"], committed_passed=committed["passed"],
        checks_equal=checks == want_checks,
        gated=gated,
        metrics_equal=sum(1 for k, v in mine.items() if theirs.get(k) == v),
        metrics=len(mine),
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out")
    parser.add_argument("--scenario", action="append", help="run only this scenario")
    args = parser.parse_args()
    committed = {s["name"]: s for s in json.loads((REPO / "SIM.json").read_text())["scenarios"]}
    baseline = json.loads((REPO / "SIM_BASELINE.json").read_text())["scenarios"]
    out, ok = {}, True
    for scenario in PINNED_SUITE:
        if args.scenario and scenario.name not in args.scenario:
            continue
        started = time.perf_counter()
        report = asyncio.run(SimRunner(scenario).run()).to_dict()
        result = check_scenario(report, committed[scenario.name], baseline[scenario.name])
        result["host_s"] = time.perf_counter() - started
        ok &= (result["passed"] == result["committed_passed"] and result["checks_equal"]
               and all(g["within"] for g in result["gated"].values()))
        out[scenario.name] = result
        print(f"{scenario.name}: passed {result['passed']} (SIM.json {result['committed_passed']}), "
              f"checks equal {result['checks_equal']}, gated within band "
              f"{sum(g['within'] for g in result['gated'].values())}/{len(result['gated'])}, "
              f"{result['metrics_equal']}/{result['metrics']} metrics equal SIM.json's, "
              f"{result['host_s']:.1f} s", file=sys.stderr, flush=True)
    line = json.dumps(dict(ok=ok, scenarios=out), default=str)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
