"""``ck sim`` — render a fleet-simulation report.

Reads a ``SIM.json`` (the JAX package's ``scripts/perf_gate.py`` writes
one; so does any :meth:`calfkit_tpu_torch.sim.report.SimReport.to_json`
document) and renders one row per scenario plus the failed checks, so an
operator can read a CI perf-gate artifact without spelunking JSON.  ``--checks`` expands
every check row; ``--scenario`` filters to one.

The renderer is a pure function over the parsed document
(:func:`render_sim_table`) — tested without a CLI runner, same pattern
as ``render_fleet_table``.
"""

from __future__ import annotations

import json
from typing import Any

from calfkit_tpu_torch.cli._common import CliError, command, echo, flag, option


def _fmt(value: "Any") -> str:
    if value is None:
        return "-"
    if isinstance(value, bool):
        return "yes" if value else "no"
    if isinstance(value, float):
        return f"{value:.3f}".rstrip("0").rstrip(".")
    return str(value)


def _metric(scenario: "dict[str, Any]", path: str) -> "Any":
    node: Any = scenario.get("metrics", {})
    for part in path.split("."):
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    return node


def render_sim_table(
    document: "dict[str, Any]",
    *,
    show_checks: bool = False,
    only: "str | None" = None,
) -> str:
    """The ``ck sim`` body: one row per scenario, failed checks always
    expanded (a pass/fail table that hides WHY it failed is useless),
    every check expanded with ``show_checks``."""
    scenarios = [
        s
        for s in document.get("scenarios", [])
        if only is None or s.get("name") == only
    ]
    rows: "list[tuple[str, ...]]" = [
        (
            "SCENARIO", "VERDICT", "REPLICAS", "OFFERED", "COMPLETED",
            "FAILED", "SHEDS", "FAILOVERS", "HIT RATE", "SKEW P95",
            "MAKESPAN S",
        )
    ]
    for s in scenarios:
        rows.append(
            (
                str(s.get("name", "?")),
                "pass" if s.get("passed") else "FAIL",
                _fmt(s.get("replicas")),
                _fmt(_metric(s, "requests.offered")),
                _fmt(_metric(s, "requests.completed")),
                _fmt(_metric(s, "requests.failed")),
                _fmt(_metric(s, "shed.sheds")),
                _fmt(_metric(s, "routing.failover_arrivals")),
                _fmt(_metric(s, "prefix.hit_rate")),
                _fmt(_metric(s, "routing.skew_p95_over_mean")),
                _fmt(_metric(s, "time.makespan_s")),
            )
        )
    widths = [
        max(len(row[i]) for row in rows) for i in range(len(rows[0]))
    ]
    lines = [
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row))
        .rstrip()
        for row in rows
    ]
    for s in scenarios:
        checks = s.get("checks", [])
        shown = [
            c for c in checks if show_checks or not c.get("passed", True)
        ]
        if not shown:
            continue
        lines.append("")
        lines.append(f"{s.get('name')}:")
        for c in shown:
            mark = "ok  " if c.get("passed") else "FAIL"
            lines.append(
                f"  [{mark}] {c.get('name')}: {c.get('metric')} "
                f"{c.get('op')} {_fmt(c.get('bound'))} "
                f"(got {_fmt(c.get('value'))})"
            )
    capture = document.get("capture") or {}
    suite = document.get("suite", "?")
    verdict = "pass" if document.get("passed") else "FAIL"
    footer = f"suite {suite}: {verdict}"
    if capture.get("captured_at"):
        footer += f"  (captured {capture['captured_at']}"
        if capture.get("wall_s") is not None:
            footer += f", wall {capture['wall_s']}s — not a gated metric"
        footer += ")"
    lines.extend(["", footer])
    return "\n".join(lines)


@command(
    "sim",
    option("--path", default="SIM.json", show_default=True, help="report file to render"),
    flag("--checks", "show_checks", help="expand every check row (failed checks always show)"),
    option("--scenario", "only", help="render one scenario only"),
    help="render a fleet-simulation report (SIM.json from "
         "scripts/perf_gate.py)",
)
def sim_command(path: str, show_checks: bool, only: "str | None") -> None:
    try:
        with open(path) as f:
            document = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise CliError(f"cannot read {path}: {exc}") from None
    echo(render_sim_table(document, show_checks=show_checks, only=only))
    if not document.get("passed"):
        raise SystemExit(1)
