"""Scenario metrics: harvesting, verdicts, and the SIM.json shape.

A :class:`ScenarioReport` is one scenario's deterministic outcome — the
counters the mesh/fleet stack already keeps (delivery ledgers, heartbeat
adverts, shed/failover counts, prefix-cache hits, lease-store state)
folded into one structured dict, plus the scenario's :class:`Check`
verdicts evaluated over it.  A :class:`SimReport` is the whole suite;
``to_json()`` is the SIM.json artifact.

Determinism contract: every value inside ``scenarios`` is a pure
function of (scenario definition, seed) — byte-identical across repeat
runs and across hosts.  Host-varying facts (wall-clock runtime, capture
timestamp, git sha) live ONLY under the top-level ``capture`` key, which
the determinism test strips before comparing (and which the perf gate
never reads).
"""

from __future__ import annotations

from calfkit_tpu_torch.effects import no_wallclock
import json
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "CheckResult",
    "ScenarioReport",
    "SimReport",
    "metric_at",
    "flatten_metrics",
    "percentile",
]

SIM_SCHEMA_VERSION = 1


@no_wallclock
def percentile(values: "list[float]", q: float) -> float:
    """Deterministic nearest-rank percentile (no interpolation jitter);
    0.0 on empty input."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = min(len(ordered) - 1, max(0, int(q * len(ordered))))
    return float(ordered[rank])


@no_wallclock
def metric_at(tree: "dict[str, Any]", path: str) -> "float | None":
    """Resolve a dotted metric path (``"requests.completed"``) to a
    number; None when the path is missing or non-numeric — callers treat
    that as a failed check, never as zero."""
    node: Any = tree
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    if isinstance(node, bool) or not isinstance(node, (int, float)):
        return None
    return float(node)


@no_wallclock
def flatten_metrics(
    tree: "dict[str, Any]", prefix: str = ""
) -> "dict[str, float]":
    """Every numeric leaf as ``dotted.path -> value`` (the perf gate's
    comparison surface)."""
    out: dict[str, float] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_metrics(value, f"{path}."))
        elif isinstance(value, bool):
            continue
        elif isinstance(value, (int, float)):
            out[path] = float(value)
    return out


@dataclass(frozen=True)
class CheckResult:
    name: str
    metric: str
    op: str
    bound: float
    value: "float | None"
    passed: bool

    def to_dict(self) -> "dict[str, Any]":
        return {
            "name": self.name,
            "metric": self.metric,
            "op": self.op,
            "bound": self.bound,
            "value": self.value,
            "passed": self.passed,
        }


@dataclass
class ScenarioReport:
    """One scenario's outcome.  ``metrics`` is the deterministic tree the
    checks and the perf gate read; ``checks`` are the evaluated
    verdicts; ``passed`` is their conjunction."""

    name: str
    seed: int
    replicas: int
    metrics: "dict[str, Any]" = field(default_factory=dict)
    checks: "list[CheckResult]" = field(default_factory=list)
    gated: "tuple[str, ...]" = ()

    @property
    def passed(self) -> bool:
        return all(c.passed for c in self.checks)

    def metric(self, path: str) -> "float | None":
        return metric_at(self.metrics, path)

    def gated_metrics(self) -> "dict[str, float]":
        """The baseline-compared subset, resolved (missing gated path =
        absent from the result; the gate treats absence as regression)."""
        out: dict[str, float] = {}
        for path in self.gated:
            value = self.metric(path)
            if value is not None:
                out[path] = value
        return out

    def to_dict(self) -> "dict[str, Any]":
        return {
            "name": self.name,
            "seed": self.seed,
            "replicas": self.replicas,
            "passed": self.passed,
            "metrics": self.metrics,
            "checks": [c.to_dict() for c in self.checks],
            "gated": list(self.gated),
        }


@dataclass
class SimReport:
    """The whole suite run → SIM.json."""

    suite: str
    scenarios: "list[ScenarioReport]" = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return bool(self.scenarios) and all(s.passed for s in self.scenarios)

    def scenario(self, name: str) -> "ScenarioReport | None":
        for report in self.scenarios:
            if report.name == name:
                return report
        return None

    def to_dict(
        self, *, capture: "dict[str, Any] | None" = None
    ) -> "dict[str, Any]":
        return {
            "schema": SIM_SCHEMA_VERSION,
            "suite": self.suite,
            "passed": self.passed,
            "scenarios": [s.to_dict() for s in self.scenarios],
            # host-varying provenance ONLY — stripped by the determinism
            # comparison, never read by the perf gate
            "capture": dict(capture or {}),
        }

    def to_json(
        self, *, capture: "dict[str, Any] | None" = None
    ) -> str:
        return json.dumps(self.to_dict(capture=capture), sort_keys=True)


@no_wallclock
def strip_capture(document: "dict[str, Any]") -> "dict[str, Any]":
    """The determinism-comparable view of a SIM.json document (drops the
    host-varying ``capture`` block)."""
    out = dict(document)
    out.pop("capture", None)
    return out


__all__.append("strip_capture")
__all__.append("SIM_SCHEMA_VERSION")
