"""Tuning value-objects: the port's own copy of ``calfkit_tpu.tuning``.

Strictly-validated knobs for the compacted-table machinery.  The important
semantic: catch-up is a GATE (a store/view must not serve until it has read
the table to its end) and barriers are read-your-own-writes freshness —
both are bounded by these timeouts so a dead broker turns into a loud
error instead of a silent hang.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import invalid


def require_positive(title: str, name: str, value: float) -> None:
    if not value > 0:
        raise invalid(title, name, "Input should be greater than 0", value)


@dataclass(frozen=True, kw_only=True)
class TableTuning:
    """Compacted-table reader bounds (the KTableReaderTuning analog)."""

    catchup_timeout_s: float = 30.0
    barrier_timeout_s: float = 30.0

    def __post_init__(self) -> None:
        require_positive("TableTuning", "catchup_timeout_s", self.catchup_timeout_s)
        require_positive("TableTuning", "barrier_timeout_s", self.barrier_timeout_s)


@dataclass(frozen=True, kw_only=True)
class FanoutConfig:
    """Durable fan-out store tuning, threaded via ``Worker(fanout=...)``.

    Raise the timeouts on slow brokers; the write-order and fold/close
    semantics are not configurable (they are the correctness story).
    """

    table: TableTuning = field(default_factory=TableTuning)
