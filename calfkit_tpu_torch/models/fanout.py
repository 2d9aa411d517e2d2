"""Durable fan-out batch wire models.

A parallel tool fan-out parks its state in compacted mesh tables so a worker
crash/rebalance never loses a batch (reference: calfkit/models/fanout.py and
calfkit/nodes/_fanout_store.py:50-64).  The write-order invariant:
**basestate before state, both acked** — registration implies restorability.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire

from calfkit_tpu_torch.models.error_report import ErrorReport
from calfkit_tpu_torch.models.marker import Marker
from calfkit_tpu_torch.models.payload import ContentPart
from calfkit_tpu_torch.models.session_context import SessionContext, WorkflowState


@dataclass(kw_only=True)
class SlotRef(Wire):
    """A pre-minted sibling slot: the sibling's frame_id IS the slot id."""
    slot_id: str
    tag: str | None = None
    tool_name: str | None = None


@dataclass(kw_only=True)
class FanoutOpen(Wire):
    fanout_id: str
    slots: list[SlotRef] = field(default_factory=list)

    def slot_ids(self) -> set[str]:
        return {s.slot_id for s in self.slots}


@dataclass(kw_only=True)
class FanoutOutcome(Wire):
    """Result of one sibling: parts XOR fault (after on_callee_error seams)."""
    slot_id: str
    parts: list[ContentPart] | None = None
    fault: ErrorReport | None = None
    marker: Marker | None = None


@dataclass(kw_only=True)
class FanoutState(Wire):
    """The compacted ``state`` table value: open batch + folded outcomes."""
    open: FanoutOpen
    outcomes: dict[str, FanoutOutcome] = field(default_factory=dict)
    closing: bool = False

    def is_complete(self) -> bool:
        return self.open.slot_ids() <= set(self.outcomes)


@dataclass(kw_only=True)
class EnvelopeSnapshot(Wire):
    """The compacted ``basestate`` table value: everything needed to resume
    the caller after the batch closes (state + stack + deps)."""
    context: SessionContext
    workflow: WorkflowState
