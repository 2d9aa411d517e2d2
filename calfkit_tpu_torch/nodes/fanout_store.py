"""The durable fan-out batch store and its pure fold/close state machine.

Exactly-once *semantics* over at-least-once delivery (reference:
calfkit/nodes/_fanout_store.py:50-363):

- the state machine is pure functions over :class:`FanoutState` so every
  transition is unit-testable without a broker;
- **write order invariant**: ``open()`` writes basestate (the resume
  snapshot) BEFORE state (the registration), both acked — observing a
  registered batch implies its snapshot is restorable;
- folds are idempotent per slot (duplicate sibling replies classify as
  ``duplicate`` against durable state *before* any user code runs);
- close is tombstone-first: the batch unregisters before the caller resumes,
  so a crash between the two re-delivers nothing.

Storage is two compacted tables per node: ``mesh.fanout.<node_id>.state`` and
``.basestate``, keyed by fanout_id.  The ktables-backed impl below works over
any MeshTransport; the dict-backed offline fake lives in tests.
"""

from __future__ import annotations

from typing import Literal, Protocol

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.mesh.transport import MeshTransport
from calfkit_tpu_torch.models.fanout import (
    EnvelopeSnapshot,
    FanoutOpen,
    FanoutOutcome,
    FanoutState,
)

SiblingClass = Literal["expected", "duplicate", "stray", "closed"]
FoldDecision = Literal["parked", "complete", "duplicate", "stray"]


# --------------------------------------------------------------------------- #
# pure state machine
# --------------------------------------------------------------------------- #


def classify_sibling(state: FanoutState | None, slot_id: str) -> SiblingClass:
    """Classify an arriving sibling reply against durable state — BEFORE any
    seams run (reference: _fanout_store.py:164)."""
    if state is None:
        return "closed"  # batch already closed (or never opened): stray-late
    if slot_id not in state.open.slot_ids():
        return "stray"
    if slot_id in state.outcomes:
        return "duplicate"
    return "expected"


def record_outcome(state: FanoutState, outcome: FanoutOutcome) -> FanoutState:
    """Fold one sibling outcome (pure; caller persists)."""
    new_outcomes = dict(state.outcomes)
    new_outcomes[outcome.slot_id] = outcome
    return state.model_copy(update={"outcomes": new_outcomes})


def fold_decision(state: FanoutState) -> FoldDecision:
    return "complete" if state.is_complete() else "parked"


# --------------------------------------------------------------------------- #
# store protocol + ktables implementation
# --------------------------------------------------------------------------- #


class FanoutBatchStore(Protocol):
    """Durable batch storage seam (swap for a fake in the offline lane)."""

    async def start(self) -> None: ...

    async def stop(self) -> None: ...

    async def open(
        self, fanout_id: str, opened: FanoutOpen, snapshot: EnvelopeSnapshot
    ) -> None: ...

    async def load(self, fanout_id: str) -> FanoutState | None: ...

    async def load_snapshot(self, fanout_id: str) -> EnvelopeSnapshot | None: ...

    async def save(self, state: FanoutState) -> None: ...

    async def close(self, fanout_id: str) -> None: ...


FANOUT_STORE_KEY = "fanout_store"


class KtablesFanoutBatchStore:
    """The production store over two compacted mesh tables."""

    def __init__(
        self,
        transport: MeshTransport,
        node_id: str,
        config: "FanoutConfig | None" = None,
    ):
        from calfkit_tpu_torch.tuning import FanoutConfig

        self._transport = transport
        self._config = config or FanoutConfig()
        self._state_topic = protocol.fanout_state_topic(node_id)
        self._base_topic = protocol.fanout_basestate_topic(node_id)
        self._state_reader = transport.table_reader(self._state_topic)
        self._state_writer = transport.table_writer(self._state_topic)
        self._base_reader = transport.table_reader(self._base_topic)
        self._base_writer = transport.table_writer(self._base_topic)

    async def start(self, *, ensure: bool = True) -> None:
        # ensure=False when the caller already provisioned the framework
        # tables (Worker boots through the classifying provisioner; paying
        # another admin round-trip per node would be pure overhead)
        if ensure:
            await self._transport.ensure_topics(
                [self._state_topic, self._base_topic], compacted=True
            )
        timeout = self._config.table.catchup_timeout_s
        await self._base_reader.start(timeout=timeout)
        await self._state_reader.start(timeout=timeout)

    async def stop(self) -> None:
        await self._state_reader.stop()
        await self._base_reader.stop()

    async def open(
        self, fanout_id: str, opened: FanoutOpen, snapshot: EnvelopeSnapshot
    ) -> None:
        # WRITE ORDER INVARIANT: basestate first, then state, both acked
        await self._base_writer.put(
            fanout_id, snapshot.model_dump_json().encode("utf-8")
        )
        await self._state_writer.put(
            fanout_id, FanoutState(open=opened).model_dump_json().encode("utf-8")
        )

    async def load(self, fanout_id: str) -> FanoutState | None:
        await self._state_reader.barrier(
            timeout=self._config.table.barrier_timeout_s
        )
        raw = self._state_reader.get(fanout_id)
        return FanoutState.model_validate_json(raw) if raw else None

    async def load_snapshot(self, fanout_id: str) -> EnvelopeSnapshot | None:
        await self._base_reader.barrier(
            timeout=self._config.table.barrier_timeout_s
        )
        raw = self._base_reader.get(fanout_id)
        return EnvelopeSnapshot.model_validate_json(raw) if raw else None

    async def save(self, state: FanoutState) -> None:
        await self._state_writer.put(
            state.open.fanout_id, state.model_dump_json().encode("utf-8")
        )

    async def close(self, fanout_id: str) -> None:
        # tombstone-first: state (the registration) before basestate, so a
        # crash mid-close leaves no registered-but-snapshotless batch
        await self._state_writer.tombstone(fanout_id)
        await self._base_writer.tombstone(fanout_id)
