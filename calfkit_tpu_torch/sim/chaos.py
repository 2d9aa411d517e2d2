"""Scripted fault injectors and the bounded settling primitive.

The fleet simulator and the chaos test suites share ONE set of deterministic failure seams:

- :class:`ChaosScript` — the engine's ``_chaos`` seam: fires a scripted
  exception (or blocks on a gate — the wedged-device simulator) at the
  Nth visit of a named point, so a mid-stream engine fault lands on an
  exact, reproducible dispatch.
- :class:`BrokerChaos` — the in-memory mesh's publish hook
  (``InMemoryMesh.chaos``): drops the Nth record matching a topic/kind
  predicate, counts everything it sees, and can run scripted side
  effects at publish time (e.g. advance the virtual clock between a
  client's deadline mint and the node's delivery).
- :func:`settle` — await a condition within a BOUNDED number of
  event-loop ticks; the harness's only waiting primitive.
- :func:`assert_engine_drained` — the no-leak oracle: no active slots,
  no in-flight dispatch, every slot on the free list, every page back
  in the pool.

Everything here is plain deterministic state — no randomness, no
wall-clock reads.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable

from calfkit_tpu_torch import protocol

__all__ = [
    "ChaosScript",
    "BrokerChaos",
    "settle",
    "assert_engine_drained",
]


class ChaosScript:
    """Scripted failure points for the engine's ``_chaos`` seam.

    >>> engine._chaos = ChaosScript().fail_at("dispatch", 3, RuntimeError("x"))

    raises on the 3rd decode tick exactly; every other visit is a no-op.
    ``calls`` keeps per-point visit counts for assertions.
    """

    def __init__(self) -> None:
        self.calls: dict[str, int] = {}
        self._plan: dict[tuple[str, int], BaseException] = {}
        self._blocks: dict[tuple[str, int], "threading.Event"] = {}

    def fail_at(
        self, point: str, nth: int, exc: BaseException
    ) -> "ChaosScript":
        self._plan[(point, nth)] = exc
        return self

    def block_at(
        self, point: str, nth: int, gate: "threading.Event"
    ) -> "ChaosScript":
        """On the Nth visit of ``point``, BLOCK until ``gate`` is set —
        the wedged-device-grant simulator: the decode thread
        (and with it the whole serve loop, stuck in its to_thread) hangs
        exactly like a hung device sync, and only the watchdog's own
        task can observe it.  ``gate.set()`` releases the dispatch, which
        then lands normally (the recovery path)."""
        self._blocks[(point, nth)] = gate
        return self

    def __call__(self, point: str) -> None:
        count = self.calls.get(point, 0) + 1
        self.calls[point] = count
        gate = self._blocks.pop((point, count), None)
        if gate is not None:
            gate.wait()
        exc = self._plan.pop((point, count), None)
        if exc is not None:
            raise exc


class BrokerChaos:
    """Scripted broker misbehavior for ``InMemoryMesh.chaos``.

    Rules match on message kind (the ``x-mesh-kind`` header) and/or a
    topic substring; each drops up to ``count`` matching records.  All
    publishes are recorded in ``seen`` as ``(topic, kind)`` so scenarios
    can assert what crossed the broker (e.g. "a cancel record WAS
    published after the timeout").  ``on_publish`` hooks run for every
    record — the deterministic place to advance a virtual clock between
    a client's deadline mint and the node's delivery.
    """

    def __init__(self) -> None:
        self.seen: list[tuple[str, str]] = []
        self.dropped: list[tuple[str, str]] = []
        self._rules: list[dict[str, Any]] = []
        self.on_publish: "Callable[[str, dict[str, str]], None] | None" = None

    def drop(
        self,
        *,
        kind: "str | None" = None,
        topic_contains: "str | None" = None,
        count: int = 1,
    ) -> "BrokerChaos":
        self._rules.append(
            {"kind": kind, "topic": topic_contains, "count": count}
        )
        return self

    def kinds_seen(self, kind: str) -> int:
        return sum(1 for _, k in self.seen if k == kind)

    def __call__(self, topic: str, headers: dict[str, str]) -> "str | None":
        kind = headers.get(protocol.HDR_KIND, "")
        self.seen.append((topic, kind))
        if self.on_publish is not None:
            self.on_publish(topic, headers)
        for rule in self._rules:
            if rule["count"] <= 0:
                continue
            if rule["kind"] is not None and kind != rule["kind"]:
                continue
            if rule["topic"] is not None and rule["topic"] not in topic:
                continue
            rule["count"] -= 1
            self.dropped.append((topic, kind))
            return "drop"
        return None


async def settle(
    condition: Callable[[], bool],
    *,
    ticks: int = 400,
    interval: float = 0.01,
    message: str = "",
) -> int:
    """Await ``condition`` within a bounded number of event-loop ticks;
    returns the tick count it took.  The ONLY waiting primitive chaos
    scenarios use — an unmet condition is a bounded, attributable
    failure, never a hang.  ``interval=0`` degrades to pure
    ``sleep(0)`` yields (the simulator's frozen-clock drain: no real
    timer may interleave, so the tick at which the condition flips is
    reproducible)."""
    for tick in range(ticks):
        if condition():
            return tick
        await asyncio.sleep(interval)
    raise AssertionError(
        message or f"condition not met within {ticks} bounded ticks"
    )


def assert_engine_drained(
    engine: Any, total_free_pages: "int | None" = None
) -> None:
    """The no-leak oracle: every slot free, no in-flight dispatch, no
    queued entries, and (paged) every page back in the pool."""
    assert not engine._active, f"leaked active slots: {dict(engine._active)}"
    assert engine._pend is None, "a dispatch is still marked in flight"
    assert engine._inflight is None, "a chunked admission wave leaked"
    assert not engine._admitting, "an admission prefill is still in flight"
    assert not engine._pending and not engine._carry, "queued entries leaked"
    assert not engine._long_pending and engine._long is None
    assert len(engine._free) == engine.runtime.max_batch_size, (
        f"free list has {len(engine._free)} of "
        f"{engine.runtime.max_batch_size} slots"
    )
    if total_free_pages is not None and engine._page_alloc is not None:
        assert engine._page_alloc.free_pages == total_free_pages, (
            f"leaked pages: {engine._page_alloc.free_pages} free of "
            f"{total_free_pages}"
        )
    # the attribution oracle: a drained engine's page ledger
    # attributes every page to NO owner — a nonzero count here is an
    # attribution leak (a missed free/release mirror), even if the
    # allocator itself balanced
    ledger = getattr(engine, "_ledger", None)
    if ledger is not None:
        assert ledger.pages_in_use == 0, (
            f"ledger attributes {ledger.pages_in_use} page(s) to live "
            f"owners on a drained engine: {ledger.breakdown(top=4)}"
        )
