"""The simulator's time authority: a virtual clock with an event heap.

:class:`VirtualClock` is a controllable stand-in for :data:`calfkit_tpu_torch.cancellation.wall_clock`,
THE deadline/staleness clock every layer reads.  Installing one via
:func:`virtual_clock` moves client deadline mint, hop expiry, engine
admission/reap, heartbeat stamps, lease lapse, and placement verdicts in
lockstep; scenarios advance time explicitly and nothing sleeps to make a
deadline pass.

The **event heap**: ``schedule(at, fn)`` registers a
callback at an absolute virtual time, and every ``advance``/
``advance_to``/``advance_to_next`` fires due callbacks IN ORDER, with
``now`` set to each event's own timestamp while it runs — so a callback
that schedules relative work (``clock.now + service_s``) composes
correctly even when one advance crosses many events.  Ties fire in
scheduling order (a monotonic sequence number breaks them), which is
what makes the fleet simulator's discrete-event loop reproducible.

No wall-clock reads anywhere in this module (the ``wall_clock`` seam is
the one clock).
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
from typing import Callable, Iterator

from calfkit_tpu_torch import cancellation

__all__ = ["VirtualClock", "virtual_clock", "DEFAULT_EPOCH"]

# an arbitrary fixed epoch well inside "plausible wall clock" so absolute
# deadlines/stamps look realistic in dumps, far from zero-is-falsy bugs
DEFAULT_EPOCH = 1_700_000_000.0


class VirtualClock:
    """A controllable stand-in for ``cancellation.wall_clock`` with an
    ordered virtual-event heap (the fleet simulator's timeline)."""

    def __init__(self, start: float = DEFAULT_EPOCH):
        self.now = float(start)
        self._heap: "list[tuple[float, int, Callable[[], object]]]" = []
        self._seq = itertools.count()
        self.fired = 0  # lifetime events fired (runner progress metric)

    def __call__(self) -> float:
        return self.now

    # ------------------------------------------------------------- events
    def schedule(self, at: float, fn: "Callable[[], object]") -> None:
        """Register ``fn`` to fire when the clock reaches virtual time
        ``at`` (clamped to ``now`` — the past is not schedulable).  Fire
        order is (time, registration order); callbacks run synchronously
        inside the advance that crosses them."""
        heapq.heappush(self._heap, (max(float(at), self.now), next(self._seq), fn))

    @property
    def next_event_at(self) -> "float | None":
        """Virtual timestamp of the earliest pending event (None = no
        pending events)."""
        return self._heap[0][0] if self._heap else None

    @property
    def pending_events(self) -> int:
        return len(self._heap)

    def fire_due(self) -> int:
        """Fire every event scheduled at or before ``now``; returns the
        count fired.  Callbacks may schedule further events (fired in the
        same pass when due)."""
        fired = 0
        while self._heap and self._heap[0][0] <= self.now:
            _, _, fn = heapq.heappop(self._heap)
            fn()
            fired += 1
            self.fired += 1
        return fired

    # ----------------------------------------------------------- advances
    def advance(self, seconds: float) -> float:
        """Advance by ``seconds``, firing every event the jump crosses
        (each with ``now`` at its own timestamp).  Returns the new now."""
        return self.advance_to(self.now + seconds)

    def advance_to(self, target: float) -> float:
        target = max(float(target), self.now)
        while self._heap and self._heap[0][0] <= target:
            at = self._heap[0][0]
            if at > self.now:
                self.now = at
            self.fire_due()
        self.now = target
        return self.now

    def advance_to_next(self) -> bool:
        """Jump to the earliest pending event and fire everything due at
        that instant.  False when the heap is empty (time holds still)."""
        if not self._heap:
            return False
        self.advance_to(self._heap[0][0])
        return True


@contextlib.contextmanager
def virtual_clock(start: float = DEFAULT_EPOCH) -> "Iterator[VirtualClock]":
    """Install a :class:`VirtualClock` as THE package deadline clock for
    the duration of the block (every caller reads it through the module
    attribute, so one swap moves all layers in lockstep)."""
    clock = VirtualClock(start)
    previous = cancellation.wall_clock
    cancellation.wall_clock = clock
    try:
        yield clock
    finally:
        cancellation.wall_clock = previous
