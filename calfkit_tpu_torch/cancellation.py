"""Cancellation and deadline plumbing: the port's own copy of
``calfkit_tpu.cancellation`` (same names, same behaviour).

- :func:`wall_clock` — THE wall-clock seam every deadline comparison goes
  through (engine admission and reap, lease lapse, the watchdog).  One
  patch point, so a test can drive every layer off one virtual clock with
  no sleeps.  Always call it through the module
  (``cancellation.wall_clock()``) so a patch is visible.
- :data:`current_deadline` — a contextvar carrying the caller's absolute
  deadline (epoch seconds); the model client forwards it to the engine.
- the **cancel-target registry** — a process-wide weak set of objects
  exposing ``cancel_correlation(corr) -> int`` (the engine registers
  itself); :func:`propagate_cancel` fans a cancel out to all of them.
- **cancel tombstones** — a cancel can arrive before the work it abandons
  is visible to any target; :func:`propagate_cancel` records the
  correlation id, and late-starting work asks :func:`was_cancelled`.

Everything here is fail-open plumbing: a broken target never faults the
caller that tried to cancel it.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import OrderedDict
from contextvars import ContextVar
from typing import Any

logger = logging.getLogger(__name__)

__all__ = [
    "wall_clock",
    "current_deadline",
    "register_cancel_target",
    "propagate_cancel",
    "cancel_targets",
    "was_cancelled",
]
# NOTE: deliberately NO per-layer "remaining budget" helper — every layer
# compares against the ABSOLUTE deadline on the shared clock; budget
# arithmetic per hop is the drift-prone design this module replaces.

# THE deadline clock: module attribute so tests/chaos patch ONE name and
# every layer (client mint, hop expiry, engine admission/reap) moves in
# lockstep.  Always call through the module (``cancellation.wall_clock()``)
# so the patch is visible.
wall_clock = time.time

# the delivery's absolute deadline (epoch seconds), set by the node kernel
# for the duration of one delivery — None outside any deadlined delivery
current_deadline: "ContextVar[float | None]" = ContextVar(
    "calfkit_mesh_deadline", default=None
)


# --------------------------------------------------------------- registry
# WeakSet: an abandoned engine must be collectable; a stopped one simply
# reports zero matches.  The lock only guards set mutation/iteration —
# targets' cancel_correlation runs outside it (a slow target must not
# serialize other registrations).
_TARGETS: "weakref.WeakSet[Any]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()


def register_cancel_target(target: Any) -> None:
    """Register an object exposing ``cancel_correlation(corr: str) -> int``
    (idempotent; weakly held)."""
    with _REGISTRY_LOCK:
        _TARGETS.add(target)


def cancel_targets() -> "list[Any]":
    with _REGISTRY_LOCK:
        return list(_TARGETS)


# ------------------------------------------------------ cancel tombstones
# LRU + TTL bounded: tombstones are advisory best-effort state — evicting
# an old entry only costs wasted work for an already-dead caller, never
# correctness — so a fixed cap is safe and keeps a cancel storm from
# growing the map without bound.  Retries are immune by construction:
# every retry attempt runs under a FRESH correlation id (RetryPolicy
# contract in client/caller.py).
_TOMBSTONE_CAP = 4096
_TOMBSTONE_TTL_S = 600.0
_tombstones: "OrderedDict[str, float]" = OrderedDict()


def _record_tombstone(correlation_id: str) -> None:
    with _REGISTRY_LOCK:
        _tombstones[correlation_id] = wall_clock()
        _tombstones.move_to_end(correlation_id)
        while len(_tombstones) > _TOMBSTONE_CAP:
            _tombstones.popitem(last=False)


def was_cancelled(correlation_id: "str | None") -> bool:
    """True if a mesh ``cancel`` for this correlation id already passed
    through this process — work that has not started yet should fault
    fast (``mesh.cancelled``) instead of executing for a dead caller."""
    if not correlation_id:
        return False
    with _REGISTRY_LOCK:
        stamp = _tombstones.get(correlation_id)
        if stamp is None:
            return False
        if wall_clock() - stamp > _TOMBSTONE_TTL_S:
            del _tombstones[correlation_id]
            return False
        return True


def propagate_cancel(correlation_id: str) -> int:
    """Fan a cancel out to every registered target; returns how many
    in-flight requests were abandoned.  Also records the correlation id's
    tombstone so work the registry cannot see yet (queued behind a busy
    dispatch lane, pre-submit) still dies at its admission gate.
    Fail-open per target."""
    if not correlation_id:
        return 0
    _record_tombstone(correlation_id)
    total = 0
    for target in cancel_targets():
        try:
            total += int(target.cancel_correlation(correlation_id) or 0)
        except Exception:  # noqa: BLE001 - a broken target never blocks the rest
            logger.debug(
                "cancel target %r failed for %s",
                target, correlation_id[:8], exc_info=True,
            )
    return total
