"""Effect-constraint markers for the meshlint static analyzer.

These decorators are NO-OPS at runtime — zero wrapper, zero overhead;
they return the function unchanged.  Their only job is to declare, at
the definition site, that a function is the ROOT of a static constraint
that ``scripts/meshlint`` propagates through the transitive call closure
of the intra-project call graph:

- :func:`hotpath` — the function runs on a serving hot path (the decode
  dispatch loop, the fleet selection path, the lease sweep).  Nothing it
  transitively calls may block (``time.sleep``/``open``/``subprocess``/
  sockets), log (``logger.*``/``print``), read the wall clock
  (``time.time``/``datetime.now``; ``time.perf_counter`` stays legal —
  it is the sanctioned hot-path duration clock), or issue a blocking
  device→host sync (``np.asarray``/``jax.device_get``/
  ``.block_until_ready()``/``.item()``) outside an annotated sync point.
  A ``@hotpath`` function must also stay sync by shape (``def``, not
  ``async def``): the selection and dispatch paths are synchronous by
  contract.
- :func:`no_block` — no transitive blocking primitive (the subset of
  ``hotpath`` that an async admission helper can honor).
- :func:`no_wallclock` — no transitive host-clock read of ANY kind
  (``time.time``, ``time.monotonic``, ``time.perf_counter``,
  ``datetime.now`` and friends).  This is the determinism constraint:
  the simulator and the perf gate's metric computation must never
  observe host time (timestamps flow through the
  ``cancellation.wall_clock`` seam only).
- :func:`no_log` — no transitive logging or ``print``.

Because the declaration lives ON the definition, a rename moves the
constraint with the function — the failure mode of the old
``lint_hotpath.py`` name lists (a renamed hot function silently dropped
out of coverage; only a separate loud-miss check caught it) is
structurally gone.

Individual effect SITES inside a guarded closure are waived with the
escape-comment vocabulary (one reasoned comment per site, on the line or
the comment block above it — never a suppression baseline file):

    # blocking-ok: <why this block/sync is safe here>
    # wallclock-ok: <why this host-clock read is safe here>
    # unbounded-ok: <which bound/permit/reaper makes this queue safe>
    # atomicity-ok: <why this read..await..write is not a lost update>

See docs/static-analysis.md for the full rule and vocabulary reference.
"""

from __future__ import annotations

from typing import Callable, TypeVar

__all__ = ["hotpath", "no_block", "no_wallclock", "no_log"]

F = TypeVar("F", bound=Callable)


def hotpath(fn: F) -> F:
    """Marker: serving-hot-path root (no block/log/wallclock/device-sync
    anywhere in the transitive call closure; must stay ``def``)."""
    return fn


def no_block(fn: F) -> F:
    """Marker: no transitive blocking primitive."""
    return fn


def no_wallclock(fn: F) -> F:
    """Marker: no transitive host-clock read (wall OR monotonic)."""
    return fn


def no_log(fn: F) -> F:
    """Marker: no transitive logging / ``print``."""
    return fn
