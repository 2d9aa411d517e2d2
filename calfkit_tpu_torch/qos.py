"""Priority classes: the port's own copy of the engine's half of
``calfkit_tpu.qos`` (same names, same behaviour).

A request carries a QoS class, ``interactive`` or ``batch``
(:data:`PRIORITY_CLASSES`, best first).  Under overload the engine sheds
batch work first, and its deadline and orphan reapers take batch before
interactive at equal expiry.  A missing or unknown class degrades to
:data:`DEFAULT_PRIORITY` (interactive: batch is an explicit opt-in to
lower priority).  :data:`current_priority` carries the caller's class to
the engine through the model client, as ``leases.current_lease`` carries
the lease.

The reference's per-tenant token bucket (``TenantRateLimiter``) budgets
entering calls at the mesh worker's node kernel, upstream of any engine,
so it is not part of this package.
"""

from __future__ import annotations

from contextvars import ContextVar

__all__ = [
    "DEFAULT_PRIORITY",
    "PRIORITY_CLASSES",
    "class_rank",
    "current_priority",
    "resolve_priority",
]

# the class vocabulary, best first: everything that ranks, sheds or
# renders by class iterates this tuple
PRIORITY_CLASSES = ("interactive", "batch")
DEFAULT_PRIORITY = "interactive"

# the caller's priority class for the duration of one call — None outside
# any; readers go through resolve_priority() so the missing/corrupt →
# default law has exactly one copy
current_priority: "ContextVar[str | None]" = ContextVar(
    "calfkit_caller_priority", default=None
)


def resolve_priority(value: "str | None" = None) -> str:
    """THE class-degradation law: an unknown or absent class is the
    default class.  With no argument, resolves :data:`current_priority`."""
    if value is None:
        value = current_priority.get()
    if value in PRIORITY_CLASSES:
        return value
    return DEFAULT_PRIORITY


def class_rank(priority: "str | None") -> int:
    """Shed and reap ordering key: a HIGHER rank degrades FIRST (batch=1
    before interactive=0)."""
    if priority == PRIORITY_CLASSES[-1]:  # "batch"
        return 1
    return 0
