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

The per-tenant token bucket (:class:`TenantRateLimiter`) budgets entering
calls at the node kernel, upstream of the engine's queues, so a storming
tenant is refused (the retriable ``mesh.rate_limited`` fault) before it
occupies ``max_pending`` slots.  The tenant is the caller's lease id where
present, else the caller's client id.  Refill rides
:func:`calfkit_tpu_torch.cancellation.wall_clock`.  Only entering work is
budgeted: continuation deliveries are the tail of an admitted run.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextvars import ContextVar

from calfkit_tpu_torch import cancellation
from calfkit_tpu_torch.protocol import DEFAULT_PRIORITY, PRIORITY_CLASSES

__all__ = [
    "DEFAULT_PRIORITY",
    "PRIORITY_CLASSES",
    "class_rank",
    "current_priority",
    "resolve_priority",
    "TenantRateLimiter",
]

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


# bucket table cap, same scale (and same rationale) as leases._BEAT_CAP:
# eviction is cheap here — a returning tenant restarts with a full
# burst, which under-throttles for one burst rather than over-throttling
_BUCKET_CAP = 4096


class TenantRateLimiter:
    """Per-tenant token bucket: ``rate_per_s`` tokens/second refill up
    to ``burst``; each entering call spends one token.  ``admit``
    returns None to admit, else the seconds until a token exists — the
    retry hint carried in the ``mesh.rate_limited`` fault.

    Construction is cheap and the disabled form (``rate_per_s <= 0``,
    the default) is a no-op, so nodes can carry a limiter resource
    unconditionally and operators opt in per deployment.
    """

    def __init__(self, rate_per_s: float = 0.0, burst: float = 1.0):
        self.rate_per_s = float(rate_per_s)
        self.burst = max(1.0, float(burst))
        # tenant_id -> (tokens, stamped_at); LRU-capped
        self._buckets: "OrderedDict[str, tuple[float, float]]" = (
            OrderedDict()
        )
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.rate_per_s > 0

    def admit(
        self, tenant_id: str, now: "float | None" = None
    ) -> "float | None":
        """Spend one token for ``tenant_id``.  None = admitted;
        otherwise the seconds until the bucket next holds a whole
        token (the caller's backoff hint).  Runs on the node kernel's
        per-delivery admission path — one dict probe, no allocation
        beyond the bucket tuple."""
        if self.rate_per_s <= 0 or not tenant_id:
            return None
        if now is None:
            now = cancellation.wall_clock()
        with self._lock:
            entry = self._buckets.get(tenant_id)
            if entry is None:
                tokens = self.burst
            else:
                tokens, stamped = entry
                if now > stamped:
                    tokens = min(
                        self.burst,
                        tokens + (now - stamped) * self.rate_per_s,
                    )
            if tokens >= 1.0:
                self._buckets[tenant_id] = (tokens - 1.0, now)
                self._buckets.move_to_end(tenant_id)
                if len(self._buckets) > _BUCKET_CAP:
                    self._buckets.popitem(last=False)
                return None
            # refusal does NOT restamp with drained tokens: a storming
            # tenant must not push its own refill horizon forward
            self._buckets[tenant_id] = (tokens, now)
            self._buckets.move_to_end(tenant_id)
            return max(0.0, (1.0 - tokens) / self.rate_per_s)

    def snapshot(self) -> "dict[str, float]":
        """tenant_id -> tokens remaining (no refill applied) — debug
        and test surface, not a hot read."""
        with self._lock:
            return {k: v[0] for k, v in self._buckets.items()}
