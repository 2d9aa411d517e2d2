"""Exception types of the port, and the ``x-mesh-error-type`` table.

Own copies of the JAX package's types of the same names: this package
imports nothing of ``calfkit_tpu``.  Each typed fault the engine raises
carries the mesh's wire code (``code``) and whether a caller may retry it
(``retriable``).  :data:`FAULT_TYPE_BY_EXCEPTION` is the one place the
wire fault vocabulary and the Python exception surface meet: the node
kernel's fault publisher gives a typed exception its code through
:func:`error_type_for`, and the caller-side classifier reads
:data:`RETRIABLE_FAULT_TYPES` / :func:`exception_for`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from calfkit_tpu_torch.models.error_report import FaultTypes

if TYPE_CHECKING:
    from calfkit_tpu_torch.models.error_report import ErrorReport
    from calfkit_tpu_torch.models.session_context import Envelope

__all__ = [
    "CalfkitError",
    "NodeFaultError",
    "ClientTimeoutError",
    "ClientClosedError",
    "DeserializationError",
    "MeshUnavailableError",
    "RegistryConfigError",
    "SeamContractError",
    "LifecycleConfigError",
    "InferenceError",
    "EngineOverloadedError",
    "EngineWedgedError",
    "DeadlineExceededError",
    "RunCancelledError",
    "RunOrphanedError",
    "TenantRateLimitedError",
    "FAULT_TYPE_BY_EXCEPTION",
    "RETRIABLE_FAULT_TYPES",
    "error_type_for",
    "exception_for",
]


class CalfkitError(Exception):
    """Base of every error this package raises."""

    code: "str | None" = None
    retriable = False


class NodeFaultError(CalfkitError):
    """The typed-fault mint gesture.

    User code raises this (or the kernel mints it) to produce a typed
    ``FaultMessage``; catching it at the client surfaces the ErrorReport.
    """

    def __init__(
        self, report: "ErrorReport", envelope: "Envelope | None" = None
    ):
        self.report = report
        # the terminal fault envelope when available (client side): exposes
        # degradation facts like state_elided to callers
        self.envelope = envelope
        super().__init__(report.describe())


class ClientTimeoutError(CalfkitError, TimeoutError):
    code = FaultTypes.TIMEOUT
    retriable = True


class ClientClosedError(CalfkitError):
    pass


class DeserializationError(CalfkitError):
    code = FaultTypes.DESERIALIZATION_ERROR


class MeshUnavailableError(CalfkitError):
    code = FaultTypes.CAPABILITY_UNAVAILABLE
    retriable = True

    def __init__(self, message: str, *, reason: str = "unavailable"):
        self.reason = reason
        super().__init__(message)


class RegistryConfigError(CalfkitError):
    """Bad handler registration (duplicate route, invalid pattern, ...)."""


class SeamContractError(CalfkitError):
    """A policy seam had the wrong arity or returned an illegal value."""


class LifecycleConfigError(CalfkitError):
    """Worker lifecycle hook/resource misconfiguration."""

    code = FaultTypes.LIFECYCLE_ERROR


class InferenceError(CalfkitError):
    """Local inference backend failure."""

    code = "mesh.model_error"


class EngineOverloadedError(CalfkitError):
    """Bounded admission shed this request.

    Raised at submit when an engine lane's queue is at
    ``RuntimeConfig.max_pending``, when a queued batch-class request was
    evicted for an interactive one, or when a stalled consumer tripped the
    ``max_out_blocks`` delivery bound.  Retriable: nothing was partially
    executed for the caller."""

    code = "mesh.overloaded"
    retriable = True

    def __init__(
        self, message: str, *, lane: str = "short", pending: int = 0, limit: int = 0
    ):
        self.lane = lane
        self.pending = pending
        self.limit = limit
        super().__init__(message)


class EngineWedgedError(CalfkitError):
    """The engine's dispatch-progress watchdog tripped: work was pending but
    no dispatch landed for ``RuntimeConfig.watchdog_stall_s``.  Retriable:
    the call may run whole on another replica."""

    code = "mesh.wedged"
    retriable = True

    def __init__(self, message: str, *, stalled_s: float = 0.0):
        self.stalled_s = stalled_s
        super().__init__(message)


class DeadlineExceededError(CalfkitError, TimeoutError):
    """The request's absolute deadline passed (at submit, queued or
    active).  Not retriable: the caller's budget is spent."""

    code = "mesh.deadline_exceeded"


class RunOrphanedError(CalfkitError):
    """The caller's liveness lease lapsed (or was released), and the
    engine's orphan reaper abandoned the run.  Not retriable: there is
    nobody left to answer."""

    code = "mesh.orphaned"

    def __init__(self, message: str, *, lease_id: str = "", lapsed_s: float = 0.0):
        self.lease_id = lease_id
        self.lapsed_s = lapsed_s
        super().__init__(message)


class RunCancelledError(CalfkitError):
    """The run's caller published a mesh ``cancel`` before this call
    started executing: the admission gate hit the correlation id's
    tombstone and refused to execute.  Not retriable: the cancel was
    deliberate."""

    code = FaultTypes.CANCELLED


class TenantRateLimitedError(CalfkitError):
    """The node kernel's per-tenant token bucket refused this call: the
    tenant (lease id where present, else caller client id) spent its
    admission budget.  Retriable: the bucket refills on the deadline
    clock's schedule, so ``retry_after_s`` is an honest backoff hint."""

    code = FaultTypes.RATE_LIMITED
    retriable = True

    def __init__(self, message: str, *, tenant_id: str = "", retry_after_s: float = 0.0):
        self.tenant_id = tenant_id
        self.retry_after_s = retry_after_s
        super().__init__(message)


# --------------------------------------------------------------------------- #
# the authoritative x-mesh-error-type <-> exception-class table
# --------------------------------------------------------------------------- #
# Subclass lookups go through error_type_for's MRO walk.  NodeFaultError is
# deliberately absent: it CARRIES a report with its own error_type.

FAULT_TYPE_BY_EXCEPTION: dict[type[BaseException], str] = {
    EngineOverloadedError: FaultTypes.OVERLOADED,
    EngineWedgedError: FaultTypes.WEDGED,
    DeadlineExceededError: FaultTypes.DEADLINE_EXCEEDED,
    RunCancelledError: FaultTypes.CANCELLED,
    RunOrphanedError: FaultTypes.ORPHANED,
    TenantRateLimitedError: FaultTypes.RATE_LIMITED,
    ClientTimeoutError: FaultTypes.TIMEOUT,
    DeserializationError: FaultTypes.DESERIALIZATION_ERROR,
    InferenceError: FaultTypes.MODEL_ERROR,
    MeshUnavailableError: FaultTypes.CAPABILITY_UNAVAILABLE,
    LifecycleConfigError: FaultTypes.LIFECYCLE_ERROR,
}

# faults a caller may retry with backoff: the work was refused whole
# (shed, drain, transport hiccup), never half-done
RETRIABLE_FAULT_TYPES: frozenset[str] = frozenset(
    {
        FaultTypes.OVERLOADED,
        FaultTypes.TIMEOUT,
        FaultTypes.CAPABILITY_UNAVAILABLE,
        FaultTypes.WEDGED,
        FaultTypes.RATE_LIMITED,
    }
)

# reverse direction, first-writer-wins where two exceptions share a code
_EXCEPTION_BY_FAULT_TYPE: dict[str, type[BaseException]] = {}
for _exc_type, _code in FAULT_TYPE_BY_EXCEPTION.items():
    _EXCEPTION_BY_FAULT_TYPE.setdefault(_code, _exc_type)


def error_type_for(exc: BaseException) -> "str | None":
    """The ``x-mesh-error-type`` code for an exception, honoring subclass
    relationships; ``None`` when the exception has no typed code."""
    for klass in type(exc).__mro__:
        code = FAULT_TYPE_BY_EXCEPTION.get(klass)
        if code is not None:
            return code
    return None


def exception_for(error_type: "str | None") -> "type[BaseException] | None":
    """The canonical local exception class for a wire fault code;
    ``None`` for unknown/untyped codes."""
    if not error_type:
        return None
    return _EXCEPTION_BY_FAULT_TYPE.get(error_type)
