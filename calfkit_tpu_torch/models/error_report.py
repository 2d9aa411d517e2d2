"""The typed fault vocabulary and the budgeted, total-constructor ErrorReport.

Design requirements carried over from the reference (calfkit/models/
error_report.py:46-657):

- **Typed codes** (``mesh.*``) so callers can dispatch on fault class without
  string-matching messages.
- **Total construction**: :meth:`ErrorReport.build_safe` must never raise —
  it is called from inside exception handlers, including against hostile
  objects whose ``__str__``/``__repr__`` raise.
- **Budgeted**: messages/tracebacks are truncated and cause-chains bounded so
  a report can always fit the wire budget; :meth:`to_minimal` is the last
  rung of the state-elision ladder.
"""

from __future__ import annotations

import traceback as _tb
from typing import Any

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire

# --------------------------------------------------------------------------- #
# fault codes
# --------------------------------------------------------------------------- #


class FaultTypes:
    """The ``mesh.*`` typed-fault vocabulary."""

    NODE_ERROR = "mesh.node_error"  # node body raised
    TOOL_ERROR = "mesh.tool_error"  # tool body raised
    CALLEE_FAULT = "mesh.callee_fault"  # downstream fault escalated through
    VALIDATION_ERROR = "mesh.validation_error"  # schema/args validation failed
    DESERIALIZATION_ERROR = "mesh.deserialization_error"
    TIMEOUT = "mesh.timeout"
    STRAY_REPLY = "mesh.stray_reply"
    FANOUT_ABORTED = "mesh.fanout_aborted"
    DECLINED = "mesh.declined"  # reply-owing delivery declined by all handlers
    CAPABILITY_UNAVAILABLE = "mesh.capability_unavailable"
    HANDOFF_REJECTED = "mesh.handoff_rejected"
    MODEL_ERROR = "mesh.model_error"
    CONTEXT_WINDOW_EXCEEDED = "mesh.model.context_window_exceeded"
    OVERSIZED_MESSAGE = "mesh.oversized_message"
    LIFECYCLE_ERROR = "mesh.lifecycle_error"
    # overload protection: a bounded queue shed the call, or a
    # draining worker refused it — RETRIABLE elsewhere/later by contract
    OVERLOADED = "mesh.overloaded"
    # the call's x-mesh-deadline passed (on arrival, in queue, or while
    # executing): the caller is gone, the work was abandoned — NOT
    # retriable (the budget is spent)
    DEADLINE_EXCEEDED = "mesh.deadline_exceeded"
    # the run's caller published a mesh `cancel` before this call started
    # executing (tombstone hit at the admission gate) — NOT retriable
    # (the caller abandoned the run on purpose)
    CANCELLED = "mesh.cancelled"
    # the engine's dispatch-progress watchdog declared the device wedged
    # (work pending, no dispatch landing within watchdog_stall_s) and
    # faulted the request instead of letting it burn its whole deadline —
    # RETRIABLE by contract: nothing was delivered to the caller, and a
    # different replica can serve the same call
    WEDGED = "mesh.wedged"
    # multi-tenant QoS: the node kernel's per-tenant token
    # bucket refused the call — the tenant's admission budget is spent.
    # RETRIABLE by contract: the bucket refills on a known schedule, so
    # backing off and retrying is exactly the right caller response
    # (unlike a deadline, which is gone forever)
    RATE_LIMITED = "mesh.rate_limited"
    # the run's CALLER liveness lease lapsed (heartbeats stopped past the
    # lease TTL, or the caller released the lease on clean close) and the
    # server-side orphan reaper abandoned the run — NOT
    # retriable: there is nobody to answer; the fault is published to the
    # (dead) reply topic for the record, not for a consumer
    ORPHANED = "mesh.orphaned"
    UNHANDLED = "mesh.unhandled_exception"

    @classmethod
    def all(cls) -> frozenset[str]:
        return frozenset(
            v for k, v in vars(cls).items() if isinstance(v, str) and not k.startswith("_")
        )


# --------------------------------------------------------------------------- #
# safe stringification (hostile-object guard)
# --------------------------------------------------------------------------- #

_MSG_BUDGET = 4096
_TB_BUDGET = 16384
_MAX_CAUSES = 8


def safe_str(obj: Any, limit: int = _MSG_BUDGET) -> str:
    """``str(obj)`` that survives hostile ``__str__``/``__repr__``.

    Reference: calfkit/_safe.py:34 (``safe_exc_message``).
    """
    try:
        s = str(obj)
    except BaseException:
        try:
            s = object.__repr__(obj)
        except BaseException:
            s = "<unprintable object>"
    if len(s) > limit:
        s = s[: limit - 1] + "…"
    return s


# --------------------------------------------------------------------------- #
# report models
# --------------------------------------------------------------------------- #


@dataclass(kw_only=True)
class ExceptionInfo(Wire):
    type: str
    message: str
    traceback: str | None = None


@dataclass(kw_only=True)
class ErrorReport(Wire):
    """A typed, wire-safe description of a failure.

    ``causes`` is the escalation chain (most-recent first): each hop a fault
    climbs up the call stack may wrap the prior report.  ``frame_chain`` is
    the list of frame ids the fault travelled through, for diagnostics.
    """


    error_type: str = FaultTypes.UNHANDLED
    message: str = ""
    node: str | None = None
    route: str | None = None
    frame_chain: list[str] = field(default_factory=list)
    causes: list["ErrorReport"] = field(default_factory=list)
    exception: ExceptionInfo | None = None
    data: dict[str, Any] | None = None

    # ---------------------------------------------------------------- build
    @classmethod
    def build_safe(
        cls,
        error_type: str,
        message: Any = None,
        *,
        exc: BaseException | None = None,
        node: str | None = None,
        route: str | None = None,
        cause: "ErrorReport | None" = None,
        frame_id: str | None = None,
        data: dict[str, Any] | None = None,
        include_traceback: bool = True,
    ) -> "ErrorReport":
        """Total constructor: never raises, whatever it is handed.

        Reference: the harvester at calfkit/models/error_report.py:611.
        """
        try:
            msg = safe_str(message) if message is not None else ""
            exc_info: ExceptionInfo | None = None
            if exc is not None:
                tb: str | None = None
                if include_traceback:
                    try:
                        tb = "".join(
                            _tb.format_exception(type(exc), exc, exc.__traceback__)
                        )[-_TB_BUDGET:]
                    except BaseException:
                        tb = None
                exc_info = ExceptionInfo(
                    type=safe_str(type(exc).__name__, 256),
                    message=safe_str(exc),
                    traceback=tb,
                )
                if not msg:
                    msg = exc_info.message
            # flatten the escalation chain: causes = [direct cause, its causes…]
            causes: list[ErrorReport] = []
            if cause is not None:
                causes = [cause.model_copy(update={"causes": []}), *cause.causes]
                causes = causes[:_MAX_CAUSES]
            frame_chain: list[str] = list(causes[0].frame_chain) if causes else []
            if frame_id:
                frame_chain = [frame_id, *frame_chain][:32]
            safe_data: dict[str, Any] | None = None
            if data is not None:
                try:
                    safe_data = {safe_str(k, 128): safe_str(v, 512) for k, v in data.items()}
                except BaseException:
                    safe_data = None
            return cls(
                error_type=error_type if isinstance(error_type, str) else FaultTypes.UNHANDLED,
                message=msg,
                node=node,
                route=route,
                frame_chain=frame_chain,
                causes=causes,
                exception=exc_info,
                data=safe_data,
            )
        except BaseException:
            # absolute floor: a report must always exist
            try:
                return cls(error_type=FaultTypes.UNHANDLED, message="error report construction failed")
            except BaseException:  # pragma: no cover - default ctor
                return cls.model_construct()

    # ------------------------------------------------------------- degrade
    def to_minimal(self) -> "ErrorReport":
        """Smallest useful report — the last rung of the elision ladder
        (reference: calfkit/nodes/base.py:838-905)."""
        return ErrorReport(
            error_type=self.error_type,
            message=safe_str(self.message, 512),
            node=self.node,
            route=self.route,
        )

    def without_tracebacks(self) -> "ErrorReport":
        """Middle rung: keep structure, drop tracebacks."""
        return self.model_copy(
            update={
                "exception": (
                    self.exception.model_copy(update={"traceback": None})
                    if self.exception
                    else None
                ),
                "causes": [c.without_tracebacks() for c in self.causes],
            }
        )

    def root_cause(self) -> "ErrorReport":
        return self.causes[-1] if self.causes else self

    def describe(self) -> str:
        head = f"[{self.error_type}] {self.message}"
        if self.node:
            head += f" (node={self.node})"
        return head
