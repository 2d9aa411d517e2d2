"""Exception types the PyTorch serving engine raises.

Own copies of the JAX package's types of the same names: this package
imports nothing of ``calfkit_tpu``.  Only the types this package raises
live here.  Each typed fault carries the mesh's wire code (``code``) and
whether a caller may retry it (``retriable``), the values the mesh's
fault table gives the reference's type of the same name.
"""

from __future__ import annotations

__all__ = [
    "CalfkitError",
    "DeadlineExceededError",
    "EngineOverloadedError",
    "EngineWedgedError",
    "InferenceError",
    "RunOrphanedError",
]


class CalfkitError(Exception):
    """Base of every error this package raises."""

    code: "str | None" = None
    retriable = False


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
