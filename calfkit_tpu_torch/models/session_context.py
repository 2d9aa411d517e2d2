"""The call stack and the envelope — continuation-passing style over the mesh.

Control flow (call/return/fault) between nodes travels as a stack of
:class:`CallFrame` inside every envelope (reference:
calfkit/models/session_context.py:55-209 and SURVEY.md §1 invariants):

- To **call**, push a frame (target topic + callback topic + payload) and
  publish the envelope to the target topic.
- To **return**, pop your frame and publish a ``ReturnMessage`` to that
  frame's callback topic.
- A **fault** unwinds the same way, one hop at a time, giving every caller's
  recovery seams a chance.

There are no in-process RPCs: this stack IS the program counter of the run.
"""

from __future__ import annotations

import uuid
from typing import Any

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire

from calfkit_tpu_torch.models.marker import Marker
from calfkit_tpu_torch.models.payload import ContentPart
from calfkit_tpu_torch.models.reply import Reply
from calfkit_tpu_torch.models.state import State


def new_id() -> str:
    return uuid.uuid4().hex


@dataclass(kw_only=True)
class CallFrame(Wire):
    """One activation record of the distributed call stack."""


    frame_id: str = field(default_factory=new_id)
    target_topic: str
    callback_topic: str
    route: str = "run"
    payload: list[ContentPart] = field(default_factory=list)
    tag: str | None = None  # caller-side correlation (e.g. tool_call_id)
    marker: Marker | None = None  # echoed verbatim on the reply
    fanout_id: str | None = None  # set on the CALLER's frame while a batch is open
    caller_kind: str | None = None
    caller_name: str | None = None


@dataclass(kw_only=True)
class WorkflowState(Wire):
    """The frame stack plus mutation verbs (reference:
    session_context.py:109 — invoke_frame/unwind_frame/mark_fanout)."""


    frames: list[CallFrame] = field(default_factory=list)

    @property
    def depth(self) -> int:
        return len(self.frames)

    def current(self) -> CallFrame | None:
        return self.frames[-1] if self.frames else None

    def require_current(self) -> CallFrame:
        frame = self.current()
        if frame is None:
            raise ValueError("workflow has no active frame")
        return frame

    def invoke_frame(self, frame: CallFrame) -> CallFrame:
        """Push an activation record for an outgoing call."""
        self.frames.append(frame)
        return frame

    def unwind_frame(self) -> CallFrame:
        """Pop the callee's own frame to produce a reply."""
        if not self.frames:
            raise ValueError("cannot unwind an empty workflow stack")
        return self.frames.pop()

    def mark_fanout(self, fanout_id: str | None) -> None:
        """Mark (or clear) an open durable batch on the current frame."""
        self.require_current().fanout_id = fanout_id

    def to_topology(self) -> list[str]:
        """Route chain root→leaf, for diagnostics and step telemetry."""
        return [f"{f.target_topic}#{f.route}" for f in self.frames]

    def root_callback_topic(self) -> str | None:
        """The run originator's inbox — where steps stream to."""
        return self.frames[0].callback_topic if self.frames else None


@dataclass(kw_only=True)
class SessionContext(Wire):
    """Durable run context: conversation state + user deps bag."""


    state: State = field(default_factory=State)
    deps: dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class Envelope(Wire):
    """The one wire body for all call/return/fault records.

    ``state_elided`` flags the degradation rung where conversation state was
    dropped to fit the wire budget (reference: envelope.py:12, reply slot
    contract at reply.py:41-82).
    """


    context: SessionContext = field(default_factory=SessionContext)
    workflow: WorkflowState = field(default_factory=WorkflowState)
    reply: Reply | None = None
    state_elided: bool = False

    def to_wire(self) -> bytes:
        return self.model_dump_json(exclude_none=True).encode("utf-8")

    @classmethod
    def from_wire(cls, data: bytes | str) -> "Envelope":
        return cls.model_validate_json(data)
