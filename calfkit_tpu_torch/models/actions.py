"""The node-result vocabulary: what a node body may decide to do next.

A routed handler returns one of (reference: calfkit/models/actions.py:29-118):

- :class:`Call` — invoke another node and suspend this run until it replies.
  A ``list[Call]`` opens a durable parallel fan-out batch.
- :class:`TailCall` — hand the *current obligation* to another node (handoff):
  the active frame is retargeted; the new node replies to the original caller.
- :class:`ReturnCall` — produce the reply for the active frame.
- :class:`Next` — decline: let a less-specific handler in the chain take the
  delivery.  Declining a reply-owing delivery with no taker is auto-faulted
  by the kernel (no silent drops).
"""

from __future__ import annotations

from typing import Union

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire

from calfkit_tpu_torch.models.marker import Marker
from calfkit_tpu_torch.models.payload import ContentPart
from calfkit_tpu_torch.models.state import State


@dataclass(kw_only=True)
class Call(Wire):

    target_topic: str
    route: str = "run"
    parts: list[ContentPart] = field(default_factory=list)
    tag: str | None = None
    marker: Marker | None = None
    # Fresh-state call: callee gets an isolated (empty or overridden) State
    # instead of the caller's conversation (reference: actions.py:29
    # ``isolate_state`` — used by message_agent).
    isolate_state: bool = False
    state_override: State | None = None


@dataclass(kw_only=True)
class TailCall(Wire):

    target_topic: str
    route: str = "run"
    parts: list[ContentPart] = field(default_factory=list)


@dataclass(kw_only=True)
class ReturnCall(Wire):

    parts: list[ContentPart] = field(default_factory=list)


@dataclass(kw_only=True)
class Next(Wire):
    """Decline the delivery; chain-of-responsibility moves on."""


NodeResult = Union[Call, list[Call], TailCall, ReturnCall, Next, None]
