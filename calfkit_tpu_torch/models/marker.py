"""The marker rail: typed correlation context echoed verbatim on replies.

A caller stamps a marker on the call frame; the callee's kernel echoes it on
the reply (return OR fault) without ever inspecting it.  This is how the agent
re-associates a reply with the model tool call that caused it
(reference: calfkit/models/marker.py).
"""

from __future__ import annotations

from typing import Any, Literal, Union

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire


@dataclass(kw_only=True)
class CallMarker(Wire):
    kind: Literal["call"] = "call"
    data: dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class ToolCallMarker(Wire):
    kind: Literal["tool_call"] = "tool_call"
    tool_call_id: str
    tool_name: str


Marker = Union[CallMarker, ToolCallMarker]
