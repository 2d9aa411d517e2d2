"""Over-the-wire tool invocation body and call-side binding models.

Reference: calfkit/models/tool_dispatch.py:26-147.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire

from calfkit_tpu_torch.models.capability import ToolDef


@dataclass(kw_only=True)
class ToolCallRef(Wire):
    """The wire body of a dispatched tool invocation (carried as a DataPart)."""


    tool_call_id: str
    tool_name: str
    args: dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class ToolBinding(Wire):
    """A tool def bound to its dispatch topic, ready for a model turn."""


    tool: ToolDef
    dispatch_topic: str


@runtime_checkable
class ToolSelector(Protocol):
    """Call-side selection of which live tools a model turn may see.

    Implementations: ``Tools`` (named XOR discover), ``Toolboxes``,
    ``Messaging``, ``Handoff`` — each resolves against the live capability /
    agents views at turn time.
    """

    def resolve(self, view: Any) -> list[ToolBinding]: ...
