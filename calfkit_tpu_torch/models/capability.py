"""Capability records (the ``mesh.capabilities`` compacted topic) and the
capability-resolution kernel: the port's own copy of the JAX package's
module of the same name, as wire dataclasses.

A capability is "this dispatch topic executes these tools".  Agents resolve
tool selectors against the live capability view each turn.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from calfkit_tpu_torch.models._wire import Wire


@dataclass(kw_only=True)
class ToolDef(Wire):
    """A model-facing tool definition (name + JSON-schema parameters)."""

    name: str
    description: str = ""
    parameters_schema: dict[str, Any] = field(
        default_factory=lambda: {"type": "object", "properties": {}}
    )


@dataclass(kw_only=True)
class CapabilityRecord(Wire):
    node_id: str
    node_kind: str = "tool"
    dispatch_topic: str
    tools: list[ToolDef] = field(default_factory=list)

    def tool_names(self) -> list[str]:
        return [t.name for t in self.tools]


@dataclass(kw_only=True)
class ResolvedTool(Wire):
    """A tool def bound to the topic that executes it."""

    tool: ToolDef
    dispatch_topic: str
    provider_node_id: str


class CapabilityResolutionError(LookupError):
    pass


def resolve_capability(
    records: list[CapabilityRecord], tool_name: str
) -> ResolvedTool:
    """Find the one live provider of ``tool_name``.

    Ambiguity (two live providers) is an error, not a coin flip — the caller
    must disambiguate via selectors.
    """
    matches = [
        ResolvedTool(tool=t, dispatch_topic=r.dispatch_topic, provider_node_id=r.node_id)
        for r in records
        for t in r.tools
        if t.name == tool_name
    ]
    if not matches:
        raise CapabilityResolutionError(f"no live provider for tool {tool_name!r}")
    providers = {m.provider_node_id for m in matches}
    if len(providers) > 1:
        raise CapabilityResolutionError(
            f"tool {tool_name!r} offered by multiple providers: {sorted(providers)}"
        )
    return matches[0]


def resolve_all_capabilities(records: list[CapabilityRecord]) -> list[ResolvedTool]:
    """Every live tool, one entry per (provider, tool) — discovery mode."""
    return [
        ResolvedTool(tool=t, dispatch_topic=r.dispatch_topic, provider_node_id=r.node_id)
        for r in records
        for t in r.tools
    ]
