"""MCPToolboxNode: host an MCP server connection as a node on the mesh.

The port's own copy of ``calfkit_tpu.mcp.toolbox``.  The node lives on
names carry the ``{node_id}__`` namespace prefix (so two toolboxes exposing
the same upstream tool never collide), caches ``tools/list`` (re-listing on
``tools/list_changed`` off the receive loop), and executes incoming
ToolCallRefs by stripping the prefix.

Call-side: ``Toolbox("name")`` / ``Toolboxes(...)`` selectors resolve the
capability view to toolbox records, with ``include=`` as the trust boundary
on which upstream tools the agent may see.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Sequence

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.models.actions import ReturnCall
from calfkit_tpu_torch.models.capability import CapabilityRecord, ToolDef
from calfkit_tpu_torch.models.error_report import FaultTypes
from calfkit_tpu_torch.models.payload import DataPart, TextPart
from calfkit_tpu_torch.models.tool_dispatch import ToolBinding
from calfkit_tpu_torch.mcp.transport import MCPServerSpec, MCPSession
from calfkit_tpu_torch.nodes.base import BaseNodeDef, NodeRunContext, handler
from calfkit_tpu_torch.nodes.tool import ToolNodeDef

logger = logging.getLogger(__name__)

NAMESPACE_SEP = "__"


class MCPToolboxNode(BaseNodeDef):
    kind = "toolbox"

    def __init__(self, spec: MCPServerSpec, **seams: Any):
        super().__init__(spec.name, **seams)
        self.spec = spec
        self._session: MCPSession | None = None
        self._tools: list[dict[str, Any]] = []
        self._list_lock = asyncio.Lock()

    # ------------------------------------------------------------- topics
    def input_topics(self) -> list[str]:
        return [protocol.toolbox_input_topic(self.name)]

    def return_topic(self) -> str:
        return protocol.require_topic_safe(
            f"mcp_server.{self.name}.private.return"
        )

    def publish_topic(self) -> str | None:
        return protocol.toolbox_publish_topic(self.name)

    # ----------------------------------------------------------- lifecycle
    async def start_session(self) -> None:
        """Connect + initial tools/list (the worker resource bracket)."""
        self._session = MCPSession(
            self.spec, on_tools_changed=self._relist
        )
        await self._session.start()
        await self._relist()

    async def stop_session(self) -> None:
        if self._session is not None:
            await self._session.stop()
            self._session = None

    async def _relist(self) -> None:
        if self._session is None:
            return
        async with self._list_lock:
            try:
                self._tools = await self._session.list_tools()
                logger.info(
                    "toolbox %s: %d tools listed", self.name, len(self._tools)
                )
            except Exception:  # noqa: BLE001
                logger.warning(
                    "toolbox %s: tools/list failed", self.name, exc_info=True
                )

    # -------------------------------------------------------- control plane
    def namespaced(self, tool_name: str) -> str:
        return f"{self.node_id}{NAMESPACE_SEP}{tool_name}"

    def capability_record(self) -> CapabilityRecord:
        return CapabilityRecord(
            node_id=self.node_id,
            node_kind=self.kind,
            dispatch_topic=protocol.toolbox_input_topic(self.name),
            tools=[
                ToolDef(
                    name=self.namespaced(t["name"]),
                    description=t.get("description", ""),
                    parameters_schema=t.get(
                        "inputSchema", {"type": "object", "properties": {}}
                    ),
                )
                for t in self._tools
            ],
        )

    # ---------------------------------------------------------------- body
    @handler("run")
    async def run(self, ctx: NodeRunContext) -> ReturnCall:
        if self._session is None:
            from calfkit_tpu_torch.exceptions import NodeFaultError
            from calfkit_tpu_torch.models.error_report import ErrorReport

            raise NodeFaultError(
                ErrorReport.build_safe(
                    FaultTypes.LIFECYCLE_ERROR,
                    f"toolbox {self.name} has no live MCP session",
                    node=self.node_id,
                )
            )
        args: dict[str, Any] = {}
        tool_name = ""
        for part in ctx.payload:
            if isinstance(part, DataPart) and isinstance(part.data, dict):
                tool_name = part.data.get("tool_name", "")
                raw = part.data.get("args", {})
                args = raw if isinstance(raw, dict) else {}
                break
        prefix = f"{self.node_id}{NAMESPACE_SEP}"
        upstream = tool_name.removeprefix(prefix)
        result = await self._session.call_tool(upstream, args)
        if isinstance(result, str):
            return ReturnCall(parts=[TextPart(text=result)])
        return ReturnCall(parts=[DataPart(data=result)])


class Toolbox:
    """Selector: every tool of one live toolbox (optionally filtered)."""

    def __init__(self, name: str, *, include: Sequence[str] | None = None):
        protocol.require_topic_safe(name, what="Toolbox name")
        self.name = name
        self.include = set(include) if include is not None else None

    def resolve(self, records: list[CapabilityRecord]) -> list[ToolBinding]:
        node_id = f"toolbox.{self.name}"
        bindings: list[ToolBinding] = []
        for record in records:
            if record.node_id != node_id:
                continue
            for tool in record.tools:
                upstream = tool.name.removeprefix(f"{node_id}{NAMESPACE_SEP}")
                if self.include is not None and upstream not in self.include:
                    continue  # the trust boundary
                bindings.append(
                    ToolBinding(tool=tool, dispatch_topic=record.dispatch_topic)
                )
        return bindings


class Toolboxes:
    """Selector over several toolboxes."""

    def __init__(self, *boxes: "Toolbox | str"):
        if not boxes:
            raise ValueError("Toolboxes requires at least one toolbox")
        self.boxes = [b if isinstance(b, Toolbox) else Toolbox(b) for b in boxes]

    def resolve(self, records: list[CapabilityRecord]) -> list[ToolBinding]:
        bindings: list[ToolBinding] = []
        for box in self.boxes:
            bindings.extend(box.resolve(records))
        return bindings


def mixed_tools(*specs: Any):
    """Combine ToolNodeDefs / Tools / Toolbox(es) into one resolvable spec."""

    class _Mixed:
        def resolve(self, records: list[CapabilityRecord]) -> list[ToolBinding]:
            from calfkit_tpu_torch.nodes.tool import eager_tools

            bindings: list[ToolBinding] = []
            node_defs = [s for s in specs if isinstance(s, ToolNodeDef)]
            bindings.extend(eager_tools(*node_defs))
            for spec in specs:
                if hasattr(spec, "resolve") and not isinstance(spec, ToolNodeDef):
                    bindings.extend(spec.resolve(records))
            return bindings

    return _Mixed()
