"""Tool nodes: ``@agent_tool`` turns a function into a deployable mesh node.

Reference: calfkit/nodes/tool.py:95-260 — signature-derived schema +
validator, ``ModelRetry`` → retry-marked TextPart, eager wire-safety before
return, and the ``Tools`` call-side selector (curated names XOR discover).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Sequence

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.engine.schema import FunctionSchema, ValidationError, function_schema
from calfkit_tpu_torch.models._wire import to_jsonable
from calfkit_tpu_torch.models.actions import ReturnCall
from calfkit_tpu_torch.models.capability import CapabilityRecord, ToolDef
from calfkit_tpu_torch.models.error_report import FaultTypes
from calfkit_tpu_torch.models.payload import DataPart, TextPart, retry_text_part
from calfkit_tpu_torch.models.tool_dispatch import ToolBinding
from calfkit_tpu_torch.nodes.base import BaseNodeDef, NodeRunContext, handler


class ModelRetry(Exception):
    """Raised by a tool to send the model a retry prompt instead of a result
    (reference: the vendored ModelRetry honored at nodes/tool.py:123)."""


class ToolNodeDef(BaseNodeDef):
    kind = "tool"

    def __init__(
        self,
        fn: Callable[..., Any] | FunctionSchema,
        *,
        name: str | None = None,
        description: str | None = None,
        **seams: Any,
    ):
        self.schema = (
            fn
            if isinstance(fn, FunctionSchema)
            else function_schema(fn, name=name, description=description)
        )
        super().__init__(name or self.schema.tool_def.name, **seams)

    def _own_fault_type(self) -> str:
        return FaultTypes.TOOL_ERROR

    # ------------------------------------------------------------- topics
    def input_topics(self) -> list[str]:
        return [protocol.tool_input_topic(self.name)]

    def return_topic(self) -> str:
        return protocol.require_topic_safe(f"tool.{self.name}.private.return")

    def publish_topic(self) -> str | None:
        return protocol.tool_publish_topic(self.name)

    # -------------------------------------------------------- control plane
    def capability_record(self) -> CapabilityRecord:
        """The advert this node publishes (reference: tool.py:69)."""
        return CapabilityRecord(
            node_id=self.node_id,
            node_kind=self.kind,
            dispatch_topic=protocol.tool_input_topic(self.name),
            tools=[self.schema.tool_def],
        )

    # ---------------------------------------------------------------- body
    @staticmethod
    def _args_from_payload(ctx: NodeRunContext) -> dict[str, Any]:
        for part in ctx.payload:
            if isinstance(part, DataPart) and isinstance(part.data, dict):
                # either a ToolCallRef-shaped body or bare args
                if "args" in part.data and "tool_name" in part.data:
                    args = part.data.get("args")
                    return args if isinstance(args, dict) else {}
                return part.data
        return {}

    @handler("run")
    async def run(self, ctx: NodeRunContext) -> ReturnCall:
        args = self._args_from_payload(ctx)
        try:
            result = await self.schema.call(args, ctx)
        except ModelRetry as retry:
            return ReturnCall(parts=[retry_text_part(str(retry))])
        except ValidationError as exc:
            # bad arguments: ask the model to try again, don't fault the run
            return ReturnCall(
                parts=[retry_text_part(f"Invalid arguments for {self.name}: {exc}")]
            )
        # eager wire-safety: a result that can't serialize fails HERE, inside
        # this node's fault rail, not at the caller (reference: tool.py:158)
        try:
            jsonable = to_jsonable(result)
            json.dumps(jsonable)
        except (TypeError, ValueError) as exc:
            raise TypeError(
                f"tool {self.name!r} returned a non-wire-safe value "
                f"({type(result).__name__}): {exc}"
            ) from exc
        if isinstance(jsonable, str):
            return ReturnCall(parts=[TextPart(text=jsonable)])
        return ReturnCall(parts=[DataPart(data=jsonable)])


def agent_tool(
    fn: Callable[..., Any] | None = None,
    *,
    name: str | None = None,
    description: str | None = None,
    **seams: Any,
) -> Any:
    """Decorator: ``@agent_tool`` → a deployable :class:`ToolNodeDef`."""

    def build(f: Callable[..., Any]) -> ToolNodeDef:
        return ToolNodeDef(f, name=name, description=description, **seams)

    return build(fn) if fn is not None else build


class Tools:
    """Call-side tool selector: curated names XOR discover-all.

    Resolves against the live capability view at model-turn time
    (reference: nodes/tool.py:207 ``Tools``).
    """

    def __init__(
        self, *names: str, discover: bool = False, exclude: Sequence[str] = ()
    ):
        from calfkit_tpu_torch.utils_names import validate_curated_or_discover

        validate_curated_or_discover("Tools", names, discover)
        self.names = list(names)
        self.discover = discover
        self.exclude = set(exclude)

    def resolve(self, records: list[CapabilityRecord]) -> list[ToolBinding]:
        from calfkit_tpu_torch.models.capability import (
            resolve_all_capabilities,
            resolve_capability,
        )

        if self.discover:
            return [
                ToolBinding(tool=r.tool, dispatch_topic=r.dispatch_topic)
                for r in resolve_all_capabilities(records)
                if r.tool.name not in self.exclude
            ]
        bindings: list[ToolBinding] = []
        for tool_name in self.names:
            resolved = resolve_capability(records, tool_name)
            bindings.append(
                ToolBinding(tool=resolved.tool, dispatch_topic=resolved.dispatch_topic)
            )
        return bindings


def eager_tools(*defs: ToolNodeDef) -> list[ToolBinding]:
    """Bind tool defs directly (no discovery): the quickstart path where the
    agent and tools deploy in one worker."""
    return [
        ToolBinding(
            tool=d.schema.tool_def,
            dispatch_topic=protocol.tool_input_topic(d.name),
        )
        for d in defs
    ]
