"""Deterministic model clients for the offline test lane.

Equivalents of the vendored ``FunctionModel`` / ``TestModel`` the reference's
tests lean on everywhere (SURVEY.md §4: "this is how agent turns are tested
without any model API"), plus an ``EchoModelClient`` used by the quickstart's
no-weights mode.
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Awaitable, Callable, Union

from calfkit_tpu_torch.engine.model_client import (
    ModelClient,
    ModelRequestParameters,
    ModelSettings,
)
from calfkit_tpu_torch.models.messages import (
    ModelMessage,
    ModelRequest,
    ModelResponse,
    TextOutput,
    ToolCallOutput,
    ToolReturnPart,
    Usage,
    UserPart,
)
from calfkit_tpu_torch.models.payload import ContentPart, render_parts_as_text

ModelFunction = Callable[
    [list[ModelMessage], ModelRequestParameters],
    Union[ModelResponse, Awaitable[ModelResponse]],
]


def _estimate_tokens(messages: list[ModelMessage]) -> int:
    return sum(len(str(m)) // 4 for m in messages)


class FunctionModelClient(ModelClient):
    """A Python function as the model (reference analog: FunctionModel)."""

    def __init__(self, fn: ModelFunction, *, name: str = "function-model"):
        self._fn = fn
        self._name = name

    @property
    def model_name(self) -> str:
        return self._name

    async def request(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> ModelResponse:
        result = self._fn(messages, params or ModelRequestParameters())
        if hasattr(result, "__await__"):
            result = await result  # type: ignore[assignment]
        response: ModelResponse = result  # type: ignore[assignment]
        if not response.usage.input_tokens:
            response = response.model_copy(
                update={
                    "usage": Usage(
                        input_tokens=_estimate_tokens(messages),
                        output_tokens=_estimate_tokens([response]),
                    )
                }
            )
        if response.model_name is None:
            response = response.model_copy(update={"model_name": self._name})
        return response


def _last_user_text(messages: list[ModelMessage]) -> str:
    for message in reversed(messages):
        if isinstance(message, ModelRequest):
            for part in reversed(message.parts):
                if isinstance(part, UserPart):
                    if isinstance(part.content, str):
                        return part.content
                    return render_parts_as_text(part.content)
    return ""


class EchoModelClient(ModelClient):
    """Echoes the latest user prompt — the zero-weights quickstart model."""

    def __init__(self, *, prefix: str = "echo: ", name: str = "echo-model"):
        self._prefix = prefix
        self._name = name

    @property
    def model_name(self) -> str:
        return self._name

    async def request(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> ModelResponse:
        return ModelResponse(
            parts=[TextOutput(text=f"{self._prefix}{_last_user_text(messages)}")],
            usage=Usage(input_tokens=_estimate_tokens(messages), output_tokens=8),
            model_name=self._name,
        )


class TestModelClient(ModelClient):
    """Calls every available tool once (with schema-derived stub args), then
    produces a final text or structured output (reference analog: TestModel).
    """

    __test__ = False  # not a pytest collectible despite the name

    def __init__(
        self,
        *,
        custom_output_text: str | None = None,
        custom_output_args: dict[str, Any] | None = None,
        call_tools: str = "all",  # "all" | "none"
        name: str = "test-model",
    ):
        self._text = custom_output_text
        self._output_args = custom_output_args
        self._call_tools = call_tools
        self._name = name

    @property
    def model_name(self) -> str:
        return self._name

    # ---------------------------------------------------------------- stubs
    @staticmethod
    def _stub_value(schema: dict[str, Any]) -> Any:
        t = schema.get("type")
        if "default" in schema:
            return schema["default"]
        if t == "string":
            return "a"
        if t == "integer":
            return 0
        if t == "number":
            return 0.0
        if t == "boolean":
            return False
        if t == "array":
            return []
        if t == "object" or "properties" in schema:
            return {
                k: TestModelClient._stub_value(v)
                for k, v in schema.get("properties", {}).items()
                if k in schema.get("required", [])
            }
        return None

    def _stub_args(self, schema: dict[str, Any]) -> dict[str, Any]:
        props = schema.get("properties", {})
        required = schema.get("required", list(props))
        return {k: self._stub_value(v) for k, v in props.items() if k in required}

    async def request(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> ModelResponse:
        params = params or ModelRequestParameters()
        returned_ids = {
            part.tool_call_id
            for message in messages
            if isinstance(message, ModelRequest)
            for part in message.parts
            if isinstance(part, ToolReturnPart)
        }
        called: set[str] = set()
        for message in messages:
            if isinstance(message, ModelResponse):
                called |= {c.tool_name for c in message.tool_calls()}

        if self._call_tools == "all":
            pending = [t for t in params.tool_defs if t.name not in called]
            if pending:
                return ModelResponse(
                    parts=[
                        ToolCallOutput(
                            tool_call_id=f"tc_{uuid.uuid4().hex[:8]}",
                            tool_name=t.name,
                            args=self._stub_args(t.parameters_schema),
                        )
                        for t in pending
                    ],
                    usage=Usage(input_tokens=_estimate_tokens(messages), output_tokens=8),
                    model_name=self._name,
                )

        if params.output_tool is not None:
            args = self._output_args
            if args is None:
                args = self._stub_args(params.output_tool.parameters_schema)
            return ModelResponse(
                parts=[
                    ToolCallOutput(
                        tool_call_id=f"tc_{uuid.uuid4().hex[:8]}",
                        tool_name=params.output_tool.name,
                        args=args,
                    )
                ],
                usage=Usage(input_tokens=_estimate_tokens(messages), output_tokens=8),
                model_name=self._name,
            )

        text = self._text
        if text is None:
            summary = {"tools_called": sorted(called), "replies": len(returned_ids)}
            text = json.dumps(summary)
        return ModelResponse(
            parts=[TextOutput(text=text)],
            usage=Usage(input_tokens=_estimate_tokens(messages), output_tokens=8),
            model_name=self._name,
        )
