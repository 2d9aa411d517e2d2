"""Anthropic messages-API model client (reference:
calfkit/providers/pydantic_ai/anthropic.py — thin subclass there; here a
client over the port's own HTTP client (:mod:`calfkit_tpu_torch._http`), on
the same ModelClient seam; the JAX package's counterpart is
``calfkit_tpu.providers.anthropic``)."""

from __future__ import annotations

import json
import os
from typing import Any

from calfkit_tpu_torch.engine.model_client import (
    ModelClient,
    ModelRequestParameters,
    ModelSettings,
    ResponseDone,
    TextDelta,
)
from calfkit_tpu_torch.models.messages import (
    ModelMessage,
    ModelRequest,
    ModelResponse,
    RetryPart,
    SystemPart,
    TextOutput,
    ToolCallOutput,
    ToolReturnPart,
    Usage,
    UserPart,
)
from calfkit_tpu_torch.providers.http import (
    ModelAPIError,
    content_str,
    post_json,
    sse_lines,
)

_DEFAULT_BASE_URL = "https://api.anthropic.com"
_API_VERSION = "2023-06-01"
_DEFAULT_MAX_TOKENS = 4096


def render_anthropic_messages(
    messages: list[ModelMessage],
) -> tuple[str, list[dict]]:
    """Our wire vocabulary → (system, messages-with-content-blocks).

    Consecutive same-role messages are merged — the API requires
    alternation and tool_result blocks must ride user messages."""
    system_chunks: list[str] = []
    rendered: list[dict] = []

    def emit(role: str, blocks: list[dict]) -> None:
        if not blocks:
            return
        if rendered and rendered[-1]["role"] == role:
            rendered[-1]["content"].extend(blocks)
        else:
            rendered.append({"role": role, "content": blocks})

    for message in messages:
        if isinstance(message, ModelResponse):
            blocks: list[dict] = []
            text = message.text()
            if text:
                blocks.append({"type": "text", "text": text})
            for call in message.tool_calls():
                blocks.append({
                    "type": "tool_use",
                    "id": call.tool_call_id,
                    "name": call.tool_name,
                    "input": call.args_dict(),
                })
            emit("assistant", blocks)
            continue
        assert isinstance(message, ModelRequest)
        if message.instructions:
            system_chunks.append(message.instructions)
        blocks = []
        for part in message.parts:
            if isinstance(part, SystemPart):
                system_chunks.append(part.content)
            elif isinstance(part, UserPart):
                blocks.append({"type": "text", "text": content_str(part.content)})
            elif isinstance(part, ToolReturnPart):
                blocks.append({
                    "type": "tool_result",
                    "tool_use_id": part.tool_call_id,
                    "content": [{"type": "text", "text": content_str(part.content)}],
                })
            elif isinstance(part, RetryPart):
                if part.tool_call_id:
                    blocks.append({
                        "type": "tool_result",
                        "tool_use_id": part.tool_call_id,
                        "is_error": True,
                        "content": [{"type": "text", "text": part.content}],
                    })
                else:
                    blocks.append({"type": "text", "text": part.content})
        emit("user", blocks)
    return "\n\n".join(system_chunks), rendered


def parse_anthropic_response(data: dict, model: str) -> ModelResponse:
    content = data.get("content")
    if not isinstance(content, list):
        raise ModelAPIError(f"anthropic response missing content: {data!r}"[:500])
    parts: list[Any] = []
    for block in content:
        kind = block.get("type")
        if kind == "text" and block.get("text"):
            parts.append(TextOutput(text=block["text"]))
        elif kind == "tool_use":
            parts.append(ToolCallOutput(
                tool_call_id=block.get("id", ""),
                tool_name=block.get("name", ""),
                args=block.get("input") or {},
            ))
    usage = data.get("usage") or {}
    return ModelResponse(
        parts=parts,
        usage=Usage(
            input_tokens=usage.get("input_tokens", 0),
            output_tokens=usage.get("output_tokens", 0),
        ),
        model_name=data.get("model", model),
    )


class AnthropicModelClient(ModelClient):
    def __init__(
        self,
        model: str,
        *,
        api_key: str | None = None,
        base_url: str = _DEFAULT_BASE_URL,
        http_client: Any | None = None,
        default_max_tokens: int = _DEFAULT_MAX_TOKENS,
    ):
        self._model = model
        self._api_key = api_key or os.environ.get("ANTHROPIC_API_KEY", "")
        self._base_url = base_url.rstrip("/")
        self._client = http_client
        self._owns_client = http_client is None
        self._default_max_tokens = default_max_tokens

    @property
    def model_name(self) -> str:
        return self._model

    def _http(self) -> Any:
        if self._client is None:
            from calfkit_tpu_torch._http import HTTPClient

            self._client = HTTPClient(timeout=120.0)
            self._owns_client = True
        return self._client

    async def aclose(self) -> None:
        # close only the DEFAULT client this instance created; a
        # caller-injected http_client= stays the caller's to close
        # (it may be shared across model clients)
        if self._client is not None and self._owns_client:
            await self._client.aclose()
            self._client = None

    def _build_payload(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings,
        params: ModelRequestParameters,
    ) -> dict[str, Any]:
        system, rendered = render_anthropic_messages(messages)
        payload: dict[str, Any] = {
            "model": self._model,
            "messages": rendered,
            # max_tokens is REQUIRED by the API
            "max_tokens": settings.max_tokens or self._default_max_tokens,
        }
        if system:
            payload["system"] = system
        tools = [
            {
                "name": t.name,
                "description": t.description,
                "input_schema": t.parameters_schema,
            }
            for t in params.all_tools()
        ]
        if tools:
            payload["tools"] = tools
            if not params.allow_text_output:
                payload["tool_choice"] = {"type": "any"}
        if settings.temperature is not None:
            payload["temperature"] = settings.temperature
        if settings.top_p is not None:
            payload["top_p"] = settings.top_p
        if settings.top_k is not None:
            payload["top_k"] = settings.top_k
        if settings.stop_sequences:
            payload["stop_sequences"] = settings.stop_sequences
        payload.update(settings.extra)
        return payload

    def _headers(self) -> dict[str, str]:
        return {
            "x-api-key": self._api_key,
            "anthropic-version": _API_VERSION,
        }

    async def request(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> ModelResponse:
        settings = settings or ModelSettings()
        params = params or ModelRequestParameters()
        data = await post_json(
            self._http(),
            f"{self._base_url}/v1/messages",
            headers=self._headers(),
            payload=self._build_payload(messages, settings, params),
            provider="anthropic",
        )
        return parse_anthropic_response(data, self._model)

    async def request_stream(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ):
        """SSE streaming: text_delta blocks yield TextDelta; tool_use
        blocks accumulate their input_json_delta; one ResponseDone."""
        settings = settings or ModelSettings()
        params = params or ModelRequestParameters()
        payload = self._build_payload(messages, settings, params)
        payload["stream"] = True

        text_chunks: list[str] = []
        tools_by_index: dict[int, dict] = {}
        usage = Usage()
        model_name = self._model
        terminated = False
        async for data in sse_lines(
            self._http(), f"{self._base_url}/v1/messages",
            headers=self._headers(), payload=payload, provider="anthropic",
        ):
            try:
                event = json.loads(data)
            except ValueError:
                continue
            kind = event.get("type")
            if kind == "error":
                # mid-stream failure (e.g. overloaded_error): a truncated
                # answer must not pass as success
                raise ModelAPIError(
                    f"anthropic mid-stream error: {event.get('error')}"[:500]
                )
            if kind == "message_start":
                message = event.get("message") or {}
                model_name = message.get("model", model_name)
                start_usage = message.get("usage") or {}
                usage = Usage(
                    input_tokens=start_usage.get("input_tokens", 0),
                    output_tokens=usage.output_tokens,
                )
            elif kind == "content_block_start":
                block = event.get("content_block") or {}
                if block.get("type") == "tool_use":
                    tools_by_index[event.get("index", 0)] = {
                        "id": block.get("id", ""),
                        "name": block.get("name", ""),
                        "json": "",
                    }
            elif kind == "content_block_delta":
                delta = event.get("delta") or {}
                if delta.get("type") == "text_delta" and delta.get("text"):
                    text_chunks.append(delta["text"])
                    yield TextDelta(delta["text"])
                elif delta.get("type") == "input_json_delta":
                    slot = tools_by_index.get(event.get("index", 0))
                    if slot is not None:
                        slot["json"] += delta.get("partial_json", "")
            elif kind == "message_delta":
                delta_usage = event.get("usage") or {}
                if delta_usage.get("output_tokens"):
                    usage = Usage(
                        input_tokens=usage.input_tokens,
                        output_tokens=delta_usage["output_tokens"],
                    )
            elif kind == "message_stop":
                terminated = True

        if not terminated:
            # a clean close without message_stop means the answer may be
            # truncated — that must not pass as success
            raise ModelAPIError(
                "anthropic stream closed without message_stop "
                "(response may be truncated)"
            )

        parts: list[Any] = []
        if text_chunks:
            parts.append(TextOutput(text="".join(text_chunks)))
        for index in sorted(tools_by_index):
            slot = tools_by_index[index]
            parts.append(ToolCallOutput(
                tool_call_id=slot["id"], tool_name=slot["name"],
                args=slot["json"] or "{}",
            ))
        yield ResponseDone(ModelResponse(
            parts=parts, usage=usage, model_name=model_name,
        ))
