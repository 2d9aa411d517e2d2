"""OpenAI Responses-API model client (reference:
calfkit/providers/pydantic_ai/openai.py:71 ``OpenAIResponsesModelClient`` —
there a thin subclass of the vendored pydantic-ai Responses model; here a
client over the port's own HTTP client (:mod:`calfkit_tpu_torch._http`)
speaking the same ModelClient seam).

The Responses API differs from chat completions in shape, not in role:

- history is a flat ``input`` item list (messages, ``function_call`` items,
  ``function_call_output`` items) instead of role-tagged chat messages;
- tools are flat (``{"type": "function", "name", ...}``) rather than nested
  under a ``function`` key;
- ``max_output_tokens`` replaces both max-token spellings;
- streaming is TYPED events (``response.output_text.delta``,
  ``response.completed``) instead of chat chunks, and the terminal
  ``response.completed`` event carries the whole final response — so the
  stream accumulates text for deltas but builds the final ModelResponse
  from the terminal payload (no tool-call delta reassembly needed).
"""

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

_DEFAULT_BASE_URL = "https://api.openai.com/v1"


def render_responses_input(
    messages: list[ModelMessage],
) -> tuple[str | None, list[dict]]:
    """Our wire vocabulary → (instructions, Responses ``input`` items)."""
    instructions: str | None = None
    items: list[dict] = []
    for message in messages:
        if isinstance(message, ModelResponse):
            text = message.text()
            if text:
                items.append({
                    "type": "message", "role": "assistant",
                    "content": [{"type": "output_text", "text": text}],
                })
            for call in message.tool_calls():
                items.append({
                    "type": "function_call",
                    "call_id": call.tool_call_id,
                    "name": call.tool_name,
                    "arguments": (
                        call.args
                        if isinstance(call.args, str)
                        else json.dumps(call.args)
                    ),
                })
            continue
        assert isinstance(message, ModelRequest)
        if message.instructions:
            # the API carries system guidance in a dedicated field; the
            # LAST request's instructions win (same precedence as sending
            # a trailing system message in chat completions)
            instructions = message.instructions
        for part in message.parts:
            if isinstance(part, SystemPart):
                items.append({"role": "system", "content": part.content})
            elif isinstance(part, UserPart):
                items.append({
                    "role": "user", "content": content_str(part.content),
                })
            elif isinstance(part, ToolReturnPart):
                items.append({
                    "type": "function_call_output",
                    "call_id": part.tool_call_id,
                    "output": content_str(part.content),
                })
            elif isinstance(part, RetryPart):
                if part.tool_call_id:
                    items.append({
                        "type": "function_call_output",
                        "call_id": part.tool_call_id,
                        "output": part.content,
                    })
                else:
                    items.append({"role": "user", "content": part.content})
    return instructions, items


def parse_responses_output(data: dict, model: str) -> ModelResponse:
    """The ``output`` item list → ModelResponse (shared by the request path
    and the stream's terminal ``response.completed`` payload)."""
    output = data.get("output")
    if not isinstance(output, list):
        raise ModelAPIError(
            f"openai responses payload missing output: {data!r}"[:500]
        )
    parts: list[Any] = []
    for item in output:
        kind = item.get("type")
        if kind == "message":
            for block in item.get("content") or []:
                if block.get("type") == "output_text" and block.get("text"):
                    parts.append(TextOutput(text=block["text"]))
        elif kind == "function_call":
            parts.append(ToolCallOutput(
                tool_call_id=item.get("call_id", ""),
                tool_name=item.get("name", ""),
                args=item.get("arguments") or "{}",
            ))
        # reasoning / web_search / other built-in items carry no parts we
        # transport; tool use beyond function calls is out of scope here
    usage = data.get("usage") or {}
    return ModelResponse(
        parts=parts,
        usage=Usage(
            input_tokens=usage.get("input_tokens", 0),
            output_tokens=usage.get("output_tokens", 0),
        ),
        model_name=data.get("model", model),
    )


def _is_hard_failure(data: dict) -> bool:
    """True when a terminal Responses payload must raise.

    ``status="incomplete"`` with reason ``max_output_tokens`` is NOT a
    failure: the partial output is returned, matching the chat-completions
    client's behavior on ``finish_reason="length"`` (divergent handling
    would make the same cap fatal behind one provider and benign behind
    the other — and burn FallbackModelClient attempts on a condition every
    fallback hits too)."""
    status = data.get("status")
    if status == "failed":
        return True
    if status == "incomplete":
        reason = (data.get("incomplete_details") or {}).get("reason")
        return reason != "max_output_tokens"
    return False


class OpenAIResponsesModelClient(ModelClient):
    """The Responses API over the port's HTTP client.  ``http_client=`` injects a configured
    :class:`calfkit_tpu_torch._http.HTTPClient` (its timeout, its headers, a
    ``MockTransport`` in tests)."""

    def __init__(
        self,
        model: str,
        *,
        api_key: str | None = None,
        base_url: str = _DEFAULT_BASE_URL,
        http_client: Any | None = None,
        reasoning_effort: str | None = None,
    ):
        self._model = model
        self._api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self._base_url = base_url.rstrip("/")
        self._client = http_client
        self._owns_client = http_client is None
        self._reasoning_effort = reasoning_effort

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
        if self._client is not None and self._owns_client:
            await self._client.aclose()
            self._client = None

    def _build_payload(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings,
        params: ModelRequestParameters,
    ) -> dict[str, Any]:
        instructions, items = render_responses_input(messages)
        payload: dict[str, Any] = {"model": self._model, "input": items}
        if instructions:
            payload["instructions"] = instructions
        tools = [
            {
                "type": "function",
                "name": t.name,
                "description": t.description,
                "parameters": t.parameters_schema,
            }
            for t in params.all_tools()
        ]
        if tools:
            payload["tools"] = tools
            if not params.allow_text_output:
                payload["tool_choice"] = "required"
        if settings.max_tokens is not None:
            payload["max_output_tokens"] = settings.max_tokens
        if settings.temperature is not None:
            payload["temperature"] = settings.temperature
        if settings.top_p is not None:
            payload["top_p"] = settings.top_p
        if self._reasoning_effort is not None:
            payload["reasoning"] = {"effort": self._reasoning_effort}
        # stop_sequences / seed have no Responses-API equivalent; extra
        # carries anything provider-specific verbatim
        payload.update(settings.extra)
        return payload

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
            f"{self._base_url}/responses",
            headers={"Authorization": f"Bearer {self._api_key}"},
            payload=self._build_payload(messages, settings, params),
            provider="openai-responses",
        )
        if _is_hard_failure(data):
            err = data.get("error") or data.get("incomplete_details") or {}
            raise ModelAPIError(
                f"openai responses run {data.get('status')}: {err}"[:500],
                body=json.dumps(data)[:2000],
            )
        return parse_responses_output(data, self._model)

    async def request_stream(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ):
        """Typed-event SSE: yields TextDelta per ``response.output_text.delta``,
        then one ResponseDone built from ``response.completed``'s payload."""
        settings = settings or ModelSettings()
        params = params or ModelRequestParameters()
        payload = self._build_payload(messages, settings, params)
        payload["stream"] = True

        final: dict | None = None
        async for data in sse_lines(
            self._http(), f"{self._base_url}/responses",
            headers={"Authorization": f"Bearer {self._api_key}"},
            payload=payload, provider="openai-responses",
        ):
            if data == "[DONE]":
                break
            try:
                event = json.loads(data)
            except ValueError:
                continue
            kind = event.get("type", "")
            if kind == "response.output_text.delta" and event.get("delta"):
                yield TextDelta(event["delta"])
            elif kind == "response.completed":
                final = event.get("response") or {}
            elif kind == "response.incomplete":
                # terminal-but-capped: a max_output_tokens cap keeps the
                # partial output (chat-completions parity, see
                # _is_hard_failure); other reasons (content filter) raise
                # the typed error instead of the generic truncation guard
                resp = event.get("response") or {}
                if _is_hard_failure({**resp, "status": "incomplete"}):
                    raise ModelAPIError(
                        "openai responses run incomplete: "
                        f"{resp.get('incomplete_details')}"[:500],
                        body=json.dumps(resp)[:2000],
                    )
                final = resp
            elif kind in ("response.failed", "error"):
                detail = (
                    (event.get("response") or {}).get("error")
                    if kind == "response.failed" else event
                )
                # mid-stream failure: a truncated answer must not pass as
                # success (mirrors the chat-completions guard)
                raise ModelAPIError(
                    f"openai responses mid-stream error: {detail}"[:500]
                )

        if final is None:
            raise ModelAPIError(
                "openai responses stream closed without response.completed "
                "(response may be truncated)"
            )
        yield ResponseDone(parse_responses_output(final, self._model))
