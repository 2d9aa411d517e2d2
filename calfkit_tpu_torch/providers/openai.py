"""OpenAI chat-completions model client (reference:
calfkit/providers/pydantic_ai/openai.py — there a thin subclass of the
vendored model; here a client over the port's own HTTP client
(:mod:`calfkit_tpu_torch._http`) speaking the same ModelClient
seam)."""

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


def render_openai_messages(messages: list[ModelMessage]) -> list[dict]:
    """Our wire vocabulary → chat-completions messages."""
    out: list[dict] = []
    for message in messages:
        if isinstance(message, ModelResponse):
            entry: dict[str, Any] = {"role": "assistant"}
            text = message.text()
            entry["content"] = text or None
            calls = [
                {
                    "id": c.tool_call_id,
                    "type": "function",
                    "function": {
                        "name": c.tool_name,
                        "arguments": (
                            c.args
                            if isinstance(c.args, str)
                            else json.dumps(c.args)
                        ),
                    },
                }
                for c in message.tool_calls()
            ]
            if calls:
                entry["tool_calls"] = calls
            out.append(entry)
            continue
        assert isinstance(message, ModelRequest)
        if message.instructions:
            out.append({"role": "system", "content": message.instructions})
        for part in message.parts:
            if isinstance(part, SystemPart):
                out.append({"role": "system", "content": part.content})
            elif isinstance(part, UserPart):
                out.append({"role": "user", "content": content_str(part.content)})
            elif isinstance(part, ToolReturnPart):
                out.append({
                    "role": "tool",
                    "tool_call_id": part.tool_call_id,
                    "content": content_str(part.content),
                })
            elif isinstance(part, RetryPart):
                if part.tool_call_id:
                    out.append({
                        "role": "tool",
                        "tool_call_id": part.tool_call_id,
                        "content": part.content,
                    })
                else:
                    out.append({"role": "user", "content": part.content})
    return out


def parse_openai_response(data: dict, model: str) -> ModelResponse:
    try:
        message = data["choices"][0]["message"]
    except (KeyError, IndexError, TypeError) as exc:
        raise ModelAPIError(
            f"openai response missing choices: {data!r}"[:500]
        ) from exc
    parts: list[Any] = []
    if message.get("content"):
        parts.append(TextOutput(text=message["content"]))
    for call in message.get("tool_calls") or []:
        function = call.get("function", {})
        parts.append(ToolCallOutput(
            tool_call_id=call.get("id", ""),
            tool_name=function.get("name", ""),
            args=function.get("arguments", "{}"),
        ))
    usage = data.get("usage") or {}
    return ModelResponse(
        parts=parts,
        usage=Usage(
            input_tokens=usage.get("prompt_tokens", 0),
            output_tokens=usage.get("completion_tokens", 0),
        ),
        model_name=data.get("model", model),
    )


def _merge_tool_call_delta(
    acc: dict[int, dict], delta: dict, last: int | None = None
) -> int:
    """Accumulate a streaming tool_calls delta by index.

    Compatible backends sometimes omit ``index``; defaulting it to 0 would
    merge distinct parallel calls into one slot (concatenated names/args).
    Fallback order: match by call id, else continue the MOST-RECENTLY-
    TOUCHED slot (``last`` — streaming order; matching the highest index
    instead misattributes continuations when a backend interleaves id-less
    chunks across parallel calls), else open a fresh one.  Returns the
    touched index for the caller to thread back in as ``last``.
    """
    index = delta.get("index")
    if index is None:
        call_id = delta.get("id") or ""
        if call_id:
            index = next(
                (k for k, s in acc.items() if s["id"] == call_id), None
            )
        elif last in acc:
            index = last
        else:
            index = max(acc, default=None)
        if index is None:
            index = max(acc, default=-1) + 1
    slot = acc.setdefault(index, {"id": "", "name": "", "arguments": ""})
    if delta.get("id"):
        slot["id"] = delta["id"]
    function = delta.get("function") or {}
    if function.get("name"):
        slot["name"] += function["name"]
    if function.get("arguments"):
        slot["arguments"] += function["arguments"]
    return index


class OpenAIModelClient(ModelClient):
    """Chat-completions over the port's HTTP client.  ``http_client=`` injects a configured
    :class:`calfkit_tpu_torch._http.HTTPClient` (its timeout, its headers, a
    ``MockTransport`` in tests)."""

    def __init__(
        self,
        model: str,
        *,
        api_key: str | None = None,
        base_url: str = _DEFAULT_BASE_URL,
        http_client: Any | None = None,
        max_tokens_param: str = "auto",
    ):
        if max_tokens_param not in ("auto", "max_tokens", "max_completion_tokens"):
            raise ValueError(
                "max_tokens_param must be 'auto', 'max_tokens' or "
                f"'max_completion_tokens', got {max_tokens_param!r}"
            )
        self._model = model
        self._api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self._base_url = base_url.rstrip("/")
        self._client = http_client
        self._owns_client = http_client is None
        self._max_tokens_param = max_tokens_param

    # reasoning-model families reject the legacy ``max_tokens`` spelling in
    # favor of ``max_completion_tokens``; OpenAI-compatible third-party
    # backends mostly only know the legacy one, so 'auto' decides by model
    # name and the constructor knob / settings.extra override it
    _REASONING_PREFIXES = ("o1", "o3", "o4", "gpt-5")

    def _max_tokens_key(self) -> str:
        if self._max_tokens_param != "auto":
            return self._max_tokens_param
        if self._model.lower().startswith(self._REASONING_PREFIXES):
            return "max_completion_tokens"
        return "max_tokens"

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
        payload: dict[str, Any] = {
            "model": self._model,
            "messages": render_openai_messages(messages),
        }
        tools = [
            {
                "type": "function",
                "function": {
                    "name": t.name,
                    "description": t.description,
                    "parameters": t.parameters_schema,
                },
            }
            for t in params.all_tools()
        ]
        if tools:
            payload["tools"] = tools
            if not params.allow_text_output:
                payload["tool_choice"] = "required"
        if settings.max_tokens is not None:
            payload[self._max_tokens_key()] = settings.max_tokens
        if settings.temperature is not None:
            payload["temperature"] = settings.temperature
        if settings.top_p is not None:
            payload["top_p"] = settings.top_p
        if settings.seed is not None:
            payload["seed"] = settings.seed
        if settings.stop_sequences:
            payload["stop"] = settings.stop_sequences
        payload.update(settings.extra)
        # an explicit key in settings.extra wins outright — never send both
        # spellings (the API rejects the pair)
        if "max_completion_tokens" in settings.extra:
            payload.pop("max_tokens", None)
        elif "max_tokens" in settings.extra:
            payload.pop("max_completion_tokens", None)
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
            f"{self._base_url}/chat/completions",
            headers={"Authorization": f"Bearer {self._api_key}"},
            payload=self._build_payload(messages, settings, params),
            provider="openai",
        )
        return parse_openai_response(data, self._model)

    async def request_stream(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ):
        """SSE streaming: yields TextDelta per content delta, accumulates
        tool-call deltas by index, then one ResponseDone."""
        settings = settings or ModelSettings()
        params = params or ModelRequestParameters()
        payload = self._build_payload(messages, settings, params)
        payload["stream"] = True
        payload["stream_options"] = {"include_usage": True}

        text_chunks: list[str] = []
        calls: dict[int, dict] = {}
        last_call: int | None = None
        usage = Usage()
        model_name = self._model
        terminated = False
        finish_seen = False
        async for data in sse_lines(
            self._http(), f"{self._base_url}/chat/completions",
            headers={"Authorization": f"Bearer {self._api_key}"},
            payload=payload, provider="openai",
        ):
            if data == "[DONE]":
                terminated = True
                break
            try:
                event = json.loads(data)
            except ValueError:
                continue
            if event.get("error"):
                # mid-stream failure: a truncated answer must not pass as
                # success (the non-streaming path raises for this state)
                raise ModelAPIError(
                    f"openai mid-stream error: {event['error']}"[:500]
                )
            model_name = event.get("model", model_name)
            if event.get("usage"):
                usage = Usage(
                    input_tokens=event["usage"].get("prompt_tokens", 0),
                    output_tokens=event["usage"].get("completion_tokens", 0),
                )
            for choice in event.get("choices") or []:
                if choice.get("finish_reason"):
                    finish_seen = True
                delta = choice.get("delta") or {}
                if delta.get("content"):
                    text_chunks.append(delta["content"])
                    yield TextDelta(delta["content"])
                for call_delta in delta.get("tool_calls") or []:
                    last_call = _merge_tool_call_delta(
                        calls, call_delta, last_call
                    )

        if not terminated and not finish_seen:
            # a clean TCP close with neither the [DONE] sentinel nor any
            # finish_reason-bearing chunk means the answer may be truncated
            # — that must not pass as success.  Some OpenAI-compatible
            # proxies end successful streams without [DONE]; a seen
            # finish_reason is the alternate completion signal.
            raise ModelAPIError(
                "openai stream closed without [DONE] or a finish_reason "
                "(response may be truncated)"
            )

        parts: list[Any] = []
        if text_chunks:
            parts.append(TextOutput(text="".join(text_chunks)))
        for index in sorted(calls):
            slot = calls[index]
            parts.append(ToolCallOutput(
                tool_call_id=slot["id"], tool_name=slot["name"],
                args=slot["arguments"] or "{}",
            ))
        yield ResponseDone(ModelResponse(
            parts=parts, usage=usage, model_name=model_name,
        ))

