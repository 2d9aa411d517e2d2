"""Google Gemini generateContent model client (reference: the vendored
pydantic-ai provider set includes a Google adapter,
calfkit/_vendor/pydantic_ai/models/google.py; here a client over the port's own
HTTP client (:mod:`calfkit_tpu_torch._http`)
on the same ModelClient seam — no google-genai SDK).

Protocol notes that shape the mapping:

- history is ``contents`` with roles ``user``/``model``; function results
  ride a user turn as ``functionResponse`` parts;
- Gemini has NO tool-call ids — calls and responses correlate by function
  NAME.  Outbound, ids minted by this client are ``<name>#<n>`` so the
  framework's id-keyed bookkeeping still works; inbound, the id is
  dropped and the name carries the correlation;
- system guidance is the dedicated ``systemInstruction`` field;
- streaming is ``:streamGenerateContent?alt=sse`` — chunks are whole
  GenerateContentResponse objects (function calls arrive complete, not as
  deltas), so the stream accumulates text and keeps the LAST usage.
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

_DEFAULT_BASE_URL = "https://generativelanguage.googleapis.com/v1beta"

# finish reasons that mean the answer was cut for a non-length reason —
# surfaced as typed errors instead of silently-partial output
_HARD_FINISH = ("SAFETY", "RECITATION", "BLOCKLIST", "PROHIBITED_CONTENT",
                "MALFORMED_FUNCTION_CALL")


def render_gemini_contents(
    messages: list[ModelMessage],
) -> tuple[str, list[dict]]:
    """Our wire vocabulary → (system_instruction, contents)."""
    system_chunks: list[str] = []
    contents: list[dict] = []

    def emit(role: str, parts: list[dict]) -> None:
        if not parts:
            return
        if contents and contents[-1]["role"] == role:
            contents[-1]["parts"].extend(parts)
        else:
            contents.append({"role": role, "parts": parts})

    for message in messages:
        if isinstance(message, ModelResponse):
            parts: list[dict] = []
            text = message.text()
            if text:
                parts.append({"text": text})
            for call in message.tool_calls():
                parts.append({
                    "functionCall": {
                        "name": call.tool_name,
                        "args": call.args_dict(),
                    }
                })
            emit("model", parts)
            continue
        assert isinstance(message, ModelRequest)
        if message.instructions:
            system_chunks.append(message.instructions)
        parts = []
        for part in message.parts:
            if isinstance(part, SystemPart):
                system_chunks.append(part.content)
            elif isinstance(part, UserPart):
                parts.append({"text": content_str(part.content)})
            elif isinstance(part, ToolReturnPart):
                parts.append({
                    "functionResponse": {
                        "name": part.tool_name,
                        "response": {"result": content_str(part.content)},
                    }
                })
            elif isinstance(part, RetryPart):
                if part.tool_call_id:
                    # name-correlated: the retry's tool_name carries it
                    parts.append({
                        "functionResponse": {
                            "name": part.tool_name or "tool",
                            "response": {"error": part.content},
                        }
                    })
                else:
                    parts.append({"text": part.content})
        emit("user", parts)
    return "\n\n".join(system_chunks), contents


def parse_gemini_response(data: dict, model: str) -> ModelResponse:
    candidates = data.get("candidates")
    if not isinstance(candidates, list) or not candidates:
        # prompt-level block arrives with no candidates at all
        feedback = data.get("promptFeedback") or {}
        raise ModelAPIError(
            f"gemini response has no candidates "
            f"(blockReason={feedback.get('blockReason')!r})",
            body=json.dumps(data)[:2000],
        )
    candidate = candidates[0]
    finish = candidate.get("finishReason")
    if finish in _HARD_FINISH:
        raise ModelAPIError(
            f"gemini candidate finished {finish}",
            body=json.dumps(candidate)[:2000],
        )
    parts: list[Any] = []
    n_calls = 0
    for part in (candidate.get("content") or {}).get("parts") or []:
        if part.get("text"):
            parts.append(TextOutput(text=part["text"]))
        elif part.get("functionCall"):
            call = part["functionCall"]
            # Gemini carries no call ids; mint a stable per-response one
            parts.append(ToolCallOutput(
                tool_call_id=f"{call.get('name', 'tool')}#{n_calls}",
                tool_name=call.get("name", ""),
                args=call.get("args") or {},
            ))
            n_calls += 1
    usage = data.get("usageMetadata") or {}
    return ModelResponse(
        parts=parts,
        usage=Usage(
            input_tokens=usage.get("promptTokenCount", 0),
            output_tokens=usage.get("candidatesTokenCount", 0),
        ),
        model_name=data.get("modelVersion", model),
    )


class GeminiModelClient(ModelClient):
    """generateContent over the port's HTTP client.  ``http_client=`` injects a configured
    :class:`calfkit_tpu_torch._http.HTTPClient` (its timeout, its headers, a
    ``MockTransport`` in tests)."""

    def __init__(
        self,
        model: str,
        *,
        api_key: str | None = None,
        base_url: str = _DEFAULT_BASE_URL,
        http_client: Any | None = None,
    ):
        self._model = model
        self._api_key = api_key or os.environ.get("GEMINI_API_KEY", "") or (
            os.environ.get("GOOGLE_API_KEY", "")
        )
        self._base_url = base_url.rstrip("/")
        self._client = http_client
        self._owns_client = http_client is None

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
        system, contents = render_gemini_contents(messages)
        payload: dict[str, Any] = {"contents": contents}
        if system:
            payload["systemInstruction"] = {"parts": [{"text": system}]}
        declarations = [
            {
                "name": t.name,
                "description": t.description,
                "parameters": t.parameters_schema,
            }
            for t in params.all_tools()
        ]
        if declarations:
            payload["tools"] = [{"functionDeclarations": declarations}]
            if not params.allow_text_output:
                payload["toolConfig"] = {
                    "functionCallingConfig": {"mode": "ANY"}
                }
        config: dict[str, Any] = {}
        if settings.max_tokens is not None:
            config["maxOutputTokens"] = settings.max_tokens
        if settings.temperature is not None:
            config["temperature"] = settings.temperature
        if settings.top_p is not None:
            config["topP"] = settings.top_p
        if settings.top_k is not None:
            config["topK"] = settings.top_k
        if settings.stop_sequences:
            config["stopSequences"] = settings.stop_sequences
        if config:
            payload["generationConfig"] = config
        payload.update(settings.extra)
        return payload

    def _headers(self) -> dict[str, str]:
        return {"x-goog-api-key": self._api_key}

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
            f"{self._base_url}/models/{self._model}:generateContent",
            headers=self._headers(),
            payload=self._build_payload(messages, settings, params),
            provider="gemini",
        )
        return parse_gemini_response(data, self._model)

    async def request_stream(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ):
        """SSE streaming: each chunk is a whole GenerateContentResponse;
        text parts yield TextDelta, function calls arrive complete, the
        LAST chunk's usage/finishReason wins; one ResponseDone."""
        settings = settings or ModelSettings()
        params = params or ModelRequestParameters()
        payload = self._build_payload(messages, settings, params)

        text_chunks: list[str] = []
        calls: list[dict] = []
        usage = Usage()
        model_name = self._model
        finish: str | None = None
        async for data in sse_lines(
            self._http(),
            f"{self._base_url}/models/{self._model}:streamGenerateContent?alt=sse",
            headers=self._headers(), payload=payload, provider="gemini",
        ):
            try:
                event = json.loads(data)
            except ValueError:
                continue
            if event.get("error"):
                raise ModelAPIError(
                    f"gemini mid-stream error: {event['error']}"[:500]
                )
            model_name = event.get("modelVersion", model_name)
            meta = event.get("usageMetadata")
            if meta:
                usage = Usage(
                    input_tokens=meta.get("promptTokenCount", 0),
                    output_tokens=meta.get("candidatesTokenCount", 0),
                )
            for candidate in event.get("candidates") or []:
                if candidate.get("finishReason"):
                    finish = candidate["finishReason"]
                for part in (candidate.get("content") or {}).get("parts") or []:
                    if part.get("text"):
                        text_chunks.append(part["text"])
                        yield TextDelta(part["text"])
                    elif part.get("functionCall"):
                        calls.append(part["functionCall"])

        if finish is None:
            # a clean close without any finishReason may hide truncation
            raise ModelAPIError(
                "gemini stream closed without a finishReason "
                "(response may be truncated)"
            )
        if finish in _HARD_FINISH:
            raise ModelAPIError(f"gemini candidate finished {finish}")

        parts: list[Any] = []
        if text_chunks:
            parts.append(TextOutput(text="".join(text_chunks)))
        for i, call in enumerate(calls):
            parts.append(ToolCallOutput(
                tool_call_id=f"{call.get('name', 'tool')}#{i}",
                tool_name=call.get("name", ""),
                args=call.get("args") or {},
            ))
        yield ResponseDone(ModelResponse(
            parts=parts, usage=usage, model_name=model_name,
        ))
