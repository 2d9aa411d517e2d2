"""AWS Bedrock model client over the Converse API (reference: the
vendored pydantic-ai bedrock adapter,
calfkit/_vendor/pydantic_ai/models/bedrock.py — there a botocore wrapper;
here the same ModelClient seam with no AWS SDK at all: a stdlib SigV4
signer, the Converse request/response mapping, and a binary
``application/vnd.amazon.eventstream`` decoder for ConverseStream).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import os
import struct
import urllib.parse
import zlib
from typing import Any, AsyncIterator

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
from calfkit_tpu_torch.providers.http import ModelAPIError, content_str


# ------------------------------------------------------------------ sigv4
def sigv4_headers(
    *,
    method: str,
    url: str,
    region: str,
    service: str,
    access_key: str,
    secret_key: str,
    session_token: str | None = None,
    payload: bytes = b"",
    now: "datetime.datetime | None" = None,
    extra_headers: "dict[str, str] | None" = None,
) -> dict[str, str]:
    """AWS Signature Version 4 over stdlib hmac/hashlib.

    Returns the headers to attach (Authorization, X-Amz-Date, Host, and
    X-Amz-Security-Token when a session token is given).  ``now`` is
    injectable so the signer can be pinned against the published AWS
    test vectors."""
    parsed = urllib.parse.urlsplit(url)
    host = parsed.netloc
    path = parsed.path or "/"
    when = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = when.strftime("%Y%m%dT%H%M%SZ")
    datestamp = when.strftime("%Y%m%d")

    headers = {"host": host, "x-amz-date": amz_date}
    for name, value in (extra_headers or {}).items():
        headers[name.lower()] = value
    if session_token:
        headers["x-amz-security-token"] = session_token
    signed_names = sorted(headers)
    canonical_headers = "".join(
        f"{n}:{headers[n].strip()}\n" for n in signed_names
    )
    signed_headers = ";".join(signed_names)

    query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(urllib.parse.parse_qsl(
            parsed.query, keep_blank_values=True
        ))
    )
    payload_hash = hashlib.sha256(payload).hexdigest()
    canonical = "\n".join([
        method, urllib.parse.quote(path, safe="/-_.~"), query,
        canonical_headers, signed_headers, payload_hash,
    ])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest(),
    ])

    def _hmac(key: bytes, message: str) -> bytes:
        return hmac.new(key, message.encode(), hashlib.sha256).digest()

    key = _hmac(("AWS4" + secret_key).encode(), datestamp)
    key = _hmac(key, region)
    key = _hmac(key, service)
    key = _hmac(key, "aws4_request")
    signature = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()

    out = {
        "Host": host,
        "X-Amz-Date": amz_date,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        ),
    }
    for name, value in (extra_headers or {}).items():
        out[name] = value
    if session_token:
        out["X-Amz-Security-Token"] = session_token
    return out


# ------------------------------------------------- eventstream (binary)
def decode_event_frames(buffer: bytearray) -> "list[tuple[dict, bytes]]":
    """Consume complete ``application/vnd.amazon.eventstream`` frames from
    ``buffer`` (mutated in place) → [(headers, payload)].

    Frame: u32 total_len | u32 headers_len | u32 prelude_crc |
    headers | payload | u32 message_crc — CRCs are zlib crc32 and are
    VERIFIED (a corrupt frame raises ModelAPIError rather than
    mis-parsing the stream)."""
    out: list[tuple[dict, bytes]] = []
    while len(buffer) >= 16:
        total_len, headers_len, prelude_crc = struct.unpack_from(
            ">III", buffer, 0
        )
        if zlib.crc32(bytes(buffer[:8])) != prelude_crc:
            raise ModelAPIError("bedrock eventstream prelude crc mismatch")
        if total_len < 16 or total_len > (16 << 20):
            raise ModelAPIError(
                f"bedrock eventstream frame length {total_len} implausible"
            )
        if len(buffer) < total_len:
            break
        frame = bytes(buffer[:total_len])
        (message_crc,) = struct.unpack_from(">I", frame, total_len - 4)
        if zlib.crc32(frame[:-4]) != message_crc:
            raise ModelAPIError("bedrock eventstream message crc mismatch")
        headers: dict[str, Any] = {}
        pos = 12
        end = 12 + headers_len
        while pos < end:
            name_len = frame[pos]
            pos += 1
            name = frame[pos:pos + name_len].decode("utf-8", "replace")
            pos += name_len
            value_type = frame[pos]
            pos += 1
            if value_type == 7:  # string
                (vlen,) = struct.unpack_from(">H", frame, pos)
                pos += 2
                headers[name] = frame[pos:pos + vlen].decode("utf-8", "replace")
                pos += vlen
            elif value_type == 6:  # byte array
                (vlen,) = struct.unpack_from(">H", frame, pos)
                pos += 2
                headers[name] = frame[pos:pos + vlen]
                pos += vlen
            elif value_type in (0, 1):  # bool true/false
                headers[name] = value_type == 0
            elif value_type == 2:
                headers[name] = frame[pos]
                pos += 1
            elif value_type == 3:
                (headers[name],) = struct.unpack_from(">h", frame, pos)
                pos += 2
            elif value_type == 4:
                (headers[name],) = struct.unpack_from(">i", frame, pos)
                pos += 4
            elif value_type in (5, 8):  # i64 / timestamp
                (headers[name],) = struct.unpack_from(">q", frame, pos)
                pos += 8
            elif value_type == 9:  # uuid
                headers[name] = frame[pos:pos + 16]
                pos += 16
            else:
                raise ModelAPIError(
                    f"bedrock eventstream unknown header type {value_type}"
                )
        out.append((headers, frame[end:total_len - 4]))
        del buffer[:total_len]
    return out


# ------------------------------------------------------ converse mapping
def render_converse(messages: list[ModelMessage]) -> tuple[list, list]:
    """Our wire vocabulary → Converse ``(system, messages)``.  Converse
    requires strictly alternating user/assistant turns, so adjacent
    same-role entries are merged."""
    system: list[dict] = []
    turns: list[dict] = []

    def push(role: str, blocks: list[dict]) -> None:
        if turns and turns[-1]["role"] == role:
            turns[-1]["content"].extend(blocks)
        else:
            turns.append({"role": role, "content": list(blocks)})

    for message in messages:
        if isinstance(message, ModelResponse):
            blocks: list[dict] = []
            text = message.text()
            if text:
                blocks.append({"text": text})
            for call in message.tool_calls():
                args = call.args
                if isinstance(args, str):
                    try:
                        args = json.loads(args or "{}")
                    except ValueError:
                        args = {"raw": args}
                blocks.append({"toolUse": {
                    "toolUseId": call.tool_call_id,
                    "name": call.tool_name,
                    "input": args,
                }})
            push("assistant", blocks)
            continue
        assert isinstance(message, ModelRequest)
        if message.instructions:
            system.append({"text": message.instructions})
        for part in message.parts:
            if isinstance(part, SystemPart):
                system.append({"text": part.content})
            elif isinstance(part, UserPart):
                push("user", [{"text": content_str(part.content)}])
            elif isinstance(part, ToolReturnPart):
                push("user", [{"toolResult": {
                    "toolUseId": part.tool_call_id,
                    "content": [{"text": content_str(part.content)}],
                    "status": "success",
                }}])
            elif isinstance(part, RetryPart):
                if part.tool_call_id:
                    push("user", [{"toolResult": {
                        "toolUseId": part.tool_call_id,
                        "content": [{"text": part.content}],
                        "status": "error",
                    }}])
                else:
                    push("user", [{"text": part.content}])
    return system, turns


def parse_converse(data: dict, model: str) -> ModelResponse:
    try:
        content = data["output"]["message"]["content"]
    except (KeyError, TypeError) as exc:
        raise ModelAPIError(
            f"bedrock response missing output.message: {data!r}"[:500]
        ) from exc
    parts: list[Any] = []
    for block in content:
        if "text" in block:
            parts.append(TextOutput(text=block["text"]))
        elif "toolUse" in block:
            use = block["toolUse"]
            parts.append(ToolCallOutput(
                tool_call_id=use.get("toolUseId", ""),
                tool_name=use.get("name", ""),
                args=json.dumps(use.get("input") or {}),
            ))
    usage = data.get("usage") or {}
    return ModelResponse(
        parts=parts,
        usage=Usage(
            input_tokens=usage.get("inputTokens", 0),
            output_tokens=usage.get("outputTokens", 0),
        ),
        model_name=model,
    )


class BedrockModelClient(ModelClient):
    """Converse / ConverseStream over the port's HTTP client with stdlib SigV4 — no
    botocore.  Credentials default to the standard AWS env vars."""

    def __init__(
        self,
        model: str,
        *,
        region: str | None = None,
        access_key: str | None = None,
        secret_key: str | None = None,
        session_token: str | None = None,
        base_url: str | None = None,
        http_client: Any | None = None,
    ):
        self._model = model
        self._region = region or os.environ.get("AWS_REGION", "us-east-1")
        self._access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self._secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", ""
        )
        self._session_token = session_token or os.environ.get(
            "AWS_SESSION_TOKEN"
        ) or None
        self._base_url = (base_url or (
            f"https://bedrock-runtime.{self._region}.amazonaws.com"
        )).rstrip("/")
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
        system, turns = render_converse(messages)
        payload: dict[str, Any] = {"messages": turns}
        if system:
            payload["system"] = system
        config: dict[str, Any] = {}
        if settings.max_tokens is not None:
            config["maxTokens"] = settings.max_tokens
        if settings.temperature is not None:
            config["temperature"] = settings.temperature
        if settings.top_p is not None:
            config["topP"] = settings.top_p
        if settings.stop_sequences:
            config["stopSequences"] = settings.stop_sequences
        if config:
            payload["inferenceConfig"] = config
        tools = [
            {"toolSpec": {
                "name": t.name,
                "description": t.description or t.name,
                "inputSchema": {"json": t.parameters_schema},
            }}
            for t in params.all_tools()
        ]
        if tools:
            payload["toolConfig"] = {
                "tools": tools,
                "toolChoice": (
                    {"auto": {}} if params.allow_text_output else {"any": {}}
                ),
            }
        payload.update(settings.extra)
        return payload

    def _signed(self, url: str, body: bytes) -> dict[str, str]:
        return sigv4_headers(
            method="POST", url=url, region=self._region, service="bedrock",
            access_key=self._access_key, secret_key=self._secret_key,
            session_token=self._session_token, payload=body,
            extra_headers={"content-type": "application/json"},
        )

    def _url(self, verb: str) -> str:
        model = urllib.parse.quote(self._model, safe="")
        return f"{self._base_url}/model/{model}/{verb}"

    async def request(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> ModelResponse:
        settings = settings or ModelSettings()
        params = params or ModelRequestParameters()
        body = json.dumps(
            self._build_payload(messages, settings, params)
        ).encode()
        url = self._url("converse")
        response = await self._http().post(
            url, content=body, headers=self._signed(url, body)
        )
        if response.status_code >= 400:
            raise ModelAPIError(
                f"bedrock converse {response.status_code}: "
                f"{response.text[:300]}",
                status=response.status_code, body=response.text,
            )
        return parse_converse(response.json(), self._model)

    async def request_stream(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> "AsyncIterator[Any]":
        """ConverseStream: binary eventstream → TextDelta per text delta,
        toolUse blocks accumulated per contentBlockIndex, one
        ResponseDone after messageStop."""
        settings = settings or ModelSettings()
        params = params or ModelRequestParameters()
        body = json.dumps(
            self._build_payload(messages, settings, params)
        ).encode()
        url = self._url("converse-stream")

        text_chunks: list[str] = []
        tools: dict[int, dict] = {}
        usage = Usage()
        stopped = False
        buffer = bytearray()
        async with self._http().stream(
            "POST", url, content=body, headers=self._signed(url, body)
        ) as response:
            if response.status_code >= 400:
                raw = await response.aread()
                raise ModelAPIError(
                    f"bedrock converse-stream {response.status_code}: "
                    f"{raw[:300]!r}",
                    status=response.status_code,
                    body=raw.decode("utf-8", "replace"),
                )
            async for chunk in response.aiter_bytes():
                buffer.extend(chunk)
                for headers, payload in decode_event_frames(buffer):
                    if headers.get(":message-type") == "exception":
                        raise ModelAPIError(
                            f"bedrock mid-stream exception "
                            f"{headers.get(':exception-type')}: "
                            f"{payload[:300]!r}"
                        )
                    event_type = headers.get(":event-type", "")
                    try:
                        event = json.loads(payload) if payload else {}
                    except ValueError:
                        continue
                    if event_type == "contentBlockStart":
                        start = (event.get("start") or {}).get("toolUse")
                        if start:
                            tools[event.get("contentBlockIndex", 0)] = {
                                "id": start.get("toolUseId", ""),
                                "name": start.get("name", ""),
                                "input": "",
                            }
                    elif event_type == "contentBlockDelta":
                        delta = event.get("delta") or {}
                        if "text" in delta:
                            text_chunks.append(delta["text"])
                            yield TextDelta(delta["text"])
                        elif "toolUse" in delta:
                            index = event.get("contentBlockIndex", 0)
                            slot = tools.setdefault(
                                index, {"id": "", "name": "", "input": ""}
                            )
                            slot["input"] += delta["toolUse"].get("input", "")
                    elif event_type == "messageStop":
                        stopped = True
                    elif event_type == "metadata" and event.get("usage"):
                        usage = Usage(
                            input_tokens=event["usage"].get("inputTokens", 0),
                            output_tokens=event["usage"].get("outputTokens", 0),
                        )
        if not stopped:
            raise ModelAPIError(
                "bedrock stream closed without messageStop "
                "(response may be truncated)"
            )
        parts: list[Any] = []
        if text_chunks:
            parts.append(TextOutput(text="".join(text_chunks)))
        for index in sorted(tools):
            slot = tools[index]
            parts.append(ToolCallOutput(
                tool_call_id=slot["id"], tool_name=slot["name"],
                args=slot["input"] or "{}",
            ))
        yield ResponseDone(ModelResponse(
            parts=parts, usage=usage, model_name=self._model,
        ))
