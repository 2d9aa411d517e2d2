"""The remote model providers of the JAX package, held against the port's
``calfkit_tpu_torch.providers`` on the port's own HTTP client
(``calfkit_tpu_torch._http``).

**The reference suites, rebound.**  The 75 cases of
``tests/test_providers.py`` (51), ``tests/test_providers_aws_mistral.py``
(15) and ``tests/test_fallback_model.py`` (9) run unchanged against the
port, each suite rebound by ``tests/_torch_rebind.py`` with ``httpx``
blocked: the suite's ``httpx.AsyncClient``, ``MockTransport``, ``Request``
and ``Response`` are the port's, and its module-scope messages and tool
definitions are rebuilt as the port's types.

**Parity with the JAX package.**  For each of the seven clients one
scripted handler answers both packages, the JAX client over
``httpx.MockTransport``, the port's over its own ``MockTransport``.  Equal:
every request's method, URL, headers (all but the three httpx adds and the
port does not: ``accept-encoding``, ``user-agent``, ``connection``) and body
bytes; ``request()``'s response; ``request_stream()``'s events; the
``ModelAPIError`` (its status, structured code and message, body, text) of
a 429, 500, 503, 529 and a ``context_length_exceeded`` answer; Bedrock's
SigV4 headers with the clock frozen, byte for byte; and Bedrock's events
for a recorded eventstream split at every byte offset.

**The HTTP client over a real loopback socket.**  An asyncio server in the
test: the first SSE line reaches the caller while the server holds the
rest back (both packages' streams equal); ``Content-Length``, ``chunked``
and read-to-close bodies, read whole and by lines, equal httpx's reading of
the same bytes; a refused connection, a server that closes mid-body and a
read past the timeout each raise the port's ``HTTPError``, and
``ModelAPIError`` through ``post_json`` and ``sse_lines``, as httpx's
errors do in the reference; a stream longer than the timeout whose every
gap is shorter is not cut; ``https://`` builds its TLS context with
``ssl.create_default_context()``.

**Fallback over the local engines, in f32.**  On ``tests/_torch_port.py``'s
weights: a remote answering 503 in front of ``TorchLocalModelClient`` and
of ``JaxLocalModelClient`` gives equal greedy answers and streams; a
prompt longer than the local engine's ``max_seq_len`` rolls over to a
scripted remote in both; a remote that fails after its first event
propagates the failure in both, and the local engine is never asked.
"""

from __future__ import annotations

import asyncio
import contextlib
import datetime
import importlib
import inspect
import json
import ssl
import sys
import types

import httpx
import numpy as np
import pytest

from calfkit_tpu import providers as JP
from calfkit_tpu.engine import model_client as JMC
from calfkit_tpu.exceptions import InferenceError as JaxInferenceError
from calfkit_tpu.models import capability as JCap
from calfkit_tpu.models import messages as JM
from calfkit_tpu.models import payload as JPay
from calfkit_tpu.providers import bedrock as JB
from calfkit_tpu.providers import http as JH
from calfkit_tpu_torch import _http
from calfkit_tpu_torch import providers as P
from calfkit_tpu_torch.exceptions import InferenceError
from calfkit_tpu_torch.providers import bedrock as PB
from calfkit_tpu_torch.providers import http as PH
from tests._torch_port import to_port
from tests._torch_rebind import port_data, ported_module
from tests.test_providers_aws_mistral import encode_event_frame

# --------------------------------------------------------------------------- #
# the reference suites, rebound
# --------------------------------------------------------------------------- #

# contract module -> {suite class: cases rebound}
SUITES = {
    "tests.test_providers": {
        "TestOpenAI": 4, "TestAnthropic": 3, "TestProviderThroughAgent": 2,
        "TestModelFaultTyping": 2, "TestStreaming": 4, "TestStreamMidFailure": 2,
        "TestAdviceRound2Fixes": 8, "TestAdviceRound3Fixes": 3, "TestOpenAIResponses": 13,
        "TestGemini": 8, "TestGeminiParallelCallIdentity": 2,
    },
    "tests.test_providers_aws_mistral": {
        "TestSigV4": 2, "TestEventStreamCodec": 3, "TestBedrockConverse": 8, "TestMistral": 2,
    },
    "tests.test_fallback_model": {
        "TestRequestFallback": 5, "TestStreamFallback": 3, "TestAgentIntegration": 1,
    },
}
# a suite's module-scope data, rebuilt as the port's types
SUITE_DATA = {
    "tests.test_providers": ("TOOL", "HISTORY"),
    "tests.test_providers_aws_mistral": ("TOOL", "HISTORY"),
    "tests.test_fallback_model": ("MSGS",),
}
CASES = [
    (module_name, suite_name, name)
    for module_name, suites in SUITES.items()
    for suite_name in suites
    for name in vars(getattr(importlib.import_module(module_name), suite_name))
    if name.startswith("test_")
]


def _suite(module_name: str) -> dict:
    module = importlib.import_module(module_name)
    return ported_module(module_name, overrides={
        name: port_data(getattr(module, name)) for name in SUITE_DATA[module_name]})


def _run(result, timeout: float = 120) -> None:
    if inspect.isawaitable(result):
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(asyncio.wait_for(result, timeout=timeout))
        finally:
            loop.close()


def test_the_contract_is_the_reference_suites():
    counts: dict = {}
    for module_name, suite_name, _ in CASES:
        counts.setdefault(module_name, {}).setdefault(suite_name, 0)
        counts[module_name][suite_name] += 1
    assert counts == SUITES
    assert len(CASES) == 75
    g = _suite("tests.test_providers")
    assert g["OpenAIModelClient"] is P.OpenAIModelClient
    assert g["httpx"].AsyncClient is _http.HTTPClient
    assert g["httpx"].MockTransport is _http.MockTransport
    assert type(g["HISTORY"][0]) is type(to_port(JM.ModelRequest()))
    assert _suite("tests.test_providers_aws_mistral")["sigv4_headers"] is PB.sigv4_headers
    assert _suite("tests.test_fallback_model")["FallbackModelClient"] is P.FallbackModelClient


@pytest.mark.parametrize("module_name,suite_name,name", CASES,
                         ids=[f"{s}::{n}" for _, s, n in CASES])
def test_reference_case_on_the_port(module_name, suite_name, name, monkeypatch):
    suite = _suite(module_name)[suite_name]
    monkeypatch.setitem(sys.modules, "httpx", None)  # an import of it raises
    _run(getattr(suite(), name)())


# --------------------------------------------------------------------------- #
# parity with the JAX package: one scripted handler answers both
# --------------------------------------------------------------------------- #

TOOL = JCap.ToolDef(name="lookup", description="Look things up.", parameters_schema={
    "type": "object", "properties": {"q": {"type": "string"}}, "required": ["q"]})
OUTPUT = JCap.ToolDef(name="final_result", description="The answer.", parameters_schema={
    "type": "object", "properties": {"answer": {"type": "integer"}}})
HISTORY = [
    JM.ModelRequest(parts=[JM.SystemPart(content="you are terse"),
                           JM.UserPart(content="find the answer, é ✓")],
                    instructions="be brief"),
    JM.ModelResponse(parts=[
        JM.TextOutput(text="checking"),
        JM.ToolCallOutput(tool_call_id="c1", tool_name="lookup", args={"q": "answer"}),
        JM.ToolCallOutput(tool_call_id="c2", tool_name="lookup", args='{"q": "x"}'),
    ]),
    JM.ModelRequest(parts=[
        JM.ToolReturnPart(tool_call_id="c1", tool_name="lookup", content={"value": 42}),
        JM.RetryPart(content="q must be a word", tool_call_id="c2", tool_name="lookup"),
    ]),
    JM.ModelRequest(parts=[
        JM.UserPart(content=[JPay.TextPart(text="and now?"), JPay.DataPart(data={"k": [1, 2]})]),
        JM.RetryPart(content="answer with the tool"),
    ]),
]
VARIANTS = [
    (JMC.ModelSettings(), JMC.ModelRequestParameters()),
    (JMC.ModelSettings(temperature=0.2, max_tokens=99, top_p=0.9, top_k=40, seed=7,
                       stop_sequences=["END"], extra={"user": "u-1"}),
     JMC.ModelRequestParameters(tool_defs=[TOOL], output_tool=OUTPUT, allow_text_output=False)),
]
CLIENTS = ("openai", "mistral", "openai_responses", "anthropic", "gemini", "bedrock", "fallback")
FROZEN = datetime.datetime(2026, 3, 4, 5, 6, 7, tzinfo=datetime.timezone.utc)


def _sse(*events, crlf: bool = False) -> bytes:
    nl = "\r\n" if crlf else "\n"
    return "".join(
        (e if e.startswith((":", "event:")) else f"data: {e}") + nl + nl for e in events
    ).encode()


def _frame(event_type: str, payload: dict, message_type: str = "event") -> bytes:
    return encode_event_frame({":event-type": event_type, ":message-type": message_type,
                               ":content-type": "application/json"},
                              json.dumps(payload).encode())


OPENAI_JSON = {
    "model": "gpt-test-001",
    "choices": [{"message": {"content": "the answer is 42", "tool_calls": [
        {"id": "t1", "type": "function", "function": {"name": "lookup",
                                                      "arguments": "{\"q\": \"y\"}"}}]}}],
    "usage": {"prompt_tokens": 30, "completion_tokens": 6},
}
OPENAI_SSE = _sse(
    '{"model":"gpt-s","choices":[{"delta":{"content":"Hel"}}]}',
    '{"choices":[{"delta":{"content":"lo é"}}]}',
    ': keep-alive',
    '{"choices":[{"delta":{"tool_calls":[{"index":0,"id":"c9","function":{"name":"look",'
    '"arguments":"{\\"q\\""}}]}}]}',
    '{"choices":[{"delta":{"tool_calls":[{"index":0,"function":{"name":"up",'
    '"arguments":": 1}"}}]}}]}',
    '{"choices":[{"delta":{"tool_calls":[{"id":"c10","function":{"name":"other",'
    '"arguments":"{}"}}]}}]}',
    'not json',
    '{"choices":[{"finish_reason":"stop","delta":{}}],'
    '"usage":{"prompt_tokens":5,"completion_tokens":2}}',
    '[DONE]', crlf=True,
)
RESPONSES_JSON = {
    "model": "gpt-r", "status": "completed",
    "output": [{"type": "message", "content": [{"type": "output_text", "text": "resp text"}]},
               {"type": "reasoning", "summary": []},
               {"type": "function_call", "call_id": "fc1", "name": "lookup",
                "arguments": "{\"q\":1}"}],
    "usage": {"input_tokens": 3, "output_tokens": 4},
}
RESPONSES_SSE = _sse(
    'event: response.output_text.delta',
    json.dumps({"type": "response.output_text.delta", "delta": "resp "}),
    json.dumps({"type": "response.output_text.delta", "delta": "text"}),
    json.dumps({"type": "response.completed", "response": RESPONSES_JSON}),
)
ANTHROPIC_JSON = {
    "model": "claude-x",
    "content": [{"type": "text", "text": "hi there"},
                {"type": "tool_use", "id": "tu1", "name": "lookup", "input": {"q": "z"}}],
    "usage": {"input_tokens": 7, "output_tokens": 8},
}
ANTHROPIC_SSE = _sse(
    "event: message_start",
    json.dumps({"type": "message_start",
                "message": {"model": "claude-s", "usage": {"input_tokens": 9}}}),
    json.dumps({"type": "content_block_start", "index": 0,
                "content_block": {"type": "text", "text": ""}}),
    json.dumps({"type": "content_block_delta", "index": 0,
                "delta": {"type": "text_delta", "text": "Hel"}}),
    json.dumps({"type": "ping"}),
    json.dumps({"type": "content_block_delta", "index": 0,
                "delta": {"type": "text_delta", "text": "lo"}}),
    json.dumps({"type": "content_block_start", "index": 1,
                "content_block": {"type": "tool_use", "id": "tu2", "name": "lookup"}}),
    json.dumps({"type": "content_block_delta", "index": 1,
                "delta": {"type": "input_json_delta", "partial_json": "{\"q\":"}}),
    json.dumps({"type": "content_block_delta", "index": 1,
                "delta": {"type": "input_json_delta", "partial_json": "\"w\"}"}}),
    json.dumps({"type": "message_delta", "usage": {"output_tokens": 12}}),
    json.dumps({"type": "message_stop"}),
)
GEMINI_JSON = {
    "candidates": [{"content": {"parts": [{"text": "gem"}, {"functionCall": {
        "name": "lookup", "args": {"q": "g"}}}]}, "finishReason": "STOP"}],
    "usageMetadata": {"promptTokenCount": 3, "candidatesTokenCount": 2},
    "modelVersion": "gemini-v",
}
GEMINI_SSE = _sse(
    json.dumps({"candidates": [{"content": {"parts": [{"text": "Ge"}]}}]}),
    json.dumps({"candidates": [{"content": {"parts": [{"text": "mini"}]}}],
                "modelVersion": "gemini-s"}),
    json.dumps({"candidates": [{"content": {"parts": [
        {"functionCall": {"name": "lookup", "args": {"q": "a"}}},
        {"functionCall": {"name": "lookup", "args": {"q": "b"}}}]}, "finishReason": "STOP"}],
        "usageMetadata": {"promptTokenCount": 4, "candidatesTokenCount": 5}}),
    crlf=True,
)
BEDROCK_JSON = {
    "output": {"message": {"role": "assistant", "content": [
        {"text": "bed"}, {"toolUse": {"toolUseId": "b1", "name": "lookup", "input": {"q": "b"}}}]}},
    "stopReason": "tool_use", "usage": {"inputTokens": 4, "outputTokens": 5},
}
BEDROCK_STREAM = b"".join([
    _frame("messageStart", {"role": "assistant"}),
    _frame("contentBlockDelta", {"contentBlockIndex": 0, "delta": {"text": "Bed"}}),
    _frame("contentBlockDelta", {"contentBlockIndex": 0, "delta": {"text": "rock é"}}),
    _frame("contentBlockStop", {"contentBlockIndex": 0}),
    _frame("contentBlockStart", {"contentBlockIndex": 1, "start": {
        "toolUse": {"toolUseId": "bt1", "name": "lookup"}}}),
    _frame("contentBlockDelta", {"contentBlockIndex": 1, "delta": {"toolUse": {"input": "{\"q\""}}}),
    _frame("contentBlockDelta", {"contentBlockIndex": 1, "delta": {"toolUse": {"input": ":\"b\"}"}}}),
    _frame("contentBlockStop", {"contentBlockIndex": 1}),
    _frame("messageStop", {"stopReason": "tool_use"}),
    _frame("metadata", {"usage": {"inputTokens": 3, "outputTokens": 9}}),
])


def _answer(method: str, url: str, body: bytes) -> "tuple[int, dict, bytes]":
    """The scripted remote: every client's endpoint, plain and streamed; a
    host named ``down.example`` answers 503."""
    payload = json.loads(body) if body else {}
    streamed = payload.get("stream") or "stream" in url.rsplit("/", 1)[-1]
    if "down.example" in url:
        return 503, {"content-type": "text/plain"}, b"overloaded"
    if "converse" in url:
        if streamed:
            return 200, {"content-type": "application/vnd.amazon.eventstream"}, BEDROCK_STREAM
        return 200, {"content-type": "application/json"}, json.dumps(BEDROCK_JSON).encode()
    for path, plain, stream in (("/chat/completions", OPENAI_JSON, OPENAI_SSE),
                                ("/responses", RESPONSES_JSON, RESPONSES_SSE),
                                ("/v1/messages", ANTHROPIC_JSON, ANTHROPIC_SSE),
                                ("Content", GEMINI_JSON, GEMINI_SSE)):
        if path in url:
            if streamed:
                return 200, {"content-type": "text/event-stream"}, stream
            return 200, {"content-type": "application/json"}, json.dumps(plain).encode()
    return 404, {}, b"no such endpoint"


# headers httpx adds and the port does not (the port asks for no compression
# and closes each connection): every other header is compared
TRANSPORT_ONLY = frozenset({"accept-encoding", "user-agent", "connection"})


def _seen(request) -> tuple:
    headers = {k.lower(): v for k, v in request.headers.items()
               if k.lower() not in TRANSPORT_ONLY}
    return request.method, str(request.url), headers, bytes(request.content)


def _ref_http(answer, seen: list) -> httpx.AsyncClient:
    def handler(request: httpx.Request) -> httpx.Response:
        seen.append(_seen(request))
        status, headers, content = answer(request.method, str(request.url), request.content)
        return httpx.Response(status, headers=headers, content=content)

    return httpx.AsyncClient(transport=httpx.MockTransport(handler))


def _port_http(answer, seen: list) -> _http.HTTPClient:
    def handler(request: _http.Request) -> _http.Response:
        seen.append(_seen(request))
        status, headers, content = answer(request.method, request.url, request.content)
        return _http.Response(status, headers=headers, content=content)

    return _http.HTTPClient(transport=_http.MockTransport(handler))


def _client(pkg, name: str, http_client):
    """Client ``name`` of package ``pkg`` (``JP`` or ``P``) over ``http_client``."""
    if name == "fallback":
        return pkg.FallbackModelClient(
            pkg.OpenAIModelClient("gpt-test", api_key="k", base_url="https://down.example/v1",
                                  http_client=http_client),
            pkg.AnthropicModelClient("claude-test", api_key="ak", http_client=http_client),
        )
    if name == "bedrock":
        return pkg.BedrockModelClient("anthropic.claude-test:0", region="eu-west-1",
                                      access_key="AKIDEXAMPLE", secret_key="secret/key+",
                                      session_token="TOKEN", http_client=http_client)
    cls = {"openai": "OpenAIModelClient", "mistral": "MistralModelClient",
           "openai_responses": "OpenAIResponsesModelClient",
           "anthropic": "AnthropicModelClient", "gemini": "GeminiModelClient"}[name]
    kwargs = {"reasoning_effort": "low"} if name == "openai_responses" else {}
    return getattr(pkg, cls)("model-test", api_key="key-1", http_client=http_client, **kwargs)


class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return FROZEN


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages' Bedrock signers read one fixed instant."""
    clock = types.SimpleNamespace(datetime=_Frozen, timezone=datetime.timezone)
    monkeypatch.setattr(JB, "datetime", clock)
    monkeypatch.setattr(PB, "datetime", clock)


def _dump(x):
    """A stream event, a response or a list of them as plain data."""
    if isinstance(x, list):
        return [_dump(e) for e in x]
    kind = type(x).__name__
    if kind == "TextDelta":
        return kind, x.text
    if kind == "ResumeOffset":
        return kind, x.chars
    if kind == "ResponseDone":
        return kind, _dump(x.response)
    return kind, x.model_dump(mode="json")


def _error(exc: BaseException) -> tuple:
    return (type(exc).__name__, getattr(exc, "status", None), getattr(exc, "error_code", None),
            getattr(exc, "error_message", None), getattr(exc, "body", None), str(exc))


async def _outcome(call) -> tuple:
    """``call()``'s result (a response or a stream's events), or its error."""
    events: list = []
    try:
        result = call()
        if inspect.isawaitable(result):
            return "result", _dump(await result)
        async for event in result:
            events.append(event)
        return "events", _dump(events)
    except Exception as exc:  # noqa: BLE001 - compared below
        return "raised", _dump(events), _error(exc)


@pytest.mark.parametrize("name", CLIENTS)
async def test_requests_responses_and_streams_equal_the_reference(name, frozen_clock):
    ref_seen, port_seen = [], []
    ref = _client(JP, name, _ref_http(_answer, ref_seen))
    port = _client(P, name, _port_http(_answer, port_seen))
    for settings, params in VARIANTS:
        args = (HISTORY, settings, params)
        port_args = (to_port(HISTORY), to_port(settings), to_port(params))
        for method in ("request", "request_stream"):
            want = await _outcome(lambda: getattr(ref, method)(*args))
            got = await _outcome(lambda: getattr(port, method)(*port_args))
            assert want[0] in ("result", "events"), want
            assert got == want, (method, settings)
    assert len(port_seen) == len(ref_seen) == 4 * (2 if name == "fallback" else 1)
    for got, want in zip(port_seen, ref_seen):
        assert got[:2] == want[:2]
        assert got[2] == want[2], (got[1], set(got[2].items()) ^ set(want[2].items()))
        assert got[3] == want[3]  # the body, byte for byte
    if name == "bedrock":
        assert all(s[2]["authorization"].startswith("AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/"
                                                    "20260304/eu-west-1/bedrock/aws4_request")
                   for s in port_seen)


ERRORS = [
    (429, {"content-type": "text/plain"}, b"rate limited"),
    (500, {"content-type": "application/json"},
     json.dumps({"error": {"message": "boom", "type": "server_error", "code": 500}}).encode()),
    (503, {}, b"down"),
    (529, {"content-type": "application/json"},
     json.dumps({"type": "error", "error": {"type": "overloaded_error",
                                            "message": "Overloaded"}}).encode()),
    (400, {"content-type": "application/json"},
     json.dumps({"error": {"code": "context_length_exceeded", "type": "invalid_request_error",
                           "message": "This model's maximum context length is 8192 tokens"}}
                ).encode()),
]


@pytest.mark.parametrize("name", CLIENTS)
async def test_api_errors_equal_the_reference(name, frozen_clock):
    for status, headers, body in ERRORS:
        def answer(method, url, content, _a=(status, headers, body)):
            return _a

        ref = _client(JP, name, _ref_http(answer, []))
        port = _client(P, name, _port_http(answer, []))
        for method in ("request", "request_stream"):
            want = await _outcome(lambda: getattr(ref, method)([HISTORY[0]]))
            got = await _outcome(lambda: getattr(port, method)([to_port(HISTORY[0])]))
            assert want[0] == "raised" and want[2][1] in (status, None), want
            assert got == want, (status, method)
        if name != "fallback":
            assert want[2][:2] == ("ModelAPIError", status)
            if status == 400:
                assert want[2][2] == "context_length_exceeded"


def test_sigv4_headers_equal_the_reference():
    cases = [
        dict(method="GET", url="https://iam.amazonaws.com/?Action=ListUsers&Version=2010-05-08",
             region="us-east-1", service="iam", access_key="AKIDEXAMPLE",
             secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
             extra_headers={"content-type": "application/x-www-form-urlencoded; charset=utf-8"}),
        dict(method="POST", url="https://bedrock-runtime.eu-west-1.amazonaws.com/model/"
             "anthropic.claude%3A0/converse-stream?b=2&a=1&a=0", region="eu-west-1",
             service="bedrock", access_key="AK", secret_key="SK", session_token="TOKEN",
             payload="{\"é\": 1}".encode(), extra_headers={"Content-Type": "application/json"}),
        dict(method="POST", url="http://127.0.0.1:8080/x y", region="r", service="s",
             access_key="a", secret_key="b", payload=b""),
    ]
    for case in cases:
        want = JB.sigv4_headers(now=FROZEN, **case)
        assert PB.sigv4_headers(now=FROZEN, **case) == want
        assert list(PB.sigv4_headers(now=FROZEN, **case)) == list(want)


async def test_bedrock_eventstream_split_at_every_offset_equals_the_reference():
    chunks: list = []

    def answer(method, url, content):
        async def body():
            for chunk in chunks:
                await asyncio.sleep(0)
                yield chunk

        return 200, {"content-type": "application/vnd.amazon.eventstream"}, body()

    ref = _client(JP, "bedrock", _ref_http(answer, []))
    port = _client(P, "bedrock", _port_http(answer, []))
    whole = BEDROCK_STREAM
    rng = np.random.default_rng(0)
    splits = [[cut] for cut in range(len(whole) + 1)] + [
        sorted(rng.integers(0, len(whole) + 1, int(rng.integers(2, 40))).tolist())
        for _ in range(40)]
    want_whole = None
    for cuts in splits:
        bounds = [0, *cuts, len(whole)]
        chunks[:] = [whole[a:b] for a, b in zip(bounds, bounds[1:])]
        want = await _outcome(lambda: ref.request_stream([HISTORY[0]]))
        got = await _outcome(lambda: port.request_stream([to_port(HISTORY[0])]))
        assert got == want, cuts
        want_whole = want_whole or want
        assert want == want_whole  # the split never shows
    assert want_whole[0] == "events" and want_whole[1][-1][1][1]["parts"][1]["tool_call_id"] == "bt1"
    # a corrupt frame anywhere in the stream fails alike
    for at in (5, 20, len(whole) // 2, len(whole) - 1):
        chunks[:] = [whole[:at] + bytes([whole[at] ^ 0x40]) + whole[at + 1:]]
        want = await _outcome(lambda: ref.request_stream([HISTORY[0]]))
        assert want[0] == "raised" and "crc mismatch" in want[2][-1]
        assert await _outcome(lambda: port.request_stream([to_port(HISTORY[0])])) == want


# --------------------------------------------------------------------------- #
# the port's HTTP client over a real loopback socket
# --------------------------------------------------------------------------- #


class Loopback:
    """A loopback server: ``respond(reader, writer, request_body)`` writes
    each answer; the request's head and body are read first."""

    def __init__(self, respond):
        self.respond = respond
        self.requests: list = []
        self._tasks: set = set()

    async def _handle(self, reader, writer):
        self._tasks.add(asyncio.current_task())
        try:
            head = []
            while line := (await reader.readline()).decode("latin-1").rstrip("\r\n"):
                head.append(line)
            length = next((int(h.split(":", 1)[1]) for h in head
                           if h.lower().startswith("content-length:")), 0)
            body = await reader.readexactly(length)
            self.requests.append((head, body))
            await self.respond(reader, writer, body)
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()

    async def __aenter__(self):
        self.server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.server.sockets[0].getsockname()[1]}"
        return self

    async def __aexit__(self, *exc):
        for task in self._tasks:
            task.cancel()
        self.server.close()
        await self.server.wait_closed()


def _chunk(data: bytes) -> bytes:
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"


STREAM_HEAD = (b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
               b"Transfer-Encoding: chunked\r\n\r\n")


async def test_first_sse_line_reaches_the_caller_before_the_rest():
    events = OPENAI_SSE.split(b"\r\n\r\n")[:-1]
    released = asyncio.Event()

    async def respond(reader, writer, body):
        writer.write(STREAM_HEAD + _chunk(events[0] + b"\r\n\r\n"))
        await writer.drain()
        await released.wait()  # the rest only once the caller holds the first delta
        for event in events[1:]:
            writer.write(_chunk(event + b"\r\n\r\n"))
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    async def first_then_rest(client, user) -> list:
        released.clear()
        got = []
        async for event in client.request_stream([user("hi")]):
            if not got:
                assert not released.is_set()
                assert type(event).__name__ == "TextDelta" and event.text == "Hel"
                released.set()
            got.append(event)
        await client.aclose()
        return got

    async with Loopback(respond) as server:
        port = await asyncio.wait_for(first_then_rest(
            P.OpenAIModelClient("m", api_key="k", base_url=server.url), to_port_user), 10)
        ref = await asyncio.wait_for(first_then_rest(
            JP.OpenAIModelClient("m", api_key="k", base_url=server.url), JM.user_message), 10)
    assert _dump(port) == _dump(ref) and len(port) == 3
    (port_head, port_body), (ref_head, ref_body) = server.requests
    assert port_head[0] == ref_head[0] == "POST /chat/completions HTTP/1.1"
    assert port_body == ref_body


def to_port_user(text: str):
    return to_port(JM.user_message(text))


RAW_BODIES = {
    "content-length": b"HTTP/1.1 200 OK\r\nContent-Type: text/plain; charset=latin-1\r\n"
                      b"Connection: close\r\nContent-Length: 20\r\n\r\n"
                      b"line one\r\nline tw\xe9\rXtrailing junk",
    "chunked": b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
               + _chunk(b"data: a\r") + _chunk(b"\ndata: \xc3") + b"3;ext=1\r\n\xa9 b\r\n"
               + _chunk(b"\n\nno end") + b"0\r\nX-Trailer: t\r\n\r\n",
    "read-to-close": b"HTTP/1.0 200 OK\r\n\r\nfirst\nsecond\r\n\r\nlast",
}


@pytest.mark.parametrize("kind", RAW_BODIES)
async def test_bodies_read_whole_and_by_lines_equal_httpx(kind):
    async def respond(reader, writer, body):
        for i in range(0, len(RAW_BODIES[kind]), 7):  # in pieces, as a network gives them
            writer.write(RAW_BODIES[kind][i:i + 7])
            await writer.drain()
            await asyncio.sleep(0.001)

    async with Loopback(respond) as server:
        url = server.url + "/path?q=1"
        async with httpx.AsyncClient() as ref:
            want = await ref.post(url, json={"a": 1})
            async with ref.stream("POST", url, content=b"x") as r:
                want_lines = [line async for line in r.aiter_lines()]
        port = _http.HTTPClient(timeout=5)
        got = await port.post(url, json={"a": 1})
        async with port.stream("POST", url, content=b"x") as r:
            got_lines = [line async for line in r.aiter_lines()]
        async with port.stream("POST", url, content=b"x") as r:
            got_chunks = [chunk async for chunk in r.aiter_bytes()]
    assert (got.status_code, got.content, got.text) == (want.status_code, want.content, want.text)
    assert got_lines == want_lines
    assert b"".join(got_chunks) == want.content and len(got_chunks) > 1  # as they arrived
    assert server.requests[0][0][0] == server.requests[2][0][0] == "POST /path?q=1 HTTP/1.1"


async def test_transport_failures_are_http_errors_then_model_api_errors():
    async def cut_mid_body(reader, writer, body):
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                     b"Content-Length: 400\r\n\r\ndata: {\"choices\": []}\n\n")
        await writer.drain()

    async def stalls(reader, writer, body):
        writer.write(STREAM_HEAD + _chunk(b"data: {\"choices\": []}\n\n"))
        await writer.drain()
        await asyncio.sleep(3)

    refused = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
    refused_url = f"http://127.0.0.1:{refused.sockets[0].getsockname()[1]}"
    refused.close()
    await refused.wait_closed()

    async def failures(url: str, timeout: float) -> list:
        client = _http.HTTPClient(timeout=timeout)
        out = []
        with pytest.raises(_http.HTTPError) as info:
            await client.post(url, json={})
        out.append(str(info.value))
        with pytest.raises(_http.HTTPError):
            async with client.stream("POST", url, json={}) as response:
                async for _ in response.aiter_lines():
                    pass
        for package, http_client in ((PH, client), (JH, httpx.AsyncClient(timeout=timeout))):
            with pytest.raises(package.ModelAPIError) as info:
                await package.post_json(http_client, url, headers={}, payload={},
                                        provider="openai")
            assert info.value.status is None and str(info.value).startswith(
                "openai request failed: ")
            lines = []
            with pytest.raises(package.ModelAPIError) as info:
                async for line in package.sse_lines(http_client, url, headers={}, payload={},
                                                    provider="openai"):
                    lines.append(line)
            assert info.value.status is None and str(info.value).startswith(
                "openai stream failed: ")
            out.append(lines)
        return out

    got = await failures(refused_url, 1)
    assert got[1] == got[2] == []
    async with Loopback(cut_mid_body) as server:
        got = await failures(server.url, 1)
        assert "cut short" in got[0] and got[1] == got[2] == ['{"choices": []}']
    async with Loopback(stalls) as server:
        t = asyncio.get_running_loop().time()
        got = await failures(server.url, 0.3)
        assert "within 0.3 s" in got[0] and got[1] == got[2] == ['{"choices": []}']
        # six exchanges, each cut at its first 0.3 s gap, not at the server's 3 s
        assert asyncio.get_running_loop().time() - t < 6


async def test_a_stream_longer_than_the_timeout_is_not_cut():
    lines = [f'{{"choices":[{{"delta":{{"content":"{i}"}}}}]}}' for i in range(8)]

    async def slow(reader, writer, body):
        writer.write(STREAM_HEAD)
        for line in [*lines, '{"choices":[{"finish_reason":"stop","delta":{}}]}', "[DONE]"]:
            await asyncio.sleep(0.15)
            writer.write(_chunk(f"data: {line}\n\n".encode()))
            await writer.drain()
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    async with Loopback(slow) as server:
        t = asyncio.get_running_loop().time()
        port = P.OpenAIModelClient("m", api_key="k", base_url=server.url,
                                   http_client=_http.HTTPClient(timeout=0.5))
        got = [e async for e in port.request_stream([to_port_user("go")])]
        took = asyncio.get_running_loop().time() - t
        ref = JP.OpenAIModelClient("m", api_key="k", base_url=server.url,
                                   http_client=httpx.AsyncClient(timeout=0.5))
        want = [e async for e in ref.request_stream([JM.user_message("go")])]
    assert took > 1.0  # longer than the timeout, twice over
    assert _dump(got) == _dump(want) and got[-1].response.text() == "01234567"


async def test_https_goes_through_the_default_tls_context():
    transport = _http.SocketTransport(1.0)
    context = transport.ssl_context()
    assert isinstance(context, ssl.SSLContext) and context is transport.ssl_context()
    assert context.verify_mode == ssl.CERT_REQUIRED and context.check_hostname

    server = await asyncio.start_server(
        lambda r, w: (w.write(b"HTTP/1.1 200 OK\r\n\r\n"), w.close()), "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    try:
        client = _http.HTTPClient(timeout=2)
        with pytest.raises(_http.HTTPError):  # no TLS answers there
            await client.post(f"https://127.0.0.1:{port}/", json={})
        owned = P.AnthropicModelClient("m", api_key="k", base_url=f"https://127.0.0.1:{port}")
        with pytest.raises(P.ModelAPIError, match="anthropic request failed"):
            await owned.request([to_port_user("hi")])
        assert isinstance(owned._client, _http.HTTPClient) and owned._client.timeout == 120.0
        await owned.aclose()
        assert owned._client is None
    finally:
        server.close()
        await server.wait_closed()


async def test_lines_split_as_httpx_splits_them():
    rng = np.random.default_rng(7)
    alphabet = [b"a", b"b", b"\n", b"\r", b"\r\n", b"\xc3\xa9", b"\xe2\x80\xa8", b"\x0b", b" ",
                b"\xff", b"data: x"]

    async def lines(client, body_chunks) -> list:
        async with client.stream("GET", "http://h.example/") as response:
            return [line async for line in response.aiter_lines()]

    for _ in range(200):
        data = b"".join(alphabet[i] for i in rng.integers(0, len(alphabet), 30))
        cuts = sorted(rng.integers(0, len(data) + 1, int(rng.integers(0, 8))).tolist())
        bounds = [0, *cuts, len(data)]
        pieces = [data[a:b] for a, b in zip(bounds, bounds[1:])]

        async def body():
            for piece in pieces:
                yield piece

        want = await lines(httpx.AsyncClient(transport=httpx.MockTransport(
            lambda r: httpx.Response(200, content=body()))), pieces)
        got = await lines(_http.HTTPClient(transport=_http.MockTransport(
            lambda r: _http.Response(200, content=body()))), pieces)
        assert got == want, (data, cuts)


def test_request_and_response_shapes():
    request = _http.HTTPClient(headers={"X-Client": "c"}).build_request(
        "post", "https://api.example/v1/x?y=1", json={"a": [1, "é"], "b": None},
        headers={"authorization": "Bearer k"})
    ref = httpx.AsyncClient(headers={"X-Client": "c"}).build_request(
        "post", "https://api.example/v1/x?y=1", json={"a": [1, "é"], "b": None},
        headers={"authorization": "Bearer k"})
    assert (request.method, str(request.url), request.content) == (
        ref.method, str(ref.url), ref.content)
    assert {k.lower(): v for k, v in request.headers.items() if k.lower() not in TRANSPORT_ONLY} \
        == {k: v for k, v in ref.headers.items() if k not in TRANSPORT_ONLY}
    assert request.headers["AUTHORIZATION"] == "Bearer k" and request.headers["accept-encoding"] \
        == "identity"
    for kw in (dict(json={"a": "é"}), dict(text="é\r\nx"), dict(content=b"\x00\xff"),
               dict(content=b"", headers={"Content-Type": "text/plain; charset=latin-1"})):
        got, want = _http.Response(201, **kw), httpx.Response(201, **kw)
        assert (got.content, got.text) == (want.content, want.text), kw
        assert {k.lower(): v for k, v in got.headers.items()} == dict(want.headers), kw
    with pytest.raises(ValueError):
        _http.Response(200, text="not json").json()
    with pytest.raises(ValueError):
        _http.HTTPClient().build_request("POST", "http://h/", json={"x": float("nan")})


# --------------------------------------------------------------------------- #
# fallback over the local engines, in f32
# --------------------------------------------------------------------------- #

jax = pytest.importorskip("jax")

from calfkit_tpu.inference.client import JaxLocalModelClient  # noqa: E402
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu_torch.inference import TorchLocalModelClient  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from tests._torch_port import JAX_CFG, TORCH_CFG, jax_params, torch_params  # noqa: E402

LOCAL = dict(max_batch_size=2, max_seq_len=128, prefill_chunk=32, decode_steps_per_dispatch=4)
LOCAL_NEW = 8


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


@contextlib.asynccontextmanager
async def _locals(weights):
    """(JAX, port) local clients on the same f32 weights."""
    ref = JaxLocalModelClient(config=JAX_CFG, max_new_tokens=LOCAL_NEW, engine=JaxEngine(
        JAX_CFG, JaxRuntime(**LOCAL, attention_impl="pallas_interpret"), params=weights[0]))
    port = TorchLocalModelClient(max_new_tokens=LOCAL_NEW, engine=InferenceEngine(
        TORCH_CFG, RuntimeConfig(**LOCAL), params=weights[1], device="cpu"))
    try:
        yield ref, port
    finally:
        await ref.stop()
        await port.stop()
    engine = port._engine
    assert not engine._active and len(engine._free) == engine.runtime.max_batch_size


async def test_remote_first_falls_back_to_the_local_engine(weights):
    ref_seen, port_seen = [], []
    async with _locals(weights) as (ref_local, port_local):
        ref = JP.FallbackModelClient(
            JP.OpenAIModelClient("gpt", api_key="k", base_url="https://down.example/v1",
                                 http_client=_ref_http(_answer, ref_seen)), ref_local)
        port = P.FallbackModelClient(
            P.OpenAIModelClient("gpt", api_key="k", base_url="https://down.example/v1",
                                http_client=_port_http(_answer, port_seen)), port_local)
        await ref.start()
        await port.start()
        for method in ("request", "request_stream"):
            want = await _outcome(lambda: getattr(ref, method)([JM.user_message("hello")]))
            got = await _outcome(lambda: getattr(port, method)([to_port_user("hello")]))
            assert want[0] in ("result", "events") and got == want, method
        assert port_local._engine.stats.prefill_tokens > 0
    assert len(port_seen) == len(ref_seen) == 2 and port_seen == ref_seen


async def test_local_first_rolls_a_refused_prompt_over_to_the_remote(weights):
    long_prompt = "far too long " * 20  # 260 byte tokens, past max_seq_len 128
    async with _locals(weights) as (ref_local, port_local):
        ref = JP.FallbackModelClient(
            ref_local, JP.OpenAIModelClient("gpt", api_key="k",
                                            http_client=_ref_http(_answer, [])),
            fallback_on=(JaxInferenceError, JP.ModelAPIError))
        port = P.FallbackModelClient(
            port_local, P.OpenAIModelClient("gpt", api_key="k",
                                            http_client=_port_http(_answer, [])),
            fallback_on=(InferenceError, P.ModelAPIError))
        for method in ("request", "request_stream"):
            want = await _outcome(lambda: getattr(ref, method)([JM.user_message(long_prompt)]))
            got = await _outcome(lambda: getattr(port, method)([to_port_user(long_prompt)]))
            assert got == want, method
        assert want[1][-1][1][1]["parts"][0]["text"] == "Hello é"
        # without the local refusal in fallback_on, it propagates in both
        ref_strict = JP.FallbackModelClient(ref_local, ref.models[1])
        port_strict = P.FallbackModelClient(port_local, port.models[1])
        want = await _outcome(lambda: ref_strict.request([JM.user_message(long_prompt)]))
        got = await _outcome(lambda: port_strict.request([to_port_user(long_prompt)]))
        assert want[0] == "raised" and got[0] == "raised" and got[:2] == want[:2]
        # the refusal's type and its first clause: the remedy it names is
        # each package's own
        assert got[2][0] == want[2][0] == "InferenceError"
        assert got[2][-1].split(" (")[0] == want[2][-1].split(" (")[0] == (
            "prompt of 285 tokens exceeds max_seq_len 128")
        assert port_local._engine.stats.prefill_tokens == 0


async def test_a_failure_after_the_first_event_propagates(weights):
    midstream = _sse('{"choices":[{"delta":{"content":"Hel"}}]}',
                     '{"error":{"message":"upstream reset","type":"server_error"}}')

    def answer(method, url, content):
        return 200, {"content-type": "text/event-stream"}, midstream

    async with _locals(weights) as (ref_local, port_local):
        ref = JP.FallbackModelClient(
            JP.OpenAIModelClient("gpt", api_key="k", http_client=_ref_http(answer, [])),
            ref_local)
        port = P.FallbackModelClient(
            P.OpenAIModelClient("gpt", api_key="k", http_client=_port_http(answer, [])),
            port_local)
        want = await _outcome(lambda: ref.request_stream([JM.user_message("hi")]))
        got = await _outcome(lambda: port.request_stream([to_port_user("hi")]))
        assert want[0] == "raised" and want[1] == [("TextDelta", "Hel")]
        assert want[2][0] == "ModelAPIError" and "mid-stream" in want[2][-1]
        assert got == want
        assert port_local._engine.stats.prefill_tokens == 0  # the local engine never asked
