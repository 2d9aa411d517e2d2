"""The MCP toolbox of the JAX package's suites, held against the port, and the
port's own HTTP client.

**The reference suites, rebound.**  The twelve cases of ``tests/test_mcp.py``
(a stdio session's initialize, list and call; the spec's command XOR url;
an agent calling an MCP tool through the mesh; the ``include=`` trust
boundary; a ``tools/list_changed`` refreshing the advert; the streamable
HTTP transport answered as JSON and as an event stream) and of
``tests/test_mcp_robustness.py`` (a hostile stdio server: garbage frames,
malformed errors and results, a 1 MiB line, a repeating cursor, a dead
session failing fast, odd content shapes) run here unchanged against
``calfkit_tpu_torch``, each suite rebound by ``tests/_torch_rebind.py``, on
the repo's fixture servers ``tests/_mcp_server.py`` and
``tests/_mcp_hostile_server.py``, with ``httpx`` blocked: the port's HTTP
transport is its own client (``calfkit_tpu_torch._http``).

**The HTTP client.**  Against a raw asyncio server that writes each answer
byte for byte: a ``Content-Length`` body, a ``chunked`` body (with a chunk
extension and a trailer), a body read to the connection's close, an
interim ``100 Continue``, an event stream's ``data:`` lines, the status
errors of ``raise_for_status`` and a refused connection; the request it
sends (method, target, ``Host``, headers, JSON body).
"""

from __future__ import annotations

import asyncio
import importlib
import inspect
import json
import sys

import pytest

from calfkit_tpu_torch import _http
from tests._torch_rebind import ported_module

# contract module -> {suite class: cases rebound}
SUITES = {
    "tests.test_mcp": {"TestMCPSession": 2, "TestToolboxNode": 2, "TestListChanged": 1,
                       "TestHTTPTransport": 1},
    "tests.test_mcp_robustness": {"TestHostileFrames": 6},
}
CASES = [
    (module_name, suite_name, name)
    for module_name, suites in SUITES.items()
    for suite_name in suites
    for name in vars(getattr(importlib.import_module(module_name), suite_name))
    if name.startswith("test_")
]


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
    assert len(CASES) == 12
    from calfkit_tpu_torch.mcp import MCPSession, MCPToolboxNode
    from calfkit_tpu_torch.mcp.transport import MCPError

    g = ported_module("tests.test_mcp")
    assert g["MCPSession"] is MCPSession and g["MCPToolboxNode"] is MCPToolboxNode
    assert ported_module("tests.test_mcp_robustness")["MCPError"] is MCPError


@pytest.mark.parametrize("module_name,suite_name,name", CASES,
                         ids=[f"{s}::{n}" for _, s, n in CASES])
def test_reference_case_on_the_port(module_name, suite_name, name, monkeypatch):
    monkeypatch.setitem(sys.modules, "httpx", None)  # an import of it raises
    suite = ported_module(module_name)[suite_name]
    _run(getattr(suite(), name)())


# --------------------------------------------------------------------------- #
# the port's HTTP client
# --------------------------------------------------------------------------- #


class RawServer:
    """A loopback server that records each request and writes ``answer``'s
    bytes back, then closes (or keeps the connection when ``linger``)."""

    def __init__(self, answer: bytes, linger: bool = False):
        self.answer, self.linger = answer, linger
        self.requests: list[tuple[list[str], bytes]] = []
        self.writers: list = []

    async def _handle(self, reader, writer):
        head = []
        while True:
            line = (await reader.readline()).decode("latin-1").rstrip("\r\n")
            if not line:
                break
            head.append(line)
        length = next((int(h.split(":", 1)[1]) for h in head
                       if h.lower().startswith("content-length:")), 0)
        self.requests.append((head, await reader.readexactly(length)))
        writer.write(self.answer)
        await writer.drain()
        if self.linger:
            self.writers.append(writer)  # closed on exit
        else:
            writer.close()

    async def __aenter__(self):
        self.server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.server.sockets[0].getsockname()[1]}/mcp?x=1"
        return self

    async def __aexit__(self, *exc):
        for writer in self.writers:
            writer.close()
        self.server.close()
        await self.server.wait_closed()


def _post(answer: bytes, **kw):
    async def go():
        async with RawServer(answer) as server:
            client = _http.HTTPClient(headers={"X-Client": "c"}, timeout=5)
            response = await client.post(server.url, **kw)
            return server, response

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


def test_content_length_body_and_the_request_sent():
    body = b'{"ok": true}'
    server, response = _post(
        b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\nContent-Length: "
        + str(len(body)).encode() + b"\r\n\r\n" + body + b"trailing junk",
        json={"a": [1, "é"]}, headers={"Accept": "application/json"},
    )
    assert response.status_code == 200 and response.reason == "OK"
    assert response.json() == {"ok": True} and response.content == body
    head, sent = server.requests[0]
    assert head[0] == "POST /mcp?x=1 HTTP/1.1"
    assert head[1] == f"Host: 127.0.0.1:{server.url.split(':')[2].split('/')[0]}"
    assert {"X-Client: c", "Accept: application/json", "Content-Type: application/json",
            "Connection: close", f"Content-Length: {len(sent)}"} <= set(head)
    assert json.loads(sent) == {"a": [1, "é"]}


def test_chunked_body_with_an_extension_and_a_trailer():
    _, response = _post(
        b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n"
        b"Content-Type: text/plain; charset=utf-8\r\n\r\n"
        b"5\r\nhello\r\n7;name=x\r\n, world\r\n0\r\nX-Trailer: t\r\n\r\n",
        json={},
    )
    assert response.content == b"hello, world" and response.text == "hello, world"


def test_body_read_to_close_and_an_interim_answer():
    _, response = _post(
        b"HTTP/1.1 100 Continue\r\n\r\nHTTP/1.1 202 Accepted\r\n\r\nno length given",
        json=[1],
    )
    assert response.status_code == 202 and response.content == b"no length given"


def test_event_stream_data_lines():
    events = (b"event: message\ndata: {\"id\": 1}\n\n: comment\ndata:{\"id\": 2}\n\n"
              b"id: 7\n")
    _, response = _post(
        b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\nContent-Length: "
        + str(len(events)).encode() + b"\r\n\r\n" + events,
        json={},
    )
    assert response.headers["content-type"] == "text/event-stream"
    assert response.sse_data() == ['{"id": 1}', '{"id": 2}']


@pytest.mark.parametrize("status,kind", [(404, "Client"), (503, "Server")])
def test_status_errors(status, kind):
    _, response = _post(
        f"HTTP/1.1 {status} Nope\r\nContent-Length: 2\r\n\r\nno".encode(), json={})
    with pytest.raises(_http.HTTPStatusError, match=f"{kind} error '{status} Nope'") as info:
        response.raise_for_status()
    assert info.value.response is response
    _post(b"HTTP/1.1 204 No Content\r\nContent-Length: 0\r\n\r\n", json={})[1].raise_for_status()


def test_refused_connection_and_malformed_answers_are_typed():
    async def go():
        server = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        server.close()
        await server.wait_closed()
        client = _http.HTTPClient(timeout=5)
        with pytest.raises(_http.HTTPError):
            await client.post(f"http://127.0.0.1:{port}/", json={})
        with pytest.raises(_http.HTTPError, match="not an http"):
            await client.post("ftp://127.0.0.1/", json={})
        async with RawServer(b"garbage\r\n\r\n") as raw:
            with pytest.raises(_http.HTTPError, match="malformed status line"):
                await client.post(raw.url, json={})
        async with RawServer(b"HTTP/1.1 200 OK\r\nContent-Length: 10\r\n\r\nshort") as raw:
            with pytest.raises(_http.HTTPError):
                await client.post(raw.url, json={})
        async with RawServer(b"", linger=True) as raw:
            with pytest.raises(_http.HTTPError, match="no answer within"):
                await _http.HTTPClient(timeout=0.3).post(raw.url, json={})

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(go())
    finally:
        loop.close()
