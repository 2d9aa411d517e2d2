"""A minimal asyncio HTTP/1.1 client: one POST a connection.

The port's stand-in for the ``httpx.AsyncClient`` calls of the JAX package
(the MCP transport's streamable HTTP), on ``asyncio.open_connection`` with
``ssl`` for ``https://``:

- :meth:`HTTPClient.post` sends a JSON body with the client's and the
  call's headers, ``Connection: close``, and reads the
  status line, the headers and a ``Content-Length``, ``chunked`` or
  read-to-close body, the whole exchange bounded by the client's timeout;
- :meth:`Response.raise_for_status` raises :class:`HTTPStatusError` for a
  4xx or 5xx status;
- :meth:`Response.sse_data` gives the payload of every ``data:`` line of
  a ``text/event-stream`` body.

No pooling, no redirects, no compression: a connection serves one
request.
"""

from __future__ import annotations

import asyncio
import json as _json
import ssl
from dataclasses import dataclass, field
from typing import Any
from urllib.parse import urlsplit

__all__ = ["HTTPClient", "HTTPError", "HTTPStatusError", "Response"]

_MAX_HEADER_BYTES = 64 * 1024


class HTTPError(Exception):
    """The exchange failed: a bad URL, a refused or broken connection, a
    malformed answer."""


class HTTPStatusError(HTTPError):
    """The server answered with a 4xx or 5xx status."""

    def __init__(self, message: str, response: "Response"):
        super().__init__(message)
        self.response = response


@dataclass
class Response:
    url: str
    status_code: int
    reason: str
    headers: dict[str, str] = field(default_factory=dict)  # names lower-cased
    content: bytes = b""

    @property
    def text(self) -> str:
        charset = "utf-8"
        for param in self.headers.get("content-type", "").split(";")[1:]:
            key, _, value = param.strip().partition("=")
            if key.lower() == "charset" and value:
                charset = value.strip('"')
        return self.content.decode(charset, errors="replace")

    def json(self) -> Any:
        return _json.loads(self.content)

    def raise_for_status(self) -> None:
        if 400 <= self.status_code < 600:
            kind = "Client" if self.status_code < 500 else "Server"
            raise HTTPStatusError(
                f"{kind} error '{self.status_code} {self.reason}' for url '{self.url}'", self
            )

    def sse_data(self) -> list[str]:
        """The payload of every ``data:`` line of an event-stream body."""
        return [line[5:].strip() for line in self.text.splitlines() if line.startswith("data:")]


class HTTPClient:
    """``HTTPClient(headers=..., timeout=...)``: POSTs, each over a fresh
    connection."""

    def __init__(self, *, headers: "dict[str, str] | None" = None, timeout: float = 30.0):
        self.headers = dict(headers or {})
        self.timeout = timeout

    async def post(self, url: str, *, json: Any,
                   headers: "dict[str, str] | None" = None) -> Response:
        body = _json.dumps(json).encode()
        merged = {**self.headers, **(headers or {})}
        if not any(k.lower() == "content-type" for k in merged):
            merged["Content-Type"] = "application/json"
        try:
            return await asyncio.wait_for(self._exchange(url, body, merged), self.timeout)
        except asyncio.TimeoutError:
            raise HTTPError(f"POST {url}: no answer within {self.timeout} s") from None

    async def _exchange(self, url: str, body: bytes, headers: dict[str, str]) -> Response:
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise HTTPError(f"not an http(s) URL: {url!r}")
        secure = parts.scheme == "https"
        port = parts.port or (443 if secure else 80)
        host = parts.hostname
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        default_port = port == (443 if secure else 80)
        lines = [
            f"POST {target} HTTP/1.1",
            f"Host: {host if default_port else f'{host}:{port}'}",
            *(f"{k}: {v}" for k, v in headers.items()),
            f"Content-Length: {len(body)}",
            "Connection: close",
        ]
        try:
            reader, writer = await asyncio.open_connection(
                host, port, ssl=ssl.create_default_context() if secure else None,
                server_hostname=host if secure else None, limit=_MAX_HEADER_BYTES,
            )
        except OSError as exc:
            raise HTTPError(f"POST {url}: {exc}") from exc
        try:
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body)
            await writer.drain()
            return await _read_response(url, reader)
        except (OSError, asyncio.IncompleteReadError, ValueError) as exc:
            raise HTTPError(f"POST {url}: {exc!r}") from exc
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except OSError:
                pass


async def _read_response(url: str, reader: asyncio.StreamReader) -> Response:
    while True:
        status_line = (await reader.readline()).decode("latin-1").rstrip("\r\n")
        version, _, rest = status_line.partition(" ")
        code, _, reason = rest.partition(" ")
        if not version.startswith("HTTP/") or not code.isdigit():
            raise HTTPError(f"POST {url}: malformed status line {status_line[:80]!r}")
        headers: dict[str, str] = {}
        while True:
            line = (await reader.readline()).decode("latin-1").rstrip("\r\n")
            if not line:
                break
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        if not 100 <= int(code) < 200:  # an informational answer precedes the real one
            break
    response = Response(url, int(code), reason, headers)
    if "chunked" in headers.get("transfer-encoding", "").lower():
        response.content = await _read_chunked(reader)
    elif "content-length" in headers:
        response.content = await reader.readexactly(int(headers["content-length"]))
    else:
        response.content = await reader.read()
    return response


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    chunks: list[bytes] = []
    while True:
        size_line = (await reader.readline()).decode("latin-1").strip()
        size = int(size_line.split(";", 1)[0], 16)
        if size == 0:
            # trailers, if any, end at an empty line
            while (await reader.readline()).strip():
                pass
            return b"".join(chunks)
        chunks.append(await reader.readexactly(size))
        await reader.readline()  # the CRLF after the chunk
