"""An asyncio HTTP/1.1 client: the port's stand-in for ``httpx.AsyncClient``.

The JAX package's remote model providers and its MCP transport talk HTTP
through ``httpx``; the port talks it through this module, on
``asyncio.open_connection`` (with ``ssl.create_default_context()`` for
``https://``), in the shape of the part of httpx they use:

- :class:`HTTPClient` ``(headers=, timeout=, transport=)``:
  :meth:`~HTTPClient.post` sends a request and reads the whole answer;
  :meth:`~HTTPClient.stream` is an async context manager whose
  :class:`Response` reads its body as it arrives (``aread()``,
  ``aiter_bytes()``, ``aiter_lines()``, lines split as httpx splits them);
- a ``json=`` body is encoded as httpx 0.28 encodes it (compact, UTF-8, no
  NaN) with ``Content-Type: application/json``; ``content=`` bytes go as
  they are;
- ``timeout`` bounds each connect, each write and each read, as httpx's
  does, never the whole exchange: a stream runs for as long as every gap
  in it stays under the timeout;
- every failure of the exchange (a bad URL, a refused or reset
  connection, a timeout, a body cut short, a malformed answer) raises
  :class:`HTTPError`, never a bare ``OSError`` or ``asyncio.TimeoutError``;
  :meth:`Response.raise_for_status` raises :class:`HTTPStatusError` for a
  4xx or 5xx status;
- the transport is injectable: a transport is any object with
  ``async handle(request) -> Response`` (and optionally ``aclose()``);
  :class:`MockTransport` ``(handler)`` answers in-process, as
  ``httpx.MockTransport`` does in tests.

No pooling (a connection serves one request, ``Connection: close``), no
redirects, no cookies and no compression: the client sends
``Accept-Encoding: identity``, so a server sends every body as it is.
"""

from __future__ import annotations

import asyncio
import codecs
import contextlib
import inspect
import json as _json
import ssl
from collections.abc import AsyncIterable, AsyncIterator, Iterator, Mapping, MutableMapping
from typing import Any, Awaitable, Callable
from urllib.parse import urlsplit

__all__ = ["HTTPClient", "HTTPError", "HTTPStatusError", "Headers", "MockTransport", "Request",
           "Response", "SocketTransport"]

_MAX_HEADER_BYTES = 64 * 1024
_READ_BYTES = 64 * 1024
_DEFAULT_HEADERS = (("Accept", "*/*"), ("Accept-Encoding", "identity"),
                    ("User-Agent", "calfkit-tpu-torch"))


class HTTPError(Exception):
    """The exchange failed: a bad URL, a refused or broken connection, a
    timeout, a body cut short, a malformed answer."""


class HTTPStatusError(HTTPError):
    """The server answered with a 4xx or 5xx status."""

    def __init__(self, message: str, response: "Response"):
        super().__init__(message)
        self.response = response


class Headers(MutableMapping):
    """Header names looked up without regard to case; each keeps the case
    it was set with, and the order it was first set in."""

    def __init__(self, items: "Mapping[str, str] | Any" = None):
        self._items: dict[str, tuple[str, str]] = {}
        if items:
            self.update(items)

    def __getitem__(self, name: str) -> str:
        return self._items[name.lower()][1]

    def __setitem__(self, name: str, value: str) -> None:
        key = name.lower()
        # a name set again keeps its place
        self._items[key] = (self._items[key][0] if key in self._items else name, str(value))

    def __delitem__(self, name: str) -> None:
        del self._items[name.lower()]

    def __iter__(self) -> Iterator[str]:
        return (name for name, _ in self._items.values())

    def __len__(self) -> int:
        return len(self._items)

    def add(self, name: str, value: str) -> None:
        """A repeated header: the values joined by ``, `` (as httpx reads one)."""
        self[name] = f"{self[name]}, {value}" if name in self else value

    def __repr__(self) -> str:
        return f"Headers({dict(self.items())!r})"


def _encode_json(value: Any) -> bytes:
    # httpx 0.28's json= encoding
    return _json.dumps(value, ensure_ascii=False, separators=(",", ":"),
                       allow_nan=False).encode("utf-8")


class Request:
    """A request as the transport sends it: ``method``, ``url`` (a ``str``),
    ``headers`` (:class:`Headers`) and the body's bytes, ``content``."""

    def __init__(self, method: str, url: str, *, headers: Any = None, content: bytes = b""):
        self.method = method.upper()
        self.url = str(url)
        self.headers = Headers(headers)
        self.content = bytes(content)

    def __repr__(self) -> str:
        return f"<Request({self.method!r}, {self.url!r})>"


class _LineDecoder:
    """Text → lines, split at every line boundary ``str.splitlines`` knows
    (``\\n``, ``\\r\\n`` and ``\\r`` among them), a ``\\r`` at the end of a
    piece held until the next shows whether ``\\n`` follows: httpx's
    ``aiter_lines`` split."""

    _BREAKS = "\n\r\x0b\x0c\x1c\x1d\x1e\x85\u2028\u2029"

    def __init__(self) -> None:
        self._partial: list[str] = []
        self._held_cr = False

    def decode(self, text: str) -> "list[str]":
        if self._held_cr:
            text, self._held_cr = "\r" + text, False
        if text.endswith("\r"):
            text, self._held_cr = text[:-1], True
        if not text:
            return []
        ends_line = text[-1] in self._BREAKS
        lines = text.splitlines()
        if len(lines) == 1 and not ends_line:
            self._partial.append(lines[0])
            return []
        if self._partial:
            lines[0] = "".join(self._partial) + lines[0]
            self._partial = []
        if not ends_line:
            self._partial = [lines.pop()]
        return lines

    def flush(self) -> "list[str]":
        if not self._partial and not self._held_cr:
            return []
        line = "".join(self._partial)
        self._partial, self._held_cr = [], False
        return [line]


class Response:
    """An answer: ``status_code``, ``reason``, ``headers`` and a body that is
    either in memory (``content=``, ``text=`` or ``json=``, as
    ``httpx.Response`` takes them) or read from a stream (``content=`` an
    async iterable of bytes, or a transport's connection) by
    :meth:`aread`, :meth:`aiter_bytes` or :meth:`aiter_lines`."""

    def __init__(self, status_code: int, *, headers: Any = None,
                 content: "bytes | str | AsyncIterable[bytes] | None" = None,
                 text: "str | None" = None, json: Any = None,
                 request: "Request | None" = None, reason: str = "",
                 on_close: "Callable[[], Awaitable[None]] | None" = None):
        self.status_code = int(status_code)
        self.reason = reason
        self.headers = Headers(headers)
        self.request = request
        self._stream: "AsyncIterable[bytes] | None" = None
        self._content: "bytes | None" = None
        self._on_close = on_close
        self._consumed = False
        if json is not None:
            body = _encode_json(json)
            self.headers.setdefault("Content-Type", "application/json")
        elif text is not None:
            body = text.encode("utf-8")
            self.headers.setdefault("Content-Type", "text/plain; charset=utf-8")
        elif isinstance(content, str):
            body = content.encode("utf-8")
        elif content is None or isinstance(content, (bytes, bytearray, memoryview)):
            body = bytes(content or b"")
        else:
            self._stream = content
            return
        if body:
            self.headers.setdefault("Content-Length", str(len(body)))
        self._content = body

    @property
    def url(self) -> str:
        return self.request.url if self.request is not None else ""

    @property
    def content(self) -> bytes:
        if self._content is None:
            raise HTTPError("the response body has not been read: call aread() first")
        return self._content

    @property
    def encoding(self) -> str:
        for param in self.headers.get("content-type", "").split(";")[1:]:
            key, _, value = param.strip().partition("=")
            if key.lower() == "charset" and value:
                try:
                    return codecs.lookup(value.strip('"')).name
                except LookupError:
                    break
        return "utf-8"

    @property
    def text(self) -> str:
        return self.content.decode(self.encoding, errors="replace")

    def json(self) -> Any:
        """The body parsed as JSON; ``ValueError`` when it is not JSON."""
        return _json.loads(self.content)

    def raise_for_status(self) -> None:
        if 400 <= self.status_code < 600:
            kind = "Client" if self.status_code < 500 else "Server"
            raise HTTPStatusError(
                f"{kind} error '{self.status_code} {self.reason}' for url '{self.url}'", self
            )

    def sse_data(self) -> "list[str]":
        """The payload of every ``data:`` line of an event-stream body."""
        return [line[5:].strip() for line in self.text.splitlines() if line.startswith("data:")]

    async def aread(self) -> bytes:
        """The whole body (read from the stream at the first call)."""
        if self._content is None:
            self._content = b"".join([chunk async for chunk in self.aiter_bytes()])
        return self._content

    async def aiter_bytes(self) -> AsyncIterator[bytes]:
        """The body's bytes in the pieces they arrive in."""
        if self._content is not None:
            if self._content:
                yield self._content
            return
        if self._consumed:
            raise HTTPError("the response body was already read as a stream")
        self._consumed = True
        async for chunk in self._stream:
            if chunk:
                yield bytes(chunk)

    async def aiter_lines(self) -> AsyncIterator[str]:
        """The body decoded in its charset (UTF-8 when none is given, bad
        bytes replaced) and split into lines as each piece arrives."""
        decoder = codecs.getincrementaldecoder(self.encoding)(errors="replace")
        lines = _LineDecoder()
        async for chunk in self.aiter_bytes():
            for line in lines.decode(decoder.decode(chunk)):
                yield line
        for line in lines.decode(decoder.decode(b"", final=True)) + lines.flush():
            yield line

    async def aclose(self) -> None:
        """Release the connection (nothing to do for a body in memory)."""
        close, self._on_close = self._on_close, None
        if close is not None:
            await close()

    def __repr__(self) -> str:
        return f"<Response [{self.status_code}]>"


class MockTransport:
    """Answers every request in-process with ``handler(request)`` (a
    :class:`Response`, or an awaitable of one), as ``httpx.MockTransport``
    does."""

    def __init__(self, handler: Callable[[Request], Any]):
        self.handler = handler

    async def handle(self, request: Request) -> Response:
        response = self.handler(request)
        if inspect.isawaitable(response):
            response = await response
        response.request = request
        return response


class SocketTransport:
    """HTTP/1.1 over a fresh connection a request (TLS for ``https://``
    through ``ssl.create_default_context()``); ``timeout`` bounds the
    connect, the write of the request and every read of the answer."""

    def __init__(self, timeout: float):
        self.timeout = timeout
        self._ssl: "ssl.SSLContext | None" = None

    def ssl_context(self) -> ssl.SSLContext:
        """The TLS context of ``https://`` connections (made at first use)."""
        if self._ssl is None:
            self._ssl = ssl.create_default_context()
        return self._ssl

    async def _timed(self, awaitable: Awaitable, where: str, what: str) -> Any:
        """``awaitable`` bounded by the timeout, its failures as HTTPError."""
        try:
            return await asyncio.wait_for(awaitable, self.timeout)
        except asyncio.TimeoutError:
            raise HTTPError(f"{where}: {what} within {self.timeout} s") from None
        except (OSError, asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ValueError) as exc:
            raise HTTPError(f"{where}: {exc!r}") from exc

    async def handle(self, request: Request) -> Response:
        parts = urlsplit(request.url)
        secure = parts.scheme == "https"
        port = parts.port or (443 if secure else 80)
        host = parts.hostname
        where = f"{request.method} {request.url}"
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        try:
            reader, writer = await asyncio.wait_for(asyncio.open_connection(
                host, port, ssl=self.ssl_context() if secure else None,
                server_hostname=host if secure else None, limit=_MAX_HEADER_BYTES,
            ), self.timeout)
        except asyncio.TimeoutError:
            raise HTTPError(f"{where}: no connection within {self.timeout} s") from None
        except OSError as exc:  # refused, unreachable, a failed TLS handshake
            raise HTTPError(f"{where}: {exc}") from exc

        async def close() -> None:
            writer.close()
            with contextlib.suppress(OSError, ssl.SSLError):
                await writer.wait_closed()

        try:
            lines = [f"{request.method} {target} HTTP/1.1",
                     *(f"{k}: {v}" for k, v in request.headers.items()), "Connection: close"]
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + request.content)
            await self._timed(writer.drain(), where, "the request was not sent")
            status, reason, headers = await self._read_head(reader, where)
        except BaseException:
            await close()
            raise
        if status in (204, 304):  # no body
            await close()
            return Response(status, headers=headers, request=request, reason=reason)
        body = self._body(reader, headers, where)

        async def release() -> None:
            with contextlib.suppress(RuntimeError):
                await body.aclose()
            await close()

        return Response(status, headers=headers, content=body, request=request, reason=reason,
                        on_close=release)

    async def _read_head(self, reader: asyncio.StreamReader,
                         where: str) -> "tuple[int, str, Headers]":
        while True:
            raw = await self._timed(reader.readline(), where, "no answer")
            status_line = raw.decode("latin-1").rstrip("\r\n")
            version, _, rest = status_line.partition(" ")
            code, _, reason = rest.partition(" ")
            if not version.startswith("HTTP/") or not code.isdigit():
                if not raw:
                    raise HTTPError(f"{where}: the server closed the connection without an answer")
                raise HTTPError(f"{where}: malformed status line {status_line[:80]!r}")
            headers = Headers()
            while True:
                line = (await self._timed(reader.readline(), where, "no header line")
                        ).decode("latin-1").rstrip("\r\n")
                if not line:
                    break
                name, _, value = line.partition(":")
                headers.add(name.strip(), value.strip())
            if not 100 <= int(code) < 200:  # an informational answer precedes the real one
                return int(code), reason, headers

    async def _body(self, reader: asyncio.StreamReader, headers: Headers,
                    where: str) -> AsyncIterator[bytes]:
        read = (where, "no body data")
        if "chunked" in headers.get("transfer-encoding", "").lower():
            while True:
                size_line = await self._timed(reader.readline(), *read)
                if not size_line:
                    raise HTTPError(f"{where}: the body was cut short (chunked)")
                try:
                    size = int(size_line.split(b";", 1)[0].strip(), 16)
                except ValueError:
                    raise HTTPError(f"{where}: malformed chunk size {size_line[:40]!r}") from None
                if size == 0:
                    # trailers, if any, end at an empty line
                    while (await self._timed(reader.readline(), *read)).strip():
                        pass
                    return
                while size:
                    chunk = await self._timed(reader.read(min(size, _READ_BYTES)), *read)
                    if not chunk:
                        raise HTTPError(f"{where}: the body was cut short (chunked)")
                    size -= len(chunk)
                    yield chunk
                await self._timed(reader.readline(), *read)  # the CRLF after the chunk
        elif "content-length" in headers:
            remaining = int(headers["content-length"])
            while remaining > 0:
                chunk = await self._timed(reader.read(min(remaining, _READ_BYTES)), *read)
                if not chunk:
                    raise HTTPError(f"{where}: the body was cut short ({remaining} of "
                                    f"{headers['content-length']} bytes missing)")
                remaining -= len(chunk)
                yield chunk
        else:  # read to the connection's close
            while chunk := await self._timed(reader.read(_READ_BYTES), *read):
                yield chunk


class HTTPClient:
    """``HTTPClient(headers=..., timeout=..., transport=...)``: requests with
    the client's headers under the call's, over ``transport`` (by default
    a :class:`SocketTransport` with the client's timeout)."""

    def __init__(self, *, headers: Any = None, timeout: float = 30.0, transport: Any = None):
        self.headers = Headers(headers)
        self.timeout = timeout
        self._transport = transport if transport is not None else SocketTransport(timeout)
        self.is_closed = False

    def build_request(self, method: str, url: str, *, json: Any = None,
                      content: "bytes | str | None" = None, headers: Any = None) -> Request:
        parts = urlsplit(str(url))
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise HTTPError(f"not an http(s) URL: {url!r}")
        if json is not None:
            body = _encode_json(json)
        elif isinstance(content, str):
            body = content.encode("utf-8")
        else:
            body = bytes(content or b"")
        merged = Headers({"Host": parts.netloc.rpartition("@")[2]})
        for name, value in _DEFAULT_HEADERS:
            merged[name] = value
        merged.update(self.headers)
        merged.update(Headers(headers))
        if json is not None:
            merged.setdefault("Content-Type", "application/json")
        merged["Content-Length"] = str(len(body))
        return Request(method, str(url), headers=merged, content=body)

    async def send(self, request: Request, *, stream: bool = False) -> Response:
        """``request``'s answer; its body read and the connection released,
        unless ``stream`` (then the caller reads and closes it)."""
        if self.is_closed:
            raise RuntimeError("the client has been closed")
        response = await self._transport.handle(request)
        if not stream:
            try:
                await response.aread()
            finally:
                await response.aclose()
        return response

    async def post(self, url: str, *, json: Any = None, content: "bytes | str | None" = None,
                   headers: Any = None) -> Response:
        return await self.send(self.build_request("POST", url, json=json, content=content,
                                                  headers=headers))

    @contextlib.asynccontextmanager
    async def stream(self, method: str, url: str, *, json: Any = None,
                     content: "bytes | str | None" = None,
                     headers: Any = None) -> AsyncIterator[Response]:
        """``async with client.stream(...) as response``: the answer with its
        body unread, released when the block ends."""
        response = await self.send(
            self.build_request(method, url, json=json, content=content, headers=headers),
            stream=True)
        try:
            yield response
        finally:
            await response.aclose()

    async def aclose(self) -> None:
        if not self.is_closed:
            self.is_closed = True
            close = getattr(self._transport, "aclose", None)
            if close is not None:
                await close()
