"""Minimal MCP client: JSON-RPC 2.0 over stdio (newline-delimited) or
streamable HTTP.

The port's own copy of ``calfkit_tpu.mcp.transport``, its HTTP on the
port's own client (:mod:`calfkit_tpu_torch._http`).  Implements exactly the
subset the toolbox node needs (the wire format is plain JSON-RPC):

- ``initialize`` handshake + ``notifications/initialized``
- ``tools/list`` (paginated) and ``tools/call``
- ``notifications/tools/list_changed`` surfaces via a callback
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

logger = logging.getLogger(__name__)

PROTOCOL_VERSION = "2024-11-05"


@dataclass(frozen=True)
class MCPServerSpec:
    """How to reach one MCP server: a command (stdio) XOR a url (HTTP)."""

    name: str
    command: list[str] | None = None
    url: str | None = None
    env: dict[str, str] = field(default_factory=dict)
    headers: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if bool(self.command) == bool(self.url):
            raise ValueError(
                f"MCP server {self.name!r}: exactly one of command/url required"
            )


class MCPError(RuntimeError):
    pass


class MCPSession:
    def __init__(
        self,
        spec: MCPServerSpec,
        *,
        on_tools_changed: Callable[[], Awaitable[None] | None] | None = None,
        request_timeout: float = 30.0,
    ):
        self.spec = spec
        self._on_tools_changed = on_tools_changed
        self._timeout = request_timeout
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future[Any]] = {}
        self._dead: str | None = None  # set when the reader can't recover
        self._proc: asyncio.subprocess.Process | None = None
        self._reader_task: asyncio.Task[None] | None = None
        self._http: Any = None

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self.spec.command:
            self._proc = await asyncio.create_subprocess_exec(
                *self.spec.command,
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.DEVNULL,
                env={**__import__("os").environ, **self.spec.env} or None,
                # asyncio's default 64 KiB stream limit would KILL the
                # read loop on any large tool result; 32 MiB covers real
                # MCP payloads
                limit=32 * 1024 * 1024,
            )
            self._reader_task = asyncio.get_running_loop().create_task(
                self._read_stdio(), name=f"mcp-{self.spec.name}-reader"
            )
        else:
            from calfkit_tpu_torch._http import HTTPClient

            self._http = HTTPClient(headers=self.spec.headers, timeout=self._timeout)
        result = await self.request(
            "initialize",
            {
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": {},
                "clientInfo": {"name": "calfkit-tpu", "version": "0.1.0"},
            },
        )
        logger.info(
            "mcp %s initialized (server: %s)",
            self.spec.name,
            result.get("serverInfo", {}).get("name", "?"),
        )
        await self.notify("notifications/initialized", {})

    async def stop(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        if self._proc is not None:
            try:
                self._proc.terminate()
                await asyncio.wait_for(self._proc.wait(), timeout=5)
            except (ProcessLookupError, asyncio.TimeoutError):
                with __import__("contextlib").suppress(ProcessLookupError):
                    self._proc.kill()
            self._proc = None
        self._http = None
        self._fail_pending("session closed")
        self._pending.clear()

    # -------------------------------------------------------------- rpc
    async def request(self, method: str, params: dict[str, Any]) -> dict[str, Any]:
        if self._dead is not None:
            # fail FAST and typed: a dead reader can never resolve a
            # future, so parking one would hang to the raw timeout
            raise MCPError(f"session dead: {self._dead}")
        rpc_id = next(self._ids)
        message = {"jsonrpc": "2.0", "id": rpc_id, "method": method, "params": params}
        if self._proc is not None:
            future: asyncio.Future[Any] = asyncio.get_running_loop().create_future()
            self._pending[rpc_id] = future
            await self._write_stdio(message)
            try:
                return await asyncio.wait_for(future, timeout=self._timeout)
            finally:
                self._pending.pop(rpc_id, None)
        # streamable HTTP: one POST per request
        response = await self._http.post(
            self.spec.url,
            json=message,
            headers={"Accept": "application/json, text/event-stream"},
        )
        response.raise_for_status()
        content_type = response.headers.get("content-type", "")
        if content_type.startswith("text/event-stream"):
            for data in response.sse_data():
                payload = json.loads(data)
                if payload.get("id") == rpc_id:
                    return self._unwrap(payload)
            raise MCPError(f"no response for id {rpc_id} in event stream")
        return self._unwrap(response.json())

    async def notify(self, method: str, params: dict[str, Any]) -> None:
        message = {"jsonrpc": "2.0", "method": method, "params": params}
        if self._proc is not None:
            await self._write_stdio(message)
        elif self._http is not None:
            try:
                await self._http.post(self.spec.url, json=message)
            except Exception:  # noqa: BLE001 - notifications are best-effort
                logger.debug("mcp notify failed", exc_info=True)

    @staticmethod
    def _unwrap(payload: dict[str, Any]) -> dict[str, Any]:
        if "error" in payload:
            error = payload["error"]
            if isinstance(error, dict):  # hostile servers send anything
                raise MCPError(
                    f"[{error.get('code')}] {error.get('message')}"
                )
            raise MCPError(str(error)[:500])
        result = payload.get("result", {})
        if not isinstance(result, dict):
            raise MCPError(
                f"server returned non-object result: {str(result)[:200]}"
            )
        return result

    # ------------------------------------------------------------- stdio
    async def _write_stdio(self, message: dict[str, Any]) -> None:
        assert self._proc is not None and self._proc.stdin is not None
        self._proc.stdin.write(json.dumps(message).encode() + b"\n")
        await self._proc.stdin.drain()

    def _fail_pending(self, message: str) -> None:
        self._dead = message
        for future in self._pending.values():
            if not future.done():
                future.set_exception(MCPError(message))

    async def _read_stdio(self) -> None:
        assert self._proc is not None and self._proc.stdout is not None
        while True:
            try:
                line = await self._proc.stdout.readline()
            except ValueError:
                # line beyond even the raised stream limit: the framing is
                # lost mid-line — the session cannot recover, fail LOUDLY
                # instead of leaving callers to time out
                logger.error(
                    "mcp %s: oversized line broke stream framing",
                    self.spec.name,
                )
                self._fail_pending("server line exceeded the stream limit")
                return
            if not line:
                logger.warning("mcp %s: server closed stdout", self.spec.name)
                self._fail_pending("server exited")
                return
            try:
                payload = json.loads(line)
            except ValueError:
                logger.debug("mcp %s: non-JSON line ignored", self.spec.name)
                continue
            if not isinstance(payload, dict):
                # a list/str/number frame must not kill the read loop (it
                # used to: .get on a list) — every in-flight AND future
                # request would silently hang to timeout
                logger.debug("mcp %s: non-object frame ignored", self.spec.name)
                continue
            try:
                self._handle_frame(payload)
            except Exception:  # noqa: BLE001 — one hostile frame must not
                logger.exception(  # take down the whole session's reader
                    "mcp %s: frame handling failed", self.spec.name
                )

    def _handle_frame(self, payload: dict[str, Any]) -> None:
        rpc_id = payload.get("id")
        if rpc_id is not None and rpc_id in self._pending:
            future = self._pending[rpc_id]
            if not future.done():
                try:
                    future.set_result(self._unwrap(payload))
                except MCPError as exc:
                    future.set_exception(exc)
        elif payload.get("method") == "notifications/tools/list_changed":
            if self._on_tools_changed is not None:
                result = self._on_tools_changed()
                if asyncio.iscoroutine(result):
                    # offload: never block the receive loop (reference:
                    # mcp_toolbox re-list offload)
                    asyncio.get_running_loop().create_task(result)

    # ------------------------------------------------------------- tools
    async def list_tools(self) -> list[dict[str, Any]]:
        tools: list[dict[str, Any]] = []
        cursor: str | None = None
        seen_cursors: set[str] = set()
        while True:
            params: dict[str, Any] = {"cursor": cursor} if cursor else {}
            result = await self.request("tools/list", params)
            page = result.get("tools", [])
            if isinstance(page, list):
                tools.extend(t for t in page if isinstance(t, dict))
            cursor = result.get("nextCursor")
            if not cursor:
                return tools
            if not isinstance(cursor, str):
                raise MCPError(
                    f"non-string nextCursor: {str(cursor)[:100]}"
                )
            if cursor in seen_cursors or len(seen_cursors) >= 1000:
                # a repeating/unbounded cursor would spin this loop forever
                raise MCPError(
                    f"tools/list pagination did not terminate "
                    f"(cursor {str(cursor)[:60]!r} repeated or >1000 pages)"
                )
            seen_cursors.add(cursor)

    async def call_tool(self, name: str, args: dict[str, Any]) -> Any:
        result = await self.request(
            "tools/call", {"name": name, "arguments": args}
        )
        if result.get("isError"):
            content = result.get("content", [])
            raise MCPError(
                _content_text(content)
                or (str(content)[:200] if content else "tool error")
            )
        content = result.get("content", [])
        structured = result.get("structuredContent")
        if structured is not None:
            return structured
        return _content_text(content)


def _content_text(content: Any) -> str:
    if not isinstance(content, list):
        return ""
    return "\n".join(
        str(c.get("text", "")) for c in content
        if isinstance(c, dict) and c.get("type") == "text"
    )
