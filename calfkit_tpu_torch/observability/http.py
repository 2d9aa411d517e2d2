"""A tiny asyncio HTTP endpoint for the metrics exposition: the port's own
copy of ``calfkit_tpu.observability.http``.

No aiohttp, no framework: ``asyncio.start_server`` + a minimal HTTP/1.0
responder serving:

- ``GET /metrics`` — Prometheus text v0;
- ``GET /healthz`` — pure LIVENESS: ``200 ok`` from the moment the server
  listens, unconditionally.  It answers "is the process alive?", nothing
  more — an orchestrator restarts on its failure;
- ``GET /readyz`` — READINESS, backed by a registerable probe
  (:meth:`MetricsServer.set_readiness`): ``200`` only once the probe says
  the node can serve (engine weights loaded, dispatch lanes running),
  ``503`` with a reason otherwise.  A load balancer routes on this.  With
  no probe registered it reports ``503`` — "unknown" must never read as
  "ready";
- ``GET /flightrec`` — on-demand JSONL dump of every registered engine
  flight recorder (:mod:`calfkit_tpu_torch.observability.flightrec`);
- ``GET /capacity`` — on-demand JSONL dump of every registered capacity
  sampler (:mod:`calfkit_tpu_torch.observability.capacity`): the occupancy
  timeline ring plus the live page-attribution breakdown in the meta
  header.

This is an OPTIONAL operator convenience — nothing in the serving path
depends on it — so every failure mode closes the offending connection and
keeps listening.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable

from calfkit_tpu_torch.observability.metrics import MetricsRegistry, metrics_text

logger = logging.getLogger(__name__)

_MAX_REQUEST_BYTES = 8192

# a probe returns bool, or (bool, reason)
ReadinessProbe = Callable[[], Any]


class MetricsServer:
    """``async with MetricsServer(port=9100): ...`` or start()/stop()."""

    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: MetricsRegistry | None = None,
        readiness: ReadinessProbe | None = None,
    ):
        self.host = host
        self.port = port  # 0 = OS-assigned; read back after start()
        self._registry = registry
        self._readiness = readiness
        self._server: asyncio.Server | None = None

    def set_readiness(self, probe: ReadinessProbe | None) -> None:
        """Register (or clear) the readiness probe behind ``/readyz``.
        The probe returns ``bool`` or ``(bool, reason)``; it is called per
        scrape, so keep it cheap.  Compose multiple conditions in the
        probe itself, e.g. ``lambda: (model.ready()[0] and worker.ready()[0],
        "engine + worker")``."""
        self._readiness = probe

    def _ready_state(self) -> "tuple[bool, str]":
        probe = self._readiness
        if probe is None:
            # fail-unready: a /readyz nobody wired must not pass traffic
            return False, "no readiness probe registered"
        try:
            result = probe()
            # normalize INSIDE the guard: a malformed probe return (e.g. a
            # 1-tuple) must degrade to a reasoned 503, not kill the request
            if isinstance(result, tuple):
                ok, reason = bool(result[0]), str(result[1])
            else:
                ok, reason = bool(result), ""
        except Exception as exc:  # noqa: BLE001 - a broken probe is unready
            return False, f"probe error: {exc!r}"
        return ok, reason

    async def start(self) -> None:
        if self._server is not None:
            return
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        sockets = self._server.sockets or []
        if sockets:
            self.port = sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        try:
            await self._server.wait_closed()
        except Exception:  # noqa: BLE001
            pass
        self._server = None

    async def __aenter__(self) -> "MetricsServer":
        await self.start()
        return self

    async def __aexit__(self, *exc: object) -> None:
        await self.stop()

    def _respond(self, path: str) -> "tuple[bytes, str, str]":
        """(body, status, content-type) for one GET path."""
        if path == "/metrics":
            return (
                metrics_text(self._registry).encode("utf-8"),
                "200 OK",
                "text/plain; version=0.0.4",
            )
        if path == "/healthz":
            # liveness ONLY: true from listen to shutdown, even before any
            # engine exists — readiness questions go to /readyz
            return b"ok\n", "200 OK", "text/plain"
        if path == "/readyz":
            ok, reason = self._ready_state()
            if ok:
                body = f"ready{': ' + reason if reason else ''}\n"
                return body.encode("utf-8"), "200 OK", "text/plain"
            body = f"unready{': ' + reason if reason else ''}\n"
            return body.encode("utf-8"), "503 Service Unavailable", "text/plain"
        if path == "/flightrec":
            from calfkit_tpu_torch.observability import flightrec

            text = flightrec.dump_all_text(reason="http")
            if not text:
                return (
                    b"no flight recorders registered\n",
                    "404 Not Found",
                    "text/plain",
                )
            return text.encode("utf-8"), "200 OK", "application/x-ndjson"
        if path == "/capacity":
            from calfkit_tpu_torch.observability import capacity

            text = capacity.dump_all_text(reason="http")
            if not text:
                return (
                    b"no capacity samplers registered\n",
                    "404 Not Found",
                    "text/plain",
                )
            return text.encode("utf-8"), "200 OK", "application/x-ndjson"
        return b"not found\n", "404 Not Found", "text/plain"

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            request = await asyncio.wait_for(
                reader.readline(), timeout=5.0
            )
            if len(request) > _MAX_REQUEST_BYTES:
                raise ValueError("request line too long")
            parts = request.decode("latin-1", "replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # drain headers (bounded) so keep-alive clients see a clean close
            drained = 0
            while True:
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                drained += len(line)
                if line in (b"\r\n", b"\n", b"") or drained > _MAX_REQUEST_BYTES:
                    break
            body, status, ctype = self._respond(path.split("?", 1)[0])
            writer.write(
                (
                    f"HTTP/1.0 {status}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode("latin-1")
                + body
            )
            await writer.drain()
        except Exception:  # noqa: BLE001 - a bad client never kills the server
            logger.debug("metrics endpoint request failed", exc_info=True)
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass
