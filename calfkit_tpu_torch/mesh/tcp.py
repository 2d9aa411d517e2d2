"""TcpMesh: MeshTransport over the native ``meshd`` dev broker.

The port's own copy of ``calfkit_tpu.mesh.tcp``.  ``meshd``
(native/meshd.cpp) is the single-binary broker behind the multi-process dev
mesh.  The protocol is newline-delimited text with
base64 fields; every publish is acked broker-side before the response
returns.  Table reads use a locally-cached fold with an end-offsets barrier
(see ``_TcpTableReader``).

Per-key ordering across processes holds because the broker assigns each
partition to exactly one live group member.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import logging
import os
import subprocess
import time
from pathlib import Path
from typing import Awaitable, Callable

from calfkit_tpu_torch.mesh.dispatch import KeyOrderedDispatcher
from calfkit_tpu_torch.mesh.tables import TableReader, TableWriter
from calfkit_tpu_torch.mesh.transport import (
    CallbackSubscription,
    MeshTransport,
    Record,
    RecordHandler,
    Subscription,
)

logger = logging.getLogger(__name__)

DEFAULT_PORT = 19092
# keys + rendered headers get their own budget (they ride every protocol
# line alongside the value; the stream limits are derived from BOTH)
KEY_HEADERS_CAP = 1024 * 1024


def _enc(data: bytes | None) -> str:
    if not data:
        return "-"
    return base64.b64encode(data).decode()


def _dec(field: str) -> bytes:
    if field == "-":
        return b""
    return base64.b64decode(field)


class _Conn:
    """One broker connection; the protocol is strict request→response."""

    def __init__(self, host: str, port: int,
                 limit: int = 32 * 1024 * 1024):
        self._host, self._port = host, port
        self._limit = limit
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._lock = asyncio.Lock()

    async def open(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self._host, self._port,
            # asyncio's default 64 KiB stream limit would break the
            # newline-delimited protocol on any record past ~48 KiB
            # (base64 inflates 4/3): budget for the biggest legal message
            limit=self._limit,
        )

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            with contextlib.suppress(Exception):
                await self._writer.wait_closed()
            self._writer = None

    async def request(self, line: str) -> str:
        async with self._lock:
            assert self._writer is not None and self._reader is not None
            self._writer.write(line.encode() + b"\n")
            await self._writer.drain()
            response = await self._reader.readline()
            if not response:
                raise ConnectionError("meshd closed the connection")
            return response.decode().rstrip("\n")

    async def request_multi(self, line: str) -> list[str]:
        """For N-prefixed responses (POLL/TABLE)."""
        async with self._lock:
            assert self._writer is not None and self._reader is not None
            self._writer.write(line.encode() + b"\n")
            await self._writer.drain()
            head = (await self._reader.readline()).decode().rstrip("\n")
            if not head.startswith("N "):
                raise ConnectionError(f"unexpected meshd response: {head!r}")
            count = int(head.split()[1])
            return [
                (await self._reader.readline()).decode().rstrip("\n")
                for _ in range(count)
            ]


class TcpMesh(MeshTransport):
    def __init__(
        self,
        address: str = f"127.0.0.1:{DEFAULT_PORT}",
        *,
        max_message_bytes: int = 5 * 1024 * 1024,
        poll_timeout_ms: int = 500,
    ):
        host, _, port = address.partition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port or DEFAULT_PORT)
        self._max_bytes = max_message_bytes
        # stream budget for one protocol line: base64 (4/3 inflation) of
        # the biggest legal value PLUS the key/headers cap + frame
        # overhead — derived, so a bigger configured budget can't pass
        # the publish guard then die on read
        self._line_limit = max(
            32 * 1024 * 1024,
            (max_message_bytes + KEY_HEADERS_CAP) * 4 // 3 + 64 * 1024,
        )
        self._poll_timeout_ms = poll_timeout_ms
        self._control: _Conn | None = None
        self._pumps: list[asyncio.Task[None]] = []
        self._dispatchers: list[KeyOrderedDispatcher] = []
        self._sub_conns: list[_Conn] = []  # per-subscription connections
        self._readers: list["_TcpTableReader"] = []
        self._started = False

    @property
    def max_message_bytes(self) -> int:
        return self._max_bytes

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._started:
            return
        self._control = _Conn(self._host, self._port, limit=self._line_limit)
        await self._control.open()
        if await self._control.request("PING") != "PONG":
            raise ConnectionError("meshd did not answer PING")
        # atomicity-ok: callers serialize start() (Client._ensure_started's
        # single-flight lock / worker boot); a double start re-opens the
        # control conn, it never corrupts state
        self._started = True

    async def stop(self) -> None:
        self._started = False
        # table readers own their conn + pump; stopping the mesh must not
        # leak them (same discipline as KafkaWireMesh).  Swap-then-iterate:
        # the lists are detached BEFORE the first await, so a subscribe()
        # racing stop() can never append into a snapshot we already walked
        # (the meshlint await-atomicity rule pins this shape)
        readers, self._readers = self._readers, []
        for reader in readers:
            with contextlib.suppress(Exception):
                await reader.stop()
        pumps, self._pumps = self._pumps, []
        for pump in pumps:
            pump.cancel()
        for pump in pumps:
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await pump
        dispatchers, self._dispatchers = self._dispatchers, []
        for d in dispatchers:
            with contextlib.suppress(Exception):
                await d.stop()
        # close subscription connections so the broker rebalances away from
        # this (now dead) member immediately
        sub_conns, self._sub_conns = self._sub_conns, []
        for conn in sub_conns:
            with contextlib.suppress(Exception):
                await conn.close()
        if self._control is not None:
            await self._control.close()
            self._control = None

    # ---------------------------------------------------------------- admin
    async def ensure_topics(self, names: list[str], *, compacted: bool = False) -> None:
        if not names:
            return
        assert self._control is not None
        await self._control.request("ENSURE " + ",".join(names))

    # -------------------------------------------------------------- produce
    async def publish(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        headers: dict[str, str] | None = None,
    ) -> None:
        if len(value) > self._max_bytes:
            raise ValueError(
                f"message of {len(value)} bytes exceeds max_message_bytes={self._max_bytes}"
            )
        if self._control is None:
            raise RuntimeError("mesh not started")
        headers_json = json.dumps(headers or {}).encode()
        if len(key or b"") + len(headers_json) > KEY_HEADERS_CAP:
            raise ValueError(
                f"key+headers of {len(key or b'') + len(headers_json)} bytes "
                f"exceed the {KEY_HEADERS_CAP}-byte budget"
            )
        response = await self._control.request(
            f"PUB {topic} {_enc(key)} {_enc(value)} {_enc(headers_json)}"
        )
        if not response.startswith("OK"):
            raise ConnectionError(f"publish failed: {response!r}")

    # -------------------------------------------------------------- consume
    async def subscribe(
        self,
        topics: list[str],
        handler: RecordHandler,
        *,
        group_id: str | None,
        from_latest: bool | None = None,
        max_workers: int = 8,
        ordered: bool = True,
    ) -> Subscription:
        if not self._started:
            raise RuntimeError("mesh not started")
        if from_latest is None:
            from_latest = group_id is None

        deliver = handler
        dispatcher: KeyOrderedDispatcher | None = None
        if ordered:
            dispatcher = KeyOrderedDispatcher(
                handler, max_workers=max_workers, name=f"tcp-{group_id or 'tap'}"
            )
            dispatcher.start()
            self._dispatchers.append(dispatcher)

            async def deliver(record: Record) -> None:  # type: ignore[misc]
                await dispatcher.submit(record)

        conns: list[_Conn] = []
        tasks: list[asyncio.Task[None]] = []
        stopping = asyncio.Event()
        mode = "latest" if from_latest else "earliest"
        for name in topics:
            conn = _Conn(self._host, self._port, limit=self._line_limit)
            await conn.open()
            response = await conn.request(f"SUB {name} {group_id or '-'} {mode}")
            sub_id = response.split()[1]
            conns.append(conn)
            self._sub_conns.append(conn)
            tasks.append(
                asyncio.get_running_loop().create_task(
                    self._pump(conn, sub_id, name, group_id, mode, deliver,
                               stopping),
                    name=f"tcp-pump-{name}",
                )
            )
        self._pumps.extend(tasks)

        async def stop_fn() -> None:
            # GRACEFUL leave: let each pump finish its in-flight POLL and
            # deliver what the broker already ack-committed to us — a
            # mid-response cancel would turn a clean unsubscribe into
            # record loss (the crash path, which is documented at-most-once)
            stopping.set()
            # the window must cover the in-flight poll AND delivering its
            # whole batch through dispatcher backpressure — a mid-delivery
            # cancel drops broker-committed records; only a genuinely hung
            # handler forfeits that guarantee
            grace = self._poll_timeout_ms / 1000.0 + 30.0
            if tasks:
                done, pending = await asyncio.wait(tasks, timeout=grace)
                for task in pending:
                    task.cancel()
                for task in tasks:  # retrieve exceptions from done pumps too
                    with contextlib.suppress(asyncio.CancelledError, Exception):
                        await task
            for conn in conns:
                await conn.close()  # broker rebalances on disconnect
                if conn in self._sub_conns:
                    self._sub_conns.remove(conn)
            if dispatcher is not None:
                await dispatcher.stop()
                if dispatcher in self._dispatchers:
                    self._dispatchers.remove(dispatcher)

        return CallbackSubscription(stop_fn)

    async def _pump(
        self,
        conn: _Conn,
        sub_id: str,
        topic: str,
        group_id: str | None,
        mode: str,
        deliver: RecordHandler,
        stopping: asyncio.Event,
    ) -> None:
        while not stopping.is_set():
            try:
                lines = await conn.request_multi(
                    f"POLL {sub_id} 64 {self._poll_timeout_ms}"
                )
            except (ConnectionError, OSError):
                if not self._started:
                    return
                # broker restart: reconnect + re-subscribe (dev brokers are
                # memory-only, so a fresh broker means a fresh log)
                logger.warning(
                    "meshd connection lost for %s: reconnecting", topic
                )
                try:
                    await asyncio.sleep(1.0)
                    await conn.close()
                    await conn.open()
                    response = await conn.request(
                        f"SUB {topic} {group_id or '-'} {mode}"
                    )
                    sub_id = response.split()[1]
                except (ConnectionError, OSError):
                    continue  # keep trying while the mesh is running
                continue
            for line in lines:
                _, part, offset, key, value, headers_b64 = line.split(" ")
                try:
                    headers = json.loads(_dec(headers_b64) or b"{}")
                except ValueError:
                    headers = {}
                record = Record(
                    topic=topic,
                    key=_dec(key) or None,
                    value=_dec(value),
                    headers=headers,
                    offset=int(offset),
                )
                try:
                    await deliver(record)
                except Exception:  # noqa: BLE001
                    logger.exception("tcp delivery failed on %s", topic)

    # --------------------------------------------------------------- tables
    def table_reader(self, topic: str) -> TableReader:
        reader = _TcpTableReader(self, topic)
        self._readers.append(reader)
        return reader

    def table_writer(self, topic: str) -> TableWriter:
        return _TcpTableWriter(self, topic)


class _TcpTableReader(TableReader):
    """A locally-cached fold fed by a broadcast tap, with an offset-gate
    barrier (same shape as the Kafka reader): ``barrier()`` captures the
    broker's per-partition end offsets and waits until the local view has
    consumed past them."""

    def __init__(self, mesh: TcpMesh, topic: str):
        self._mesh = mesh
        self._topic = topic
        self._view: dict[str, bytes] = {}
        self._positions = [0] * 16  # consumed count per partition
        self._version = 0  # view-mutation counter (TableReader.version)
        self._advanced = asyncio.Event()
        self._conn: _Conn | None = None
        self._task: asyncio.Task[None] | None = None
        self._started = False

    async def start(self, *, timeout: float = 30.0) -> None:
        await self._mesh.ensure_topics([self._topic])
        self._conn = _Conn(self._mesh._host, self._mesh._port,
                          limit=self._mesh._line_limit)
        await self._conn.open()
        response = await self._conn.request(f"SUB {self._topic} - earliest")
        sub_id = response.split()[1]
        self._task = asyncio.get_running_loop().create_task(
            self._pump(sub_id), name=f"tcp-table-{self._topic}"
        )
        try:
            await asyncio.wait_for(self.barrier(), timeout=timeout)
        except BaseException:
            await self.stop()
            raise
        self._started = True

    async def _pump(self, sub_id: str) -> None:
        assert self._conn is not None
        while True:
            try:
                lines = await self._conn.request_multi(f"POLL {sub_id} 256 500")
            except (ConnectionError, OSError):
                return
            for line in lines:
                _, part, _offset, key, value, _headers = line.split(" ")
                k = _dec(key).decode("utf-8", errors="replace")
                v = _dec(value)
                if k:
                    if v:
                        self._view[k] = v
                    else:
                        self._view.pop(k, None)
                    self._version += 1
                self._positions[int(part)] += 1
            if lines:
                self._advanced.set()

    async def stop(self) -> None:
        self._started = False
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
            self._task = None
        if self._conn is not None:
            await self._conn.close()
            self._conn = None
        if self in self._mesh._readers:
            self._mesh._readers.remove(self)

    async def barrier(self, *, timeout: float = 30.0) -> None:
        assert self._mesh._control is not None
        response = await self._mesh._control.request(f"ENDS {self._topic}")
        ends = [int(x) for x in response.split()[1].split(",")]

        def behind() -> bool:
            return any(p < e for p, e in zip(self._positions, ends))

        async def gate() -> None:
            while behind():
                self._advanced.clear()
                if not behind():
                    return
                await self._advanced.wait()

        await asyncio.wait_for(gate(), timeout=timeout)

    def get(self, key: str) -> bytes | None:
        return self._view.get(key)

    def items(self) -> dict[str, bytes]:
        return dict(self._view)

    @property
    def is_caught_up(self) -> bool:
        return self._started

    @property
    def version(self) -> "int | None":
        return self._version


class _TcpTableWriter(TableWriter):
    def __init__(self, mesh: TcpMesh, topic: str):
        self._mesh = mesh
        self._topic = topic

    async def put(self, key: str, value: bytes) -> None:
        await self._mesh.publish(self._topic, value, key=key.encode())

    async def tombstone(self, key: str) -> None:
        await self._mesh.publish(self._topic, b"", key=key.encode())


# --------------------------------------------------------------------------- #
# spawning
# --------------------------------------------------------------------------- #


def find_meshd() -> str | None:
    from calfkit_tpu_torch.mesh._native import find_native_binary

    return find_native_binary("meshd", "CALFKIT_MESHD")


def spawn_meshd(
    port: int = DEFAULT_PORT, *, start_new_session: bool = False
) -> subprocess.Popen:
    """Spawn the native broker and wait for readiness.

    ``port=0`` lets the broker bind an OS-assigned port (no
    probe-then-spawn TOCTOU race); the actual port is parsed from the
    broker's ``PORT <n>`` stdout line and exposed as ``proc.meshd_port``
    (set for every spawn).

    ``start_new_session=True`` detaches it from the caller's terminal
    (managed dev brokers must survive a ctrl-c aimed at the CLI).
    """
    from calfkit_tpu_torch.mesh._native import spawn_port_reporting

    binary = find_meshd()
    if binary is None:
        raise FileNotFoundError(
            "meshd binary not found: run `make -C native` or set CALFKIT_MESHD"
        )
    proc, port = spawn_port_reporting(
        binary, port, name="meshd", start_new_session=start_new_session
    )
    proc.meshd_port = port  # type: ignore[attr-defined]
    deadline = time.time() + 10
    import socket

    while time.time() < deadline:
        if proc.poll() is not None:
            # a PONG from a pre-existing broker must not mask a bind failure
            raise RuntimeError(
                f"meshd exited immediately (code {proc.returncode}) — is "
                f"port {port} already in use?"
            )
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=0.5) as s:
                s.sendall(b"PING\n")
                if s.recv(16).startswith(b"PONG"):
                    return proc
        except OSError:
            time.sleep(0.05)
    proc.terminate()
    raise TimeoutError(f"meshd on port {port} did not become ready")
