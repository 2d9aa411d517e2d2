"""Dev-loop state: the managed broker and detached agent daemons.

Connect-or-spawn with a spawn-race file lock, and detached agent daemons
with status/stop/down.

All state lives under ``$CALFKIT_DEV_DIR`` (default
``~/.calfkit_tpu_torch/dev``, apart from the JAX package's
``~/.calfkit_tpu/dev``, so a broker or daemon one package manages is never
stopped by the other): ``broker.json`` + ``broker.lock`` for the managed
meshd, and ``agents/<name>.json`` + ``agents/<name>.log`` per detached
daemon.  The brokers are the port's own spawns
(:func:`~calfkit_tpu_torch.mesh.tcp.spawn_meshd`,
:func:`~calfkit_tpu_torch.mesh.kafka_wire.spawn_kafkad`) and the daemons
``python -m calfkit_tpu_torch.cli.main run`` workers.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

# the managed dev brokers: meshd (native line protocol) and kafkad (the
# real Kafka wire protocol — closest to the reference's bundled Tansu
# dev broker, which is itself Kafka-compatible)
logger = logging.getLogger(__name__)

BROKER_KINDS = {
    "meshd": {"default_port": 19092, "scheme": "tcp"},
    "kafkad": {"default_port": 19392, "scheme": "kafka+wire"},
}


def default_port(kind: str = "meshd") -> int:
    return BROKER_KINDS[kind]["default_port"]


def dev_dir() -> Path:
    root = os.environ.get("CALFKIT_DEV_DIR") or os.path.expanduser(
        "~/.calfkit_tpu_torch/dev"
    )
    path = Path(root)
    (path / "agents").mkdir(parents=True, exist_ok=True)
    return path


def _pid_alive(pid: int) -> bool:
    """Liveness that treats zombies as dead (a spawner that dropped its
    Popen handle never reaps; ``os.kill(pid, 0)`` still succeeds)."""
    with contextlib.suppress(ChildProcessError, OSError):
        os.waitpid(pid, os.WNOHANG)  # reap if it's our own child
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    with contextlib.suppress(OSError, IndexError):
        stat = Path(f"/proc/{pid}/stat").read_text()
        if stat.rsplit(")", 1)[1].split()[0] == "Z":
            return False
    return True


def _pid_is_ours(pid: int, needle: str) -> bool:
    """Never signal a recycled pid: the process must still look like the
    one this registry started."""
    with contextlib.suppress(OSError):
        cmdline = Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ")
        return needle.encode() in cmdline
    return False


def _port_open(port: int, timeout: float = 0.5) -> bool:
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=timeout):
            return True
    except OSError:
        return False


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes (recv may legally return partial reads)."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return buf
        buf += chunk
    return buf


def _probe_kind(port: int, kind: str, timeout: float = 0.5) -> bool:
    """Protocol-aware liveness: an open port is only 'our broker' if it
    answers the kind's own protocol (a meshd squatting the port must not
    be claimed as a kafkad and vice versa)."""
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
            s.settimeout(timeout)
            if kind == "meshd":
                s.sendall(b"PING\n")
                return _recv_exact(s, 4) == b"PONG"
            # kafkad: ApiVersions v0 (api_key 18) with correlation id 7
            req = (b"\x00\x12" b"\x00\x00" b"\x00\x00\x00\x07" b"\xff\xff")
            s.sendall(len(req).to_bytes(4, "big") + req)
            header = _recv_exact(s, 8)
            return (
                len(header) == 8
                and int.from_bytes(header[4:8], "big") == 7
            )
    except OSError:
        return False


# --------------------------------------------------------------------------- #
# broker: connect-or-spawn with a spawn-race file lock
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class BrokerInfo:
    port: int
    pid: int | None  # None = pre-existing broker we merely connected to
    spawned: bool
    kind: str = "meshd"

    @property
    def url(self) -> str:
        scheme = BROKER_KINDS[self.kind]["scheme"]
        return f"{scheme}://127.0.0.1:{self.port}"


def _broker_meta(kind: str) -> Path:
    # meshd keeps the legacy filename so existing dev state stays valid
    name = "broker.json" if kind == "meshd" else f"broker-{kind}.json"
    return dev_dir() / name


def ensure_broker(
    port: int | None = None, kind: str = "meshd", *,
    durable: "bool | None" = None,
) -> BrokerInfo:
    """Connect to a live dev broker, or spawn one — exactly one, even when
    multiple ``ck dev`` invocations race (a file lock: one spawn wins,
    the rest connect)."""
    if kind not in BROKER_KINDS:
        raise ValueError(f"unknown broker kind {kind!r}")
    if port is None:
        port = default_port(kind)
    def _connected() -> BrokerInfo:
        # warn only on a POSITIVE non-durable record: no record at all
        # means unknown provenance (racing sibling mid-meta-write) and a
        # spurious warning would be a lie
        if durable and _recorded_durable(port, kind) is False:
            logger.warning(
                "a NON-durable %s broker is already up on port %d; "
                "--durable has no effect until it is restarted "
                "(ck dev stop, then ck dev mesh --kafka --durable)",
                kind, port,
            )
        return BrokerInfo(
            port=port, pid=_read_broker_pid(port, kind), spawned=False,
            kind=kind,
        )

    if _probe_kind(port, kind):
        return _connected()
    if durable is None:
        # unstated durability INHERITS what this registry last spawned on
        # the port — `ck dev serve --kafka` must not silently demote a
        # broker the user created with --durable
        durable = bool(_recorded_durable(port, kind))
    if _port_open(port):
        # something is listening but the protocol probe above missed it.
        # That is EITHER a foreign listener, or a broker another racer
        # spawned between our two checks (bind happens before the probe
        # endpoint answers) — re-probe briefly before declaring foreign,
        # else a concurrent `ck dev` race misclassifies its sibling's
        # fresh broker and errors spuriously.
        for _ in range(10):
            # short probe timeout: a FOREIGN listener never answers, and
            # this path must stay a quick error (~1s), while a sibling's
            # fresh broker answers within the first try or two
            if _probe_kind(port, kind, timeout=0.1):
                return _connected()
            if not _port_open(port):
                break  # listener vanished: fall through to the spawn path
            time.sleep(0.05)
        else:
            # consistently open but never speaks our protocol: foreign —
            # claiming it would point daemons' wire clients at the wrong
            # protocol
            raise RuntimeError(
                f"port {port} is occupied by something that does not speak "
                f"the {kind} protocol — pick another --port"
            )
    lock_path = dev_dir() / f"broker-{kind}.lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # losers wait here while one spawns
        try:
            if _probe_kind(port, kind):  # the winner got it up while we waited
                return _connected()
            if kind == "kafkad":
                from calfkit_tpu_torch.mesh.kafka_wire import spawn_kafkad

                kwargs = {}
                if durable:
                    # per-PORT WAL dir: two brokers must never share a log
                    wal_dir = dev_dir() / f"kafkad-wal-{port}"
                    wal_dir.mkdir(parents=True, exist_ok=True)
                    kwargs["log_dir"] = str(wal_dir)

                def spawn(p, *, start_new_session=False):
                    return spawn_kafkad(
                        p, start_new_session=start_new_session, **kwargs
                    )
            else:
                from calfkit_tpu_torch.mesh.tcp import spawn_meshd as spawn

            # own session: a ctrl-c aimed at the CLI must not take the
            # broker (daemons pointed at it) down with it
            proc = spawn(port, start_new_session=True)
            _broker_meta(kind).write_text(
                json.dumps({"port": port, "pid": proc.pid, "kind": kind,
                            "durable": bool(durable)})
            )
            return BrokerInfo(port=port, pid=proc.pid, spawned=True, kind=kind)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _recorded_durable(port: int, kind: str) -> "bool | None":
    """True/False when this registry recorded the port's broker; None
    when there is no record (unknown provenance — e.g. a sibling racer's
    broker whose meta isn't written yet)."""
    with contextlib.suppress(Exception):
        meta = json.loads(_broker_meta(kind).read_text())
        if meta.get("port") == port:
            return bool(meta.get("durable"))
    return None


def _read_broker_pid(port: int, kind: str = "meshd") -> int | None:
    with contextlib.suppress(Exception):
        meta = json.loads(_broker_meta(kind).read_text())
        if meta.get("port") == port and _pid_alive(meta.get("pid", -1)):
            return int(meta["pid"])
    return None


def recorded_port(kind: str) -> int | None:
    """The port this registry last spawned a ``kind`` broker on."""
    with contextlib.suppress(Exception):
        return int(json.loads(_broker_meta(kind).read_text())["port"])
    return None


def broker_status(port: int | None = None, kind: str = "meshd") -> dict:
    if port is None:
        port = recorded_port(kind) or default_port(kind)
    scheme = BROKER_KINDS[kind]["scheme"]
    return {
        "port": port,
        "kind": kind,
        "url": f"{scheme}://127.0.0.1:{port}",
        "up": _probe_kind(port, kind),
        "pid": _read_broker_pid(port, kind),
    }


def stop_broker(port: int | None = None, kind: str = "meshd") -> bool:
    """Stop the MANAGED broker (one we spawned and recorded); a broker this
    registry doesn't own — or a recycled pid — is left alone.  ``port=None``
    targets whatever port the registry recorded for this kind."""
    if port is None:
        port = recorded_port(kind) or default_port(kind)
    pid = _read_broker_pid(port, kind)
    if pid is None:
        return False
    if _pid_is_ours(pid, kind):
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGTERM)
        for _ in range(50):
            if not _pid_alive(pid):
                break
            time.sleep(0.1)
    with contextlib.suppress(FileNotFoundError):
        _broker_meta(kind).unlink()
    return True


# --------------------------------------------------------------------------- #
# detached agent daemons
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class DaemonInfo:
    name: str
    pid: int
    specs: list[str]
    mesh_url: str
    log_path: str

    @property
    def alive(self) -> bool:
        return _pid_alive(self.pid)


def _daemon_meta(name: str) -> Path:
    return dev_dir() / "agents" / f"{name}.json"


def spawn_daemon(
    name: str, specs: list[str], mesh_url: str
) -> DaemonInfo:
    """Detach a ``ck run`` worker serving ``specs`` against ``mesh_url``.

    Guarded by a per-name file lock (two terminals racing the same name
    must not leave an untracked second worker) and a short post-spawn
    liveness check (an immediately-crashing daemon is reported, not
    recorded as 'up')."""
    lock_path = dev_dir() / "agents" / f"{name}.lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if (existing := get_daemon(name)) is not None and existing.alive:
                raise RuntimeError(
                    f"daemon {name!r} already running (pid {existing.pid})"
                )
            log_path = dev_dir() / "agents" / f"{name}.log"
            log = open(log_path, "ab")
            specs = [_absolutize(spec) for spec in specs]
            proc = subprocess.Popen(
                [
                    sys.executable, "-m", "calfkit_tpu_torch.cli.main", "run",
                    *specs, "--mesh", mesh_url,
                ],
                stdout=log,
                stderr=log,
                stdin=subprocess.DEVNULL,
                start_new_session=True,  # survives the spawning terminal
            )
            log.close()
            # wait for the child's startup verdict: "serving" in the log
            # (ck run prints it once nodes load) or an early exit.  Bounded
            # so a pathological environment can't hang the CLI.
            log_start = log_path.stat().st_size if log_path.exists() else 0
            for _ in range(80):
                time.sleep(0.1)
                if proc.poll() is not None:
                    tail = ""
                    with contextlib.suppress(OSError):
                        tail = log_path.read_bytes()[-500:].decode(
                            errors="replace"
                        )
                    raise RuntimeError(
                        f"daemon {name!r} exited during startup "
                        f"(code {proc.returncode}); log tail:\n{tail}"
                    )
                with contextlib.suppress(OSError):
                    new = log_path.read_bytes()[log_start:]
                    if b"serving" in new:
                        break
            info = DaemonInfo(
                name=name, pid=proc.pid, specs=list(specs),
                mesh_url=mesh_url, log_path=str(log_path),
            )
            _daemon_meta(name).write_text(json.dumps(info.__dict__))
            return info
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _absolutize(spec: str) -> str:
    """File-based specs must survive the daemon's different cwd."""
    from calfkit_tpu_torch.cli._common import is_file_spec

    if ":" not in spec:  # bare file spec (collect-all grammar)
        return str(Path(spec).resolve()) if is_file_spec(spec) else spec
    module_part, _, attr = spec.rpartition(":")
    if module_part and is_file_spec(module_part):
        return f"{Path(module_part).resolve()}:{attr}"
    return spec


def get_daemon(name: str) -> DaemonInfo | None:
    with contextlib.suppress(Exception):
        return DaemonInfo(**json.loads(_daemon_meta(name).read_text()))
    return None


def list_daemons() -> list[DaemonInfo]:
    out = []
    for meta in sorted((dev_dir() / "agents").glob("*.json")):
        with contextlib.suppress(Exception):
            out.append(DaemonInfo(**json.loads(meta.read_text())))
    return out


def stop_daemon(name: str, *, timeout: float = 10.0) -> bool:
    info = get_daemon(name)
    if info is None:
        return False
    # recycled-pid guard: only signal a process that is still OUR daemon
    if info.alive and _pid_is_ours(info.pid, "calfkit_tpu_torch"):
        with contextlib.suppress(ProcessLookupError):
            os.kill(info.pid, signal.SIGTERM)
        deadline = time.time() + timeout
        while time.time() < deadline and _pid_alive(info.pid):
            time.sleep(0.1)
        if _pid_alive(info.pid):
            with contextlib.suppress(ProcessLookupError):
                os.kill(info.pid, signal.SIGKILL)
    with contextlib.suppress(FileNotFoundError):
        _daemon_meta(name).unlink()
    return True
