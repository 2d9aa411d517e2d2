"""Shared spawn machinery for the in-repo native brokers (meshd, kafkad).

The port's own copy of ``calfkit_tpu.mesh._native``, plus
:func:`build_native`, which compiles the brokers and the CRC library from
``native/``'s sources with its Makefile's flags into ``_build/native/``.

Both binaries follow the same contract: ``<binary> <port>`` where port 0
binds an OS-assigned port, and the bound port is reported on stdout as
``PORT <n>`` before serving begins.
"""

from __future__ import annotations

import hashlib
import os
import re
import select
import shutil
import subprocess
import time
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "native"
# binary -> (source, the Makefile's compiler and flags variables, the rule's
# own arguments, the environment variable that points the mesh at it)
TARGETS: dict[str, tuple[str, str, str, tuple[str, ...], str]] = {
    "meshd": ("meshd.cpp", "CXX", "CXXFLAGS", (), "CALFKIT_MESHD"),
    "kafkad": ("kafkad.cpp", "CXX", "CXXFLAGS", (), "CALFKIT_KAFKAD"),
    "libcrc32c.so": ("crc32c.c", "CC", "CFLAGS", ("-shared", "-fPIC"), "CALFKIT_CRC32C"),
}


def find_native_binary(name: str, env_var: str) -> str | None:
    """Locate an in-repo native binary; ``$<env_var>`` overrides."""
    env = os.environ.get(env_var)
    if env and Path(env).exists():
        return env
    candidate = Path(__file__).resolve().parents[2] / "native" / "bin" / name
    return str(candidate) if candidate.exists() else None


def spawn_port_reporting(
    binary: str, port: int, *, name: str, start_new_session: bool = False,
    timeout: float = 10.0, extra_args=(),
) -> tuple[subprocess.Popen, int]:
    """Spawn a PORT-reporting broker and return (proc, bound_port).

    Handles the failure paths uniformly: immediate exit (bind failure on a
    taken fixed port) raises with the exit code instead of hanging in
    select; a binary that never prints ``PORT`` (stale build) is killed,
    reaped, and reported."""
    proc = subprocess.Popen(
        [binary, str(port), *extra_args],
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        start_new_session=start_new_session,
    )

    def _kill(message: str, error: type) -> None:
        proc.terminate()
        try:
            proc.wait(timeout=5)
        except Exception:  # noqa: BLE001
            pass
        proc.stdout.close()
        raise error(message)

    # non-blocking accumulate until a full line: a child that writes a
    # partial line without a newline (stale/wedged binary) must hit the
    # deadline below, not hang the caller in a blocking readline
    os.set_blocking(proc.stdout.fileno(), False)
    deadline = time.time() + timeout
    buf = b""
    while b"\n" not in buf:
        if proc.poll() is not None and not buf:
            proc.stdout.close()
            raise RuntimeError(
                f"{name} exited immediately (code {proc.returncode}) — is "
                f"port {port} already in use?"
            )
        ready, _, _ = select.select(
            [proc.stdout], [], [], min(0.25, max(0.0, deadline - time.time()))
        )
        if ready:
            chunk = proc.stdout.read(4096)
            if chunk:
                buf += chunk
                continue
            if chunk == b"":  # pipe EOF: the child can never report now
                if proc.poll() is not None:
                    proc.stdout.close()
                    raise RuntimeError(
                        f"{name} exited immediately (code {proc.returncode}) "
                        f"— is port {port} already in use?"
                    )
                _kill(
                    f"{name} closed stdout without reporting its bound port "
                    "— stale binary? run `make -C native`",
                    RuntimeError,
                )
        if time.time() >= deadline:
            _kill(
                f"{name} did not report its bound port within {timeout:.0f}s "
                "— stale binary? run `make -C native`",
                TimeoutError,
            )
    line = buf.split(b"\n", 1)[0].decode(errors="replace").strip()
    try:
        reported = int(line.removeprefix("PORT "))
    except ValueError:
        reported = -1
    if not line.startswith("PORT ") or reported <= 0:
        _kill(
            f"{name} did not report its bound port (got {line!r}) — "
            "stale binary? run `make -C native`",
            RuntimeError,
        )
    proc.stdout.close()
    return proc, reported


def makefile_defaults() -> dict[str, str]:
    """The ``NAME ?= value`` defaults of ``native/Makefile``."""
    text = (NATIVE_DIR / "Makefile").read_text()
    return {m[1]: m[2].strip() for m in re.finditer(r"^(\w+)\s*\?=(.*)$", text, re.M)}


def build_native() -> dict[str, Path]:
    """Compile the native brokers and the CRC library from ``native/``'s
    sources with its Makefile's compilers and flags (``$CXX``, ``$CC``,
    ``$CXXFLAGS`` and ``$CFLAGS`` override them, as they do for ``make``),
    one compiler per target, all started together → {name: path}.  Each
    build lands in ``_build/native/<hash>/``, the hash of its source, the
    Makefile and the command, so an unchanged target is not rebuilt."""
    defaults = makefile_defaults()
    started = {}
    for name, (source, cc, flags, extra, _) in TARGETS.items():
        cmd = [
            *(os.environ.get(cc) or defaults[cc]).split(),
            *(os.environ.get(flags) or defaults[flags]).split(), *extra,
        ]
        digest = hashlib.sha256(" ".join(cmd).encode())
        for path in (NATIVE_DIR / source, NATIVE_DIR / "Makefile"):
            digest.update(path.read_bytes())
        out = BUILD_DIR / digest.hexdigest()[:16] / name
        if out.exists():
            started[name] = (out, None, None)
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [*cmd, "-o", str(tmp), str(NATIVE_DIR / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started[name] = (out, tmp, proc)
    built = {}
    for name, (out, tmp, proc) in started.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"building {name} from native/{TARGETS[name][0]} failed:\n{log}")
            os.replace(tmp, out)
        built[name] = out
    return built


def use_native_builds(built: "dict[str, Path]") -> None:
    """Point the meshes' lookups (``$CALFKIT_MESHD``, ``$CALFKIT_KAFKAD``,
    ``$CALFKIT_CRC32C``) at :func:`build_native`'s outputs.  The wire
    client picks its CRC when :mod:`~calfkit_tpu_torch.mesh.kafka_wire` is
    first imported: call this before."""
    for name, path in built.items():
        os.environ[TARGETS[name][4]] = str(path)


def compiler_versions() -> dict[str, str]:
    """The first line of ``--version`` of the compilers :func:`build_native` runs."""
    defaults = makefile_defaults()
    out = {}
    for var in ("CXX", "CC"):
        exe = (os.environ.get(var) or defaults[var]).split()[0]
        found = shutil.which(exe)
        out[var] = (
            subprocess.run([found, "--version"], capture_output=True, text=True)
            .stdout.splitlines()[0] if found else f"{exe}: not found"
        )
    return out
