"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<source>.cu`` exports plain C functions (one per kernel, listed
in :data:`SIGNATURES`; the ``*.cuh`` headers hold device code they share)
and is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library under ``_build/`` (listed in ``.gitignore``), then
loaded with ``ctypes``.  Nothing is built
when this module is imported: the first wrapper that launches a kernel
builds it, or :func:`build_all` builds every source at once, one ``nvcc``
per source, all started together.  A library is named by the hash of its
source and the headers, so an edited source rebuilds and an unchanged one
loads as is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# kernel → (the source that exports it, its C symbol, its C signature)
SIGNATURES: dict[str, tuple[str, str, list]] = {
    "decode_attention": (
        "decode_attention", "calfkit_decode_attention",
        [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
         _L, _L, _L, _L, _L, _L, _F, _P],
    ),
    "paged_decode_attention": (
        "decode_attention", "calfkit_paged_decode_attention",
        [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
         _L, _L, _L, _L, _L, _L, _L, _F, _P],
    ),
    "prefill_attention": (
        "prefill_attention", "calfkit_prefill_attention",
        [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
         _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    ),
    "ragged_attention": (
        "ragged_attention", "calfkit_ragged_attention",
        [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
         _L, _L, _L, _L, _L, _L, _F, _P],
    ),
    "ragged_attention_paged": (
        "ragged_attention", "calfkit_ragged_paged_attention",
        [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _L, _L, _L, _L, _L, _L, _L, _F, _P],
    ),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library_path(source: str) -> Path:
    # the shared headers count too: an edited header rebuilds every source
    digest = hashlib.sha256()
    for path in (CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{source}-{digest}.so"


def _start_build(source: str) -> "tuple[Path, subprocess.Popen | None]":
    out = _library_path(source)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, proc


def _finish_build(source: str, out: Path, proc: "subprocess.Popen | None") -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, Path]:
    """Compile every kernel source that has no current library, one ``nvcc``
    per source in parallel → {source: library path}."""
    with _lock:
        sources = dict.fromkeys(source for source, _, _ in SIGNATURES.values())
        started = {source: _start_build(source) for source in sources}
        for source, (out, proc) in started.items():
            _finish_build(source, out, proc)
        return {source: out for source, (out, _) in started.items()}


def function(name: str) -> "ctypes._CFuncPtr":
    """The loaded C entry point of kernel ``name``, its source built at first
    use."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            source, symbol, argtypes = SIGNATURES[name]
            out, proc = _start_build(source)
            _finish_build(source, out, proc)
            fn = getattr(ctypes.CDLL(str(out)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn
