"""The benchmark measures the PyTorch and CUDA package alone: after the
window, no module whose top-level name (the part before the first dot) is
one of :data:`FORBIDDEN`, compared as a whole name, may be loaded."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "calfkit_tpu")


def forbidden(modules: "list[str] | None" = None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: those
    loaded in this process)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)
