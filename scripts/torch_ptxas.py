#!/usr/bin/env python3
"""Print what ptxas reports for each kernel of the PyTorch port's CUDA sources.

    python3 scripts/torch_ptxas.py [SOURCE ...]

Compiles ``calfkit_tpu_torch/csrc/<SOURCE>.cu`` (default: every source) with
the flags the port builds with (``kernels.NVCC_FLAGS``) plus ``-Xptxas -v``
into a throw-away object, and prints ptxas's lines: for each kernel its
registers a thread, spill stores and loads (bytes), and static shared memory
(``smem``; the kernels' dynamic shared memory is set at launch and is not in
it).  Needs ``nvcc``.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from calfkit_tpu_torch import kernels  # noqa: E402


def report(source: str) -> str:
    flags = [f for f in kernels.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [kernels._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / "k.o"),
               str(kernels.CSRC / f"{source}.cu")]
        done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}.cu:\n{done.stdout}{done.stderr}")
    return "\n".join(
        line for line in (done.stdout + done.stderr).splitlines() if line.startswith("ptxas")
    )


def main() -> int:
    sources = sys.argv[1:] or sorted({source for source, _, _ in kernels.SIGNATURES.values()})
    for source in sources:
        print(f"== {source}.cu")
        print(report(source))
    return 0


if __name__ == "__main__":
    sys.exit(main())
