"""The import law of the PyTorch port: ``calfkit_tpu_torch`` and
``chip_smoke.py`` import neither ``jax`` nor anything of ``calfkit_tpu``,
and the engine refuses to fall back to the CPU when no card is present."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "calfkit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "calfkit_tpu" \\
                or name.startswith("calfkit_tpu."):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
import calfkit_tpu_torch
for mod in pkgutil.walk_packages(calfkit_tpu_torch.__path__, "calfkit_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
assert not any(m == "jax" or m.startswith(("jax.", "calfkit_tpu.")) or m == "calfkit_tpu"
               for m, v in sys.modules.items() if v is not None)
print("OK")
"""


def test_port_imports_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [
        name for name in names
        if name.split(".")[0] in ("jax", "jaxlib", "calfkit_tpu")
    ]
    assert not bad, f"{path.name} imports {bad}"


def test_engine_without_a_card_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from calfkit_tpu_torch.exceptions import InferenceError
    from calfkit_tpu_torch.inference.config import RuntimeConfig, preset
    from calfkit_tpu_torch.inference.engine import InferenceEngine

    with pytest.raises(InferenceError, match="no CUDA device"):
        InferenceEngine(preset("debug"), RuntimeConfig(max_batch_size=2, max_seq_len=64))
