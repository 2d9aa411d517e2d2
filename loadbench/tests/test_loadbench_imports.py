"""What the benchmark loads: never JAX or the JAX package, compared by
whole top-level names; the plain reference nothing of the program either."""

from __future__ import annotations

import json
import subprocess
import sys

from loadbench import guard
from loadbench.tests.tiny import REPO

_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(REPO), imports=imports)],
        capture_output=True, text=True, check=True, timeout=300, cwd=str(REPO),
    )
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_top_level_names_are_compared():
    assert guard.forbidden(["calfkit_tpu_torch.inference.engine", "jaxtyping", "numpy"]) == []
    assert guard.forbidden(["calfkit_tpu.inference", "jax.numpy", "flax.linen"]) == [
        "calfkit_tpu", "flax", "jax"]


def test_the_harness_and_the_program_load_no_jax():
    loaded = _loaded(
        "import loadbench.harness, loadbench.drive, loadbench.trace, loadbench.guard\n"
        "from loadbench import traffic\n"
        "traffic.generator('sessions'); traffic.generator('closed')\n"
        "import calfkit_tpu_torch.inference.engine\n"
        "from calfkit_tpu_torch.inference.config import ModelConfig, RuntimeConfig\n"
    )
    assert "calfkit_tpu_torch" in loaded
    assert guard.forbidden(sorted(loaded)) == []


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import loadbench.reference.decoder, loadbench.weights, loadbench.configs")
    assert not loaded & {"calfkit_tpu_torch", "calfkit_tpu", "jax", "jaxlib", "flax"}
