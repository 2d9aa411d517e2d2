"""The cells on the card: each comes out correct, and each cell's control
comes out not correct.  Marked ``cuda``; each test skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from loadbench.tests.tiny import REPO

CELLS = ("mistral7b.agent-loop", "mistral7b-w8.chat-batch", "mistral7b.chat-batch")


def _card() -> None:
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(script: str, cell: str, seed: int) -> dict:
    out = subprocess.run(
        [sys.executable, f"loadbench/{script}", "--workload", cell, "--seed", str(seed),
         "--seconds", "10", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_is_correct_on_the_card(cell):
    _card()
    result = _run("run.py", cell, 2**31 + 101)
    assert result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    _card()
    result = _run("control.py", cell, 2**31 + 202)
    assert not result["correct"], result["checks"]
