"""The comparison that decides ``correct`` fails a run whose timed path is
broken underneath, and the control: on the CPU at a debug size, the run
goes through every step but the look for a card."""

from __future__ import annotations

import pytest
import torch

from calfkit_tpu_torch.inference import engine as E
from calfkit_tpu_torch.inference import model as M
from loadbench import harness
from loadbench.tests import tiny


def _run(tmp_path, monkeypatch, traffic="chat-batch", control=False, quantization=None):
    root, bench, cell = tiny.make_root(tmp_path, traffic, quantization)
    tiny.use(root, monkeypatch)
    result, _ = harness.run(bench, cell, 31337, 1.5, False, torch.device("cpu"), 0.0,
                            control=control)
    return result


def test_a_token_altered_where_it_is_produced_is_not_correct(tmp_path, monkeypatch):
    argmax = torch.argmax

    def off_by_one(x, *args, **kwargs):
        out = argmax(x, *args, **kwargs)
        return (out + 1) % x.shape[-1] if x.dim() == 2 and x.shape[-1] == 512 else out

    monkeypatch.setattr(E.torch, "argmax", off_by_one)
    result = _run(tmp_path, monkeypatch)
    assert not result["correct"]
    assert result["checks"]["mean_logit_gap"]["value"] > result["checks"]["mean_logit_gap"]["limit"]


def test_a_step_that_leaves_the_cache_unchanged_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(M, "consolidate_ring_paged", lambda *args, **kwargs: None)
    result = _run(tmp_path, monkeypatch)
    assert not result["correct"]


def test_reused_prefix_pages_that_read_wrong_are_not_correct(tmp_path, monkeypatch):
    seed = E.InferenceEngine._seed_graph

    def zeroed(self, bucket, n_pages, rows):
        fn = seed(self, bucket, n_pages, rows)
        body = fn._body

        def wrong(ids):
            body(ids)
            for side in self._scratch(rows):
                side[:, :, :, : n_pages * self.runtime.page_size].mul_(0.5)

        fn._body = wrong
        return fn

    monkeypatch.setattr(E.InferenceEngine, "_seed_graph", zeroed)
    result = _run(tmp_path, monkeypatch, traffic="agent-loop")
    assert not result["correct"]


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_the_sound_run_is_correct(tmp_path, monkeypatch, quantization):
    result = _run(tmp_path, monkeypatch, quantization=quantization)
    assert result["correct"], result["checks"]


def test_the_control_is_not_correct(tmp_path, monkeypatch):
    """The int8 configuration's control, the program's int4 path, on the
    CPU: the tiny model's limit sits between the mean gaps of sound runs
    (at most 0.0006 over twelve seeds) and the control's (0.14-0.35), as
    the cells' limits do.  The bf16 configuration's control, the int8
    path, parts from sound runs only at the published widths (at the tiny
    size the two overlap): ``test_loadbench_card.py`` runs it there."""
    result = _run(tmp_path, monkeypatch, control=True, quantization="int8")
    assert not result["correct"], result["checks"]
