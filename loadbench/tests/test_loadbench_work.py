"""The work counts of the rooflines and of mfu, against hand counts."""

from __future__ import annotations

import pytest

from loadbench import work
from loadbench.drive import Record
from loadbench.readings import Readings

ARCH = dict(vocab=10, d_model=4, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=2, d_ff=6,
            rope_theta=1e4, norm_eps=1e-5, tied=False, dtype="bfloat16")


def test_layer_and_head_params():
    # q 4x4, k and v 4x2 each, o 4x4, gate/up/down 4x6 each
    assert work.layer_params(ARCH) == 16 + 8 + 8 + 16 + 72
    assert work.head_params(ARCH) == 40


def test_attention_flops_count_each_query_over_its_keys():
    # queries at positions 2 and 3 see 3 and 4 keys: 7 (query, key) pairs
    assert work.attention_flops(ARCH, 2, 4) == 4 * 2 * 2 * 2 * 7
    assert work.attention_flops(ARCH, 0, 1) == 4 * 2 * 2 * 2 * 1


def test_prefill_and_decode_flops():
    per_token = 2 * 2 * 120
    assert work.prefill_flops(ARCH, 1, 3) == 2 * per_token + work.attention_flops(ARCH, 1, 3) + 80
    assert work.decode_flops(ARCH, 5) == per_token + 80 + 4 * 2 * 2 * 2 * 5


def test_decode_attention_bytes():
    # per layer: K and V of 5 positions (1 kv head, hd 2, 2 bytes), q and o (2 heads)
    assert work.decode_attention_bytes(ARCH, 5) == 2 * (2 * 1 * 2 * 2 * 5 + 2 * 2 * 2 * 2)


def test_the_prefix_model_holds_whole_pages_with_their_prefix():
    model = work.PrefixModel(page=4)
    model.add(list(range(10)))
    assert model.cached(list(range(10)) + [99]) == 8
    assert model.cached(list(range(8))) == 7  # the last position always computes
    assert model.cached([0, 1, 2, 3, 9, 9, 9, 9]) == 4
    assert model.cached([5, 1, 2, 3]) == 0


def _record(submit, first, prompt, n):
    r = Record("r", submit, submit, prompt, n)
    r.tokens = [0] * n
    r.times = [first + 0.1 * i for i in range(n)]
    return r


def test_mfu_counts_uncached_prompts_and_tokens_in_the_span():
    a = _record(0.0, 1.0, list(range(8)), 3)  # first token at 1.0, then 1.1, 1.2
    b = _record(2.0, 3.0, list(range(8)) + [50, 51], 2)  # 8 positions held by a
    r = Readings(ARCH, {"page_size": 4}, "NVIDIA H100 80GB HBM3", [a, b], (0.0, 4.0), {}, 0)
    assert r.cached(a) == 0 and r.cached(b) == 8
    want = (
        work.prefill_flops(ARCH, 0, 8) + work.decode_flops(ARCH, 9) + work.decode_flops(ARCH, 10)
        + work.prefill_flops(ARCH, 8, 10) + work.decode_flops(ARCH, 11)
    )
    assert r.flops(0.0, 4.0) == want
    assert r.flops(1.05, 1.15) == work.decode_flops(ARCH, 9)
    assert work.peaks(r.device_name)["bf16_flops"] == pytest.approx(989e12)
    assert work.peaks("cpu") is None


def test_the_step_time_is_the_mean_gap_whatever_the_dispatch_lengths():
    # two rows in lockstep at 0.05 s a step: a dispatch of 8 steps lands at
    # 1.4, one of 4 at 1.6, one of 8 at 2.0; each row's first token at 1.0
    lands = [1.0] + [1.4] * 8 + [1.6] * 4 + [2.0] * 8
    rows = []
    for _ in range(2):
        x = Record("r", 0.0, 0.0, [1, 2], len(lands))
        x.tokens, x.times = [0] * len(lands), list(lands)
        rows.append(x)
    r = Readings(ARCH, {"page_size": 4}, "x", rows, (0.0, 3.0), {}, 0)
    assert r.step_s(0.0, 3.0) == pytest.approx(0.05)
    assert r.step_s(1.5, 3.0) == pytest.approx(0.05)  # the last two dispatches
    assert r.step_s(2.5, 3.0) is None
