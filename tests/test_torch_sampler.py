"""The PyTorch port's sampler against ``calfkit_tpu.inference.sampler``.

``filtered_logits`` agrees with allclose (f32; the nucleus cumsum runs in
another order, 1e-5).  ``retire_mask_slots`` is integer logic and must agree
exactly on randomized blocks.  Draws cannot match ``jax.random`` bit for
bit, so the port's own sampling contract is tested: draws depend only on
(seed, position), and greedy rows take the argmax.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from calfkit_tpu.inference import sampler as JS  # noqa: E402
from calfkit_tpu_torch.inference import sampler as TS  # noqa: E402
from tests._torch_port import j, n, t  # noqa: E402


@pytest.mark.parametrize("seed", range(4))
def test_filtered_logits_match(seed):
    rng = np.random.default_rng(seed)
    B, V = 6, 64
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.5, 1.0, 1.3, 0.7, 2.0], np.float32)
    top_k = np.array([0, 5, 0, 1, 64, 10], np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 0.5, 0.3, 1.2], np.float32)
    ref = JS.filtered_logits(j(logits), j(temp), j(top_k), j(top_p))
    out = TS.filtered_logits(t(logits), t(temp), t(top_k), t(top_p))
    ref, out = n(ref), n(out)
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(out[finite], ref[finite], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_retire_mask_slots_exact(seed):
    rng = np.random.default_rng(100 + seed)
    B, S, n_stop = 8, 6, 3
    toks = rng.integers(0, 12, (B, S), dtype=np.int32)
    table = np.full((B, n_stop), -1, np.int32)
    for b in range(B):
        k = rng.integers(0, n_stop + 1)
        table[b, :k] = rng.choice(12, k, replace=False)
    bound = rng.integers(-2, S + 3, B).astype(np.int32)
    active = rng.random(B) < 0.8
    emitted = rng.integers(1, S + 1, B).astype(np.int32)
    for em in (None, emitted):
        ref = JS.retire_mask_slots(
            j(toks), j(table), j(bound), j(active), None if em is None else j(em)
        )
        out = TS.retire_mask_slots(
            t(toks), t(table), t(bound), t(active), None if em is None else t(em)
        )
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(n(a), n(b))


def test_greedy_rows_take_the_argmax():
    logits = torch.randn((4, 50), generator=torch.Generator().manual_seed(0))
    keys = TS.fold_in(torch.arange(4), torch.full((4,), 7))
    zeros = torch.zeros(4)
    out = TS.sample_slots(logits, keys, zeros, torch.zeros(4, dtype=torch.int32), torch.ones(4))
    assert torch.equal(out, logits.argmax(-1).to(torch.int32))


def test_draws_depend_on_seed_and_position_only():
    """The same (seed, position) draws the same token whatever row it sits
    in and whatever shares the batch; other positions draw differently."""
    V = 97
    logits = torch.randn((1, V), generator=torch.Generator().manual_seed(1))
    one = TS.sample_slots(
        logits, TS.fold_in(torch.tensor([42]), torch.tensor([9])),
        torch.tensor([1.0]), torch.tensor([0], dtype=torch.int32), torch.tensor([1.0]),
    )
    batch = logits.expand(3, V)
    seeds, pos = torch.tensor([5, 42, 42]), torch.tensor([9, 9, 10])
    many = TS.sample_slots(
        batch, TS.fold_in(seeds, pos), torch.ones(3),
        torch.zeros(3, dtype=torch.int32), torch.ones(3),
    )
    assert int(many[1]) == int(one[0])
    draws = {
        int(TS.sample_slots(
            logits, TS.fold_in(torch.tensor([42]), torch.tensor([p])),
            torch.tensor([1.0]), torch.tensor([0], dtype=torch.int32), torch.tensor([1.0]),
        )[0])
        for p in range(40)
    }
    assert len(draws) > 5  # positions give independent draws


def test_draws_follow_the_filtered_distribution():
    """Over many (seed, position) keys the Gumbel-max draw lands on each
    token with the softmax probability of the filtered logits."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, -5.0]])
    N = 20000
    keys = TS.fold_in(torch.arange(N), torch.zeros(N, dtype=torch.int64))
    draws = TS.sample_slots(
        logits.expand(N, 5), keys, torch.ones(N),
        torch.full((N,), 3, dtype=torch.int32), torch.ones(N),
    )
    freq = torch.bincount(draws.long(), minlength=5).float() / N
    expect = torch.softmax(torch.tensor([2.0, 1.0, 0.0]), -1)
    assert freq[3:].sum() == 0  # top_k=3 removed the tail
    torch.testing.assert_close(freq[:3], expect, atol=0.015, rtol=0)
