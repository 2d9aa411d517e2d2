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


# --------------------------------------------------------------------------- #
# speculative acceptance
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(4))
def test_greedy_spec_accept_matches_reference(seed):
    """Greedy acceptance is exact match against the argmax: the port's
    outputs equal the reference's, tokens and emitted counts alike."""
    rng = np.random.default_rng(200 + seed)
    B, S, V = 6, 5, 16
    logits = rng.standard_normal((B, S, V)).astype(np.float32)
    greedy = logits.argmax(-1).astype(np.int32)
    # drafts that follow the argmax for a random prefix, then deviate
    drafts = greedy[:, : S - 1].copy()
    for b in range(B):
        cut = rng.integers(0, S)
        drafts[b, cut:] = (drafts[b, cut:] + 1 + rng.integers(0, V - 1, S - 1 - cut)) % V
    ndraft = rng.integers(0, S, B).astype(np.int32)
    base = rng.integers(0, 50, B).astype(np.int32)
    zeros_f, zeros_i, ones = np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32)
    ref = JS.spec_accept_slots(
        j(logits), j(drafts), j(ndraft), j(base), jax.random.split(jax.random.key(0), B),
        j(zeros_f), j(zeros_i), j(ones), sampled=False,
    )
    for sampled in (False, True):  # a sampled batch treats greedy rows the same
        out = TS.spec_accept_slots(
            t(logits), t(drafts), t(ndraft), t(base), torch.arange(B), t(zeros_f),
            t(zeros_i), t(ones), sampled=sampled,
        )
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(n(a), n(b))


def _spec_rows(row_logits, drafts_row, temp, N, seed=1):
    S, V = row_logits.shape
    return TS.spec_accept_slots(
        row_logits.expand(N, S, V), torch.tensor(drafts_row, dtype=torch.int32).expand(N, S - 1),
        torch.full((N,), S - 1, dtype=torch.int32), torch.zeros(N, dtype=torch.int32),
        torch.arange(N) + seed * N, torch.full((N,), temp), torch.zeros(N, dtype=torch.int32),
        torch.ones(N),
    )


def test_sampled_spec_marginal_matches_target():
    """Rejection sampling keeps the target distribution: over many seeds the
    first emitted token follows p, and after an accepted draft so does the
    second."""
    V, temp, N = 8, 0.8, 20000
    row = torch.randn((2, V), generator=torch.Generator().manual_seed(3)) * 1.5
    p = torch.softmax(TS.filtered_logits(
        row, torch.full((2,), temp), torch.zeros(2, dtype=torch.int32), torch.ones(2)
    ), -1)
    d0 = int(p[0].argmax())
    out, emitted = _spec_rows(row, [d0], temp, N)
    emp0 = torch.bincount(out[:, 0].long(), minlength=V).float() / N
    torch.testing.assert_close(emp0, p[0], atol=0.015, rtol=0)
    acc = out[out[:, 0] == d0]
    assert len(acc) > N * float(p[0][d0]) * 0.9
    emp1 = torch.bincount(acc[:, 1].long(), minlength=V).float() / len(acc)
    torch.testing.assert_close(emp1, p[1], atol=0.02, rtol=0)
    # a rejected point-mass draft is never the correction
    rejected = out[emitted == 1]
    assert len(rejected) > 0 and not (rejected[:, 0] == d0).any()


def test_undrafted_correction_is_the_spec_off_draw():
    """With nothing drafted, the verify emits exactly the token
    ``sample_slots`` draws at that position from the same seed, so a
    seeded stream does not depend on whether a drafter found anything."""
    B, V = 64, 50
    logits = torch.randn((B, 1, V), generator=torch.Generator().manual_seed(4))
    seeds, base = torch.arange(B) * 7 + 3, torch.arange(B, dtype=torch.int32) + 10
    temp, top_k, top_p = torch.full((B,), 0.9), torch.full((B,), 20, dtype=torch.int32), torch.full((B,), 0.95)
    out, emitted = TS.spec_accept_slots(
        logits, torch.zeros((B, 0), dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
        base, seeds, temp, top_k, top_p,
    )
    plain = TS.sample_slots(logits[:, 0], TS.fold_in(seeds, base + 1), temp, top_k, top_p)
    assert torch.equal(emitted, torch.ones(B, dtype=torch.int32))
    assert torch.equal(out[:, 0], plain)
