"""The long-context lane's functions (``calfkit_tpu_torch/inference/ring_attention.py``)
against ``calfkit_tpu.inference.ring_attention`` on a one-device ``sp`` mesh.

Both packages run the ``debug`` preset on the same f32 weights and the same
numpy inputs; the JAX package's functions run on ``Mesh(jax.devices()[:1],
("sp",))``, the sp = 1 ring the port serves.  Tolerances (f32): attention
outputs, logits, K/V and the (o, m, z) source agree to ``atol=rtol=1e-5``
(the same f32 products summed in different orders); greedy tokens, the
carried last token and every fresh-cache slot a dispatch did not write are
equal exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from calfkit_tpu.inference import ring_attention as JR  # noqa: E402
from calfkit_tpu_torch.inference import attention as A  # noqa: E402
from calfkit_tpu_torch.inference import ring_attention as TR  # noqa: E402
from tests._torch_port import JAX_CFG, TORCH_CFG, j, jax_params, n, t, torch_params  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = TORCH_CFG
L, KH, HD = CFG.n_layers, CFG.n_kv_heads, CFG.head_dim
H = CFG.n_heads


@pytest.fixture(scope="module")
def both():
    p = jax_params()
    return p, torch_params(p)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("sp",))


def _qkv(B, S, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, HD)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("lens", [None, [40, 17, 1]], ids=["full", "ragged"])
def test_ring_attention_equals_reference(mesh, lens):
    """The ring at sp = 1 and the plain single-device reference, each
    against the JAX package's, on the positions each row keeps (a row's
    positions past its length are garbage in both)."""
    B, S = 3, 40
    q, k, v = _qkv(B, S, 0)
    seq = None if lens is None else np.asarray(lens, np.int32)
    want = JR.ring_attention(j(q), j(k), j(v), mesh, seq_lens=None if seq is None else j(seq))
    plain_want = JR.single_device_causal_attention(
        j(q), j(k), j(v), None if seq is None else j(seq)
    )
    got = TR.ring_attention(t(q), t(k), t(v), None if seq is None else t(seq))
    plain = TR.single_device_causal_attention(t(q), t(k), t(v), None if seq is None else t(seq))
    keep = np.arange(S)[None, :] < (np.full(B, S) if seq is None else seq)[:, None]
    np.testing.assert_allclose(n(got)[keep], n(want)[keep], **TOL)
    np.testing.assert_allclose(n(plain)[keep], n(plain_want)[keep], **TOL)
    np.testing.assert_allclose(n(got)[keep], n(plain)[keep], **TOL)


def test_ring_attention_goes_through_the_prefill_wrapper(monkeypatch):
    """On a card the ring is kernel #5: the port's ring calls
    ``attention.prefill_attention`` with ``q_pos = arange(S)``."""
    calls = []
    inner = A.prefill_attention

    def spy(q, k, v, q_pos, seq_lens):
        calls.append((tuple(q.shape), tuple(k.shape), q_pos.tolist()))
        return inner(q, k, v, q_pos, seq_lens)

    monkeypatch.setattr(A, "prefill_attention", spy)
    q, k, v = _qkv(2, 8, 1)
    TR.ring_attention(t(q), t(k), t(v))
    assert calls == [((2, 8, H, HD), (2, KH, 8, HD), [list(range(8))] * 2)]


@pytest.mark.parametrize("in_place", [False, True], ids=["returned", "cache"])
def test_prefill_sequence_parallel_equals_reference(both, mesh, in_place):
    """Last-valid logits and the K/V of every layer: returned, or written
    in place into the [..., :S, :] views of a longer scratch (the engine's
    graphs)."""
    jp, tp = both
    B, S = 2, 48
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, CFG.vocab_size, (B, S), dtype=np.int32)
    lens = np.asarray([48, 30], np.int32)
    jl, (jk, jv) = JR.prefill_sequence_parallel(jp, JAX_CFG, j(tokens), mesh, seq_lens=j(lens))
    cache = None
    if in_place:
        full = tuple(torch.zeros((L, B, KH, 64, HD)) for _ in range(2))
        cache = tuple(side[:, :, :, :S] for side in full)
    tl, (tk, tv) = TR.prefill_sequence_parallel(tp, CFG, t(tokens), t(lens), cache)
    np.testing.assert_allclose(n(tl), n(jl), **TOL)
    keep = np.arange(S)[None, :] < lens[:, None]  # [B, S]
    for got, want in ((tk, jk), (tv, jv)):
        assert tuple(got.shape) == (L, B, KH, S, HD)
        np.testing.assert_allclose(
            n(got).transpose(1, 3, 0, 2, 4)[keep], n(want).transpose(1, 3, 0, 2, 4)[keep], **TOL
        )
    if in_place:
        assert tk.data_ptr() == full[0].data_ptr() and not full[0][:, :, :, S:].any()


def test_context_parallel_attention_equals_reference(mesh):
    B, S = 3, 64
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    kp = rng.standard_normal((B, KH, S, HD)).astype(np.float32)
    vp = rng.standard_normal((B, KH, S, HD)).astype(np.float32)
    lens = np.asarray([64, 21, 0], np.int32)
    want = JR.context_parallel_attention(j(q), j(kp), j(vp), j(lens), mesh)
    got = TR.context_parallel_attention(t(q), t(kp), t(vp), t(lens))
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(n(a), n(b), **TOL)


def test_decode_sp_dispatch_carries_across_dispatches(both, mesh):
    """Two dispatches of 4 steps against a prefilled prefix, the second at
    t0 = 4 on the first's fresh cache and last token: the same greedy
    tokens, the same last token, and the same fresh cache (slots past 8
    untouched zeros in both)."""
    jp, tp = both
    steps, cap = 4, 12
    rng = np.random.default_rng(4)
    S, n_valid = 64, 50
    tokens = rng.integers(0, CFG.vocab_size, (1, S), dtype=np.int32)
    lens = np.asarray([n_valid], np.int32)
    jl, jprefix = JR.prefill_sequence_parallel(jp, JAX_CFG, j(tokens), mesh, seq_lens=j(lens))
    tl, tprefix = TR.prefill_sequence_parallel(tp, CFG, t(tokens), t(lens))
    first = np.asarray([int(np.argmax(n(jl)[0]))], np.int32)
    assert int(torch.argmax(tl[0])) == first[0]
    shape = (L, 1, KH, cap, HD)
    jfresh = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    tfresh = (torch.zeros(shape), torch.zeros(shape))
    jlast, tlast = j(first), t(first)
    for t0 in (0, steps):
        jtoks, jlast, jfresh = JR.decode_sp_dispatch(
            jp, JAX_CFG, jlast, jprefix, j(lens), jfresh, jnp.int32(t0), mesh, steps
        )
        ttoks, tlast, tfresh = TR.decode_sp_dispatch(
            tp, CFG, tlast, tprefix, t(lens), tfresh, t(np.asarray([t0], np.int32)), steps
        )
        assert n(ttoks).tolist() == n(jtoks).tolist()
        assert n(tlast).tolist() == n(jlast).tolist()
        for a, b in zip(tfresh, jfresh):
            np.testing.assert_allclose(n(a), n(b), **TOL)
    assert not tfresh[0][:, :, :, 2 * steps:].any()
    one_shot = TR.decode_with_sharded_prefix(tp, CFG, t(first), tprefix, t(lens), 2 * steps)
    want = JR.decode_with_sharded_prefix(jp, JAX_CFG, j(first), jprefix, j(lens), mesh, 2 * steps)
    assert n(one_shot).tolist() == n(want).tolist()


@pytest.mark.parametrize("fn", ["ring", "prefill", "context", "decode"])
def test_sp_other_than_one_is_refused(both, fn):
    """Sharding the sequence over several cards is the multi-device slice."""
    tp = both[1]
    q, k, v = _qkv(1, 8, 5)
    calls = {
        "ring": lambda: TR.ring_attention(t(q), t(k), t(v), sp=2),
        "prefill": lambda: TR.prefill_sequence_parallel(
            tp, CFG, torch.zeros((1, 8), dtype=torch.int32), sp=4),
        "context": lambda: TR.context_parallel_attention(
            t(q[:, :1]), t(k).transpose(1, 2), t(v).transpose(1, 2),
            torch.tensor([8]), sp=2),
        "decode": lambda: TR.decode_with_sharded_prefix(
            tp, CFG, torch.zeros((1,), dtype=torch.int32),
            (torch.zeros((L, 1, KH, 8, HD)),) * 2, torch.tensor([8]), 2, sp=8),
    }
    with pytest.raises(ValueError, match="multi-device"):
        calls[fn]()
