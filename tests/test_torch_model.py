"""The PyTorch port's model math against ``calfkit_tpu.inference.model``.

Both packages run the ``debug`` preset on the same f32 weights (converted
with ``params_from_numpy``) and the same numpy inputs.  Logits and computed
K/V agree to 2e-4: the two compute the same f32 products through a few
layers of matmuls summed in different orders.  Pure data movement
(``consolidate_ring``, ``_insert_chunk``) must agree exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from calfkit_tpu.inference import model as JM  # noqa: E402
from calfkit_tpu_torch.inference import model as TM  # noqa: E402
from calfkit_tpu_torch.inference.weights import params_from_numpy  # noqa: E402
from tests._torch_port import (  # noqa: E402
    JAX_CFG, TORCH_CFG, j, jax_params, n, t, torch_params,
)

TOL = dict(atol=2e-4, rtol=2e-4)
B, SMAX = 2, 64


@pytest.fixture(scope="module")
def both():
    p = jax_params()
    return p, torch_params(p)


def _prompt_inputs(S=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, JAX_CFG.vocab_size, (B, S), dtype=np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return tokens, positions, np.full((B,), S, np.int32)


def _prefill_both(both, attn_impl="auto"):
    jp, tp = both
    tokens, positions, lens = _prompt_inputs()
    jl, (jk, jv) = JM.forward(
        jp, JAX_CFG, j(tokens), j(positions),
        JM.make_empty_cache(JAX_CFG, B, SMAX, jnp.float32), j(lens),
    )
    cache = TM.make_empty_cache(TORCH_CFG, B, SMAX, torch.float32, device="cpu")
    tl, (tk, tv) = TM.forward(
        tp, TORCH_CFG, t(tokens), t(positions), cache, t(lens), attn_impl=attn_impl
    )
    return (jl, jk, jv), (tl, tk, tv)


@pytest.mark.parametrize("attn_impl", ["auto", "plain"])
def test_forward_logits_and_cache_match(both, attn_impl):
    (jl, jk, jv), (tl, tk, tv) = _prefill_both(both, attn_impl)
    np.testing.assert_allclose(n(tl), n(jl), **TOL)
    np.testing.assert_allclose(n(tk), n(jk), **TOL)
    np.testing.assert_allclose(n(tv), n(jv), **TOL)


def test_forward_chunk_at_offset(both):
    """A second chunk at explicit per-row offsets (insert_at) attends the
    first chunk's cache."""
    jp, tp = both
    rng = np.random.default_rng(3)
    first = rng.integers(0, JAX_CFG.vocab_size, (B, 16), dtype=np.int32)
    second = rng.integers(0, JAX_CFG.vocab_size, (B, 8), dtype=np.int32)
    pos1 = np.broadcast_to(np.arange(16, dtype=np.int32), (B, 16)).copy()
    pos2 = np.broadcast_to(np.arange(16, 24, dtype=np.int32), (B, 8)).copy()
    jc = JM.make_empty_cache(JAX_CFG, B, SMAX, jnp.float32)
    tc = TM.make_empty_cache(TORCH_CFG, B, SMAX, torch.float32, device="cpu")
    _, jc = JM.forward(jp, JAX_CFG, j(first), j(pos1), jc, j(np.full(B, 16, np.int32)))
    TM.forward(tp, TORCH_CFG, t(first), t(pos1), tc, t(np.full(B, 16, np.int32)))
    at = np.full(B, 16, np.int32)
    lens = np.full(B, 24, np.int32)
    jl, jc = JM.forward(jp, JAX_CFG, j(second), j(pos2), jc, j(lens), insert_at=j(at))
    tl, tc = TM.forward(tp, TORCH_CFG, t(second), t(pos2), tc, t(lens), insert_at=t(at))
    np.testing.assert_allclose(n(tl), n(jl), **TOL)
    np.testing.assert_allclose(n(tc[0]), n(jc[0]), **TOL)


def test_decode_step_ring_and_consolidation(both):
    jp, tp = both
    (_, jk, jv), _ = _prefill_both(both)
    base = np.array([24, 17], np.int32)  # row 1 decodes over a shorter prefix
    k0, v0 = np.asarray(jk), np.asarray(jv)
    L, T, K, hd = JAX_CFG.n_layers, 3, JAX_CFG.n_kv_heads, JAX_CFG.head_dim
    jring = (jnp.zeros((L, T, B, K, hd)), jnp.zeros((L, T, B, K, hd)))
    tring = (torch.zeros((L, T, B, K, hd)), torch.zeros((L, T, B, K, hd)))
    tok = np.array([[5], [9]], np.int32)
    for step in range(T):
        jl, jring = JM.decode_step_ring(
            jp, JAX_CFG, j(tok), (j(k0), j(v0)), jring, jnp.int32(step), j(base),
            attn_window=32,
        )
        tl, tring = TM.decode_step_ring(
            tp, TORCH_CFG, t(tok), (t(k0), t(v0)), tring, step, t(base),
            attn_window=32,
        )
        np.testing.assert_allclose(n(tl), n(jl), **TOL)
        np.testing.assert_allclose(n(tring[0]), n(jring[0]), **TOL)
        tok = np.argmax(n(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    # consolidation is data movement: on the SAME ring it must be exact
    ring_np = (np.asarray(jring[0]), np.asarray(jring[1]))
    jk2, jv2 = JM.consolidate_ring((j(k0), j(v0)), (j(ring_np[0]), j(ring_np[1])), j(base))
    tk2, tv2 = t(k0), t(v0)
    TM.consolidate_ring((tk2, tv2), (t(ring_np[0]), t(ring_np[1])), t(base))
    np.testing.assert_array_equal(n(tk2), n(jk2))
    np.testing.assert_array_equal(n(tv2), n(jv2))


@pytest.mark.parametrize("offsets", [[0, 5], [60, 3]])  # 60: clamps like JAX
def test_insert_chunk_exact(offsets):
    rng = np.random.default_rng(7)
    cache = rng.standard_normal((B, 2, SMAX, 8)).astype(np.float32)
    chunk = rng.standard_normal((B, 6, 2, 8)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    ref = JM._insert_chunk(j(cache), j(chunk), j(off))
    out = TM._insert_chunk(t(cache), t(chunk), t(off))
    np.testing.assert_array_equal(n(out), n(ref))


def test_rope_and_rms_norm_match():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 200, (2, 5)).astype(np.int32)
    for a, b in zip(
        TM.rope_tables(t(pos), 16, 10000.0), JM.rope_tables(j(pos), 16, 10000.0)
    ):
        np.testing.assert_allclose(n(a), n(b), atol=1e-5, rtol=1e-5)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    cos, sin = JM.rope_tables(j(pos), 16, 10000.0)
    np.testing.assert_allclose(
        n(TM.apply_rope(t(x), t(np.asarray(cos)), t(np.asarray(sin)))),
        n(JM.apply_rope(j(x), cos, sin)), atol=1e-5, rtol=1e-5,
    )
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        n(TM.rms_norm(t(x), t(w), 1e-5)), n(JM.rms_norm(j(x), j(w), 1e-5)),
        atol=1e-5, rtol=1e-5,
    )


def test_init_params_layout_matches_reference():
    g = torch.Generator().manual_seed(0)
    ours = TM.init_params(TORCH_CFG, g)
    ref = JM.init_params(JAX_CFG, jax.random.key(0))
    shapes = lambda tree: {  # noqa: E731
        k: (shapes(v) if isinstance(v, dict) else tuple(v.shape)) for k, v in tree.items()
    }
    assert shapes(ours) == shapes(ref)
    assert ours["embed"].dtype == torch.bfloat16  # the preset's dtype


def test_decoder_module_owns_the_params(both):
    """The module holds every tensor of the tree as a frozen parameter on
    its device, and hands the same tree back to the model functions."""
    _, tp = both
    module = TM.Decoder(tp, "cpu")
    tree = module.params()
    assert tree.keys() == tp.keys() and tree["layers"].keys() == tp["layers"].keys()
    assert all(not p.requires_grad and p.device.type == "cpu" for p in module.parameters())
    assert len(list(module.parameters())) == len(tp) - 1 + len(tp["layers"])
    np.testing.assert_array_equal(n(tree["layers"]["wq"]), n(tp["layers"]["wq"]))
    (_, jk, _), (_, tk, _) = _prefill_both((both[0], tree))
    np.testing.assert_allclose(n(tk), n(jk), **TOL)


def test_params_from_numpy_keeps_bfloat16_bits():
    ref = JM.init_params(JAX_CFG, jax.random.key(1))  # bf16 leaves
    tree = jax.tree.map(np.asarray, ref)
    ours = params_from_numpy(tree, device="cpu")
    assert ours["layers"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ours["layers"]["wq"].float().numpy(),
        np.asarray(ref["layers"]["wq"], np.float32),
    )


# --------------------------------------------------------------------------- #
# paged KV
# --------------------------------------------------------------------------- #

PAGE, NPAGES, PMAX = 8, 12, 6


def _pool_and_tables(seed=5):
    """A [L, N, K, page, hd] pool of random values and two rows' block tables
    of shuffled page ids, trash-padded."""
    rng = np.random.default_rng(seed)
    L, K, hd = JAX_CFG.n_layers, JAX_CFG.n_kv_heads, JAX_CFG.head_dim
    pool = rng.standard_normal((2, L, NPAGES, K, PAGE, hd)).astype(np.float32)
    ids = rng.permutation(np.arange(1, NPAGES))
    tables = np.zeros((B, PMAX), np.int32)
    tables[0, :4] = ids[:4]
    tables[1, :3] = ids[4:7]
    return pool, tables


def test_make_page_pool_layout():
    ours = TM.make_page_pool(TORCH_CFG, NPAGES, PAGE, device="cpu")
    ref = JM.make_page_pool(JAX_CFG, NPAGES, PAGE)
    assert tuple(ours[0].shape) == ref[0].shape and ours[0].dtype == torch.bfloat16
    assert not ours[0].any() and not ours[1].any()


@pytest.mark.parametrize("wpages", [2, 4])
def test_gather_window_paged_exact(wpages):
    pool, tables = _pool_and_tables()
    ref = JM.gather_window_paged(j(pool[0, 1]), j(tables), wpages)
    out = TM.gather_window_paged(t(pool[0, 1]), t(tables), wpages)
    np.testing.assert_array_equal(n(out), n(ref))


def test_decode_step_ring_paged_matches(both):
    jp, tp = both
    pool, tables = _pool_and_tables()
    base = np.array([29, 17], np.int32)  # row 0 spans 4 pages, row 1 three
    L, T, K, hd = JAX_CFG.n_layers, 3, JAX_CFG.n_kv_heads, JAX_CFG.head_dim
    jring = (jnp.zeros((L, T, B, K, hd)), jnp.zeros((L, T, B, K, hd)))
    tring = (torch.zeros((L, T, B, K, hd)), torch.zeros((L, T, B, K, hd)))
    tok = np.array([[5], [9]], np.int32)
    for step in range(T):
        jl, jring = JM.decode_step_ring_paged(
            jp, JAX_CFG, j(tok), (j(pool[0]), j(pool[1])), j(tables), jring,
            jnp.int32(step), j(base), wpages=4, attn_impl="pallas_interpret",
        )
        tl, tring = TM.decode_step_ring_paged(
            tp, TORCH_CFG, t(tok), (t(pool[0]), t(pool[1])), t(tables), tring,
            step, t(base), 4,
        )
        np.testing.assert_allclose(n(tl), n(jl), **TOL)
        np.testing.assert_allclose(n(tring[0]), n(jring[0]), **TOL)
        tok = np.argmax(n(jl)[:, -1], axis=-1).astype(np.int32)[:, None]


@pytest.mark.parametrize(
    "base,active",
    [
        ([29, 17], [True, True]),
        ([29, 17], [True, False]),  # the inactive row writes the trash page
        ([46, 3], [True, True]),  # row 0 overshoots Pmax * page = 48
    ],
)
def test_consolidate_ring_paged_exact(base, active):
    pool, tables = _pool_and_tables()
    rng = np.random.default_rng(9)
    L, T, K, hd = JAX_CFG.n_layers, 4, JAX_CFG.n_kv_heads, JAX_CFG.head_dim
    ring = rng.standard_normal((2, L, T, B, K, hd)).astype(np.float32)
    base, active = np.asarray(base, np.int32), np.asarray(active)
    jk, jv = JM.consolidate_ring_paged(
        (j(pool[0]), j(pool[1])), (j(ring[0]), j(ring[1])), j(tables), j(base), j(active)
    )
    tk, tv = t(pool[0]), t(pool[1])
    TM.consolidate_ring_paged((tk, tv), (t(ring[0]), t(ring[1])), t(tables), t(base), t(active))
    # every page but the trash page is exact; the trash page's content is
    # whichever duplicate write landed last, so it is not compared
    np.testing.assert_array_equal(n(tk)[:, 1:], n(jk)[:, 1:])
    np.testing.assert_array_equal(n(tv)[:, 1:], n(jv)[:, 1:])
    if not active.all():  # the inactive row's own pages are untouched
        row = tables[~active][0]
        np.testing.assert_array_equal(n(tk)[:, row[row > 0]], pool[0][:, row[row > 0]])


def test_write_prefill_pages_exact():
    pool, _ = _pool_and_tables()
    rng = np.random.default_rng(11)
    L, K, hd = JAX_CFG.n_layers, JAX_CFG.n_kv_heads, JAX_CFG.head_dim
    scratch = rng.standard_normal((2, L, B, K, 3 * PAGE, hd)).astype(np.float32)
    ids = np.array([[4, 0, 7], [2, 9, 0]], np.int32)  # 0: a reused page's write
    jk, jv = JM.write_prefill_pages(
        (j(pool[0]), j(pool[1])), (j(scratch[0]), j(scratch[1])), j(ids)
    )
    tk, tv = t(pool[0]), t(pool[1])
    TM.write_prefill_pages((tk, tv), (t(scratch[0]), t(scratch[1])), t(ids))
    np.testing.assert_array_equal(n(tk)[:, 1:], n(jk)[:, 1:])
    np.testing.assert_array_equal(n(tv)[:, 1:], n(jv)[:, 1:])


# --------------------------------------------------------------------------- #
# speculative verify
# --------------------------------------------------------------------------- #


def _verify_tokens(S, seed=13):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JAX_CFG.vocab_size, (B, S), dtype=np.int32)


@pytest.mark.parametrize("S", [1, 5])
def test_verify_step_ring_matches(both, S):
    """Logits and the chunk ring of one verify step over the dense window,
    against the reference on its Pallas lane (interpret mode)."""
    jp, tp = both
    (_, jk, jv), _ = _prefill_both(both)
    k0, v0 = np.asarray(jk)[:, :, :, :32], np.asarray(jv)[:, :, :, :32]
    base = np.array([24, 17], np.int32)
    tokens = _verify_tokens(S)
    jl, (jrk, jrv) = JM.verify_step_ring(
        jp, JAX_CFG, j(tokens), (j(k0), j(v0)), j(base), attn_impl="pallas_interpret"
    )
    tl, (trk, trv) = TM.verify_step_ring(tp, TORCH_CFG, t(tokens), (t(k0), t(v0)), t(base))
    assert tuple(trk.shape) == (JAX_CFG.n_layers, S, B, JAX_CFG.n_kv_heads, JAX_CFG.head_dim)
    np.testing.assert_allclose(n(tl), n(jl), **TOL)
    np.testing.assert_allclose(n(trk), n(jrk), **TOL)
    np.testing.assert_allclose(n(trv), n(jrv), **TOL)


@pytest.mark.parametrize("S", [1, 4])
def test_verify_step_ring_paged_matches(both, S):
    jp, tp = both
    pool, tables = _pool_and_tables()
    base = np.array([29, 17], np.int32)
    tokens = _verify_tokens(S, seed=14)
    jl, (jrk, _) = JM.verify_step_ring_paged(
        jp, JAX_CFG, j(tokens), (j(pool[0]), j(pool[1])), j(tables), j(base), wpages=4,
        attn_impl="pallas_interpret",
    )
    tl, (trk, _) = TM.verify_step_ring_paged(
        tp, TORCH_CFG, t(tokens), (t(pool[0]), t(pool[1])), t(tables), t(base), 4
    )
    np.testing.assert_allclose(n(tl), n(jl), **TOL)
    np.testing.assert_allclose(n(trk), n(jrk), **TOL)


def test_verify_chunk_source_matches():
    rng = np.random.default_rng(21)
    S, K, G, hd = 5, 2, 2, 16
    qg = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    rk = rng.standard_normal((S, B, K, hd)).astype(np.float32)
    rv = rng.standard_normal((S, B, K, hd)).astype(np.float32)
    for dtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = JM.verify_chunk_source(j(qg), j(rk, dtype), j(rv, dtype))
        out = TM.verify_chunk_source(t(qg), t(rk, tdtype), t(rv, tdtype))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(n(a), n(b), atol=1e-5, rtol=1e-5)


def test_ragged_attention_source_matches():
    rng = np.random.default_rng(22)
    S, K, G, W, hd = 4, 2, 2, 24, 16
    qg = rng.standard_normal((3, S, K, G, hd)).astype(np.float32)
    kc = rng.standard_normal((3, K, W, hd)).astype(np.float32)
    vc = rng.standard_normal((3, K, W, hd)).astype(np.float32)
    starts, lens = np.array([4, 9, 0], np.int32), np.array([9, 9 + S, 0], np.int32)
    ref = JM.ragged_attention_source(j(qg), j(kc), j(vc), j(starts), j(lens))
    out = TM.ragged_attention_source(t(qg), t(kc), t(vc), t(starts), t(lens))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), n(b), atol=1e-5, rtol=1e-5)
