"""The long-context lane's functions (``calfkit_tpu_torch/inference/ring_attention.py``)
against ``calfkit_tpu.inference.ring_attention`` on an ``sp`` mesh.

Both packages run the ``debug`` preset on the same f32 weights and the same
numpy inputs.  At sp = 1 the JAX package's functions run on
``Mesh(jax.devices()[:1], ("sp",))``; at sp = 2 and 4 the port's functions
run in sp gloo processes (``tests/_torch_ranks.py``), each rank on its
block, against the JAX package's on ``Mesh(jax.devices()[:sp], ("sp",))``;
the prefill and the decode there on every (tp, dp) mesh of the ranks.
Tolerances (f32): attention
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


# --------------------------------------------------------------------------- #
# sp > 1: each rank's block in gloo processes, against the JAX package's
# functions on Mesh(jax.devices()[:sp], ("sp",))
# --------------------------------------------------------------------------- #

SPS = (2, 4)
# the (tp, dp) meshes of the world the prefill and decode run on: the weights
# whole (tp = 1), split over tp (gathered a layer at a time for the prefill),
# and at tp = 4 the debug preset's 2 kv heads replicated and narrowed
SP_MESHES = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2), (4, 1)]}
SP_P, SP_CHUNK, SP_STEPS, SP_CAP = 48, 16, 4, 12
SP_LENS = np.asarray([48, 30], np.int32)
# name → (B, H, K, lens): G = 4 and MHA, whole and ragged rows (a row
# ending inside the first rank's block, one inside a later one)
RING_CASES = {
    "gqa4-full": (2, 8, 2, None),
    "gqa4-ragged": (3, 8, 2, [32, 19, 5]),
    "mha-ragged": (2, 4, 4, [27, 9]),
}


def _sp_inputs():
    rng = np.random.default_rng(7)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    ring = {}
    for name, (B, Hq, Kq, lens) in RING_CASES.items():
        ring[name] = (normal(B, 32, Hq, 16), normal(B, 32, Kq, 16), normal(B, 32, Kq, 16),
                      None if lens is None else np.asarray(lens, np.int32))
    context = (normal(3, 1, H, HD), normal(3, KH, 64, HD), normal(3, KH, 64, HD),
               np.asarray([64, 21, 0], np.int32))
    return dict(
        ring=ring, context=context,
        indivisible=np.zeros((1, 33), np.int32),  # divides over neither sp
        tokens=rng.integers(0, CFG.vocab_size, (2, SP_P), dtype=np.int32), lens=SP_LENS,
        chunk=SP_CHUNK, steps=SP_STEPS, cap=SP_CAP,
    )


_SP_RUNS: dict = {}


@pytest.fixture(scope="module")
def sp_runs(both):
    """sp → (the ranks' outputs in rank order, the JAX package's): one
    spawn of sp gloo processes for all of one sp's checks."""
    from tests._torch_ranks import run_ranks, sp_functions

    def get(sp):
        if sp not in _SP_RUNS:
            inputs = _sp_inputs()
            ranks = run_ranks(sp, sp_functions, jax.tree.map(np.asarray, both[0]), inputs,
                              SP_MESHES[sp])
            _SP_RUNS[sp] = ranks, _sp_reference(both[0], inputs, sp)
        return _SP_RUNS[sp]

    return get


def _sp_reference(jp, inputs, sp) -> dict:
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    ref = {}
    # jitted: the shard_map bodies run op by op otherwise (seconds a call)
    ring = jax.jit(lambda q, k, v, lens: JR.ring_attention(q, k, v, mesh, seq_lens=lens))
    for name, (q, k, v, lens) in inputs["ring"].items():
        ref["ring", name] = n(ring(j(q), j(k), j(v), None if lens is None else j(lens)))
    context = jax.jit(lambda *args: JR.context_parallel_attention(*args, mesh))
    ref["context"] = [n(x) for x in context(*(j(x) for x in inputs["context"]))]
    with pytest.raises(ValueError) as exc:
        JR.prefill_sequence_parallel(jp, JAX_CFG, j(inputs["indivisible"]), mesh)
    ref["indivisible"] = str(exc.value)
    lens = j(inputs["lens"])
    logits, prefix = JR.prefill_sequence_parallel(
        jp, JAX_CFG, j(inputs["tokens"]), mesh, seq_lens=lens)
    first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    shape = (L, 2, KH, SP_CAP, HD)
    fresh = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    last, toks = first, []
    for t0 in (0, SP_STEPS):
        got, last, fresh = JR.decode_sp_dispatch(
            jp, JAX_CFG, last, prefix, lens, fresh, jnp.int32(t0), mesh, SP_STEPS)
        toks.append(n(got))
    ref["prefill"] = dict(
        logits=n(logits), k=n(prefix[0]), v=n(prefix[1]), toks=toks, last=n(last),
        fresh=[n(f) for f in fresh],
        one_shot=n(JR.decode_with_sharded_prefix(
            jp, JAX_CFG, first, prefix, lens, mesh, 2 * SP_STEPS)),
    )
    return ref


@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("sp", SPS)
def test_sp_ring_attention_equals_reference(sp_runs, sp, case):
    """Each rank's output block of the ring, joined in rank order, equals
    the JAX ring's on the positions each row keeps."""
    ranks, ref = sp_runs(sp)
    got = np.concatenate([r["ring", case] for r in ranks], axis=1)
    want = ref["ring", case]
    lens = RING_CASES[case][3]
    B = want.shape[0]
    keep = np.arange(32)[None, :] < (np.full(B, 32) if lens is None else np.asarray(lens))[:, None]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[keep], want[keep], **TOL)


@pytest.mark.parametrize("sp", SPS)
def test_sp_indivisible_prompt_is_refused_as_the_reference(sp_runs, sp):
    """A prompt whose length does not divide over sp raises the reference's
    ValueError, on every rank."""
    ranks, ref = sp_runs(sp)
    assert "must divide" in ref["indivisible"]
    assert [r.get("indivisible") for r in ranks] == [ref["indivisible"]] * sp


@pytest.mark.parametrize("sp", SPS)
def test_sp_context_parallel_attention_equals_reference(sp_runs, sp):
    """Every rank's merged (o, m, z), from its own block of the prefix
    (rows wholly inside, across and before the blocks; a row of 0), equals
    the JAX package's replicated result."""
    ranks, ref = sp_runs(sp)
    for r in ranks:
        for a, b in zip(r["context"], ref["context"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, **TOL)


def _mesh_cases():
    return [(sp, mesh) for sp in SPS for mesh in SP_MESHES[sp]]


def _mesh_id(case):
    sp, (tp, dp) = case
    return f"sp{sp}-tp{tp}xdp{dp}"


def _keep_blocks(ranks, name):
    """The ranks' K or V blocks joined along the sequence → [L, B, K, P,
    hd]."""
    return np.concatenate([r[name] for r in ranks], axis=3)


def _assert_kv(got, want):
    keep = np.arange(SP_P)[None, :] < SP_LENS[:, None]  # [B, P]
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got.transpose(1, 3, 0, 2, 4)[keep], want.transpose(1, 3, 0, 2, 4)[keep], **TOL)


@pytest.mark.parametrize("case", _mesh_cases(), ids=_mesh_id)
def test_sp_prefill_sequence_parallel_equals_reference(sp_runs, case):
    """The monolithic prefill: the last valid logits on every rank, and
    each rank's K/V block (every kv head) equal to the reference's shard."""
    sp, (tp, dp) = case
    ranks, ref = sp_runs(sp)
    want = ref["prefill"]
    outs = [r["mesh", tp, dp] for r in ranks]
    for o in outs:
        np.testing.assert_allclose(o["logits"], want["logits"], **TOL)
        assert o["k"].shape == (L, 2, KH, SP_P // sp, HD)
    for side in ("k", "v"):
        _assert_kv(_keep_blocks(outs, side), want[side])


@pytest.mark.parametrize("case", _mesh_cases(), ids=_mesh_id)
def test_sp_chunked_prefill_equals_monolithic_reference(sp_runs, case):
    """The chunked long prefill at sp > 1 (chunks of 16 over blocks of 24
    or 12: chunks that straddle two ranks' blocks): each row's logits at
    its last position, and the scratch blocks, equal the reference's
    monolithic prefill."""
    sp, (tp, dp) = case
    ranks, ref = sp_runs(sp)
    want = ref["prefill"]
    outs = [r["mesh", tp, dp] for r in ranks]
    for o in outs:
        np.testing.assert_allclose(o["chunked"], want["logits"], **TOL)
    _assert_kv(_keep_blocks(outs, "chunk_k"), want["k"])
    _assert_kv(_keep_blocks(outs, "chunk_v"), want["v"])


@pytest.mark.parametrize("case", _mesh_cases(), ids=_mesh_id)
def test_sp_decode_dispatches_carry_as_reference(sp_runs, case):
    """Two dispatches of 4 steps carried (t0 = 0, then 4 on the first's
    fresh cache and last token): every rank's greedy tokens and last token
    equal the reference's, and its fresh cache equals the reference's at
    the rank's kv heads; the one-shot decode too."""
    sp, (tp, dp) = case
    ranks, ref = sp_runs(sp)
    want = ref["prefill"]
    for o in ranks:
        o = o["mesh", tp, dp]
        assert [x.tolist() for x in o["toks"]] == [x.tolist() for x in want["toks"]]
        assert o["last"].tolist() == want["last"].tolist()
        assert o["one_shot"].tolist() == want["one_shot"].tolist()
        lo, cnt = o["kv"]
        for a, b in zip(o["fresh"], want["fresh"]):
            np.testing.assert_allclose(a, b[:, :, lo:lo + cnt], **TOL)
        assert not o["fresh"][0][:, :, :, 2 * SP_STEPS:].any()
