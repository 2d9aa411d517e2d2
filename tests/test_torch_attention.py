"""The PyTorch port's attention against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version; the Pallas kernels run in
interpret mode, as the JAX package's own tests run them.  Inputs are numpy
arrays from a seed, handed to both.  Tolerances are f32 ``atol=rtol=1e-5``:
both sides compute the same f32 expressions and differ only in the order of
the sums (over at most a few hundred terms of magnitude ~1), which moves
results by a few f32 ulps.

The hand-written kernels are held against these plain versions on the card
in ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from calfkit_tpu.inference.pallas_attention import (  # noqa: E402
    decode_attention_pallas,
    merged_decode_attention_pallas,
    merged_paged_decode_attention_pallas,
    paged_decode_attention_pallas,
    prefill_attention_pallas,
)
from calfkit_tpu_torch.inference import attention as A  # noqa: E402
from calfkit_tpu_torch.inference import ragged as RG  # noqa: E402
from tests._torch_port import j, n, t  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _decode_inputs(B, K, G, W, hd, lens, seed=0, T=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        q=f(B, K, G, hd), k=f(B, K, W, hd), v=f(B, K, W, hd),
        rk=f(T, B, K, hd), rv=f(T, B, K, hd), lens=np.asarray(lens, np.int32),
    )


@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_plain_matches_pallas(G):
    x = _decode_inputs(B=3, K=2, G=G, W=40, hd=16, lens=[0, 7, 40], seed=G)
    ref = decode_attention_pallas(
        j(x["q"]), j(x["k"]), j(x["v"]), j(x["lens"]), interpret=True
    )
    out = A.decode_attention(t(x["q"]), t(x["k"]), t(x["v"]), t(x["lens"]))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), n(b), **TOL)
    # the fresh row (len 0): nothing attended, the -1e29 floor, z = 0
    assert np.all(n(out[1])[0] == -1e29) and np.all(n(out[2])[0] == 0.0)


@pytest.mark.parametrize("step", [0, 2, 3])
def test_merged_decode_matches_pallas(step):
    B, K, G, hd = 3, 2, 2, 16
    x = _decode_inputs(B, K, G, W=32, hd=hd, lens=[0, 9, 31], seed=10 + step)
    q = x["q"].reshape(B, 1, K * G, hd)
    ref = merged_decode_attention_pallas(
        j(q), j(x["k"]), j(x["v"]), j(x["rk"]), j(x["rv"]), j(x["lens"]),
        jnp.int32(step), interpret=True,
    )
    out = A.merged_decode_attention(
        t(q), t(x["k"]), t(x["v"]), t(x["rk"]), t(x["rv"]), t(x["lens"]), step
    )
    np.testing.assert_allclose(n(out), n(ref), **TOL)


def _prefill_inputs(B, Sq, H, K, Skv, hd, lens, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q_pos = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq))
    return dict(
        q=f(B, Sq, H, hd), k=f(B, K, Skv, hd), v=f(B, K, Skv, hd),
        q_pos=np.ascontiguousarray(q_pos), lens=np.asarray(lens, np.int32),
    )


@pytest.mark.parametrize(
    "G,Sq,Skv,lens,blocks",
    [
        (1, 24, 24, [24, 24], {}),  # Sq below one q block
        (2, 24, 40, [40, 31], {}),  # a chunk at an offset, seq_len < Skv
        (4, 64, 64, [64, 50], dict(block_q=16, kv_chunk=32)),  # many blocks
        (2, 64, 96, [96, 70], dict(block_q=32, kv_chunk=32)),
        (4, 24, 40, [40, 0], {}),  # a row that sees no position gives 0
    ],
)
def test_prefill_plain_matches_pallas(G, Sq, Skv, lens, blocks):
    K, hd = 2, 16
    x = _prefill_inputs(2, Sq, K * G, K, Skv, hd, lens, seed=Sq + Skv + G)
    ref = prefill_attention_pallas(
        j(x["q"]), j(x["k"]), j(x["v"]), j(x["q_pos"]), j(x["lens"]),
        interpret=True, **blocks,
    )
    out = A.prefill_attention(
        t(x["q"]), t(x["k"]), t(x["v"]), t(x["q_pos"]), t(x["lens"])
    )
    assert out.shape == (2, Sq, K * G, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(n(out), n(ref), **TOL)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    A.reset_launch_counts()
    x = _decode_inputs(B=2, K=1, G=2, W=8, hd=8, lens=[3, 8])
    A.decode_attention(t(x["q"]), t(x["k"]), t(x["v"]), t(x["lens"]))
    A.ragged_attention(t(x["q"])[:, :, None], t(x["k"]), t(x["v"]), t(x["lens"]), t(x["lens"]))
    assert A.launch_counts == {
        "decode_attention": 0, "paged_decode_attention": 0, "prefill_attention": 0,
        "ragged_attention": 0, "ragged_attention_paged": 0,
    }


def test_no_kernel_for_other_devices():
    q = torch.zeros((1, 1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        A.decode_attention(q, q, q, torch.zeros((1,), device="meta"))


def test_strided_window_view_is_read_in_place():
    """The engine hands the kernels a [:, :, :W] view of its cache; the
    wrappers take it through its strides."""
    x = _decode_inputs(B=2, K=2, G=2, W=16, hd=8, lens=[5, 12])
    big = np.zeros((2, 2, 32, 8), np.float32)
    big[:, :, :16] = x["k"]
    out = A.decode_attention(t(x["q"]), t(big)[:, :, :16], t(x["v"]), t(x["lens"]))
    ref = A.decode_attention(t(x["q"]), t(x["k"]), t(x["v"]), t(x["lens"]))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), n(b), **TOL)


def _paged_inputs(B, K, G, hd, page, n_pages, lens, wpages, pmax, seed, T=4):
    """A pool [L=2, N, K, page, hd] and block tables of shuffled, distinct
    page ids; entries past a row's pages are the trash page (0)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ids = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((B, pmax), np.int32)
    for b, n_tok in enumerate(lens):
        need = -(-n_tok // page)
        tables[b, :need] = ids[:need]
        ids = ids[need:]
    return dict(
        q=f(B, K, G, hd), pk=f(2, n_pages, K, page, hd), pv=f(2, n_pages, K, page, hd),
        rk=f(T, B, K, hd), rv=f(T, B, K, hd), tables=tables,
        lens=np.asarray(lens, np.int32), wpages=wpages,
    )


@pytest.mark.parametrize(
    "page,G,lens,wpages,pmax",
    [
        (8, 2, [0, 5, 8, 40], 5, 6),   # len 0, unaligned lens, wpages < Pmax
        (16, 4, [17, 1, 31, 48], 3, 4),
        (4, 1, [9, 0, 12, 3], 4, 8),
    ],
)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_decode_plain_matches_pallas(page, G, lens, wpages, pmax, dtype):
    x = _paged_inputs(4, 2, G, 16, page, 40, lens, wpages, pmax, seed=page * G)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    for layer in (0, 1):
        ref = paged_decode_attention_pallas(
            j(x["q"]), j(x["pk"], dtype), j(x["pv"], dtype), jnp.int32(layer),
            j(x["tables"]), j(x["lens"]), wpages=wpages, interpret=True,
        )
        out = A.paged_decode_attention(
            t(x["q"]), t(x["pk"], tdtype), t(x["pv"], tdtype), layer,
            t(x["tables"]), t(x["lens"]), wpages=wpages,
        )
        for a, b in zip(out, ref):
            np.testing.assert_allclose(n(a), n(b), **TOL)
    # the fresh row (len 0): nothing attended, the -1e29 floor, z = 0
    fresh = list(lens).index(0) if 0 in lens else None
    if fresh is not None:
        assert np.all(n(out[1])[fresh] == -1e29) and np.all(n(out[2])[fresh] == 0.0)


@pytest.mark.parametrize("step", [0, 3])
def test_merged_paged_decode_matches_pallas(step):
    B, K, G, hd = 4, 2, 2, 16
    x = _paged_inputs(B, K, G, hd, 8, 30, [0, 9, 23, 40], 5, 6, seed=20 + step)
    q = x["q"].reshape(B, 1, K * G, hd)
    ref = merged_paged_decode_attention_pallas(
        j(q), j(x["pk"]), j(x["pv"]), jnp.int32(1), j(x["tables"]), j(x["rk"]),
        j(x["rv"]), j(x["lens"]), jnp.int32(step), wpages=5, interpret=True,
    )
    out = A.merged_paged_decode_attention(
        t(q), t(x["pk"]), t(x["pv"]), 1, t(x["tables"]), t(x["rk"]), t(x["rv"]),
        t(x["lens"]), step, wpages=5,
    )
    np.testing.assert_allclose(n(out), n(ref), **TOL)


# --------------------------------------------------------------------------- #
# ragged multi-query attention and the speculative verify
# --------------------------------------------------------------------------- #


def _ragged_inputs(B, K, S, G, W, hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(B, S, K * G, hd), k=f(B, K, W, hd), v=f(B, K, W, hd),
                ck=f(S, B, K, hd), cv=f(S, B, K, hd))


# each case's rows for S queries a row: the mixed rows of
# tests/test_ragged_waves.py (a decode row, a prefill-kind row with its
# within-chunk triangle, a verify row) plus a last chunk shorter than S and
# a fresh row with nothing to attend; and verify rows alone
RAGGED_ROWS = {
    "mixed": lambda S: [
        RG.RaggedRow(RG.KIND_DECODE, start=9, q_len=1, kv_len=9),
        RG.RaggedRow(RG.KIND_PREFILL, start=9, q_len=S, kv_len=9 + S),
        RG.RaggedRow(RG.KIND_PREFILL, start=4, q_len=5, kv_len=9),
        RG.RaggedRow(RG.KIND_VERIFY, start=12, q_len=S, kv_len=12),
        RG.RaggedRow(RG.KIND_DECODE, start=0, q_len=1, kv_len=0),
    ],
    "verify": lambda S: [
        RG.RaggedRow(RG.KIND_VERIFY, start=n, q_len=S, kv_len=n) for n in (0, 7, 12, 31)
    ],
}


def _descriptors(rows):
    """(q_starts, kv_lens) of ``rows`` as int32 arrays."""
    starts, _, kv_lens = RG.build_descriptors(rows)
    return np.asarray(starts, np.int32), np.asarray(kv_lens, np.int32)


@pytest.mark.parametrize("rows", list(RAGGED_ROWS))
@pytest.mark.parametrize("S,G", [(4, 2), (5, 4), (16, 4)])  # S*G 8, 20, 64
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ragged_plain_matches_pallas(rows, S, G, dtype):
    from calfkit_tpu.inference.pallas_attention import ragged_attention_pallas

    starts, lens = _descriptors(RAGGED_ROWS[rows](S))
    B, K, W, hd = len(starts), 2, 32, 16
    x = _ragged_inputs(B, K, S, G, W, hd, seed=S * G)
    qg = np.ascontiguousarray(x["q"].reshape(B, S, K, G, hd).transpose(0, 2, 1, 3, 4))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    ref = ragged_attention_pallas(
        j(qg), j(x["k"], dtype), j(x["v"], dtype), j(starts), j(lens), interpret=True
    )
    out = A.ragged_attention(t(qg), t(x["k"], tdtype), t(x["v"], tdtype), t(starts), t(lens))
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), n(b), **TOL)
    fresh = list(lens).index(0)  # nothing attended: the -1e29 floor, z = 0, o = 0
    assert np.all(n(out[1])[fresh] == -1e29) and np.all(n(out[2])[fresh] == 0.0)
    assert np.all(n(out[0])[fresh] == 0.0)


@pytest.mark.parametrize("page,S,G", [(8, 4, 4), (4, 5, 2), (8, 16, 4)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ragged_paged_plain_matches_pallas(page, S, G, dtype):
    from calfkit_tpu.inference.pallas_attention import ragged_attention_paged_pallas

    B, K, hd, wpages, pmax = 4, 2, 16, 4, 6
    starts, lens = _descriptors([
        RG.RaggedRow(RG.KIND_VERIFY, start=7, q_len=S, kv_len=7),
        RG.RaggedRow(RG.KIND_PREFILL, start=12, q_len=S, kv_len=12 + S),
        RG.RaggedRow(RG.KIND_DECODE, start=0, q_len=1, kv_len=0),  # fresh
        RG.RaggedRow(RG.KIND_VERIFY, start=20, q_len=S, kv_len=20),
    ])
    x = _paged_inputs(B, K, G, hd, page, 30, list(lens), wpages, pmax, seed=page + S)
    q = np.random.default_rng(S).standard_normal((B, K, S, G, hd)).astype(np.float32)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    for layer in (0, 1):
        ref = ragged_attention_paged_pallas(
            j(q), j(x["pk"], dtype), j(x["pv"], dtype), jnp.int32(layer), j(x["tables"]),
            j(starts), j(lens), wpages=wpages, interpret=True,
        )
        out = A.ragged_attention_paged(
            t(q), t(x["pk"], tdtype), t(x["pv"], tdtype), layer, t(x["tables"]),
            t(starts), t(lens), wpages=wpages,
        )
        for a, b in zip(out, ref):
            np.testing.assert_allclose(n(a), n(b), **TOL)


@pytest.mark.parametrize("S", [1, 5])
def test_verify_attention_matches_pallas(S):
    from calfkit_tpu.inference.pallas_attention import verify_attention_pallas

    B, K, G, W, hd = 3, 2, 4, 32, 16
    x = _ragged_inputs(B, K, S, G, W, hd, seed=40 + S)
    base = np.asarray([7, 0, 25], np.int32)
    args = (x["q"], x["k"], x["v"], x["ck"], x["cv"], base)
    ref = verify_attention_pallas(*map(j, args), interpret=True)
    out = A.verify_attention(*map(t, args))
    np.testing.assert_allclose(n(out), n(ref), **TOL)


@pytest.mark.parametrize("S", [1, 4])
def test_verify_attention_paged_matches_pallas(S):
    from calfkit_tpu.inference.pallas_attention import verify_attention_paged_pallas

    B, K, G, hd, page, wpages = 4, 2, 2, 16, 8, 5
    x = _paged_inputs(B, K, G, hd, page, 30, [0, 9, 23, 40], wpages, 6, seed=50 + S)
    c = _ragged_inputs(B, K, S, G, 8, hd, seed=60 + S)
    lens = x["lens"]
    ref = verify_attention_paged_pallas(
        j(c["q"]), j(x["pk"]), j(x["pv"]), jnp.int32(1), j(x["tables"]), j(c["ck"]),
        j(c["cv"]), j(lens), wpages=wpages, interpret=True,
    )
    out = A.verify_attention_paged(
        t(c["q"]), t(x["pk"]), t(x["pv"]), 1, t(x["tables"]), t(c["ck"]), t(c["cv"]),
        t(lens), wpages=wpages,
    )
    np.testing.assert_allclose(n(out), n(ref), **TOL)


# --------------------------------------------------------------------------- #
# the split-window law of the decode and ragged kernels
# --------------------------------------------------------------------------- #
#
# The kernels cut the window into splits of whole tiles, one block each; a
# split computes the plain (o, m, z) of its positions alone, and the last
# split to finish folds them in split order.  Here each split's (o, m, z)
# comes from the plain version on the window's slice, folded in index order
# as the kernels fold, and the fold is held against the Pallas kernel on
# the whole window.  Tolerance: f32 sum order (TOL), since the fold only
# regroups the sums.


def _fold_splits(parts):
    """Fold split partials [(o, m, z)] in index order: m = max m_i (the
    -1e29 floor included), w_i = exp(m_i - m), o = sum w_i o_i, z = sum
    w_i z_i."""
    m = torch.full_like(parts[0][1], -1e29)
    for _, mi, _ in parts:
        m = torch.maximum(m, mi)
    o, z = torch.zeros_like(parts[0][0]), torch.zeros_like(parts[0][2])
    for oi, mi, zi in parts:
        w = torch.exp(mi - m)
        o = o + w[..., None] * oi
        z = z + w * zi
    return o, m, z


def _split_slices(W, split):
    return [(lo, min(W, lo + split)) for lo in range(0, W, split)]


# lens on, and one either side of, the split boundaries; a fresh row (all
# splits past its stop) and a full one
SPLIT_LENS = [0, 15, 16, 17, 31, 33, 48]


def _walk_cuts(unit_tiles, tile, W):
    """The paged walk's segments of each unit, as window slices [lo, hi),
    in segment order: the plan of :func:`A.walk_plan` with chunks of one or
    two tiles, so a unit of more than one tile is cut, at varying places."""
    cuts: dict[int, tuple[int, list]] = {}
    blocks = max(2, 2 * sum(unit_tiles) // 3)
    for segments in A.walk_plan(unit_tiles, blocks, min_tiles=1):
        for u, t_lo, t_hi, _, n_seg in segments:
            cuts.setdefault(u, (n_seg, []))[1].append((t_lo * tile, min(W, t_hi * tile)))
    assert all(len(slices) == n_seg for n_seg, slices in cuts.values())
    return {u: slices for u, (_, slices) in cuts.items()}


def _fold_cuts(cuts, unit_rows, partial):
    """Fold each unit's segment partials in segment order: ``partial(lo,
    hi)`` gives the plain (o, m, z) of window slice [lo, hi) for the whole
    batch; ``unit_rows(u)`` indexes unit u's rows in it → {u: (o, m, z)}."""
    cache: dict = {}
    out = {}
    for u, slices in cuts.items():
        parts = []
        for lo, hi in slices:
            if (lo, hi) not in cache:
                cache[lo, hi] = partial(lo, hi)
            parts.append(tuple(x[unit_rows(u)] for x in cache[lo, hi]))
        out[u] = _fold_splits(parts)
    return out


@pytest.mark.parametrize("split", [8, 16, 48])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("cut", ["splits", "walk"])
def test_split_fold_matches_pallas_decode(split, G, cut):
    """``splits``: the window cut into splits of ``split`` positions, as the
    split grid cuts it; ``walk``: each (row, kv head) cut where the paged
    walk's chunks cut it, tiles of ``split`` positions, cuts inside a row."""
    B, K, W, hd = len(SPLIT_LENS), 2, 48, 16
    x = _decode_inputs(B, K, G, W, hd, lens=SPLIT_LENS, seed=split + G)
    lens = np.asarray(SPLIT_LENS, np.int32)

    def partial(lo, hi):
        return A.decode_attention_reference(
            t(x["q"]), t(x["k"][:, :, lo:hi]), t(x["v"][:, :, lo:hi]),
            t(np.clip(lens - lo, 0, hi - lo).astype(np.int32)),
        )

    ref = decode_attention_pallas(j(x["q"]), j(x["k"]), j(x["v"]), j(lens), interpret=True)
    if cut == "splits":
        out = _fold_splits([partial(lo, hi) for lo, hi in _split_slices(W, split)])
    else:
        tiles = A.walk_unit_tiles(list(SPLIT_LENS), list(SPLIT_LENS), K, 1, G, 16, W, tile=split)
        cuts = _walk_cuts(tiles, split, W)
        # a row cut across chunks, where a row has more than one tile
        assert any(len(c) > 1 for c in cuts.values()) or max(tiles) == 1
        folded = _fold_cuts(cuts, lambda u: (u // K, u % K), partial)
        out = [torch.stack([torch.stack([folded[b * K + k][i] for k in range(K)])
                            for b in range(B)]) for i in range(3)]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), n(b), **TOL)
    # the fresh row: every split empty, the fold keeps o = 0, m = -1e29, z = 0
    assert np.all(n(out[0])[0] == 0) and np.all(n(out[1])[0] == -1e29)
    assert np.all(n(out[2])[0] == 0)


@pytest.mark.parametrize("rows", list(RAGGED_ROWS) + ["split_edges"])
@pytest.mark.parametrize("split", [8, 16])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("cut", ["splits", "walk"])
def test_split_fold_matches_pallas_ragged(rows, split, dtype, cut):
    """As the decode fold test; the walk's units are query tiles of 16 of
    the S*G = 20 rows, so a row's two tiles see different stops."""
    from calfkit_tpu.inference.pallas_attention import ragged_attention_pallas

    S, G = 5, 4
    if rows == "split_edges":  # prefill-kind rows ending mid-split, verify rows at the edges
        descr = [
            RG.RaggedRow(RG.KIND_PREFILL, start=10, q_len=S, kv_len=10 + S),
            RG.RaggedRow(RG.KIND_PREFILL, start=0, q_len=S, kv_len=3),
            RG.RaggedRow(RG.KIND_VERIFY, start=16, q_len=S, kv_len=16),
            RG.RaggedRow(RG.KIND_VERIFY, start=17, q_len=S, kv_len=17),
            RG.RaggedRow(RG.KIND_DECODE, start=0, q_len=1, kv_len=0),
        ]
    else:
        descr = RAGGED_ROWS[rows](S)
    starts, lens = _descriptors(descr)
    B, K, W, hd = len(starts), 2, 32, 16
    x = _ragged_inputs(B, K, S, G, W, hd, seed=split * S)
    qg = np.ascontiguousarray(x["q"].reshape(B, S, K, G, hd).transpose(0, 2, 1, 3, 4))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16

    def partial(lo, hi):
        return A.ragged_attention_reference(
            t(qg), t(x["k"][:, :, lo:hi], tdtype), t(x["v"][:, :, lo:hi], tdtype),
            t((starts - lo).astype(np.int32)),
            t(np.clip(lens - lo, 0, hi - lo).astype(np.int32)),
        )

    ref = ragged_attention_pallas(
        j(qg), j(x["k"], dtype), j(x["v"], dtype), j(starts), j(lens), interpret=True
    )
    if cut == "splits":
        out = _fold_splits([partial(lo, hi) for lo, hi in _split_slices(W, split)])
    else:
        rows_a_tile, qtiles = 16, 2  # S*G = 20 rows: tiles of rows 0-15 and 16-19
        tiles = A.walk_unit_tiles(list(starts), list(lens), K, S, G, rows_a_tile, W, tile=split)
        cuts = _walk_cuts(tiles, split, W)
        assert any(len(c) > 1 for c in cuts.values()) or max(tiles) == 1

        def unit_rows(u):  # unit (b, k, qt): its rows r = j * G + g of the [B, K, S*G] view
            b, k, qt = u // (K * qtiles), u // qtiles % K, u % qtiles
            r = torch.arange(qt * rows_a_tile, min(S * G, (qt + 1) * rows_a_tile))
            return b, k, r // G, r % G

        folded = _fold_cuts(cuts, unit_rows, partial)
        out = [torch.zeros_like(x_) for x_ in partial(0, W)]
        for u, res in folded.items():
            for dst, val in zip(out, res):
                dst[unit_rows(u)] = val
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), n(b), **TOL)
    fresh = list(lens).index(0)
    assert np.all(n(out[0])[fresh] == 0) and np.all(n(out[1])[fresh] == -1e29)
    assert np.all(n(out[2])[fresh] == 0)


@pytest.mark.parametrize(
    "groups,window",
    [(64, 2048), (8, 2048), (128, 2048), (64, 256), (1, 8192), (2, 64), (64, 0), (4, 100)],
)
def test_split_plan_covers_the_window_in_whole_tiles(groups, window):
    splits, split_pos = A.split_plan(groups, window, sms=132)
    assert split_pos % 64 == 0 and split_pos >= 64
    assert 1 <= splits <= 64
    assert splits * split_pos >= window > (splits - 1) * split_pos or splits == 1
    tiles = max(1, -(-window // 64))
    assert split_pos // 64 >= min(4, tiles)  # a split takes four tiles where there are four
    per = split_pos // 64
    if 4 < per < tiles and splits < 64:  # one tile less a split would pass the aim
        assert groups * -(-tiles // (per - 1)) > A._BLOCKS_PER_SM * 132


# --------------------------------------------------------------------------- #
# the paged walk's plan (csrc/paged_attention.cuh; mirrored by A.walk_plan)
# --------------------------------------------------------------------------- #


def _walk_case(case, seed):
    """(starts, lens, K, S, G, rows a block, window) of a named case."""
    rng = np.random.default_rng(seed)
    if case == "random decode":
        lens = rng.integers(0, 2049, 16)
        lens[rng.integers(0, 16, 3)] = 0
        return list(lens), list(lens), 8, 1, 4, 16, 2048
    if case == "random verify":  # S*G = 20 rows: two query tiles of 16
        lens = rng.integers(0, 2049, int(rng.integers(1, 40)))
        return list(lens), list(lens), 8, 5, 4, 16, 2048
    if case == "random prefill":  # prefill-kind rows: starts below their lens
        lens = rng.integers(0, 700, 9)
        starts = np.maximum(0, lens - rng.integers(0, 12, 9))
        return list(starts), list(lens), 4, 12, 4, 32, 640
    lens = {
        "one long, 15 empty": [2048] + [0] * 15,
        "all full": [2048] * 16,
        "one row": [2000],
        "all empty": [0] * 16,
        "one position each": [1] * 16,
        "past the window": [5000, 3, 64, 65],
    }[case]
    return lens, lens, 8, 1, 4, 16, 2048


WALK_CASES = ["random decode", "random verify", "random prefill", "one long, 15 empty",
              "all full", "one row", "all empty", "one position each", "past the window"]


@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("blocks", [264, 132, 7, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_plan_covers_every_tile_once(case, blocks, seed):
    starts, lens, K, S, G, rows, W = _walk_case(case, seed)
    tiles = A.walk_unit_tiles(starts, lens, K, S, G, rows, W)
    qtiles = -(-S * G // rows)
    assert len(tiles) == len(lens) * K * qtiles
    plan = A.walk_plan(tiles, blocks)
    T = sum(tiles)
    # chunks: one a block at most, equal to within one tile, the least size
    # where there are tiles enough
    sizes = [sum(hi - lo for _, lo, hi, _, _ in chunk) for chunk in plan]
    assert len(plan) <= blocks and sum(sizes) == T
    assert max(sizes) - min(sizes) <= 1
    assert min(sizes) >= min(A._MIN_CHUNK_TILES, T)
    # every unit's tiles once, in order; its segments agree on their count;
    # partial ids distinct and within the bound the host sizes scratch by
    seen: dict[int, list] = {}
    ids = set()
    for chunk in plan:
        for u, lo, hi, pid, n_seg in chunk:
            seen.setdefault(u, []).append((lo, hi, n_seg))
            assert pid not in ids and pid < A.walk_scratch(len(tiles), blocks)
            ids.add(pid)
    assert sorted(seen) == list(range(len(tiles)))
    for u, segments in seen.items():
        assert segments[0][0] == 0 and segments[-1][1] == tiles[u]
        assert all(a[1] == b[0] for a, b in zip(segments, segments[1:]))
        # one writer: a lone segment writes, or the last of n_seg folds
        assert all(n_seg == len(segments) for _, _, n_seg in segments)
    # a unit that sees nothing has one tile and so exactly one writer
    for b, (st, n) in enumerate(zip(starts, lens)):
        if min(n, W) <= 0 or st + S <= 0:
            for u in range(b * K * qtiles, (b + 1) * K * qtiles):
                assert tiles[u] == 1 and len(seen[u]) == 1


@pytest.mark.parametrize("rows", [16, 32])
def test_walk_unit_tiles_follow_the_stop_of_each_query_tile(rows):
    # S*G = 20: with 16 rows a block, tile 0 holds queries 0-3, tile 1 query 4
    starts, lens = [100, 0, 64], [104, 0, 2000]
    tiles = A.walk_unit_tiles(starts, lens, 2, 5, 4, rows, 2048)
    if rows == 16:  # stops: row 0 104, 104; row 1 0, 0; row 2 68, 69
        assert tiles == [2, 2] * 2 + [1, 1] * 2 + [2, 2] * 2
    else:
        assert tiles == [2] * 2 + [1] * 2 + [2] * 2
