"""The PyTorch port's hand-written CUDA kernels against their plain
versions, on the card.  These tests need a CUDA device and skip without one
(run them there with ``python -m pytest tests/test_torch_kernels_cuda.py
-m cuda``); they import neither JAX nor the JAX package, so they run where
only PyTorch is installed."""

import math

import pytest
import torch

from calfkit_tpu_torch.inference import attention as A
from calfkit_tpu_torch.inference import ragged as RG

# evaluated at test setup, not at import: every worker collects the same tests
cuda_only = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)

# f32 accumulation in both versions; the tolerances cover the sum order over
# up to a few hundred positions, plus, for a bf16 prefill, the kernel's bf16
# rounding of the probabilities (2**-9 relative each) and one bf16 rounding
# of the output (2**-8 relative)
DECODE_TOL = dict(atol=2e-5, rtol=2e-5)
PREFILL_TOL = {
    torch.float32: dict(atol=2e-5, rtol=2e-5),
    torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
}


GEOMETRIES = [(128, 4), (64, 8), (128, 1), (64, 2)]  # (hd, G)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", GEOMETRIES)
def test_decode_kernel_matches_plain(dtype, hd, G):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(hd + G)
    B, K, W = 8, 8, 256
    q = torch.randn((B, K, G, hd), generator=g, device=dev)
    cache = torch.randn((2, B, K, 512, hd), generator=g, device=dev).to(dtype)
    k, v = cache[0, :, :, :W], cache[1, :, :, :W]
    lens = torch.tensor([0, 1, 31, 32, 33, 100, 255, 256], dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, lens)
    ref = A.decode_attention_reference(q, k, v, lens)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", GEOMETRIES)
@pytest.mark.parametrize("Sq", [300, 77])  # a whole prompt; a chunk at an offset
def test_prefill_kernel_matches_plain(dtype, hd, G, Sq):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(hd * G + Sq)
    B, K, Skv = 2, 4, 300
    q = torch.randn((B, Sq, K * G, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, K, Skv, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, K, Skv, hd), generator=g, device=dev).to(dtype)
    pos = torch.arange(Skv - Sq, Skv, dtype=torch.int32, device=dev).expand(B, Sq).contiguous()
    lens = torch.tensor([Skv, 211], dtype=torch.int32, device=dev)
    out = A.prefill_attention(q, k, v, pos, lens)
    ref = A.prefill_attention_reference(q, k, v, pos, lens)
    torch.testing.assert_close(out.float(), ref.float(), **PREFILL_TOL[dtype])


def _prefill_layer_case(dev, dtype, hd, G, Sq, Skv, q_pos, lens, seed, K):
    """q [B, Sq, K*G, hd] and K/V as ``model.forward`` passes them: the
    [:, :, :Skv] window of layer 1 of a [L, B, K, S, hd] cache."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    q = torch.randn((B, Sq, K * G, hd), generator=g, device=dev).to(dtype)
    pages = torch.randn((2, 2, B, K, Skv + 96, hd), generator=g, device=dev).to(dtype)
    pos = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, pages[0, 1, :, :, :Skv], pages[1, 1, :, :, :Skv], pos, lens_t


def _check_prefill(dtype, q, k, v, pos, lens):
    """The kernel against the plain version; rows that see no position
    (seq_len 0) are finite zeros in both."""
    out = A.prefill_attention(q, k, v, pos, lens)
    ref = A.prefill_attention_reference(q, k, v, pos, lens)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), **PREFILL_TOL[dtype])
    blind = torch.minimum(pos + 1, lens[:, None]) <= 0
    assert torch.all(out[blind] == 0)


# the draft path's narrow forwards: B=16 rows of 1-8 queries over a 2048
# window, lens spread over every tile; each row's queries end at its len,
# except a fresh row (len 0: sees nothing) and two rows whose queries lie
# past their len (they see only w < len)
NARROW_LENS = [0, 17, 64, 100, 255, 511, 640, 777, 1000, 1024, 1300, 1500, 1601, 1800, 2000, 2048]


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("Sq", [1, 3, 8])
def test_prefill_kernel_narrow_launches(hd, G, Sq):
    dev = torch.device("cuda")
    q_pos = [[max(n, Sq) - Sq + j + (50 if b in (3, 9) else 0) for j in range(Sq)]
             for b, n in enumerate(NARROW_LENS)]
    case = _prefill_layer_case(dev, torch.bfloat16, hd, G, Sq, 2048, q_pos, NARROW_LENS,
                               hd + G + Sq, K=8)
    _check_prefill(torch.bfloat16, *case)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", GEOMETRIES)
def test_prefill_kernel_tile_edges(dtype, hd, G):
    """Skv = 333, not a multiple of 64; chunks at offsets 37, 0, 233 and 150,
    so the diagonal crosses tiles; row 1's len (60) is below most of its
    q_pos, row 2's reaches Skv, row 3's is 0."""
    dev = torch.device("cuda")
    Sq, Skv = 100, 333
    offsets, lens = [37, 0, 233, 150], [137, 60, 333, 0]
    q_pos = [[o + j for j in range(Sq)] for o in offsets]
    case = _prefill_layer_case(dev, dtype, hd, G, Sq, Skv, q_pos, lens, hd * G, K=4)
    _check_prefill(dtype, *case)


@pytest.mark.cuda
@cuda_only
def test_misaligned_inputs_raise_instead_of_launching():
    dev = torch.device("cuda")
    flat = torch.zeros(2 * 4 * 64 * 128 + 1, dtype=torch.bfloat16, device=dev)
    k = flat[1:].view(2, 4, 64, 128)  # 2 bytes past a 16-byte boundary
    q = torch.zeros((2, 4, 4, 128), device=dev)
    lens = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.decode_attention(q, k, k, lens)
    qp = torch.zeros((2, 64, 16, 128), dtype=torch.bfloat16, device=dev)
    pos = torch.arange(64, dtype=torch.int32, device=dev).expand(2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.prefill_attention(qp, k, k, pos, lens)


def _paged_case(dev, dtype, hd, G, page, lens, wpages, seed, K=8, n_pages=200,
                q_dtype=torch.float32, L=2):
    """An L-layer pool of random values and block tables of shuffled page
    ids (trash-padded past each row's pages, three entries past wpages); q
    in ``q_dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    q = torch.randn((B, K, G, hd), generator=g, device=dev).to(q_dtype)
    pool = torch.randn((2, L, n_pages, K, page, hd), generator=g, device=dev).to(dtype)
    ids = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    tables = torch.zeros((B, wpages + 3), dtype=torch.int32)
    used = 0
    for b, n in enumerate(lens):
        need = -(-n // page)
        tables[b, :need] = ids[used:used + need]
        used += need
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, pool[0], pool[1], tables.to(dev), lens_t


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", GEOMETRIES)
@pytest.mark.parametrize("page", [8, 16, 64])
def test_paged_decode_kernel_matches_plain(dtype, hd, G, page):
    dev = torch.device("cuda")
    wpages = 256 // page
    lens = [0, 1, 31, 64, 65, 100, 255, 256]
    q, pk, pv, tables, lens_t = _paged_case(dev, dtype, hd, G, page, lens, wpages, hd + G + page)
    for layer in (0, 1):
        out = A.paged_decode_attention(q, pk, pv, layer, tables, lens_t, wpages=wpages)
        ref = A.paged_decode_attention_reference(q, pk, pv, layer, tables, lens_t, wpages=wpages)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, **DECODE_TOL)


@pytest.mark.cuda
@cuda_only
def test_paged_decode_kernel_counts_and_refuses_bad_shapes():
    dev = torch.device("cuda")
    q, pk, pv, tables, lens_t = _paged_case(dev, torch.bfloat16, 128, 4, 64, [10, 70], 4, 1)
    A.reset_launch_counts()
    A.paged_decode_attention(q, pk, pv, 1, tables, lens_t, wpages=4)
    assert A.launch_counts["paged_decode_attention"] == 1
    with pytest.raises(ValueError, match="layer"):
        A.paged_decode_attention(q, pk, pv, 2, tables, lens_t, wpages=4)
    with pytest.raises(ValueError, match="wpages"):
        A.paged_decode_attention(q, pk, pv, 0, tables, lens_t, wpages=tables.shape[1] + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(pk.numel() + 1, dtype=pk.dtype, device=dev)
        shifted = flat[1:].view(pk.shape)
        A.paged_decode_attention(q, shifted, shifted, 0, tables, lens_t, wpages=4)


# ragged rows: verify rows (start = kv_len), prefill-kind rows (start <
# kv_len: the within-row triangle), a fresh row (kv_len = 0) and a row whose
# kv_len is past the window
def _ragged_rows(kind, S, W):
    """→ (q_starts, kv_lens) of eight rows of ``kind`` with S queries each."""
    if kind == "verify":
        rows = [RG.RaggedRow(RG.KIND_VERIFY, n, S, n) for n in (0, 1, 63, 64, 65, 200, W - 1, W)]
    else:
        starts = [0, 0, 40, 100, W - S, 5, 0, W]
        lens = [0, S, 40 + S, 100 + S, W, 5 + S // 2, S, W + 7]
        rows = [RG.RaggedRow(RG.KIND_PREFILL, st, S, n) for st, n in zip(starts, lens)]
    starts, _, kv_lens = RG.build_descriptors(rows)
    return starts, kv_lens


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", GEOMETRIES)
@pytest.mark.parametrize("kind,S", [("verify", 5), ("verify", 1), ("prefill", 20)])
def test_ragged_kernel_matches_plain(dtype, hd, G, kind, S):
    """S*G from 1 to 160 query rows: one query tile (32 rows) or several."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(hd * G + S)
    B, K, W = 8, 4, 256
    q = torch.randn((B, K, S, G, hd), generator=g, device=dev)
    cache = torch.randn((2, B, K, 384, hd), generator=g, device=dev).to(dtype)
    k, v = cache[0, :, :, :W], cache[1, :, :, :W]  # a window view, as the engine passes
    starts, lens = (torch.tensor(x, dtype=torch.int32, device=dev) for x in _ragged_rows(kind, S, W))
    out = A.ragged_attention(q, k, v, starts, lens)
    ref = A.ragged_attention_reference(q, k, v, starts, lens)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    assert torch.all(out[1][0] == -1e29) and torch.all(out[2][0] == 0) and torch.all(out[0][0] == 0)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", [(128, 4), (64, 8)])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("kind,S", [("verify", 5), ("prefill", 12)])
def test_ragged_paged_kernel_matches_plain(dtype, hd, G, page, kind, S):
    dev = torch.device("cuda")
    wpages = 256 // page
    starts, lens = _ragged_rows(kind, S, 256)
    q, pk, pv, tables, lens_t = _paged_case(
        dev, dtype, hd, G, page, [min(n, 256) for n in lens], wpages, hd + G + page + S
    )
    q = torch.randn((len(lens), 8, S, G, hd), generator=torch.Generator(device=dev).manual_seed(S),
                    device=dev)
    starts_t = torch.tensor(starts, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    for layer in (0, 1):
        out = A.ragged_attention_paged(q, pk, pv, layer, tables, starts_t, lens_t, wpages=wpages)
        ref = A.ragged_attention_paged_reference(
            q, pk, pv, layer, tables, starts_t, lens_t, wpages=wpages
        )
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, **DECODE_TOL)


@pytest.mark.cuda
@cuda_only
def test_ragged_kernels_count_and_refuse_bad_inputs():
    dev = torch.device("cuda")
    q, pk, pv, tables, lens_t = _paged_case(dev, torch.bfloat16, 128, 4, 64, [10, 70], 4, 2)
    qr = torch.zeros((2, 8, 5, 4, 128), device=dev)
    A.reset_launch_counts()
    A.ragged_attention_paged(qr, pk, pv, 1, tables, lens_t, lens_t, wpages=4)
    cache = torch.zeros((2, 8, 64, 128), dtype=torch.bfloat16, device=dev)
    A.ragged_attention(qr, cache, cache, lens_t, lens_t)
    assert A.launch_counts["ragged_attention_paged"] == 1
    assert A.launch_counts["ragged_attention"] == 1
    with pytest.raises(ValueError, match="layer"):
        A.ragged_attention_paged(qr, pk, pv, 2, tables, lens_t, lens_t, wpages=4)
    with pytest.raises(ValueError, match="hd=96"):
        A.ragged_attention(torch.zeros((2, 8, 5, 4, 96), device=dev), cache, cache, lens_t, lens_t)
    flat = torch.zeros(cache.numel() + 1, dtype=cache.dtype, device=dev)
    shifted = flat[1:].view(cache.shape)  # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.ragged_attention(qr, shifted, shifted, lens_t, lens_t)
    flat = torch.zeros(pk.numel() + 1, dtype=pk.dtype, device=dev)
    shifted = flat[1:].view(pk.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.ragged_attention_paged(qr, shifted, shifted, 0, tables, lens_t, lens_t, wpages=4)


# --------------------------------------------------------------------------- #
# the split window of the decode and ragged kernels
# --------------------------------------------------------------------------- #


def _edges(q, kv_dtype, W):
    """Lens on, and one either side of, the first two split boundaries the
    kernel takes for q over a window of W, plus a full row."""
    splits, split_pos = A.kernel_split_plan(q, kv_dtype, W)
    assert splits > 1, "the case must cut its window"
    return [split_pos - 1, split_pos, split_pos + 1, 2 * split_pos - 1, 2 * split_pos,
            2 * split_pos + 1, W - 1, W]


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", [(128, 4), (64, 8)])
def test_decode_kernel_at_split_boundaries(dtype, q_dtype, hd, G):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(hd + G + 1)
    B, K, W = 8, 8, 2048
    q = torch.randn((B, K, G, hd), generator=g, device=dev).to(q_dtype)
    cache = torch.randn((2, B, K, W + 64, hd), generator=g, device=dev).to(dtype)
    k, v = cache[0, :, :, :W], cache[1, :, :, :W]
    lens = torch.tensor(_edges(q, dtype, W), dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, lens)
    ref = A.decode_attention_reference(q, k, v, lens)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [0, 1, 130, 2000, 2048])
def test_decode_kernel_one_row_many_splits(dtype, n):
    """A lone agent turn: B=1 over a 2048 window, most splits past the
    row's length (n = 0: every split but the first exits, and the row
    still gets o = 0, m = -1e29, z = 0)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n)
    q = torch.randn((1, 8, 4, 128), generator=g, device=dev)
    k = torch.randn((1, 8, 2048, 128), generator=g, device=dev).to(dtype)
    v = torch.randn((1, 8, 2048, 128), generator=g, device=dev).to(dtype)
    assert A.kernel_split_plan(q, dtype, 2048)[0] >= 8
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, lens)
    ref = A.decode_attention_reference(q, k, v, lens)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    if n == 0:
        assert torch.all(out[0] == 0) and torch.all(out[1] == -1e29) and torch.all(out[2] == 0)


def _split_ragged_rows(split_pos, S, W):
    """(starts, kv_lens): verify rows on and beside split boundaries, a
    fresh row, prefill-kind rows whose triangle ends mid-split or on a
    boundary, and a prefill-kind row past the window."""
    rows = [RG.RaggedRow(RG.KIND_VERIFY, n, S, n) for n in (split_pos - 1, split_pos, W)]
    rows.append(RG.RaggedRow(RG.KIND_DECODE, 0, 1, 0))
    for st in (split_pos + 7, 2 * split_pos - S, W - S - 3):
        rows.append(RG.RaggedRow(RG.KIND_PREFILL, st, S, st + S))
    rows.append(RG.RaggedRow(RG.KIND_PREFILL, W - 2, S, W + 5))
    starts, _, kv_lens = RG.build_descriptors(rows)
    return starts, kv_lens


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", [(128, 4), (64, 8)])
@pytest.mark.parametrize("S", [5, 12])
def test_ragged_kernel_at_split_boundaries(dtype, hd, G, S):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(hd + G + S)
    B, K, W = 8, 8, 2048
    q = torch.randn((B, K, S, G, hd), generator=g, device=dev)
    cache = torch.randn((2, B, K, W + 64, hd), generator=g, device=dev).to(dtype)
    k, v = cache[0, :, :, :W], cache[1, :, :, :W]
    splits, split_pos = A.kernel_split_plan(q, dtype, W)
    assert splits > 1
    starts, lens = (torch.tensor(x, dtype=torch.int32, device=dev)
                    for x in _split_ragged_rows(split_pos, S, W))
    out = A.ragged_attention(q, k, v, starts, lens)
    ref = A.ragged_attention_reference(q, k, v, starts, lens)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    fresh = 3
    assert torch.all(out[0][fresh] == 0) and torch.all(out[1][fresh] == -1e29)
    assert torch.all(out[2][fresh] == 0)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("q_form", ["f32", "f32 of bf16 values", "bf16"])
@pytest.mark.parametrize("B,n", [(8, None), (1, 2000)])
def test_ragged_kernel_q_precision(q_form, B, n):
    """The bf16 tensor-core products hold f32 q (bits below bf16: three
    bf16 terms), f32 q whose values are bf16 (the lower terms are zero) and
    bf16 q (one term) to the f32 plain version at DECODE_TOL."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(B)
    K, S, G, hd, W = 8, 5, 4, 128, 2048
    q = torch.randn((B, K, S, G, hd), generator=g, device=dev)
    if q_form != "f32":
        q = q.to(torch.bfloat16)
        if q_form == "f32 of bf16 values":
            q = q.float()
    k = torch.randn((B, K, W, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, K, W, hd), generator=g, device=dev).to(torch.bfloat16)
    lens_list = [n] if n is not None else [17, 300, 777, 1024, 1500, 1600, 2000, 2048]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    out = A.ragged_attention(q, k, v, lens, lens)
    ref = A.ragged_attention_reference(q, k, v, lens, lens)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("kernel", ["decode", "ragged", "paged_decode", "ragged_paged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_split_kernels_repeat_bitwise(kernel, dtype, q_dtype):
    """Two launches on the same inputs give the same bits: the partials
    fold in split order, never in the order the splits finish."""
    dev = torch.device("cuda")
    lens = [0, 17, 300, 777, 1024, 1500, 2000, 2048]
    q, pk, pv, tables, lens_t = _paged_case(dev, dtype, 128, 4, 64, lens, 32, 5, n_pages=300,
                                            q_dtype=q_dtype)
    g = torch.Generator(device=dev).manual_seed(5)
    qr = torch.randn((8, 8, 5, 4, 128), generator=g, device=dev).to(q_dtype)
    kd, vd = torch.randn((2, 8, 8, 2048, 128), generator=g, device=dev).to(dtype)
    call = {
        "decode": lambda: A.decode_attention(q, kd, vd, lens_t),
        "ragged": lambda: A.ragged_attention(qr, kd, vd, lens_t, lens_t),
        "paged_decode": lambda: A.paged_decode_attention(q, pk, pv, 1, tables, lens_t, wpages=32),
        "ragged_paged": lambda: A.ragged_attention_paged(
            qr, pk, pv, 1, tables, lens_t, lens_t, wpages=32),
    }[kernel]
    first = [x.clone() for x in call()]
    for _ in range(3):
        for a, b in zip(first, call()):
            assert torch.equal(a, b)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_paged_kernels_at_split_boundaries(dtype, q_dtype, page, kind):
    """The paged twins across split boundaries, q in f32 and in bf16 (as
    serving passes it: one q term and its own shared-memory layout, with
    the block table staged after it)."""
    dev = torch.device("cuda")
    W, S, K, G, hd = 2048, 5, 8, 4, 128
    wpages = W // page
    probe = torch.empty((8, K, S, G, hd), device=dev) if kind != "decode" else \
        torch.empty((8, K, G, hd), device=dev)
    splits, split_pos = A.kernel_split_plan(probe, dtype, W)
    assert splits > 1
    if kind == "prefill":
        starts, lens = _split_ragged_rows(split_pos, S, W)
    else:
        starts = lens = _edges(probe, dtype, W)
    q, pk, pv, tables, _ = _paged_case(dev, dtype, hd, G, page, [min(x, W) for x in lens],
                                       wpages, page + S, K=K, n_pages=8 * wpages + 1,
                                       q_dtype=q_dtype)
    starts_t = torch.tensor(starts, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    for layer in (0, 1):
        if kind == "decode":
            out = A.paged_decode_attention(q, pk, pv, layer, tables, lens_t, wpages=wpages)
            ref = A.paged_decode_attention_reference(q, pk, pv, layer, tables, lens_t,
                                                     wpages=wpages)
        else:
            qr = torch.randn((8, K, S, G, hd), generator=torch.Generator(device=dev).manual_seed(S),
                             device=dev).to(q_dtype)
            out = A.ragged_attention_paged(qr, pk, pv, layer, tables, starts_t, lens_t,
                                           wpages=wpages)
            ref = A.ragged_attention_paged_reference(qr, pk, pv, layer, tables, starts_t, lens_t,
                                                     wpages=wpages)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, **DECODE_TOL)


# --------------------------------------------------------------------------- #
# the paged walk (bf16 pools): skewed batches, the tensor-map cache
# --------------------------------------------------------------------------- #

# one long row and fifteen empty ones (one row's tiles cut across most
# blocks), every row full, a lone agent turn
WALK_LENS = {"one long, 15 empty": [2048] + [0] * 15, "all full": [2048] * 16, "one row": [2000]}


def _walk_call(kernel, case, page, q_dtype, seed):
    """The paged kernel ``kernel`` on a 3-layer bf16 pool at WALK_LENS[case],
    2048-position windows of wpages = 2048 / page entries of wider tables
    → (a launch at layer l, its plain version at layer l)."""
    dev = torch.device("cuda")
    lens = WALK_LENS[case]
    W, K, G, hd, S = 2048, 8, 4, 128, 5
    wpages = W // page
    q, pk, pv, tables, lens_t = _paged_case(dev, torch.bfloat16, hd, G, page, lens, wpages, seed,
                                            K=K, n_pages=len(lens) * wpages + 1, q_dtype=q_dtype,
                                            L=3)
    assert tables.shape[1] > wpages
    if kernel == "paged_decode":
        def run(layer, fn=A.paged_decode_attention):
            return fn(q, pk, pv, layer, tables, lens_t, wpages=wpages)
        return run, lambda layer: run(layer, A.paged_decode_attention_reference)
    qr = torch.randn((len(lens), K, S, G, hd), generator=torch.Generator(device=dev).manual_seed(seed),
                     device=dev).to(q_dtype)

    def run(layer, fn=A.ragged_attention_paged):
        return fn(qr, pk, pv, layer, tables, lens_t, lens_t, wpages=wpages)
    return run, lambda layer: run(layer, A.ragged_attention_paged_reference)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("kernel", ["paged_decode", "ragged_paged"])
@pytest.mark.parametrize("case", list(WALK_LENS))
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_walk_skewed_batches(kernel, case, page, q_dtype):
    """The walk's chunks cross rows of every length; layers 0 and L-1 of a
    3-layer pool; wpages below the tables' width; q in f32 and in bf16."""
    kernel_fn, plain = _walk_call(kernel, case, page, q_dtype, seed=page + len(case))
    for layer in (0, 2):
        out, ref = kernel_fn(layer), plain(layer)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, **DECODE_TOL)
        empty = torch.tensor(WALK_LENS[case], device=a.device) == 0
        assert torch.all(out[0][empty] == 0) and torch.all(out[1][empty] == -1e29)
        assert torch.all(out[2][empty] == 0)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("kernel", ["paged_decode", "ragged_paged"])
@pytest.mark.parametrize("case", list(WALK_LENS))
def test_paged_walk_repeats_bitwise(kernel, case):
    """The same bits every launch: a row cut across chunks folds in segment
    order, never in the order its segments finish."""
    kernel_fn, _ = _walk_call(kernel, case, 64, torch.bfloat16, seed=3)
    first = [x.clone() for x in kernel_fn(1)]
    for _ in range(3):
        for a, b in zip(first, kernel_fn(1)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("kernel", ["paged_decode", "ragged_paged"])
def test_pool_tensor_map_cache_serves_no_stale_map(kernel):
    """A pool freed and another of another geometry allocated at the same
    address (here: the same storage, viewed with page 64 and then page 16):
    the tensor-map cache is keyed by address, shape, strides and dtype, so
    the second pool is read through a map of its own."""
    dev = torch.device("cuda")
    K, G, hd, S, L = 8, 4, 128, 5, 2
    lens = [100, 2000, 0, 700]
    storage = torch.empty(2 * L * 129 * K * 64 * hd, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((4, K, G, hd), generator=g, device=dev).to(torch.bfloat16)
    qr = torch.randn((4, K, S, G, hd), generator=g, device=dev).to(torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    for page, n_pages in ((64, 129), (16, 516)):
        storage.normal_(generator=g)
        pk, pv = storage.view(2, L, n_pages, K, page, hd)  # the same address each time
        wpages = 2048 // page
        ids = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(page)) + 1
        tables = ids[:4 * wpages].view(4, wpages).to(torch.int32).to(dev)
        if kernel == "paged_decode":
            out = A.paged_decode_attention(q, pk, pv, 1, tables, lens_t, wpages=wpages)
            ref = A.paged_decode_attention_reference(q, pk, pv, 1, tables, lens_t, wpages=wpages)
        else:
            out = A.ragged_attention_paged(qr, pk, pv, 1, tables, lens_t, lens_t, wpages=wpages)
            ref = A.ragged_attention_paged_reference(qr, pk, pv, 1, tables, lens_t, lens_t,
                                                     wpages=wpages)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, **DECODE_TOL)
    keys = [key for key in A._pool_maps if key[1] == storage.data_ptr()]
    assert {key[2][3] for key in keys} >= {64, 16}  # one map a geometry


@pytest.mark.cuda
@cuda_only
def test_paged_page_size_not_a_multiple_of_8():
    """A bf16 pool's page size must be a multiple of 8 (the walk's TMA boxes
    start on 1 KB boundaries): page 12 raises.  An f32 pool takes any page
    size (the split grid) and matches its plain version."""
    dev = torch.device("cuda")
    lens = [0, 13, 100, 250]
    for dtype in (torch.bfloat16, torch.float32):
        q, pk, pv, tables, lens_t = _paged_case(dev, dtype, 128, 4, 12, lens, 22, 9)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="multiple of 8"):
                A.paged_decode_attention(q, pk, pv, 1, tables, lens_t, wpages=22)
            qr = torch.zeros((4, 8, 5, 4, 128), device=dev)
            with pytest.raises(ValueError, match="multiple of 8"):
                A.ragged_attention_paged(qr, pk, pv, 1, tables, lens_t, lens_t, wpages=22)
        else:
            out = A.paged_decode_attention(q, pk, pv, 1, tables, lens_t, wpages=22)
            ref = A.paged_decode_attention_reference(q, pk, pv, 1, tables, lens_t, wpages=22)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, **DECODE_TOL)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("kernel", ["paged_decode", "ragged_paged"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_walk_reads_a_misaligned_q(kernel, q_dtype):
    """A q whose address is no 16-byte multiple (a view one element into
    its storage) is copied before the walk's 16-byte loads, and matches
    the plain version."""
    dev = torch.device("cuda")
    lens = [0, 100, 700, 2048]
    q, pk, pv, tables, lens_t = _paged_case(dev, torch.bfloat16, 128, 4, 64, lens, 32, 11,
                                            n_pages=130, q_dtype=q_dtype)
    shape = q.shape if kernel == "paged_decode" else (4, 8, 5, 4, 128)
    flat = torch.randn(math.prod(shape) + 1, generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev).to(q_dtype)
    qm = flat[1:].view(shape)
    assert qm.data_ptr() % 16
    if kernel == "paged_decode":
        out = A.paged_decode_attention(qm, pk, pv, 1, tables, lens_t, wpages=32)
        ref = A.paged_decode_attention_reference(qm, pk, pv, 1, tables, lens_t, wpages=32)
    else:
        out = A.ragged_attention_paged(qm, pk, pv, 1, tables, lens_t, lens_t, wpages=32)
        ref = A.ragged_attention_paged_reference(qm, pk, pv, 1, tables, lens_t, lens_t, wpages=32)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)


# --------------------------------------------------------------------------- #
# weight-only quantization on the card
# --------------------------------------------------------------------------- #

# (weight shape, reduction axes) at Llama-3-8B widths: one layer's wq, wo,
# w_down, and the LM head's first 4096 vocabulary columns
QUANT_LEAVES = [((1, 4096, 32, 128), (1,)), ((1, 32, 128, 4096), (1, 2)),
                ((1, 14336, 4096), (1,)), ((4096, 4096), (0,))]


def _quantize(w, axes, bits):
    from calfkit_tpu_torch.inference import quant as Q

    return Q.quantize_tensor(w, axes) if bits == 8 else Q.quantize_tensor4(w, axes)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,axes", QUANT_LEAVES)
def test_quantize_and_dequant_on_the_card_match_the_cpu_bitwise(shape, axes, bits):
    """Quantizing and dequantizing are elementwise IEEE arithmetic (a
    division, round half to even, a multiply, one rounding cast): the card
    gives the CPU's bits."""
    from calfkit_tpu_torch.inference import quant as Q

    g = torch.Generator().manual_seed(len(shape) + bits)
    w = (torch.randn(shape, generator=g) * 0.02).to(torch.bfloat16)
    cpu = _quantize(w, axes, bits)
    card = _quantize(w.cuda(), axes, bits)
    for key in cpu:
        assert torch.equal(card[key].cpu(), cpu[key]), key
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(Q.dequant(card, dtype).cpu(), Q.dequant(cpu, dtype))


def _map_weights(tree, fn):
    """``fn`` over a params tree's weights, a quantized leaf taken whole."""
    from calfkit_tpu_torch.inference import quant as Q

    return {
        name: fn(w) if not isinstance(w, dict) or Q.is_quantized(w) or Q.is_quantized4(w)
        else _map_weights(w, fn)
        for name, w in tree.items()
    }


def _quantized_forward(params, cfg, dev, seed):
    """The debug-shaped forward of ``params`` on ``dev`` over 2 rows of 40
    tokens (one of them 29 long) → logits."""
    from calfkit_tpu_torch.inference import model as M

    def to(w):
        return {k: x.to(dev) for k, x in w.items()} if isinstance(w, dict) else w.to(dev)

    g = torch.Generator().manual_seed(seed)
    B, S = 2, 40
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    lens = torch.tensor([S, 29], dtype=torch.int32)
    cache = M.make_empty_cache(cfg, B, 64, torch.float32, device=dev)
    logits, _ = M.forward(
        _map_weights(params, to), cfg, tokens.to(dev), pos.to(dev), cache, lens.to(dev)
    )
    return logits


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_forward_on_the_card(bits):
    """The quantized forward on the card equals, bit for bit, the card's
    forward on the dequantized weights as plain tensors (the seam adds
    nothing), and the CPU's quantized forward within the f32 tolerance of
    the CPU parity tests (2e-4: cuBLAS and the CPU sum in other orders)."""
    from calfkit_tpu_torch.inference import model as M
    from calfkit_tpu_torch.inference import quant as Q
    from calfkit_tpu_torch.inference.config import preset

    cfg = preset("debug", d_model=256, n_heads=2, n_kv_heads=1, d_ff=512, dtype="float32")
    params = Q.quantize_params(M.init_params(cfg, torch.Generator().manual_seed(bits)), bits=bits)
    plain = _map_weights(params, lambda w: Q.dequant(w).float() if isinstance(w, dict) else w)
    card = _quantized_forward(params, cfg, "cuda", bits)
    assert torch.equal(card, _quantized_forward(plain, cfg, "cuda", bits))
    torch.testing.assert_close(
        card.cpu(), _quantized_forward(params, cfg, "cpu", bits), atol=2e-4, rtol=2e-4
    )


# --------------------------------------------------------------------------- #
# the compiled-dispatch layer: graphs captured once and replayed
# --------------------------------------------------------------------------- #


def _graph_engine(dev):
    """A paged bf16 engine at debug depth with the kernels' head_dim (64):
    page 16, two rows holding pages of a pool filled with random K/V, each
    row's table naming its own pages."""
    from calfkit_tpu_torch.inference.config import RuntimeConfig, preset
    from calfkit_tpu_torch.inference.engine import InferenceEngine

    cfg = preset("debug", d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, dtype="bfloat16")
    rt = RuntimeConfig(
        max_batch_size=4, max_seq_len=512, prefill_chunk=32, decode_steps_per_dispatch=4,
        kv_layout="paged", page_size=16, chunked_prefill=True, max_prefill_wave=2,
    )
    engine = InferenceEngine(cfg, rt, seed=5, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    for pool in (engine._k, engine._v):
        pool.copy_(torch.randn(pool.shape, generator=g, device=dev).to(pool.dtype))
    pmax = rt.pages_per_seq()
    engine._tables[:2] = 1 + torch.arange(2 * pmax, dtype=torch.int32, device=dev).view(2, pmax)
    engine._lens[:2] = torch.tensor([37, 101], dtype=torch.int32, device=dev)
    engine._last[:2] = torch.tensor([3, 250], dtype=torch.int32, device=dev)
    engine._hard_end[:2] = 500
    engine._retire_dirty = True
    return engine


def _graph_state(engine):
    return [t.clone() for t in (
        engine._k, engine._v, engine._last, engine._lens, engine._done, engine._scratch_flat,
    )]


def _graph_restore(engine, state):
    for t, saved in zip((
        engine._k, engine._v, engine._last, engine._lens, engine._done, engine._scratch_flat,
    ), state):
        t.copy_(saved)


def _graph_drive(engine, steps):
    """For each i of ``steps``, a paged decode dispatch (one key) and a
    prefill chunk of two rows at offset 32 i mod 480 (one key) with tokens
    and last positions drawn from seed 7 + i → (every dispatch's tokens,
    every chunk's last-position logits), on the host."""
    import numpy as np

    active = np.asarray([True, True, False, False])
    toks, logits = [], []
    for i in steps:
        block, _, _ = engine._dispatch(active, 512, 4, False, engine._done_zero)
        toks.append(block.cpu())
        rng = np.random.default_rng(7 + i)
        tokens = rng.integers(0, engine.config.vocab_size, (2, 32)).astype(np.int32)
        offset = np.asarray([(32 * i) % 480], np.int32)
        last_idx = rng.integers(0, 32, 2).astype(np.int64)
        logits.append(engine._chunk_graph(32, 2)(tokens, offset, last_idx).cpu())
    return toks, logits


@pytest.mark.cuda
@cuda_only
def test_graph_replays_equal_eager_bitwise():
    """A paged decode dispatch and a prefill chunk, captured and replayed
    50 times, give eager()'s tokens, logits, pool, scratch and engine state
    bit for bit in bf16 (the same kernels over the same buffers); their
    launch counts add the capture's count at each replay; the walk's
    tickets are all zero after the replays; device memory holds steady
    across replays."""
    from calfkit_tpu_torch.inference import graphs

    dev = torch.device("cuda")
    engine = _graph_engine(dev)
    start = _graph_state(engine)
    with graphs.eager():
        want_toks, want_logits = _graph_drive(engine, range(51))
    torch.cuda.synchronize()
    want_state = _graph_state(engine)
    assert engine._graphs.stats["eager"] == 2 * 51 and engine._graphs.stats["captures"] == 0

    _graph_restore(engine, start)
    got_toks, got_logits = _graph_drive(engine, range(1))  # the first calls: eager run + capture
    A.reset_launch_counts()
    decode = engine._decode_graphs[(32, 4, False, "paged")]
    chunk = engine._prefill_graphs[("chunk", 32, 2)]
    assert decode._launches == {"paged_decode_attention": 2 * 4}  # layers x steps
    assert chunk._launches == {"prefill_attention": 2}  # layers
    memory = torch.cuda.memory_allocated()
    toks, logits = _graph_drive(engine, range(1, 51))
    torch.cuda.synchronize()
    got_toks += toks
    got_logits += logits
    assert torch.cuda.memory_allocated() == memory
    assert engine._graphs.stats["captures"] == 2 and engine._graphs.stats["replays"] == 2 * 50
    for name, graph in (("paged_decode_attention", decode), ("prefill_attention", chunk)):
        assert A.launch_counts[name] == 50 * graph._launches[name], name
    for a, b in zip(got_toks, want_toks):
        assert torch.equal(a, b)
    for a, b in zip(got_logits, want_logits):
        assert torch.equal(a, b)
    for a, b in zip(_graph_state(engine), want_state):
        assert torch.equal(a, b)
    assert all(int(buf.count_nonzero()) == 0 for buf in A._tickets.values())


@pytest.mark.cuda
@cuda_only
def test_draft_proposer_graphs_equal_eager_bitwise():
    """The draft model's proposer, captured once a catch-up width: twelve
    rounds (whole prompts, then 1-8 tokens a row) propose eager()'s drafts
    and leave eager()'s draft cache bit for bit in bf16; every round counts
    layers x k #5 launches, the replays through their capture's count."""
    import contextlib

    import numpy as np

    from calfkit_tpu_torch.inference import graphs
    from calfkit_tpu_torch.inference import model as M
    from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig, preset
    from calfkit_tpu_torch.inference.spec import DraftModelDrafter

    dev = torch.device("cuda")
    cfg = preset("debug", d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, dtype="bfloat16")
    rt = RuntimeConfig(max_batch_size=4, max_seq_len=256)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(5))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 7, 90, 23)]
    rounds = [[rng.integers(0, cfg.vocab_size, n).tolist() for n in rng.integers(1, hi, 4)]
              for hi in (2, 3, 5, 9) * 3]
    per_round = cfg.n_layers * 4  # the catch-up and k - 1 one-token forwards

    def run(eager):
        pool = graphs.GraphPool(dev)
        drafter = DraftModelDrafter(SpecConfig(k=4, draft=cfg), rt, dev, params=params, pool=pool)
        histories = [list(p) for p in prompts]
        for slot, history in enumerate(histories):
            drafter.admit(slot, history)
        drafts = []
        with graphs.eager() if eager else contextlib.nullcontext():
            for extra in rounds:
                A.reset_launch_counts()
                drafts.append(drafter.propose([(s, list(h)) for s, h in enumerate(histories)]))
                assert A.launch_counts["prefill_attention"] == per_round
                for history, tokens in zip(histories, extra):
                    history += tokens
        torch.cuda.synchronize()
        return drafter, pool, drafts

    eager, eager_pool, want = run(True)
    assert eager_pool.stats["eager"] == len(rounds) and eager_pool.stats["captures"] == 0
    graphed, pool, got = run(False)
    assert got == want
    assert torch.equal(graphed._kc, eager._kc) and torch.equal(graphed._vc, eager._vc)
    keys = set(graphed._graphs)
    assert keys == {128, 1, 2, 4, 8}
    assert pool.stats["captures"] == len(keys)
    assert pool.stats["replays"] == len(rounds) - len(keys)
    assert all(fn._launches == {"prefill_attention": per_round} for fn in graphed._graphs.values())


@pytest.mark.cuda
@cuda_only
def test_keyless_rows_attend_their_window_uniformly():
    """``model.forward(keyless_mean=)`` on the card, in f32: a marked row
    with ``seq_lens`` 0 (a draft row fed nothing) gets, through #5, what
    the plain attention's ``-1e30`` mask gives it, the mean of v over the
    whole window; the other rows are #5's own.  Unmarked, the row sees no
    key and #5 answers 0, so its logits differ."""
    from calfkit_tpu_torch.inference import model as M
    from calfkit_tpu_torch.inference.config import preset

    dev = torch.device("cuda")
    cfg = preset("debug", d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, dtype="float32")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(3))
    g = torch.Generator(device=dev).manual_seed(4)
    B, S, W = 3, 8, 64
    cache = torch.randn((2, cfg.n_layers, B, cfg.n_kv_heads, W, cfg.head_dim), generator=g,
                        device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    base = torch.tensor([0, 5, 0], dtype=torch.int32, device=dev)
    cat_len = torch.tensor([0, 3, 8], dtype=torch.int32, device=dev)
    pos = base[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None]
    mark = torch.tensor([True, False, False], device=dev)

    def run(**kw):
        kv = cache.clone()
        logits, _ = M.forward(params, cfg, tokens, pos, (kv[0], kv[1]), base + cat_len,
                              insert_at=base, **kw)
        return logits, kv

    got, got_kv = run(keyless_mean=mark)
    want, want_kv = run(attn_impl="plain")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_kv, want_kv, atol=1e-4, rtol=1e-4)
    unmarked, _ = run()
    torch.testing.assert_close(unmarked[1:], want[1:], atol=1e-4, rtol=1e-4)
    assert not torch.allclose(unmarked[0], want[0], atol=1e-3)


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("chunked", [False, True], ids=["monolithic", "chunked"])
def test_long_lane_graphs_equal_eager_bitwise(chunked):
    """A long-context drive (two long prompts of 300 and 140 tokens beside
    two short ones on a bf16 engine at debug depth, max_seq_len 128) on
    graphs gives ``eager()``'s streams bit for bit; every dispatch of the
    lane is a graph of ``_long_graphs``, and the lane runs #1 and #5."""
    import asyncio
    import contextlib

    from calfkit_tpu_torch.inference import graphs
    from calfkit_tpu_torch.inference.config import RuntimeConfig, preset
    from calfkit_tpu_torch.inference.engine import InferenceEngine

    dev = torch.device("cuda")
    cfg = preset("debug", d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, dtype="bfloat16")
    rt = RuntimeConfig(
        max_batch_size=4, max_seq_len=128, prefill_chunk=32, decode_steps_per_dispatch=4,
        long_context=True, long_new_cap=32, chunked_prefill=chunked,
    )
    V = cfg.vocab_size
    jobs = [([(7 * i + 3) % V for i in range(300)], 24), ([(3 * i + 1) % V for i in range(140)], 20),
            ([5, 6, 7], 12), ([(11 * i) % V for i in range(40)], 16)]

    async def drive(eager):
        with graphs.eager() if eager else contextlib.nullcontext():
            engine = InferenceEngine(cfg, rt, seed=5, device=dev)
            await engine.start()
            try:
                streams = await asyncio.gather(*[
                    _collect(engine, prompt, n) for prompt, n in jobs])
            finally:
                await engine.stop()
        return streams, engine

    async def _collect(engine, prompt, n):
        return [tok async for tok in engine.generate(prompt, max_new_tokens=n)]

    want, _ = asyncio.run(drive(True))
    A.reset_launch_counts()
    got, engine = asyncio.run(drive(False))
    assert got == want and [len(s) for s in got] == [n for _, n in jobs]
    stats = engine._graphs.stats
    calls = sum(fn.calls for table in (engine._decode_graphs, engine._prefill_graphs,
                                       engine._long_graphs) for fn in table.values())
    assert stats["eager"] == 0 and calls == stats["captures"] + stats["replays"]
    assert engine.stats.long_requests == 2 and len(engine._long_graphs) == 4
    assert A.launch_counts["decode_attention"] > 0 and A.launch_counts["prefill_attention"] > 0


@pytest.mark.cuda
@cuda_only
def test_two_engines_capture_at_once():
    """Two engines of one process on one set of bf16 weights, serving at
    once, each dispatching on its own worker thread: their first dispatches
    capture at the same time (one capture at a time in the process,
    ``graphs._capture_lock``; a second capture opened beside a first breaks
    both), and each engine's greedy stream equals the one it gives serving
    alone."""
    import asyncio

    from calfkit_tpu_torch.inference.config import RuntimeConfig, preset
    from calfkit_tpu_torch.inference.engine import InferenceEngine

    dev = torch.device("cuda")
    cfg = preset("debug", d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, dtype="bfloat16")
    rt = RuntimeConfig(
        max_batch_size=4, max_seq_len=256, prefill_chunk=32, decode_steps_per_dispatch=4,
        kv_layout="paged", page_size=16, chunked_prefill=True, prefix_cache=True,
    )
    params = InferenceEngine(cfg, rt, seed=5, device=dev).params
    V = cfg.vocab_size
    prompts = [[(7 * i + 3) % V for i in range(100)], [(3 * i + 1) % V for i in range(60)]]

    async def serve(jobs):
        engines = [InferenceEngine(cfg, rt, params=params, device=dev) for _ in jobs]
        for engine in engines:
            await engine.start()
        try:
            streams = await asyncio.gather(*[
                _stream(engine, prompt) for engine, prompt in zip(engines, jobs)])
        finally:
            for engine in engines:
                await engine.stop()
        return streams, engines

    async def _stream(engine, prompt):
        return [tok async for tok in engine.generate(prompt, max_new_tokens=40)]

    alone = [asyncio.run(serve([prompt]))[0][0] for prompt in prompts]
    together, engines = asyncio.run(serve(prompts))
    assert together == alone and all(len(s) == 40 for s in together)
    for engine in engines:
        assert engine._graphs.stats["captures"] > 0 and engine._graphs.stats["eager"] == 0
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
            engine.params["layers"].values(), params["layers"].values()))


# llama-3-8b's heads on one rank of a tensor-parallel engine: (H, K) at tp
RANK_HEADS = {2: (16, 4), 4: (8, 2), 8: (4, 1)}


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("tp", sorted(RANK_HEADS))
def test_kernels_at_a_ranks_heads(tp):
    """#2 and #5 at the heads one rank of llama-3-8b holds at tp = 2, 4, 8
    (H/K = 16/4, 8/2, 4/1), bf16 caches and q, hd 128, page 64."""
    dev = torch.device("cuda")
    H, K = RANK_HEADS[tp]
    G, hd, page = H // K, 128, 64
    lens = [0, 1, 63, 64, 65, 700, 1023, 1024]
    wpages = 1024 // page
    q, pk, pv, tables, lens_t = _paged_case(
        dev, torch.bfloat16, hd, G, page, lens, wpages, 90 + tp, K=K, q_dtype=torch.bfloat16)
    out = A.paged_decode_attention(q, pk, pv, 1, tables, lens_t, wpages=wpages)
    ref = A.paged_decode_attention_reference(q, pk, pv, 1, tables, lens_t, wpages=wpages)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    Sq, Skv = 512, 1024
    q_pos = [list(range(512, 1024))] * 2
    args = _prefill_layer_case(dev, torch.bfloat16, hd, G, Sq, Skv, q_pos, [1024, 900], tp, K)
    torch.testing.assert_close(
        A.prefill_attention(*args).float(), A.prefill_attention_reference(*args).float(),
        **PREFILL_TOL[torch.bfloat16],
    )


_TP_CHILD = '''
import sys
import torch
sys.path.insert(0, {repo!r})
from calfkit_tpu_torch.inference import distributed as D, model as M, sharding as S
from calfkit_tpu_torch.inference.config import preset

rank = int(sys.argv[1])
D.initialize_multihost({coordinator!r}, 2, rank, backend="gloo")
cfg = preset("llama-3-8b", n_layers=2, vocab_size=4096)
generator = torch.Generator(device="cuda")
generator.manual_seed(0)
mesh = S.make_mesh(tp=2)
shard = M.init_params(cfg, generator, shardings=S.param_shardings(cfg, mesh), rank=rank)
layout = S.layout_of(cfg, mesh, rank, D.Comm(mesh, rank))
params = M.Decoder(S.local_params(shard, cfg, layout), "cuda", layout).params()
tokens = torch.load({tokens!r}).cuda()
B, T = tokens.shape
cache = M.make_empty_cache(cfg, B, T, device="cuda", kv_heads=layout.kv_heads)
pos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T)
logits, _ = M.forward(params, cfg, tokens, pos, cache,
                      torch.full((B,), T, dtype=torch.int32, device="cuda"))
torch.save(logits.cpu(), {out!r}.format(rank))
# gloo work cannot live in a CUDA graph: a capture that meets a collective raises
from calfkit_tpu_torch.exceptions import InferenceError
graph = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(graph):
        M.forward(params, cfg, tokens, pos, cache,
                  torch.full((B,), T, dtype=torch.int32, device="cuda"))
except InferenceError as exc:
    print("CAPTURE REFUSED", "gloo" in str(exc))
D.shutdown_group()
'''


@pytest.mark.cuda
@cuda_only
def test_two_process_gloo_forward_on_one_card(tmp_path):
    """A tp = 2 forward in two processes sharing the card over gloo (each
    rank its shard of llama-3-8b's widths at 2 layers, drawn from one
    seed; the kernels at 16 heads over 4 kv heads) equals the one-process
    forward within the bf16 tie law: each position's tp = 2 argmax lies
    within 3 bf16 spacings of the one-process top logit.  A CUDA-graph
    capture of the same forward raises on each rank at its first gloo
    collective."""
    import os
    import subprocess
    import sys

    from calfkit_tpu_torch.inference import model as M
    from calfkit_tpu_torch.inference.config import preset

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = preset("llama-3-8b", n_layers=2, vocab_size=4096)
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    torch.save(tokens, tmp_path / "tokens.pt")
    script = tmp_path / "rank.py"
    script.write_text(_TP_CHILD.format(
        repo=repo, coordinator="file://" + str(tmp_path / "store"),
        tokens=str(tmp_path / "tokens.pt"), out=str(tmp_path / "logits{}.pt")))
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
            assert "CAPTURE REFUSED True" in out, (out, err[-2000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    tp2 = torch.load(tmp_path / "logits0.pt").float()
    assert torch.equal(tp2, torch.load(tmp_path / "logits1.pt").float())
    dev = torch.device("cuda")
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    params = M.init_params(cfg, generator)
    B, T = tokens.shape
    one, _ = M.forward(params, cfg, tokens.to(dev), torch.arange(T, dtype=torch.int32, device=dev)
                       .expand(B, T), M.make_empty_cache(cfg, B, T, device=dev),
                       torch.full((B,), T, dtype=torch.int32, device=dev))
    one = one.float().cpu()
    top = one.max(dim=-1).values
    chosen = one.gather(-1, tp2.argmax(dim=-1, keepdim=True))[..., 0]
    spacing = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(2.0 ** -126))) - 7)
    assert ((top - chosen) / spacing).max() <= 3, ((top - chosen) / spacing).max()
    assert (tp2 - one).abs().mean() <= 0.02 * one.abs().mean()


_NCCL_CHILD = '''
import sys
sys.path.insert(0, {repo!r})
from calfkit_tpu_torch.inference import distributed as D
try:
    D.initialize_multihost({coordinator!r}, 2, int(sys.argv[1]), backend="nccl")
except ValueError as exc:
    print("REFUSED", "shared by 2 ranks" in str(exc))
'''


@pytest.mark.cuda
@cuda_only
def test_nccl_on_a_shared_card_raises(tmp_path):
    """Two ranks asking for NCCL on one card (the children see card 0
    only) both raise before any collective, as NCCL itself refuses."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "nccl.py"
    script.write_text(_NCCL_CHILD.format(repo=repo, coordinator="file://" + str(tmp_path / "s")))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0 and "REFUSED True" in out, (out, err[-2000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
