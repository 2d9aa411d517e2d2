"""The PyTorch port's hand-written CUDA kernels against their plain
versions, on the card.  These tests need a CUDA device and skip without one
(run them there with ``python -m pytest tests/test_torch_kernels_cuda.py
-m cuda``); they import neither JAX nor the JAX package, so they run where
only PyTorch is installed."""

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


def _paged_case(dev, dtype, hd, G, page, lens, wpages, seed, K=8, n_pages=200):
    """A 2-layer pool of random values and block tables of shuffled page
    ids (trash-padded past each row's pages)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    q = torch.randn((B, K, G, hd), generator=g, device=dev)
    pool = torch.randn((2, 2, n_pages, K, page, hd), generator=g, device=dev).to(dtype)
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
