"""The int8 weight product's seam on the CPU: ``quant.int8_matmul`` runs its
plain version there (the einsum over ``dequant``'s weight, bit for bit what
the projections computed before the kernel existed), ``model._project``
routes each leaf by what it sees, and ``quant.int8_matmul_plan`` cuts every
shape into whole splits.  The kernel itself is tested on the card
(``tests/test_torch_kernels_cuda.py -k int8``)."""

import pytest
import torch

from calfkit_tpu_torch.inference import model as M
from calfkit_tpu_torch.inference import quant as Q
from calfkit_tpu_torch.inference.config import preset

# (einsum spec, x shape, weight shape, its reduction axes): the projections
# of ``model.attn_qkv``, ``attn_out_mlp`` and ``lm_logits`` at debug widths
PROJECTIONS = {
    "wq": ("bsd,dnh->bsnh", (2, 5, 64), (64, 4, 16), (0,)),
    "wk": ("bsd,dkh->bskh", (2, 5, 64), (64, 1, 16), (0,)),
    "wo": ("bsnh,nhd->bsd", (2, 5, 4, 16), (4, 16, 64), (0, 1)),
    "w_gate": ("bsd,df->bsf", (2, 5, 64), (64, 128), (0,)),
    "w_down": ("bsf,fd->bsd", (2, 5, 128), (128, 64), (0,)),
    "lm_head": ("bsd,dv->bsv", (3, 1, 64), (64, 512), (0,)),
}


def _case(name, dtype, seed=0):
    spec, x_shape, w_shape, axes = PROJECTIONS[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(x_shape, generator=g).to(dtype)
    leaf = Q.quantize_tensor(torch.randn(w_shape, generator=g) * 0.1, axes)
    return spec, x, leaf, len(axes)


def _old_project(spec, x, leaf):
    """The projection as ``model.py`` computed every leaf before the kernel."""
    return torch.einsum(spec, x, M._w(leaf, x.dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_int8_matmul_on_the_cpu_is_the_einsum_over_dequant(name, dtype):
    spec, x, leaf, _ = _case(name, dtype)
    got = Q.int8_matmul(spec, x, leaf)
    assert got.dtype == dtype
    assert torch.equal(got, torch.einsum(spec, x, Q.dequant(leaf).to(dtype)))
    assert torch.equal(Q.int8_matmul_reference(spec, x, leaf), got)


@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_project_is_the_old_projection_on_the_cpu(name):
    for dtype in (torch.bfloat16, torch.float32):
        spec, x, leaf, _ = _case(name, dtype, seed=1)
        assert torch.equal(M._project(spec, x, leaf), _old_project(spec, x, leaf))
        plain = Q.dequant(leaf).to(dtype)
        assert torch.equal(M._project(spec, x, plain), torch.einsum(spec, x, plain))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_forward_on_the_cpu_is_unchanged(dtype, monkeypatch):
    """The whole quantized forward (chunk with logits at every position)
    gives the logits and cache of the projections as they were, bit for
    bit."""
    cfg = preset("debug", dtype=dtype)
    params = Q.quantize_params(M.init_params(cfg, torch.Generator().manual_seed(3)))
    g = torch.Generator().manual_seed(4)
    B, S = 2, 12
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    lens = torch.tensor([S, 7], dtype=torch.int32)

    def run():
        cache = M.make_empty_cache(cfg, B, 32, M.torch_dtype(dtype), device="cpu")
        logits, (k, v) = M.forward(params, cfg, tokens, pos, cache, lens)
        return logits, k, v

    new = run()
    monkeypatch.setattr(M, "_project", _old_project)
    old = run()
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def test_project_routes_by_what_it_sees(monkeypatch):
    """Only an int8 leaf under bf16 activations reaches ``int8_matmul``;
    f32 activations, int4 leaves and plain weights take ``_w``."""
    seen = []
    real = M.int8_matmul
    monkeypatch.setattr(M, "int8_matmul", lambda spec, x, leaf: seen.append(spec) or real(spec, x, leaf))
    spec, x, leaf, _ = _case("wo", torch.bfloat16)
    w = torch.randn((4, 16, 64)) * 0.1
    leaf4 = Q.quantize_tensor4(w, (0, 1))
    M._project(spec, x, leaf)
    assert seen == [spec]
    M._project(spec, x.float(), leaf)
    M._project(spec, x, leaf4)
    M._project(spec, x, w.to(torch.bfloat16))
    assert seen == [spec]
    assert torch.equal(M._project(spec, x, leaf4), torch.einsum(spec, x, Q.dequant(leaf4)))


@pytest.mark.parametrize("spec", ["bsd,dnh->bsnh", "bsnh,nhd->bsd", "bsd,dv->bsv", "bsf,fd->bsd"])
def test_contracted_axes_of_a_projection(spec):
    assert Q._contracted(spec) == (2 if spec.startswith("bsnh") else 1)


@pytest.mark.parametrize("spec", ["bsd,vd->bsv", "bsd,dnh->bshn", "bsnh,hnd->bsd"])
def test_int8_matmul_refuses_other_einsums(spec):
    with pytest.raises(ValueError, match="no projection"):
        Q._contracted(spec)


def test_cpu_calls_count_no_launch_and_no_card_read():
    Q.reset_counts()
    spec, x, leaf, _ = _case("w_gate", torch.bfloat16)
    Q.int8_matmul(spec, x, leaf)
    Q.dequant(leaf)
    assert Q.launch_counts == {"int8_matmul": 0}
    assert Q.read_counts == {"int8_dequant_cuda": 0}


# (M, N, K) → the plan on 132 SMs: Mistral-7B-v0.3's decode step (M = 128)
# and a wave's chunk (M = 4,096), and tp = 2's shards at decode
PLANS = {
    (128, 4096, 4096): (128, 4, 16),  # wq, wo
    (128, 1024, 4096): (128, 4, 16),  # wk, wv
    (128, 14336, 4096): (128, 1, 64),  # w_gate, w_up
    (128, 4096, 14336): (128, 4, 56),  # w_down
    (128, 32768, 4096): (128, 1, 64),  # lm_head
    (4096, 4096, 4096): (256, 1, 64),
    (4096, 14336, 4096): (256, 1, 64),
    (4096, 4096, 14336): (256, 1, 224),
    (640, 4096, 4096): (128, 1, 64),
    (128, 512, 4096): (128, 4, 16),  # wk / 2
    (128, 4096, 7168): (128, 4, 28),  # w_down / 2
    (1, 32, 64): (128, 1, 1),
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_int8_matmul_plan(shape):
    assert Q.int8_matmul_plan(*shape, 132) == PLANS[shape]


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_int8_matmul_plan_cuts_whole_splits(sms):
    """Every split holds at least one step, the splits cover K, and a split
    launch never gives more blocks than the card has SMs."""
    for M_ in (1, 8, 66, 128, 129, 640, 4224):
        for N in (16, 512, 1024, 4096, 14336, 32768):
            for K in (8, 64, 72, 4096, 7168, 14336):
                rows, splits, per = Q.int8_matmul_plan(M_, N, K, sms)
                steps = -(-K // 64)
                assert rows in (128, 256) and splits >= 1 and per >= 1
                assert (splits - 1) * per < steps <= splits * per
                tiles = -(-M_ // rows) * -(-N // 128)
                assert splits == 1 or tiles * splits <= max(sms, tiles)
