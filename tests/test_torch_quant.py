"""The PyTorch port's weight-only quantization against
``calfkit_tpu.inference.quant``.

Quantization and dequantization are pure arithmetic on the same numpy
inputs, so both packages must agree BIT FOR BIT: int8 and int4 payloads,
scales, dequantized bf16 and f32 weights, and the host-side random
quantized params for a seed (bf16 leaves compared by their bits).  The
debug-preset forward with int8 and int4 weights agrees with the JAX
package's to 2e-4, the f32 tolerance of ``tests/test_torch_model.py``: the
same dequantized weights, f32 products summed in different orders.  The
quantized engine's greedy streams and counters, dense and paged with the
prefix cache, must be IDENTICAL to the JAX engine's (Pallas in interpret
mode).
"""

import asyncio
import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from calfkit_tpu.inference import model as JM  # noqa: E402
from calfkit_tpu.inference import quant as JQ  # noqa: E402
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu_torch.inference import model as TM  # noqa: E402
from calfkit_tpu_torch.inference import quant as TQ  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from calfkit_tpu_torch.inference.weights import params_from_numpy  # noqa: E402
from tests._torch_port import (  # noqa: E402
    JAX_CFG, TORCH_CFG, j, jax_params, n, quantized_params, t, torch_params,
)

TOL = dict(atol=2e-4, rtol=2e-4)
LEAVES = [*TQ.LAYER_REDUCTION_AXES, "lm_head"]


@pytest.fixture(scope="module")
def weights():
    """The debug preset's f32 weights as numpy arrays."""
    return jax.tree.map(np.asarray, jax_params())


def _leaf(weights, name):
    if name == "lm_head":
        return weights["lm_head"], TQ.LM_HEAD_REDUCTION_AXES
    return weights["layers"][name], TQ.LAYER_REDUCTION_AXES[name]


def _same(jax_tree, port_tree):
    """Two quantized leaves (or plain arrays) are identical: keys, dtypes
    and values."""
    if isinstance(jax_tree, dict):
        assert set(jax_tree) == set(port_tree)
        for key in jax_tree:
            _same(jax_tree[key], port_tree[key])
        return
    a = np.asarray(jax_tree)
    b = port_tree.numpy() if isinstance(port_tree, torch.Tensor) else np.asarray(port_tree)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_reduction_axes_match_reference():
    assert TQ.LAYER_REDUCTION_AXES == JQ.LAYER_REDUCTION_AXES
    assert TQ.LM_HEAD_REDUCTION_AXES == JQ.LM_HEAD_REDUCTION_AXES
    assert TQ.DEFAULT_Q4_GROUP == JQ.DEFAULT_Q4_GROUP


# int4 at the default group (128: the debug preset's axes of 16-128 fall
# back to the whole axis or are one group) and at 8, which divides every
# packing axis into several groups
QUANTIZERS = {
    "int8": (lambda w, axes: JQ.quantize_tensor(j(w), axes),
             lambda w, axes: TQ.quantize_tensor(t(w), axes)),
    "int4": (lambda w, axes: JQ.quantize_tensor4(j(w), axes),
             lambda w, axes: TQ.quantize_tensor4(t(w), axes)),
    "int4-group8": (lambda w, axes: JQ.quantize_tensor4(j(w), axes, 8),
                    lambda w, axes: TQ.quantize_tensor4(t(w), axes, 8)),
    "host-int8": (lambda w, axes: JQ.quantize_array_host(w, axes, bits=8),
                  lambda w, axes: TQ.quantize_array_host(w, axes, bits=8)),
    "host-int4": (lambda w, axes: JQ.quantize_array_host(w, axes, bits=4),
                  lambda w, axes: TQ.quantize_array_host(w, axes, bits=4)),
    "host-int4-group8": (lambda w, axes: JQ.quantize_array_host(w, axes, bits=4, group=8),
                         lambda w, axes: TQ.quantize_array_host(w, axes, bits=4, group=8)),
}


@pytest.mark.parametrize("kind", list(QUANTIZERS))
@pytest.mark.parametrize("name", LEAVES)
def test_quantize_is_bit_identical(weights, name, kind):
    w, axes = _leaf(weights, name)
    ref, port = QUANTIZERS[kind]
    _same(ref(w, axes), port(w, axes))


def test_int4_group_keys():
    """A group that divides the packing axis keeps its size in the key; one
    that does not falls back to the whole axis; an odd axis raises."""
    w = np.random.default_rng(0).standard_normal((2, 64, 4, 16)).astype(np.float32)
    assert TQ.q4_key_of(TQ.quantize_tensor4(t(w), (1,), 16))[1:] == (3, 16)
    assert TQ.q4_key_of(TQ.quantize_tensor4(t(w), (1,), 48))[1:] == (3, 64)
    with pytest.raises(ValueError, match="even axis"):
        TQ.quantize_tensor4(t(w[:, :63]), (1,))
    with pytest.raises(ValueError, match="even axis"):
        TQ.quantize_array_host(w[:, :63], (1,), bits=4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("consume", [False, True])
def test_quantize_params_is_bit_identical(weights, bits, consume):
    ref = JQ.quantize_params(jax.tree.map(jnp.asarray, weights), bits=bits)
    source = params_from_numpy(weights, device="cpu")
    port = TQ.quantize_params(source, consume=consume, bits=bits)
    _same(ref, port)
    assert TQ.is_quantized(port["layers"]["wq"]) == (bits == 8)
    assert TQ.is_quantized4(port["layers"]["wq"]) == (bits == 4)
    assert port["embed"] is source["embed"]  # the embedding stays as it is
    # consume pops each quantized tensor (and the norms) out of the input
    assert (source["layers"] == {} and "lm_head" not in source) == consume
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        TQ.quantize_params(params_from_numpy(weights, device="cpu"), bits=6)


@pytest.mark.parametrize("name,bits", [("int8", 8), ("int4", 4), ("fp8", None), ("INT8", None)])
def test_bits_of(name, bits):
    """The engine, the loader and the scripts read a quantization name's bit
    width here; any other name raises the engine's unsupported error."""
    if bits is not None:
        assert TQ.bits_of(name) == bits
        return
    with pytest.raises(ValueError, match=f"unsupported quantization '{name}'"):
        TQ.bits_of(name)


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["int8", "int4", "int4-group8"])
@pytest.mark.parametrize("name", LEAVES)
def test_dequant_is_bit_identical(weights, name, kind, out):
    w, axes = _leaf(weights, name)
    ref, port = QUANTIZERS[kind]
    a = np.asarray(JQ.dequant(ref(w, axes), getattr(jnp, out)))
    b = TQ.dequant(port(w, axes), getattr(torch, out))
    assert b.dtype == getattr(torch, out)
    if out == "bfloat16":
        assert np.array_equal(a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16))
    else:
        assert np.array_equal(a, b.numpy())


def test_dequant_passes_plain_tensors_through():
    w = torch.ones(3, 4)
    assert TQ.dequant(w) is w


def test_dequant_of_a_layer_slice(weights):
    """Slicing the layer axis off the left keeps the int4 key valid: layer
    i's dequantized slice is the i-th slice of the whole."""
    for bits in (8, 4):
        q = TQ.quantize_params(params_from_numpy(weights, device="cpu"), bits=bits)
        for i in range(TORCH_CFG.n_layers):
            lp = TM.layer_params(q, i)
            for name in TQ.LAYER_REDUCTION_AXES:
                assert torch.equal(TQ.dequant(lp[name]), TQ.dequant(q["layers"][name])[i])


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("bits", [8, 4])
def test_random_quantized_params_host_is_identical(bits, dtype):
    ref = JQ.random_quantized_params_host(JAX_CFG, seed=5, dtype=dtype, bits=bits)
    port = TQ.random_quantized_params_host(TORCH_CFG, seed=5, dtype=dtype, bits=bits)

    def flat(tree, prefix=()):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from flat(value, prefix + (key,))
            else:
                yield prefix + (key,), value

    ref, port = dict(flat(ref)), dict(flat(port))
    assert set(ref) == set(port)
    for key, a in ref.items():
        b = port[key]
        assert b.device.type == "cpu"
        if a.dtype.name == "bfloat16":  # compared by their bits
            assert b.dtype == torch.bfloat16, key
            assert np.array_equal(a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16)), key
        else:
            assert np.array_equal(a, b.numpy()) and a.dtype == b.numpy().dtype, key


# --------------------------------------------------------------------------- #
# the model and the engine on quantized weights
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def quantized():
    return {bits: quantized_params(bits) for bits in (8, 4)}


@pytest.mark.parametrize("bits", [8, 4])
def test_forward_matches_reference(quantized, bits):
    jp, tp = quantized[bits]
    B, S, SMAX = 2, 24, 64
    rng = np.random.default_rng(bits)
    tokens = rng.integers(0, JAX_CFG.vocab_size, (B, S), dtype=np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    lens = np.full((B,), S, np.int32)
    jl, (jk, jv) = JM.forward(
        jp, JAX_CFG, j(tokens), j(pos), JM.make_empty_cache(JAX_CFG, B, SMAX, jnp.float32), j(lens)
    )
    cache = TM.make_empty_cache(TORCH_CFG, B, SMAX, torch.float32, device="cpu")
    tl, (tk, tv) = TM.forward(tp, TORCH_CFG, t(tokens), t(pos), cache, t(lens))
    np.testing.assert_allclose(n(tl), n(jl), **TOL)
    np.testing.assert_allclose(n(tk), n(jk), **TOL)
    np.testing.assert_allclose(n(tv), n(jv), **TOL)


def test_weights_keep_quantized_leaves_under_a_dtype_cast(quantized):
    """``params_from_numpy(dtype=...)`` casts floating plain leaves only: an
    int8 payload stays int8 and its scale f32."""
    jp, _ = quantized[8]
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.bfloat16)
    wq = tree["layers"]["wq"]
    assert wq["q8"].dtype == torch.int8 and wq["scale"].dtype == torch.float32
    assert torch.equal(wq["q8"], t(jp["layers"]["wq"]["q8"]))
    assert tree["embed"].dtype == torch.bfloat16
    jp4, _ = quantized[4]
    tree4 = params_from_numpy(jax.tree.map(np.asarray, jp4), device="cpu", dtype=torch.bfloat16)
    key = TQ.q4_key_of(tree4["lm_head"])[0]
    assert tree4["lm_head"][key].dtype == torch.uint8
    assert tree4["lm_head"]["scale"].dtype == torch.float32


def test_decoder_owns_quantized_leaves(quantized):
    _, tp = quantized[4]
    decoder = TM.Decoder(tp, "cpu")
    owned = decoder.params()
    wq = owned["layers"]["wq"]
    assert TQ.is_quantized4(wq) and isinstance(wq, dict)
    assert all(not p.requires_grad for p in decoder.parameters())
    assert {p.dtype for p in decoder.parameters()} == {torch.float32, torch.uint8}
    _same(jax.tree.map(np.asarray, quantized[4][0]), jax.tree.map(lambda x: x.detach(), owned))


DENSE = dict(max_batch_size=4, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4)
PAGED = dict(
    DENSE, kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True,
)
RUNTIMES = {"dense": DENSE, "paged": PAGED}
PREFIX = [(11 * i + 5) % 512 for i in range(32)]
BURSTS = [
    [(PREFIX + [3, 1, 4], 8), ([9, 8, 7, 6, 5], 6), (PREFIX + [2, 7], 5)],
    [(PREFIX + [1, 5, 9, 2, 6], 7), ([5] * 20, 4)],
]
COUNTERS = (
    "prefix_hits", "prefix_reused_tokens", "prefill_absorbed_tokens", "unified_dispatches",
    "decode_dispatches", "decode_tokens",
)


async def _serve_bursts(engine):
    async def gen(prompt, k):
        return [tok async for tok in engine.generate(prompt, max_new_tokens=k)]

    await engine.start()
    try:
        streams = []
        for burst in BURSTS:
            streams += await asyncio.gather(*[gen(p, k) for p, k in burst])
        return streams, {name: getattr(engine.stats, name) for name in COUNTERS}
    finally:
        await engine.stop()


_REFERENCE: dict = {}


async def _reference(quantized, bits, layout):
    key = (bits, layout)
    if key not in _REFERENCE:
        runtime = JaxRuntime(
            **RUNTIMES[layout], attention_impl="pallas_interpret",
            quantization=f"int{bits}",
        )
        _REFERENCE[key] = await _serve_bursts(
            JaxEngine(JAX_CFG, runtime, params=quantized[bits][0])
        )
    return _REFERENCE[key]


@pytest.mark.parametrize("layout", list(RUNTIMES))
@pytest.mark.parametrize("bits", [8, 4])
async def test_engine_streams_and_counters_match_reference(quantized, bits, layout):
    ref_streams, ref_counters = await _reference(quantized, bits, layout)
    runtime = RuntimeConfig(**RUNTIMES[layout], quantization=f"int{bits}")
    engine = InferenceEngine(TORCH_CFG, runtime, params=quantized[bits][1], device="cpu")
    streams, counters = await _serve_bursts(engine)
    assert streams == ref_streams
    assert [len(s) for s in streams] == [k for burst in BURSTS for _, k in burst]
    assert counters == ref_counters
    if layout == "paged":
        assert counters["prefix_hits"] >= 2
    assert sorted(engine._free) == list(range(DENSE["max_batch_size"])) and not engine._active


@pytest.mark.parametrize("bits", [8, 4])
async def test_engine_quantizes_full_precision_params(quantized, bits):
    """Full-precision params quantize at construction (consuming the tree
    handed in) into what the JAX package's quantize_params gives: the same
    streams as the pre-quantized tree."""
    source = torch_params(jax_params())
    runtime = RuntimeConfig(**DENSE, quantization=f"int{bits}")
    engine = InferenceEngine(TORCH_CFG, runtime, params=source, device="cpu")
    assert source["layers"] == {} and "lm_head" not in source
    _same(jax.tree.map(np.asarray, quantized[bits][0]),
          jax.tree.map(lambda x: x.detach(), engine.params))
    ref_streams, _ = await _reference(quantized, bits, "dense")
    streams, _ = await _serve_bursts(engine)
    assert streams == ref_streams


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_bitness_mismatch_raises_as_reference(quantized, bits):
    other = f"int{12 - bits}"  # the other bitness
    with pytest.raises(ValueError) as ref:
        JaxEngine(JAX_CFG, JaxRuntime(**DENSE, quantization=other),
                  params=copy.deepcopy(quantized[bits][0]))
    with pytest.raises(ValueError) as port:
        InferenceEngine(TORCH_CFG, RuntimeConfig(**DENSE, quantization=other),
                        params=quantized[bits][1], device="cpu")
    assert str(port.value) == str(ref.value)
    assert "pre-quantized at the other bitness" in str(port.value)


def test_engine_unsupported_quantization_raises_as_reference(quantized):
    with pytest.raises(ValueError) as ref:
        JaxEngine(JAX_CFG, JaxRuntime(**DENSE, quantization="fp8"), params=quantized[8][0])
    with pytest.raises(ValueError) as port:
        InferenceEngine(TORCH_CFG, RuntimeConfig(**DENSE, quantization="fp8"),
                        params=quantized[8][1], device="cpu")
    assert str(port.value) == str(ref.value) == "unsupported quantization 'fp8'"
