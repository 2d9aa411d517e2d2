"""Weight-only int8 and int4 quantization.

The port's copy of ``calfkit_tpu.inference.quant``, on torch tensors (and
numpy in and out on the host, :func:`quantize_array_host`).  A quantized
tensor is the leaf-pair ``{"q8": int8[...], "scale": f32 broadcastable}`` (int8,
per-output-channel scales) or ``{"q4an<n>g<group>": uint8[...], "scale":
f32}`` (int4, two values a byte, group-wise scales);
:func:`dequant` is the single read-side seam (identity for plain tensors),
applied at every weight use in :mod:`calfkit_tpu_torch.inference.model`.

Unlike XLA, which fuses the dequant into the consuming matmul's operand
load, eager PyTorch writes the dequantized bf16 weight to device memory at
every use and the product reads it back: the weights' bytes at rest halve
(int8) or quarter (int4), their traffic a step does not.
"""

from __future__ import annotations

import math
import re
from typing import Any

import numpy as np
import torch

Params = dict[str, Any]

# which layer weights quantize, and their INPUT (reduction/contraction)
# axes — scales are per-output-channel (max over these axes)
LAYER_REDUCTION_AXES: dict[str, tuple[int, ...]] = {
    "wq": (1,),  # [L, D, H, hd] — reduce D
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),  # [L, H, hd, D] — reduce (H, hd)
    "w_gate": (1,),  # [L, D, F]
    "w_up": (1,),
    "w_down": (1,),  # [L, F, D]
}
LM_HEAD_REDUCTION_AXES: tuple[int, ...] = (0,)  # [D, V] — reduce D

# the runtime's weight-only quantization names and their bit widths
QUANTIZATION_BITS: dict[str, int] = {"int8": 8, "int4": 4}


def bits_of(quantization: str) -> int:
    """The bit width of a quantization name (``RuntimeConfig.quantization``,
    the loader's ``quantize=``); any other name raises ``ValueError``."""
    if quantization not in QUANTIZATION_BITS:
        raise ValueError(f"unsupported quantization {quantization!r}")
    return QUANTIZATION_BITS[quantization]


def quantize_tensor(w: torch.Tensor, reduction_axes: tuple[int, ...]) -> dict[str, torch.Tensor]:
    """int8 symmetric quantization with per-output-channel scales.

    ``reduction_axes`` are the matmul's contraction dims; every other dim
    keeps its own scale (rank preserved: the scale broadcasts)."""
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=reduction_axes, keepdim=True)
    scale = torch.clamp_min(_div(absmax, 127.0), 1e-8)
    q8 = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q8": q8, "scale": scale}


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded once, as IEEE division: PyTorch's CUDA
    kernels multiply by the reciprocal of a Python-number divisor, which can
    differ in the last bit, so the divisor is a tensor on ``x``'s device."""
    return x / x.new_tensor(divisor)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q8" in leaf and "scale" in leaf


# int4 leaves carry their packing axis + group size IN THE KEY
# (``q4an<n>g<group>`` where the packing axis is the n-th FROM THE RIGHT,
# i.e. axis = ndim - n), as in the JAX package.  Right-relative indexing
# keeps the key valid after ``model.layer_params`` slices the layer axis
# off the LEFT of every per-layer weight.
_Q4_KEY = "q4an{n}g{group}"
_Q4_RE = re.compile(r"^q4an(\d+)g(\d+)$")


def q4_key_of(leaf: dict) -> "tuple[str, int, int] | None":
    """→ (key, n_from_right, group); axis = tensor.ndim - n_from_right."""
    for key in leaf:
        m = _Q4_RE.match(key)
        if m:
            return key, int(m.group(1)), int(m.group(2))
    return None


def is_quantized4(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "scale" in leaf and q4_key_of(leaf) is not None


def dequant(leaf: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """The read-side seam: plain tensors pass through.  The multiply runs in
    f32 (the scale's storage precision) and casts once, rounding to nearest
    even: bit for bit the JAX package's dequant."""
    if is_quantized(leaf):
        return (leaf["q8"].to(torch.float32) * leaf["scale"]).to(dtype)
    if isinstance(leaf, dict) and "scale" in leaf:
        found = q4_key_of(leaf)
        if found is not None:
            key, n_right, group = found
            axis = leaf[key].dim() - n_right
            return _dequant4(leaf[key], leaf["scale"], axis, group, dtype)
    return leaf


def _dequant4(
    packed: torch.Tensor, scale: torch.Tensor, axis: int, group: int, dtype: torch.dtype
) -> torch.Tensor:
    """Unpack two 4-bit values per byte along ``axis`` (low nibble = even
    element, high = odd; values biased by +8) and apply the group-wise
    scales.  ``>>`` on uint8 is a logical shift."""
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = ((packed >> 4) & 0x0F).to(torch.int8) - 8
    w = torch.stack([lo, hi], dim=axis + 1)
    shape = list(packed.shape)
    shape[axis] *= 2
    w = w.reshape(shape)
    n_groups = shape[axis] // group
    if n_groups > 1:
        gshape = shape[:axis] + [n_groups, group] + shape[axis + 1:]
        sshape = list(scale.shape[:axis]) + [n_groups, 1] + list(scale.shape[axis + 1:])
        w = (w.reshape(gshape).to(torch.float32) * scale.reshape(sshape)).reshape(shape)
    else:
        w = w.to(torch.float32) * scale
    return w.to(dtype)


DEFAULT_Q4_GROUP = 128


def _q4_group_for(n: int, group: int) -> int:
    """Group size along the packing axis: the requested group when it
    divides the axis, else the whole axis (per-channel fallback)."""
    return group if group and n % group == 0 else n


def _every_other(x: Any, axis: int, start: int) -> Any:
    """Elements ``start, start + 2, ...`` of ``x`` along ``axis``."""
    index = [slice(None)] * x.ndim
    index[axis] = slice(start, None, 2)
    return x[tuple(index)]


def quantize_tensor4(
    w: torch.Tensor, reduction_axes: tuple[int, ...], group: int = DEFAULT_Q4_GROUP
) -> dict[str, torch.Tensor]:
    """int4 symmetric quantization: values in [-7, 7] biased to [1, 15],
    two per byte packed along the LAST reduction axis, with group-wise
    scales along that axis.  Other reduction axes keep per-element scale
    granularity (scale dims stay full there)."""
    axis = reduction_axes[-1]
    n = w.shape[axis]
    if n % 2:
        raise ValueError(f"int4 packing needs an even axis, got {n}")
    g = _q4_group_for(n, group)
    shape = list(w.shape)
    gshape = shape[:axis] + [n // g, g] + shape[axis + 1:]
    w32 = w.to(torch.float32).reshape(gshape)
    absmax = w32.abs().amax(dim=axis + 1, keepdim=True)
    scale = torch.clamp_min(_div(absmax, 7.0), 1e-8)
    q = torch.clamp(torch.round(w32 / scale), -7, 7).reshape(shape)
    biased = (q + 8).to(torch.uint8)
    packed = _every_other(biased, axis, 0) | (_every_other(biased, axis, 1) << 4)
    # scale stored with n_groups at the packing axis (drop the kept-1 dim)
    scale = scale.reshape(list(scale.shape[:axis + 1]) + list(scale.shape[axis + 2:]))
    return {_Q4_KEY.format(n=w.dim() - axis, group=g): packed.contiguous(), "scale": scale}


def quantize_params(params: Params, *, consume: bool = False, bits: int = 8) -> Params:
    """Quantize the large matmul weights; norms and embeddings stay as they
    are.

    ``consume=True`` pops tensors out of the input tree as they quantize so
    each full-precision original frees before the next allocates: peak
    memory stays ~1x the model size instead of 1.5x.  ``bits`` selects int8
    (per-output-channel scales) or int4 (packed nibbles + group-wise
    scales).  The embedding table is a gather and stays unquantized."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qt = quantize_tensor if bits == 8 else quantize_tensor4
    layers = params["layers"]
    out: Params = {"embed": params["embed"], "final_norm": params["final_norm"]}
    qlayers: Params = {}
    for name in list(layers):
        w = layers.pop(name) if consume else layers[name]
        qlayers[name] = qt(w, LAYER_REDUCTION_AXES[name]) if name in LAYER_REDUCTION_AXES else w
        del w
    out["layers"] = qlayers
    if "lm_head" in params:
        head = params.pop("lm_head") if consume else params["lm_head"]
        out["lm_head"] = qt(head, LM_HEAD_REDUCTION_AXES)
    return out


def quantize_array_host(
    w: Any, reduction_axes: tuple[int, ...], *, bits: int = 8, group: int = DEFAULT_Q4_GROUP
) -> dict[str, np.ndarray]:
    """Host-side quantization, numpy in and out: :func:`quantize_tensor` or
    :func:`quantize_tensor4` on the CPU (the same bits as the JAX package's
    numpy version).  The checkpoint loader calls those two on its CPU
    tensors directly; this is the numpy entry point beside them."""
    w32 = np.ascontiguousarray(w, dtype=np.float32)
    if not w32.flags.writeable:  # torch wraps only writable arrays
        w32 = w32.copy()
    w32 = torch.from_numpy(w32)
    q = quantize_tensor(w32, reduction_axes) if bits == 8 else quantize_tensor4(
        w32, reduction_axes, group)
    return {key: t.numpy() for key, t in q.items()}


def quantize_shardings(shardings: Params, *, bits: int = 8) -> Params:
    """Mirror a sharding tree (:func:`sharding.param_shardings`) onto the
    quantized structure, as the reference does.

    int8: q8 keeps the tensor's spec; the scale clears the spec at every
    reduction axis (those dims are singletons after keepdims).

    int4: the packed tensor keeps the spec (halving an axis keeps it
    divisible); the scale clears the spec ONLY at the packing axis (its
    dim becomes n_groups) and keeps it elsewhere.  A rank's shard of a
    packed leaf whose packing axis is split takes the matching scale rows
    (:func:`sharding.local_params`)."""
    from calfkit_tpu_torch.inference.sharding import Sharding

    def expand(ns: Any, reduction_axes: "tuple[int, ...]") -> Any:
        spec = list(ns.spec) + [None] * 8  # pad: a spec may be shorter than the rank
        cleared = reduction_axes if bits == 8 else reduction_axes[-1:]
        for axis in cleared:
            spec[axis] = None
        scale_ns = Sharding(ns.mesh, tuple(spec[: len(ns.spec)]))
        if bits == 8:
            return {"q8": ns, "scale": scale_ns}
        # the key's group is resolved at quantize time from the real axis
        # size: :func:`align_quant_sharding_keys` renames it
        return {"__q4__": ns, "scale": scale_ns}

    out: Params = {"embed": shardings["embed"], "final_norm": shardings["final_norm"]}
    out["layers"] = {
        name: expand(ns, LAYER_REDUCTION_AXES[name]) if name in LAYER_REDUCTION_AXES else ns
        for name, ns in shardings["layers"].items()
    }
    if "lm_head" in shardings:
        out["lm_head"] = expand(shardings["lm_head"], LM_HEAD_REDUCTION_AXES)
    return out


def align_quant_sharding_keys(shardings: Params, params: Params) -> Params:
    """Rename int4 placeholder keys (``__q4__``) in a sharding tree to the
    concrete ``q4an<n>g<group>`` keys the params tree carries, so the two
    trees have one structure."""

    def walk(sh: Any, pr: Any) -> Any:
        if isinstance(sh, dict) and "__q4__" in sh and isinstance(pr, dict):
            found = q4_key_of(pr)
            if found is None:
                raise ValueError("params leaf is not int4 but shardings are")
            return {found[0]: sh["__q4__"], "scale": sh["scale"]}
        if isinstance(sh, dict):
            return {k: walk(v, pr[k] if isinstance(pr, dict) else pr) for k, v in sh.items()}
        return sh

    return walk(shardings, params)


def random_quantized_params_host(
    config: Any, seed: int = 0, dtype: Any = None, *, bits: int = 8
) -> Params:
    """Random params of the model's shapes, built quantized on the host
    (CPU tensors, one at a time), for driving big models without a
    checkpoint: a random init on the device would hold the full bf16 tree
    first.  The draws are the JAX package's (``np.random.default_rng(seed)``,
    the same order), so the same seed gives the same arrays; the dense
    leaves are rounded to ``dtype`` (bf16 by default) to nearest even.
    Values are meaningless; shapes, dtypes and bytes are the serving
    path's."""
    from calfkit_tpu_torch.inference.model import torch_dtype

    rng = np.random.default_rng(seed)
    out_dtype = torch_dtype(dtype) if dtype else torch.bfloat16

    L, D, H, K, hd, F, V = (
        config.n_layers, config.d_model, config.n_heads, config.n_kv_heads,
        config.head_dim, config.d_ff, config.vocab_size,
    )

    def q(shape, reduction_axes):
        fan_in = math.prod(shape[a] for a in reduction_axes)
        if bits == 8:
            q8 = rng.integers(-127, 128, size=shape, dtype=np.int8)
            scale_shape = tuple(1 if i in reduction_axes else s for i, s in enumerate(shape))
            scale = np.full(scale_shape, 1.0 / (127.0 * np.sqrt(fan_in)), np.float32)
            return {"q8": torch.from_numpy(q8), "scale": torch.from_numpy(scale)}
        axis = reduction_axes[-1]
        g = _q4_group_for(shape[axis], DEFAULT_Q4_GROUP)
        packed_shape = tuple(s // 2 if i == axis else s for i, s in enumerate(shape))
        packed = rng.integers(0, 256, size=packed_shape, dtype=np.uint8)
        scale_shape = tuple(shape[axis] // g if i == axis else s for i, s in enumerate(shape))
        scale = np.full(scale_shape, 1.0 / (7.0 * np.sqrt(fan_in)), np.float32)
        return {_Q4_KEY.format(n=len(shape) - axis, group=g): torch.from_numpy(packed),
                "scale": torch.from_numpy(scale)}

    def dense(shape, fan_in):
        # the draw divided by a numpy float64 is float64 (as in the JAX
        # package); through f32 to the output dtype, as ml_dtypes casts
        draw = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)
        return torch.from_numpy(draw.astype(np.float32)).to(out_dtype)

    def ones(shape):
        return torch.ones(shape, dtype=out_dtype)

    params: Params = {
        "embed": dense((V, D), D),
        "layers": {
            "wq": q((L, D, H, hd), LAYER_REDUCTION_AXES["wq"]),
            "wk": q((L, D, K, hd), LAYER_REDUCTION_AXES["wk"]),
            "wv": q((L, D, K, hd), LAYER_REDUCTION_AXES["wv"]),
            "wo": q((L, H, hd, D), LAYER_REDUCTION_AXES["wo"]),
            "w_gate": q((L, D, F), LAYER_REDUCTION_AXES["w_gate"]),
            "w_up": q((L, D, F), LAYER_REDUCTION_AXES["w_up"]),
            "w_down": q((L, F, D), LAYER_REDUCTION_AXES["w_down"]),
            "attn_norm": ones((L, D)),
            "mlp_norm": ones((L, D)),
        },
        "final_norm": ones((D,)),
    }
    if not config.tie_embeddings:
        params["lm_head"] = q((D, V), LM_HEAD_REDUCTION_AXES)
    return params

