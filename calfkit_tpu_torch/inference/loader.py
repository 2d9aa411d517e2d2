"""HF checkpoint → the port's params on one device, or one rank's shard.

Loads a *local* Llama-family HF directory (``config.json`` + safetensors,
one ``model.safetensors`` or shards listed in
``model.safetensors.index.json``) into the stacked-layer tree of
:mod:`calfkit_tpu_torch.inference.model`: the port's copy of
``calfkit_tpu.inference.loader``.  With ``shardings=`` and ``rank=`` (a
rank of a multi-rank engine, :mod:`.sharding`) each leaf is cut to the
rank's shard on the host before it moves, so no card holds more than its
shard; a leaf to quantize is quantized whole on the host first (its scales
span the reduction axes a rank may hold only part of), as the reference
quantizes before it places.  The safetensors files are
read by the port's own reader (:mod:`._safetensors`), which needs neither
the ``safetensors`` package nor a numpy bfloat16 type.

Weight name mapping (HF → ours):
    model.embed_tokens.weight                     → embed [V, D]
    model.layers.{i}.self_attn.{q,k,v}_proj.weight→ wq/wk/wv (transposed,
                                                    reshaped to [D, N, hd])
    model.layers.{i}.self_attn.o_proj.weight      → wo [H, hd, D]
    model.layers.{i}.mlp.{gate,up,down}_proj.weight → w_gate/w_up/w_down
    model.layers.{i}.{input,post_attention}_layernorm.weight → norms
    model.norm.weight                              → final_norm
    lm_head.weight                                 → lm_head [D, V]
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

from calfkit_tpu_torch.exceptions import InferenceError
from calfkit_tpu_torch.inference._safetensors import SafetensorsFile
from calfkit_tpu_torch.inference.config import ModelConfig
from calfkit_tpu_torch.inference.model import torch_dtype
from calfkit_tpu_torch.inference.quant import (
    LAYER_REDUCTION_AXES,
    LM_HEAD_REDUCTION_AXES,
    bits_of,
    quantize_tensor,
    quantize_tensor4,
)

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Checkpoint:
    """A local HF checkpoint directory as an engine's ``params``: every rank
    of a multi-rank engine reads its own shard of it (:func:`load_params`
    with the engine's shard tree)."""

    path: str


def config_from_hf(path: "str | Path") -> ModelConfig:
    raw = json.loads((Path(path) / "config.json").read_text())
    return ModelConfig(
        name=raw.get("_name_or_path", str(path)),
        vocab_size=raw["vocab_size"],
        d_model=raw["hidden_size"],
        n_layers=raw["num_hidden_layers"],
        n_heads=raw["num_attention_heads"],
        n_kv_heads=raw.get("num_key_value_heads", raw["num_attention_heads"]),
        d_ff=raw["intermediate_size"],
        rope_theta=raw.get("rope_theta", 10000.0),
        norm_eps=raw.get("rms_norm_eps", 1e-5),
        max_seq_len=raw.get("max_position_embeddings", 2048),
        tie_embeddings=raw.get("tie_word_embeddings", False),
    )


def _tensor_files(path: Path) -> "dict[str, SafetensorsFile]":
    """name → the file that holds it, across all shards."""
    index_file = path / "model.safetensors.index.json"
    if index_file.exists():
        index = json.loads(index_file.read_text())
        opened: dict[str, SafetensorsFile] = {}
        files = {}
        for name, shard in index["weight_map"].items():
            if shard not in opened:
                opened[shard] = SafetensorsFile(path / shard)
            files[name] = opened[shard]
        return files
    single = path / "model.safetensors"
    if not single.exists():
        raise FileNotFoundError(f"no safetensors found under {path}")
    f = SafetensorsFile(single)
    return {name: f for name in f.keys()}


def load_params(
    path: "str | Path",
    config: ModelConfig,
    *,
    device: "torch.device | str" = "cuda",
    quantize: "str | None" = None,
    shardings: "dict[str, Any] | None" = None,
    rank: int = 0,
) -> "dict[str, Any]":
    """Load, transpose, stack and place the checkpoint on ``device`` (with
    ``shardings``, a :class:`sharding.Sharding` tree already expanded by
    :func:`quant.quantize_shardings` when quantizing: ``rank``'s shard of
    every leaf, a :class:`sharding.RankShard`).

    ``quantize="int8"``/``"int4"`` quantizes each matmul weight ON THE HOST
    (:func:`quant.quantize_tensor`/:func:`quant.quantize_tensor4` on the
    CPU tensor) before it moves, so the device never
    holds a full-precision copy of a quantized weight; the embedding and
    the norms come in the model's dtype."""
    if quantize is not None:
        bits_of(quantize)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise InferenceError("no CUDA device: pass device='cpu' to load on the CPU")
    files = _tensor_files(Path(path))
    params = _build_params(
        config, lambda name: files[name].get_tensor(name), quantize, device, shardings, rank
    )
    if shardings is None:
        return params
    from calfkit_tpu_torch.inference.sharding import RankShard

    return RankShard(params)


def _build_params(
    config: ModelConfig,
    get: "Callable[[str], torch.Tensor]",
    quantize: "str | None",
    device: "torch.device | str",
    shardings: "dict[str, Any] | None" = None,
    rank: int = 0,
) -> "dict[str, Any]":
    D, H, K, hd = config.d_model, config.n_heads, config.n_kv_heads, config.head_dim
    L = config.n_layers
    dtype = torch_dtype(config.dtype)
    quant_axes: dict[str, tuple[int, ...]] = {}
    if quantize is not None:
        quant_axes = {**LAYER_REDUCTION_AXES, "lm_head": LM_HEAD_REDUCTION_AXES}
        qt = quantize_tensor if bits_of(quantize) == 8 else quantize_tensor4

    def cut(t: torch.Tensor, sharding: Any) -> torch.Tensor:
        # the rank's shard, copied out on the host before it moves
        return t if sharding is None else sharding.shard(t, rank)

    def leaf_sharding(name: str) -> Any:
        if shardings is None:
            return None
        return shardings["layers"][name] if name in shardings["layers"] else shardings[name]

    def put(w: torch.Tensor, name: str = "", top: str = "") -> Any:
        axes = quant_axes.get(name)
        sh = leaf_sharding(name or top)
        if axes is not None:  # quantized here, on the host, whole
            return {
                key: cut(t, None if sh is None else sh[key]).contiguous().to(device)
                for key, t in qt(w, axes).items()
            }
        return cut(w, sh).to(dtype).contiguous().to(device)

    def stack(fmt: str, transform: "Callable[[torch.Tensor], torch.Tensor]") -> torch.Tensor:
        return torch.stack([transform(get(fmt.format(i))) for i in range(L)])

    def proj(name: str, fmt: str, shape: tuple) -> Any:
        # HF projections are [out, in]; ours are [in, heads, hd] and the like
        return put(stack(fmt, lambda w: w.T.reshape(shape)), name)

    attn = "model.layers.{}.self_attn."
    mlp = "model.layers.{}.mlp."
    params: dict[str, Any] = {
        "embed": put(get("model.embed_tokens.weight"), top="embed"),
        "layers": {
            "wq": proj("wq", attn + "q_proj.weight", (D, H, hd)),
            "wk": proj("wk", attn + "k_proj.weight", (D, K, hd)),
            "wv": proj("wv", attn + "v_proj.weight", (D, K, hd)),
            "wo": proj("wo", attn + "o_proj.weight", (H, hd, D)),
            "w_gate": proj("w_gate", mlp + "gate_proj.weight", (D, -1)),
            "w_up": proj("w_up", mlp + "up_proj.weight", (D, -1)),
            "w_down": proj("w_down", mlp + "down_proj.weight", (-1, D)),
            "attn_norm": put(
                stack("model.layers.{}.input_layernorm.weight", lambda w: w), top="attn_norm"
            ),
            "mlp_norm": put(
                stack("model.layers.{}.post_attention_layernorm.weight", lambda w: w),
                top="mlp_norm",
            ),
        },
        "final_norm": put(get("model.norm.weight"), top="final_norm"),
    }
    if not config.tie_embeddings:
        params["lm_head"] = put(get("lm_head.weight").T, "lm_head")
    logger.info("loaded %s params", config.name)
    return params
