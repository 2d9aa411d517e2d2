"""A configuration file (``configs/<name>.json``): the model's published
``config.json`` keys at the top level, as the source gives them, plus the
serving deployment under ``runtime`` (the engine's ``RuntimeConfig``
fields), the precision of the plain reference's weights under
``reference_weights``, the control's runtime under ``control``, and the
keys changed from the source (``reduced``) and the sizes set here
(``assumed``).

:func:`arch` reads the sizes the benchmark needs (the weight generator,
the plain reference and the work counts) from the published keys; the
engine's ``ModelConfig`` is built from the same numbers by
:func:`model_fields`, so the program and the reference cannot be handed
different shapes.
"""

from __future__ import annotations

import json
from pathlib import Path

from loadbench import manifest

# the published keys of a Llama-family decoder, as Hugging Face names them
ARCH_KEYS = {
    "vocab_size": "vocab", "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff", "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tied",
}


def load(name: str) -> dict:
    """``configs/<name>.json`` as a dict."""
    path = manifest.BENCH_DIR / "configs" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration file {path}")
    return json.loads(Path(path).read_text())


def arch(config: dict) -> dict:
    """The decoder's sizes: vocab, d_model, n_layers, n_heads, n_kv_heads,
    head_dim, d_ff, rope_theta, norm_eps, tied, and the served dtype."""
    out = {short: config[key] for key, short in ARCH_KEYS.items()}
    out["head_dim"] = config.get("head_dim") or out["d_model"] // out["n_heads"]
    if out["head_dim"] * out["n_heads"] != out["d_model"]:
        raise ValueError("the engine's decoder needs n_heads x head_dim == hidden_size")
    if config.get("sliding_window") not in (None, 0):
        raise ValueError("a sliding window is not part of the engine's decoder")
    if config.get("hidden_act", "silu") != "silu":
        raise ValueError("the engine's decoder is a SwiGLU (silu) MLP")
    out["dtype"] = config.get("torch_dtype", "bfloat16")
    return out


def model_fields(config: dict, name: str) -> dict:
    """The engine's ``ModelConfig`` fields for ``config``."""
    a = arch(config)
    return dict(
        name=name, vocab_size=a["vocab"], d_model=a["d_model"], n_layers=a["n_layers"],
        n_heads=a["n_heads"], n_kv_heads=a["n_kv_heads"], d_ff=a["d_ff"],
        rope_theta=float(a["rope_theta"]), norm_eps=float(a["norm_eps"]),
        max_seq_len=config["runtime"]["max_seq_len"], dtype=a["dtype"],
        tie_embeddings=bool(a["tied"]),
    )


def runtime_fields(config: dict, control: bool = False) -> dict:
    """The engine's ``RuntimeConfig`` fields: the deployment's, or with
    ``control`` the deployment with the control's changes."""
    fields = dict(config["runtime"])
    if control:
        fields.update(config["control"]["runtime"])
    return fields


def limits(cell: str) -> dict:
    """``limits/<cell>.json``: each compared number's limit, with the
    readings it was set from."""
    path = manifest.BENCH_DIR / "limits" / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no limits file {path}")
    return {name: entry["limit"] for name, entry in json.loads(path.read_text()).items()}
