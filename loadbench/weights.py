"""The weights of a run, made from ``--seed`` on the run's device.

One generator on the device, seeded by the run's seed, draws every leaf
whole in the served dtype, in one fixed order: the same seed gives the same
weights on the same device.  The layout is the engine's (stacked layers;
``wq [L, D, H, hd]``, ``wk``/``wv [L, D, K, hd]``, ``wo [L, H, hd, D]``,
``w_gate``/``w_up [L, D, F]``, ``w_down [L, F, D]``, norms ``[L, D]``,
``embed [V, D]``, ``final_norm [D]``, ``lm_head [D, V]``), and the plain
reference reads the same dict.  Projections are normal with standard
deviation ``1/sqrt(fan_in)``; norm weights are ``1 + 0.05 N(0, 1)``, so a
path that skipped a norm's weight would read differently.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def generator(seed: int, device: "torch.device | str") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make(arch: dict, seed: int, device: "torch.device | str") -> dict:
    """Every leaf of the model ``arch`` (:func:`loadbench.configs.arch`),
    drawn from ``seed`` on ``device`` in the served dtype."""
    dtype = DTYPES[arch["dtype"]]
    g = generator(seed, device)
    L, D, H, K = arch["n_layers"], arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    hd, F, V = arch["head_dim"], arch["d_ff"], arch["vocab"]

    def normal(shape: tuple, fan_in: int) -> torch.Tensor:
        leaf = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return leaf.mul_(1.0 / math.sqrt(fan_in))

    def norm(shape: tuple) -> torch.Tensor:
        leaf = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return leaf.mul_(0.05).add_(1.0)

    params = {
        "embed": normal((V, D), D),
        "layers": {
            "wq": normal((L, D, H, hd), D),
            "wk": normal((L, D, K, hd), D),
            "wv": normal((L, D, K, hd), D),
            "wo": normal((L, H, hd, D), H * hd),
            "w_gate": normal((L, D, F), D),
            "w_up": normal((L, D, F), D),
            "w_down": normal((L, F, D), F),
            "attn_norm": norm((L, D)),
            "mlp_norm": norm((L, D)),
        },
        "final_norm": norm((D,)),
    }
    if not arch["tied"]:
        params["lm_head"] = normal((D, V), D)
    return params
