"""The plain reference of a Llama-family decoder as Mistral-7B-v0.3 publishes
it (``MistralForCausalLM`` with ``sliding_window`` null): token embedding;
per layer RMSNorm, q/k/v projections, rotary embedding on q and k
(``rotate_half`` pairs, frequencies ``theta^(-2i/hd)``), causal grouped-query
attention with scale ``1/sqrt(hd)``, output projection and residual, RMSNorm,
SwiGLU MLP (``silu(x W_gate) * (x W_up)`` then ``W_down``) and residual;
a final RMSNorm and an untied LM head.

Everything runs in float32 with TF32 off, one sequence at a time over its
whole length (no cache, no batching), one layer's weights in float32 at a
time, and attention in blocks of queries so that a long sequence fits.
With ``weights="int8"`` each projection and the LM head are first put
through the benchmark's own copy of the per-output-channel int8 rule
(:func:`int8_rule`) and used as ``q * scale`` in float32.
"""

from __future__ import annotations

import math

import torch

# the contraction axes of each per-layer weight (after the layer axis is
# taken off): int8 scales are per output channel, the max over these axes
LAYER_REDUCTION = {
    "wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1),
    "w_gate": (0,), "w_up": (0,), "w_down": (0,),
}
QUERY_BLOCK = 1024


def int8_rule(w: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    """Symmetric int8 with one scale per output channel: scale = max|w| over
    the contraction ``axes`` / 127 (at least 1e-8), q = round(w / scale)
    clamped to [-127, 127] → q * scale in float32."""
    w32 = w.to(torch.float32)
    scale = torch.clamp_min(w32.abs().amax(dim=axes, keepdim=True) / w32.new_tensor(127.0), 1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return q * scale


class Decoder:
    """The reference over a weights dict (:func:`loadbench.weights.make`'s
    layout) and the sizes of :func:`loadbench.configs.arch`."""

    def __init__(self, arch: dict, params: dict, weights: str = "bfloat16"):
        if weights not in ("bfloat16", "float16", "float32", "int8"):
            raise ValueError(f"unknown reference weights {weights!r}")
        self.arch = arch
        self.params = params
        self.int8 = weights == "int8"

    def _weight(self, name: str, i: int) -> torch.Tensor:
        w = self.params["layers"][name][i]
        if self.int8 and name in LAYER_REDUCTION:
            return int8_rule(w, LAYER_REDUCTION[name])
        return w.to(torch.float32)

    def _head(self) -> torch.Tensor:
        head = self.params.get("lm_head")
        if head is None:
            return self.params["embed"].to(torch.float32).T
        return int8_rule(head, (0,)) if self.int8 else head.to(torch.float32)

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        eps = float(self.arch["norm_eps"])
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.to(torch.float32)

    def _rope(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Causal GQA: q [S, H, hd], k/v [S, K, hd] → [S, H, hd]."""
        S, H, hd = q.shape
        K = k.shape[1]
        G = H // K
        kh = k.permute(1, 0, 2)  # [K, S, hd]
        vh = v.permute(1, 0, 2)
        out = torch.empty_like(q)
        for lo in range(0, S, QUERY_BLOCK):
            hi = min(S, lo + QUERY_BLOCK)
            qb = q[lo:hi].reshape(hi - lo, K, G, hd).permute(1, 2, 0, 3)  # [K, G, s, hd]
            scores = torch.einsum("kgsh,kth->kgst", qb, kh[:, :hi]) / math.sqrt(hd)
            pos = torch.arange(lo, hi, device=q.device)[:, None]
            keys = torch.arange(hi, device=q.device)[None, :]
            scores = scores.masked_fill(keys > pos, float("-inf"))
            probs = torch.softmax(scores, dim=-1)
            ob = torch.einsum("kgst,kth->kgsh", probs, vh[:, :hi])
            out[lo:hi] = ob.permute(2, 0, 1, 3).reshape(hi - lo, H, hd)
        return out

    @torch.no_grad()
    def logits(self, tokens: "list[int]", first: int = 0) -> torch.Tensor:
        """The float32 logits [len(tokens) - first, V] at positions
        ``first ..`` of the causal forward over ``tokens``."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(tokens, first)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def _logits(self, tokens: "list[int]", first: int) -> torch.Tensor:
        a, p = self.arch, self.params
        device = p["embed"].device
        ids = torch.as_tensor(tokens, dtype=torch.int64, device=device)
        S, D, H, K, hd = len(tokens), a["d_model"], a["n_heads"], a["n_kv_heads"], a["head_dim"]
        inv = 1.0 / torch.pow(
            torch.tensor(float(a["rope_theta"]), dtype=torch.float64),
            torch.arange(0, hd, 2, dtype=torch.float64) / hd,
        )
        angles = torch.arange(S, dtype=torch.float64)[:, None] * inv[None, :]
        cos = torch.cos(angles).to(torch.float32).to(device)[:, None, :]
        sin = torch.sin(angles).to(torch.float32).to(device)[:, None, :]
        x = p["embed"][ids].to(torch.float32)
        for i in range(a["n_layers"]):
            h = self._norm(x, p["layers"]["attn_norm"][i])
            q = (h @ self._weight("wq", i).reshape(D, H * hd)).reshape(S, H, hd)
            k = (h @ self._weight("wk", i).reshape(D, K * hd)).reshape(S, K, hd)
            v = (h @ self._weight("wv", i).reshape(D, K * hd)).reshape(S, K, hd)
            attn = self._attention(self._rope(q, cos, sin), self._rope(k, cos, sin), v)
            x = x + attn.reshape(S, H * hd) @ self._weight("wo", i).reshape(H * hd, D)
            h = self._norm(x, p["layers"]["mlp_norm"][i])
            gate = h @ self._weight("w_gate", i)
            up = h @ self._weight("w_up", i)
            x = x + (torch.nn.functional.silu(gate) * up) @ self._weight("w_down", i)
        x = self._norm(x[first:], p["final_norm"])
        return x @ self._head()


def gaps(logits: torch.Tensor, served: "list[int]") -> torch.Tensor:
    """The gap [n] by which each served token's logit lies below the best
    logit at its position (0 where the served token is the reference's
    best): ``logits`` [n, V] are the reference's at the positions that
    produced ``served`` [n]."""
    ids = torch.as_tensor(served, dtype=torch.int64, device=logits.device)
    best = logits.max(dim=-1).values
    return best - logits.gather(1, ids[:, None])[:, 0]


def widest_gap(logits: torch.Tensor, served: "list[int]") -> float:
    """The widest of :func:`gaps`."""
    return float(gaps(logits, served).max())
