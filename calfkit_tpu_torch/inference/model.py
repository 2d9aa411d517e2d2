"""Llama-family decoder on PyTorch tensors: the dense and paged serving paths.

The counterpart of ``calfkit_tpu.inference.model``: the same function names,
argument order and tensor layouts, so the two packages compute the same
function on the same weights.  Differences that follow from PyTorch:

- layers run as a Python loop over the stacked ``[L, ...]`` parameters;
- KV caches and page pools are updated IN PLACE (``forward``,
  ``consolidate_ring``, ``_insert_chunk``, ``consolidate_ring_paged``,
  ``write_prefill_pages``) where the JAX package donates buffers to a pure
  function — memory stays at one cache copy either way;
- attention goes through :mod:`calfkit_tpu_torch.inference.attention`: the
  hand-written kernels on CUDA tensors, their plain versions on CPU
  tensors.  ``attn_impl="plain"`` selects :func:`attention_xla`, the plain
  attention, on any device (a reference for checking the kernels).

Weight layout (per layer, stacked on axis 0 across layers):
    attn: wq [L, D, H, hd], wk/wv [L, D, K, hd], wo [L, H, hd, D]
    mlp:  w_gate/w_up [L, D, F], w_down [L, F, D]
    norms: attn_norm/mlp_norm [L, D]
    top:   embed [V, D], final_norm [D], lm_head [D, V] (absent when tied)
The projections and the LM head may be quantized leaves
(:mod:`calfkit_tpu_torch.inference.quant`), read through :func:`_w`.

Tensor parallelism: a rank's params (:class:`Decoder` over a rank's shard)
carry its :class:`sharding.Layout` as ``params.layout``.  The functions
here then run the collectives the reference leaves to GSPMD, and only
where a dimension was actually split: the vocab-split embedding gather is
summed over tp (:func:`embed_tokens`), the products by a head-split ``wo``
and an ff-split ``w_down`` are summed over tp (:func:`attn_out_mlp`), and
vocab-split logits are gathered (:func:`lm_logits`).  Without a layout
(one device) nothing changes.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from calfkit_tpu_torch.inference import attention as _attention
from calfkit_tpu_torch.inference.attention import (
    merged_decode_attention,
    merged_paged_decode_attention,
    verify_attention,
    verify_attention_paged,
)
from calfkit_tpu_torch.inference.config import ModelConfig
from calfkit_tpu_torch.inference.quant import dequant

Params = dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: "str | torch.dtype") -> torch.dtype:
    """A config dtype name ("bfloat16", ...) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[name]


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #


def init_params(
    config: ModelConfig, generator: torch.Generator, dtype: Any = None, *,
    shardings: "Params | None" = None, rank: int = 0,
) -> Params:
    """Random-init params (He-ish scaling) drawn from ``generator`` on the
    generator's device.  The draws differ from the JAX package's (another
    generator); convert JAX params with ``weights.params_from_numpy`` to
    compute the same function.

    With ``shardings`` (:func:`sharding.param_shardings`' tree), the result
    is ``rank``'s shard of the same draws: each leaf is cut as it is drawn,
    so a rank never holds more than one layer of a full leaf, and the ranks
    of a mesh, seeded alike, hold the shards of one model."""
    dtype = torch_dtype(dtype or config.dtype)
    device = generator.device
    L, D, H, K, hd, Fd, V = (
        config.n_layers, config.d_model, config.n_heads, config.n_kv_heads,
        config.head_dim, config.d_ff, config.vocab_size,
    )
    top = shardings or {}
    layers = top.get("layers", {})

    def index(shape: tuple, sh: Any) -> tuple:
        return (slice(None),) * len(shape) if sh is None else sh.slices(shape, rank)

    def norm_init(shape: tuple, fan_in: int, sh: Any) -> torch.Tensor:
        scale = 1.0 / math.sqrt(fan_in)
        cut = index(shape, sh)
        if len(shape) == 2:
            draw = torch.randn(shape, generator=generator, device=device)
            out = (draw * scale).to(dtype)
            return out if sh is None else out[cut].clone()
        local = torch.empty(shape, device="meta")[cut].shape
        out = torch.empty(local, dtype=dtype, device=device)
        for i in range(shape[0]):  # layer by layer: the f32 draw stays small
            draw = torch.randn(shape[1:], generator=generator, device=device)
            out[i] = (draw * scale)[cut[1:]]
        return out

    def ones(shape: tuple, sh: Any) -> torch.Tensor:
        local = torch.empty(shape, device="meta")[index(shape, sh)].shape
        return torch.ones(local, dtype=dtype, device=device)

    params: Params = {
        "embed": norm_init((V, D), D, top.get("embed")),
        "layers": {
            "wq": norm_init((L, D, H, hd), D, layers.get("wq")),
            "wk": norm_init((L, D, K, hd), D, layers.get("wk")),
            "wv": norm_init((L, D, K, hd), D, layers.get("wv")),
            "wo": norm_init((L, H, hd, D), H * hd, layers.get("wo")),
            "w_gate": norm_init((L, D, Fd), D, layers.get("w_gate")),
            "w_up": norm_init((L, D, Fd), D, layers.get("w_up")),
            "w_down": norm_init((L, Fd, D), Fd, layers.get("w_down")),
            "attn_norm": ones((L, D), layers.get("attn_norm")),
            "mlp_norm": ones((L, D), layers.get("mlp_norm")),
        },
        "final_norm": ones((D,), top.get("final_norm")),
    }
    if not config.tie_embeddings:
        params["lm_head"] = norm_init((D, V), D, top.get("lm_head"))
    return params


class RankParams(dict):
    """A rank's params tree, with the :class:`sharding.Layout` that tells
    the functions of this module where its collectives are."""

    layout: Any = None


def layout_of(params: Params) -> Any:
    """The params' :class:`sharding.Layout`, or ``None`` on one device."""
    return getattr(params, "layout", None)


class Decoder(torch.nn.Module):
    """Owns the decoder's parameter tensors on one device, for inference (no
    gradients).  A quantized leaf (``quant``'s integer payload and f32
    scale) is a nested dict of its two tensors.  :meth:`params` returns them
    in the tree layout the functions of this module take (with ``layout``,
    a rank's shard: a :class:`RankParams`)."""

    def __init__(self, params: Params, device: "torch.device | str", layout: Any = None):
        super().__init__()
        self.layout = layout

        def own(tree: Params) -> torch.nn.ParameterDict:
            return torch.nn.ParameterDict({
                name: own(w) if isinstance(w, dict)
                else torch.nn.Parameter(w.to(device), requires_grad=False)
                for name, w in tree.items()
            })

        self.layers = own(params["layers"])
        self.top = own({name: w for name, w in params.items() if name != "layers"})

    def params(self) -> Params:
        def tree(owned: torch.nn.ParameterDict) -> Params:
            return {
                name: tree(w) if isinstance(w, torch.nn.ParameterDict) else w
                for name, w in owned.items()
            }

        out = {**tree(self.top), "layers": tree(self.layers)}
        if self.layout is None:
            return out
        ranked = RankParams(out)
        ranked.layout = self.layout
        return ranked


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer parameters (views); a
    quantized leaf gives layer ``i``'s payload and scale."""
    return {
        name: {k: v[i] for k, v in w.items()} if isinstance(w, dict) else w[i]
        for name, w in params["layers"].items()
    }


def _w(leaf: Any, dtype: torch.dtype) -> torch.Tensor:
    """The weight read seam: a plain tensor passes through; a quantized leaf
    is dequantized to bf16, as the JAX package does whatever the model's
    dtype, then cast to the activations' ``dtype`` (bf16 → f32 is exact, as
    the JAX package's einsum promotion)."""
    if isinstance(leaf, dict):
        return dequant(leaf).to(dtype)
    return leaf


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` [..., seq] → [..., seq, hd/2]."""
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim
    )
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs. x: [B, S, N, hd]; cos/sin: [B, S, hd/2]."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attn_qkv(
    x: torch.Tensor,  # [B, S, D]
    lp: Params,  # one layer's params
    cos: torch.Tensor,
    sin: torch.Tensor,
    eps: float,
    q_tables: "tuple[torch.Tensor, torch.Tensor] | None" = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block's attention front half: norm → QKV projections → rope
    (the queries by ``q_tables`` when given, else by cos/sin as the keys)."""
    h = rms_norm(x, lp["attn_norm"], eps)
    q = torch.einsum("bsd,dnh->bsnh", h, _w(lp["wq"], h.dtype))
    k = torch.einsum("bsd,dkh->bskh", h, _w(lp["wk"], h.dtype))
    v = torch.einsum("bsd,dkh->bskh", h, _w(lp["wv"], h.dtype))
    return apply_rope(q, *(q_tables or (cos, sin))), apply_rope(k, cos, sin), v


def attn_out_mlp(
    x: torch.Tensor,  # [B, S, D] residual stream
    attn: torch.Tensor,  # [B, S, H, hd]
    lp: Params,
    eps: float,
    layout: Any = None,
) -> torch.Tensor:
    """The block's back half: output projection + residual + SwiGLU MLP.
    On a rank whose ``wo`` (``w_down``) is split over tp, the product is
    this rank's partial sum: summed over tp before the residual add."""
    out = torch.einsum("bsnh,nhd->bsd", attn, _w(lp["wo"], attn.dtype))
    if layout is not None and layout.heads:
        out = layout.comm.tp_sum(out)
    x = x + out
    h = rms_norm(x, lp["mlp_norm"], eps)
    gate = torch.einsum("bsd,df->bsf", h, _w(lp["w_gate"], h.dtype))
    up = torch.einsum("bsd,df->bsf", h, _w(lp["w_up"], h.dtype))
    act = F.silu(gate) * up
    down = torch.einsum("bsf,fd->bsd", act, _w(lp["w_down"], act.dtype))
    if layout is not None and layout.ff:
        down = layout.comm.tp_sum(down)
    return x + down


def lm_logits(x: torch.Tensor, params: Params, eps: float) -> torch.Tensor:
    """Final norm + (tied or untied) LM head; a rank's vocab-split logits
    are gathered over tp, in rank order (the whole vocabulary, so every
    rank's argmax and sampling see what one device's see)."""
    x = rms_norm(x, params["final_norm"], eps)
    head = params.get("lm_head")
    if head is None:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, _w(head, x.dtype))
    layout = layout_of(params)
    if layout is not None and layout.vocab is not None:
        logits = layout.comm.tp_gather(logits, dim=-1)
    return logits


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding gather; a rank holding a vocab slice looks up its own
    rows, zeroes the rest, and the ranks' rows are summed over tp."""
    table = params["embed"]
    layout = layout_of(params)
    if layout is None or layout.vocab is None:
        return table[tokens]
    lo, n = layout.vocab
    local = tokens.to(torch.int64) - lo
    mine = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
    return layout.comm.tp_sum(x)


def kv_heads(params: Params, config: ModelConfig) -> int:
    """The kv heads this rank's caches hold (all of them on one device)."""
    layout = layout_of(params)
    return config.n_kv_heads if layout is None else layout.kv_heads


def _einsum_f32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with f32 accumulation and an f32 result."""
    return torch.einsum(spec, a.to(torch.float32), b.to(torch.float32))


def attention_xla(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k_cache: torch.Tensor,  # [B, K, Skv, hd]
    v_cache: torch.Tensor,  # [B, K, Skv, hd]
    q_pos: torch.Tensor,  # [B, Sq] absolute positions of the queries
    seq_lens: torch.Tensor,  # [B] total valid kv per sequence
) -> torch.Tensor:
    """The plain GQA attention over the cache, masked by position/length
    (the JAX package's XLA einsum path): the whole [Sq, Skv] score matrix,
    a softmax, and the probabilities rounded to the cache dtype."""
    B, Sq, H, hd = q.shape
    K, Skv = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, K, G, hd)
    scores = _einsum_f32("bqkgh,bksh->bkgqs", qg, k_cache) * scale
    kv_pos = torch.arange(Skv, device=q.device)[None, None, :]
    mask = (kv_pos <= q_pos[:, :, None]) & (kv_pos < seq_lens[:, None, None])
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(k_cache.dtype)
    out = _einsum_f32("bkgqs,bksh->bqkgh", probs, v_cache)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def prefill_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k_cache: torch.Tensor,  # [B, K, Skv, hd]
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,  # [B, Sq]
    seq_lens: torch.Tensor,  # [B]
    *,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Prefill attention dispatch: ``"auto"`` → the flash kernel on CUDA
    tensors (its plain version on CPU tensors); ``"plain"`` → attention_xla."""
    if attn_impl == "plain":
        return attention_xla(q, k_cache, v_cache, q_pos, seq_lens)
    if attn_impl != "auto":
        raise ValueError(f"unsupported attn_impl {attn_impl!r} (auto | plain)")
    # looked up at each call, so a caller may wrap the kernel's wrapper
    return _attention.prefill_attention(q, k_cache, v_cache, q_pos, seq_lens)


# --------------------------------------------------------------------------- #
# the transformer
# --------------------------------------------------------------------------- #


def forward(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int
    positions: torch.Tensor,  # [B, S] absolute positions
    kv_cache: tuple[torch.Tensor, torch.Tensor],  # ([L,B,K,Smax,hd], ...)
    seq_lens: torch.Tensor,  # [B] kv length AFTER inserting this chunk
    attn_window: int | None = None,  # attend only cache[..., :W, :]
    attn_impl: str = "auto",  # "auto" | "plain"
    insert_at: torch.Tensor | None = None,  # [B] explicit per-row write offset
    logits_at: torch.Tensor | None = None,  # [B] the one chunk position a row wants
    keyless_mean: torch.Tensor | None = None,  # [B] bool: rows that attend their window uniformly
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Run the decoder over a token chunk → (logits [B, S, V], cache), or
    [B, 1, V] at each row's ``logits_at`` position (the final norm and LM
    head then run on those positions only).

    The chunk's K/V are written into ``kv_cache`` IN PLACE at ``insert_at``
    (default: the chunk ends at ``seq_lens``), which stands in for the JAX
    package's buffer donation; the returned cache is the same tensors.

    A row with ``seq_lens`` 0 sees no key: the kernels answer its queries
    with 0.  A row set in ``keyless_mean`` (one with ``seq_lens`` 0) gets
    what the JAX package's XLA attention gives it instead (its ``-1e30``
    mask makes the softmax uniform): the mean of v over the whole window,
    computed by the same kernel as a zero query (its rope tables zeroed,
    which costs no pass over q) that sees every position of the window."""
    eps = config.norm_eps
    x = embed_tokens(params, tokens)  # [B, S, D]
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    if insert_at is None:
        insert_at = seq_lens - tokens.shape[1]  # where this chunk lands
    k_pages, v_pages = kv_cache
    W = attn_window or k_pages.shape[3]
    attn_pos, attn_lens, q_tables = positions, seq_lens, None
    if keyless_mean is not None:
        keep = (~keyless_mean)[:, None, None].to(cos.dtype)  # [B, 1, 1]
        q_tables = (cos * keep, sin * keep)
        attn_pos = torch.where(keyless_mean[:, None], W - 1, positions)
        attn_lens = torch.where(keyless_mean, W, seq_lens)
    for i in range(config.n_layers):
        lp = layer_params(params, i)
        q, k, v = attn_qkv(x, lp, cos, sin, eps, q_tables)
        _insert_chunk(k_pages[i], k, insert_at)
        _insert_chunk(v_pages[i], v, insert_at)
        attn = prefill_attention(
            q, k_pages[i, :, :, :W], v_pages[i, :, :, :W], attn_pos, attn_lens,
            attn_impl=attn_impl,
        )
        x = attn_out_mlp(x, attn, lp, eps, layout_of(params))
    if logits_at is not None:
        x = x[torch.arange(x.shape[0], device=x.device), logits_at][:, None]
    return lm_logits(x, params, eps), (k_pages, v_pages)


def decode_step_ring(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B, 1]
    kv_cache: tuple[torch.Tensor, torch.Tensor],  # main pages, READ-ONLY here
    ring: tuple[torch.Tensor, torch.Tensor],  # [L, T, B, K, hd] fresh-token ring
    t: int,  # this dispatch's step index (ring write slot)
    base_lens: torch.Tensor,  # [B] kv length at dispatch start (main cache)
    attn_window: int | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One decode step over the dense [L, B, K, S, hd] cache layout.

    Every step writes its K/V densely at ring slot ``t`` (the same slot for
    all rows, in place: no per-row scatter), attention merges (main cache ⊕
    ring) with a logsumexp combine, and :func:`consolidate_ring` writes the
    whole dispatch's tokens back in one pass."""
    k_pages, v_pages = kv_cache
    W = attn_window or k_pages.shape[3]
    return _decode_step_with_ring(
        params, config, tokens, ring, t, base_lens,
        lambda i, q, rk, rv: merged_decode_attention(
            q, k_pages[i, :, :, :W], v_pages[i, :, :, :W], rk, rv, base_lens, t
        ),
    )


def _decode_step_with_ring(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B, 1]
    ring: tuple[torch.Tensor, torch.Tensor],  # [L, T, B, K, hd], written in place
    t: int,
    base_lens: torch.Tensor,  # [B]
    attn_source: Any,  # (i, q, ring_k_i, ring_v_i) -> attn [B, 1, H, hd]
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """The decode-step transformer body; the main-cache read arrives as
    ``attn_source`` (the one thing a cache layout changes)."""
    eps = config.norm_eps
    positions = (base_lens + t)[:, None]  # [B, 1] absolute position
    x = embed_tokens(params, tokens)
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    ring_k, ring_v = ring
    for i in range(config.n_layers):
        lp = layer_params(params, i)
        q, k, v = attn_qkv(x, lp, cos, sin, eps)
        ring_k[i, t] = k[:, 0].to(ring_k.dtype)
        ring_v[i, t] = v[:, 0].to(ring_v.dtype)
        attn = attn_source(i, q, ring_k[i], ring_v[i])
        x = attn_out_mlp(x, attn, lp, eps, layout_of(params))
    return lm_logits(x, params, eps), (ring_k, ring_v)


def masked_attention_source(
    qg: torch.Tensor,  # [B, K, G, hd] (unscaled)
    k_cache: torch.Tensor,  # [B, K, S, hd]
    v_cache: torch.Tensor,
    valid: torch.Tensor,  # [B, S] bool — attendable positions
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One masked flash-stats attention source → (o unnormalized, m, z),
    m and z [B, K, G, 1]: -1e30 mask → max → -1e29 finite floor → exp/z."""
    scale = 1.0 / math.sqrt(qg.shape[-1])
    s = _einsum_f32("bkgh,bksh->bkgs", qg, k_cache) * scale
    s = torch.where(valid[:, None, None, :], s, -1e30)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e29)
    p = torch.exp(s - m).to(k_cache.dtype)
    z = p.to(torch.float32).sum(dim=-1, keepdim=True)
    o = _einsum_f32("bkgs,bksh->bkgh", p, v_cache)
    return o, m, z


def ring_attention_source(
    qg: torch.Tensor,  # [B, K, G, hd]
    ring_k: torch.Tensor,  # [T, B, K, hd]
    ring_v: torch.Tensor,
    t: int,  # ring slots 0..t valid
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fresh-token attention source (T ≤ steps per dispatch) →
    (o unnormalized, m, z) with m, z [B, K, G, 1]."""
    T = ring_k.shape[0]
    scale = 1.0 / math.sqrt(qg.shape[-1])
    s2 = _einsum_f32("bkgh,tbkh->bkgt", qg, ring_k) * scale  # [B,K,G,T]
    valid2 = (torch.arange(T, device=qg.device) <= t).reshape(1, 1, 1, T)
    s2 = torch.where(valid2, s2, -1e30)
    m2 = s2.amax(dim=-1, keepdim=True)
    p2 = torch.exp(s2 - m2).to(ring_k.dtype)
    z2 = p2.to(torch.float32).sum(dim=-1, keepdim=True)
    o2 = _einsum_f32("bkgt,tbkh->bkgh", p2, ring_v)
    return o2, m2, z2


def logsumexp_merge(
    a: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    b: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Combine two (o unnormalized, m, z) attention sources."""
    o1, m1, z1 = a
    o2, m2, z2 = b
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m)
    w2 = torch.exp(m2 - m)
    return (o1 * w1 + o2 * w2) / (z1 * w1 + z2 * w2)


# --------------------------------------------------------------------------- #
# ragged multi-query attention and the speculative verify step
# --------------------------------------------------------------------------- #


def ragged_attention_source(
    qg: torch.Tensor,  # [B, S, K, G, hd] multi-query, kv-grouped (unscaled)
    k_cache: torch.Tensor,  # [B, K, W, hd]
    v_cache: torch.Tensor,
    q_starts: torch.Tensor,  # [B] absolute position of each row's query 0
    kv_lens: torch.Tensor,  # [B] valid kv length each row may attend
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ragged multi-query attention source → (o unnormalized
    [B,K,G,S,hd], m [B,K,G,S,1], z [B,K,G,S,1]).

    One mask law serves every row kind (see :mod:`.ragged`): query ``j`` of
    row ``b`` attends kv positions ``< min(kv_lens[b], q_starts[b] + j + 1)``.
    Verify rows (start = kv_len) reduce to the plain length mask;
    prefill-kind rows (start < kv_len) get the within-row causal triangle.
    The probabilities are rounded to the cache dtype, as in the JAX
    package; in f32 (the ragged kernels' plain version) that is a no-op."""
    W = k_cache.shape[2]
    S = qg.shape[1]
    scale = 1.0 / math.sqrt(qg.shape[-1])
    s1 = _einsum_f32("bskgh,bkwh->bkgsw", qg, k_cache) * scale
    kv_pos = torch.arange(W, device=qg.device)[None, None, :]  # [1, 1, W]
    limit = torch.minimum(
        kv_lens[:, None], q_starts[:, None] + torch.arange(S, device=qg.device)[None, :] + 1
    )  # [B, S]
    valid = kv_pos < limit[:, :, None]  # [B, S, W]
    s1 = torch.where(valid[:, None, None, :, :], s1, -1e30)
    m1 = s1.amax(dim=-1, keepdim=True).clamp_min(-1e29)
    p1 = torch.exp(s1 - m1).to(k_cache.dtype)
    z1 = p1.to(torch.float32).sum(dim=-1, keepdim=True)
    o1 = _einsum_f32("bkgsw,bkwh->bkgsh", p1, v_cache)
    return o1, m1, z1


def verify_chunk_source(
    qg: torch.Tensor,  # [B, S, K, G, hd]
    ring_k: torch.Tensor,  # [S, B, K, hd] this layer's chunk K (ring layout)
    ring_v: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The verify chunk's self-attention source → (o, m, z) in the merge
    layout [B,K,G,S,·]: query j attends chunk slots 0..j (slot j is its own
    token).  The probabilities are rounded to the ring's dtype, as in the
    JAX package."""
    S = qg.shape[1]
    scale = 1.0 / math.sqrt(qg.shape[-1])
    s2 = _einsum_f32("bskgh,tbkh->bkgst", qg, ring_k) * scale
    slots = torch.arange(S, device=qg.device)
    causal = slots[None, :] <= slots[:, None]  # [S(query), S(chunk slot)]
    s2 = torch.where(causal[None, None, None, :, :], s2, -1e30)
    m2 = s2.amax(dim=-1, keepdim=True).clamp_min(-1e29)
    p2 = torch.exp(s2 - m2).to(ring_k.dtype)
    z2 = p2.to(torch.float32).sum(dim=-1, keepdim=True)
    o2 = _einsum_f32("bkgst,tbkh->bkgsh", p2, ring_v)
    return o2, m2, z2


def _verify_step_with_ring(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B, S] fed tokens: [last, d_0, .., d_{S-2}]
    base_lens: torch.Tensor,  # [B] kv length at dispatch start
    ring_dtype: torch.dtype,
    attn_source: Any,  # (i, q [B,S,H,hd], ring_k_i, ring_v_i) -> [B, S, H, hd]
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """The speculative-verify transformer body: the decode step generalized
    from one query to S = k+1 per row.  The drafted chunk runs as ONE
    forward; its K/V land densely in a chunk ring [L, S, B, K, hd] (slot j
    = the token at position ``base_lens + j``, written in place per layer),
    attention merges (main cache ⊕ causal chunk), and the caller
    consolidates the ring like a decode dispatch's: rejected slots sit past
    the advanced length and the next wave overwrites them."""
    eps = config.norm_eps
    B, S = tokens.shape
    positions = base_lens[:, None] + torch.arange(S, device=tokens.device)[None, :]
    x = embed_tokens(params, tokens)
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    ring_shape = (config.n_layers, S, B, kv_heads(params, config), config.head_dim)
    ring_k = torch.zeros(ring_shape, dtype=ring_dtype, device=tokens.device)
    ring_v = torch.zeros(ring_shape, dtype=ring_dtype, device=tokens.device)
    for i in range(config.n_layers):
        lp = layer_params(params, i)
        q, k, v = attn_qkv(x, lp, cos, sin, eps)
        ring_k[i] = k.transpose(0, 1).to(ring_dtype)  # [B, S, K, hd] -> [S, B, K, hd]
        ring_v[i] = v.transpose(0, 1).to(ring_dtype)
        attn = attn_source(i, q, ring_k[i], ring_v[i])
        x = attn_out_mlp(x, attn, lp, eps, layout_of(params))
    return lm_logits(x, params, eps), (ring_k, ring_v)  # logits [B, S, V]


def verify_step_ring(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B, S] fed tokens
    kv_cache: tuple[torch.Tensor, torch.Tensor],  # window-sliced, READ-ONLY here
    base_lens: torch.Tensor,  # [B]
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Speculative verify over the dense cache layout → (logits [B, S, V],
    chunk ring [L, S, B, K, hd] ×2 for :func:`consolidate_ring`).  Each
    layer's main-cache read is one :func:`attention.verify_attention`: the
    ragged kernel reads the window once for all S queries."""
    k_pages, v_pages = kv_cache
    return _verify_step_with_ring(
        params, config, tokens, base_lens, k_pages.dtype,
        lambda i, q, rk, rv: verify_attention(q, k_pages[i], v_pages[i], rk, rv, base_lens),
    )


def verify_step_ring_paged(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B, S]
    pool: tuple[torch.Tensor, torch.Tensor],  # [L, N, K, page, hd] READ-ONLY here
    tables: torch.Tensor,  # [B, Pmax]
    base_lens: torch.Tensor,  # [B]
    wpages: int,  # window bucket in pages
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Speculative verify reading KV through the block tables → (logits,
    chunk ring for :func:`consolidate_ring_paged`).  Each layer hands the
    WHOLE pool and its layer index to :func:`attention.verify_attention_paged`."""
    pool_k, pool_v = pool
    return _verify_step_with_ring(
        params, config, tokens, base_lens, pool_k.dtype,
        lambda i, q, rk, rv: verify_attention_paged(
            q, pool_k, pool_v, i, tables, rk, rv, base_lens, wpages=wpages
        ),
    )


def consolidate_ring(
    kv_cache: tuple[torch.Tensor, torch.Tensor],  # [L, B, K, S, hd], updated in place
    ring: tuple[torch.Tensor, torch.Tensor],  # [L, T, B, K, hd]
    base_lens: torch.Tensor,  # [B] where each row's ring tokens begin
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write the dispatch's ring tokens into the main cache, per row at
    ``base_lens`` (IN PLACE; no host sync).  Rows whose requests already
    retired write beyond their valid length, which is masked and later
    overwritten.  Offsets clamp so the chunk fits, as a JAX
    ``dynamic_update_slice`` does."""
    k_pages, v_pages = kv_cache
    for pages, r in ((k_pages, ring[0]), (v_pages, ring[1])):
        L, B, K, S, hd = pages.shape
        T = r.shape[1]
        chunk = r.permute(0, 2, 3, 1, 4).to(pages.dtype)  # [L, B, K, T, hd]
        pages.scatter_(3, _row_span(base_lens, T, S, (L, B, K, T, hd), 1), chunk)
    return k_pages, v_pages


def _row_span(
    offsets: torch.Tensor, n: int, size: int, shape: tuple, row_dim: int
) -> torch.Tensor:
    """Scatter index of ``n`` consecutive positions per row starting at
    ``offsets`` (clamped into [0, size - n]), broadcast to ``shape`` with the
    rows on ``row_dim`` and the positions on the second-to-last axis."""
    start = offsets.to(torch.int64).clamp(0, max(size - n, 0))
    idx = start[:, None] + torch.arange(n, device=offsets.device)[None, :]  # [B, n]
    view = [1] * len(shape)
    view[row_dim] = idx.shape[0]
    view[-2] = n
    return idx.reshape(view).expand(shape)


def _insert_chunk(
    cache: torch.Tensor,  # [B, K, Smax, hd], updated in place
    chunk: torch.Tensor,  # [B, S, K, hd]
    offsets: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Per-row write of the chunk at each sequence's offset (in place)."""
    B, K, Smax, hd = cache.shape
    S = chunk.shape[1]
    src = chunk.transpose(1, 2).to(cache.dtype)  # [B, K, S, hd]
    cache.scatter_(2, _row_span(offsets, S, Smax, (B, K, S, hd), 0), src)
    return cache


def make_empty_cache(
    config: ModelConfig, batch: int, max_seq: int, dtype: Any = None,
    device: "torch.device | str" = "cuda", kv_heads: "int | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A dense cache [L, batch, K, max_seq, hd] (a rank's: ``kv_heads``)."""
    dtype = torch_dtype(dtype or config.dtype)
    K = config.n_kv_heads if kv_heads is None else kv_heads
    shape = (config.n_layers, batch, K, max_seq, config.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


# --------------------------------------------------------------------------- #
# paged KV cache (block-table indirection; see inference/paged.py)
# --------------------------------------------------------------------------- #


def make_page_pool(
    config: ModelConfig, num_pages: int, page_size: int, dtype: Any = None,
    device: "torch.device | str" = "cuda", kv_heads: "int | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """KV page pool [L, N, K, page, hd] (a rank's: ``kv_heads``); page 0 is
    the trash page."""
    dtype = torch_dtype(dtype or config.dtype)
    K = config.n_kv_heads if kv_heads is None else kv_heads
    shape = (config.n_layers, num_pages, K, page_size, config.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def gather_window_paged(
    pool_layer: torch.Tensor,  # [N, K, page, hd] one layer's pages
    tables: torch.Tensor,  # [B, Pmax] int block tables
    wpages: int,  # pages per attention window
) -> torch.Tensor:
    """Materialize each row's window from its pages → [B, K, wpages·page, hd].

    The plain read path, a copy of the window: the plain version of the
    paged decode kernel and the tests use it.  The engine never calls it on
    a CUDA tensor, where the kernel reads the pages in place."""
    B = tables.shape[0]
    N, K, page, hd = pool_layer.shape
    gathered = pool_layer[tables[:, :wpages].to(torch.int64)]  # [B, wp, K, page, hd]
    return gathered.permute(0, 2, 1, 3, 4).reshape(B, K, wpages * page, hd)


def decode_step_ring_paged(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B, 1]
    pool: tuple[torch.Tensor, torch.Tensor],  # [L, N, K, page, hd] READ-ONLY here
    tables: torch.Tensor,  # [B, Pmax] block tables
    ring: tuple[torch.Tensor, torch.Tensor],  # [L, T, B, K, hd], written in place
    t: int,  # this dispatch's step index (ring write slot)
    base_lens: torch.Tensor,  # [B]
    wpages: int,  # window bucket in pages
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One decode step reading KV through the block tables.

    Shares the transformer body with :func:`decode_step_ring`; only the
    main-cache read differs.  Each layer hands the WHOLE pool and its layer
    index to :func:`merged_paged_decode_attention`: no layer or window is
    copied."""
    pool_k, pool_v = pool
    return _decode_step_with_ring(
        params, config, tokens, ring, t, base_lens,
        lambda i, q, rk, rv: merged_paged_decode_attention(
            q, pool_k, pool_v, i, tables, rk, rv, base_lens, t, wpages=wpages
        ),
    )


def consolidate_ring_paged(
    pool: tuple[torch.Tensor, torch.Tensor],  # [L, N, K, page, hd], updated in place
    ring: tuple[torch.Tensor, torch.Tensor],  # [L, T, B, K, hd]
    tables: torch.Tensor,  # [B, Pmax]
    base_lens: torch.Tensor,  # [B]
    active: torch.Tensor,  # [B] bool — inactive rows scatter to the trash page
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write the dispatch's ring tokens through the block tables, IN PLACE
    (the JAX package donates the pool instead), one scatter per dispatch.

    Inactive rows go to page 0, the trash page: a retired slot's pages may
    already belong to a new request, so its stale row must not write
    through its old table entries.  The engine folds ``done_prev`` into
    ``active`` first, so a row that retired inside the previous, still
    in-flight dispatch writes to the trash page too.  Positions past the
    table's ``Pmax`` entries (a dispatch overshooting a retiring row's cap)
    also go to the trash page."""
    pool_k, pool_v = pool
    ring_k, ring_v = ring
    T = ring_k.shape[1]
    page = pool_k.shape[3]
    pmax = tables.shape[1]
    pos = base_lens.to(torch.int64)[:, None] + torch.arange(T, device=tables.device)[None, :]
    logical = pos // page  # [B, T] which table entry
    in_range = logical < pmax
    page_ids = torch.gather(tables.to(torch.int64), 1, logical.clamp(max=pmax - 1))
    page_ids = torch.where(active[:, None] & in_range, page_ids, 0)
    offsets = pos % page
    for side, r in ((pool_k, ring_k), (pool_v, ring_v)):
        # non-adjacent index tensors put their [B, T] dims first: [B, T, L, K, hd]
        side[:, page_ids, :, offsets] = r.permute(2, 1, 0, 3, 4).to(side.dtype)
    return pool_k, pool_v


def write_prefill_pages(
    pool: tuple[torch.Tensor, torch.Tensor],  # [L, N, K, page, hd], updated in place
    scratch: tuple[torch.Tensor, torch.Tensor],  # [L, R, K, P, hd] prefill K/V
    page_ids: torch.Tensor,  # [R, P // page] int destination pages
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter whole prefill pages into the pool, IN PLACE (page-granular
    writes; the JAX package donates the pool instead)."""
    pool_k, pool_v = pool
    sk, sv = scratch
    L, R, K, P, hd = sk.shape
    page = pool_k.shape[3]
    npg = P // page
    ids = page_ids.reshape(-1).to(torch.int64)
    for side, s in ((pool_k, sk), (pool_v, sv)):
        blocks = s.reshape(L, R, K, npg, page, hd).permute(0, 1, 3, 2, 4, 5)
        side[:, ids] = blocks.reshape(L, R * npg, K, page, hd).to(side.dtype)
    return pool_k, pool_v
