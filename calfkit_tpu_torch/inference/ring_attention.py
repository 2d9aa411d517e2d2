"""The long-context lane's attention and dispatches on one device (sp = 1).

The counterpart of ``calfkit_tpu.inference.ring_attention`` at a sequence
axis of one device: the JAX package shards a long prompt over an ``sp``
mesh axis and rotates K/V blocks around the ring; with one device the ring
has one block, and no collective is left:

- :func:`ring_attention` is causal GQA attention over the whole prompt,
  which is the prefill kernel's function (``attention.prefill_attention``
  with ``q_pos = arange(S)``);
- :func:`context_parallel_attention` is one masked (o, m, z) source over the
  whole prefix, which is the dense decode kernel's function
  (``attention.decode_attention``), merged with the fresh-token source by
  :func:`model.logsumexp_merge`;
- :func:`prefill_sequence_parallel` and :func:`decode_sp_dispatch` are the
  serving engine's long prefill and its carried decode dispatch, the same
  transformer helpers (:func:`model.attn_qkv`, :func:`model.attn_out_mlp`,
  :func:`model.lm_logits`) as the dense paths.

The signatures drop the JAX package's ``mesh`` and ``axis``; an ``sp`` other
than 1 is refused: sharding the sequence over several cards belongs to the
multi-device slice of the port.  Where the JAX package passes a buffer to be
donated, these functions write the engine's buffer in place (``cache=`` of
the prefill, ``fresh`` of the decode dispatch), so a CUDA graph can capture
them at fixed addresses; ``t0`` and ``prefix_lens`` are tensors, so one
capture serves every dispatch of a request.
"""

from __future__ import annotations

import torch

from calfkit_tpu_torch.inference import attention as _attention
from calfkit_tpu_torch.inference import model as M


def _check_sp(sp: int) -> None:
    if sp != 1:
        raise ValueError(
            f"sp={sp}: sequence parallelism over several devices is the "
            "multi-device slice of the port; this module serves sp = 1"
        )


def ring_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    seq_lens: "torch.Tensor | None" = None,  # [B] valid tokens; None = all S
    *,
    sp: int = 1,
) -> torch.Tensor:
    """Causal GQA attention over the whole sequence → [B, S, H, hd] in q's
    dtype.  Positions >= a row's length neither attend usefully nor get
    attended (their outputs are garbage the caller ignores)."""
    _check_sp(sp)
    B, S = q.shape[:2]
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
    q_pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    return _attention.prefill_attention(
        q, k.transpose(1, 2), v.transpose(1, 2), q_pos, seq_lens.to(torch.int32)
    )


def single_device_causal_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,
    seq_lens: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """The plain reference the ring must match: the serving path's
    :func:`model.attention_xla` over the same positions."""
    B, S = q.shape[:2]
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
    positions = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    return M.attention_xla(q, k.transpose(1, 2), v.transpose(1, 2), positions, seq_lens)


def prefill_sequence_parallel(
    params: dict,
    config,
    tokens: torch.Tensor,  # [B, S] int
    seq_lens: "torch.Tensor | None" = None,  # [B] true prompt lengths
    cache: "tuple[torch.Tensor, torch.Tensor] | None" = None,  # [L, B, K, S, hd]
    *,
    sp: int = 1,
) -> "tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]":
    """A long prompt's prefill → (``last_logits`` [B, V] at each row's last
    valid position, ``(k, v)`` [L, B, K, S, hd]).  Positions >= a row's
    length hold garbage, masked by ``seq_lens`` downstream.

    The attention of each layer reads that layer's fresh K/V in the
    activations' dtype; ``cache``, when given, receives them in place (cast
    to its dtype) and is returned, else they are returned in the
    activations' dtype."""
    _check_sp(sp)
    B, S = tokens.shape
    dev = tokens.device
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    eps = config.norm_eps
    x = params["embed"][tokens]  # [B, S, D]
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    cos, sin = M.rope_tables(positions, config.head_dim, config.rope_theta)
    ks, vs = [], []
    for i in range(config.n_layers):
        lp = M.layer_params(params, i)
        q, k, v = M.attn_qkv(x, lp, cos, sin, eps)
        attn = ring_attention(q, k, v, seq_lens)
        if cache is None:
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        else:
            cache[0][i].copy_(k.transpose(1, 2))
            cache[1][i].copy_(v.transpose(1, 2))
        x = M.attn_out_mlp(x, attn, lp, eps)
    kv = cache if cache is not None else (torch.stack(ks), torch.stack(vs))
    # gather the last valid hidden state FIRST, then the head: logits of
    # every position would be [B, S, V]
    idx = (seq_lens.to(torch.int64) - 1).clamp(0, S - 1)
    x_last = x[torch.arange(B, device=dev), idx][:, None]  # [B, 1, D]
    return M.lm_logits(x_last, params, eps)[:, 0], kv


def context_parallel_attention(
    q: torch.Tensor,  # [B, 1, H, hd] one decode step's queries
    k_prefix: torch.Tensor,  # [B, K, S, hd]
    v_prefix: torch.Tensor,
    prefix_lens: torch.Tensor,  # [B] valid prefix tokens
    *,
    sp: int = 1,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Decode attention over the whole prefix → (o [B, K, G, hd]
    unnormalized, m [B, K, G, 1], z [B, K, G, 1]) in f32, the source that
    :func:`model.logsumexp_merge` folds with the fresh tokens'."""
    _check_sp(sp)
    B, _, H, hd = q.shape
    K = k_prefix.shape[1]
    o, m, z = _attention.decode_attention(
        q.reshape(B, K, H // K, hd), k_prefix, v_prefix, prefix_lens.to(torch.int32)
    )
    return o, m[..., None], z[..., None]


def decode_sp_dispatch(
    params: dict,
    config,
    token: torch.Tensor,  # [B] last sampled token (enters this dispatch)
    prefix: "tuple[torch.Tensor, torch.Tensor]",  # [L, B, K, S, hd]
    prefix_lens: torch.Tensor,  # [B]
    fresh: "tuple[torch.Tensor, torch.Tensor]",  # [L, B, K, cap, hd], in place
    t0: torch.Tensor,  # [1] int: fresh tokens already generated
    steps: int,
    *,
    sp: int = 1,
) -> "tuple[torch.Tensor, torch.Tensor, tuple[torch.Tensor, torch.Tensor]]":
    """One long-lane decode dispatch: ``steps`` greedy tokens against the
    prefix, the fresh K/V of step i written in place at slot ``t0 + i``
    (an indexed copy at a device index) → (toks [B, steps], last [B],
    fresh)."""
    _check_sp(sp)
    k_prefix, v_prefix = prefix
    fresh_k, fresh_v = fresh
    B = token.shape[0]
    Kh, hd, eps = config.n_kv_heads, config.head_dim, config.norm_eps
    t0 = t0.reshape(1).to(torch.int64)
    toks = []
    for i in range(steps):
        t = t0 + i  # the global fresh index: carries across dispatches
        positions = (prefix_lens.to(torch.int64) + t)[:, None]  # [B, 1]
        x = params["embed"][token[:, None]]
        cos, sin = M.rope_tables(positions, hd, config.rope_theta)
        for layer in range(config.n_layers):
            lp = M.layer_params(params, layer)
            q, k, v = M.attn_qkv(x, lp, cos, sin, eps)
            fk, fv = fresh_k[layer], fresh_v[layer]  # [B, K, cap, hd]
            fk.index_copy_(2, t, k.transpose(1, 2).to(fk.dtype))
            fv.index_copy_(2, t, v.transpose(1, 2).to(fv.dtype))
            prefix_source = context_parallel_attention(
                q, k_prefix[layer], v_prefix[layer], prefix_lens
            )
            fresh_source = M.ring_attention_source(
                q.reshape(B, Kh, -1, hd), fk.permute(2, 0, 1, 3), fv.permute(2, 0, 1, 3), t
            )
            attn = M.logsumexp_merge(prefix_source, fresh_source)
            x = M.attn_out_mlp(x, attn.reshape(B, 1, -1, hd).to(x.dtype), lp, eps)
        logits = M.lm_logits(x, params, eps)[:, -1]
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(token)
    return torch.stack(toks, dim=1), token, fresh


def decode_with_sharded_prefix(
    params: dict,
    config,
    first_token: torch.Tensor,  # [B] the token sampled from the prefill logits
    prefix: "tuple[torch.Tensor, torch.Tensor]",  # [L, B, K, S, hd]
    prefix_lens: torch.Tensor,  # [B]
    steps: int,
    *,
    sp: int = 1,
) -> torch.Tensor:
    """Greedy-decode ``steps`` tokens against a prefilled prefix → [B,
    steps] int32: the one-shot form of :func:`decode_sp_dispatch`, with a
    fresh cache of ``steps`` slots."""
    _check_sp(sp)
    B = first_token.shape[0]
    shape = (config.n_layers, B, config.n_kv_heads, steps, config.head_dim)
    dev = first_token.device
    fresh = (
        torch.zeros(shape, dtype=torch.float32, device=dev),
        torch.zeros(shape, dtype=torch.float32, device=dev),
    )
    t0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    toks, _last, _fresh = decode_sp_dispatch(
        params, config, first_token, prefix, prefix_lens, fresh, t0, steps
    )
    return toks
