"""The long-context lane's attention and dispatches: the sequence sharded
over the ranks of an engine (sp = tp·dp), or held whole on one device.

The counterpart of ``calfkit_tpu.inference.ring_attention``.  The JAX
package shards a long prompt over an ``sp`` mesh axis of every device of
the engine and runs its functions under ``shard_map``; the port runs one
process a rank (:mod:`.distributed`), and each function here is what one
rank computes: it takes the rank's block and returns the rank's block, as
the reference's ``shard_map`` body sees them.  Rank i of the sp group
(:class:`distributed.Comm`, ``sp_index``; the rank ``ranks[d, t]`` of the
mesh is ``d * tp + t``) holds positions ``[i * S/sp, (i + 1) * S/sp)`` of a
prompt padded to S, with every kv head.  A ``comm`` of ``None`` is the sp =
1 ring of one device, where no collective is left:

- :func:`ring_attention` is causal GQA attention.  At sp = 1 it is the
  prefill kernel's function (``attention.prefill_attention`` with ``q_pos =
  arange(S)``); at sp > 1 each rank keeps its query block and folds the K/V
  blocks as they rotate around the ring (:meth:`Comm.sp_ring`, n - 1 hops,
  the last fold without one), each fold an (o, m, z) source of the ragged
  kernel (``attention.ragged_attention``, whose mask law covers every fold:
  an earlier block is seen whole, the rank's own block causally, a later
  block not at all, so it is skipped), merged in f32;
- :func:`context_parallel_attention` is one masked (o, m, z) source over
  the prefix, the dense decode kernel's function (``attention.decode_attention``)
  over the rank's block, merged over the ranks with ``sp_max`` and
  ``sp_sum`` (the result is the same on every rank);
- :func:`prefill_sequence_parallel` and :func:`decode_sp_dispatch` are the
  serving engine's long prefill and its carried decode dispatch, the same
  transformer helpers (:func:`model.attn_qkv`, :func:`model.attn_out_mlp`,
  :func:`model.lm_logits`) as the dense paths;
  :func:`prefill_chunk_sequence_parallel` is one chunk of the chunked long
  prefill at sp > 1 (at sp = 1 the engine runs the short lane's chunk).

At tp > 1 a rank's weights are its tp shard (:mod:`.sharding`).  The
prefill computes a block of its own over every head, so it gathers each
layer whole over the tp group (dequantized in the activations' dtype,
which for the int8 and int4 leaves is the shard of the dequantized leaf),
one layer at a time.  The decode and the chunks keep the shard: the rank
gathers the queries over tp, scores its block for every head, merges over
sp, and keeps its own heads.

Where the JAX package passes a buffer to be donated, these functions write
the engine's buffer in place (``cache=`` of the prefill, ``fresh`` of the
decode dispatch, ``prefix`` of the chunk), so a CUDA graph can capture them
at fixed addresses; ``t0``, ``offset`` and ``prefix_lens`` are tensors, so
one capture serves every dispatch of a request.
"""

from __future__ import annotations

from typing import Any

import torch

from calfkit_tpu_torch.inference import attention as _attention
from calfkit_tpu_torch.inference import model as M
from calfkit_tpu_torch.inference.sharding import kv_span


def _sp(comm: Any) -> int:
    return 1 if comm is None else comm.sp


def _full_lens(lens: "torch.Tensor | None", B: int, S: int, dev: torch.device) -> torch.Tensor:
    if lens is None:
        return torch.full((B,), S, dtype=torch.int32, device=dev)
    return lens.to(torch.int32)


def _fold(
    a: "tuple[torch.Tensor, torch.Tensor, torch.Tensor]",
    b: "tuple[torch.Tensor, torch.Tensor, torch.Tensor]",
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Two (o unnormalized, m, z) sources as one, m and z shaped like o[...,
    0]: the logsumexp law of :func:`model.logsumexp_merge`, unnormalized."""
    (o1, m1, z1), (o2, m2, z2) = a, b
    m = torch.maximum(m1, m2)
    w1, w2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return o1 * w1[..., None] + o2 * w2[..., None], m, z1 * w1 + z2 * w2


def _sp_merge(
    source: "tuple[torch.Tensor, torch.Tensor, torch.Tensor]", comm: Any
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Every rank's (o, m, z) source over its block as the one source over
    the whole sequence, the same on every rank: the max of m over sp, each
    rank's o and z rescaled to it, summed over sp (in one all-reduce)."""
    o, m, z = source
    m_all = comm.sp_max(m.clone())
    w = torch.exp(m - m_all)
    packed = comm.sp_sum(torch.cat([(o * w[..., None]).reshape(-1), (z * w).reshape(-1)]))
    return packed[:o.numel()].view(o.shape), m_all, packed[o.numel():].view(z.shape)


def _whole_heads(x: torch.Tensor, dim: int, config, layout: Any) -> torch.Tensor:
    """``x``, holding the kv heads this rank of a tp group attends along
    ``dim``, with every kv head of the model: gathered over tp, and where
    the kv heads are replicated and narrowed (:func:`sharding.kv_span`),
    each head taken from a rank that holds it."""
    K = config.n_kv_heads
    if layout is None or x.shape[dim] == K:
        return x
    parts = layout.comm.tp_gather(x, dim)
    if x.shape[dim] * layout.tp == K and K % layout.tp == 0:
        return parts  # split over tp: the shards in rank order
    n = x.shape[dim]
    spans = [kv_span(config, layout.tp, t) for t in range(layout.tp)]
    picks = []
    for head in range(K):
        t = next(t for t, (lo, cnt) in enumerate(spans) if lo <= head < lo + cnt)
        picks.append(parts.narrow(dim, t * n + head - spans[t][0], 1))
    return torch.cat(picks, dim=dim)


def _whole_layer(lp: dict, config, layout: Any, dtype: torch.dtype) -> dict:
    """One layer's weights whole on a rank of a tp group: each leaf the tp
    split cut, dequantized in ``dtype`` and gathered over tp (a shard
    dequantizes to the shard of the dequantized leaf); the rest as given."""
    if layout is None or layout.tp == 1:
        return lp
    comm = layout.comm
    out = dict(lp)
    if layout.heads:  # wq [D, H/tp, hd], wo [H/tp, hd, D]
        out["wq"] = comm.tp_gather(M._w(lp["wq"], dtype), 1)
        out["wo"] = comm.tp_gather(M._w(lp["wo"], dtype), 0)
    for name in ("wk", "wv"):  # [D, kv, hd]
        out[name] = _whole_heads(M._w(lp[name], dtype), 1, config, layout)
    if layout.ff:  # w_gate/w_up [D, F/tp], w_down [F/tp, D]
        out["w_gate"] = comm.tp_gather(M._w(lp["w_gate"], dtype), 1)
        out["w_up"] = comm.tp_gather(M._w(lp["w_up"], dtype), 1)
        out["w_down"] = comm.tp_gather(M._w(lp["w_down"], dtype), 0)
    return out


def _own_heads(x: torch.Tensor, dim: int, layout: Any) -> torch.Tensor:
    """This rank's query heads of ``x``, which holds every head along
    ``dim`` (the rank's are the tp-th slice where the heads split)."""
    if layout is None or not layout.heads:
        return x
    n = x.shape[dim] // layout.tp
    return x.narrow(dim, layout.t * n, n)


def _all_heads(q: torch.Tensor, layout: Any) -> torch.Tensor:
    """[B, S, H/tp, hd] queries of this rank → [B, S, H, hd], gathered over
    tp where the heads split."""
    if layout is None or not layout.heads:
        return q
    return layout.comm.tp_gather(q, 2)


# --------------------------------------------------------------------------- #
# ring attention
# --------------------------------------------------------------------------- #


def ring_attention(
    q: torch.Tensor,  # [B, S/sp, H, hd] this rank's query block
    k: torch.Tensor,  # [B, S/sp, K, hd] this rank's K/V block
    v: torch.Tensor,
    seq_lens: "torch.Tensor | None" = None,  # [B] valid tokens; None = all S
    *,
    comm: Any = None,
) -> torch.Tensor:
    """Causal GQA attention of the rank's query block over the whole
    sequence → [B, S/sp, H, hd] in q's dtype.  Positions >= a row's length
    neither attend usefully nor get attended (their outputs are garbage the
    caller ignores)."""
    B, blk, H, hd = q.shape
    dev = q.device
    n = _sp(comm)
    lens = _full_lens(seq_lens, B, blk * n, dev)
    if n == 1:
        q_pos = torch.arange(blk, dtype=torch.int32, device=dev).expand(B, blk)
        return _attention.prefill_attention(q, k.transpose(1, 2), v.transpose(1, 2), q_pos, lens)
    Kh = k.shape[2]
    my = comm.sp_index
    qg = q.reshape(B, blk, Kh, H // Kh, hd).transpose(1, 2)  # [B, K, blk, G, hd]
    acc = None
    for r in range(n):
        # the block held now came from rank (my - r) mod n
        src = (my - r) % n
        if src <= my:  # a later block is masked whole: skipped
            start = torch.full((B,), blk if src < my else 0, dtype=torch.int32, device=dev)
            kv_len = (lens - src * blk).clamp(0, blk)
            source = _attention.ragged_attention(
                qg, k.transpose(1, 2), v.transpose(1, 2), start, kv_len
            )
            acc = source if acc is None else _fold(acc, source)
        if r < n - 1:  # the last fold needs no rotation after it
            k, v = comm.sp_ring(k, v)
    o, _, z = acc  # [B, K, blk, G, hd], [B, K, blk, G]
    out = o / z.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).reshape(B, blk, H, hd).to(q.dtype)


def single_device_causal_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,
    seq_lens: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """The plain reference the ring must match: the serving path's
    :func:`model.attention_xla` over the same positions."""
    B, S = q.shape[:2]
    seq_lens = _full_lens(seq_lens, B, S, q.device)
    positions = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    return M.attention_xla(q, k.transpose(1, 2), v.transpose(1, 2), positions, seq_lens)


# --------------------------------------------------------------------------- #
# sequence-parallel prefill
# --------------------------------------------------------------------------- #


def _embed_block(
    params: dict, tokens: torch.Tensor, lo: int, blk: int, layout: Any
) -> torch.Tensor:
    """The embeddings of positions [lo, lo + blk) of ``tokens``.  A vocab
    split over tp is looked up over the span of the rank's tp group (its
    ranks hold consecutive blocks), each rank its own rows summed over tp,
    and the rank keeps its block."""
    if layout is None or layout.vocab is None:
        return params["embed"][tokens[:, lo:lo + blk]]
    span = layout.tp * blk
    first = layout.d * span
    x = M.embed_tokens(params, tokens[:, first:first + span])
    return x[:, layout.t * blk:(layout.t + 1) * blk]


def prefill_sequence_parallel(
    params: dict,
    config,
    tokens: torch.Tensor,  # [B, S] int, the whole prompt on every rank
    seq_lens: "torch.Tensor | None" = None,  # [B] true prompt lengths
    cache: "tuple[torch.Tensor, torch.Tensor] | None" = None,  # [L, B, K, S/sp, hd]
    *,
    comm: Any = None,
) -> "tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]":
    """A long prompt's prefill, each rank over its block of the sequence →
    (``last_logits`` [B, V] at each row's last valid position, the same on
    every rank; ``(k, v)`` [L, B, K, S/sp, hd], the rank's block with every
    kv head).  Positions >= a row's length hold garbage, masked by
    ``seq_lens`` downstream.  S must divide over sp.

    The attention of each layer reads that layer's fresh K/V in the
    activations' dtype; ``cache``, when given, receives them in place (cast
    to its dtype) and is returned, else they are returned in the
    activations' dtype."""
    B, S = tokens.shape
    dev = tokens.device
    n = _sp(comm)
    if S % n:
        raise ValueError(f"prompt length {S} must divide over sp={n}")
    seq_lens = _full_lens(seq_lens, B, S, dev)
    blk = S // n
    lo = 0 if comm is None else comm.sp_index * blk
    layout = M.layout_of(params)
    eps = config.norm_eps
    x = _embed_block(params, tokens, lo, blk, layout)  # [B, blk, D]
    positions = torch.arange(lo, lo + blk, dtype=torch.int32, device=dev).expand(B, blk)
    cos, sin = M.rope_tables(positions, config.head_dim, config.rope_theta)
    ks, vs = [], []
    for i in range(config.n_layers):
        lp = _whole_layer(M.layer_params(params, i), config, layout, x.dtype)
        q, k, v = M.attn_qkv(x, lp, cos, sin, eps)
        attn = ring_attention(q, k, v, seq_lens, comm=comm)
        if cache is None:
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        else:
            cache[0][i].copy_(k.transpose(1, 2))
            cache[1][i].copy_(v.transpose(1, 2))
        x = M.attn_out_mlp(x, attn, lp, eps)  # the whole layer: no tp sum
        del lp  # a gathered layer is freed before the next is gathered
    kv = cache if cache is not None else (torch.stack(ks), torch.stack(vs))
    # gather the last valid hidden state FIRST, then the head: logits of
    # every position would be [B, S, V]; the rank holding it hands it to
    # every rank (its row plus the others' zeros: exact)
    idx = (seq_lens.to(torch.int64) - 1).clamp(0, S - 1) - lo
    x_last = x[torch.arange(B, device=dev), idx.clamp(0, blk - 1)]  # [B, D]
    if n > 1:
        mine = (idx >= 0) & (idx < blk)
        x_last = comm.sp_sum(x_last * mine[:, None].to(x_last.dtype))
    return M.lm_logits(x_last[:, None], params, eps)[:, 0], kv


def prefill_chunk_sequence_parallel(
    params: dict,
    config,
    tokens: torch.Tensor,  # [B, C] int, the chunk on every rank
    offset: torch.Tensor,  # [1] int: the chunk's first position
    last_idx: torch.Tensor,  # [B] the chunk position whose logits each row wants
    prefix: "tuple[torch.Tensor, torch.Tensor]",  # [L, B, K, S/sp, hd], in place
    *,
    comm: Any,
) -> torch.Tensor:
    """One chunk of the chunked long prefill at sp > 1 → the logits [B, V]
    at ``last_idx``, the same on every rank.  The short lane's chunk on the
    rank's tp shard, but for its attention: the chunk's K/V, with every kv
    head (gathered over tp), are written into the blocks of the ranks that
    hold those positions, and each rank scores the chunk's queries, every
    head of them (gathered over tp), against its own block with the ragged
    kernel (``start`` = the chunk's offset less the block's, which is
    negative where the chunk starts before the block: a query before the
    block sees none of it), the sources merged over sp; the rank keeps its
    own heads."""
    B, C = tokens.shape
    dev = tokens.device
    layout = M.layout_of(params)
    Kh, hd, eps = config.n_kv_heads, config.head_dim, config.norm_eps
    blk = prefix[0].shape[3]
    lo = comm.sp_index * blk
    x = M.embed_tokens(params, tokens)
    positions = (offset + torch.arange(C, dtype=torch.int32, device=dev)).expand(B, C)
    cos, sin = M.rope_tables(positions, hd, config.rope_theta)
    # block position w takes the chunk's position lo + w - offset, if any
    src = lo + torch.arange(blk, device=dev) - offset.to(torch.int64)
    take = ((src >= 0) & (src < C))[:, None]  # [blk, 1]
    src = src.clamp(0, C - 1)
    starts = (offset.to(torch.int32) - lo).expand(B)
    lens = torch.full((B,), blk, dtype=torch.int32, device=dev)
    for i in range(config.n_layers):
        lp = M.layer_params(params, i)
        q, k, v = M.attn_qkv(x, lp, cos, sin, eps)
        for side, new in zip(prefix, (k, v)):
            new = _whole_heads(new, 2, config, layout).transpose(1, 2).to(side.dtype)
            side[i].copy_(torch.where(take, new[:, :, src], side[i]))
        qa = _all_heads(q, layout)
        qg = qa.reshape(B, C, Kh, -1, hd).transpose(1, 2)  # [B, K, C, G, hd]
        o, _, z = _sp_merge(
            _attention.ragged_attention(qg, prefix[0][i], prefix[1][i], starts, lens), comm
        )
        attn = (o / z.clamp_min(1e-30)[..., None]).transpose(1, 2).reshape(qa.shape)
        x = M.attn_out_mlp(x, _own_heads(attn, 2, layout).to(x.dtype), lp, eps, layout)
    x = x[torch.arange(B, device=dev), last_idx][:, None]
    return M.lm_logits(x, params, eps)[:, 0]


# --------------------------------------------------------------------------- #
# context-parallel decode over a sequence-sharded prefix
# --------------------------------------------------------------------------- #


def context_parallel_attention(
    q: torch.Tensor,  # [B, 1, H, hd] one decode step's queries
    k_prefix: torch.Tensor,  # [B, K, S/sp, hd] this rank's block of the prefix
    v_prefix: torch.Tensor,
    prefix_lens: torch.Tensor,  # [B] valid prefix tokens
    *,
    comm: Any = None,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Decode attention over the whole prefix → (o [B, K, G, hd]
    unnormalized, m [B, K, G, 1], z [B, K, G, 1]) in f32, the same on every
    rank: the source that :func:`model.logsumexp_merge` folds with the
    fresh tokens'.  Each rank scores its own block, no K/V moves."""
    B, _, H, hd = q.shape
    K, blk = k_prefix.shape[1], k_prefix.shape[2]
    lens = prefix_lens.to(torch.int32)
    if _sp(comm) > 1:
        lens = (lens - comm.sp_index * blk).clamp(0, blk)
    source = _attention.decode_attention(q.reshape(B, K, H // K, hd), k_prefix, v_prefix, lens)
    o, m, z = source if _sp(comm) == 1 else _sp_merge(source, comm)
    return o, m[..., None], z[..., None]


def decode_sp_dispatch(
    params: dict,
    config,
    token: torch.Tensor,  # [B] last sampled token (enters this dispatch)
    prefix: "tuple[torch.Tensor, torch.Tensor]",  # [L, B, K, S/sp, hd] the rank's block
    prefix_lens: torch.Tensor,  # [B]
    fresh: "tuple[torch.Tensor, torch.Tensor]",  # [L, B, kv, cap, hd], in place
    t0: torch.Tensor,  # [1] int: fresh tokens already generated
    steps: int,
    *,
    comm: Any = None,
) -> "tuple[torch.Tensor, torch.Tensor, tuple[torch.Tensor, torch.Tensor]]":
    """One long-lane decode dispatch: ``steps`` greedy tokens against the
    prefix, the fresh K/V of step i written in place at slot ``t0 + i``
    (an indexed copy at a device index) → (toks [B, steps], last [B],
    fresh), the same tokens on every rank.  The fresh cache holds the kv
    heads of the rank's tp shard (:func:`model.kv_heads`); the prefix
    source is scored for every head and the rank keeps its own."""
    k_prefix, v_prefix = prefix
    fresh_k, fresh_v = fresh
    layout = M.layout_of(params)
    B = token.shape[0]
    hd, eps = config.head_dim, config.norm_eps
    t0 = t0.reshape(1).to(torch.int64)
    toks = []
    for i in range(steps):
        t = t0 + i  # the global fresh index: carries across dispatches
        positions = (prefix_lens.to(torch.int64) + t)[:, None]  # [B, 1]
        x = M.embed_tokens(params, token[:, None])
        cos, sin = M.rope_tables(positions, hd, config.rope_theta)
        for layer in range(config.n_layers):
            lp = M.layer_params(params, layer)
            q, k, v = M.attn_qkv(x, lp, cos, sin, eps)
            fk, fv = fresh_k[layer], fresh_v[layer]  # [B, kv, cap, hd]
            fk.index_copy_(2, t, k.transpose(1, 2).to(fk.dtype))
            fv.index_copy_(2, t, v.transpose(1, 2).to(fv.dtype))
            o, m, z = context_parallel_attention(
                _all_heads(q, layout), k_prefix[layer], v_prefix[layer], prefix_lens, comm=comm
            )
            Kl = fk.shape[1]
            prefix_source = tuple(  # [B, K, G, ·] → this rank's [B, kv, H/tp/kv, ·]
                _own_heads(s.flatten(1, 2), 1, layout).unflatten(1, (Kl, -1))
                for s in (o, m, z)
            )
            fresh_source = M.ring_attention_source(
                q.reshape(B, Kl, -1, hd), fk.permute(2, 0, 1, 3), fv.permute(2, 0, 1, 3), t
            )
            attn = M.logsumexp_merge(prefix_source, fresh_source)
            x = M.attn_out_mlp(x, attn.reshape(B, 1, -1, hd).to(x.dtype), lp, eps, layout)
        logits = M.lm_logits(x, params, eps)[:, -1]
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(token)
    return torch.stack(toks, dim=1), token, fresh


def decode_with_sharded_prefix(
    params: dict,
    config,
    first_token: torch.Tensor,  # [B] the token sampled from the prefill logits
    prefix: "tuple[torch.Tensor, torch.Tensor]",  # [L, B, K, S/sp, hd] the rank's block
    prefix_lens: torch.Tensor,  # [B]
    steps: int,
    *,
    comm: Any = None,
) -> torch.Tensor:
    """Greedy-decode ``steps`` tokens against a prefilled prefix → [B,
    steps] int32: the one-shot form of :func:`decode_sp_dispatch`, with a
    fresh cache of ``steps`` slots."""
    B = first_token.shape[0]
    shape = (config.n_layers, B, M.kv_heads(params, config), steps, config.head_dim)
    dev = first_token.device
    fresh = (
        torch.zeros(shape, dtype=torch.float32, device=dev),
        torch.zeros(shape, dtype=torch.float32, device=dev),
    )
    t0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    toks, _last, _fresh = decode_sp_dispatch(
        params, config, first_token, prefix, prefix_lens, fresh, t0, steps, comm=comm
    )
    return toks
