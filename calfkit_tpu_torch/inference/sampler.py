"""Token sampling on tensors: greedy / temperature / top-k / top-p per row,
plus the device-side retirement mask of overlapped decode.

The PyTorch counterpart of ``calfkit_tpu.inference.sampler``: same names,
argument order and tensor layouts.  One difference is deliberate.  The JAX
package draws from ``jax.random`` keys; this module draws with the
Gumbel-max trick from a counter-based hash of ``(key, vocab index)``, where
a row's key is :func:`fold_in` of its request seed and the absolute token
position.  A draw therefore depends on the seed and the position alone —
never on the batch around it, on slot reuse, or on any generator state —
and needs no host round trip.  It does not reproduce ``jax.random``'s bits.

Speculative decoding adds :func:`spec_accept_slots`: ragged acceptance of
the drafted tokens of each row against the verify dispatch's logit rows,
exact match for greedy rows and rejection sampling for sampled rows, both
against the distribution :func:`filtered_logits` defines.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_MASK32 = 0xFFFFFFFF


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0  # 0 → off
    top_p: float = 1.0  # 1 → off

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 tensors holding values in
    [0, 2**32).  Both multipliers are below 2**31, so no product leaves the
    int64 range before the mask."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _MASK32
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _MASK32
    return x ^ (x >> 16)


def fold_in(seeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Per-row stream keys [B] int64 from request seeds and absolute token
    positions (the counterpart of ``jax.random.fold_in(key, position)``)."""
    s = _mix32(seeds.to(torch.int64) & _MASK32)
    p = (positions.to(torch.int64) * 0x61C88647) & _MASK32
    return _mix32(s ^ p)


def _uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Uniform draws in (0, 1), [B, n] f32, one per (row key, index)."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    h = _mix32(keys[:, None] ^ ((idx[None, :] * 0x27D4EB2D) & _MASK32))
    h = _mix32(h ^ 0x5BD1E995)
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def filtered_logits(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] i32; 0 → off
    top_p: torch.Tensor,  # [B] f32; >= 1 → off
) -> torch.Tensor:
    """Temperature-scaled logits with top-k/top-p support filtering applied
    (-inf outside the kept set) → [B, V] f32.  One descending sort serves
    both cutoffs; the top-ranked token is never filtered out."""
    V = logits.shape[-1]
    safe_temp = temperature.clamp_min(1e-6)[:, None]
    scaled = logits.to(torch.float32) / safe_temp
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    ranks = torch.arange(V, device=logits.device)[None, :]
    k_eff = torch.where(top_k > 0, top_k, V)[:, None]
    keep = ranks < k_eff
    probs = torch.softmax(sorted_desc, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    keep &= (cumulative - probs) < top_p.clamp_max(1.0)[:, None]
    keep |= ranks == 0
    threshold = torch.where(keep, sorted_desc, torch.inf).min(
        dim=-1, keepdim=True
    ).values
    return torch.where(scaled < threshold, -torch.inf, scaled)


def sample_slots(
    logits: torch.Tensor,  # [B, V] (last-token logits)
    keys: torch.Tensor,  # [B] int64 stream keys (see fold_in)
    temperature: torch.Tensor,  # [B] f32; <= 0 → greedy for that row
    top_k: torch.Tensor,  # [B] i32; 0 → off
    top_p: torch.Tensor,  # [B] f32; >= 1 → off
) -> torch.Tensor:
    """Per-row sampling → [B] int32 next tokens; greedy rows take the
    argmax.  Sampled rows take argmax(filtered + Gumbel noise), an exact
    draw from the filtered distribution."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    filtered = filtered_logits(logits, temperature, top_k, top_p)
    drawn = torch.argmax(filtered + _gumbel(keys, logits.shape[-1]), dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, drawn, greedy)


def retire_mask_slots(
    toks: torch.Tensor,  # [B, S] the dispatch's generated tokens, row-major
    stop_table: torch.Tensor,  # [B, n_stop] i32 per-row stop tokens, -1 padded
    bound: torch.Tensor,  # [B] i32 steps until the row's hard bound
    active: torch.Tensor,  # [B] bool rows that actually participated
    emitted: "torch.Tensor | None" = None,  # [B] valid tokens per row (None → S)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row retirement classification → (n_valid [B] i32, done [B] bool).

    The device-side mirror of the engine's host retirement authority
    (``_record_token``): deliver each row's tokens up to the first stop
    token (exclusive) or the hard generation bound, whichever comes first.
    Computing it on the device lets the next dispatch consume ``done``
    before any host sync of this one.  Inactive rows report (0, False).
    """
    B, S = toks.shape
    dev = toks.device
    limit = (
        torch.full((B,), S, dtype=torch.int32, device=dev)
        if emitted is None
        else emitted.to(torch.int32)
    )
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    within = pos < limit[:, None]
    is_stop = (toks[:, :, None] == stop_table[:, None, :]).any(-1) & within
    stop_any = is_stop.any(dim=1)
    first_stop = torch.argmax(is_stop.to(torch.int32), dim=1).to(torch.int32)
    n_before = torch.where(stop_any, first_stop, limit)
    bound = bound.to(torch.int32).clamp_min(0)
    n_valid = torch.minimum(n_before, bound)
    done = stop_any | (bound <= limit)
    return torch.where(active, n_valid, 0).to(torch.int32), done & active


def _gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Gumbel noise [B, n] f32 from each row's stream key: argmax(logits +
    noise) is an exact draw from softmax(logits)."""
    return -torch.log(-torch.log(_uniform(keys, n)))


def spec_accept_slots(
    logits: torch.Tensor,  # [B, S, V] verify logits (S = drafts + 1)
    drafts: torch.Tensor,  # [B, S-1] i32 drafted candidate tokens
    ndraft: torch.Tensor,  # [B] i32 valid drafts per row (0..S-1)
    base_lens: torch.Tensor,  # [B] kv length at dispatch start
    seeds: torch.Tensor,  # [B] per-slot request seeds
    temperature: torch.Tensor,  # [B] f32; <= 0 → greedy (exact-match) rows
    top_k: torch.Tensor,  # [B] i32
    top_p: torch.Tensor,  # [B] f32
    *,
    sampled: bool = True,  # False → all-greedy batch, no random draws
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged speculative acceptance → (out_tokens [B, S] int32, emitted [B]
    int32).

    ``logits[:, j]`` is the target's distribution for the token after fed
    token j (fed tokens are [last, d_0, .., d_{S-2}]).  Each row accepts the
    longest prefix of its drafts, then emits ONE correction token at the
    first rejected (or undrafted) position: ``emitted = accepted + 1`` and
    ``out_tokens[b, :emitted[b]]`` are the row's new tokens.

    - Greedy rows: accept d_j iff it equals argmax(logits[:, j]); the
      correction is the argmax, so the output equals non-speculative greedy
      decoding token for token.
    - Sampled rows: rejection sampling against the filtered distribution p
      of :func:`sample_slots`.  The drafts are point masses, so d_j is
      accepted with probability p(d_j), and a rejection draws from p with
      d_j removed: the emitted marginal is p.  Position j's key is
      ``fold_in(seed, base_lens + 1 + j)``, the key non-speculative decoding
      uses for that token, and its Gumbel noise is the noise
      :func:`sample_slots` draws there: a row with nothing drafted emits the
      token spec-off decoding samples.  The acceptance uniforms come from a
      second stream of the same key.
    """
    B, S, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, S]
    drafts = drafts.to(torch.int32)
    j = torch.arange(S - 1, device=logits.device)[None, :]
    drafted = j < ndraft[:, None]  # [B, S-1]
    acc_greedy = drafts == greedy[:, : S - 1]
    if not sampled:
        return _assemble(drafts, acc_greedy & drafted, greedy)
    flat = filtered_logits(
        logits.reshape(B * S, V),
        temperature.repeat_interleave(S),
        top_k.repeat_interleave(S),
        top_p.repeat_interleave(S),
    )  # [B*S, V]
    pos = base_lens[:, None].to(torch.int64) + 1 + torch.arange(S, device=logits.device)[None, :]
    keys = fold_in(seeds[:, None].expand(B, S).reshape(-1), pos.reshape(-1))  # [B*S]
    gumbel = _gumbel(keys, V)
    corr_plain = torch.argmax(flat + gumbel, dim=-1).reshape(B, S).to(torch.int32)
    u = _uniform(_mix32(keys ^ 0x9E3779B9), 1).reshape(B, S)  # acceptance draws
    flat = flat.reshape(B, S, V)
    probs = torch.softmax(flat[:, : S - 1], dim=-1)
    p_draft = torch.gather(probs, -1, drafts[..., None].to(torch.int64))[..., 0]  # [B, S-1]
    is_sampled = temperature[:, None] > 0.0
    acc = torch.where(is_sampled, u[:, : S - 1] < p_draft, acc_greedy) & drafted
    # a rejected drafted position draws from the residual (p without the
    # draft) with the position's own noise; an undrafted position draws
    # from p (this covers the bonus token after full acceptance)
    residual = flat[:, : S - 1].scatter(-1, drafts[..., None].to(torch.int64), -torch.inf)
    corr_residual = torch.argmax(
        residual + gumbel.reshape(B, S, V)[:, : S - 1], dim=-1
    ).to(torch.int32)
    corr_sampled = torch.cat(
        [torch.where(drafted, corr_residual, corr_plain[:, : S - 1]), corr_plain[:, S - 1:]],
        dim=-1,
    )
    return _assemble(drafts, acc, torch.where(is_sampled, corr_sampled, greedy))


def _assemble(
    drafts: torch.Tensor,  # [B, S-1]
    acc: torch.Tensor,  # [B, S-1] bool per-position acceptance
    corr: torch.Tensor,  # [B, S] correction token per position
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out_tokens [B, S], emitted [B]): the leading accepted draft prefix
    followed by ONE correction token at the first non-accepted position."""
    B, S = corr.shape
    accepted = torch.cumprod(acc.to(torch.int32), dim=-1).sum(dim=-1).to(torch.int32)  # [B]
    i = torch.arange(S, device=corr.device)[None, :]
    pad_drafts = torch.cat([drafts, torch.zeros((B, 1), dtype=torch.int32, device=corr.device)], -1)
    out = torch.where(
        i < accepted[:, None], pad_drafts,
        torch.where(i == accepted[:, None], corr.to(torch.int32), 0),
    ).to(torch.int32)
    return out, accepted + 1
