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
    gumbel = -torch.log(-torch.log(_uniform(keys, logits.shape[-1])))
    drawn = torch.argmax(filtered + gumbel, dim=-1).to(torch.int32)
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
