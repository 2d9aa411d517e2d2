"""Token-budget arithmetic of the ragged unified prefill+decode waves.

The port's own copy of the budget helpers of ``calfkit_tpu.inference.ragged``:
how much pending prefill a decode dispatch may absorb.  Pure host
arithmetic, called at wave formation and at every tick of the unified lane.
"""

from __future__ import annotations


def token_budget(
    configured: int, max_batch_size: int, steps: int, chunk: int,
    max_prefill_wave: int,
) -> int:
    """Resolve the wave token budget (``RuntimeConfig.ragged_token_budget``;
    0 = auto).  Auto is a full decode wave plus a full-width prefill wave:
    admission is already bounded by free slots and ``max_prefill_wave``.
    An explicit budget bounds per-dispatch latency instead."""
    if configured > 0:
        return configured
    return max_batch_size * steps + max_prefill_wave * chunk


def fits_budget(
    budget: int, active_rows: int, steps: int, chunk_rows: int, chunk: int
) -> bool:
    """May a dispatch carrying ``active_rows`` decode rows absorb a
    ``chunk_rows``-wide prefill chunk?  Decode contributes
    ``active_rows * steps`` query tokens, the chunk ``chunk_rows * chunk``."""
    return active_rows * steps + chunk_rows * chunk <= budget


def wave_width_cap(
    budget: int, active_rows: int, steps: int, chunk: int
) -> int:
    """Widest prefill wave the budget lets a dispatch absorb alongside
    ``active_rows`` decode rows — never below 1 (the wave head always
    forms; a head that can't absorb advances in its own invocation)."""
    slack = budget - active_rows * steps
    return max(1, slack // chunk)
