"""Ragged waves: the row vocabulary of the ragged attention kernels, and the
token-budget arithmetic of the unified prefill+decode waves.

The port's own copy of ``calfkit_tpu.inference.ragged``.  One ragged
attention call serves rows of three kinds:

- ``decode`` rows: q_len = 1, one fresh query at position ``start``;
- ``prefill`` rows: q_len = chunk, queries at ``start .. start+chunk``;
- ``verify`` rows: q_len = k+1, the speculative multi-query read.

All share one mask law: query ``j`` of a row attends kv positions
``< min(kv_len, start + j + 1)``, causal within the row's own fresh span and
bounded by its valid cache length.  :class:`RaggedRow` and
:func:`build_descriptors` describe mixed waves for the tests; the engine
passes the ``(q_starts, kv_lens)`` arrays directly.  The budget helpers are
pure host arithmetic, called at wave formation and at every tick of the
unified lane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

KIND_DECODE = 0
KIND_PREFILL = 1
KIND_VERIFY = 2

_KIND_NAMES = {KIND_DECODE: "decode", KIND_PREFILL: "prefill", KIND_VERIFY: "verify"}


@dataclass(frozen=True)
class RaggedRow:
    """One row of a ragged wave: its kind of work, the absolute position of
    its first query, how many queries it carries, and how much cache is
    valid for it."""

    kind: int  # KIND_DECODE | KIND_PREFILL | KIND_VERIFY
    start: int  # absolute position of the row's first query
    q_len: int  # 1 (decode) | chunk (prefill) | k+1 (verify)
    kv_len: int  # valid kv length the row may attend

    @property
    def kind_name(self) -> str:
        return _KIND_NAMES.get(self.kind, "?")

    def tokens(self) -> int:
        """Query tokens the row contributes to the wave's budget."""
        return self.q_len


def build_descriptors(
    rows: "Iterable[RaggedRow]",
) -> "tuple[list[int], list[int], list[int]]":
    """Flatten rows into the (q_starts, q_lens, kv_lens) arrays of the
    ragged attention entry points (the kind is not shipped: the mask law is
    the same for every kind)."""
    starts: list[int] = []
    q_lens: list[int] = []
    kv_lens: list[int] = []
    for row in rows:
        starts.append(row.start)
        q_lens.append(row.q_len)
        kv_lens.append(row.kv_len)
    return starts, q_lens, kv_lens


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
