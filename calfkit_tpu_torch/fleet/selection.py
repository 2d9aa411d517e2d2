"""Pure selection primitives: the hashing layer under every "which of N
do I pick" decision in the mesh.

The key-ordered dispatcher's lane choice and the client's replica choice
compose over the same dependency-free primitives:

- :func:`lane_of` — the dispatcher's lane law (crc32, keyless → lane 0).
  Per-key ordering contracts hang off this value being stable.
- :func:`stable_hash` — 64-bit blake2b for affinity keys; NOT Python's
  ``hash()`` (randomized per process — a router must agree with itself
  across restarts, with its peers, and with ``calfkit_tpu``'s routers:
  both packages place one key on one replica).
- :func:`rendezvous_rank` — highest-random-weight ordering of candidate
  ids for a key.  The prefix-affinity property fleet routing needs falls
  out of HRW directly: the same key always prefers the same replica, and
  when that replica is ineligible (draining, stale, excluded) the
  NEXT-ranked replica is a stable second home instead of a reshuffle of
  the whole fleet.
- :func:`page_aligned_prefix` — quantize a prompt to page-granular
  prefix boundaries so one session's turns (same instructions/history
  prefix, growing tail) map to one affinity key.

This module must stay dependency-free (stdlib only): ``mesh/dispatch``
imports it, and the mesh layer must not pull in control-plane models.
"""

from __future__ import annotations

from calfkit_tpu_torch.effects import hotpath

import hashlib
import zlib
from typing import Iterable, Sequence

__all__ = [
    "lane_of",
    "stable_hash",
    "rendezvous_rank",
    "page_aligned_prefix",
]


@hotpath
def lane_of(key: "bytes | None", lanes: int) -> int:
    """The key-ordered dispatcher's lane law (unchanged semantics:
    ``crc32(key) % lanes``; keyless records serialize on lane 0)."""
    if key is None:
        return 0
    return zlib.crc32(key) % lanes


@hotpath
def stable_hash(data: bytes, *, salt: bytes = b"") -> int:
    """Process- and host-stable 64-bit hash (blake2b).

    The salt is folded into the hashed stream (length-prefixed so
    ``salt|data`` boundaries cannot alias), NOT passed as blake2b's
    ``key`` parameter: the key is silently capped at 64 bytes, and a
    rendezvous salt built from a long replica key (``agent.<name>@…``)
    would truncate BEFORE the instance id — every replica hashing
    identically turns prefix-affinity into route-everything-to-the-
    lexicographic-max replica."""
    h = hashlib.blake2b(digest_size=8)
    h.update(len(salt).to_bytes(4, "big"))
    h.update(salt)
    h.update(data)
    return int.from_bytes(h.digest(), "big")


@hotpath
def rendezvous_rank(key: bytes, candidates: Iterable[str]) -> "list[str]":
    """Candidate ids ordered by highest-random-weight for ``key``.

    ``rank[0]`` is the key's home; ``rank[1]`` its stable fallback.
    Adding or removing ONE candidate moves only the keys homed on it —
    the minimal-disruption property that makes affinity survive replica
    churn.  Ties (hash collisions) break on the candidate id itself so
    the ordering is total and deterministic.
    """
    return sorted(
        candidates,
        key=lambda c: (stable_hash(key, salt=c.encode("utf-8")), c),
        reverse=True,
    )


@hotpath
def page_aligned_prefix(
    tokens: "Sequence[int] | str", page: int, *, max_pages: int = 4
) -> "bytes | None":
    """The prompt's page-aligned prefix head as hashable bytes, or
    ``None`` when the prompt is shorter than one page (no shared pages
    to chase — affinity would just be a worse-balanced random policy).

    Accepts token ids (aligned to the KV page size: the unit the
    ``PrefixCache`` caches at) or raw text (callers that have not
    tokenized yet quantize on characters; pick ``page`` ≈ page_size
    tokens × ~4 chars/token).  Two alignment properties matter:

    - truncating to whole pages (not raw length) maps prompts that
      share cached pages to the same key;
    - capping at ``max_pages`` keeps the key stable as a SESSION grows:
      turn N's prompt is turn 1's plus appended history, so hashing the
      full aligned prompt would re-home the session every few turns —
      exactly when its earlier pages are hot on the current home."""
    if page <= 0:
        return None
    aligned = (len(tokens) // page) * page
    if aligned <= 0:
        return None
    head = tokens[: min(aligned, max(1, max_pages) * page)]
    if isinstance(head, str):
        return head.encode("utf-8", errors="replace")
    return b"".join(int(t).to_bytes(8, "big", signed=True) for t in head)
