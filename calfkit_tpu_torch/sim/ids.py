"""Deterministic identity for simulation runs.

Correlation ids, client ids, lease ids, and node instance ids are all
minted through :func:`uuid.uuid4`.  None of them are *semantically* load
bearing, but several are *mechanically* load bearing for reproducibility:

- the **instance id** is half of the replica key — lexicographic
  tie-breaks in the routing policies and every rendezvous-hash rank are
  functions of it;
- the **correlation id** keys the mesh dispatcher's lane assignment
  (``crc32(key) % lanes``), so which calls serialize behind each other
  on a shared worker depends on it;
- the **lease id** keys the caller-liveness table.

A simulator that promises byte-identical reports across runs therefore
needs the id mint to be part of the seed.  :func:`deterministic_ids`
swaps ``uuid.uuid4`` for a seeded generator for the duration of a run —
RFC-4122-shaped (version/variant bits set) so nothing downstream can
tell, but fully reproducible.  It composes with the virtual clock the
same way: one seam, every layer moves together.
"""

from __future__ import annotations

import contextlib
import random
import uuid
from typing import Iterator

__all__ = ["deterministic_ids"]


@contextlib.contextmanager
def deterministic_ids(seed: int) -> "Iterator[None]":
    """Patch :func:`uuid.uuid4` with a generator seeded from ``seed`` for
    the duration of the block.  Never nest two of these with the same
    seed around concurrent mints from different logical actors — the
    draw ORDER is part of the determinism contract (the simulator mints
    everything from one event loop, where order is reproducible)."""
    rng = random.Random(seed ^ 0x51D_5EED)
    original = uuid.uuid4

    def seeded_uuid4() -> uuid.UUID:
        return uuid.UUID(int=rng.getrandbits(128), version=4)

    uuid.uuid4 = seeded_uuid4  # type: ignore[assignment]
    try:
        yield
    finally:
        uuid.uuid4 = original  # type: ignore[assignment]
