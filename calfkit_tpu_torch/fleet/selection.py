"""Pure selection primitives: the hashing under the mesh dispatcher's lane
choice.  The port's own copy of the helper of
``calfkit_tpu.fleet.selection`` that the mesh layer uses, :func:`lane_of`
(crc32, keyless → lane 0; per-key ordering contracts hang off this value
being stable).  The fleet's hashing and ranking helpers come with the
fleet router (ROADMAP Queue 1).

Stdlib only: ``mesh/dispatch`` imports it.
"""

from __future__ import annotations

import zlib

__all__ = ["lane_of"]


def lane_of(key: "bytes | None", lanes: int) -> int:
    """The key-ordered dispatcher's lane law: ``crc32(key) % lanes``;
    keyless records serialize on lane 0."""
    if key is None:
        return 0
    return zlib.crc32(key) % lanes
