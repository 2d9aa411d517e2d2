"""Shared curated-XOR-discover validation for handle selectors
(reference: calfkit/_handle_names.py:1-127 — Tools/Toolboxes/Messaging/
Handoff all share this rail)."""

from __future__ import annotations

from typing import Sequence

from calfkit_tpu_torch import protocol


def validate_curated_or_discover(
    what: str, names: Sequence[str], discover: bool
) -> None:
    if names and discover:
        raise ValueError(f"{what} takes either names or discover=True, not both")
    if not names and not discover:
        raise ValueError(f"{what} requires names, or discover=True")
    seen: set[str] = set()
    for name in names:
        protocol.require_topic_safe(name, what=f"{what} name")
        if name in seen:
            raise ValueError(f"{what}: duplicate name {name!r}")
        seen.add(name)
