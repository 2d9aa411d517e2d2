"""The partition-keying seam: task_id -> Kafka partition key.

THE CONTRACT (reference: calfkit/keying.py:1-34 — the single most load-bearing
invariant in the framework):

    Every publish that participates in a workflow run MUST be keyed by
    ``partition_key(task_id)``.  Combined with key-ordered consumption
    (parallel across keys, strictly serial per key), this makes every run a
    single-writer system: per-run state mutation is race-free *by
    construction*, with no locks anywhere.

A new keying scheme would change which runs serialize against each other on a
shared partition; route every producer through this function so the decision
stays in one place.
"""

from __future__ import annotations


def partition_key(task_id: str) -> bytes:
    """The one authority for workflow partition keys."""
    if not task_id:
        raise ValueError("task_id must be non-empty")
    return task_id.encode("utf-8")
