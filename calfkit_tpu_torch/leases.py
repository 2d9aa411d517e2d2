"""Caller liveness leases: the port's own copy of ``calfkit_tpu.leases``
(same names, same behaviour).

A caller registers its runs against a ``(lease_id, ttl_s)`` lease and
beats while it waits; the engine's orphan reaper abandons the runs of a
caller whose beats lapsed, so a dead caller stops holding slots and pages.

- the **process-wide beat store**: :func:`note_beat` (a heartbeat, or a
  folded ``mesh.caller_liveness`` record via :func:`fold_liveness_record`),
  :func:`note_admission` (a delivered call is proof of life at publish),
  :func:`release_lease` (a clean close: lapsed at once);
- :data:`current_lease` — a contextvar carrying the caller's lease; the
  model client forwards it to the engine.

The lapse law (one copy, shared by the reaper and the shed order):

- a lease never seen is **alive** (fail-safe: the store may be cold);
- a lease is **lapsed** once ``now - last_beat > ttl``;
- a **released** lease is lapsed immediately.

Stamps ride :func:`calfkit_tpu_torch.cancellation.wall_clock`, so a
virtual clock drives lapse deterministically.  Everything here is
fail-open advisory state: an evicted entry only costs one TTL of grace.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from contextvars import ContextVar

from calfkit_tpu_torch import cancellation

__all__ = [
    "DEFAULT_LEASE_TTL",
    "current_lease",
    "note_beat",
    "note_admission",
    "release_lease",
    "release_generation",
    "lease_lapsed",
    "lease_expiry",
    "lease_age",
    "active_leases",
    "fold_liveness_record",
    "beat_payload",
]

DEFAULT_LEASE_TTL = 15.0  # matches the fleet's heartbeat staleness scale

# the current delivery's caller lease (lease_id, ttl_s), set by the node
# kernel from the x-mesh-lease header for the duration of one delivery —
# None outside any leased delivery (same channel shape as the deadline)
current_lease: "ContextVar[tuple[str, float] | None]" = ContextVar(
    "calfkit_caller_lease", default=None
)

# lease_id -> (last_beat_at, ttl_s), capped.  Eviction is NOT free: an
# evicted lease reads as "never seen = alive" (the fail-safe default),
# which would permanently disable reaping for its runs — so at the cap,
# LONG-LAPSED entries are pruned first (their runs were reaped within a
# TTL of the lapse; entries lapsed for many TTLs carry no live runs to
# protect), and only then does LRU eviction touch entries that may still
# matter.  Dead callers' final beats otherwise accumulate one entry
# each forever — production clusters should also give the
# mesh.caller_liveness topic compact+delete retention, like mesh.traces
# (docs/robustness.md).
_BEAT_CAP = 4096
# a lease lapsed longer than PRUNE_TTLS × its ttl is historical record,
# not live state: every run registered against it was reaped long ago
_PRUNE_TTLS = 32.0
# the stale-prune scan is O(store); running it on EVERY insert while the
# store sits at its cap is O(store²) under fleet-scale caller churn (the
# fleet-scale churn spends most of its time there).  Amortize:
# scan at most once per this many over-cap inserts; between scans the
# cap is held by O(1) LRU pops — beats move entries to the end, so the
# LRU front is the oldest-beat (≈ most-lapsed) entry anyway.
_PRUNE_SCAN_EVERY = 256
_scan_countdown = 0
_RELEASED = float("-inf")
_beats: "OrderedDict[str, tuple[float, float]]" = OrderedDict()
_LOCK = threading.Lock()
# bumped on every release: a released lease must reap IMMEDIATELY, but
# the engine's orphan heap only re-checks entries at their registered
# expiry — a generation mismatch (one int compare per scheduler pass)
# tells it to sweep registered runs against the lapse law now
_release_gen = 0


def note_beat(
    lease_id: str, ttl_s: float, at: "float | None" = None
) -> None:
    """Record a caller heartbeat (table fold or admission stamp).  Beats
    only move the lease FORWARD — a stale table record replayed behind a
    fresh admission stamp must not age the lease backward — and a
    RELEASED lease is terminal: the liveness feed is unordered, so the
    caller's final heartbeat may fold AFTER its close() tombstone, and
    resurrecting the lease would un-orphan a deliberately departed
    caller's runs (lease ids are minted fresh per client, never
    reused)."""
    if not lease_id or ttl_s <= 0:
        return
    if at is None:
        at = cancellation.wall_clock()
    with _LOCK:
        prev = _beats.get(lease_id)
        if prev is not None:
            if prev[0] == _RELEASED:
                return  # released is terminal
            if prev[0] > at:
                at = prev[0]
        _beats[lease_id] = (at, ttl_s)
        _beats.move_to_end(lease_id)
        if len(_beats) > _BEAT_CAP:
            # prune the historical dead first (released, or lapsed many
            # TTLs ago): evicting a FRESH entry would read as
            # never-seen = alive and permanently un-reap its runs.  The
            # scan is amortized (see _PRUNE_SCAN_EVERY): between scans
            # the O(1) LRU pop below holds the cap.
            global _scan_countdown
            if _scan_countdown <= 0:
                _scan_countdown = _PRUNE_SCAN_EVERY
                now = cancellation.wall_clock()
                stale = [
                    key
                    for key, (beat, ttl) in _beats.items()
                    if beat == _RELEASED or now - beat > ttl * _PRUNE_TTLS
                ]
                for key in stale:
                    if len(_beats) <= _BEAT_CAP:
                        break
                    del _beats[key]
            else:
                _scan_countdown -= 1
        while len(_beats) > _BEAT_CAP:
            _beats.popitem(last=False)


def note_admission(lease_id: str, ttl_s: float) -> None:
    """A leased call was just delivered: the caller was alive when it
    PUBLISHED — an implicit beat, so a run admitted before the liveness
    feed caught up still gets its full TTL of grace.  But delivery lags
    publish by an unknown delay: a call surfacing from a backlog AFTER
    its caller's lease already lapsed (or was released) must NOT
    resurrect the lease — the publish was at least one TTL ago, which
    is no evidence of life now."""
    if lease_lapsed(lease_id):
        return
    note_beat(lease_id, ttl_s)


def release_lease(lease_id: str) -> None:
    """The caller tombstoned its lease (clean close): outstanding leased
    runs are orphans NOW — no TTL of grace for a deliberate departure."""
    global _release_gen
    if not lease_id:
        return
    with _LOCK:
        ttl = _beats.get(lease_id, (0.0, DEFAULT_LEASE_TTL))[1]
        _beats[lease_id] = (_RELEASED, ttl)
        # released = historical record: park it at the LRU FRONT so the
        # cap's O(1) eviction backstop consumes corpses before it can
        # ever touch a live lease (an evicted LIVE lease reads
        # never-seen = alive forever and permanently un-reaps its runs)
        _beats.move_to_end(lease_id, last=False)
        _release_gen += 1


def release_generation() -> int:
    """Monotonic count of lease releases — the orphan reaper's
    sweep-now signal (one bare int read per scheduler pass)."""
    return _release_gen


def lease_expiry(lease_id: "str | None") -> "float | None":
    """Absolute epoch at which the lease lapses (last_beat + ttl), or
    None for a lease the store has never seen (= alive, fail-safe).  The
    engine's orphan heap keys on this."""
    if not lease_id:
        return None
    with _LOCK:
        entry = _beats.get(lease_id)
    if entry is None:
        return None
    beat_at, ttl = entry
    return beat_at + ttl


def lease_lapsed(lease_id: "str | None", now: "float | None" = None) -> bool:
    """THE lapse law (see module docstring): True only with positive
    evidence — a known lease whose last beat is older than its TTL (or
    was released).  Unknown leases are alive."""
    expiry = lease_expiry(lease_id)
    if expiry is None:
        return False
    if now is None:
        now = cancellation.wall_clock()
    return now > expiry


def lease_age(lease_id: "str | None", now: "float | None" = None) -> "float | None":
    """Seconds since the lease's last beat (None = never seen).  The
    lease-listing read AND the engine's lease-aware shed
    ordering signal: under overload, the batch victim with
    the OLDEST beat sheds first — leased-but-silent callers give way
    before actively-beating ones."""
    if not lease_id:
        return None
    with _LOCK:
        entry = _beats.get(lease_id)
    if entry is None:
        return None
    if now is None:
        now = cancellation.wall_clock()
    return max(0.0, now - entry[0])


def active_leases() -> "dict[str, tuple[float, float]]":
    """Snapshot of the beat store: lease_id -> (last_beat_at, ttl_s);
    released leases carry beat_at = -inf."""
    with _LOCK:
        return dict(_beats)


# ------------------------------------------------------------ wire fold
# Beats travel as compact JSON table values keyed by lease id; the
# liveness feed (ControlPlane.attach) folds every record through here.


def beat_payload(lease_id: str, ttl_s: float) -> bytes:
    """The wire form of one caller heartbeat (client side)."""
    return json.dumps(
        {
            "lease_id": lease_id,
            "ttl_s": round(ttl_s, 3),
            "beat_at": cancellation.wall_clock(),
        }
    ).encode("utf-8")


def fold_liveness_record(key: "bytes | str | None", value: bytes) -> None:
    """Fold one ``mesh.caller_liveness`` record into the beat store.
    Tombstones (empty value) release the lease; undecodable records are
    dropped (fail-open — a corrupt beat must never fault the feed)."""
    lease_id = (
        key.decode("utf-8", "replace") if isinstance(key, bytes) else key
    )
    if not value:
        if lease_id:
            release_lease(lease_id)
        return
    try:
        body = json.loads(value)
        beat_at = float(body["beat_at"])
        ttl_s = float(body["ttl_s"])
        lease_id = str(body.get("lease_id") or lease_id or "")
    except (ValueError, KeyError, TypeError):
        return
    note_beat(lease_id, ttl_s, at=beat_at)
