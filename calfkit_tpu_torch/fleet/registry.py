"""The replica registry: per-INSTANCE view over ``mesh.engine_stats``.

``ControlPlaneView`` deliberately collapses instance-keyed records to one
live record per node name (freshest heartbeat wins) — correct for "is
agent X up", fatally wrong for a fleet: N replicas of the same model
serve under ONE node name, and the router needs all of them, each with
its own heartbeat age, queue depth, drain flag, and replica-addressed
topic.  :class:`ReplicaRegistry` therefore reads the same compacted
table but keeps every ``<node_id>@<instance>`` key separate.

Eligibility rules (DeServe's placement/overload-isolation loop,
arXiv:2501.14784):

- **stale heartbeat** (``now - heartbeat_at >= stale_after`` on the
  :func:`calfkit_tpu_torch.cancellation.wall_clock` seam) → ineligible until
  the replica re-advertises; a wedged worker must stop receiving
  traffic without anyone deregistering it;
- **draining** (``EngineStatsRecord.draining``) → ineligible for NEW
  runs; in-flight work finishes on the replica untouched;
- **not ready** (boot not finished, readiness probe false) → ineligible;
- **excluded** (caller-supplied instance ids — the shed-retry loop
  excludes the replica that just refused) → ineligible for this pick.

Everything here is a read path: the registry never publishes.
"""

from __future__ import annotations

from calfkit_tpu_torch.effects import hotpath

import logging
import zlib
from dataclasses import dataclass

from calfkit_tpu_torch.models._wire import ValidationError

from calfkit_tpu_torch import cancellation, protocol
from calfkit_tpu_torch.mesh.tables import TableReader
from calfkit_tpu_torch.mesh.transport import MeshTransport
from calfkit_tpu_torch.models.records import (
    SCHEMA_VERSION,
    ControlPlaneRecord,
    EngineStatsRecord,
)

logger = logging.getLogger(__name__)

__all__ = [
    "Replica",
    "ReplicaRegistry",
    "eligibility_verdict",
    "parse_replicas",
]

DEFAULT_STALE_AFTER = 15.0  # matches ControlPlaneConfig 5s beat × 3


@dataclass(frozen=True)
class Replica:
    """One live engine-backed instance, as the router sees it."""

    key: str  # "<node_id>@<instance_id>" — the control-plane record key
    node_id: str  # e.g. "agent.support"
    instance_id: str
    heartbeat_at: float
    stats: EngineStatsRecord
    # requests THIS router placed on the replica that have not returned
    # yet (FleetRouter's local accounting).  The heartbeat depth is the
    # fleet-wide truth but lags a beat interval; without the local
    # share, every pick between two beats sees the same depths and a
    # least-loaded policy herds the whole gap onto one replica.
    router_inflight: int = 0

    @property
    def agent_name(self) -> str:
        """The node name without its kind prefix ("agent.x" -> "x")."""
        _, _, name = self.node_id.partition(".")
        return name or self.node_id

    @property
    def model_name(self) -> str:
        return self.stats.model_name

    @property
    def topic(self) -> str:
        """The replica-addressed input topic ("" = shared-topic only)."""
        return self.stats.replica_topic

    @property
    def queue_depth(self) -> int:
        """The load signal policies rank on: slots occupied plus requests
        admitted but still queued for a slot (per the last heartbeat),
        plus this router's own not-yet-returned placements."""
        return (
            self.stats.active_requests
            + self.stats.pending_requests
            + self.router_inflight
        )

    @property
    def batch_depth(self) -> int:
        """The batch-class share of the advertised QUEUE:
        queued batch requests per the last heartbeat.  The routing
        tiebreak signal — at equal total depth, prefer the replica whose
        backlog is batch-heavy, because its queued work is exactly what
        priority shedding will evict if an interactive arrival needs the
        slot.  Zero everywhere when no batch traffic exists (and on
        pre-QoS adverts), so the tiebreak is exactly neutral for
        single-class fleets — pinned pre-QoS timelines are unchanged."""
        return self.stats.batch_pending

    @property
    def dispatch_ewma(self) -> float:
        """EWMA decode-dispatch latency (ms) from the advert — the
        many-router coherence tiebreak: when queue depths tie
        (the normal state between heartbeat beats), policies prefer the
        replica that is actually dispatching faster, so N independent
        routers stop herding onto one lexicographic winner.  0.0 = no
        signal (pre-EWMA advert, never-dispatched engine): the policy
        ranks it LAST among ties — no latency evidence must not read as
        zero latency — and all-unknown ties fall to the stable key."""
        return self.stats.dispatch_ewma_ms

    @property
    def headroom_pages(self) -> "int | None":
        """Pages an admission could obtain on this replica right now
       : the advert's pages_total minus live-owner pages —
        free-list pages plus evictable zero-ref cached pages.  None when
        the replica advertises no page pool (dense layout or a
        pre-capacity record): no signal must not read as zero headroom,
        or a density-aware policy would starve every legacy replica."""
        total = self.stats.pages_total
        if total <= 0:
            return None
        return max(0, total - self.stats.pages_in_use)

    def age(self, now: "float | None" = None) -> float:
        if now is None:
            now = cancellation.wall_clock()
        return max(0.0, now - self.heartbeat_at)


@hotpath
def eligibility_verdict(
    replica: Replica, *, stale_after: float, now: "float | None" = None
) -> str:
    """THE eligibility law, shared by the router's filter and the
    ``ck fleet`` ROUTE column (one copy, or the operator tool drifts
    from what the router actually does): ``"yes"`` = routable for a NEW
    run, else the first reason it is skipped — ``"shared-only"`` (not
    individually addressable), ``"stale"`` (wedged heartbeat),
    ``"drain"``, ``"unready"``.  Caller-supplied exclusions are
    per-pick state, not part of the verdict."""
    if now is None:
        now = cancellation.wall_clock()
    if not replica.topic:
        return "shared-only"
    if replica.age(now) >= stale_after:
        return "stale"
    if replica.stats.draining:
        return "drain"
    if not replica.stats.ready:
        return "unready"
    return "yes"


def parse_replicas(items: "dict[str, bytes]") -> "list[Replica]":
    """Fold raw compacted-table items into per-instance replicas.

    Undecodable and foreign-schema records are skipped (same leniency as
    ``ControlPlaneView``); staleness is NOT applied here — callers that
    render (``ck fleet``) want stale rows visible, callers that route
    (:meth:`ReplicaRegistry.eligible`) filter them."""
    out: list[Replica] = []
    for key, raw in items.items():
        try:
            wrapped = ControlPlaneRecord.from_wire(raw)
            if wrapped.schema_version != SCHEMA_VERSION:
                continue
            stats = EngineStatsRecord.model_validate(wrapped.record)
        except (ValidationError, ValueError):
            # blocking-ok: the undecodable-record debug floor — fires only
            # for a CORRUPT advert (never per healthy parse), lazily
            # %-formatted, and _parsed's version fast path means a stable
            # corrupt record is logged once per table change, not per call
            logger.debug("undecodable engine-stats record %s", key)
            continue
        out.append(
            Replica(
                key=key,
                node_id=stats.node_id,
                instance_id=(
                    stats.instance_id or wrapped.stamp.instance_id
                ),
                heartbeat_at=wrapped.stamp.heartbeat_at,
                stats=stats,
            )
        )
    return sorted(out, key=lambda r: r.key)


class ReplicaRegistry:
    def __init__(
        self,
        transport: MeshTransport,
        *,
        stale_after: float = DEFAULT_STALE_AFTER,
        catchup_timeout: float = 30.0,
    ):
        self._reader: TableReader = transport.table_reader(
            protocol.ENGINE_STATS_TOPIC
        )
        self.stale_after = stale_after
        self._catchup_timeout = catchup_timeout
        self._started = False
        # parsed-replica cache keyed on a cheap fingerprint: the table
        # only changes once per heartbeat tick, but routing reads it per
        # CALL — re-running record validation per replica per pick
        # would put JSON decode on the routing hot path.
        # Readers that maintain a mutation version counter (all in-repo
        # transports do) make the no-change case a
        # single int compare, O(1) in table size; readers without one
        # fall back to the crc32 byte scan (~100x cheaper than the
        # parse, but still O(table bytes) per pick).
        self._cache_fp: "tuple | None" = None
        self._cache: "list[Replica]" = []
        self._cache_by_key: "dict[str, Replica]" = {}

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._started:
            return
        await self._reader.start(timeout=self._catchup_timeout)
        # atomicity-ok: single-flight via FleetRouter.start's lock (the
        # only caller); a double reader catch-up is idempotent regardless
        self._started = True

    async def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        await self._reader.stop()

    async def barrier(self) -> None:
        await self._reader.barrier()

    @property
    def is_caught_up(self) -> bool:
        return self._started and self._reader.is_caught_up

    # --------------------------------------------------------------- reads
    @hotpath
    def _parsed(self) -> "list[Replica]":
        version = self._reader.version
        if version is not None:
            # O(1) no-change fast path: the reader bumps its version on
            # every view mutation, so an unchanged table is one int
            # compare — no byte scan, no items() dict copy
            fp: tuple = ("v", version)
            if fp == self._cache_fp:
                return self._cache
            items = self._reader.items()
        else:
            items = self._reader.items()
            crc = 0
            for key, value in items.items():
                crc = zlib.crc32(value, zlib.crc32(key.encode("utf-8"), crc))
            # empty table ≠ crc seed 0
            fp = ("crc", (crc << 1) | 1 if items else 0)
        if fp != self._cache_fp:
            self._cache = parse_replicas(items)
            self._cache_by_key = {r.key: r for r in self._cache}
            self._cache_fp = fp
        return self._cache

    @hotpath
    def replicas(
        self,
        *,
        agent: "str | None" = None,
        model: "str | None" = None,
    ) -> "list[Replica]":
        """Every advertised replica (stale and draining INCLUDED — this
        is the rendering/debugging read), optionally filtered by agent
        name or model name."""
        out = self._parsed()
        if agent is not None:
            out = [r for r in out if r.agent_name == agent]
        if model is not None:
            out = [r for r in out if r.model_name == model]
        # never hand out the cache list itself: a caller-side sort/append
        # would poison every later read
        return list(out) if out is self._cache else out

    @hotpath
    def replica(self, key: str) -> "Replica | None":
        """One replica by its full ``<node_id>@<instance>`` key, or None
        when its record left the table (tombstoned, compacted away).  The
        failover supervisor's per-probe lookup — O(1) off the parsed
        cache."""
        self._parsed()
        return self._cache_by_key.get(key)

    @hotpath
    def eligible(
        self,
        agent: str,
        *,
        exclude: "frozenset[str] | set[str]" = frozenset(),
        now: "float | None" = None,
    ) -> "list[Replica]":
        """Replicas a NEW run may be routed to: verdict ``"yes"`` under
        :func:`eligibility_verdict` and not in ``exclude``."""
        if now is None:
            now = cancellation.wall_clock()
        return [
            r
            for r in self.replicas(agent=agent)
            if r.instance_id not in exclude
            and eligibility_verdict(
                r, stale_after=self.stale_after, now=now
            ) == "yes"
        ]
