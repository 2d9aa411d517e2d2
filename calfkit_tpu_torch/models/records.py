"""Control-plane record envelope: liveness stamp + schema version + payload.

Every control-plane table value is a :class:`ControlPlaneRecord` keyed by
``<node_name>@<instance_id>``; readers collapse instances to one live record
per node and filter by staleness and schema version (reference:
calfkit/controlplane/records.py:54, view at controlplane/view.py:116-123).
"""

from __future__ import annotations

from typing import Any

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire

from calfkit_tpu_torch import cancellation

SCHEMA_VERSION = 1


def _now() -> float:
    # through the module attribute, NOT a bound reference: liveness stamps
    # must follow the ONE deadline clock (the wall_clock seam) so
    # the chaos harness's virtual clock governs staleness-based replica
    # eligibility deterministically — a time.time stamp here would make a
    # frozen-clock fleet scenario see every replica as stale (or fresh)
    # depending on the host's real clock, not the script
    return cancellation.wall_clock()


@dataclass(kw_only=True)
class ControlPlaneStamp(Wire):

    node_name: str
    node_kind: str
    instance_id: str
    started_at: float = field(default_factory=_now)
    heartbeat_at: float = field(default_factory=_now)

    def key(self) -> str:
        return f"{self.node_name}@{self.instance_id}"


@dataclass(kw_only=True)
class ControlPlaneRecord(Wire):

    schema_version: int = SCHEMA_VERSION
    stamp: ControlPlaneStamp
    record: dict[str, Any] = field(default_factory=dict)  # AgentCard / CapabilityRecord dump

    def to_wire(self) -> bytes:
        return self.model_dump_json().encode("utf-8")

    @classmethod
    def from_wire(cls, data: bytes | str) -> "ControlPlaneRecord":
        return cls.model_validate_json(data)


@dataclass(kw_only=True)
class EngineStatsRecord(Wire):
    """Live serving metrics for one worker's inference engine, heartbeated
    on the control plane (SURVEY §5: the TPU build adds real metrics —
    tok/s, batch occupancy, memory — where the reference had only logs).

    Re-derived per heartbeat tick, so readers see a rolling snapshot with
    the same staleness semantics as agent liveness.
    """

    node_id: str
    model_name: str = ""
    platform: str = ""
    # fleet identity + routability: which replica instance this
    # record describes, the replica-addressed topic the router may publish
    # to ("" = not individually addressable, shared-topic only), and the
    # worker's readiness/drain state at heartbeat time.  Defaults read a
    # pre-fleet record as an anonymous, routable-only-via-shared-topic
    # replica that is serving — not as unknown.
    instance_id: str = ""
    replica_topic: str = ""
    ready: bool = True
    draining: bool = False
    tokens_per_second: float = 0.0
    mean_occupancy: float = 0.0
    active_requests: int = 0
    # requests admitted but not yet holding a slot (queued + carry + long
    # queue): active + pending is the router's queue-depth load signal
    pending_requests: int = 0
    free_slots: int = 0
    max_batch_size: int = 0
    kv_layout: str = "dense"
    free_pages: int | None = None  # paged layout only
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_dispatches: int = 0
    # overlapped execution: double-buffered dispatch enabled, and pad
    # tokens discarded by one-dispatch-late retirement (the overlap tax).
    # Default False so a record from a pre-overlap engine (key absent)
    # reads as off/unknown, not as overlapped-with-zero-waste
    overlap_dispatch: bool = False
    overlap_wasted_tokens: int = 0
    # ragged unified prefill+decode waves: whether the fused
    # lane is live, prefill chunk tokens absorbed into decode dispatches,
    # and tokens processed (decode + absorbed) per dispatch.  Defaults
    # read a pre-ragged engine's record as off/zero, not unknown.
    ragged_waves: bool = False
    prefill_absorbed_tokens: int = 0
    unified_dispatches: int = 0
    tokens_per_dispatch: float = 0.0
    # overload protection: admission sheds (max_pending bound),
    # deadline expiries, reaped consumer cancels (with the mesh-propagated
    # subset) and max_out_blocks stall-cancels.  Defaults 0 so records
    # from older engines read as "no overload events", not unknown.
    max_pending: int = 0
    shed_requests: int = 0
    expired_requests: int = 0
    # multi-tenant QoS: per-class splits of the shed/expired
    # counters and per-class QUEUED depth — `ck stats` class columns and
    # the routing policy's interactive-depth tiebreak.  Defaults 0 so a
    # pre-QoS record reads as "no class signal", not unknown.
    interactive_shed: int = 0
    batch_shed: int = 0
    interactive_expired: int = 0
    batch_expired: int = 0
    interactive_pending: int = 0
    batch_pending: int = 0
    cancelled_requests: int = 0
    cancel_propagated: int = 0
    delivery_stalled: int = 0
    # caller liveness: runs the server-side orphan reaper
    # abandoned because their CALLER's lease lapsed — `ck stats` ORPHANS.
    # Default 0 so pre-lease records read as "no orphans", not unknown.
    orphaned_requests: int = 0
    # EWMA decode-dispatch latency (ms): the many-router tiebreak signal
    # — PowerOfTwoChoices breaks queue-depth ties on it so N independent
    # routers seeing identical depths between beats stop herding.
    # Default 0.0 = "no signal" (pre-EWMA records tie-break on the key).
    dispatch_ewma_ms: float = 0.0
    # failure recovery: whether the engine's dispatch-progress
    # watchdog currently declares it wedged (ready goes false with it —
    # routers route around, and outstanding placements are declared
    # dead), its trip/fault lifetime counters, and how many of this
    # replica's arrivals were failover re-dispatches / hedge duplicates
    # (counted by the serving agent from the x-mesh-attempt marker).
    # Defaults read a older record as never-wedged / no-recovery.
    wedged: bool = False
    watchdog_trips: int = 0
    watchdog_faulted: int = 0
    failover_requests: int = 0
    hedge_requests: int = 0
    # run-scoped observability: arrivals counted from the
    # x-mesh-run header by the serving agent — run_requests counts
    # first attempts (attempt_no == 0), attempt_requests counts every
    # linked placement, so ATTEMPTS/RUNS in `ck stats` is the attempt
    # amplification failover/hedge re-dispatches add per replica.
    # Corrupt/missing run headers count in NEITHER (un-linked degrade).
    # Defaults read a pre-run-ledger record as zero, not unknown.
    run_requests: int = 0
    attempt_requests: int = 0
    # prefix-cache health: cached pages resident plus lifetime
    # hit/reuse counters — the signal prefix-affinity routing exists to
    # improve, surfaced per replica in `ck fleet` and ROUTER.json
    prefix_cached_pages: int = 0
    prefix_hits: int = 0
    prefix_reused_tokens: int = 0
    # capacity observatory: the headroom advert.  pages_total
    # is the allocatable pool (pool minus the trash page; 0 = dense
    # layout, no page signal); pages_in_use counts live-owner pages only
    # (slot-held private + referenced prefix pages — zero-ref cached
    # pages are evictable-on-demand and therefore headroom, not use);
    # prefix_resident_pages is cache residency regardless of refcount;
    # evictions_window is pages reclaimed under pressure THIS heartbeat
    # interval; alloc_stalls counts admissions whose page alloc came up
    # short (lifetime).  The registry derives headroom_pages =
    # pages_total - pages_in_use.  Defaults read a pre-capacity record
    # as a dense/no-signal replica, not as a full one.
    pages_total: int = 0
    pages_in_use: int = 0
    prefix_resident_pages: int = 0
    evictions_window: int = 0
    alloc_stalls: int = 0
    # flight-recorder ring accounting ({"appended", "dropped", "dumped"}):
    # None for records from engines predating the journal
    flightrec: dict[str, int] | None = None
    hbm_gb_in_use: float | None = None  # where the backend reports memory
    # latency percentiles (ms) from the engine's fixed-bucket histograms:
    # ttft_p50/p99, inter_token_p50/p99, queue_wait_p50/p99, prefill_p50/p99
    latency_ms: dict[str, float] | None = None
    # per-heartbeat-interval deltas (EngineStats.snapshot_and_delta), so
    # directory readers see rates, not lifetime cumulative values
    window: dict[str, Any] | None = None


@dataclass(kw_only=True)
class RunAttemptRecord(Wire):
    """One placement of a supervised run: which replica got
    the call, under which correlation id (== that attempt's trace id by
    client convention — the ``ck run`` stitch key), how it was marked
    (first | retry | failover | hedge | resume), and how it ended."""

    attempt_no: int = 0
    correlation_id: str = ""
    # first | retry | failover | hedge | resume
    kind: str = "first"
    # replica key "<agent>@<instance>" ("" = shared-topic / unrouted)
    placement: str = ""
    agent: str = ""
    started_at: float = 0.0  # wall_clock seam (virtual in sim)
    finished_at: float = 0.0  # 0.0 = never finished (superseded/killed)
    # ok | fault | shed | cancelled | superseded | pending
    outcome: str = "pending"
    error_type: str = ""  # typed fault code (x-mesh-error-type) if any
    queue_wait_s: float = 0.0
    tokens_delivered: int = 0
    device_time_s: float = 0.0  # from engine counters where reported


@dataclass(kw_only=True)
class RunRecord(Wire):
    """One logical run's ledger entry, published compacted to
    ``mesh.runs`` (key = ``run_id``) when the supervising client
    finishes the run.  The run-level view the per-attempt trace and
    flight-recorder timelines cannot give: one record spans every
    retry/failover/hedge/resume placement."""

    run_id: str
    agent: str = ""
    client_id: str = ""
    started_at: float = 0.0
    finished_at: float = 0.0
    # ok | fault | timeout | cancelled | pending
    outcome: str = "pending"
    error_type: str = ""
    # priority class: the run's effective class as the
    # supervising client resolved it.  Default = the default class, so
    # a pre-QoS record folds as interactive, never as a third bucket.
    priority: str = "interactive"
    attempts: "list[RunAttemptRecord]" = field(default_factory=list)
    sheds: int = 0
    failovers: int = 0
    hedges: int = 0
    resumes: int = 0
    tokens_delivered: int = 0

    def run_key(self) -> str:
        """Compaction key: latest record per run survives."""
        return self.run_id

    def to_wire(self) -> bytes:
        return self.model_dump_json().encode("utf-8")

    @classmethod
    def from_wire(cls, data: bytes | str) -> "RunRecord":
        return cls.model_validate_json(data)


@dataclass(kw_only=True)
class SloRollupRecord(Wire):
    """Per-agent windowed run-level SLO rollup, re-derived on
    the control-plane heartbeat cadence from folded ``mesh.runs``
    records and published compacted to ``mesh.slo`` (key =
    ``<agent>@<instance>`` of the publishing worker).  Run-level, not
    attempt-level: completion ratio and latency percentiles describe
    what callers experienced, with failover/hedge amplification visible
    separately."""

    agent: str
    node_id: str = ""  # publishing worker's node@instance provenance
    window_s: float = 300.0
    window_end: float = 0.0  # wall_clock seam (virtual in sim)
    runs: int = 0
    completed: int = 0
    completion_ratio: float = 1.0
    e2e_p50_s: float = 0.0
    e2e_p95_s: float = 0.0
    e2e_p99_s: float = 0.0
    attempts: int = 0
    attempt_amplification: float = 1.0
    shed_rate: float = 0.0
    failover_rate: float = 0.0
    orphan_rate: float = 0.0
    # fraction of the window's error budget burned: observed failure
    # ratio / allowed failure ratio against the completion objective
    slo_completion_target: float = 0.999
    error_budget_burn: float = 0.0
    # per-class sub-rollups: the `ck slo` class split.  A
    # pre-QoS rollup reports zeros — "no class signal", not "no runs"
    # (the totals above stay authoritative).
    interactive_runs: int = 0
    interactive_completed: int = 0
    interactive_p95_s: float = 0.0
    batch_runs: int = 0
    batch_completed: int = 0
    batch_p95_s: float = 0.0

    def slo_key(self) -> str:
        return f"{self.agent}@{self.node_id}" if self.node_id else self.agent

    def to_wire(self) -> bytes:
        return self.model_dump_json().encode("utf-8")

    @classmethod
    def from_wire(cls, data: bytes | str) -> "SloRollupRecord":
        return cls.model_validate_json(data)


@dataclass(kw_only=True)
class SpanRecord(Wire):
    """One finished trace span, published to the compacted ``mesh.traces``
    topic (and kept in the process tracer's ring buffer as the zero-broker
    fallback).  ``trace_id`` equals the run's correlation id by client
    convention, so ``ck trace <correlation-id>`` needs no join."""

    trace_id: str
    span_id: str
    parent_span_id: str | None = None
    name: str = ""
    # client | dispatch | agent | tool | consumer | toolbox | engine | internal
    kind: str = "internal"
    emitter: str = ""
    start_s: float = 0.0  # wall clock (epoch seconds): waterfall alignment
    duration_ms: float = 0.0
    status: str = "ok"  # ok | error | cancelled
    attrs: dict[str, Any] = field(default_factory=dict)

    def span_key(self) -> str:
        """Compaction key: latest record per span survives."""
        return f"{self.trace_id}/{self.span_id}"

    def to_wire(self) -> bytes:
        return self.model_dump_json().encode("utf-8")

    @classmethod
    def from_wire(cls, data: bytes | str) -> "SpanRecord":
        return cls.model_validate_json(data)
