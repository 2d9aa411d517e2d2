"""The fleet-scenario DSL.

A :class:`Scenario` is a declarative description of one simulated fleet
run: how many replicas, what the arrival process looks like over virtual
time, who the tenants are, how the (stubbed) engines behave, which
faults are scripted when, and which :class:`Check` verdicts the run must
satisfy.  A runner executes it against the REAL
mesh → worker → node-kernel → fleet-router path; everything random rides
an injected seeded rng (the ``RetryPolicy`` convention), so one seed
pins the whole timeline.  (The JAX package's ``sim/runner.py`` is that
runner; the port carries the dataclasses, which its stubs read.)

Scale knobs (``Scenario.scaled``) exist so the SAME scenario definition
runs full-size (hundreds of replicas, simulated hours) and small in the
determinism tests.

Time in this module is VIRTUAL seconds unless a name says otherwise;
nothing here reads a clock at all.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Iterator, Protocol

__all__ = [
    "LoadPhase",
    "TenantSpec",
    "ServiceSpec",
    "ReplicaEvent",
    "LeaseChurn",
    "Check",
    "Scenario",
    "diurnal_phases",
    "CHECK_OPS",
]


@dataclass(frozen=True)
class LoadPhase:
    """One segment of the arrival curve: Poisson arrivals at ``rate_rps``
    (mean requests per VIRTUAL second, exponential interarrivals from the
    scenario rng) for ``duration_s`` virtual seconds.  ``rate_rps=0`` is
    a silent gap (the diurnal trough, a maintenance window)."""

    duration_s: float
    rate_rps: float


def diurnal_phases(
    *,
    hours: float = 24.0,
    trough_rps: float,
    peak_rps: float,
    steps: int = 24,
) -> "tuple[LoadPhase, ...]":
    """A smooth day curve: ``steps`` equal phases tracing a raised cosine
    from trough (t=0) up to peak (t=hours/2) and back — the classic
    diurnal load shape, deterministic by construction."""
    phases = []
    for i in range(steps):
        # phase midpoint position in the day, 0..1
        x = (i + 0.5) / steps
        level = 0.5 - 0.5 * math.cos(2.0 * math.pi * x)
        phases.append(
            LoadPhase(
                duration_s=hours * 3600.0 / steps,
                rate_rps=trough_rps + (peak_rps - trough_rps) * level,
            )
        )
    return tuple(phases)


@dataclass(frozen=True)
class TenantSpec:
    """One traffic class: ``weight`` is its share of arrivals (relative
    to the other tenants' weights); ``sessions`` is how many distinct
    long-lived sessions its traffic collapses into — each session keeps
    one page-aligned prompt prefix, which is what prefix-affinity
    routing keys on.  A hotspot tenant is just a tenant whose weight
    dwarfs the rest.

    ``priority`` is the class the tenant's calls carry on
    ``x-mesh-priority``: ``"interactive"`` (default) or ``"batch"``.
    Under overload the stub engines shed batch-class arrivals first —
    the mixed_priority_storm scenario gates exactly that ordering."""

    name: str
    weight: float = 1.0
    sessions: int = 4
    priority: str = "interactive"

    def __post_init__(self) -> None:
        if self.priority not in ("interactive", "batch"):
            raise ValueError(
                f"unknown tenant priority {self.priority!r} "
                "(one of: interactive, batch)"
            )


@dataclass(frozen=True)
class ServiceSpec:
    """The stubbed engine's deterministic service model, in VIRTUAL time.

    One request occupies one of ``slots`` virtual servers for
    ``(base_s + prefill_per_token_s × input_tokens × (0 if prefix hit)
    + per_token_s × new_tokens) × skew[replica]`` seconds; requests past
    every busy slot queue in virtual time.  ``shed_above`` is the
    admitted-but-unfinished depth past which the stub sheds with the
    REAL typed ``EngineOverloadedError`` (None = never shed).  ``skew``
    multiplies per replica (cycled), modeling a slow host in the fleet.

    ``pool_pages`` gives every replica a virtual KV page pool
    of that size: the stub then maintains the REAL
    :class:`~calfkit_tpu_torch.observability.capacity.PageLedger` and
    :class:`~calfkit_tpu_torch.observability.capacity.CapacitySampler` (ring
    capacity ``capacity_samples``) through the same alloc / transfer /
    acquire / release / evict transitions a paged engine drives, with
    page counts derived deterministically from the prompt and prefix
    model.  ``0`` (the default) models no pool — pre-capacity scenarios
    are untouched.  Pool size is per replica and intentionally NOT
    scaled by :meth:`Scenario.scaled`: per-replica page pressure is the
    thing the capacity scenario pins."""

    base_s: float = 0.2
    per_token_s: float = 0.01
    prefill_per_token_s: float = 0.002
    new_tokens: int = 32
    steps_per_dispatch: int = 8
    slots: int = 4
    shed_above: "int | None" = None
    skew: "tuple[float, ...]" = ()
    pool_pages: int = 0
    capacity_samples: int = 0

    def multiplier(self, replica_index: int) -> float:
        if not self.skew:
            return 1.0
        return self.skew[replica_index % len(self.skew)]


@dataclass(frozen=True)
class ReplicaEvent:
    """A scripted fault on the fleet timeline, fired at virtual offset
    ``at_s`` from scenario start.  Actions:

    - ``"kill"`` — hard kill / partition away (``ReplicaTransport.kill``):
      publishes vanish, heartbeat stamp freezes, backlog buffers;
    - ``"resume"`` — the heal: backlog replays (cancels first), the next
      heartbeat re-stamps the advert;
    - ``"drain"`` — clean drain (``Worker.drain()``): the advert flips
      ``draining`` on the next beat and the router stops placing here;
    - ``"wedge_heartbeat"`` — the heartbeat loop dies but serving
      continues (the stale-not-dead geometry).
    """

    at_s: float
    action: str  # kill | resume | drain | wedge_heartbeat
    replica: int

    def __post_init__(self) -> None:
        if self.action not in ("kill", "resume", "drain", "wedge_heartbeat"):
            raise ValueError(f"unknown replica event action {self.action!r}")


@dataclass(frozen=True)
class LeaseChurn:
    """Synthetic caller-liveness churn: ``callers`` distinct lease ids
    beat on the compacted ``mesh.caller_liveness`` table (every worker
    folds them into the process lease store, exactly the production
    path).  Each caller beats every ``beat_every_s`` virtual seconds for
    a lifetime drawn uniformly from ``[min_life_s, max_life_s]`` (the
    scenario rng), then goes silent — except a ``clean_release_ratio``
    fraction, which release cleanly (tombstone) at end of life instead.
    Tens of thousands of callers is the intended scale: the point is
    proving the store's lapse law and cap behavior under fleet-sized
    churn."""

    callers: int = 1000
    ttl_s: float = 15.0
    beat_every_s: float = 5.0
    min_life_s: float = 30.0
    max_life_s: float = 300.0
    clean_release_ratio: float = 0.25


CHECK_OPS = ("<=", ">=", "==", "<", ">", "!=")


@dataclass(frozen=True)
class Check:
    """One pass/fail verdict over the scenario's harvested metrics:
    ``metric`` is a dotted path into the scenario report dict (e.g.
    ``"requests.completed"`` or ``"routing.skew_p95_over_mean"``),
    compared against ``bound`` with ``op``.  Missing metric = failed
    check (a silently absent number must not read as a pass)."""

    name: str
    metric: str
    op: str
    bound: float

    def __post_init__(self) -> None:
        if self.op not in CHECK_OPS:
            raise ValueError(f"unknown check op {self.op!r}")

    def evaluate(self, value: "float | None") -> bool:
        if value is None:
            return False
        if self.op == "<=":
            return value <= self.bound
        if self.op == ">=":
            return value >= self.bound
        if self.op == "==":
            return value == self.bound
        if self.op == "<":
            return value < self.bound
        if self.op == ">":
            return value > self.bound
        return value != self.bound


@dataclass(frozen=True)
class Scenario:
    """One declarative fleet-simulation run.  See the module docstring;
    ``docs/simulation.md`` documents every knob and the tolerance
    policy for the gated metrics."""

    name: str
    replicas: int
    phases: "tuple[LoadPhase, ...]"
    policy: str = "p2c"
    seed: int = 0
    tenants: "tuple[TenantSpec, ...]" = (TenantSpec("t0"),)
    service: ServiceSpec = field(default_factory=ServiceSpec)
    events: "tuple[ReplicaEvent, ...]" = ()
    leases: "LeaseChurn | None" = None
    # caller posture: bounded shed-retry attempts (0 = no retry policy),
    # and whether the failover supervisor runs (cascading-failure /
    # partition scenarios need it; steady-state does not)
    retry_attempts: int = 3
    failover: bool = False
    max_failovers: int = 3
    # control-plane cadence, virtual seconds (production shape: 5s beat,
    # 3 beats to stale)
    heartbeat_every_s: float = 5.0
    stale_after_s: float = 15.0
    # per-call budget; generous by default — scenario checks, not
    # timeouts, are the verdict mechanism
    timeout_s: float = 3600.0
    # racing-failover scenarios make per-replica placement counts
    # order-sensitive; with this False the report carries only
    # order-invariant aggregates (see docs/simulation.md "Determinism")
    per_replica_report: bool = True
    checks: "tuple[Check, ...]" = ()
    # dotted metric paths compared against SIM_BASELINE.json by the perf
    # gate (in addition to the pass/fail checks above)
    gated: "tuple[str, ...]" = ()

    @property
    def duration_s(self) -> float:
        return sum(p.duration_s for p in self.phases)

    def expected_arrival_horizon_s(self) -> float:
        """Virtual horizon the runner must keep time flowing past even
        when no arrivals are pending: scripted events and lease churn may
        outlive the load curve."""
        horizon = self.duration_s
        for event in self.events:
            horizon = max(horizon, event.at_s)
        return horizon + 2.0 * self.stale_after_s

    def scaled(self, factor: float) -> "Scenario":
        """A proportionally smaller (or larger) copy: replica count,
        arrival rates, session counts, and lease-churn population scale
        together so per-replica load and per-session turn counts are
        preserved; scripted event indices clamp to the new fleet size,
        and bounds of checks over population-absolute metrics
        (``leases.minted``) scale with the population.

        Verdicts are APPROXIMATELY preserved, not guaranteed: a
        two-replica fleet has almost no sibling headroom to absorb
        Poisson bursts that a twelve-replica fleet statistically
        smooths, so shed-retry checks get tighter as fleets shrink.
        The tier-1 determinism tests pin factor 0.15, where every
        pinned verdict holds; verify before leaning on other factors."""
        replicas = max(2, int(round(self.replicas * factor)))
        phases = tuple(
            replace(p, rate_rps=p.rate_rps * factor) for p in self.phases
        )
        events = tuple(
            replace(e, replica=min(e.replica, replicas - 1))
            for e in self.events
        )
        tenants = tuple(
            replace(t, sessions=max(1, int(round(t.sessions * factor))))
            for t in self.tenants
        )
        leases = self.leases
        checks = self.checks
        if leases is not None:
            scaled_callers = max(8, int(round(leases.callers * factor)))
            leases = replace(leases, callers=scaled_callers)
            checks = tuple(
                replace(c, bound=c.bound * factor)
                if c.metric == "leases.minted"
                else c
                for c in checks
            )
        return replace(
            self, replicas=replicas, phases=phases, events=events,
            tenants=tenants, leases=leases, checks=checks,
        )

    def arrival_times(self, rng: "RandomLike") -> "Iterator[float]":
        """Poisson arrival offsets (virtual seconds from scenario start)
        across every phase, in order, from the injected rng."""
        t = 0.0
        phase_start = 0.0
        for phase in self.phases:
            phase_end = phase_start + phase.duration_s
            if phase.rate_rps > 0.0:
                t = max(t, phase_start)
                while True:
                    t += rng.expovariate(phase.rate_rps)
                    if t >= phase_end:
                        break
                    yield t
            phase_start = phase_end


class RandomLike(Protocol):
    """The slice of ``random.Random`` the DSL consumes (typing seam)."""

    def expovariate(self, lambd: float) -> float: ...

    def uniform(self, a: float, b: float) -> float: ...

    def random(self) -> float: ...
