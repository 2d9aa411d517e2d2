"""The fleet simulator's discrete-event loop.

:class:`SimRunner` executes one :class:`~calfkit_tpu_torch.sim.scenario.
Scenario` against the REAL serving stack — an ``InMemoryMesh``, N real
Workers (own dispatch lanes, own control-plane publishers), the real
node kernel and agent turn, the real ``FleetRouter``/``ReplicaRegistry``
over the real compacted ``mesh.engine_stats`` table, a real ``Client``
with the real shed-retry and failover supervision — with exactly ONE
substitution: the inference engine is a
:class:`~calfkit_tpu_torch.sim.stubs.SimEngineModel`, whose service times are
virtual.  Simulated hours cost seconds of host time, and the whole
timeline is a pure function of the scenario seed.

How determinism is achieved (docs/simulation.md "Determinism"):

- every layer's clock reads ride the ``cancellation.wall_clock`` seam,
  swapped for a :class:`~calfkit_tpu_torch.sim.clock.VirtualClock`;
- every id mint (instance ids, correlation ids, lease ids) rides
  :func:`~calfkit_tpu_torch.sim.ids.deterministic_ids`;
- every stochastic choice (arrivals, tenants, policy sampling, retry
  jitter) rides an injected ``random.Random(seed)`` stream;
- NOTHING in the loop waits on host time: heartbeats are virtual
  events (``FleetTopology.beat_all``), the caller's retry backoff is
  zero-delay, the failover supervisor's probe interval is zero (a
  yield, not a timer), and the runner's drain is pure ``sleep(0)``
  ticks — so the asyncio ready queue, which IS deterministic, is the
  only scheduler.

The event loop advances in macro-steps: fire every virtual event in the
next window (arrivals, completions, beats, scripted faults), then drain
the mesh at a frozen clock until quiescent, then jump the clock again.
No wall-clock reads anywhere in this package: host time must never leak
into a report.
"""

from __future__ import annotations

import asyncio
import contextlib
import random
from typing import Any, Iterator

from calfkit_tpu_torch import leases, protocol
from calfkit_tpu_torch.client import Client
from calfkit_tpu_torch.client.caller import RetryPolicy
from calfkit_tpu_torch.fleet import FleetRouter
from calfkit_tpu_torch.fleet.failover import FailoverPolicy
from calfkit_tpu_torch.fleet.policy import (
    LeastLoaded,
    PowerOfTwoChoices,
    PrefixAffinity,
    RandomChoice,
    RoutingPolicy,
)
from calfkit_tpu_torch.mesh.memory import InMemoryMesh
from calfkit_tpu_torch.sim.chaos import settle
from calfkit_tpu_torch.sim.clock import VirtualClock, virtual_clock
from calfkit_tpu_torch.sim.ids import deterministic_ids
from calfkit_tpu_torch.sim.report import CheckResult, ScenarioReport, percentile
from calfkit_tpu_torch.sim.scenario import Scenario, TenantSpec
from calfkit_tpu_torch.sim.stubs import SimEngineModel
from calfkit_tpu_torch.sim.topology import FleetTopology

__all__ = ["SimRunner", "run_scenario", "fresh_lease_store"]

# sleep(0) yields per drain round: enough for a full client→worker→stub
# round trip (~30 awaits) plus supervisor/retry churn riding on top
DRAIN_TICKS = 80
# minimum virtual jump per macro-step: events closer together than this
# fire as one batch (each still at its own timestamp) — bounds the
# number of drain rounds for dense arrival bursts
QUANTUM_S = 0.25
# bounded idle advances once the heap is dry but calls are outstanding
# (blackholed placements waiting out stale_after); then we fail loudly
MAX_IDLE_ADVANCES = 64
# prompts carry a 4-page session preamble so the affinity key (and the
# stub's prefix model) sees a stable head across a session's turns
SESSION_PREFIX_CHARS = 256


@contextlib.contextmanager
def fresh_lease_store() -> "Iterator[None]":
    """Run with an empty process-wide caller-lease store, restoring the
    previous contents after — repeat suite runs in one process (the
    determinism test) must not see each other's leases."""
    with leases._LOCK:
        saved = dict(leases._beats)
        saved_gen = leases._release_gen
        saved_countdown = leases._scan_countdown
        leases._beats.clear()
        leases._scan_countdown = 0
    try:
        yield
    finally:
        with leases._LOCK:
            leases._beats.clear()
            leases._beats.update(saved)
            leases._release_gen = saved_gen
            leases._scan_countdown = saved_countdown


def _resolve_policy(
    name: "str | RoutingPolicy", seed: int
) -> RoutingPolicy:
    """The scenario's policy with every random stream injected from the
    seed (the ``RetryPolicy`` convention) — a bare ``resolve_policy``
    would fall back to the global ``random`` module and break repeat-run
    determinism."""
    if not isinstance(name, str):
        return name
    if name in ("least-loaded",):
        return LeastLoaded()
    if name in ("p2c", "power-of-two"):
        return PowerOfTwoChoices(rng=random.Random(seed ^ 0x9C2).random)
    if name in ("prefix-affinity",):
        return PrefixAffinity(
            fallback=PowerOfTwoChoices(rng=random.Random(seed ^ 0x9C2).random)
        )
    if name in ("random",):
        return RandomChoice(rng=random.Random(seed ^ 0x9C2).random)
    raise ValueError(f"unknown scenario policy {name!r}")


class SimRunner:
    """Execute one scenario; see the module docstring.  ``policy`` (when
    given) OVERRIDES the scenario's routing policy — the perf gate's
    seeded-regression seam (the JAX package's ``scripts/perf_gate.py
    --degrade`` degrades the routing this way)."""

    def __init__(
        self,
        scenario: Scenario,
        *,
        policy: "RoutingPolicy | None" = None,
    ):
        self.scenario = scenario
        self._policy_override = policy

    # ------------------------------------------------------------ helpers
    def _pick_tenant(
        self, rng: random.Random, tenants: "tuple[TenantSpec, ...]"
    ) -> TenantSpec:
        weights = [t.weight for t in tenants]
        return rng.choices(tenants, weights=weights, k=1)[0]

    def _prompt(
        self, rng: random.Random, tenant: TenantSpec, index: int
    ) -> str:
        session = rng.randrange(max(1, tenant.sessions))
        head = f"[{tenant.name}#s{session:04d}] simulated agent session "
        head = (head + "context " * 32)[:SESSION_PREFIX_CHARS]
        return f"{head} turn {index}: do the next step"

    async def _drain(self, ticks: int = DRAIN_TICKS) -> None:
        for _ in range(ticks):
            await asyncio.sleep(0)

    # ---------------------------------------------------------------- run
    async def run(self) -> ScenarioReport:
        scenario = self.scenario
        with contextlib.ExitStack() as stack:
            stack.enter_context(deterministic_ids(scenario.seed))
            stack.enter_context(fresh_lease_store())
            clock = stack.enter_context(virtual_clock())
            return await self._run_inside(clock)
        raise AssertionError("unreachable")  # pragma: no cover

    async def _run_inside(self, clock: VirtualClock) -> ScenarioReport:
        scenario = self.scenario
        arrivals_rng = random.Random(scenario.seed ^ 0xA221)
        tenant_rng = random.Random(scenario.seed ^ 0x7E4A)
        lease_rng = random.Random(scenario.seed ^ 0x1EA5)

        mesh = InMemoryMesh()
        models = [
            SimEngineModel(clock, index=i, service=scenario.service)
            for i in range(scenario.replicas)
        ]
        shed_above = scenario.service.shed_above
        max_workers = max(
            8,
            2 * scenario.service.slots,
            (shed_above + 4) if shed_above is not None else 0,
        )
        topo = FleetTopology(
            mesh,
            models,
            # the REAL heartbeat tick loop must never fire: beats are
            # virtual-clock events (beat_all below), so the control
            # plane is part of the deterministic timeline
            heartbeat_interval=1e6,
            stale_multiplier=1.0,
            max_workers=max_workers,
        )
        policy = self._policy_override or _resolve_policy(
            scenario.policy, scenario.seed
        )
        start_at = clock.now
        kill_ledger: "list[dict[str, Any]]" = []
        depth_samples: "list[int]" = []
        beats_fired = 0

        async with topo:
            router = FleetRouter(
                mesh, policy, stale_after=scenario.stale_after_s
            )
            client = Client.connect(mesh, router=router)
            await router.start()
            await topo.beat_all()
            await settle(
                lambda: len(router.registry.eligible(topo.name))
                == scenario.replicas,
                interval=0,
                ticks=20_000,
                message="fleet never became fully eligible",
            )
            gateway = client.agent(topo.name)

            retry = (
                RetryPolicy(
                    attempts=scenario.retry_attempts,
                    base_delay=0.0,
                    jitter=0.0,
                    rng=random.Random(scenario.seed ^ 0xE77).random,
                )
                if scenario.retry_attempts > 1
                else None
            )
            failover = (
                FailoverPolicy(
                    probe_interval=0.0,
                    max_failovers=scenario.max_failovers,
                )
                if scenario.failover
                else None
            )

            futures: "list[asyncio.Task[Any]]" = []
            faults: "dict[str, int]" = {}
            completed = [0]

            def launch(index: int) -> None:
                # tenant pick then session pick: the SAME rng consumption
                # order as before the QoS split — pre-QoS timelines are
                # byte-identical
                tenant = self._pick_tenant(tenant_rng, scenario.tenants)
                prompt = self._prompt(tenant_rng, tenant, index)

                async def one() -> None:
                    try:
                        await gateway.execute(
                            prompt,
                            timeout=scenario.timeout_s,
                            retry=retry,
                            failover=failover,
                            priority=tenant.priority,
                        )
                        completed[0] += 1
                    except Exception as exc:  # noqa: BLE001 - harvested
                        kind = type(exc).__name__
                        faults[kind] = faults.get(kind, 0) + 1

                futures.append(asyncio.ensure_future(one()))

            # ---- the timeline: arrivals, beats, scripted faults, leases
            offered = 0
            for t in scenario.arrival_times(arrivals_rng):
                index = offered
                offered += 1
                clock.schedule(start_at + t, lambda i=index: launch(i))

            horizon = start_at + scenario.expected_arrival_horizon_s()

            def beat() -> None:
                nonlocal beats_fired
                beats_fired += 1
                for model in models:
                    depth_samples.append(model.active)
                asyncio.ensure_future(topo.beat_all())
                if clock.now + scenario.heartbeat_every_s <= horizon:
                    clock.schedule(
                        clock.now + scenario.heartbeat_every_s, beat
                    )

            clock.schedule(
                start_at + scenario.heartbeat_every_s, beat
            )
            # keep time flowing to the horizon even with no arrivals
            # pending (stale-out windows after a kill, lease tails)
            clock.schedule(horizon, lambda: None)

            def fire_event(action: str, replica: int) -> None:
                if action == "kill":
                    kill_ledger.append(
                        {
                            "replica": replica,
                            "at_s": clock.now - start_at,
                            "delivered_at_kill": topo.calls_delivered(
                                replica
                            ),
                        }
                    )
                    topo.kill(replica)
                elif action == "resume":
                    for entry in kill_ledger:
                        if entry["replica"] == replica and (
                            "delivered_at_heal" not in entry
                        ):
                            entry["delivered_at_heal"] = (
                                topo.calls_delivered(replica)
                            )
                    asyncio.ensure_future(topo.resume(replica))
                elif action == "drain":
                    topo.drain(replica)
                elif action == "wedge_heartbeat":
                    topo.wedge_heartbeat(replica)

            for event in scenario.events:
                clock.schedule(
                    start_at + event.at_s,
                    lambda a=event.action, r=event.replica: fire_event(a, r),
                )

            leases_minted = [0]
            leases_released = [0]
            if scenario.leases is not None:
                self._schedule_leases(
                    clock, mesh, lease_rng, start_at,
                    leases_minted, leases_released,
                )

            # --------------------------------- the discrete-event loop
            idle_advances = 0
            while True:
                await self._drain()
                next_at = clock.next_event_at
                if next_at is not None:
                    idle_advances = 0  # real events = progress
                    clock.advance_to(max(next_at, clock.now + QUANTUM_S))
                    continue
                if all(f.done() for f in futures):
                    break
                # heap dry, calls outstanding: blackholed placements
                # waiting out stale_after — advance deterministically.
                # The budget bounds CONSECUTIVE dry advances only: a
                # long scenario legitimately goes briefly dry many times
                # (a completion frees a dispatcher permit, the next
                # delivery schedules its event one drain later).
                idle_advances += 1
                if idle_advances > MAX_IDLE_ADVANCES:
                    raise RuntimeError(
                        f"scenario {scenario.name!r} did not settle: "
                        f"{sum(not f.done() for f in futures)} call(s) "
                        "still outstanding after the idle-advance budget"
                    )
                clock.advance(max(scenario.stale_after_s / 2.0, 1.0))
            await self._drain()

            # one closing beat so the registry snapshot reflects final
            # counters (failover arrivals, prefix hits) for the harvest
            await topo.beat_all()
            await self._drain()
            report = self._harvest(
                clock=clock,
                start_at=start_at,
                topo=topo,
                models=models,
                router=router,
                mesh=mesh,
                offered=offered,
                completed=completed[0],
                faults=faults,
                depth_samples=depth_samples,
                beats_fired=beats_fired,
                kill_ledger=kill_ledger,
                leases_minted=leases_minted[0],
                leases_released=leases_released[0],
                run_records=client.run_ledger.finished_records(),
            )
            await client.close()
            await router.stop()
        await mesh.stop()
        return report

    # ------------------------------------------------------------- leases
    def _schedule_leases(
        self,
        clock: VirtualClock,
        mesh: InMemoryMesh,
        rng: random.Random,
        start_at: float,
        minted: "list[int]",
        released: "list[int]",
    ) -> None:
        """Synthetic caller-liveness churn: beats and tombstones on the
        real compacted table (every worker folds them — the production
        path), scheduled as virtual events."""
        churn = self.scenario.leases
        assert churn is not None
        writer = mesh.table_writer(protocol.CALLER_LIVENESS_TOPIC)
        duration = max(self.scenario.duration_s, 1.0)

        def put_beat(lease_id: str, ttl: float) -> None:
            asyncio.ensure_future(
                writer.put(lease_id, leases.beat_payload(lease_id, ttl))
            )

        def put_release(lease_id: str) -> None:
            released[0] += 1
            asyncio.ensure_future(writer.tombstone(lease_id))

        for k in range(churn.callers):
            lease_id = f"simlease-{k:06d}"
            born = rng.uniform(0.0, duration)
            life = rng.uniform(churn.min_life_s, churn.max_life_s)
            clean = rng.random() < churn.clean_release_ratio
            minted[0] += 1
            t = 0.0
            while t <= life:
                clock.schedule(
                    start_at + born + t,
                    lambda lid=lease_id, ttl=churn.ttl_s: put_beat(lid, ttl),
                )
                t += churn.beat_every_s
            if clean:
                clock.schedule(
                    start_at + born + life,
                    lambda lid=lease_id: put_release(lid),
                )

    # ------------------------------------------------------------ harvest
    def _harvest(
        self,
        *,
        clock: VirtualClock,
        start_at: float,
        topo: FleetTopology,
        models: "list[SimEngineModel]",
        router: FleetRouter,
        mesh: InMemoryMesh,
        offered: int,
        completed: int,
        faults: "dict[str, int]",
        depth_samples: "list[int]",
        beats_fired: int,
        kill_ledger: "list[dict[str, Any]]",
        leases_minted: int,
        leases_released: int,
        run_records: "list[Any] | None" = None,
    ) -> ScenarioReport:
        scenario = self.scenario
        served = [m.replies for m in models]
        served_total = sum(served)
        mean_served = served_total / max(1, len(served))
        sheds = sum(m.sheds for m in models)
        prefix_lookups = sum(m.prefix_lookups for m in models)
        prefix_hits = sum(m.prefix_hits for m in models)
        decode_tokens = sum(m.decode_tokens for m in models)
        dispatches = sum(m.decode_dispatches for m in models)
        replicas = router.registry.replicas(agent=topo.name)
        failover_arrivals = sum(r.stats.failover_requests for r in replicas)

        delivered_while_dead = 0
        delivered_after_heal = 0
        healed = False
        for entry in kill_ledger:
            final = topo.calls_delivered(entry["replica"])
            end = entry.get("delivered_at_heal", final)
            delivered_while_dead += end - entry["delivered_at_kill"]
            if "delivered_at_heal" in entry:
                healed = True
                delivered_after_heal += final - entry["delivered_at_heal"]

        metrics: "dict[str, Any]" = {
            "requests": {
                "offered": offered,
                "completed": completed,
                "failed": offered - completed,
                "completion_ratio": (
                    round(completed / offered, 6) if offered else 1.0
                ),
                "faults": dict(sorted(faults.items())),
            },
            "shed": {
                "sheds": sheds,
            },
            "routing": {
                "served_total": served_total,
                "fleet": len(models),
                "delivered_while_dead": delivered_while_dead,
                "failover_arrivals": failover_arrivals,
            },
        }
        if healed:
            metrics["routing"]["delivered_after_heal"] = delivered_after_heal
        if run_records is not None:
            # run-level metrics off the client's run ledger,
            # computed through the SAME pure rollup fold the SLO adverts
            # use — the sim gates what callers experienced per RUN
            # (virtual seconds end-to-end across every failover/retry),
            # not per attempt.  Window = the whole scenario.
            from calfkit_tpu_torch.observability.runledger import rollup_window

            entries = [
                {
                    "started_at": r.started_at,
                    "finished_at": r.finished_at,
                    "outcome": r.outcome,
                    "error_type": r.error_type,
                    "attempts": len(r.attempts),
                    "sheds": r.sheds,
                    "failovers": r.failovers,
                    "priority": r.priority,
                }
                for r in run_records
            ]
            rollup = rollup_window(
                entries,
                agent=topo.name,
                window_end=clock.now,
                window_s=max(clock.now - start_at, 1.0) + 1.0,
            )
            metrics["runs"] = {
                "finished": rollup.runs,
                "completed": rollup.completed,
                "completion_ratio": round(rollup.completion_ratio, 6),
                "e2e_p50_s": round(rollup.e2e_p50_s, 6),
                "e2e_p95_s": round(rollup.e2e_p95_s, 6),
                "e2e_p99_s": round(rollup.e2e_p99_s, 6),
                "attempts": rollup.attempts,
                "attempt_amplification": round(
                    rollup.attempt_amplification, 6
                ),
                "shed_rate": round(rollup.shed_rate, 6),
                "failover_rate": round(rollup.failover_rate, 6),
                "orphan_rate": round(rollup.orphan_rate, 6),
                "error_budget_burn": round(rollup.error_budget_burn, 6),
            }
            if any(t.priority == "batch" for t in scenario.tenants):
                # multi-tenant QoS metrics, emitted ONLY when
                # the scenario actually runs mixed classes — single-class
                # scenario reports stay byte-identical to their pre-QoS
                # baselines.  Per-run numbers come off the same rollup
                # fold as metrics["runs"]; shed counts come off the stub
                # engines, split by the VICTIM's class — the fairness
                # ratio (batch share of all sheds) is the gate input.
                interactive_sheds = sum(m.interactive_sheds for m in models)
                batch_sheds = sum(m.batch_sheds for m in models)
                total_sheds = interactive_sheds + batch_sheds
                metrics["qos"] = {
                    "interactive": {
                        "runs": rollup.interactive_runs,
                        "completed": rollup.interactive_completed,
                        "completion_ratio": round(
                            rollup.interactive_completed
                            / rollup.interactive_runs,
                            6,
                        ) if rollup.interactive_runs else 1.0,
                        "e2e_p95_s": round(rollup.interactive_p95_s, 6),
                        "sheds": interactive_sheds,
                        "replies": sum(
                            m.interactive_replies for m in models
                        ),
                    },
                    "batch": {
                        "runs": rollup.batch_runs,
                        "completed": rollup.batch_completed,
                        "completion_ratio": round(
                            rollup.batch_completed / rollup.batch_runs, 6
                        ) if rollup.batch_runs else 1.0,
                        "e2e_p95_s": round(rollup.batch_p95_s, 6),
                        "sheds": batch_sheds,
                        "replies": sum(m.batch_replies for m in models),
                    },
                    "shed_fairness_ratio": round(
                        batch_sheds / total_sheds, 6
                    ) if total_sheds else 1.0,
                }
        metrics.update({
            "prefix": {
                "lookups": prefix_lookups,
                "hits": prefix_hits,
                "hit_rate": (
                    round(prefix_hits / prefix_lookups, 6)
                    if prefix_lookups
                    else 0.0
                ),
                "reused_tokens": sum(
                    m.prefix_reused_tokens for m in models
                ),
            },
            "tokens": {
                "decode_tokens": decode_tokens,
                "dispatches": dispatches,
                "tokens_per_dispatch": (
                    round(decode_tokens / dispatches, 6)
                    if dispatches
                    else 0.0
                ),
            },
            "time": {
                "virtual_duration_s": round(scenario.duration_s, 6),
                # last completion, not the final clock position — the
                # horizon no-op event must not inflate the makespan
                "makespan_s": round(
                    max(
                        (m.last_done_at for m in models if m.last_done_at),
                        default=start_at,
                    )
                    - start_at,
                    6,
                ),
                "events_fired": clock.fired,
                "heartbeats": beats_fired,
            },
        })
        if scenario.service.pool_pages > 0:
            # capacity observatory metrics, summed off the
            # same PageLedger/CapacitySampler a paged engine drives.
            # residual_pages_in_use is the leak oracle at fleet scale:
            # a drained fleet must attribute every page to no owner.
            ledgers = [m.ledger for m in models if m.ledger is not None]
            metrics["capacity"] = {
                "pages_total": sum(led.pages_total for led in ledgers),
                "evicted_pages": sum(led.evicted_pages for led in ledgers),
                "alloc_stalls": sum(led.alloc_stalls for led in ledgers),
                "prefix_resident_pages": sum(
                    led.prefix_resident_pages for led in ledgers
                ),
                "headroom_pages": sum(
                    led.headroom_pages for led in ledgers
                ),
                "residual_pages_in_use": sum(
                    led.pages_in_use for led in ledgers
                ),
                "peak_pages_in_use": max(
                    (m.peak_pages_in_use for m in models), default=0
                ),
                "samples": sum(
                    m.sampler.counts()["appended"]
                    for m in models
                    if m.sampler is not None
                ),
            }
        if scenario.per_replica_report:
            metrics["routing"].update(
                {
                    "per_replica": served,
                    "skew_max_over_mean": (
                        round(max(served) / mean_served, 6)
                        if served_total
                        else 0.0
                    ),
                    "skew_p95_over_mean": (
                        round(
                            percentile([float(s) for s in served], 0.95)
                            / mean_served,
                            6,
                        )
                        if served_total
                        else 0.0
                    ),
                }
            )
            metrics["depth"] = {
                "samples": len(depth_samples),
                "p50": percentile([float(d) for d in depth_samples], 0.50),
                "p95": percentile([float(d) for d in depth_samples], 0.95),
                "max": float(max(depth_samples)) if depth_samples else 0.0,
            }
            ewmas = [
                m.dispatch_ewma_ms for m in models if m.dispatch_ewma_ms > 0
            ]
            metrics["latency"] = {
                "dispatch_ewma_ms_mean": (
                    round(sum(ewmas) / len(ewmas), 6) if ewmas else 0.0
                ),
                "busy_virtual_s_total": round(
                    sum(m.busy_virtual_s for m in models), 6
                ),
            }
        if scenario.leases is not None:
            store = leases.active_leases()
            now = clock.now
            lapsed = sum(
                1
                for beat_at, ttl in store.values()
                if beat_at == float("-inf") or now - beat_at > ttl
            )
            table = mesh.table_reader(protocol.CALLER_LIVENESS_TOPIC)
            metrics["leases"] = {
                "minted": leases_minted,
                "released": leases_released,
                "store_size": len(store),
                "lapsed": lapsed,
                "table_records": len(table.items()),
            }

        checks = [
            CheckResult(
                name=check.name,
                metric=check.metric,
                op=check.op,
                bound=check.bound,
                value=(value := scenario_metric(metrics, check.metric)),
                passed=check.evaluate(value),
            )
            for check in scenario.checks
        ]
        return ScenarioReport(
            name=scenario.name,
            seed=scenario.seed,
            replicas=scenario.replicas,
            metrics=metrics,
            checks=checks,
            gated=scenario.gated,
        )


def scenario_metric(
    metrics: "dict[str, Any]", path: str
) -> "float | None":
    from calfkit_tpu_torch.sim.report import metric_at

    return metric_at(metrics, path)


async def run_scenario(
    scenario: Scenario, *, policy: "RoutingPolicy | None" = None
) -> ScenarioReport:
    """One-shot convenience: build a runner and execute the scenario."""
    return await SimRunner(scenario, policy=policy).run()
