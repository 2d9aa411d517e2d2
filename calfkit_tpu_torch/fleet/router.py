"""The fleet router: registry + policy → one topic per call.

Sits on the CALLER side of the mesh (the client owns one), replacing the
hardcoded ``agent_input_topic`` in ``client/caller.py`` with an explicit
placement decision:

    eligible = registry.eligible(agent, exclude=…)   # drain/stale gate
    replica  = policy.select(eligible, request)       # ranking seam
    topic    = replica.topic or shared fallback

Design rules:

- **Fail-open to the shared topic.**  No control plane, a cold
  directory, zero live replicas, every replica excluded — all degrade
  to the pre-fleet shared topic, where consumer-group membership still
  load-balances blindly.  Routing is an optimization; it must never be
  a new way for a call to fail.
- **Reads only.**  The per-call path touches the registry's folded
  table snapshot (host memory) — no broker round-trip, no barrier, no
  lock; it is ``@hotpath`` code: nothing in it blocks.
- **Exclusions are per-pick**, supplied by the caller (the shed-retry
  loop in ``AgentGateway.execute`` excludes the replica that shed).
- **Local in-flight accounting.**  Heartbeat depth is fleet-wide truth
  but lags a beat interval; a router ranking on it alone herds every
  pick between two beats onto the momentary minimum.  The router
  therefore folds its OWN not-yet-returned placements into each
  candidate's depth (``Replica.router_inflight`` — the least-request
  technique client-side balancers use).  Entries clear when the run's
  terminal reply lands (the gateway notifies) and are TTL-swept as a
  leak backstop for runs whose terminal never arrives.
"""

from __future__ import annotations

from calfkit_tpu_torch.effects import hotpath


import asyncio
import logging
import time
from dataclasses import dataclass, replace

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.fleet.policy import (
    RouteRequest,
    RoutingPolicy,
    affinity_key_for,
    resolve_policy,
)
from calfkit_tpu_torch.fleet.registry import Replica, ReplicaRegistry
from calfkit_tpu_torch.mesh.transport import MeshTransport

logger = logging.getLogger(__name__)

__all__ = ["Route", "FleetRouter"]


@dataclass(frozen=True)
class Route:
    """One placement decision: where to publish, and to whom."""

    topic: str
    replica: "Replica | None" = None  # None = shared-topic fallback

    @property
    def instance_id(self) -> "str | None":
        return self.replica.instance_id if self.replica else None


class FleetRouter:
    def __init__(
        self,
        transport: MeshTransport,
        policy: "RoutingPolicy | str" = "p2c",
        *,
        stale_after: "float | None" = None,
        catchup_timeout: float = 30.0,
    ):
        kwargs = {"catchup_timeout": catchup_timeout}
        if stale_after is not None:
            kwargs["stale_after"] = stale_after
        self.registry = ReplicaRegistry(transport, **kwargs)
        self.policy = resolve_policy(policy)
        self._started = False
        # monotonic stamp of the last failed registry start: routing
        # degrades to the shared topic, then RE-PROBES after
        # start_retry_interval — a one-blip broker outage at first call
        # must not disable fleet routing for the client's lifetime
        self._start_failed_at: "float | None" = None
        self.start_retry_interval = 30.0
        # created lazily (constructor may run with no event loop): guards
        # the registry start against concurrent first route() calls —
        # N unguarded awaits would each start a table reader, leaking
        # N-1 broker clients and pump tasks on a real transport
        self._start_lock: "asyncio.Lock | None" = None
        # local in-flight placements, keyed by the FULL replica key
        # ("<node_id>@<instance>"): bare instance ids collide across
        # agents when operators pin stable ids ("r0", "r1") for every
        # agent's replicas, and a collision would charge agent A's
        # backlog against agent B's idle replica.  Values are
        # {correlation: placed-at monotonic}; bounded by construction
        # (one entry per in-flight run of THIS client) with a TTL sweep
        # as the leak backstop for runs whose terminal never arrives.
        self._inflight: "dict[str, dict[str, float]]" = {}
        self.inflight_ttl = 600.0

    # ------------------------------------------------ in-flight accounting
    @hotpath
    def note_dispatch(self, replica_key: str, correlation_id: str) -> None:
        """A run was just placed on the replica (gateway-called)."""
        self._inflight.setdefault(replica_key, {})[correlation_id] = (
            time.monotonic()
        )

    @hotpath
    def note_done(self, replica_key: str, correlation_id: str) -> None:
        """The run's terminal reply landed (any outcome)."""
        entries = self._inflight.get(replica_key)
        if entries is not None:
            entries.pop(correlation_id, None)
            if not entries:
                self._inflight.pop(replica_key, None)

    @hotpath
    def _sweep_inflight(self, now_m: float) -> None:
        """Drop TTL-expired entries and emptied per-instance dicts for
        EVERY instance — including replicas that have left the fleet
        (sweeping only current candidates would leak entries charged to
        a departed replica forever, and a non-empty ``_inflight`` forces
        the per-candidate copy pass in :meth:`select` on every pick)."""
        for replica_key, entries in list(self._inflight.items()):
            stale = [
                corr for corr, placed in entries.items()
                if now_m - placed > self.inflight_ttl
            ]
            for corr in stale:
                del entries[corr]
            if not entries:
                self._inflight.pop(replica_key, None)

    @hotpath
    def _outstanding(self, replica_key: str) -> int:
        entries = self._inflight.get(replica_key)
        return len(entries) if entries else 0

    # ---------------------------------------------- dead-placement law
    def placement_verdict(self, replica_key: str) -> str:
        """Is a run placed on ``replica_key`` still being served?  ``"alive"``, or ``"dead:gone"`` / ``"dead:stale"`` /
        ``"dead:unready"`` per :func:`calfkit_tpu_torch.fleet.failover.
        placement_verdict`.  Fail-SAFE, not fail-open: with no registry
        view (router never started, directory down) the verdict is
        ``"alive"`` — failover must never fire on blindness, only on
        positive evidence of death."""
        if not self._started:
            return "alive"
        from calfkit_tpu_torch.fleet.failover import placement_verdict

        return placement_verdict(
            self.registry.replica(replica_key),
            stale_after=self.registry.stale_after,
        )

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._started:
            return
        if self._start_lock is None:
            self._start_lock = asyncio.Lock()
        async with self._start_lock:  # single-flight across callers
            if self._started:
                return
            await self.registry.start()
            # atomicity-ok: double-checked under _start_lock (re-read
            # inside the lock above)
            self._started = True
            self._start_failed_at = None

    async def stop(self) -> None:
        if self._start_lock is None:
            self._start_lock = asyncio.Lock()
        async with self._start_lock:
            # serialized with start(): stopping while a first route()'s
            # catch-up is in flight must wait for it, or registry.stop()
            # would no-op (registry not yet marked started) and the
            # reader's broker client + pump task would outlive the client
            self._started = False
            await self.registry.stop()

    # --------------------------------------------------------------- route
    async def route(
        self,
        agent: str,
        *,
        prompt_text: str = "",
        correlation_id: str = "",
        exclude: "frozenset[str] | set[str]" = frozenset(),
    ) -> Route:
        """Pick a target topic for one call to ``agent``.  Never raises:
        any trouble (directory unreadable, no live replicas) returns the
        shared-topic fallback."""
        shared = Route(topic=protocol.agent_input_topic(agent))
        if not self._started:
            if (
                self._start_failed_at is not None
                and time.monotonic() - self._start_failed_at
                < self.start_retry_interval
            ):
                return shared  # directory recently failed: don't re-pay yet
            try:
                await self.start()
            except Exception:  # noqa: BLE001 - fail-open to shared topic
                # atomicity-ok: _start_failed_at is a rate-limit stamp —
                # concurrent failed routes both stamping is last-wins and
                # only widens the retry backoff by one interval
                self._start_failed_at = time.monotonic()
                logger.warning(
                    "fleet registry unavailable; routing %s via the "
                    "shared topic (re-probing in %.0fs)",
                    agent, self.start_retry_interval, exc_info=True,
                )
                return shared
        try:
            replica = self.select(
                agent,
                prompt_text=prompt_text,
                correlation_id=correlation_id,
                exclude=exclude,
            )
        except Exception:  # noqa: BLE001 - the never-raises contract
            # covers the whole pick, not just registry start: a custom
            # policy's select() or a broken reader read degrades to the
            # shared topic instead of failing the call
            logger.warning(
                "replica selection failed for %s; using the shared topic",
                agent, exc_info=True,
            )
            return shared
        if replica is None:
            return shared
        return Route(topic=replica.topic, replica=replica)

    @hotpath
    def select(
        self,
        agent: str,
        *,
        prompt_text: str = "",
        correlation_id: str = "",
        exclude: "frozenset[str] | set[str]" = frozenset(),
    ) -> "Replica | None":
        """The synchronous per-dispatch selection path (registry snapshot
        + pure policy; ``@hotpath``): ``None`` = no eligible
        replica, use the shared topic."""
        candidates = self.registry.eligible(agent, exclude=exclude)
        if not candidates:
            return None
        if self._inflight:
            # fold this router's own not-yet-returned placements into
            # the heartbeat depths (least-request accounting)
            self._sweep_inflight(time.monotonic())
        if self._inflight:
            candidates = [
                replace(r, router_inflight=self._outstanding(r.key))
                for r in candidates
            ]
        request = RouteRequest(
            agent=agent,
            affinity_key=affinity_key_for(prompt_text),
            correlation_id=correlation_id,
        )
        return self.policy.select(candidates, request)
