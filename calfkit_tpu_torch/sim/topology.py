"""Multi-replica fleet topologies on one event loop.

:class:`FleetTopology` spawns N workers hosting replicas of ONE agent
name on a shared mesh — exactly the multi-process fleet shape, collapsed
into one event loop so scenarios stay deterministic.  Each replica rides
its own :class:`~calfkit_tpu_torch.sim.transport.ReplicaTransport` (the
death/partition seam) and its own control-plane publisher.

Heartbeat cadence comes in two modes:

- **chaos tests** (the historical shape): heartbeats tick fast on the
  REAL event loop while liveness stamps ride the virtual clock, so
  staleness is driven by ``clock.advance``, never by sleeping;
- **simulator**: ``heartbeat_interval`` is set far beyond the
  run's real duration and :meth:`beat`/:meth:`beat_all` publish adverts
  as virtual-clock events — the control plane becomes part of the
  deterministic timeline (a killed replica's beat is dropped by its
  gated transport, freezing its stamp exactly like a dead process).
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from typing import Any, Callable

from calfkit_tpu_torch.sim.transport import ReplicaTransport

__all__ = ["FleetTopology"]


class FleetTopology:
    """N workers hosting replicas of ONE agent name on a shared mesh.

    Each replica is its own :class:`~calfkit_tpu_torch.worker.Worker` (own
    dispatch lanes, own control-plane publisher, own drain state) —
    exactly the multi-process fleet shape, collapsed into one event loop
    so scenarios stay deterministic.  ``delivered[i]`` ledgers the
    correlation ids whose CALLS were admitted by replica ``i`` (the
    drain/stale scenarios' "zero new calls" oracle).
    """

    def __init__(
        self,
        mesh: Any,
        models: "list[Any]",
        *,
        name: str = "svc",
        heartbeat_interval: float = 0.05,
        stale_multiplier: float = 100.0,
        agent_kwargs: "dict | None" = None,
        meshes: "list[Any] | None" = None,
        max_workers: int = 8,
    ):
        from calfkit_tpu_torch.controlplane import ControlPlaneConfig
        from calfkit_tpu_torch.nodes import Agent
        from calfkit_tpu_torch.worker import Worker

        self.mesh = mesh
        self.name = name
        self.config = ControlPlaneConfig(
            heartbeat_interval=heartbeat_interval,
            stale_multiplier=stale_multiplier,
        )
        self.delivered: "list[list[str]]" = [[] for _ in models]
        self.agents: "list[Any]" = []
        self.workers: "list[Any]" = []
        # replicas whose heartbeat is wedged: the tick loop is cancelled
        # AND the simulator's manual beat skips them (a wedged publisher
        # re-stamping through beat_all would un-wedge it silently)
        self._wedged: "set[int]" = set()
        # every replica's I/O rides its own ReplicaTransport proxy — the
        # process-death seam (kill/resume).  ``meshes`` supplies a
        # per-replica INNER transport (e.g. one KafkaWireMesh connection
        # each, the real multi-process shape); default = the shared mesh.
        self.transports = [
            ReplicaTransport(inner)
            for inner in (meshes if meshes is not None else [mesh] * len(models))
        ]
        for i, model in enumerate(models):
            agent = Agent(
                name,
                model=model,
                before_node=[self._ledger(i)],
                **(agent_kwargs or {}),
            )
            self.agents.append(agent)
            self.workers.append(
                Worker(
                    [agent],
                    mesh=self.transports[i],
                    control_plane=self.config,
                    owns_transport=meshes is not None,
                    max_workers=max_workers,
                )
            )

    def _ledger(self, i: int) -> Callable[[Any], None]:
        def note(ctx: Any) -> None:
            if ctx.delivery_kind == "call":
                self.delivered[i].append(ctx.correlation_id or "")
            return None

        return note

    # ------------------------------------------------------------ lifecycle
    async def __aenter__(self) -> "FleetTopology":
        for worker in self.workers:
            await worker.start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        for worker in self.workers:
            with contextlib.suppress(Exception):
                await worker.stop()

    # ------------------------------------------------------------- identity
    def instance_id(self, i: int) -> str:
        return self.agents[i].instance_id

    def replica_key(self, i: int) -> str:
        return f"{self.agents[i].node_id}@{self.instance_id(i)}"

    def index_of_lowest_key(self) -> int:
        """The replica a depth-tied least-loaded pick lands on (policies
        tie-break on the lexicographic replica key)."""
        return min(range(len(self.agents)), key=self.replica_key)

    def calls_delivered(self, i: int) -> int:
        return len(self.delivered[i])

    # ------------------------------------------------------ process death
    def kill(self, i: int) -> None:
        """Hard-kill replica ``i``: stop consuming AND stop
        heartbeating, without drain — its advert stays on the table with
        the last stamp (staleness is then driven by ``clock.advance``),
        its in-flight output vanishes, its backlog buffers."""
        self.transports[i].kill()

    async def resume(self, i: int) -> None:
        """The killed replica returns as a ZOMBIE: backlog replays
        (cancels first, the express law), publishes flow, the next
        heartbeat re-stamps the advert fresh."""
        await self.transports[i].resume()

    def drain(self, i: int) -> None:
        """Clean drain: the worker refuses NEW calls, finishes in-flight
        work, and its next advert flips ``draining`` so routers stop
        picking it (the scale-down / deploy geometry)."""
        self.workers[i].drain()

    # ---------------------------------------------------- heartbeat chaos
    def _publisher(self, i: int) -> Any:
        attached = self.workers[i]._advertiser
        assert attached is not None, "control plane not attached"
        return attached._publisher

    async def beat(self, i: int) -> None:
        """Publish replica ``i``'s adverts ONCE, stamped at the current
        virtual clock — the simulator's heartbeat primitive (the tick
        loop never fires when ``heartbeat_interval`` is set beyond the
        run).  A killed/partitioned replica's beat is dropped by its
        gated transport, so its table stamp freezes exactly like a dead
        process's."""
        if i in self._wedged:
            return
        publisher = self._publisher(i)
        for advert in publisher._adverts:
            await publisher._writers[advert.topic].put(
                advert.key, publisher._record(advert).to_wire()
            )

    async def beat_all(self) -> None:
        for i in range(len(self.workers)):
            await self.beat(i)

    def wedge_heartbeat(self, i: int) -> None:
        """Simulate a wedged worker: the heartbeat loop dies, the record
        stays on the table with its last stamp (no tombstone — that
        would be a clean shutdown, a DIFFERENT scenario), and serving
        continues.  Advancing the virtual clock past ``stale_after``
        then makes the replica ineligible."""
        publisher = self._publisher(i)
        if publisher._task is not None:
            publisher._task.cancel()
            publisher._task = None
        # simulator mode drives beats manually: mark the replica so
        # beat()/beat_all() stop re-stamping it too
        self._wedged.add(i)

    async def resume_heartbeat(self, i: int) -> None:
        """The wedged worker recovers: one immediate re-advert (fresh
        stamp on the current virtual clock) and the tick loop restarts."""
        self._wedged.discard(i)
        publisher = self._publisher(i)
        await self.beat(i)
        # a real-time chaos-test helper: re-arms the REAL tick loop's monotonic stamp; never
        # runs inside a scenario's virtual event loop
        publisher._last_beat_at = time.monotonic()
        publisher._task = asyncio.get_running_loop().create_task(
            publisher._beat(), name=f"chaos-resumed-heartbeat-{i}"
        )
