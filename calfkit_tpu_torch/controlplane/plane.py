"""ControlPlane: the worker-side wiring of publisher + views.

``Worker`` calls :meth:`attach` at boot (reference: the auto-registration in
calfkit/worker/worker.py:197-330): every hosted node's adverts start
heartbeating, and capability/agents views are attached to node resources so
selectors (`Tools(discover=True)`, `Messaging`, `Handoff`) resolve live.
"""

from __future__ import annotations

import logging
from typing import Any

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.controlplane.config import ControlPlaneConfig
from calfkit_tpu_torch.controlplane.publisher import Advert, ControlPlanePublisher
from calfkit_tpu_torch.controlplane.view import ControlPlaneView
from calfkit_tpu_torch.models.agents import AgentCard
from calfkit_tpu_torch.models.capability import CapabilityRecord

logger = logging.getLogger(__name__)

CAPABILITY_VIEW_KEY = "capability_view"
AGENTS_VIEW_KEY = "agents_view"
# set truthy on every node once the caller-liveness feed is consuming:
# the node kernel only ENFORCES leases (registers runs for the orphan
# reaper) where beats can actually arrive — a worker with no control
# plane must not orphan a live caller's run one TTL after admission
CALLER_LIVENESS_FEED_KEY = "caller_liveness_feed"


class _Attached:
    def __init__(
        self,
        publisher: ControlPlanePublisher,
        views: list[ControlPlaneView[Any]],
        liveness: Any = None,  # caller-liveness feed subscription
        runs_feed: Any = None,  # mesh.runs feed subscription
    ):
        self._publisher = publisher
        self._views = views
        self._liveness = liveness
        self._runs_feed = runs_feed

    async def stop(self) -> None:
        await self._publisher.stop()  # tombstones first
        for view in self._views:
            try:
                await view.stop()
            except Exception:  # noqa: BLE001
                logger.debug("view stop failed", exc_info=True)
        for feed, label in (
            (self._liveness, "liveness"),
            (self._runs_feed, "runs"),
        ):
            if feed is not None:
                try:
                    await feed.stop()
                except Exception:  # noqa: BLE001
                    logger.debug("%s feed stop failed", label, exc_info=True)


async def _fold_caller_liveness(record: Any) -> None:
    """The caller-liveness feed handler: fold every beat /
    tombstone on ``mesh.caller_liveness`` into the process-wide lease
    store the engine's orphan reaper reads.  Fail-open by construction
    (``fold_liveness_record`` drops undecodables)."""
    from calfkit_tpu_torch import leases

    leases.fold_liveness_record(record.key, record.value)


async def _fold_run_record(record: Any) -> None:
    """The ``mesh.runs`` feed handler: fold every finished
    run record into the process-wide window store the SLO adverts read.
    Fail-open by construction (the store drops undecodables)."""
    from calfkit_tpu_torch.observability.runledger import run_window_store

    run_window_store().fold(record.key, record.value)


class ControlPlane:
    def __init__(self, config: ControlPlaneConfig | None = None):
        self.config = config or ControlPlaneConfig()

    def adverts_for(self, node: Any) -> list[Advert]:
        adverts: list[Advert] = []
        if hasattr(node, "agent_card"):
            card: AgentCard = node.agent_card()
            adverts.append(
                Advert(
                    topic=protocol.AGENTS_TOPIC,
                    node_name=card.name,
                    node_kind=node.kind,
                    instance_id=node.instance_id,
                    payload=card.model_dump(),
                    payload_fn=lambda n=node: n.agent_card().model_dump(),
                )
            )

            # fleet SLO rollup: per-agent run-level window
            # stats, re-derived from the worker's mesh.runs fold on
            # every heartbeat tick — the per-host→per-zone rollup shape
            # the autoscaler consumes, published compacted to mesh.slo
            def slo_payload(n=node, agent=card.name):
                from calfkit_tpu_torch import cancellation
                from calfkit_tpu_torch.observability.runledger import (
                    run_window_store,
                )

                return run_window_store().rollup_for(
                    agent,
                    window_end=cancellation.wall_clock(),
                    node_id=n.instance_id,
                ).model_dump()

            adverts.append(
                Advert(
                    topic=protocol.SLO_TOPIC,
                    node_name=card.name,
                    node_kind=node.kind,
                    instance_id=node.instance_id,
                    payload=slo_payload(),
                    payload_fn=slo_payload,
                )
            )
        if hasattr(node, "capability_record"):
            record: CapabilityRecord = node.capability_record()
            adverts.append(
                Advert(
                    topic=protocol.CAPABILITIES_TOPIC,
                    node_name=record.node_id,
                    node_kind=node.kind,
                    instance_id=node.instance_id,
                    payload=record.model_dump(),
                    payload_fn=lambda n=node: n.capability_record().model_dump(),
                )
            )
        if (
            hasattr(node, "engine_stats_record")
            and (stats := node.engine_stats_record()) is not None
        ):
            # live serving metrics, re-derived per heartbeat tick (SURVEY
            # §5: the TPU build surfaces tok/s, occupancy, memory)
            def stats_payload(n=node):
                snapshot = n.engine_stats_record()
                if snapshot is None:
                    # raise so the publisher's designed fallback (last good
                    # payload) applies — publishing {} would overwrite the
                    # compacted record with an unreadable one
                    raise RuntimeError("engine stats unavailable this tick")
                return snapshot

            adverts.append(
                Advert(
                    topic=protocol.ENGINE_STATS_TOPIC,
                    node_name=stats["node_id"],
                    node_kind=node.kind,
                    instance_id=node.instance_id,
                    payload=stats,
                    payload_fn=stats_payload,
                )
            )
        return adverts

    async def attach(self, worker: Any, *, ensure: bool = True) -> _Attached:
        transport = worker.mesh
        config = self.config

        capability_view: ControlPlaneView[CapabilityRecord] = ControlPlaneView(
            transport,
            protocol.CAPABILITIES_TOPIC,
            CapabilityRecord,
            stale_after=config.stale_after,
            catchup_timeout=config.catchup_timeout,
        )
        agents_view: ControlPlaneView[AgentCard] = ControlPlaneView(
            transport,
            protocol.AGENTS_TOPIC,
            AgentCard,
            stale_after=config.stale_after,
            catchup_timeout=config.catchup_timeout,
        )
        if ensure:  # False when the worker's provisioner already ran
            await transport.ensure_topics(
                [
                    protocol.AGENTS_TOPIC,
                    protocol.CAPABILITIES_TOPIC,
                    protocol.ENGINE_STATS_TOPIC,
                    protocol.TRACES_TOPIC,
                    protocol.CALLER_LIVENESS_TOPIC,
                    protocol.RUNS_TOPIC,
                    protocol.SLO_TOPIC,
                ],
                compacted=True,
            )
        # views catch up BEFORE serving: a turn must not resolve against a
        # half-read directory.  Anything started before a failure is stopped
        # again — a failed attach must not orphan readers.
        started: list[ControlPlaneView[Any]] = []
        liveness = None
        runs_feed = None
        try:
            for view in (capability_view, agents_view):
                await view.start()
                started.append(view)

            # caller-liveness feed: every worker folds the
            # compacted beat table into the process lease store, so the
            # engines it hosts can reap runs whose caller died — no
            # per-engine subscription, one feed per worker process
            liveness = await transport.subscribe(
                [protocol.CALLER_LIVENESS_TOPIC],
                _fold_caller_liveness,
                group_id=None,
                from_latest=False,
                ordered=False,
            )

            # runs feed: fold finished run records into the
            # process window store behind the per-agent SLO adverts —
            # same one-feed-per-worker shape as the liveness fold
            runs_feed = await transport.subscribe(
                [protocol.RUNS_TOPIC],
                _fold_run_record,
                group_id=None,
                from_latest=False,
                ordered=False,
            )

            adverts: list[Advert] = []
            for node in worker.nodes:
                adverts.extend(self.adverts_for(node))
                node.resources.setdefault(CAPABILITY_VIEW_KEY, capability_view)
                node.resources.setdefault(AGENTS_VIEW_KEY, agents_view)
                node.resources.setdefault(CALLER_LIVENESS_FEED_KEY, True)
            worker.resources.setdefault(CAPABILITY_VIEW_KEY, capability_view)
            worker.resources.setdefault(AGENTS_VIEW_KEY, agents_view)
            worker.resources.setdefault(CALLER_LIVENESS_FEED_KEY, True)

            publisher = ControlPlanePublisher(transport, adverts, config)
            await publisher.start(ensure=ensure)  # fail-loud first adverts
        except BaseException:
            for view in started:
                try:
                    await view.stop()
                except Exception:  # noqa: BLE001
                    logger.debug("view rollback stop failed", exc_info=True)
            for feed in (liveness, runs_feed):
                if feed is not None:
                    try:
                        await feed.stop()
                    except Exception:  # noqa: BLE001
                        logger.debug(
                            "feed rollback stop failed", exc_info=True
                        )
            raise
        logger.info(
            "control plane attached: %d adverts, views live", len(adverts)
        )
        return _Attached(
            publisher,
            [capability_view, agents_view],
            liveness=liveness,
            runs_feed=runs_feed,
        )
