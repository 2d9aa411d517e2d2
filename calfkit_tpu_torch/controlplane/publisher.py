"""The worker-owned heartbeat publisher.

Contract (reference: calfkit/controlplane/publisher.py:42-127):

- the FIRST publish of every advert is fail-loud: a worker that cannot
  announce itself must not report a healthy boot;
- subsequent ticks are resilient: a transient publish failure logs WARNING
  and the loop continues;
- shutdown cancels the tick task BEFORE writing tombstones, so a tick can't
  resurrect a record mid-withdrawal.
"""

from __future__ import annotations

import asyncio
import logging
import time
import weakref
from dataclasses import dataclass
from typing import Any

from calfkit_tpu_torch import cancellation
from calfkit_tpu_torch.mesh.transport import MeshTransport
from calfkit_tpu_torch.models.records import ControlPlaneRecord, ControlPlaneStamp
from calfkit_tpu_torch.observability.metrics import REGISTRY
from calfkit_tpu_torch.controlplane.config import ControlPlaneConfig

logger = logging.getLogger(__name__)

# a REAL staleness signal: computed at scrape time
# from the last successful publish, so a wedged heartbeat loop shows a
# climbing number instead of a frozen last-write.  Directory readers see
# staleness per node via ControlPlaneStamp.heartbeat_at; this gauge is
# the LOCAL view — "is MY publisher still getting beats out?" — which is
# what a node-level alert needs when the broker (and thus the directory)
# is the thing that broke.
_HB_STALENESS = REGISTRY.gauge(
    "calfkit_heartbeat_staleness_s",
    "seconds since this process's last successful control-plane "
    "heartbeat publish (scrape-time computed)",
)


def _bind_staleness(publisher: "ControlPlanePublisher") -> None:
    """Point the gauge at ``publisher`` without pinning it alive: a
    collected (or stopped) publisher reads as 0 rather than climbing
    forever on a process that deliberately shut its control plane."""
    ref = weakref.ref(publisher)

    def staleness() -> float:
        p = ref()
        if p is None or p._last_beat_at is None:
            return 0.0
        return max(0.0, time.monotonic() - p._last_beat_at)

    _HB_STALENESS.set_fn(staleness)


@dataclass(frozen=True)
class Advert:
    topic: str
    node_name: str
    node_kind: str
    instance_id: str
    payload: dict[str, Any]  # AgentCard / CapabilityRecord dump
    # re-derives the payload per heartbeat tick so runtime changes (e.g. an
    # MCP toolbox re-listing after tools/list_changed) reach the directory
    payload_fn: Any = None  # Callable[[], dict] | None

    @property
    def key(self) -> str:
        return f"{self.node_name}@{self.instance_id}"

    def current_payload(self) -> dict[str, Any]:
        if self.payload_fn is not None:
            try:
                return self.payload_fn()
            except Exception:  # noqa: BLE001 - fall back to the boot snapshot
                logger.warning(
                    "advert payload refresh failed for %s", self.key, exc_info=True
                )
        return self.payload


class ControlPlanePublisher:
    def __init__(
        self,
        transport: MeshTransport,
        adverts: list[Advert],
        config: ControlPlaneConfig | None = None,
    ):
        self._transport = transport
        self._adverts = adverts
        self._config = config or ControlPlaneConfig()
        self._writers = {
            topic: transport.table_writer(topic)
            for topic in {a.topic for a in adverts}
        }
        self._task: asyncio.Task[None] | None = None
        # liveness stamps ride the ONE deadline clock (cancellation.
        # wall_clock): readers compare heartbeat_at against the same seam,
        # so a chaos virtual clock drives staleness deterministically
        self._started_at = cancellation.wall_clock()
        self._last_beat_at: float | None = None  # monotonic; None pre-start

    def _record(self, advert: Advert) -> ControlPlaneRecord:
        return ControlPlaneRecord(
            stamp=ControlPlaneStamp(
                node_name=advert.node_name,
                node_kind=advert.node_kind,
                instance_id=advert.instance_id,
                started_at=self._started_at,
                heartbeat_at=cancellation.wall_clock(),
            ),
            record=advert.current_payload(),
        )

    async def start(self, *, ensure: bool = True) -> None:
        if ensure:  # False when the worker's provisioner owns topic admin
            topics = sorted(self._writers)
            await self._transport.ensure_topics(topics, compacted=True)
        # first adverts: fail-loud
        for advert in self._adverts:
            await self._writers[advert.topic].put(
                advert.key, self._record(advert).to_wire()
            )
        self._last_beat_at = time.monotonic()
        _bind_staleness(self)
        self._task = asyncio.get_running_loop().create_task(
            self._beat(), name="control-plane-heartbeat"
        )

    async def _beat(self) -> None:
        while True:
            await asyncio.sleep(self._config.heartbeat_interval)
            beat_ok = bool(self._adverts)
            for advert in self._adverts:
                try:
                    await self._writers[advert.topic].put(
                        advert.key, self._record(advert).to_wire()
                    )
                except Exception:  # noqa: BLE001 - per-tick resilience
                    beat_ok = False
                    logger.warning(
                        "heartbeat publish failed for %s (retrying next tick)",
                        advert.key,
                        exc_info=True,
                    )
            if beat_ok:
                # only a fully-successful tick resets staleness: a tick
                # where any advert failed leaves the gauge climbing
                self._last_beat_at = time.monotonic()

    async def stop(self) -> None:
        # cancel BEFORE tombstoning: no tick may resurrect a record
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None
        for advert in self._adverts:
            try:
                await self._writers[advert.topic].tombstone(advert.key)
            except Exception:  # noqa: BLE001
                logger.warning("tombstone failed for %s", advert.key, exc_info=True)
        # a DELIBERATELY stopped publisher must read as 0 staleness, not
        # climb forever: the publisher object may stay referenced (the
        # control plane holds it), so the weakref alone doesn't cover this
        self._last_beat_at = None
