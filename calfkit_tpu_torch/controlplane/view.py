"""Typed read views over control-plane tables.

A view collapses instance-keyed records (``<name>@<instance>``) to ONE live
record per node name: freshest heartbeat wins, stale instances
(``now - heartbeat_at ≥ stale_after``) and foreign schema versions are
filtered out (reference: calfkit/controlplane/view.py:67-195 — including the
surfaced health: ``status``/``failure``/``is_caught_up``).
"""

from __future__ import annotations

import logging
from typing import Generic, Type, TypeVar

from calfkit_tpu_torch import cancellation
from calfkit_tpu_torch.mesh.transport import MeshTransport
from calfkit_tpu_torch.models._wire import ValidationError, Wire
from calfkit_tpu_torch.models.records import SCHEMA_VERSION, ControlPlaneRecord

logger = logging.getLogger(__name__)

RecordT = TypeVar("RecordT", bound=Wire)


class ControlPlaneView(Generic[RecordT]):
    def __init__(
        self,
        transport: MeshTransport,
        topic: str,
        record_type: Type[RecordT],
        *,
        stale_after: float = 15.0,
        catchup_timeout: float = 30.0,
    ):
        self._reader = transport.table_reader(topic)
        self._topic = topic
        self._record_type = record_type
        self._stale_after = stale_after
        self._catchup_timeout = catchup_timeout
        self._status = "new"  # new -> catching_up -> live | failed
        self._failure: str | None = None

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        self._status = "catching_up"
        try:
            await self._reader.start(timeout=self._catchup_timeout)
        except Exception as exc:  # noqa: BLE001
            self._status = "failed"
            self._failure = f"catch-up failed: {exc}"
            raise
        self._status = "live"

    async def stop(self) -> None:
        await self._reader.stop()
        self._status = "new"

    # -------------------------------------------------------------- health
    @property
    def status(self) -> str:
        return self._status

    @property
    def failure(self) -> str | None:
        return self._failure

    @property
    def is_caught_up(self) -> bool:
        return self._status == "live" and self._reader.is_caught_up

    # --------------------------------------------------------------- reads
    def _live_members(self) -> dict[str, ControlPlaneRecord]:
        """name -> freshest live instance record."""
        # same clock seam the publisher stamps with (chaos-patchable)
        now = cancellation.wall_clock()
        best: dict[str, ControlPlaneRecord] = {}
        for key, raw in self._reader.items().items():
            try:
                record = ControlPlaneRecord.from_wire(raw)
            except (ValidationError, ValueError):
                logger.debug("undecodable control-plane record %s", key)
                continue
            if record.schema_version != SCHEMA_VERSION:
                continue
            if now - record.stamp.heartbeat_at >= self._stale_after:
                continue
            name = record.stamp.node_name
            incumbent = best.get(name)
            if (
                incumbent is None
                or record.stamp.heartbeat_at > incumbent.stamp.heartbeat_at
            ):
                best[name] = record
        return best

    def records(self) -> list[RecordT]:
        """One typed payload per live node."""
        out: list[RecordT] = []
        for record in self._live_members().values():
            try:
                out.append(self._record_type.model_validate(record.record))
            except ValidationError:
                logger.debug(
                    "control-plane payload failed %s validation",
                    self._record_type.__name__,
                )
        return out

    async def barrier(self) -> None:
        await self._reader.barrier()
