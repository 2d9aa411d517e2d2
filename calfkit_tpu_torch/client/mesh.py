"""client.mesh — the read-only mesh directory.

Reference: calfkit/client/mesh.py:241-354.  Per-kind views are created
lazily, started once (single-flight), and surface typed
:class:`MeshUnavailableError` with a reason instead of hanging when the
control plane can't be read.
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import TYPE_CHECKING

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.controlplane.view import ControlPlaneView
from calfkit_tpu_torch.exceptions import MeshUnavailableError
from calfkit_tpu_torch.models.agents import AgentCard
from calfkit_tpu_torch.models.capability import CapabilityRecord
from calfkit_tpu_torch.models.records import EngineStatsRecord

if TYPE_CHECKING:
    from calfkit_tpu_torch.client.caller import Client


class Mesh:
    def __init__(self, client: "Client", *, catchup_timeout: float = 30.0):
        self._client = client
        self._catchup_timeout = catchup_timeout
        self._views: dict[str, ControlPlaneView] = {}
        self._locks: dict[str, asyncio.Lock] = {}

    async def _view(self, kind: str) -> ControlPlaneView:
        view = self._views.get(kind)
        if view is not None and view.is_caught_up:
            return view
        lock = self._locks.setdefault(kind, asyncio.Lock())
        async with lock:  # single-flight per kind
            view = self._views.get(kind)
            if view is not None and view.is_caught_up:
                return view
            if view is not None:
                # lagging/failed view: stop it before replacing (a replaced
                # reader would otherwise consume forever)
                self._views.pop(kind, None)
                try:
                    await view.stop()
                except Exception:  # noqa: BLE001
                    pass
            await self._client._ensure_started()
            topic, record_type = {
                "agents": (protocol.AGENTS_TOPIC, AgentCard),
                "capabilities": (protocol.CAPABILITIES_TOPIC, CapabilityRecord),
                "engine_stats": (
                    protocol.ENGINE_STATS_TOPIC, EngineStatsRecord
                ),
            }[kind]
            view = ControlPlaneView(
                self._client.mesh,
                topic,
                record_type,
                catchup_timeout=self._catchup_timeout,
            )
            try:
                await view.start()
            except Exception as exc:  # noqa: BLE001
                with contextlib.suppress(Exception):
                    await view.stop()  # failed start must not leak a reader
                raise MeshUnavailableError(
                    f"mesh {kind} directory unavailable: {exc}",
                    reason="catchup-failed",
                ) from exc
            self._views[kind] = view
            return view

    async def get_agents(self) -> list[AgentCard]:
        return (await self._view("agents")).records()

    async def get_capabilities(self) -> list[CapabilityRecord]:
        return (await self._view("capabilities")).records()

    async def get_engine_stats(self) -> "list[EngineStatsRecord]":
        """Live serving metrics from every worker whose agents run a local
        inference engine (tok/s, occupancy, free slots/pages)."""
        return (await self._view("engine_stats")).records()

    async def get_agent(self, name: str) -> AgentCard:
        for card in await self.get_agents():
            if card.name == name:
                return card
        raise MeshUnavailableError(
            f"no live agent named {name!r}", reason="not-found"
        )

    async def close(self) -> None:
        for view in self._views.values():
            await view.stop()
        self._views.clear()
