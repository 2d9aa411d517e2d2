"""The process-death / partition seam: one replica's I/O boundary.

:class:`ReplicaTransport` wraps a shared mesh transport per replica so scenarios can script the
two failure geometries fleets actually see:

- **death** — ``kill()`` with no ``resume()``: publishes vanish, the
  heartbeat stamp freezes on the table (no tombstone — that would be a
  clean shutdown), deliveries buffer like a dead consumer's partition
  backlog, and in-flight compute keeps burning (the zombie the
  cancel-tombstone law exists for);
- **partition + heal** — ``kill()`` then ``resume()``: the SAME seam.
  A partitioned replica is indistinguishable from a dead one to the
  rest of the fleet (that is the whole point of failure detectors);
  ``resume()`` is the heal — buffered deliveries replay with cancel
  records FIRST (mirroring the dispatcher's express intake, where a
  cancel skips the ordered lanes), publishes flow again, and the next
  heartbeat re-stamps the advert fresh.
"""

from __future__ import annotations

from typing import Any

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.mesh.tables import TableReader, TableWriter
from calfkit_tpu_torch.mesh.transport import MeshTransport

__all__ = ["ReplicaTransport"]


class _GatedTableWriter(TableWriter):
    """A dead replica's heartbeat puts/tombstones never reach the table —
    its last stamp stays frozen there, exactly what a killed process
    leaves behind (no tombstone: that would be a CLEAN shutdown)."""

    def __init__(self, owner: "ReplicaTransport", inner: TableWriter):
        self._owner = owner
        self._inner = inner

    async def put(self, key: str, value: bytes) -> None:
        if self._owner.dead:
            self._owner.dropped.append(("<table-put>", key))
            return
        await self._inner.put(key, value)

    async def tombstone(self, key: str) -> None:
        if self._owner.dead:
            self._owner.dropped.append(("<table-tombstone>", key))
            return
        await self._inner.tombstone(key)


class _DeliveryGate:
    """The consumption half of a process death: while dead, deliveries
    buffer (the dead process's partition backlog) instead of reaching
    the node handler; ``replay()`` on resume drains the backlog with
    cancel records FIRST — mirroring the dispatcher's express intake,
    where a cancel skips the ordered lanes and therefore lands before
    the queued work it abandons gets to execute."""

    def __init__(self, owner: "ReplicaTransport", inner: Any):
        self._owner = owner
        self._inner = inner
        self.buffered: list[Any] = []

    async def __call__(self, record: Any) -> None:
        if self._owner.dead:
            self.buffered.append(record)
            return
        await self._inner(record)

    async def replay(self) -> None:
        backlog, self.buffered = self.buffered, []
        cancels = [
            r for r in backlog
            if r.headers.get(protocol.HDR_KIND) == "cancel"
        ]
        rest = [
            r for r in backlog
            if r.headers.get(protocol.HDR_KIND) != "cancel"
        ]
        for record in cancels + rest:
            await self._inner(record)


class ReplicaTransport(MeshTransport):
    """One replica's I/O boundary over the (shared) mesh — the
    process-death seam, doubling as the partition seam
    (see module docstring).

    ``kill()`` models a hard kill OR a network partition: NOTHING the
    replica publishes reaches the mesh (heartbeats stop landing with the
    last stamp frozen on the table, a half-delivered stream just stops,
    terminal replies vanish) and nothing is consumed (deliveries buffer
    like the dead consumer's backlog).  Compute the replica had in
    flight keeps burning — exactly the zombie the cancel-tombstone law
    exists for.  ``resume()`` models that zombie coming back (the heal):
    publishes flow again, the backlog replays (cancels first, per the
    dispatcher's express law), and the next heartbeat re-stamps the
    advert."""

    def __init__(self, inner: MeshTransport):
        self.inner = inner
        self.dead = False
        self.dropped: list[tuple[str, str]] = []  # publishes lost while dead
        self._gates: list[_DeliveryGate] = []

    def kill(self) -> None:
        self.dead = True

    async def resume(self) -> None:
        self.dead = False
        for gate in self._gates:
            await gate.replay()

    # ------------------------------------------------------- transport
    async def start(self) -> None:
        await self.inner.start()

    async def stop(self) -> None:
        await self.inner.stop()

    @property
    def max_message_bytes(self) -> int:
        return self.inner.max_message_bytes

    async def publish(
        self,
        topic: str,
        value: bytes,
        *,
        key: "bytes | None" = None,
        headers: "dict[str, str] | None" = None,
    ) -> None:
        if self.dead:
            self.dropped.append(
                (topic, (headers or {}).get(protocol.HDR_KIND, ""))
            )
            return
        await self.inner.publish(topic, value, key=key, headers=headers)

    async def subscribe(self, topics: Any, handler: Any, **kwargs: Any) -> Any:
        gate = _DeliveryGate(self, handler)
        self._gates.append(gate)
        return await self.inner.subscribe(topics, gate, **kwargs)

    async def ensure_topics(
        self, names: Any, *, compacted: bool = False
    ) -> None:
        await self.inner.ensure_topics(names, compacted=compacted)

    def table_reader(self, topic: str) -> TableReader:
        return self.inner.table_reader(topic)

    def table_writer(self, topic: str) -> TableWriter:
        return _GatedTableWriter(self, self.inner.table_writer(topic))
