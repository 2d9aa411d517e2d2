"""A full in-process mesh: the offline test substrate and the dev mesh.

Faithful to the Kafka semantics nodes rely on, in one process:

- topics have **partitions** (default 16); a record's partition is
  ``crc32(key) % P`` — so per-key ordering holds *across consumer-group
  members*, exactly as on a real broker;
- named consumer groups share partitions (round-robin assignment, recomputed
  on membership change = the rebalance analog);
- ``group_id=None`` subscribers are broadcast taps (own cursors, from latest
  by default);
- compacted table topics serve reader views with trivially-true catch-up and
  barrier (everything is local, read-your-own-writes holds by construction).

The reference leaned on FastStream's TestKafkaBroker for the offline lane and
a spawned Tansu binary for the dev mesh (SURVEY.md §4, §3.5); owning this
implementation removes both dependencies.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import zlib
from typing import Awaitable, Callable

from calfkit_tpu_torch.mesh.dispatch import KeyOrderedDispatcher
from calfkit_tpu_torch.mesh.tables import TableReader, TableWriter
from calfkit_tpu_torch.mesh.transport import (
    CallbackSubscription,
    MeshTransport,
    Record,
    RecordHandler,
    Subscription,
)

logger = logging.getLogger(__name__)

DEFAULT_PARTITIONS = 16


class _Topic:
    # past this per-partition length, unconsumed compacted topics are trimmed
    COMPACT_THRESHOLD = 512

    def __init__(self, name: str, partitions: int, compacted: bool):
        self.name = name
        self.compacted = compacted
        self.partitions: list[list[Record]] = [[] for _ in range(partitions)]
        self.changed = asyncio.Event()
        self.consumer_count = 0  # log-position consumers (pumps); gates trimming
        # compacted topics also maintain the folded view at publish time so
        # table reads are O(1) instead of re-folding the log; the version
        # counter bumps on every fold mutation (TableReader.version — the
        # fleet registry's O(1) no-change fast path reads it)
        self.table: dict[str, bytes] = {}
        self.table_version = 0
        # set by the mesh: remaps persisted group cursors after a log trim
        self.on_compact: Callable[["_Topic", int, list[Record], list[Record]], None] | None = None
        self._rr = itertools.count()
        self._offset = itertools.count()

    def partition_of(self, key: bytes | None) -> int:
        if key is None:
            return next(self._rr) % len(self.partitions)
        return zlib.crc32(key) % len(self.partitions)

    def append(self, key: bytes | None, value: bytes, headers: dict[str, str]) -> None:
        p = self.partition_of(key)
        record = Record(
            topic=self.name,
            key=key,
            value=value,
            headers=dict(headers),
            offset=next(self._offset),
        )
        self.partitions[p].append(record)
        if self.compacted and key is not None:
            k = key.decode("utf-8", errors="replace")
            self.table_version += 1
            if len(value) == 0:
                self.table.pop(k, None)  # tombstone
            else:
                self.table[k] = value
            # bound log growth (heartbeats rewrite the same keys forever);
            # only safe when no pump holds an index-based cursor on the log —
            # persisted group cursors are remapped via on_compact
            if self.consumer_count == 0 and len(self.partitions[p]) > self.COMPACT_THRESHOLD:
                old = self.partitions[p]
                latest: dict[bytes, Record] = {}
                for r in old:
                    if r.key is not None:
                        latest[r.key] = r
                kept = sorted(
                    (r for r in latest.values() if len(r.value) > 0),
                    key=lambda r: r.offset,
                )
                self.partitions[p] = kept
                if self.on_compact is not None:
                    self.on_compact(self, p, old, kept)
        self.changed.set()

    def ends(self) -> list[int]:
        return [len(p) for p in self.partitions]


class _Group:
    """Consumer-group state for one topic: shared cursors + assignment.

    ``locks[p]`` is the revocation barrier: a member holds the partition lock
    while pulling/delivering from it, so after a rebalance the new assignee
    cannot start until the old one's in-flight delivery completes — per-key
    ordering survives membership changes (a real broker achieves this with
    the rebalance protocol's revocation phase)."""

    def __init__(self, topic: _Topic):
        self.topic = topic
        self.cursors = [0] * len(topic.partitions)
        self.locks = [asyncio.Lock() for _ in topic.partitions]
        self.members: list["_GroupMember"] = []

    def rebalance(self) -> None:
        n = len(self.members)
        for i, member in enumerate(self.members):
            member.assigned = [p for p in range(len(self.topic.partitions)) if p % n == i]


class _GroupMember:
    def __init__(self) -> None:
        self.assigned: list[int] = []


class InMemoryMesh(MeshTransport):
    def __init__(
        self,
        *,
        partitions: int = DEFAULT_PARTITIONS,
        auto_create_topics: bool = True,
        max_message_bytes: int = 5 * 1024 * 1024,
    ):
        self._partitions = partitions
        self._auto_create = auto_create_topics
        self._max_bytes = max_message_bytes
        self._topics: dict[str, _Topic] = {}
        self._groups: dict[tuple[str, str], _Group] = {}  # (topic, group_id)
        self._pumps: list[asyncio.Task[None]] = []
        self._dispatchers: list[KeyOrderedDispatcher] = []
        self._started = False
        # chaos seam (tests/_chaos.py): a deterministic fault injector for
        # scripted broker-failure scenarios.  Called per publish with
        # (topic, headers); returning "drop" silently loses the record —
        # the broker-drop-during-return scenario.  None = transparent.
        self.chaos: "Callable[[str, dict[str, str]], str | None] | None" = None

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        self._started = True

    async def stop(self) -> None:
        self._started = False
        # swap-then-iterate (meshlint await-atomicity): detach before
        # the first await so a racing subscribe can't be silently dropped
        pumps, self._pumps = self._pumps, []
        for pump in pumps:
            pump.cancel()
        for pump in pumps:
            try:
                await pump
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        dispatchers, self._dispatchers = self._dispatchers, []
        for d in dispatchers:
            try:
                await d.stop()
            except Exception:  # noqa: BLE001
                logger.exception("dispatcher drain failed")

    @property
    def max_message_bytes(self) -> int:
        return self._max_bytes

    # ---------------------------------------------------------------- admin
    async def ensure_topics(self, names: list[str], *, compacted: bool = False) -> None:
        for name in names:
            self._topic(name, create=True, compacted=compacted)

    def _topic(self, name: str, *, create: bool | None = None, compacted: bool = False) -> _Topic:
        topic = self._topics.get(name)
        if topic is None:
            if not (create or (create is None and self._auto_create)):
                raise KeyError(f"unknown topic {name!r} (auto-create disabled)")
            topic = _Topic(name, self._partitions, compacted)
            topic.on_compact = self._remap_group_cursors
            self._topics[name] = topic
        elif compacted and not topic.compacted:
            # upgrade a topic auto-created by an early publish: backfill the
            # folded view from the log so table reads see prior records
            topic.compacted = True
            for record in sorted(
                (r for p in topic.partitions for r in p), key=lambda r: r.offset
            ):
                if record.key is None:
                    continue
                k = record.key.decode("utf-8", errors="replace")
                topic.table_version += 1
                if len(record.value) == 0:
                    topic.table.pop(k, None)
                else:
                    topic.table[k] = record.value
        return topic

    def topic_names(self) -> list[str]:
        return sorted(self._topics)

    def _remap_group_cursors(
        self, topic: _Topic, p: int, old: list[Record], kept: list[Record]
    ) -> None:
        """After a log trim, persisted cursors of (possibly stopped) groups
        index the OLD list; remap each to its position in the kept list so a
        returning group member resumes without skipping records."""
        for (topic_name, _gid), group in self._groups.items():
            if topic_name != topic.name:
                continue
            c = group.cursors[p]
            if c <= 0:
                continue
            boundary = old[c - 1].offset if c <= len(old) else old[-1].offset
            group.cursors[p] = sum(1 for r in kept if r.offset <= boundary)

    # -------------------------------------------------------------- produce
    async def publish(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        headers: dict[str, str] | None = None,
    ) -> None:
        if len(value) > self._max_bytes:
            raise ValueError(
                f"message of {len(value)} bytes exceeds max_message_bytes={self._max_bytes}"
            )
        if self.chaos is not None and self.chaos(topic, headers or {}) == "drop":
            # injected broker loss: the record never lands (scripted
            # scenarios assert the timeout/cancel story downstream)
            await asyncio.sleep(0)
            return
        t = self._topic(topic)
        t.append(key, value, headers or {})
        # yield so same-task publish->consume chains interleave like real I/O
        await asyncio.sleep(0)

    # -------------------------------------------------------------- consume
    async def subscribe(
        self,
        topics: list[str],
        handler: RecordHandler,
        *,
        group_id: str | None,
        from_latest: bool | None = None,
        max_workers: int = 8,
        ordered: bool = True,
    ) -> Subscription:
        if not self._started:
            raise RuntimeError("mesh not started")
        if from_latest is None:
            from_latest = group_id is None  # taps from latest, groups from earliest

        deliver = handler
        dispatcher: KeyOrderedDispatcher | None = None
        if ordered:
            dispatcher = KeyOrderedDispatcher(
                handler, max_workers=max_workers, name=f"sub-{group_id or 'tap'}"
            )
            dispatcher.start()
            self._dispatchers.append(dispatcher)

            async def deliver(record: Record) -> None:  # type: ignore[misc]
                await dispatcher.submit(record)

        tasks: list[asyncio.Task[None]] = []
        members: list[tuple[_Group, _GroupMember]] = []
        attached: list[_Topic] = []
        for name in topics:
            topic = self._topic(name, create=True)
            topic.consumer_count += 1
            attached.append(topic)
            if group_id is None:
                cursors = [len(p) if from_latest else 0 for p in topic.partitions]
                tasks.append(
                    asyncio.get_running_loop().create_task(
                        self._pump_broadcast(topic, cursors, deliver),
                        name=f"pump-tap-{name}",
                    )
                )
            else:
                group = self._groups.setdefault((name, group_id), _Group(topic))
                member = _GroupMember()
                group.members.append(member)
                group.rebalance()
                if from_latest and len(group.members) == 1:
                    group.cursors = [len(p) for p in topic.partitions]
                members.append((group, member))
                tasks.append(
                    asyncio.get_running_loop().create_task(
                        self._pump_group(group, member, deliver),
                        name=f"pump-{group_id}-{name}",
                    )
                )
        self._pumps.extend(tasks)

        async def stop_fn() -> None:
            for topic in attached:
                topic.consumer_count -= 1
            for group, member in members:
                if member in group.members:
                    group.members.remove(member)
                    if group.members:
                        group.rebalance()
            for task in tasks:
                task.cancel()
            for task in tasks:
                try:
                    await task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
            if dispatcher is not None:
                await dispatcher.stop()
                if dispatcher in self._dispatchers:
                    self._dispatchers.remove(dispatcher)

        return CallbackSubscription(stop_fn)

    async def _pump_broadcast(
        self,
        topic: _Topic,
        cursors: list[int],
        deliver: RecordHandler,
    ) -> None:
        while True:
            progressed = False
            for p, partition in enumerate(topic.partitions):
                while cursors[p] < len(partition):
                    record = partition[cursors[p]]
                    cursors[p] += 1
                    progressed = True
                    try:
                        await deliver(record)
                    except Exception:  # noqa: BLE001
                        logger.exception("broadcast tap handler failed on %s", topic.name)
            if not progressed:
                topic.changed.clear()
                # re-check before parking: a publish may have landed between
                # the scan and the clear (missed-wakeup race)
                if any(
                    cursors[p] < len(part) for p, part in enumerate(topic.partitions)
                ):
                    continue
                await topic.changed.wait()

    async def _pump_group(
        self,
        group: _Group,
        member: _GroupMember,
        deliver: RecordHandler,
    ) -> None:
        topic = group.topic
        while True:
            progressed = False
            for p in list(member.assigned):
                if group.locks[p].locked():
                    continue  # previous assignee mid-delivery; revisit next pass
                async with group.locks[p]:
                    while p in member.assigned and group.cursors[p] < len(topic.partitions[p]):
                        record = topic.partitions[p][group.cursors[p]]
                        # ACK-first: advance the cursor (the commit) before handling
                        group.cursors[p] += 1
                        progressed = True
                        try:
                            await deliver(record)
                        except Exception:  # noqa: BLE001
                            logger.exception(
                                "group delivery failed on %s[%d]", topic.name, p
                            )
            if not progressed:
                topic.changed.clear()
                if any(
                    p in member.assigned and group.cursors[p] < len(topic.partitions[p])
                    for p in range(len(topic.partitions))
                ):
                    continue
                try:
                    await asyncio.wait_for(topic.changed.wait(), timeout=0.2)
                except asyncio.TimeoutError:
                    pass  # re-check assignment after rebalances

    # --------------------------------------------------------------- tables
    def table_reader(self, topic: str) -> TableReader:
        return _MemoryTableReader(self, topic)

    def table_writer(self, topic: str) -> TableWriter:
        return _MemoryTableWriter(self, topic)


class _MemoryTableReader(TableReader):
    """A view over a local topic: always caught up, barrier is a yield."""

    def __init__(self, mesh: InMemoryMesh, topic: str):
        self._mesh = mesh
        self._topic_name = topic
        self._started = False

    async def start(self, *, timeout: float = 30.0) -> None:
        self._mesh._topic(self._topic_name, create=True, compacted=True)
        self._started = True

    async def stop(self) -> None:
        self._started = False

    async def barrier(self, *, timeout: float = 30.0) -> None:
        await asyncio.sleep(0)

    def _view(self) -> dict[str, bytes]:
        # the topic maintains its folded view at publish time (O(1) reads)
        return self._mesh._topic(self._topic_name, create=True, compacted=True).table

    def get(self, key: str) -> bytes | None:
        return self._view().get(key)

    def items(self) -> dict[str, bytes]:
        return dict(self._view())

    @property
    def is_caught_up(self) -> bool:
        return self._started

    @property
    def version(self) -> "int | None":
        # the topic folds at publish time, so its mutation counter IS the
        # view version (reads are always caught up on the local mesh)
        return self._mesh._topic(
            self._topic_name, create=True, compacted=True
        ).table_version


class _MemoryTableWriter(TableWriter):
    def __init__(self, mesh: InMemoryMesh, topic: str):
        self._mesh = mesh
        self._topic = topic

    async def put(self, key: str, value: bytes) -> None:
        await self._mesh.publish(self._topic, value, key=key.encode("utf-8"))

    async def tombstone(self, key: str) -> None:
        await self._mesh.publish(self._topic, b"", key=key.encode("utf-8"))
