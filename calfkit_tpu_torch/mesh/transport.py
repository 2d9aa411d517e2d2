"""The transport interface every mesh implementation provides.

Semantics contract (what nodes/clients may rely on, independent of backend):

- **At-least-once under redelivery, at-most-once under crash**: commits are
  ACK-first (cadence independent of handler completion), so records
  abandoned in flight by a crashed consumer are not redelivered — the
  reference's documented stance (_faststream_ext/_subscriber.py:214-221).
  Durable state (fan-out batches) makes workflows survive crashes anyway.
- Per-key ordering within a topic (keys map to partitions; one partition is
  consumed serially per group).
- ``group_id=None`` subscriptions are *broadcast taps from latest*: every
  such subscriber sees every record published after it attached (the client
  inbox / firehose pattern).
- Named-group subscriptions share work: each record goes to exactly one live
  member of the group (horizontal scaling — the reference's DP analog,
  SURVEY.md §2.4).
- Compacted-table topics retain the latest value per key; ``None`` value is
  a tombstone.
"""

from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from calfkit_tpu_torch.mesh.tables import TableReader, TableWriter


@dataclass(frozen=True)
class Record:
    """One consumed record."""

    topic: str
    value: bytes
    key: bytes | None = None
    headers: dict[str, str] = field(default_factory=dict)
    offset: int = 0
    timestamp: float = field(default_factory=time.time)


RecordHandler = Callable[[Record], Awaitable[None]]


class Subscription(abc.ABC):
    """A live subscription; ``stop()`` drains in-flight handlers."""

    @abc.abstractmethod
    async def stop(self) -> None: ...


class CallbackSubscription(Subscription):
    """The standard stop_fn-wrapping subscription every transport uses."""

    def __init__(self, stop_fn: Callable[[], Awaitable[None]]):
        self._stop_fn = stop_fn
        self._stopped = False

    async def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        await self._stop_fn()


class MeshTransport(abc.ABC):
    @abc.abstractmethod
    async def start(self) -> None: ...

    @abc.abstractmethod
    async def stop(self) -> None: ...

    @abc.abstractmethod
    async def publish(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        headers: dict[str, str] | None = None,
    ) -> None: ...

    @abc.abstractmethod
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
        """Attach a consumer.

        ``ordered=True`` routes records through a key-ordered dispatcher
        (parallel across keys, serial per key, bounded in-flight);
        ``ordered=False`` runs the handler serially in subscription order
        (broadcast taps).

        ``from_latest=None`` (default) resolves per the contract: broadcast
        taps (``group_id=None``) start from latest, named groups from
        earliest uncommitted.
        """

    @abc.abstractmethod
    async def ensure_topics(
        self, names: list[str], *, compacted: bool = False
    ) -> None: ...

    @abc.abstractmethod
    def table_reader(self, topic: str) -> TableReader: ...

    @abc.abstractmethod
    def table_writer(self, topic: str) -> TableWriter: ...

    # ------------------------------------------------------------------ misc
    @property
    def max_message_bytes(self) -> int:
        """Producer guard / consumer fetch floor (reference default 5 MiB,
        calfkit/client/_connection.py:31)."""
        return 5 * 1024 * 1024
