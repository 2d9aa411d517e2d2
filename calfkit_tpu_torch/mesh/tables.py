"""Compacted-table readers/writers — the slim ktables equivalent.

A *table topic* is a compacted topic read as a key→value map.  Readers expose
a **catch-up gate** (``start()`` returns only once the view has consumed to
the end-of-topic as of attach time) and a **barrier** (``await barrier()``
guarantees the view reflects every record published before the call) — the
read-your-own-writes primitive the durable fan-out store depends on
(reference: ktables usage at calfkit/nodes/_fanout_store.py:258-337 and
controlplane/view.py catch-up gates).
"""

from __future__ import annotations

import abc


class TableReader(abc.ABC):
    @abc.abstractmethod
    async def start(self, *, timeout: float = 30.0) -> None:
        """Attach and catch up; raises ``TimeoutError`` if the gate fails."""

    @abc.abstractmethod
    async def stop(self) -> None: ...

    @abc.abstractmethod
    async def barrier(self, *, timeout: float = 30.0) -> None:
        """Block until the view reflects all records published before now."""

    @abc.abstractmethod
    def get(self, key: str) -> bytes | None: ...

    @abc.abstractmethod
    def items(self) -> dict[str, bytes]:
        """Snapshot of the compacted view (tombstoned keys absent)."""

    @property
    @abc.abstractmethod
    def is_caught_up(self) -> bool: ...

    @property
    def version(self) -> "int | None":
        """Monotonic view-mutation counter: bumps at least once whenever
        the folded view changes (put, tombstone, rebuild swap), never
        otherwise.  Lets per-call readers (the fleet registry's parsed-
        replica cache) make the no-change case a single int
        compare instead of re-scanning the table's bytes.  ``None`` (the
        default, for third-party readers) means "no counter — fall back
        to content fingerprinting"; all in-repo transports implement it.
        """
        return None


class TableWriter(abc.ABC):
    @abc.abstractmethod
    async def put(self, key: str, value: bytes) -> None:
        """Publish and wait for the broker ack."""

    @abc.abstractmethod
    async def tombstone(self, key: str) -> None: ...
