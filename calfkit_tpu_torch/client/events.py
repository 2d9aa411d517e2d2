"""The client firehose: every step event from every run this client observes.

Bounded drop-oldest per observer with a ``dropped`` counter (reference:
calfkit/client/events.py:26-157).
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import AsyncIterator, Callable

from calfkit_tpu_torch.models.step import StepEvent

DEFAULT_BUFFER = 1024

_CLOSED = object()  # queue sentinel: wakes consumers parked on get()


class EventStream:
    def __init__(
        self,
        *,
        buffer: int = DEFAULT_BUFFER,
        on_close: Callable[["EventStream"], None] | None = None,
    ):
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=buffer + 1)
        self.dropped = 0
        self._closed = False
        self._on_close = on_close

    def push(self, event: StepEvent) -> None:
        if self._closed:
            return
        try:
            self._queue.put_nowait(event)
        except asyncio.QueueFull:
            self.dropped += 1
            with contextlib.suppress(asyncio.QueueEmpty, asyncio.QueueFull):
                self._queue.get_nowait()
                self._queue.put_nowait(event)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._on_close is not None:
            self._on_close(self)
        with contextlib.suppress(asyncio.QueueFull):
            self._queue.put_nowait(_CLOSED)  # wake any parked consumer

    def __aiter__(self) -> AsyncIterator[StepEvent]:
        return self

    async def __anext__(self) -> StepEvent:
        if self._closed and self._queue.empty():
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is _CLOSED:
            raise StopAsyncIteration
        return item
