"""The key-ordered dispatcher — the framework's concurrency model.

Invariants (reference: calfkit/_faststream_ext/_subscriber.py:102-350):

- N lanes; a record's lane is ``crc32(key) % N`` → strictly serial per key,
  parallel across keys.  Combined with task-keyed publishing this yields the
  single-writer-per-run property (see :mod:`calfkit_tpu_torch.keying`).
- ONE global semaphore with bound ``2 × N`` is the sole backpressure:
  ``submit()`` blocks when 2N records are in flight, which stalls the
  consumer pull loop (broker-side flow control takes over from there).
- ACK-first: the caller acks/commits *before* ``submit()`` — crash-abandoned
  in-flight records are documented at-most-once.
- Graceful drain: ``stop()`` stops intake, then acquires every permit, which
  can only succeed once all in-flight handlers have finished.
- A permit-accounting bug must be loud, not a slow leak: releasing beyond the
  bound raises (the semaphore tripwire, reference :336-350).
- Keyless records are legal but warn once per dispatcher and serialize on
  lane 0 (they have no ordering contract to honor).
"""

from __future__ import annotations

from calfkit_tpu_torch.effects import hotpath

import asyncio
import logging
import threading
import time
import weakref
from typing import Awaitable, Callable

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.fleet import selection
from calfkit_tpu_torch.mesh.transport import Record
from calfkit_tpu_torch.observability.metrics import REGISTRY
from calfkit_tpu_torch.observability.trace import TRACER, TraceContext

logger = logging.getLogger(__name__)

# lane telemetry: how long records sit queued behind their key's lane
# (the "where did the time go" gap between publish and handler start).
# Buckets span sub-ms (healthy lanes) through tens of seconds (a stalled
# lane is exactly what this metric exists to expose — capping at 1 s
# would hide the pathology in +Inf)
_LANE_WAIT_BUCKETS_MS = (
    0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
    1000.0, 5000.0, 10000.0, 30000.0,
)
_QUEUE_WAIT = REGISTRY.histogram(
    "calfkit_dispatch_queue_wait_ms",
    "time a record spent queued in its key-ordered lane (ms)",
    buckets=_LANE_WAIT_BUCKETS_MS,
)
_RECORDS = REGISTRY.counter(
    "calfkit_dispatch_records_total", "records dispatched through lanes"
)

# saturation signals: the queue-wait histogram only
# shows trouble AFTER records have waited — depth and in-flight gauges
# show the build-up while it happens.  Our exposition has no labels, so
# per-lane depth is surfaced as (total, deepest-single-lane): the max
# gauge is exactly the "one stalled key serializes its lane" pathology a
# per-lane breakdown exists to catch.  Values aggregate across every live
# dispatcher in the process (one per node), mirroring the engine's
# active-request gauge: last-writer-wins would let an idle node's
# dispatcher zero out a saturated one.
_QUEUE_DEPTH = REGISTRY.gauge(
    "calfkit_dispatch_queue_depth",
    "records queued in key-ordered lanes (summed over lanes + dispatchers)",
)
_LANE_DEPTH_MAX = REGISTRY.gauge(
    "calfkit_dispatch_lane_depth_max",
    "deepest single key-ordered lane across the process's dispatchers",
)
_IN_FLIGHT = REGISTRY.gauge(
    "calfkit_dispatch_records_in_flight",
    "records submitted but not yet finished (queued + in handlers)",
)
_DEPTH_LOCK = threading.Lock()
_DEPTH_BY_DISPATCHER: "dict[int, tuple[int, int, int]]" = {}


@hotpath
def _publish_depth(key: int, total: int, deepest: int, in_flight: int) -> None:
    with _DEPTH_LOCK:
        _DEPTH_BY_DISPATCHER[key] = (total, deepest, in_flight)
        totals = _DEPTH_BY_DISPATCHER.values()
        depth = sum(t for t, _, _ in totals)
        max_lane = max((d for _, d, _ in totals), default=0)
        flight = sum(f for _, _, f in totals)
    _QUEUE_DEPTH.set(depth)
    _LANE_DEPTH_MAX.set(max_lane)
    _IN_FLIGHT.set(flight)


def _drop_depth(key: int) -> None:
    """Remove a stopped/abandoned dispatcher from the aggregation and
    re-set the gauges, so its final counts never pin the exposition."""
    with _DEPTH_LOCK:
        if _DEPTH_BY_DISPATCHER.pop(key, None) is None:
            return
        totals = _DEPTH_BY_DISPATCHER.values()
        depth = sum(t for t, _, _ in totals)
        max_lane = max((d for _, d, _ in totals), default=0)
        flight = sum(f for _, _, f in totals)
    _QUEUE_DEPTH.set(depth)
    _LANE_DEPTH_MAX.set(max_lane)
    _IN_FLIGHT.set(flight)


class _LaneTask(asyncio.Task):
    """A lane worker task that records cancel() requests.

    ``Task.cancelling()`` is 3.11+; on the image's 3.10 a lane cannot
    otherwise distinguish "this task was cancelled" (stop(), asyncio.run
    teardown, an enclosing scope — must terminate) from "the handler
    raised CancelledError itself" (a fault the lane must survive).  The
    flag emulates exactly the cancelling() signal: set by ANY cancel()
    delivery, regardless of who called it."""

    _cancel_requested = False

    def cancel(self, msg: "str | None" = None) -> bool:
        self._cancel_requested = True
        return super().cancel(msg)


def _task_cancel_requested(task: "asyncio.Task | None") -> bool:
    if task is None:
        return False
    if getattr(task, "_cancel_requested", False):
        return True
    cancelling = getattr(task, "cancelling", None)  # 3.11+ native signal
    return cancelling is not None and bool(cancelling())


class _TripwireSemaphore(asyncio.Semaphore):
    """A semaphore whose value may never exceed its initial bound."""

    def __init__(self, value: int):
        super().__init__(value)
        self._bound = value

    def release(self) -> None:
        if self._value >= self._bound:
            raise RuntimeError(
                "key-ordered dispatcher permit over-release: accounting bug"
            )
        super().release()


class KeyOrderedDispatcher:
    def __init__(
        self,
        handler: Callable[[Record], Awaitable[None]],
        *,
        max_workers: int = 8,
        name: str = "dispatcher",
    ):
        if max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        self._handler = handler
        self._lanes = max_workers
        self._name = name
        # queue items are (record, enqueue perf_counter) for queue-wait
        # attribution; None is the drain sentinel
        self._queues: list[asyncio.Queue[tuple[Record, float] | None]] = [
            # unbounded-ok: total queued records across all lanes are
            # bounded by the 2*max_workers permit semaphore submit()
            # acquires before enqueueing — a maxsize would deadlock the
            # permit holder
            asyncio.Queue() for _ in range(max_workers)
        ]
        self._permits = _TripwireSemaphore(2 * max_workers)
        self._workers: list[asyncio.Task[None]] = []
        self._started = False
        self._stopping = False
        self._warned_keyless = False
        # a dispatcher abandoned without stop() must not pin its last
        # depth/in-flight counts into the process gauges
        weakref.finalize(self, _drop_depth, id(self))

    @hotpath
    def _update_depth_gauges(self) -> None:
        """Recompute this dispatcher's saturation signals (O(lanes)) and
        fold them into the process gauges.  Called per submit and per lane
        dequeue/finish — the gauges track the live build-up, not a poll."""
        depths = [q.qsize() for q in self._queues]
        _publish_depth(
            id(self),
            sum(depths),
            max(depths, default=0),
            2 * self._lanes - self._permits._value,
        )

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        loop = asyncio.get_running_loop()
        self._workers = [
            _LaneTask(
                self._serve_lane(i), loop=loop, name=f"{self._name}-lane-{i}"
            )
            for i in range(self._lanes)
        ]

    async def stop(self, *, drain_timeout: float = 5.0) -> None:
        """Stop intake and drain; wedged handlers are cancelled after
        ``drain_timeout`` so shutdown always terminates."""
        self._stopping = True
        drained = True

        async def acquire_all() -> None:
            # owning every permit proves no handler is still running
            for _ in range(2 * self._lanes):
                await self._permits.acquire()

        try:
            # wait_for, not asyncio.timeout: the image runs 3.10, where
            # asyncio.timeout does not exist (stop() used to raise
            # AttributeError here and rely on callers suppressing it)
            await asyncio.wait_for(acquire_all(), drain_timeout)
        except (TimeoutError, asyncio.TimeoutError):
            drained = False
            logger.warning(
                "[%s] graceful drain timed out after %.1fs; cancelling in-flight handlers",
                self._name,
                drain_timeout,
            )
        for q in self._queues:
            q.put_nowait(None)
        # swap-then-iterate (meshlint await-atomicity): detach before the
        # awaits — _stopping is already set, so no new lane task can spawn
        # into a snapshot we already walked
        workers, self._workers = self._workers, []
        if not drained:
            for w in workers:
                w.cancel()
        for w in workers:
            try:
                await asyncio.wait_for(w, timeout=1)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                w.cancel()
        self._started = False
        _drop_depth(id(self))

    # -------------------------------------------------------------- intake
    @hotpath
    def lane_of(self, key: bytes | None) -> int:
        # the lane law lives in the fleet selection seam so
        # lane assignment and replica placement share one set of
        # primitives; semantics unchanged (crc32, keyless -> lane 0)
        return selection.lane_of(key, self._lanes)

    async def submit(self, record: Record) -> None:
        """Enqueue for ordered dispatch; blocks at the 2N in-flight bound."""
        if not self._started:
            raise RuntimeError("dispatcher not started")
        if self._stopping:
            return
        if (record.headers or {}).get(protocol.HDR_KIND) == "cancel":
            # control-record preemption: a `cancel` rides the
            # same task key as the call it abandons, so the ordered lane
            # would queue it BEHIND that very call — undeliverable until
            # the work it exists to stop has finished.  Cancels are
            # advisory, body-less and idempotent: handle inline on the
            # pull task, skipping lanes and permits.  Fail-open.
            try:
                await self._handler(record)
            except Exception:  # noqa: BLE001 - advisory, never stalls intake
                logger.exception(
                    "[%s] cancel-record handler failed on %s",
                    self._name, record.topic,
                )
            return
        if record.key is None and not self._warned_keyless:
            self._warned_keyless = True
            logger.warning(
                "[%s] keyless record on %s: no ordering contract, using lane 0",
                self._name,
                record.topic,
            )
        await self._permits.acquire()
        self._queues[self.lane_of(record.key)].put_nowait(
            (record, time.perf_counter())
        )
        self._update_depth_gauges()

    # -------------------------------------------------------------- lanes
    async def _serve_lane(self, lane: int) -> None:
        queue = self._queues[lane]
        while True:
            item = await queue.get()
            if item is None:
                return
            record, enqueued = item
            wait_ms = (time.perf_counter() - enqueued) * 1000.0
            _QUEUE_WAIT.observe(wait_ms)
            _RECORDS.inc()
            self._update_depth_gauges()  # dequeued: depth down, in-flight holds
            # traced records get a dispatch span (parent: the emitting
            # hop's span) covering HANDLER time, with the preceding lane
            # wait carried as the queue_wait_ms attr; untraced records
            # (heartbeats, control plane) pay only the two
            # histogram/counter calls above
            span = None
            remote = TraceContext.from_headers(record.headers)
            if remote is not None:
                span = TRACER.start_span(
                    "mesh.dispatch",
                    parent=remote,
                    kind="dispatch",
                    emitter=self._name,
                    attrs={
                        "topic": record.topic,
                        "lane": lane,
                        "queue_wait_ms": round(wait_ms, 3),
                    },
                )
            status = None
            try:
                await self._handler(record)
            except asyncio.CancelledError:
                # was OUR task cancelled (stop(), asyncio.run teardown, an
                # enclosing scope — terminate), or did the handler raise
                # CancelledError itself (a fault the lane must survive)?
                # _LaneTask records cancel() deliveries so this works on
                # 3.10 too, where Task.cancelling() does not exist.
                if _task_cancel_requested(asyncio.current_task()):
                    if span is not None:
                        span.end(status="cancelled")
                        span = None
                    raise
                status = "error"
                logger.exception(
                    "[%s] handler leaked CancelledError on %s (lane %d)",
                    self._name,
                    record.topic,
                    lane,
                )
            except BaseException:
                # the handler owns its fault rail; anything escaping it is a
                # floor-level bug — log loudly, never kill the lane
                status = "error"
                logger.exception(
                    "[%s] handler escaped its fault rail on %s (lane %d)",
                    self._name,
                    record.topic,
                    lane,
                )
            finally:
                if span is not None:
                    span.end(status=status)
                self._permits.release()
                self._update_depth_gauges()  # handler done: in-flight down
