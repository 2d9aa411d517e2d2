"""The client hub: one groupless inbox subscriber demuxing replies and steps
by correlation id into weakly-held run channels.

Reference: calfkit/client/hub.py:89-426.  Invariants preserved:

- a handle is registered BEFORE the call publishes (race-free: the reply
  cannot beat the registration);
- channels are weakly held — an abandoned handle stops consuming memory;
- cancel-safe: ``result()``/``stream()`` can be cancelled without corrupting
  the channel; a late reply to a dead handle goes to the firehose only.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import weakref
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Generic, TypeVar

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.exceptions import ClientTimeoutError, NodeFaultError
from calfkit_tpu_torch.mesh.transport import Record
from calfkit_tpu_torch.models.error_report import ErrorReport, FaultTypes
from calfkit_tpu_torch.models.node_result import InvocationResult
from calfkit_tpu_torch.models.reply import FaultMessage, ReturnMessage
from calfkit_tpu_torch.models.session_context import Envelope
from calfkit_tpu_torch.models.step import StepEvent, StepMessage

logger = logging.getLogger(__name__)

OutputT = TypeVar("OutputT")


@dataclass
class RunCompleted:
    envelope: Envelope
    headers: dict[str, str]


@dataclass
class RunFailed:
    report: ErrorReport
    envelope: Envelope | None = None


Terminal = RunCompleted | RunFailed


@dataclass
class _RunChannel:
    correlation_id: str
    task_id: str
    steps: asyncio.Queue[StepEvent] = field(
        default_factory=lambda: asyncio.Queue(maxsize=1024)
    )
    terminal: asyncio.Future[Terminal] = field(
        default_factory=lambda: asyncio.get_running_loop().create_future()
    )

    def push_step(self, event: StepEvent) -> None:
        try:
            self.steps.put_nowait(event)
        except asyncio.QueueFull:
            # drop-oldest: the terminal result matters more than telemetry
            with contextlib.suppress(asyncio.QueueEmpty, asyncio.QueueFull):
                self.steps.get_nowait()
                self.steps.put_nowait(event)

    def complete(self, terminal: Terminal) -> None:
        if not self.terminal.done():
            self.terminal.set_result(terminal)


class InvocationHandle(Generic[OutputT]):
    """The caller's grip on one in-flight run."""

    # fleet routing: the replica instance id this run was
    # placed on, set by AgentGateway.start; None = shared-topic placement
    routed_replica: "str | None" = None
    # the FULL control-plane replica key ("<node_id>@<instance>") of the
    # placement — what the failover supervisor's dead-placement probe
    # looks up in the registry; None = shared-topic placement
    routed_replica_key: "str | None" = None
    # run-scoped observability: the run id this placement
    # serves under — every retry/failover/hedge/resume placement of one
    # logical call shares it — and the client's ledger, so
    # ``run_report()`` answers from the handle
    run_id: "str | None" = None
    _run_ledger: Any = None

    def run_report(self) -> Any:
        """The run-level report (:class:`~calfkit_tpu_torch.models.records.RunRecord`)
        for this handle's run: every attempt with its placement, marker
        kind, and typed outcome.  None when the client's
        ledger no longer holds the run (LRU aged out)."""
        if self._run_ledger is None or self.run_id is None:
            return None
        return self._run_ledger.run_report(self.run_id)

    def __init__(
        self,
        channel: _RunChannel,
        output_type: type[OutputT],
        *,
        default_timeout: float | None = None,
        on_abandon: Any = None,  # async callable: publish the mesh cancel
        task_registry: "set | None" = None,  # client-owned: close() drains it
    ):
        self._channel = channel
        self._output_type = output_type
        self._default_timeout = default_timeout
        self._on_abandon = on_abandon
        self._cancelled = False
        self._cancel_task: "asyncio.Task | None" = None
        self._task_registry = task_registry

    @property
    def correlation_id(self) -> str:
        return self._channel.correlation_id

    @property
    def task_id(self) -> str:
        return self._channel.task_id

    # the cancel publish runs as a background task off the timeout rail
    # (_cancel_soon) but still must not linger forever: an unreachable
    # broker is the LIKELY state when a timeout fires — the publish could
    # otherwise block on reconnection indefinitely
    _CANCEL_PUBLISH_TIMEOUT = 5.0

    async def cancel(self) -> None:
        """Publish the run's mesh ``cancel`` record (idempotent,
        best-effort, time-bounded): downstream engines abandon in-flight
        work for this correlation id instead of decoding for a caller
        that left.  Called automatically when ``result()``/``stream()``
        time out; call it yourself when abandoning a run for any other
        reason."""
        if self._cancelled or self._on_abandon is None:
            return
        self._cancelled = True
        try:
            await asyncio.wait_for(
                self._on_abandon(), self._CANCEL_PUBLISH_TIMEOUT
            )
        except Exception:  # noqa: BLE001 - cancel is advisory, never masks
            logger.debug(
                "cancel publish failed for %s", self.correlation_id[:8],
                exc_info=True,
            )

    def _cancel_soon(self) -> None:
        """Queue the advisory cancel publish OFF the timeout rail: the
        ``ClientTimeoutError`` must surface the moment the caller's
        budget expires, not up to ``_CANCEL_PUBLISH_TIMEOUT`` later when
        the broker is unreachable (the likely state when a timeout
        fires).  The task is retained on the handle — and registered with
        the client so ``Client.close()`` gives it a bounded window to
        land before the mesh stops; ``cancel()`` stays awaitable for
        callers who want publish confirmation."""
        if self._cancelled or self._on_abandon is None:
            return
        task = asyncio.get_running_loop().create_task(self.cancel())
        self._cancel_task = task
        if self._task_registry is not None:
            self._task_registry.add(task)
            task.add_done_callback(self._task_registry.discard)

    @property
    def terminal_arrived(self) -> bool:
        """True once the run's terminal reply (return OR fault) landed."""
        return self._channel.terminal.done()

    async def wait(self, timeout: "float | None") -> bool:
        """Await the terminal for up to ``timeout`` seconds WITHOUT
        consuming it or publishing a cancel on expiry — the failover
        supervisor's probe primitive: returns True once the
        terminal landed, False on a quiet timeout (the run is still
        in flight; call :meth:`result` to consume, :meth:`cancel` to
        abandon)."""
        try:
            await asyncio.wait_for(
                asyncio.shield(self._channel.terminal), timeout
            )
            return True
        except asyncio.TimeoutError:
            return False

    async def result(self, timeout: float | None = None) -> InvocationResult[OutputT]:
        """Await the terminal reply; faults raise :class:`NodeFaultError`.
        A timeout publishes the run's mesh cancel before raising — the
        timeout is no longer purely local."""
        timeout = timeout if timeout is not None else self._default_timeout
        try:
            terminal = await asyncio.wait_for(
                asyncio.shield(self._channel.terminal), timeout
            )
        except asyncio.TimeoutError:
            self._cancel_soon()
            raise ClientTimeoutError(
                f"run {self.correlation_id[:8]} produced no terminal reply "
                f"within {timeout}s"
            ) from None
        if isinstance(terminal, RunFailed):
            raise NodeFaultError(terminal.report, terminal.envelope)
        return InvocationResult.from_envelope(
            terminal.envelope,
            self._output_type,
            correlation_id=self.correlation_id,
            task_id=self.task_id,
        )

    async def stream(
        self, timeout: float | None = None
    ) -> AsyncIterator[StepEvent | InvocationResult[OutputT]]:
        """Yield step events live, ending with the typed result."""
        timeout = timeout if timeout is not None else self._default_timeout
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout if timeout is not None else None
        while True:
            remaining: float | None = None
            if deadline is not None:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    self._cancel_soon()
                    raise ClientTimeoutError(
                        f"run {self.correlation_id[:8]} stream timed out"
                    )
            step_task = asyncio.ensure_future(self._channel.steps.get())
            try:
                done, _ = await asyncio.wait(
                    [step_task, self._channel.terminal],
                    timeout=remaining,
                    return_when=asyncio.FIRST_COMPLETED,
                )
            except asyncio.CancelledError:
                step_task.cancel()
                raise
            if not done:
                step_task.cancel()
                self._cancel_soon()
                raise ClientTimeoutError(
                    f"run {self.correlation_id[:8]} stream timed out"
                )
            if step_task in done:
                yield step_task.result()
                continue
            step_task.cancel()
            # drain any steps that raced the terminal
            while not self._channel.steps.empty():
                yield self._channel.steps.get_nowait()
            terminal = self._channel.terminal.result()
            if isinstance(terminal, RunFailed):
                raise NodeFaultError(terminal.report, terminal.envelope)
            yield InvocationResult.from_envelope(
                terminal.envelope,
                self._output_type,
                correlation_id=self.correlation_id,
                task_id=self.task_id,
            )
            return


class Hub:
    """Demuxes the client inbox into run channels + the firehose tee."""

    def __init__(self) -> None:
        self._channels: weakref.WeakValueDictionary[str, _RunChannel] = (
            weakref.WeakValueDictionary()
        )
        self._firehose_taps: list[Any] = []  # EventStream instances
        # terminal-arrival hook: called with the correlation
        # id of EVERY terminal reply this inbox observes — including
        # replies to abandoned/fire-and-forget runs whose channel is
        # gone.  The client's lease heartbeat uses it to stop counting a
        # run as outstanding the moment its terminal lands, which no
        # handle-side callback can do for a dropped handle.
        self.on_terminal: "Any | None" = None

    def track(self, correlation_id: str, task_id: str) -> _RunChannel:
        channel = _RunChannel(correlation_id=correlation_id, task_id=task_id)
        self._channels[correlation_id] = channel
        return channel

    def add_tap(self, tap: Any) -> None:
        self._firehose_taps.append(tap)

    def remove_tap(self, tap: Any) -> None:
        if tap in self._firehose_taps:
            self._firehose_taps.remove(tap)

    # ----------------------------------------------------------- dispatch
    async def on_record(self, record: Record) -> None:
        headers = record.headers
        correlation_id = headers.get(protocol.HDR_CORRELATION)
        if headers.get(protocol.HDR_WIRE) == "step":
            self._on_step(record, correlation_id)
            return
        self._on_reply(record, correlation_id, headers)

    def _on_step(self, record: Record, correlation_id: str | None) -> None:
        try:
            message = StepMessage.from_wire(record.value)
        except ValueError:
            logger.debug("undecodable step message dropped")
            return
        for step in message.steps:
            event = StepEvent(
                correlation_id=correlation_id or "",
                task_id=record.headers.get(protocol.HDR_TASK),
                node=message.emitter or None,
                step=step,
            )
            channel = self._channels.get(correlation_id or "")
            if channel is not None:
                channel.push_step(event)
            for tap in self._firehose_taps:
                tap.push(event)

    def _on_reply(
        self, record: Record, correlation_id: str | None, headers: dict[str, str]
    ) -> None:
        try:
            envelope = Envelope.from_wire(record.value)
        except ValueError:
            logger.warning("undecodable reply on client inbox dropped")
            return
        if self.on_terminal is not None and correlation_id:
            try:
                self.on_terminal(correlation_id)
            except Exception:  # noqa: BLE001 - the hook never blocks replies
                logger.debug("on_terminal hook failed", exc_info=True)
        channel = self._channels.get(correlation_id or "")
        if channel is None:
            logger.debug(
                "reply for unknown/abandoned run %s", (correlation_id or "?")[:8]
            )
            return
        reply = envelope.reply
        if isinstance(reply, ReturnMessage):
            channel.complete(RunCompleted(envelope=envelope, headers=headers))
        elif isinstance(reply, FaultMessage):
            channel.complete(RunFailed(report=reply.report, envelope=envelope))
        else:
            channel.complete(
                RunFailed(
                    report=ErrorReport.build_safe(
                        FaultTypes.DESERIALIZATION_ERROR,
                        "terminal record carried no reply",
                    ),
                    envelope=envelope,
                )
            )
