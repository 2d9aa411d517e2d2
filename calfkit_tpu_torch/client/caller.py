"""The Client: the caller surface onto the mesh.

Reference: calfkit/client/caller.py:46-437 + gateway.py.  Semantics kept:

- ``Client.connect(...)`` is **lazy sync** — no I/O until first use;
- the inbox subscriber is consuming before the first call publishes;
- three verbs per agent: ``send`` (fire token), ``start`` (handle),
  ``execute`` (await result);
- handles register before publish (race-free);
- ``client.events()`` is the bounded drop-oldest firehose.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import random
import uuid
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Generic, TypeVar

from calfkit_tpu_torch import cancellation, protocol
from calfkit_tpu_torch.exceptions import (
    RETRIABLE_FAULT_TYPES,
    ClientClosedError,
    ClientTimeoutError,
    MeshUnavailableError,
    NodeFaultError,
)
from calfkit_tpu_torch.models.error_report import FaultTypes

from calfkit_tpu_torch.keying import partition_key
from calfkit_tpu_torch.mesh.transport import MeshTransport, Subscription
from calfkit_tpu_torch.models.messages import ModelMessage
from calfkit_tpu_torch.models.node_result import InvocationResult
from calfkit_tpu_torch.models.payload import ContentPart, TextPart
from calfkit_tpu_torch.models.session_context import (
    CallFrame,
    Envelope,
    SessionContext,
    WorkflowState,
    new_id,
)
from calfkit_tpu_torch.models.state import State
from calfkit_tpu_torch.client.events import EventStream
from calfkit_tpu_torch.client.hub import Hub, InvocationHandle, RunCompleted
from calfkit_tpu_torch.observability.runledger import RunLedger, publish_runs_soon

logger = logging.getLogger(__name__)

OutputT = TypeVar("OutputT")

DEFAULT_TIMEOUT = 60.0
# a leased run with no deadline still leaves the outstanding set
# eventually: the beat loop prunes it after this many seconds, so a
# dropped fire-and-forget terminal cannot pin heartbeats forever
_LEASE_RUN_FALLBACK_S = 3600.0


@dataclass(frozen=True)
class RetryPolicy:
    """Caller-side bounded retry with jittered exponential backoff
    — applied by :meth:`AgentGateway.execute` to faults whose
    ``error_type`` is in :data:`RETRIABLE_FAULT_TYPES` (overload, drain,
    transient capability loss) and NOTHING else: a deadline fault means
    the budget is spent, a node error means the same call would fail the
    same way.

    Delays follow ``base_delay * multiplier**attempt`` capped at
    ``max_delay``, each multiplied by a jitter factor drawn uniformly
    from ``[1 - jitter, 1]``.  ``rng`` is a zero-arg callable returning
    a float in ``[0, 1)`` (default :func:`random.random`); pass e.g.
    ``random.Random(0).random`` for fully deterministic backoff (the
    chaos harness does)."""

    attempts: int = 3  # total tries (1 = no retry)
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5  # fraction of the delay the jitter may remove
    rng: "Callable[[], float] | None" = None

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based)."""
        raw = min(self.base_delay * self.multiplier**attempt, self.max_delay)
        draw = (self.rng or random.random)()
        return raw * (1.0 - self.jitter * draw)

    @staticmethod
    def retriable(exc: BaseException) -> bool:
        return (
            isinstance(exc, NodeFaultError)
            and exc.report.error_type in RETRIABLE_FAULT_TYPES
        )


class Client:
    def __init__(
        self,
        mesh: MeshTransport,
        *,
        client_id: str | None = None,
        default_timeout: float = DEFAULT_TIMEOUT,
        retry: "RetryPolicy | None" = None,
        router: Any = None,  # not ported: must stay None
        failover: Any = None,  # not ported: must stay None
        lease_ttl: "float | None" = None,
        priority: "str | None" = None,
    ):
        self.mesh = mesh
        self.client_id = client_id or uuid.uuid4().hex[:12]
        # multi-tenant QoS: this client's default priority
        # class ("interactive" | "batch"), stamped on every call as
        # x-mesh-priority unless a per-call class overrides it.  None =
        # no header — receivers resolve the absent class to the mesh
        # DEFAULT (interactive); "batch" is the explicit opt-in to
        # shed/reap/rate-limit FIRST under overload.
        self.priority = priority if priority in protocol.PRIORITY_CLASSES else None
        self.inbox_topic = protocol.client_inbox_topic(self.client_id)
        self.default_timeout = default_timeout
        # opt-in bounded retry for execute(): None = single attempt (the
        # older behavior; retries change at-most-once semantics for
        # non-idempotent agents, so the caller must choose them)
        self.retry = retry
        # fleet routing and in-flight failover (a FleetRouter / policy
        # name, a FailoverPolicy) are not ported yet: refused, typed
        if router is not None or failover is not None:
            raise MeshUnavailableError(
                "Client(router=/failover=): fleet placement and failover are "
                "not ported to calfkit_tpu_torch yet (ROADMAP Queue 1); calls "
                "ride the shared agent topic",
                reason="not_ported",
            )
        # opt-in caller liveness lease: with a TTL set, every
        # call carries an ``x-mesh-lease`` header and — while any run is
        # outstanding — this client heartbeats the compacted
        # ``mesh.caller_liveness`` table at ttl/3.  Engines whose run's
        # lease lapses reap it server-side (typed ``mesh.orphaned``): the
        # recovery path that covers fire-and-forget ``send()``, which no
        # client-side supervisor can.  None = un-leased (older):
        # a dead caller's runs burn until their deadline.
        self.lease_ttl = lease_ttl
        self._lease_id = uuid.uuid4().hex[:12] if lease_ttl else None
        self._lease_runs: dict[str, float] = {}  # corr -> prune-after epoch
        self._lease_task: "asyncio.Task | None" = None
        self._lease_writer: Any = None
        self._hub = Hub()
        if self._lease_id is not None:
            self._hub.on_terminal = self._note_run_terminal
        self._subscription: Subscription | None = None
        self._started = False
        self._closed = False
        self._owns_mesh = False  # connect() sets it for url-built transports
        self._start_lock: asyncio.Lock | None = None
        self._mesh_view: Any = None
        self._span_tasks: set[asyncio.Task] = set()  # in-flight span exports
        # run-scoped observability: the per-run attempt ledger
        # — every start() placement records here under its run id, the
        # execute()/stream() supervisors close runs with caller-visible
        # outcomes, and closed runs export fire-and-forget to the
        # compacted ``mesh.runs`` table (key = run_id)
        self.run_ledger = RunLedger()
        self._run_tasks: set[asyncio.Task] = set()  # in-flight run exports
        # in-flight fire-and-forget cancel publishes (hub._cancel_soon):
        # close() drains these too, or a caller exiting right after a
        # ClientTimeoutError would silently drop the mesh cancel
        self._cancel_tasks: set[asyncio.Task] = set()

    # ------------------------------------------------------------- connect
    @classmethod
    def connect(
        cls,
        mesh: "MeshTransport | str | None" = None,
        *,
        client_id: str | None = None,
        default_timeout: float = DEFAULT_TIMEOUT,
        retry: "RetryPolicy | None" = None,
        router: Any = None,
        failover: Any = None,
        lease_ttl: "float | None" = None,
        priority: "str | None" = None,
    ) -> "Client":
        """Lazy constructor: performs no I/O (reference: caller.py:102).

        ``mesh`` may be a transport object, a url string
        (``tcp://host:port`` / ``kafka://host:port``), or None to read
        ``$CALFKIT_MESH_URL``.  A transport built here from a url is OWNED
        by the client: ``close()`` stops it.
        """
        from calfkit_tpu_torch.mesh.urls import resolve_mesh

        transport, owned = resolve_mesh(mesh, allow_memory=False)
        client = cls(
            transport, client_id=client_id, default_timeout=default_timeout,
            retry=retry, router=router, failover=failover,
            lease_ttl=lease_ttl, priority=priority,
        )
        client._owns_mesh = owned
        return client

    async def _ensure_started(self) -> None:
        if self._closed:
            raise ClientClosedError("client is closed")
        if self._started:
            return
        if self._start_lock is None:
            self._start_lock = asyncio.Lock()
        async with self._start_lock:
            if self._started:
                return
            await self.mesh.start()
            await self.mesh.ensure_topics([self.inbox_topic])
            # run-record export: compacted by run id so the
            # latest (finished) record per run survives for `ck run` /
            # the worker-side SLO fold
            await self.mesh.ensure_topics(
                [protocol.RUNS_TOPIC], compacted=True
            )
            if self._lease_id is not None:
                await self.mesh.ensure_topics(
                    [protocol.CALLER_LIVENESS_TOPIC], compacted=True
                )
                self._lease_writer = self.mesh.table_writer(
                    protocol.CALLER_LIVENESS_TOPIC
                )
            # inbox must be consuming BEFORE any call publishes
            self._subscription = await self.mesh.subscribe(
                [self.inbox_topic],
                self._hub.on_record,
                group_id=None,
                from_latest=False,
                ordered=False,
            )
            # atomicity-ok: double-checked under _start_lock — the flag is
            # re-read inside the lock, so the stale outer read only costs
            # a lock acquire, never a double start
            self._started = True

    # ------------------------------------------------- caller liveness
    # One lease per CLIENT process, not per run: the beat loop
    # publishes a compact record keyed by the lease id while any leased
    # run is outstanding, and close() releases the lease (tombstone) so
    # a clean departure orphans its leftovers immediately instead of
    # after a TTL of silence.

    @property
    def lease_id(self) -> "str | None":
        return self._lease_id

    def _lease_header(self) -> "str | None":
        if self._lease_id is None or self.lease_ttl is None:
            return None
        return protocol.format_lease(self._lease_id, self.lease_ttl)

    def _note_run_started(
        self, correlation_id: str, deadline: "float | None"
    ) -> None:
        """Count a leased run as outstanding (and start beating).  The
        prune horizon bounds fire-and-forget runs whose terminal nobody
        awaits: the run's own deadline when it has one, else a fallback
        — a dropped terminal must not pin heartbeats forever."""
        if self._lease_id is None:
            return
        prune_at = (
            deadline
            if deadline is not None
            else cancellation.wall_clock() + _LEASE_RUN_FALLBACK_S
        )
        self._lease_runs[correlation_id] = prune_at
        if self._lease_task is None or self._lease_task.done():
            self._lease_task = asyncio.get_running_loop().create_task(
                self._beat_lease(), name="caller-lease-heartbeat"
            )

    def _note_run_terminal(self, correlation_id: str) -> None:
        """Hub hook: ANY terminal reply (including one for a dropped
        fire-and-forget handle) retires the run from the outstanding
        set — the beat loop goes quiet once the set empties."""
        self._lease_runs.pop(correlation_id, None)

    # ------------------------------------------- run ledger
    # One run id per logical execute()/stream() call, minted once and
    # carried verbatim across every retry/failover/hedge/resume
    # placement.  The ledger is telemetry: every fold here is fail-open
    # and first-signal-wins, and a lost export degrades to client-local
    # ``handle.run_report()`` visibility only.

    def _record_attempt_terminal(
        self,
        run_id: str,
        correlation_id: str,
        fut: "asyncio.Future",
        *,
        finish: bool = False,
    ) -> None:
        """Terminal-future hook: fold one attempt's terminal into the
        ledger.  Typed mapping: return → ok; ``mesh.overloaded`` → shed;
        ``mesh.cancelled``/``mesh.orphaned`` → cancelled; any other
        fault → fault (with its error type).

        ``finish=True`` means no supervisor owns this run (a bare
        ``start()``/``send()`` minted the id itself): the attempt's
        terminal IS the run's terminal, so close the run and export it
        — otherwise an un-supervised run would sit ``pending`` forever
        and never reach ``mesh.runs``."""
        if fut.cancelled():
            return
        terminal = fut.result()
        now = cancellation.wall_clock()
        if isinstance(terminal, RunCompleted):
            self.run_ledger.note_outcome(
                run_id, correlation_id, outcome="ok", finished_at=now
            )
            if finish:
                self._finish_run_soon(run_id, outcome="ok")
            return
        error_type = str(getattr(terminal.report, "error_type", "") or "")
        if error_type == FaultTypes.OVERLOADED:
            outcome = "shed"
        elif error_type in (FaultTypes.CANCELLED, FaultTypes.ORPHANED):
            outcome = "cancelled"
        else:
            outcome = "fault"
        self.run_ledger.note_outcome(
            run_id,
            correlation_id,
            outcome=outcome,
            error_type=error_type,
            finished_at=now,
        )
        if finish:
            self._finish_run_soon(
                run_id, outcome=outcome, error_type=error_type
            )

    def _note_attempt_superseded(
        self, run_id: "str | None", handle: Any, reason: str
    ) -> None:
        """Supervisor verdict: this placement was abandoned (dead
        replica, losing hedge) — its terminal may never arrive, so the
        supervisor records the outcome itself.  First-signal-wins in the
        ledger: if a real terminal already landed, this drops."""
        if not run_id:
            return
        self.run_ledger.note_outcome(
            run_id,
            handle.correlation_id,
            outcome="superseded",
            error_type=reason,
            finished_at=cancellation.wall_clock(),
        )

    def _finish_run_soon(
        self, run_id: "str | None", *, outcome: str, error_type: str = ""
    ) -> None:
        """Close the run with its CALLER-visible outcome and export the
        record to ``mesh.runs`` fire-and-forget (the span-export
        pattern: close() drains stragglers briefly)."""
        if not run_id:
            return
        self.run_ledger.finish_run(
            run_id,
            outcome=outcome,
            error_type=error_type,
            finished_at=cancellation.wall_clock(),
        )
        record = self.run_ledger.export_record(run_id)
        if record is not None:
            publish_runs_soon(self.mesh.publish, [record], self._run_tasks)

    def _finish_run_exc(
        self, run_id: "str | None", exc: BaseException
    ) -> None:
        """Close the run from the exception surfacing to the caller."""
        if isinstance(exc, ClientTimeoutError):
            self._finish_run_soon(run_id, outcome="timeout")
        elif isinstance(exc, (asyncio.CancelledError, GeneratorExit)):
            self._finish_run_soon(run_id, outcome="cancelled")
        elif isinstance(exc, NodeFaultError):
            self._finish_run_soon(
                run_id,
                outcome="fault",
                error_type=str(exc.report.error_type or ""),
            )
        else:
            self._finish_run_soon(
                run_id, outcome="fault", error_type=type(exc).__name__
            )

    def _prune_lease_runs(self) -> None:
        """Drop runs past their prune horizon — UNLESS the caller still
        holds a live handle (the hub's weak channel map answers that):
        the fallback horizon exists for dropped fire-and-forget
        terminals, and silently stopping heartbeats under an
        un-deadlined run somebody is actively awaiting would make the
        engine orphan a LIVE caller's run.  Awaited runs re-arm."""
        now = cancellation.wall_clock()
        for corr, at in list(self._lease_runs.items()):
            if at > now:
                continue
            if self._hub._channels.get(corr) is not None:
                # handle still alive: the caller is awaiting — keep
                # beating and push the horizon out another window
                self._lease_runs[corr] = now + _LEASE_RUN_FALLBACK_S
            else:
                del self._lease_runs[corr]

    async def _beat_lease(self) -> None:
        """Publish caller heartbeats at ttl/3 while runs are outstanding.
        Per-beat resilient (a flaky broker logs and retries next tick —
        the engine grants a full TTL of grace); exits when the
        outstanding set drains, restarted by the next leased start()."""
        assert self.lease_ttl is not None and self._lease_id is not None
        from calfkit_tpu_torch import leases

        interval = max(0.02, self.lease_ttl / 3.0)
        while not self._closed:
            self._prune_lease_runs()
            if not self._lease_runs:
                return
            try:
                await self._lease_writer.put(
                    self._lease_id,
                    leases.beat_payload(self._lease_id, self.lease_ttl),
                )
            except Exception:  # noqa: BLE001 - per-beat resilience
                logger.warning(
                    "caller lease beat failed (retrying next tick)",
                    exc_info=True,
                )
            await asyncio.sleep(interval)

    async def _release_lease(self) -> None:
        """Clean departure: stop beating and tombstone the lease —
        outstanding leased runs become orphans NOW (the server-side
        reaper grants no TTL grace to a deliberate close)."""
        if self._lease_task is not None:
            self._lease_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._lease_task
            self._lease_task = None
        if self._lease_writer is not None and self._lease_id is not None:
            with contextlib.suppress(Exception):
                await asyncio.wait_for(
                    self._lease_writer.tombstone(self._lease_id), 2.0
                )

    async def close(self) -> None:
        self._closed = True
        await self._release_lease()
        pending = {
            t
            for t in (*self._span_tasks, *self._run_tasks, *self._cancel_tasks)
            if not t.done()
        }
        if pending:
            # give in-flight fire-and-forget span exports and cancel
            # publishes a brief window to land before the mesh stops (the
            # root span has no ring-to-topic fallback; a dropped cancel
            # leaves downstream engines decoding for a dead caller);
            # stragglers are dropped, not awaited
            with contextlib.suppress(Exception):
                await asyncio.wait(pending, timeout=2.0)
        if self._subscription is not None:
            with contextlib.suppress(Exception):
                await self._subscription.stop()
            self._subscription = None
        if self._owns_mesh:
            # connect() built this transport from a url: stop it too, or a
            # per-job client would leak sockets and reader tasks
            with contextlib.suppress(Exception):
                await self.mesh.stop()

    async def __aenter__(self) -> "Client":
        await self._ensure_started()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()

    # ------------------------------------------------------------- agents
    def agent(
        self, name: str, *, output_type: type[OutputT] = str
    ) -> "AgentGateway[OutputT]":
        return AgentGateway(self, name, output_type)

    # ---------------------------------------------------------------- mesh
    @property
    def mesh_directory(self) -> Any:
        """The read-only directory of live agents/capabilities
        (``client.mesh`` in the reference; named ``mesh_directory`` here
        because ``.mesh`` is the transport)."""
        if self._mesh_view is None:
            from calfkit_tpu_torch.client.mesh import Mesh

            self._mesh_view = Mesh(self)
        return self._mesh_view

    # ------------------------------------------------------------ firehose
    def events(self, *, buffer: int = 1024) -> EventStream:
        """Every step event this client observes, across all runs.

        ``stream.close()`` detaches the tap from the hub."""
        stream = EventStream(buffer=buffer, on_close=self._hub.remove_tap)
        self._hub.add_tap(stream)
        return stream

    # ------------------------------------------------------------ internal
    async def _publish_cancel(
        self, target_topic: str, correlation_id: str, task_id: str
    ) -> None:
        """Publish the run's ``cancel`` record: pure headers, no
        body, keyed like the call so it rides the same ordered lane.  Any
        node on the target topic fans it out to in-process cancellation
        targets (engines) — a timed-out caller stops burning TPU
        dispatches instead of merely stopping to listen."""
        headers = {
            protocol.HDR_EMITTER: protocol.emitter_header(
                "client", self.client_id
            ),
            protocol.HDR_KIND: "cancel",
            protocol.HDR_TASK: task_id,
            protocol.HDR_CORRELATION: correlation_id,
        }
        await self.mesh.publish(
            target_topic, b"", key=partition_key(task_id), headers=headers
        )

    async def _publish_call(
        self,
        target_topic: str,
        parts: list[ContentPart],
        *,
        route: str,
        correlation_id: str,
        task_id: str,
        state: State,
        deps: dict[str, Any],
        deadline: float | None = None,
        attempt: str | None = None,
        run: str | None = None,
        priority: str | None = None,
    ) -> None:
        from calfkit_tpu_torch.observability.trace import TRACER

        envelope = Envelope(
            context=SessionContext(state=state, deps=deps),
            workflow=WorkflowState(
                frames=[
                    CallFrame(
                        target_topic=target_topic,
                        callback_topic=self.inbox_topic,
                        route=route,
                        payload=parts,
                        caller_kind="client",
                        caller_name=self.client_id,
                    )
                ]
            ),
        )
        # the trace root: trace_id == correlation_id by convention, so
        # `ck trace <correlation-id>` needs no id mapping
        span = TRACER.start_span(
            "client.dispatch",
            trace_id=correlation_id,
            kind="client",
            emitter=protocol.emitter_header("client", self.client_id),
            attrs={"target_topic": target_topic, "route": route},
        )
        headers = {
            protocol.HDR_EMITTER: protocol.emitter_header("client", self.client_id),
            protocol.HDR_KIND: "call",
            protocol.HDR_WIRE: "envelope",
            protocol.HDR_ROUTE: route,
            protocol.HDR_TASK: task_id,
            protocol.HDR_CORRELATION: correlation_id,
            **span.context.headers(),
        }
        if deadline is not None:
            # the mesh deadline: minted once from the caller's timeout,
            # forwarded absolute by every hop (protocol.HDR_DEADLINE)
            headers[protocol.HDR_DEADLINE] = protocol.format_deadline(deadline)
        lease = self._lease_header()
        if lease is not None:
            # the caller liveness lease: forwarded by every
            # hop like the deadline — downstream work runs on the
            # ORIGINAL caller's behalf and dies with its lease
            headers[protocol.HDR_LEASE] = lease
        if attempt:
            # failure recovery: "failover" | "hedge" — this
            # placement only, counted by the serving agent's advert
            headers[protocol.HDR_ATTEMPT] = attempt
        if run is not None:
            # run identity: "<run_id>:<attempt_no>", minted
            # once per logical execute()/stream() call and carried
            # VERBATIM across retry/failover/hedge/resume re-dispatches;
            # forwarded by every downstream hop (unlike x-mesh-attempt).
            # A corrupt value degrades to an un-linked run — never
            # faults delivery (the header-degradation law)
            headers[protocol.HDR_RUN] = run
        if priority in protocol.PRIORITY_CLASSES:
            # priority class: forwarded by every hop like the
            # deadline/lease — downstream work degrades as THIS caller's
            # class.  Absent = the mesh default; corrupt parses degrade,
            # never fault (the header-degradation law)
            headers[protocol.HDR_PRIORITY] = protocol.format_priority(priority)
        try:
            await self.mesh.publish(
                target_topic,
                envelope.to_wire(),
                key=partition_key(task_id),
                headers=headers,
            )
        except BaseException as exc:
            span.end(
                status="cancelled"
                if isinstance(exc, asyncio.CancelledError)
                else "error"
            )
            raise
        record = span.end()
        if record is not None:
            # best-effort span export, FIRE-AND-FORGET (shared helper):
            # an awaited publish here would add a full broker round-trip
            # to every client call; close() drains stragglers briefly
            from calfkit_tpu_torch.observability.trace import publish_spans_soon

            publish_spans_soon(self.mesh.publish, [record], self._span_tasks)


class AgentGateway(Generic[OutputT]):
    """Typed per-agent verbs (reference: client/gateway.py:32-120)."""

    def __init__(self, client: Client, name: str, output_type: type[OutputT]):
        self._client = client
        self.name = name
        self.output_type = output_type
        self.input_topic = protocol.agent_input_topic(name)

    def _build_state(
        self, message_history: list[ModelMessage] | None
    ) -> State:
        return State(message_history=list(message_history or []))

    @staticmethod
    def _as_parts(prompt: str | list[ContentPart]) -> list[ContentPart]:
        if isinstance(prompt, str):
            return [TextPart(text=prompt)]
        return list(prompt)

    async def start(
        self,
        prompt: str | list[ContentPart],
        *,
        message_history: list[ModelMessage] | None = None,
        deps: dict[str, Any] | None = None,
        route: str = "run",
        timeout: float | None = None,
        mark: "str | None" = None,
        run_id: "str | None" = None,
        attempt_no: int = 0,
        attempt_kind: str = "first",
        priority: "str | None" = None,
    ) -> InvocationHandle[OutputT]:
        """Begin a run; returns a handle (reference: gateway.py:70).

        The effective timeout also mints the run's ``x-mesh-deadline``
        (absolute epoch), and the handle carries a cancel hook: a timeout
        (or an explicit ``handle.cancel()``) publishes a mesh ``cancel``
        record so downstream engines abandon the run's work.

        The call rides the agent's shared input topic (the JAX package's
        fleet placement and ``exclude_replicas`` come with the fleet
        router, ROADMAP Queue 1).  ``mark`` stamps the call's
        ``x-mesh-attempt`` header ("failover" | "hedge") so the serving
        replica's advert counts recovery arrivals.

        ``run_id``/``attempt_no``/``attempt_kind`` are the
        run identity: minted here for a bare ``start()``/``send()``,
        passed in by the execute()/stream() supervisors so every
        retry/failover/hedge/resume placement lands in ONE ledger entry
        and carries the same ``x-mesh-run`` header."""
        client = self._client
        await client._ensure_started()
        correlation_id = new_id()
        task_id = new_id()
        effective_timeout = (
            timeout if timeout is not None else client.default_timeout
        )
        parts = self._as_parts(prompt)
        target_topic = self.input_topic
        now = cancellation.wall_clock()
        deadline = (
            now + effective_timeout if effective_timeout is not None else None
        )

        async def publish_cancel() -> None:
            await client._publish_cancel(
                target_topic, correlation_id, task_id
            )

        # register BEFORE publish: the reply cannot beat the handle
        channel = client._hub.track(correlation_id, task_id)
        # caller liveness: the run joins the lease's
        # outstanding set BEFORE publish (heartbeats must be flowing by
        # the time the engine registers the run); the hub's terminal
        # hook retires it — even for a dropped fire-and-forget handle
        client._note_run_started(correlation_id, deadline)
        handle: InvocationHandle[OutputT] = InvocationHandle(
            channel,
            self.output_type,
            default_timeout=effective_timeout,
            on_abandon=publish_cancel,
            task_registry=client._cancel_tasks,
        )
        # run ledger: record the attempt BEFORE publish (the
        # terminal callback below may fire the moment the reply lands),
        # and fold its terminal in when it does — first signal wins, so
        # a supervisor's later "superseded" verdict never clobbers a
        # real outcome (or vice versa)
        # a bare start()/send() owns the run it mints; execute()/stream()
        # supervisors pass run_id in and close the run themselves
        owns_run = run_id is None
        run_id = run_id or new_id()
        # the run's EFFECTIVE class (per-call override, else the client
        # default, else the default class): stamped on the wire header
        # below AND on the run record, so `ck slo` can fold per class
        effective_priority = (
            priority
            if priority in protocol.PRIORITY_CLASSES
            else client.priority
        )
        client.run_ledger.begin_run(
            run_id,
            agent=self.name,
            client_id=client.client_id,
            started_at=now,
            priority=effective_priority or protocol.DEFAULT_PRIORITY,
        )
        client.run_ledger.note_attempt(
            run_id,
            attempt_no=attempt_no,
            correlation_id=correlation_id,
            kind=attempt_kind,
            placement="",
            agent=self.name,
            started_at=now,
        )
        handle.run_id = run_id
        handle._run_ledger = client.run_ledger
        channel.terminal.add_done_callback(
            lambda f, r=run_id, c=correlation_id, fin=owns_run: (
                client._record_attempt_terminal(r, c, f, finish=fin)
            )
        )
        try:
            await client._publish_call(
                target_topic,
                parts,
                route=route,
                correlation_id=correlation_id,
                task_id=task_id,
                state=self._build_state(message_history),
                deps=deps or {},
                deadline=deadline,
                attempt=mark,
                run=protocol.format_run(run_id, attempt_no),
                priority=effective_priority,
            )
        except BaseException:
            # the call never reached the mesh: no terminal will resolve,
            # so uncharge the replica NOW — a phantom in-flight entry
            # would bias placement away from a healthy replica for the
            # whole TTL — and retire the run from the lease's
            # outstanding set (its terminal can never arrive)
            client._note_run_terminal(correlation_id)
            raise
        return handle

    async def send(
        self,
        prompt: str | list[ContentPart],
        *,
        message_history: list[ModelMessage] | None = None,
        deps: dict[str, Any] | None = None,
        route: str = "run",
        priority: "str | None" = None,
    ) -> str:
        """Fire-and-forget; returns the correlation id (reference:
        gateway.py 'send' — the fire token)."""
        handle = await self.start(
            prompt, message_history=message_history, deps=deps, route=route,
            priority=priority,
        )
        return handle.correlation_id

    async def execute(
        self,
        prompt: str | list[ContentPart],
        *,
        message_history: list[ModelMessage] | None = None,
        deps: dict[str, Any] | None = None,
        route: str = "run",
        timeout: float | None = None,
        retry: "RetryPolicy | None" = None,
        priority: "str | None" = None,
    ) -> InvocationResult[OutputT]:
        """Run to a typed result.  With a :class:`RetryPolicy` (here or on
        the client), faults typed retriable — overload sheds, draining
        workers — are retried with jittered exponential backoff; each
        retry is a FRESH run (new correlation id, new deadline).  Timeouts
        and non-retriable faults surface immediately.

        (The JAX package's fleet-routed placement, replica exclusion and
        in-flight failover come with the fleet router, ROADMAP Queue 1.)"""
        policy = retry if retry is not None else self._client.retry
        client = self._client
        # run identity: ONE run id for the whole logical call
        # — every retry/failover/hedge placement below records into the
        # same ledger entry and carries the same x-mesh-run header
        run_id = new_id()
        attempts = policy.attempts if policy is not None else 1
        last: BaseException | None = None
        try:
            for attempt in range(max(1, attempts)):
                if attempt:
                    await asyncio.sleep(policy.delay(attempt - 1))
                handle = await self.start(
                    prompt,
                    message_history=message_history,
                    deps=deps,
                    route=route,
                    timeout=timeout,
                    run_id=run_id,
                    attempt_no=attempt,
                    attempt_kind="first" if attempt == 0 else "retry",
                    priority=priority,
                )
                try:
                    result = await handle.result()
                except NodeFaultError as exc:
                    if policy is None or not RetryPolicy.retriable(exc):
                        raise
                    last = exc
                    continue
                client._finish_run_soon(run_id, outcome="ok")
                return result
            assert last is not None
            raise last
        except BaseException as exc:
            client._finish_run_exc(run_id, exc)
            raise

    async def stream(
        self,
        prompt: str | list[ContentPart],
        *,
        message_history: list[ModelMessage] | None = None,
        deps: dict[str, Any] | None = None,
        route: str = "run",
        timeout: float | None = None,
        priority: "str | None" = None,
    ) -> "AsyncIterator[Any]":
        """Stream a run's step events live, ending with the typed result:
        ``start()`` + ``handle.stream()`` under one run id.  (The JAX
        package's in-flight failover of a fleet-routed stream comes with
        the fleet router, ROADMAP Queue 1.)"""
        client = self._client
        run_id = new_id()
        handle = await self.start(
            prompt, message_history=message_history, deps=deps,
            route=route, timeout=timeout, run_id=run_id,
            priority=priority,
        )
        try:
            async for item in handle.stream():
                step = getattr(item, "step", None)
                if step is not None and getattr(step, "kind", "") == "token":
                    client.run_ledger.add_tokens(
                        run_id, handle.correlation_id, 1
                    )
                yield item
        except BaseException as exc:
            client._finish_run_exc(run_id, exc)
            raise
        client._finish_run_soon(run_id, outcome="ok")
