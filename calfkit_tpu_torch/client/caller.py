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
from typing import TYPE_CHECKING, Any, AsyncIterator, Callable, Generic, TypeVar

from calfkit_tpu_torch import cancellation, protocol
from calfkit_tpu_torch.exceptions import (
    RETRIABLE_FAULT_TYPES,
    ClientClosedError,
    ClientTimeoutError,
    NodeFaultError,
)
from calfkit_tpu_torch.models.error_report import ErrorReport, FaultTypes

if TYPE_CHECKING:  # pragma: no cover
    from calfkit_tpu_torch.fleet.failover import FailoverPolicy, StreamLedger
    from calfkit_tpu_torch.models.step import StepEvent
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
        router: Any = None,  # FleetRouter | policy name | None
        failover: "FailoverPolicy | None" = None,
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
        # opt-in fleet routing: a FleetRouter (or a policy name
        # — "least-loaded" / "p2c" / "prefix-affinity" — that builds one
        # over this client's transport) replaces the hardcoded shared
        # agent topic with a per-call replica placement; None = the
        # pre-fleet behavior (shared topic, consumer-group balancing).
        # The router's lifecycle is owned here: close() stops it.
        if isinstance(router, str):
            from calfkit_tpu_torch.fleet import FleetRouter

            router = FleetRouter(mesh, router)
        self.router = router
        # opt-in in-flight failure recovery: with a router AND a
        # FailoverPolicy, execute()/stream() supervise each outstanding
        # placement against the dead-placement law and re-dispatch (fresh
        # correlation id, remaining deadline, dead replica excluded, old
        # correlation cancel-tombstoned) when the placed replica dies
        # mid-run.  None = calls ride their placement to the caller's
        # timeout, the older behavior.
        self.failover = failover
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
        failover: "FailoverPolicy | None" = None,
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
        if self.router is not None:
            # the router's registry holds a table reader on this client's
            # transport: stop it before the transport goes away
            with contextlib.suppress(Exception):
                await self.router.stop()
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

    # the affinity key only ever reads the page-aligned head (64-char
    # pages × 4 max pages — see fleet/policy.py); collecting more would
    # copy a whole long-history prompt per routed call for nothing
    _AFFINITY_TEXT_CAP = 256

    @classmethod
    def _prompt_text(cls, parts: list[ContentPart]) -> str:
        """The prompt's text-projection HEAD, for affinity hashing only."""
        out: list[str] = []
        length = 0
        for p in parts:
            text = getattr(p, "text", "") or ""
            if not text:
                continue
            out.append(text[: cls._AFFINITY_TEXT_CAP - length])
            length += len(out[-1])
            if length >= cls._AFFINITY_TEXT_CAP:
                break
        return "".join(out)

    async def _route_topic(
        self,
        parts: list[ContentPart],
        correlation_id: str,
        exclude_replicas: "frozenset[str]",
    ) -> "tuple[str, Any]":
        """The engine/topic-selection seam: with a fleet
        router on the client, each call is placed on a specific
        replica's addressed topic; without one (or with no eligible
        replica) the shared agent topic load-balances as before.
        Returns ``(topic, Replica | None)``."""
        router = self._client.router
        if router is None:
            return self.input_topic, None
        route = await router.route(
            self.name,
            prompt_text=self._prompt_text(parts),
            correlation_id=correlation_id,
            exclude=exclude_replicas,
        )
        return route.topic, route.replica

    async def start(
        self,
        prompt: str | list[ContentPart],
        *,
        message_history: list[ModelMessage] | None = None,
        deps: dict[str, Any] | None = None,
        route: str = "run",
        timeout: float | None = None,
        exclude_replicas: "frozenset[str]" = frozenset(),
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

        ``exclude_replicas`` (fleet-routed clients only) bars specific
        replica instances from this placement — the shed-retry loop in
        :meth:`execute` passes the instances that already refused.  The
        placement lands on ``handle.routed_replica`` /
        ``handle.routed_replica_key`` (None = shared topic).  ``mark``
        stamps the call's ``x-mesh-attempt`` header ("failover" |
        "hedge") so the serving replica's advert counts
        recovery arrivals.

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
        # place BEFORE minting the deadline: the first routed call may
        # pay the registry's table catch-up (seconds on a slow broker),
        # and that setup cost must not be charged against the caller's
        # serving budget — an expired-at-publish call would fault
        # non-retriable DeadlineExceeded for work that never started
        target_topic, routed = await self._route_topic(
            parts, correlation_id, exclude_replicas
        )
        routed_replica = routed.instance_id if routed is not None else None
        now = cancellation.wall_clock()
        deadline = (
            now + effective_timeout if effective_timeout is not None else None
        )

        async def publish_cancel() -> None:
            # the cancel follows the CALL's placement: a replica-routed
            # run is abandoned on the replica's topic
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
        handle.routed_replica = routed_replica
        handle.routed_replica_key = routed.key if routed is not None else None
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
            placement=routed.key if routed is not None else "",
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
        router = client.router if routed is not None else None
        if router is not None:
            # least-request accounting, keyed by the FULL replica key
            # (instance ids may be operator-pinned and collide across
            # agents): the router counts this run against the replica
            # until its terminal reply lands (TTL sweep covers terminals
            # that never arrive)
            replica_key = routed.key
            router.note_dispatch(replica_key, correlation_id)
            channel.terminal.add_done_callback(
                lambda _f, r=router, k=replica_key, c=correlation_id: (
                    r.note_done(k, c)
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
            if router is not None:
                router.note_done(routed.key, correlation_id)
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
        failover: "FailoverPolicy | None" = None,
        priority: "str | None" = None,
    ) -> InvocationResult[OutputT]:
        """Run to a typed result.  With a :class:`RetryPolicy` (here or on
        the client), faults typed retriable — overload sheds, draining
        workers — are retried with jittered exponential backoff; each
        retry is a FRESH run (new correlation id, new deadline).  Timeouts
        and non-retriable faults surface immediately.

        Fleet-routed clients retry ``mesh.overloaded`` sheds against a
        DIFFERENT replica: the shed source's instance id is excluded from
        every subsequent attempt's placement, so a retry storm
        spreads across the fleet instead of hammering the replica that
        just refused.

        With a :class:`~calfkit_tpu_torch.fleet.failover.FailoverPolicy` (here
        or on the client) on a fleet-routed client, the call is
        additionally SUPERVISED in flight: the placed replica's
        health is probed while awaiting the terminal, a dead placement
        (heartbeat lapsed, advert gone, unready without drain) is
        re-dispatched to a surviving replica under the REMAINING deadline
        with the old correlation cancel-tombstoned, and an optional
        ``hedge_after`` races a duplicate on a second replica — first
        terminal wins, the loser is cancelled."""
        policy = retry if retry is not None else self._client.retry
        fo = failover if failover is not None else self._client.failover
        client = self._client
        # run identity: ONE run id for the whole logical call
        # — every retry/failover/hedge placement below records into the
        # same ledger entry and carries the same x-mesh-run header
        run_id = new_id()
        if fo is not None and client.router is not None:
            try:
                result = await self._execute_failover(
                    prompt,
                    message_history=message_history,
                    deps=deps,
                    route=route,
                    timeout=timeout,
                    policy=policy,
                    failover=fo,
                    run_id=run_id,
                    priority=priority,
                )
            except BaseException as exc:
                client._finish_run_exc(run_id, exc)
                raise
            client._finish_run_soon(run_id, outcome="ok")
            return result
        attempts = policy.attempts if policy is not None else 1
        last: BaseException | None = None
        shed_sources: set[str] = set()
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
                    exclude_replicas=frozenset(shed_sources),
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
                    if handle.routed_replica is not None:
                        # EVERY retriable fault excludes the replica that
                        # produced it, not just sheds: a hung replica
                        # faulting mesh.timeout would otherwise be re-picked
                        # deterministically (affinity re-homes there;
                        # fail-fast keeps it the least-loaded minimum) while
                        # a healthy replica sits idle
                        shed_sources.add(handle.routed_replica)
                    continue
                client._finish_run_soon(run_id, outcome="ok")
                return result
            assert last is not None
            raise last
        except BaseException as exc:
            client._finish_run_exc(run_id, exc)
            raise

    # ================================================== failure recovery
    # (laws in calfkit_tpu_torch/fleet/failover.py, docs/robustness.md
    # "Failure recovery")

    @staticmethod
    async def _first_terminal(
        handles: "list[InvocationHandle]", timeout: float
    ) -> "InvocationHandle | None":
        """Park until the FIRST of ``handles`` lands a terminal, or
        ``timeout`` (one probe tick) elapses — whichever is sooner.
        Returns the finished handle, or None on a quiet tick.

        ``timeout <= 0`` is the busy-poll mode (the fleet simulator's
        deterministic probing: a yield, not a timer) — one bare
        event-loop yield instead of waiter-task churn, because hundreds
        of outstanding supervised calls each allocating tasks per tick
        is the difference between a simulation step and a stall."""
        for handle in handles:
            if handle.terminal_arrived:
                return handle
        if timeout is not None and timeout <= 0:
            await asyncio.sleep(0)
            for handle in handles:
                if handle.terminal_arrived:
                    return handle
            return None
        waiters = [
            asyncio.ensure_future(h.wait(timeout)) for h in handles
        ]
        try:
            await asyncio.wait(waiters, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for w in waiters:
                w.cancel()
        for handle in handles:
            if handle.terminal_arrived:
                return handle
        return None

    async def _await_placement(
        self,
        exclude: "frozenset[str]",
        *,
        probe_interval: float,
        remaining: "Callable[[], float | None]",
    ) -> None:
        """Park until the router can place a call on SOME eligible
        replica outside ``exclude`` (a dead fleet usually means one
        heartbeat interval of waiting — a replica re-advertises or a
        fresh one boots), bounded by the remaining budget."""
        router = self._client.router
        while router.select(self.name, exclude=exclude) is None:
            rem = remaining()
            if rem is not None and rem <= 0:
                raise ClientTimeoutError(
                    "no eligible replica for the failover re-dispatch "
                    "within the remaining budget"
                )
            await asyncio.sleep(
                probe_interval if rem is None else min(probe_interval, rem)
            )

    def _no_placement_fault(self, reason: str) -> NodeFaultError:
        """The typed, RETRIABLE fault raised when a run keeps losing its
        placements past the failover budget: the fleet cannot currently
        hold this call — the caller may back off and try again."""
        return NodeFaultError(
            ErrorReport.build_safe(
                FaultTypes.CAPABILITY_UNAVAILABLE,
                f"run lost its placement ({reason}) and the failover "
                "budget is spent; the fleet cannot hold this call "
                "right now",
            )
        )

    async def _execute_failover(
        self,
        prompt: str | list[ContentPart],
        *,
        message_history: list[ModelMessage] | None,
        deps: dict[str, Any] | None,
        route: str,
        timeout: float | None,
        policy: "RetryPolicy | None",
        failover: "FailoverPolicy",
        run_id: "str | None" = None,
        priority: "str | None" = None,
    ) -> InvocationResult[OutputT]:
        """The supervised execute: one absolute budget, N placements.

        The loop holds one PRIMARY handle (plus at most one HEDGE) and
        alternates between waiting for a terminal and probing each
        outstanding placement against the dead-placement law.  Every
        re-dispatch runs under the REMAINING budget (the mesh deadline is
        absolute), a fresh correlation id, and the accumulated exclusion
        set (shed sources AND dead replicas — one set, so a failover
        never re-picks a replica that already refused, and a shed retry
        never lands on a corpse)."""
        client = self._client
        router = client.router
        effective = timeout if timeout is not None else client.default_timeout
        deadline = (
            cancellation.wall_clock() + effective
            if effective is not None else None
        )
        exclude: set[str] = set()
        failovers = 0
        fault_attempts = 1  # terminals consumed (the original counts)
        max_fault_attempts = max(1, policy.attempts) if policy else 1
        run_id = run_id or new_id()
        attempt_no = 0  # ledger attempt counter (every placement)

        def remaining() -> "float | None":
            if deadline is None:
                return None
            return deadline - cancellation.wall_clock()

        async def dispatch(
            mark: "str | None",
            extra_exclude: "frozenset[str]" = frozenset(),
        ) -> InvocationHandle[OutputT]:
            rem = remaining()
            if rem is not None and rem <= 0:
                raise ClientTimeoutError(
                    f"budget spent after {failovers} failover(s); "
                    "no terminal reply"
                )
            if mark is not None:
                # a failover/hedge re-dispatch must NOT fail open to the
                # shared topic: the shared consumer group may still count
                # the corpse as a member (a dead consumer holds its
                # partitions until the broker's session timeout), which is
                # exactly the blackhole failover exists to escape.  Wait —
                # within the remaining budget — for an eligible replica.
                await self._await_placement(
                    frozenset(exclude | set(extra_exclude)),
                    probe_interval=failover.probe_interval,
                    remaining=remaining,
                )
            nonlocal attempt_no
            # the ledger marker: the wire mark where one exists
            # ("failover"/"hedge"), else first vs plain-retry
            kind = (
                mark
                if mark is not None
                else ("first" if attempt_no == 0 else "retry")
            )
            handle = await self.start(
                prompt,
                message_history=message_history,
                deps=deps,
                route=route,
                timeout=remaining(),
                exclude_replicas=frozenset(exclude | set(extra_exclude)),
                mark=mark,
                run_id=run_id,
                attempt_no=attempt_no,
                attempt_kind=kind,
                priority=priority,
            )
            attempt_no += 1
            return handle

        primary = await dispatch(None)
        dispatched_at = cancellation.wall_clock()
        hedge: "InvocationHandle[OutputT] | None" = None
        hedged = False  # at most one hedge per call

        while True:
            live = [h for h in (primary, hedge) if h is not None]
            winner = await self._first_terminal(live, failover.probe_interval)

            if winner is not None:
                loser = hedge if winner is primary else primary
                try:
                    result = await winner.result()
                except NodeFaultError as exc:
                    if policy is None or not RetryPolicy.retriable(exc):
                        if loser is not None and loser is not winner:
                            await loser.cancel()
                            client._note_attempt_superseded(
                                run_id, loser, "hedge_lost"
                            )
                        raise
                    if winner.routed_replica is not None:
                        exclude.add(winner.routed_replica)
                    if loser is not None and loser is not winner:
                        # the duplicate may still answer: promote it and
                        # keep supervising instead of burning a retry
                        primary, hedge = loser, None
                        continue
                    fault_attempts += 1
                    if fault_attempts > max_fault_attempts:
                        raise
                    await asyncio.sleep(policy.delay(fault_attempts - 2))
                    primary = await dispatch(None)
                    dispatched_at = cancellation.wall_clock()
                    hedge = None
                    continue
                if loser is not None and loser is not winner:
                    # first terminal wins: cancel the duplicate through
                    # the ordinary cancel propagation (tombstone included
                    # — a zombie cannot execute the losing correlation)
                    await loser.cancel()
                    client._note_attempt_superseded(
                        run_id, loser, "hedge_lost"
                    )
                return result

            # ---- quiet probe tick: budget, then placement health
            rem = remaining()
            if rem is not None and rem <= 0:
                for h in live:
                    h._cancel_soon()
                raise ClientTimeoutError(
                    f"run produced no terminal reply within {effective}s "
                    f"({failovers} failover(s) attempted)"
                )
            if hedge is not None and hedge.routed_replica_key is not None:
                hedge_verdict = router.placement_verdict(
                    hedge.routed_replica_key
                )
                if hedge_verdict != "alive":
                    # a dead hedge is simply dropped (and its correlation
                    # tombstoned) — the primary is still supervised
                    if hedge.routed_replica is not None:
                        exclude.add(hedge.routed_replica)
                    await hedge.cancel()
                    client._note_attempt_superseded(
                        run_id, hedge, hedge_verdict
                    )
                    # uncharge the corpse NOW: its terminal can never
                    # arrive, so the done-callback that normally clears
                    # the router's least-request entry never fires — the
                    # phantom in-flight would bias placement away from
                    # the replica for the whole TTL after it heals
                    router.note_done(
                        hedge.routed_replica_key, hedge.correlation_id
                    )
                    hedge = None
            if primary.routed_replica_key is not None:
                verdict = router.placement_verdict(primary.routed_replica_key)
                if verdict != "alive":
                    # dead placement: tombstone the orphaned correlation
                    # FIRST (a zombie that resumes consuming must fault
                    # the old call at its admission gate), then exclude
                    # the corpse and re-dispatch under what's left
                    if primary.routed_replica is not None:
                        exclude.add(primary.routed_replica)
                    await primary.cancel()
                    client._note_attempt_superseded(
                        run_id, primary, verdict
                    )
                    # uncharge the corpse (see the dead-hedge branch):
                    # no terminal will ever clear this entry, and a
                    # healed replica must not carry phantom load.
                    # note_done is pop-idempotent, so a zombie that DOES
                    # later publish a terminal double-clears harmlessly.
                    router.note_done(
                        primary.routed_replica_key, primary.correlation_id
                    )
                    if hedge is not None:
                        # the duplicate is already running elsewhere:
                        # promote it instead of spending a failover
                        primary, hedge = hedge, None
                        dispatched_at = cancellation.wall_clock()
                        continue
                    failovers += 1
                    if failovers > failover.max_failovers:
                        raise self._no_placement_fault(verdict)
                    primary = await dispatch("failover")
                    dispatched_at = cancellation.wall_clock()
                    continue
            # ---- tail-latency hedge (execute() only): race a duplicate
            if (
                not hedged
                and failover.hedge_after is not None
                and cancellation.wall_clock() - dispatched_at
                >= failover.hedge_after
                and primary.routed_replica is not None
                and router.select(
                    self.name,
                    exclude=frozenset(exclude | {primary.routed_replica}),
                ) is not None
            ):
                hedged = True
                hedge = await dispatch(
                    "hedge",
                    extra_exclude=frozenset({primary.routed_replica}),
                )

    def _filter_step(
        self, event: "StepEvent", ledger: "StreamLedger"
    ) -> "StepEvent | None":
        """Apply the stream-resume dedupe law to one step event: token
        steps pass through the ledger (suppressing the replayed prefix
        after a failover); None = fully-replayed, drop it.  Offset-
        stamped steps align the ledger exactly — a resumed
        attempt's first chunk arrives at the delivered-prefix offset and
        passes through whole.  Non-token steps pass through unchanged —
        they carry no offsets to dedupe on, so a failover may repeat
        them (documented)."""
        step = event.step
        if getattr(step, "kind", "") != "token":
            return event
        text = ledger.filter(step.text, getattr(step, "offset", None))
        if not text:
            return None
        if text != step.text:
            return event.model_copy(
                update={"step": step.model_copy(update={"text": text})}
            )
        return event

    async def stream(
        self,
        prompt: str | list[ContentPart],
        *,
        message_history: list[ModelMessage] | None = None,
        deps: dict[str, Any] | None = None,
        route: str = "run",
        timeout: float | None = None,
        failover: "FailoverPolicy | None" = None,
        priority: "str | None" = None,
    ) -> "AsyncIterator[Any]":
        """Stream a run's step events live, ending with the typed result
        — ``handle.stream()`` with in-flight failure recovery.

        On a fleet-routed client with a FailoverPolicy, the placement is
        supervised while streaming: when the placed replica dies
        mid-stream (or faults typed-retriable), the call is re-issued as
        a continuation on a surviving replica — same prompt (it rides
        the prefix cache there), remaining deadline, old correlation
        cancel-tombstoned, ``deps["calfkit.resume_text"]`` carrying the
        already-delivered text — and the replayed token prefix is
        suppressed so the caller observes ONE contiguous stream (the
        :class:`~calfkit_tpu_torch.fleet.failover.StreamLedger` law).  Without
        a policy (or a router) this is plain ``start()+stream()``."""
        client = self._client
        fo = failover if failover is not None else client.failover
        if fo is None or client.router is None:
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
            return
        from calfkit_tpu_torch.fleet.failover import StreamLedger

        router = client.router
        ledger = StreamLedger()
        effective = timeout if timeout is not None else client.default_timeout
        deadline = (
            cancellation.wall_clock() + effective
            if effective is not None else None
        )

        def remaining() -> "float | None":
            if deadline is None:
                return None
            return deadline - cancellation.wall_clock()

        exclude: set[str] = set()
        failovers = 0
        # run identity: ONE run id across the original
        # placement and every failover/resume re-dispatch below — the
        # whole try/except boundary closes the run with the outcome the
        # CALLER observed (ok / timeout / fault / cancelled)
        run_id = new_id()
        attempt_no = 0
        # decode-from-offset resume is a SINGLE-TURN contract: the hint
        # seeds the re-attempt's first model turn, so a run that already
        # dispatched tool calls (its delivered text spans turns) must
        # replay wholly instead — the ledger's cumulative law keeps the
        # stream contiguous either way
        multi_turn = False
        try:
            handle = await self.start(
                prompt, message_history=message_history, deps=deps,
                route=route, timeout=effective,
                run_id=run_id, attempt_no=attempt_no, attempt_kind="first",
                priority=priority,
            )
            attempt_no += 1
            while True:
                dead_reason: "str | None" = None
                pending_exc: "NodeFaultError | None" = None
                channel = handle._channel
                step_task: asyncio.Task = asyncio.ensure_future(
                    channel.steps.get()
                )
                try:
                    while dead_reason is None:
                        rem = remaining()
                        if rem is not None and rem <= 0:
                            handle._cancel_soon()
                            raise ClientTimeoutError(
                                f"stream produced no terminal within "
                                f"{effective}s ({failovers} failover(s))"
                            )
                        tick = (
                            fo.probe_interval if rem is None
                            else min(fo.probe_interval, rem)
                        )
                        done, _ = await asyncio.wait(
                            [step_task, channel.terminal],
                            timeout=tick,
                            return_when=asyncio.FIRST_COMPLETED,
                        )
                        if step_task in done:
                            raw = step_task.result()
                            if getattr(raw.step, "kind", "") in (
                                "tool_call", "tool_result", "handoff"
                            ):
                                multi_turn = True
                            event = self._filter_step(raw, ledger)
                            if event is not None:
                                if getattr(event.step, "kind", "") == "token":
                                    # delivered (post-dedupe) tokens only:
                                    # a replayed prefix never double-counts
                                    client.run_ledger.add_tokens(
                                        run_id, handle.correlation_id, 1
                                    )
                                yield event
                            step_task = asyncio.ensure_future(
                                channel.steps.get()
                            )
                            continue
                        if channel.terminal.done():
                            while not channel.steps.empty():
                                event = self._filter_step(
                                    channel.steps.get_nowait(), ledger
                                )
                                if event is not None:
                                    if getattr(event.step, "kind", "") == "token":
                                        client.run_ledger.add_tokens(
                                            run_id, handle.correlation_id, 1
                                        )
                                    yield event
                            try:
                                final = await handle.result()
                            except NodeFaultError as exc:
                                if not RetryPolicy.retriable(exc):
                                    raise
                                # a retriable fault ends THIS attempt, not
                                # the stream: re-dispatch and resume
                                dead_reason = (
                                    f"fault:{exc.report.error_type}"
                                )
                                pending_exc = exc
                                continue
                            yield final
                            client._finish_run_soon(run_id, outcome="ok")
                            return
                        # quiet tick: probe the placement
                        if handle.routed_replica_key is not None:
                            verdict = router.placement_verdict(
                                handle.routed_replica_key
                            )
                            if verdict != "alive":
                                dead_reason = verdict
                finally:
                    step_task.cancel()
                # ---- failover re-dispatch (dead placement / retriable fault)
                failovers += 1
                if failovers > fo.max_failovers:
                    if pending_exc is not None:
                        raise pending_exc
                    raise self._no_placement_fault(dead_reason or "unknown")
                if handle.routed_replica is not None:
                    exclude.add(handle.routed_replica)
                # tombstone the orphan BEFORE the replacement publishes: a
                # zombie that resumes consuming faults the old correlation
                # at its admission gate instead of executing it
                await handle.cancel()
                # ledger verdict for the abandoned attempt (first signal
                # wins: a fault that already landed keeps its outcome)
                client._note_attempt_superseded(
                    run_id, handle, dead_reason or "superseded"
                )
                ledger.begin_attempt()
                rem = remaining()
                if rem is not None and rem <= 0:
                    if pending_exc is not None:
                        raise pending_exc
                    raise ClientTimeoutError(
                        f"stream placement died ({dead_reason}) with no "
                        "budget left to re-dispatch"
                    )
                if pending_exc is None:
                    # DEATH re-dispatch: never fail open to the shared topic
                    # — the shared group may still count the corpse as a
                    # member — wait for an eligible replica instead
                    await self._await_placement(
                        frozenset(exclude),
                        probe_interval=fo.probe_interval,
                        remaining=remaining,
                    )
                else:
                    # FAULT re-dispatch: the replica is alive and answering
                    # (it shed/wedged us, typed) — a brief backoff, then
                    # fail-open placement is SAFE and required: on a fleet
                    # with no alternative replica, waiting on the exclusion
                    # set would burn the whole deadline for a transient shed
                    # that the shared topic (or the same replica, recovered)
                    # can absorb in milliseconds
                    rem = remaining()
                    await asyncio.sleep(
                        fo.probe_interval if rem is None
                        else min(fo.probe_interval, max(rem, 0.0))
                    )
                resume_deps = dict(deps or {})
                if ledger.text and not multi_turn:
                    # the continuation hint: prompt + already-delivered text.
                    # The agent's first model turn CONSUMES it (decode-from-
                    # offset); multi-turn runs omit it — delivered
                    # text spanning tool-call turns would corrupt the first
                    # turn's continuation — and replay wholly instead (the
                    # dedupe ledger guarantees contiguity either way)
                    resume_deps["calfkit.resume_text"] = ledger.text
                handle = await self.start(
                    prompt,
                    message_history=message_history,
                    deps=resume_deps,
                    route=route,
                    timeout=remaining(),
                    exclude_replicas=frozenset(exclude),
                    mark="failover",
                    run_id=run_id,
                    attempt_no=attempt_no,
                    # the ledger distinguishes a decode-from-offset
                    # resume from a whole-replay failover; the wire mark
                    # stays "failover" (x-mesh-attempt vocabulary)
                    attempt_kind=(
                        "resume"
                        if "calfkit.resume_text" in resume_deps
                        else "failover"
                    ),
                    priority=priority,
                )
                attempt_no += 1
        except BaseException as exc:
            client._finish_run_exc(run_id, exc)
            raise
