"""The node kernel: the staged per-delivery pipeline every node kind shares.

Pipeline (reference: calfkit/nodes/base.py:244-2094, restructured, not
ported):

    stage 0   decode floor + classify (call / return / fault / reentry)
    stage 1   aggregation — returns & faults resolve against the pending
              call: on_callee_error seams, durable fan-out fold/close
    stage 2   before_node seam chain
    stage 3   routed body (chain-of-responsibility over @handler patterns)
    stage 4   after_node seam chain
    stage 5   publish chokepoint (Call push / ReturnCall unwind / TailCall
              retarget) + fan-out OPEN
    exit      step-ledger flush (once) + broadcast mirror

Fault rail invariants preserved from the reference:

- **No silent drops**: every failure lands a typed FaultMessage to the
  caller, or a floor log when there is no caller; a reply-owing delivery
  declined by every handler auto-faults (``mesh.declined``).
- **Mint rule**: user code raises :class:`NodeFaultError` to emit a typed
  fault; any other exception is harvested into a ``mesh.node_error`` report
  after the ``on_node_error`` chain gets a recovery chance.
- **Escalation ladder**: an oversized fault degrades full → no-tracebacks →
  minimal+state-elided rather than dropping (base.py:838-905 analog).
- **Single-writer**: every publish is keyed by ``partition_key(task_id)``.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, ClassVar, Sequence


from calfkit_tpu_torch import cancellation, leases, protocol, qos
from calfkit_tpu_torch.exceptions import NodeFaultError, error_type_for
from calfkit_tpu_torch.keying import partition_key
from calfkit_tpu_torch.mesh.transport import MeshTransport, Record
from calfkit_tpu_torch.models._wire import ValidationError
from calfkit_tpu_torch.models.actions import Call, Next, NodeResult, ReturnCall, TailCall
from calfkit_tpu_torch.models.error_report import ErrorReport, FaultTypes
from calfkit_tpu_torch.models.fanout import (
    EnvelopeSnapshot,
    FanoutOpen,
    FanoutOutcome,
    SlotRef,
)
from calfkit_tpu_torch.models.marker import CallMarker, ToolCallMarker
from calfkit_tpu_torch.models.messages import RetryPart, ToolReturnPart
from calfkit_tpu_torch.models.payload import ContentPart, is_retry, render_parts_as_text
from calfkit_tpu_torch.models.reply import FaultMessage, ReturnMessage
from calfkit_tpu_torch.models.session_context import CallFrame, Envelope, new_id
from calfkit_tpu_torch.models.state import State
from calfkit_tpu_torch.nodes.fanout_store import (
    FANOUT_STORE_KEY,
    FanoutBatchStore,
    classify_sibling,
    record_outcome,
)
from calfkit_tpu_torch.nodes.registry import RegistryMixin, handler  # noqa: F401 (re-export)
from calfkit_tpu_torch.nodes.seams import (
    MintedFault,
    run_chain,
    run_chain_guarded,
    validate_seam_arity,
)
from calfkit_tpu_torch.nodes.steps import HopStepLedger, Observed

logger = logging.getLogger(__name__)

# mirror of controlplane.plane.CALLER_LIVENESS_FEED_KEY (the
# capability_view/agents_view mirrored-constant pattern — no import
# cycle): truthy once the worker's caller-liveness feed is consuming;
# the kernel only ENFORCES leases where beats can actually arrive
CALLER_LIVENESS_FEED_KEY = "caller_liveness_feed"

# node-resource key for the per-tenant admission token bucket
#: a qos.TenantRateLimiter; absent or disabled = no limiting
QOS_LIMITER_KEY = "qos_limiter"

_REENTRY_KEY = "fanout_reentry"

# aggregation outcomes
_HANDLED = "handled"
_RESUME = "resume"


def _as_recovery_parts(recovery: Any) -> list:
    """Coerce an on_callee_error/on_tool_error recovery into content parts.

    The documented sugar accepts a plain string ('answer from memory'), a
    part, or a list of parts (reference: nodes/_tool_error.py — seam
    returns become the slot's substitute value the model sees)."""
    from calfkit_tpu_torch.models.payload import DataPart, TextPart

    def one(p: Any) -> Any:
        if isinstance(p, str):
            return TextPart(text=p)
        if isinstance(p, dict):
            return DataPart(data=p)
        return p

    if isinstance(recovery, list):
        return [one(p) for p in recovery]
    return [one(recovery)]


def _as_action(value: Any) -> NodeResult:
    """Coerce a seam-returned value into a publishable action.

    Bodies return NodeResults; seams may return plain values (a canned
    string, a dict) — wrap those in a ReturnCall so a short-circuit or an
    after_node replacement can never silently fall through the publish
    chokepoint."""
    if isinstance(value, (Call, TailCall, ReturnCall, Next, list)):
        return value
    from calfkit_tpu_torch.models.payload import DataPart, TextPart

    if isinstance(value, str):
        return ReturnCall(parts=[TextPart(text=value)])
    if isinstance(value, dict):
        return ReturnCall(parts=[DataPart(data=value)])
    # anything else is almost certainly an accidental return from a seam
    # written for observe-only semantics (e.g. a trailing setdefault) —
    # fail loudly instead of publishing its repr as the agent's answer
    raise TypeError(
        "a seam returned an unpublishable value "
        f"({type(value).__name__}); return a NodeResult, str, dict, or None"
    )


@dataclass
class NodeRunContext:
    """What the body and seams see for one delivery."""

    node: "BaseNodeDef"
    envelope: Envelope
    route: str
    delivery_kind: str
    correlation_id: str | None
    task_id: str
    ledger: HopStepLedger
    headers: dict[str, str] = field(default_factory=dict)
    # the resolved callee outcome for return/fault resumptions
    folded: FanoutOutcome | None = None
    # the marker of the reply currently being resolved (set during stage-1
    # aggregation so on_callee_error sugar can see which call faulted)
    folding_marker: Any = None
    # the broadcast mirror fires at most once per hop
    mirrored: bool = False
    # captured at stage 0: the run's step-stream destination survives the
    # frame unwind that a ReturnCall performs before flush time
    root_topic: str | None = None
    # this hop's trace context (the HOP SPAN's id): forwarded in every
    # outgoing record's headers so downstream hops parent to this hop
    trace: Any = None  # TraceContext | None
    # set by _publish_fault so the hop span can record error status
    fault_error_type: str | None = None

    @property
    def state(self) -> State:
        return self.envelope.context.state

    @property
    def deps(self) -> dict[str, Any]:
        return self.envelope.context.deps

    @property
    def frame(self) -> CallFrame | None:
        return self.envelope.workflow.current()

    @property
    def payload(self) -> list[ContentPart]:
        frame = self.frame
        return frame.payload if frame else []

    def resource(self, key: str) -> Any:
        return self.node.resources.get(key)


class BaseNodeDef(RegistryMixin):
    kind: ClassVar[str] = "node"

    def __init__(
        self,
        name: str,
        *,
        before_node: Sequence[Any] = (),
        after_node: Sequence[Any] = (),
        on_node_error: Sequence[Any] = (),
        on_callee_error: Sequence[Any] = (),
        instance_id: "str | None" = None,
    ):
        protocol.require_topic_safe(name, what="node name")
        self.name = name
        # per-boot random by default.  Operators deploying replica fleets
        # on clusters where topics must PRE-exist (provisioning disabled,
        # ACL-restricted admin) pin a stable id per replica ("r0", "r1",
        # …) so the replica-addressed topic is knowable ahead of boot and
        # survives restarts; the control-plane key stays <name>@<id>.
        if instance_id is not None:
            protocol.require_topic_safe(instance_id, what="instance_id")
        self.instance_id = instance_id or uuid.uuid4().hex[:12]
        for seam in before_node:
            validate_seam_arity(seam, 1, name="before_node")
        for seam in after_node:
            validate_seam_arity(seam, 2, name="after_node")
        for seam in on_node_error:
            validate_seam_arity(seam, 2, name="on_node_error")
        for seam in on_callee_error:
            validate_seam_arity(seam, 2, name="on_callee_error")
        self.before_node = list(before_node)
        self.after_node = list(after_node)
        self.on_node_error = list(on_node_error)
        self.on_callee_error = list(on_callee_error)
        self.resources: dict[str, Any] = {}
        self._transport: MeshTransport | None = None
        # in-flight background publishes (span exports, cancel forwards)
        self._span_tasks: "set[Any]" = set()
        # cancel forwarding: topics this kernel published CALLS
        # to, per correlation id, so _handle_cancel can re-publish the
        # cancel along the run's path — an engine in ANOTHER process
        # (behind a downstream topic) is unreachable through the
        # in-process registry alone.  Bounded LRU; entries are advisory
        # (a stale forward to a finished child fans out to nothing), so
        # eviction never costs correctness.
        self._downstream_calls: "OrderedDict[str, set[str]]" = OrderedDict()

    # ------------------------------------------------------------ identity
    @property
    def node_id(self) -> str:
        return f"{self.kind}.{self.name}"

    @property
    def emitter(self) -> str:
        return protocol.emitter_header(self.kind, self.name)

    def input_topics(self) -> list[str]:
        raise NotImplementedError

    def return_topic(self) -> str:
        raise NotImplementedError

    def publish_topic(self) -> str | None:
        return None

    def all_topics(self) -> list[str]:
        topics = list(self.input_topics()) + [self.return_topic()]
        pub = self.publish_topic()
        if pub:
            topics.append(pub)
        return topics

    # ------------------------------------------------------------- binding
    def bind(self, transport: MeshTransport) -> None:
        self._transport = transport

    @property
    def transport(self) -> MeshTransport:
        if self._transport is None:
            raise RuntimeError(f"node {self.node_id} is not bound to a transport")
        return self._transport

    @property
    def fanout_store(self) -> FanoutBatchStore | None:
        return self.resources.get(FANOUT_STORE_KEY)

    # =====================================================================
    # entrypoint
    # =====================================================================
    async def handler(self, record: Record) -> None:
        """The transport-facing entrypoint (one delivery, one hop)."""
        try:
            await self._handle_delivery(record)
        except Exception:  # noqa: BLE001 - absolute floor: never kill the lane
            logger.exception(
                "[%s] delivery pipeline escaped its fault rail on %s",
                self.node_id,
                record.topic,
            )

    async def _handle_delivery(self, record: Record) -> None:
        headers = record.headers
        if headers.get(protocol.HDR_KIND) == "cancel":
            # a cancel record is pure headers (no envelope body): fan it
            # out to every in-process cancellation target (engines) so a
            # dead caller's in-flight work is abandoned, then stop — there
            # is nothing to execute and no reply owed
            self._handle_cancel(headers)
            return
        if not protocol.is_envelope(headers):
            return  # step/other wire kinds are not for the kernel
        try:
            envelope = Envelope.from_wire(record.value)
        except (ValidationError, ValueError):
            # decode floor: no frame to fault against — loud, then drop
            logger.error(
                "[%s] undecodable envelope on %s (%d bytes): dropped",
                self.node_id,
                record.topic,
                len(record.value),
            )
            return

        correlation_id = headers.get(protocol.HDR_CORRELATION)
        task_id = headers.get(protocol.HDR_TASK) or new_id()  # ingress mint
        kind = headers.get(protocol.HDR_KIND)
        if kind not in protocol.MESSAGE_KINDS:
            kind = "return" if envelope.reply is not None else "call"

        frame = envelope.workflow.current()
        route = frame.route if frame else headers.get(protocol.HDR_ROUTE, "run")
        ctx = NodeRunContext(
            node=self,
            envelope=envelope,
            route=route,
            delivery_kind=kind,
            correlation_id=correlation_id,
            task_id=task_id,
            ledger=HopStepLedger(self.emitter),
            headers=dict(headers),
            root_topic=envelope.workflow.root_callback_topic(),
        )
        log_id = (correlation_id or task_id)[:8]

        # ---- deadline: the delivery's absolute budget rides a contextvar
        # (same channel shape as the trace) so in-process children — the
        # inference engine above all — enforce the caller's deadline
        # without per-layer budget arithmetic.  Reset in the finally.
        deadline = protocol.parse_deadline(headers.get(protocol.HDR_DEADLINE))
        deadline_token = (
            cancellation.current_deadline.set(deadline)
            if deadline is not None
            else None
        )

        # ---- caller liveness lease: recorded at admission —
        # a CLIENT-emitted call is proof the caller was alive at publish,
        # an implicit beat that grants a full TTL of grace even before
        # the liveness feed catches up (forwarded calls prove only the
        # forwarding NODE's liveness, so they don't beat).  The lease
        # rides a contextvar like the deadline, so the in-process engine
        # registers this delivery's runs for the orphan reaper.  Only
        # ENFORCED where the worker's caller-liveness feed is consuming
        # (the control plane sets the resource flag): a worker that
        # cannot receive beats must not orphan a LIVE caller's run one
        # TTL after admission — fail-safe, the pre-lease behavior.
        # ---- run identity: the x-mesh-run header rides a
        # contextvar like the deadline/lease, so the in-process engine's
        # capacity ledger attributes HBM pages to the logical RUN this
        # delivery serves (not just the per-attempt correlation id)
        from calfkit_tpu_torch.observability import capacity as _capacity

        parsed_run = protocol.parse_run(headers.get(protocol.HDR_RUN))
        run_token = (
            _capacity.current_run.set(parsed_run[0])
            if parsed_run is not None
            else None
        )

        lease = protocol.parse_lease(headers.get(protocol.HDR_LEASE))
        lease_token = None
        if lease is not None and self.resources.get(CALLER_LIVENESS_FEED_KEY):
            if kind == "call":
                emitter_kind, _ = protocol.parse_emitter(
                    headers.get(protocol.HDR_EMITTER)
                )
                if emitter_kind == "client":
                    leases.note_admission(*lease)
            lease_token = leases.current_lease.set(lease)

        # ---- priority class: rides a contextvar like the
        # deadline/lease, so the in-process engine's class-aware shed and
        # reap ordering see the caller's class with no per-layer
        # plumbing.  A corrupt header parses to None and the contextvar
        # stays at its default — readers resolve that to the DEFAULT
        # class; delivery never faults (the header-degradation law).
        priority = protocol.parse_priority(headers.get(protocol.HDR_PRIORITY))
        priority_token = (
            qos.current_priority.set(priority)
            if priority is not None
            else None
        )

        # ---- tracing: one HOP SPAN per traced delivery.  A missing trace
        # header is legal (pre-trace emitters, external producers) — the
        # hop simply runs untraced.  Everything here is fail-open.
        from calfkit_tpu_torch.observability import trace as _trace

        hop_span = None
        sink: list[Any] = []
        sink_token = ctx_token = None
        remote = _trace.TraceContext.from_headers(headers)
        if remote is not None:
            hop_span = _trace.TRACER.start_span(
                f"{self.kind}.hop",
                parent=remote,
                kind=self.kind,
                emitter=self.emitter,
                attrs={
                    "node": self.node_id,
                    "topic": record.topic,
                    "route": route,
                    "delivery": kind,
                },
            )
            ctx.trace = hop_span.context
            ctx_token = _trace.current_context.set(hop_span.context)
            # in-process children (the inference engine's spans) land in
            # this hop's sink so they ride the same topic publish below
            sink, sink_token = _trace.collect_spans()

        try:
            if kind == "call":
                # expired-on-arrival + drain gate: record the typed fault
                # FAST instead of executing for a caller that is gone (or
                # a worker that is leaving) — raising here lands in the
                # NodeFaultError arm below, so the fault rail, step flush
                # and span bookkeeping all run normally
                self._check_admission(ctx, deadline)
            await self._execute(ctx)
        except MintedFault as minted:
            await self._publish_fault(ctx, minted.error.report)
        except NodeFaultError as fault:
            await self._publish_fault(ctx, fault.report)
        except Exception as exc:  # noqa: BLE001 - the fault rail
            # typed exceptions (EngineOverloadedError, DeadlineExceeded…)
            # keep their wire code from the authoritative table in
            # calfkit_tpu_torch.exceptions; everything else harvests as this
            # node kind's generic fault
            report = ErrorReport.build_safe(
                error_type_for(exc) or self._own_fault_type(),
                exc=exc,
                node=self.node_id,
                route=ctx.route,
            )
            recovered = False
            try:
                recovery = await run_chain_guarded(self.on_node_error, ctx, report)
            except MintedFault as minted:
                await self._publish_fault(ctx, minted.error.report)
                recovery, recovered = None, True
            except Exception:  # noqa: BLE001 - seam crash joins the fault
                logger.exception("[%s] on_node_error seam crashed", log_id)
                recovery = None
            if recovery is not None and not recovered:
                try:
                    await self._publish_action(ctx, recovery)
                    recovered = True
                except Exception:  # noqa: BLE001
                    logger.exception("[%s] recovery action publish failed", log_id)
            if not recovered:
                # a failed recovery must not swallow the original fault
                await self._publish_fault(ctx, report)
        except BaseException as exc:
            # cancellation (lane force-cancel, loop teardown) and other
            # non-Exception escapes: record the truth on the hop span NOW
            # (end() is idempotent — the finally's end() becomes a no-op),
            # then propagate.  Captured locally, not via sys.exc_info() in
            # the finally, which also reports outer HANDLED exceptions.
            if hop_span is not None:
                import asyncio as _asyncio

                hop_span.end(
                    status="cancelled"
                    if isinstance(exc, _asyncio.CancelledError)
                    else "error"
                )
            raise
        finally:
            if deadline_token is not None:
                cancellation.current_deadline.reset(deadline_token)
            if run_token is not None:
                _capacity.current_run.reset(run_token)
            if lease_token is not None:
                leases.current_lease.reset(lease_token)
            if priority_token is not None:
                qos.current_priority.reset(priority_token)
            await self._flush_steps(ctx)
            if hop_span is not None:
                if ctx.fault_error_type is not None:
                    hop_span.end(
                        status="error", error_type=ctx.fault_error_type
                    )
                else:
                    hop_span.end()
                if ctx_token is not None:
                    _trace.current_context.reset(ctx_token)
                if sink_token is not None:
                    _trace.release_spans(sink_token)
                self._publish_spans_soon(sink)

    def _own_fault_type(self) -> str:
        return FaultTypes.NODE_ERROR

    # --------------------------------------------- overload protection
    # LRU cap on the per-kernel corr -> downstream-call-topics map: sized
    # for every plausible concurrent-run count; eviction only degrades a
    # cancel back to single-hop for the evicted (oldest) run
    _DOWNSTREAM_CALLS_CAP = 2048

    def _note_downstream_call(self, correlation_id: str, topic: str) -> None:
        """Remember that this run published a call to ``topic`` so a later
        cancel can follow it (``_handle_cancel``)."""
        calls = self._downstream_calls
        entry = calls.get(correlation_id)
        if entry is None:
            entry = calls[correlation_id] = set()
        entry.add(topic)
        calls.move_to_end(correlation_id)
        while len(calls) > self._DOWNSTREAM_CALLS_CAP:
            calls.popitem(last=False)

    # per-topic bound on one forwarded publish, mirroring the client's
    # _CANCEL_PUBLISH_TIMEOUT rationale: an unreachable broker is the
    # LIKELY state when cancels storm in, and must not wedge the task
    _CANCEL_FORWARD_TIMEOUT = 5.0

    def _handle_cancel(self, headers: dict[str, str]) -> None:
        """Route a ``cancel``-kind record to in-process abandonment AND
        forward it along the run's path: every registered cancellation
        target (the inference engines) drops its requests for the record's
        correlation id, and every topic this kernel published one of the
        run's calls to gets the cancel re-published — an engine in another
        worker process is only reachable through its topic.  The pop makes
        forwarding idempotent (a duplicate cancel delivery forwards
        nothing); the forwards run as a retained, time-bounded background
        task because this runs INLINE on the dispatcher's express intake
        path — awaiting an unreachable broker here would head-of-line
        block all record intake, the exact failure the express path
        exists to avoid.  Fail-open — a cancel is advisory; a target or
        hop that cannot honor it changes nothing."""
        correlation_id = headers.get(protocol.HDR_CORRELATION)
        if not correlation_id:
            return
        topics = self._downstream_calls.pop(correlation_id, None)
        if topics:
            task = asyncio.get_running_loop().create_task(
                self._forward_cancel(
                    sorted(topics), correlation_id,
                    headers.get(protocol.HDR_TASK),
                )
            )
            self._span_tasks.add(task)
            task.add_done_callback(self._span_tasks.discard)
        matched = cancellation.propagate_cancel(correlation_id)
        if matched:
            logger.info(
                "[%s] cancel for %s abandoned %d in-flight request(s)",
                self.node_id, correlation_id[:8], matched,
            )

    async def _forward_cancel(
        self,
        topics: "list[str]",
        correlation_id: str,
        task_id: "str | None",
    ) -> None:
        for topic in topics:
            fwd = {
                protocol.HDR_EMITTER: self.emitter,
                protocol.HDR_KIND: "cancel",
                protocol.HDR_CORRELATION: correlation_id,
            }
            if task_id:
                fwd[protocol.HDR_TASK] = task_id
            try:
                await asyncio.wait_for(
                    self.transport.publish(
                        topic,
                        b"",
                        key=partition_key(task_id) if task_id else None,
                        headers=fwd,
                    ),
                    self._CANCEL_FORWARD_TIMEOUT,
                )
            except Exception:  # noqa: BLE001 - advisory, never faults the hop
                logger.warning(
                    "[%s] cancel forward to %s failed for %s",
                    self.node_id, topic, correlation_id[:8],
                    exc_info=True,
                )

    # emitter kinds whose calls CONTINUE a run already admitted to the
    # mesh (an agent's tool call, a tail call): a draining worker must let
    # these finish — "in-flight work runs to completion" — and only refuse
    # runs ENTERING the mesh (client-emitted, or unattributed external)
    _CONTINUATION_EMITTERS = ("agent", "tool", "toolbox", "consumer", "worker")

    def _check_admission(
        self, ctx: NodeRunContext, deadline: "float | None"
    ) -> None:
        """The call-delivery gate: an already-expired call
        records a typed ``mesh.deadline_exceeded`` fault instead of
        executing, and a draining worker refuses NEW runs with a typed,
        retriable ``mesh.overloaded`` fault while in-flight deliveries —
        returns, faults, and node-emitted continuation calls belonging to
        runs already executing — keep flowing to completion.  A call whose
        run was already cancelled (tombstone hit: the cancel rode EXPRESS
        past the lane this call was still queued in) faults fast instead
        of executing for a caller that left."""
        if cancellation.was_cancelled(ctx.correlation_id):
            raise NodeFaultError(
                ErrorReport.build_safe(
                    FaultTypes.CANCELLED,
                    f"run was cancelled before this call reached "
                    f"{self.node_id}",
                    node=self.node_id,
                    route=ctx.route,
                )
            )
        if deadline is not None:
            overdue = cancellation.wall_clock() - deadline
            if overdue >= 0:
                raise NodeFaultError(
                    ErrorReport.build_safe(
                        FaultTypes.DEADLINE_EXCEEDED,
                        f"call expired {overdue:.3f}s before reaching "
                        f"{self.node_id}",
                        node=self.node_id,
                        route=ctx.route,
                    )
                )
        worker = self.resources.get("worker")
        if worker is not None and getattr(worker, "draining", False):
            emitter = ctx.headers.get(protocol.HDR_EMITTER, "")
            if emitter.split("/", 1)[0] in self._CONTINUATION_EMITTERS:
                return  # a sub-call of an in-flight run: let it finish
            raise NodeFaultError(
                ErrorReport.build_safe(
                    FaultTypes.OVERLOADED,
                    f"{self.node_id} is draining for shutdown; "
                    "retry against another instance",
                    node=self.node_id,
                    route=ctx.route,
                )
            )
        # per-tenant admission budget: only runs ENTERING the
        # mesh spend a token — continuation calls are the tail of an
        # already-admitted run, and rate-limiting them mid-run would
        # strand slots and pages the run already holds (same exemption
        # as the drain gate above).  Tenant identity is the caller's
        # lease id where present (one lease per caller process — the
        # natural tenant grain), else the caller's emitter id.
        limiter = self.resources.get(QOS_LIMITER_KEY)
        if limiter is not None and getattr(limiter, "enabled", False):
            emitter = ctx.headers.get(protocol.HDR_EMITTER, "")
            if emitter.split("/", 1)[0] not in self._CONTINUATION_EMITTERS:
                lease = protocol.parse_lease(
                    ctx.headers.get(protocol.HDR_LEASE)
                )
                if lease is not None:
                    tenant = lease[0]
                else:
                    _, emitter_id = protocol.parse_emitter(emitter)
                    tenant = emitter_id or emitter
                retry_after = limiter.admit(tenant)
                if retry_after is not None:
                    raise NodeFaultError(
                        ErrorReport.build_safe(
                            FaultTypes.RATE_LIMITED,
                            f"tenant {tenant!r} exceeded its admission "
                            f"budget at {self.node_id}; retry after "
                            f"{retry_after:.3f}s",
                            node=self.node_id,
                            route=ctx.route,
                            data={
                                "tenant_id": tenant,
                                "retry_after_s": f"{retry_after:.3f}",
                            },
                        )
                    )

    # =====================================================================
    # stages
    # =====================================================================
    async def _execute(self, ctx: NodeRunContext) -> None:
        if ctx.delivery_kind in ("return", "fault"):
            outcome = await self._aggregate(ctx)
            if outcome != _RESUME:
                return
        short_circuit = await run_chain(self.before_node, ctx)
        if short_circuit is not None:
            # a before_node seam answered the delivery: the body never runs
            # (caching / canned responses / maintenance mode); after_node
            # still sees the result like any other
            action = _as_action(short_circuit)
        else:
            action = await self._dispatch_routed(ctx)
        if isinstance(action, Observed):
            ctx.ledger.absorb(action.facts)
            action = action.action
        transformed = await run_chain(self.after_node, ctx, action)
        if transformed is not None:
            action = _as_action(transformed)
        await self._publish_action(ctx, action)

    async def _dispatch_routed(self, ctx: NodeRunContext) -> NodeResult | Observed:
        chain = self.handlers_for(ctx.route)
        if not chain:
            raise NodeFaultError(
                ErrorReport.build_safe(
                    FaultTypes.DECLINED,
                    f"no handler for route {ctx.route!r} on {self.node_id}",
                    node=self.node_id,
                    route=ctx.route,
                )
            )
        for body in chain:
            result = body(ctx)
            if hasattr(result, "__await__"):
                result = await result
            if not isinstance(result, Next):
                return result
        # every handler declined
        return Next()

    # ------------------------------------------------------------ aggregate
    async def _aggregate(self, ctx: NodeRunContext) -> str:
        envelope = ctx.envelope
        reply = envelope.reply
        envelope.reply = None
        if reply is None:
            logger.warning(
                "[%s] %s delivery with empty reply slot: stray, dropped",
                self.node_id,
                ctx.delivery_kind,
            )
            return _HANDLED

        # fan-out close reentry?
        if (
            isinstance(reply.marker, CallMarker)
            and _REENTRY_KEY in reply.marker.data
        ):
            return await self._close_fanout_batch(
                ctx, reply.marker.data[_REENTRY_KEY]
            )

        frame = envelope.workflow.current()
        if frame is not None and frame.fanout_id:
            return await self._fold_sibling_reply(ctx, frame.fanout_id, reply)

        # single pending call: resolve (seams on faults), then resume body
        outcome = await self._resolve_callee(
            ctx, reply, slot_id=reply.frame_id or ""
        )
        if outcome.fault is not None:
            # unrecovered callee fault escalates one hop up the stack
            escalated = ErrorReport.build_safe(
                FaultTypes.CALLEE_FAULT,
                f"callee fault reached {self.node_id}",
                node=self.node_id,
                route=ctx.route,
                cause=outcome.fault,
                frame_id=frame.frame_id if frame else None,
            )
            await self._publish_fault(ctx, escalated)
            return _HANDLED
        self.materialize_outcome(ctx, outcome)
        ctx.folded = outcome
        return _RESUME

    async def _resolve_callee(
        self, ctx: NodeRunContext, reply: Any, *, slot_id: str
    ) -> FanoutOutcome:
        """Stage-1 resolution: returns pass through; faults get the
        on_callee_error chain (parts = recovery, None = stays a fault)."""
        ctx.folding_marker = getattr(reply, "marker", None)
        if isinstance(reply, ReturnMessage):
            outcome = FanoutOutcome(
                slot_id=slot_id, parts=list(reply.parts), marker=reply.marker
            )
            self._note_fold(ctx, outcome)
            return outcome
        assert isinstance(reply, FaultMessage)
        report = reply.report
        recovery = await run_chain_guarded(self.on_callee_error, ctx, report)
        if recovery is not None:
            outcome = FanoutOutcome(
                slot_id=slot_id,
                parts=_as_recovery_parts(recovery),
                marker=reply.marker,
            )
            self._note_fold(ctx, outcome, recovered_fault=True)
            return outcome
        outcome = FanoutOutcome(slot_id=slot_id, fault=report, marker=reply.marker)
        self._note_fold(ctx, outcome)
        return outcome

    def _note_fold(
        self, ctx: NodeRunContext, outcome: FanoutOutcome, *,
        recovered_fault: bool = False,
    ) -> None:
        """Pair law: the result step for a marked call mints at the fold."""
        marker = outcome.marker
        if isinstance(marker, ToolCallMarker):
            if outcome.fault is not None:
                ctx.ledger.fold_failed(
                    marker.tool_call_id, marker.tool_name, outcome.fault
                )
            else:
                ctx.ledger.folded(
                    marker.tool_call_id,
                    marker.tool_name,
                    render_parts_as_text(outcome.parts or []),
                    ok=not recovered_fault,
                )

    def materialize_outcome(self, ctx: NodeRunContext, outcome: FanoutOutcome) -> None:
        """Default slot materialization: marked tool results land in
        ``state.tool_results`` (retry-marked parts become RetryPart)."""
        marker = outcome.marker
        if not isinstance(marker, ToolCallMarker):
            return
        parts = outcome.parts or []
        if any(is_retry(p) for p in parts):
            ctx.state.tool_results[marker.tool_call_id] = RetryPart(
                content=render_parts_as_text(parts),
                tool_call_id=marker.tool_call_id,
                tool_name=marker.tool_name,
            )
        else:
            ctx.state.tool_results[marker.tool_call_id] = ToolReturnPart(
                tool_call_id=marker.tool_call_id,
                tool_name=marker.tool_name,
                content=render_parts_as_text(parts),
            )

    # -------------------------------------------------------------- fan-out
    def _require_store(self) -> FanoutBatchStore:
        store = self.fanout_store
        if store is None:
            raise NodeFaultError(
                ErrorReport.build_safe(
                    FaultTypes.LIFECYCLE_ERROR,
                    f"{self.node_id}: parallel calls need a fanout store "
                    f"resource ({FANOUT_STORE_KEY!r})",
                    node=self.node_id,
                )
            )
        return store

    async def _handle_fanout_open(self, ctx: NodeRunContext, calls: list[Call]) -> None:
        """OPEN: snapshot + pre-minted slots + marked own frame + dispatch."""
        store = self._require_store()
        envelope = ctx.envelope
        fanout_id = new_id()
        slots = [
            SlotRef(
                slot_id=new_id(),
                tag=call.tag,
                tool_name=(
                    call.marker.tool_name
                    if isinstance(call.marker, ToolCallMarker)
                    else None
                ),
            )
            for call in calls
        ]
        envelope.workflow.mark_fanout(fanout_id)
        snapshot = EnvelopeSnapshot(
            context=envelope.context.model_copy(deep=True),
            workflow=envelope.workflow.model_copy(deep=True),
        )
        await store.open(
            fanout_id, FanoutOpen(fanout_id=fanout_id, slots=slots), snapshot
        )
        for call, slot in zip(calls, slots):
            sibling = Envelope(
                context=envelope.context.model_copy(deep=True),
                workflow=envelope.workflow.model_copy(deep=True),
            )
            if call.isolate_state:
                sibling.context.state = call.state_override or State()
            await self._dispatch_call(ctx, sibling, call, frame_id=slot.slot_id)

    async def _dispatch_call(
        self,
        ctx: NodeRunContext,
        envelope: Envelope,
        call: Call,
        *,
        frame_id: str | None = None,
    ) -> None:
        """The one push-frame/publish/note-dispatch sequence for outgoing
        calls (single and fan-out siblings)."""
        frame = CallFrame(
            target_topic=call.target_topic,
            callback_topic=self.return_topic(),
            route=call.route,
            payload=call.parts,
            tag=call.tag,
            marker=call.marker,
            caller_kind=self.kind,
            caller_name=self.name,
        )
        if frame_id is not None:
            frame.frame_id = frame_id
        envelope.workflow.invoke_frame(frame)
        await self._publish_envelope(
            ctx, call.target_topic, envelope, kind="call", route=call.route
        )
        if isinstance(call.marker, ToolCallMarker):
            args: dict[str, Any] = {}
            if call.parts:
                data = getattr(call.parts[0], "data", None)
                if isinstance(data, dict):
                    args = data.get("args", data)
                    if not isinstance(args, dict):
                        args = {}
            ctx.ledger.note_dispatch(
                call.marker.tool_call_id, call.marker.tool_name, args
            )

    async def _fold_sibling_reply(
        self, ctx: NodeRunContext, fanout_id: str, reply: Any
    ) -> str:
        store = self._require_store()
        slot_id = reply.frame_id or ""
        state = await store.load(fanout_id)
        classification = classify_sibling(state, slot_id)
        if classification != "expected":
            logger.warning(
                "[%s] sibling reply %s classified %s for batch %s: dropped",
                self.node_id,
                slot_id[:8],
                classification,
                fanout_id[:8],
            )
            return _HANDLED
        assert state is not None
        outcome = await self._resolve_callee(ctx, reply, slot_id=slot_id)
        state = record_outcome(state, outcome)
        if state.is_complete() and not state.closing:
            state = state.model_copy(update={"closing": True})
            await store.save(state)
            await self._publish_reentry(ctx, fanout_id)
        else:
            await store.save(state)
        return _HANDLED

    async def _publish_reentry(self, ctx: NodeRunContext, fanout_id: str) -> None:
        """Self-published close trigger, through the same key-ordered lane."""
        envelope = Envelope(
            reply=ReturnMessage(marker=CallMarker(data={_REENTRY_KEY: fanout_id}))
        )
        await self._publish_envelope(
            ctx,
            self.return_topic(),
            envelope,
            kind="return",
            route="fanout.close",
            mirror=False,  # internal control record: never on the events tap
        )

    async def _close_fanout_batch(self, ctx: NodeRunContext, fanout_id: str) -> str:
        store = self._require_store()
        state = await store.load(fanout_id)
        if state is None:
            logger.warning(
                "[%s] duplicate close for batch %s: dropped",
                self.node_id,
                fanout_id[:8],
            )
            return _HANDLED
        snapshot = await store.load_snapshot(fanout_id)
        await store.close(fanout_id)  # tombstone-first, exactly-once close
        if snapshot is None:
            logger.error(
                "[%s] batch %s registered without snapshot: write-order "
                "invariant broken; run stranded",
                self.node_id,
                fanout_id[:8],
            )
            return _HANDLED
        # restore the caller's continuation (incl. the step-stream root,
        # which the reentry envelope's empty workflow couldn't provide)
        ctx.envelope.context = snapshot.context
        ctx.envelope.workflow = snapshot.workflow
        ctx.envelope.workflow.mark_fanout(None)
        ctx.root_topic = ctx.envelope.workflow.root_callback_topic()
        ctx.route = (
            ctx.envelope.workflow.current().route
            if ctx.envelope.workflow.current()
            else ctx.route
        )

        faults = [o for o in state.outcomes.values() if o.fault is not None]
        if faults:
            group = ErrorReport.build_safe(
                FaultTypes.FANOUT_ABORTED,
                f"{len(faults)} of {len(state.open.slots)} parallel calls "
                f"faulted on {self.node_id}",
                node=self.node_id,
                route=ctx.route,
                cause=faults[0].fault,
                data={"faulted_slots": str(len(faults))},
            )
            await self._publish_fault(ctx, group)
            return _HANDLED
        for slot in state.open.slots:
            outcome = state.outcomes[slot.slot_id]
            self.materialize_outcome(ctx, outcome)
        return _RESUME

    # =====================================================================
    # publish chokepoint
    # =====================================================================
    async def _publish_action(self, ctx: NodeRunContext, action: NodeResult) -> None:
        envelope = ctx.envelope
        if isinstance(action, list):
            if not all(isinstance(c, Call) for c in action):
                raise NodeFaultError(
                    ErrorReport.build_safe(
                        FaultTypes.NODE_ERROR,
                        "a list action must contain only Calls",
                        node=self.node_id,
                    )
                )
            if not action:
                action = None  # empty batch = no action; decline check below
            elif len(action) == 1 and not action[0].isolate_state:
                action = action[0]  # degenerate list: plain call
            else:
                await self._handle_fanout_open(ctx, action)
                return

        if isinstance(action, Call):
            if action.isolate_state:
                # isolated single call = degenerate durable batch (the
                # caller's state must survive outside the wire)
                await self._handle_fanout_open(ctx, [action])
                return
            envelope.reply = None
            await self._dispatch_call(ctx, envelope, action)
            return

        if isinstance(action, TailCall):
            frame = envelope.workflow.require_current()
            frame.target_topic = action.target_topic
            frame.route = action.route
            # the retargeted frame carries ONLY what the TailCall specifies:
            # keeping the old payload would re-stage the original prompt at
            # the handoff target (duplicate user turns per hop)
            frame.payload = action.parts
            envelope.reply = None
            await self._publish_envelope(
                ctx, action.target_topic, envelope, kind="call", route=action.route
            )
            return

        if isinstance(action, ReturnCall):
            frame = envelope.workflow.unwind_frame()
            envelope.reply = ReturnMessage(
                parts=action.parts,
                frame_id=frame.frame_id,
                tag=frame.tag,
                marker=frame.marker,
            )
            # steps flush BEFORE the terminal reply: both land on the same
            # topic+key, so per-key ordering guarantees stream consumers see
            # every step before the result on any broker (reference order:
            # base.py:1982 flush precedes the action publish)
            await self._flush_steps(ctx)
            await self._publish_envelope(
                ctx, frame.callback_topic, envelope, kind="return", route=frame.route
            )
            return

        # None / Next: a reply-owing delivery must not be silently dropped
        if envelope.workflow.depth > 0:
            raise NodeFaultError(
                ErrorReport.build_safe(
                    FaultTypes.DECLINED,
                    f"{self.node_id} declined a reply-owing delivery "
                    f"(route {ctx.route!r})",
                    node=self.node_id,
                    route=ctx.route,
                )
            )

    # ---------------------------------------------------------------- fault
    async def _publish_fault(self, ctx: NodeRunContext, report: ErrorReport) -> None:
        ctx.fault_error_type = report.error_type  # hop span → status=error
        envelope = ctx.envelope
        if envelope.workflow.depth == 0:
            # no caller: the fault rail's floor
            logger.error(
                "[%s] unroutable fault (no caller frame): %s",
                self.node_id,
                report.model_dump_json(),
            )
            return
        frame = envelope.workflow.unwind_frame()
        report = report.model_copy(
            update={"frame_chain": ([frame.frame_id] + report.frame_chain)[:32]}
        )
        await self._flush_steps(ctx)  # steps precede the fault (same key)
        # the state-elision ladder: full -> no tracebacks -> minimal+elide
        budget = self.transport.max_message_bytes
        attempts = [
            (report, False),
            (report.without_tracebacks(), False),
            (report.to_minimal(), True),
        ]
        for attempt, elide_state in attempts:
            candidate = envelope
            if elide_state:
                candidate = envelope.model_copy(deep=True)
                candidate.context.state = State()
                candidate.state_elided = True
            candidate.reply = FaultMessage(
                report=attempt,
                frame_id=frame.frame_id,
                tag=frame.tag,
                marker=frame.marker,
            )
            wire = candidate.to_wire()
            if len(wire) <= budget:
                try:
                    await self._publish_envelope(
                        ctx,
                        frame.callback_topic,
                        candidate,
                        kind="fault",
                        route=frame.route,
                        error_type=attempt.error_type,
                    )
                    if elide_state or attempt is not report:
                        logger.warning(
                            "[%s] fault degraded to fit wire budget "
                            "(state_elided=%s)",
                            self.node_id,
                            elide_state,
                        )
                    return
                except Exception:  # noqa: BLE001 - try the next rung
                    logger.exception(
                        "[%s] fault publish attempt failed; degrading",
                        self.node_id,
                    )
        logger.error(
            "[%s] fault could not be published at any elision rung: %s",
            self.node_id,
            report.to_minimal().model_dump_json(),
        )

    # ------------------------------------------------------------ transport
    async def _publish_envelope(
        self,
        ctx: NodeRunContext,
        topic: str,
        envelope: Envelope,
        *,
        kind: str,
        route: str,
        error_type: str | None = None,
        mirror: bool = True,
    ) -> None:
        headers = {
            protocol.HDR_EMITTER: self.emitter,
            protocol.HDR_KIND: kind,
            protocol.HDR_WIRE: "envelope",
            protocol.HDR_ROUTE: route,
            protocol.HDR_TASK: ctx.task_id,
        }
        if ctx.correlation_id:
            headers[protocol.HDR_CORRELATION] = ctx.correlation_id
        if error_type:
            headers[protocol.HDR_ERROR_TYPE] = error_type
        # deadline propagation: every hop forwards the caller's absolute
        # deadline unchanged (next to the trace headers) so downstream
        # hops and engines enforce the SAME budget
        incoming_deadline = ctx.headers.get(protocol.HDR_DEADLINE)
        if incoming_deadline:
            headers[protocol.HDR_DEADLINE] = incoming_deadline
        # lease propagation: like the deadline — downstream
        # work runs on the ORIGINAL caller's behalf; engines several
        # hops deep still register against the one caller lease
        incoming_lease = ctx.headers.get(protocol.HDR_LEASE)
        if incoming_lease:
            headers[protocol.HDR_LEASE] = incoming_lease
        # priority-class propagation: forwarded VERBATIM like
        # the deadline/lease — downstream tool calls run on the ORIGINAL
        # caller's behalf, so they degrade as the caller's class, not as
        # the forwarding node's
        incoming_priority = ctx.headers.get(protocol.HDR_PRIORITY)
        if incoming_priority:
            headers[protocol.HDR_PRIORITY] = incoming_priority
        # run-identity propagation: forwarded VERBATIM like
        # the deadline/lease — downstream hops serve the same logical
        # run, so their spans stitch into its `ck run` timeline.  Note
        # the contrast with x-mesh-attempt, which is this-placement-only
        # and deliberately NOT forwarded
        incoming_run = ctx.headers.get(protocol.HDR_RUN)
        if incoming_run:
            headers[protocol.HDR_RUN] = incoming_run
        if ctx.trace is not None:
            # downstream hops parent to THIS hop's span
            headers.update(ctx.trace.headers())
        if kind == "call" and ctx.correlation_id:
            self._note_downstream_call(ctx.correlation_id, topic)
        await self.transport.publish(
            topic,
            envelope.to_wire(),
            key=partition_key(ctx.task_id),
            headers=headers,
        )
        # broadcast mirror: the hop's outcome re-published for broker-level
        # taps (reference: base.py:580-701,919) — best-effort, once per hop
        mirror_topic = self.publish_topic() if mirror else None
        if mirror_topic and mirror_topic != topic and not ctx.mirrored:
            ctx.mirrored = True
            try:
                await self.transport.publish(
                    mirror_topic,
                    envelope.to_wire(),
                    key=partition_key(ctx.task_id),
                    headers=headers,
                )
            except Exception:  # noqa: BLE001
                logger.warning(
                    "[%s] broadcast mirror failed (run unaffected)",
                    self.node_id,
                    exc_info=True,
                )

    def _publish_spans_soon(self, records: "list[Any]") -> None:
        """Export the hop's finished spans off the delivery critical path
        (the dispatcher lane permit is still held here) via the shared
        fire-and-forget helper; the tracer's ring buffer already holds
        every record, so a failed publish degrades to in-process
        visibility."""
        if self._transport is None:
            return
        from calfkit_tpu_torch.observability.trace import publish_spans_soon

        publish_spans_soon(
            self._transport.publish,
            records,
            self._span_tasks,
            on_error=lambda exc: logger.debug(
                "[%s] span publish failed (run unaffected): %s",
                self.node_id, exc,
            ),
        )

    async def _flush_steps(self, ctx: NodeRunContext) -> None:
        if not ctx.ledger.has_steps:
            return
        root = ctx.root_topic or ctx.envelope.workflow.root_callback_topic()
        try:
            await ctx.ledger.flush(
                self.transport,
                root,
                correlation_id=ctx.correlation_id,
                task_id=ctx.task_id,
            )
        except Exception:  # noqa: BLE001 - steps never fault the run
            logger.warning(
                "[%s] step flush failed (run unaffected)", self.node_id, exc_info=True
            )
