"""The Agent node: one model turn per delivery, tools dispatched as mesh
calls.

Reference: calfkit/nodes/agent.py:80-1031.  The hot loop (SURVEY.md §3.3):

    delivery(call)   → stage user prompt → model turn
    model turn       → tool calls?  dispatch as Call/fan-out (tag =
                       tool_call_id, marker-stamped) and suspend
                     → final?      ReturnCall with text/structured parts
    delivery(return) → materialized tool_results → next model turn

State discipline: the staged request (user prompt or tool-returns) is
committed to ``message_history`` only after a successful model turn, so a
redelivered hop cannot double-commit; in-flight ``tool_calls`` /
``tool_results`` live in :class:`State` and ride the wire.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Sequence

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.engine.model_client import ModelClient, ModelSettings
from calfkit_tpu_torch.engine.turn import FINAL_RESULT_TOOL, TurnOutcome, run_turn
from calfkit_tpu_torch.exceptions import NodeFaultError
from calfkit_tpu_torch.models._wire import to_jsonable
from calfkit_tpu_torch.models.actions import Call, NodeResult, ReturnCall, TailCall
from calfkit_tpu_torch.models.agents import AgentCard
from calfkit_tpu_torch.models.capability import CapabilityRecord
from calfkit_tpu_torch.models.error_report import ErrorReport, FaultTypes
from calfkit_tpu_torch.models.marker import ToolCallMarker
from calfkit_tpu_torch.models.messages import (
    ModelRequest,
    RetryPart,
    ToolReturnPart,
    UserPart,
)
from calfkit_tpu_torch.models.payload import (
    DataPart,
    TextPart,
    render_parts_as_text,
    retry_text_part,
)
from calfkit_tpu_torch.models.tool_dispatch import ToolBinding, ToolCallRef
from calfkit_tpu_torch.nodes.base import BaseNodeDef, NodeRunContext, handler
from calfkit_tpu_torch.nodes.projection import (
    project,
    step_preamble,
    structured_output_preamble,
)
from calfkit_tpu_torch.nodes.steps import (
    DeniedCall,
    Fact,
    HandedOff,
    InferenceFact,
    Observed,
    Said,
)
from calfkit_tpu_torch.nodes.tool import ToolNodeDef, eager_tools
from calfkit_tpu_torch.peers.handoff import HANDOFF_TOOL, arbitrate_handoff
from calfkit_tpu_torch.peers.messaging import MESSAGE_AGENT_TOOL

logger = logging.getLogger(__name__)

Instructions = str | Callable[[NodeRunContext], str]
ToolsSpec = Any  # ToolNodeDef list | ToolBinding list | selector with .resolve()

CAPABILITY_VIEW_KEY = "capability_view"
AGENTS_VIEW_KEY = "agents_view"


def render_fault_for_model(report: ErrorReport) -> Any:
    """A callee fault rendered as a model-visible retry part (the
    ``surface_to_model`` prebuilt, reference: nodes/_tool_error.py:116)."""
    return retry_text_part(
        f"The tool call failed: {report.describe()}. "
        "You may retry, use another tool, or answer without it."
    )


def surface_to_model(ctx: NodeRunContext, report: ErrorReport) -> list[Any]:
    return [render_fault_for_model(report)]


def _adapt_on_tool_error(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Adapt ``on_tool_error(tool_call_marker, ctx, report)`` onto the
    kernel's 2-arg ``on_callee_error`` seam."""

    async def seam(ctx: NodeRunContext, report: ErrorReport) -> Any:
        marker = ctx.folding_marker
        if not isinstance(marker, ToolCallMarker):
            return None  # not a tool-call reply: fall through the chain
        result = fn(marker, ctx, report)
        if hasattr(result, "__await__"):
            result = await result
        return result

    return seam


class BaseAgentNodeDef(BaseNodeDef):
    kind = "agent"

    def __init__(
        self,
        name: str,
        *,
        model: ModelClient,
        instructions: Instructions | None = None,
        tools: ToolsSpec = (),
        peers: Sequence[Any] = (),  # Messaging / Handoff selectors
        output_type: type = str,
        description: str = "",
        model_settings: ModelSettings | None = None,
        max_output_retries: int = 2,
        on_tool_error: Callable[..., Any] | None = None,
        stream_tokens: bool = False,
        **seams: Any,
    ):
        super().__init__(name, **seams)
        self.model = model
        self.instructions = instructions
        self.tools = tools
        self.peers = list(peers)
        kinds = [getattr(p, "kind", "?") for p in self.peers]
        if len(kinds) != len(set(kinds)):
            from calfkit_tpu_torch.exceptions import LifecycleConfigError

            raise LifecycleConfigError(
                f"agent {name!r}: one peer selector per kind (got {kinds}); "
                "list multiple names inside one selector instead"
            )
        self.output_type = output_type
        self.description = description
        self.model_settings = model_settings
        self.max_output_retries = max_output_retries
        self.stream_tokens = stream_tokens
        if on_tool_error is not None:
            # sugar: (tool_call_marker, ctx, report) -> parts | None, adapted
            # onto the kernel's on_callee_error seam (reference:
            # nodes/_tool_error.py:42-150)
            self.on_callee_error.append(_adapt_on_tool_error(on_tool_error))
        # failure recovery: arrivals marked as failover
        # re-dispatches / hedge duplicates (the caller's x-mesh-attempt
        # marker), folded into the engine-stats advert so `ck stats` /
        # `ck fleet` show which replicas are absorbing recovered work
        self._failover_requests = 0
        self._hedge_requests = 0
        # run-scoped observability: arrivals counted from the
        # x-mesh-run header — runs (attempt_no == 0) vs every linked
        # placement, so ATTEMPTS/RUNS in `ck stats` is the amplification
        # failover/hedge re-dispatches add per replica.  Corrupt or
        # missing headers count in NEITHER (un-linked degrade, the header-degradation law)
        self._run_requests = 0
        self._attempt_requests = 0

    # --------------------------------------------------------- decorators
    def instructions_fn(self, fn: Callable[[NodeRunContext], str]) -> Callable:
        """Decorator: dynamic instructions rendered per turn.

        ``@weather_agent.instructions_fn`` (reference: the instructions
        decorator on the agent, SURVEY.md capability checklist)."""
        self.instructions = fn
        return fn

    # ------------------------------------------------------------- topics
    def input_topics(self) -> list[str]:
        topics = [protocol.agent_input_topic(self.name)]
        replica = self.replica_topic()
        if replica is not None:
            topics.append(replica)
        return topics

    def replica_topic(self) -> "str | None":
        """The replica-ADDRESSED input topic, for agents whose
        model exposes serving stats (the engine-backed ones the fleet
        router places): consumed only by THIS instance, advertised in
        the engine-stats heartbeat so routing policies can pick a
        specific replica.  None for plain agents — they stay
        shared-topic only and never enter the replica registry."""
        if getattr(self.model, "stats_snapshot", None) is None:
            return None
        return protocol.agent_replica_topic(self.name, self.instance_id)

    def return_topic(self) -> str:
        return protocol.agent_return_topic(self.name)

    def publish_topic(self) -> str | None:
        return protocol.agent_publish_topic(self.name)

    # -------------------------------------------------------- control plane
    def agent_card(self) -> AgentCard:
        return AgentCard(
            name=self.name,
            description=self.description,
            structured_output=self.output_type is not str,
        )

    def engine_stats_record(self) -> "dict | None":
        """Serving metrics for the engine-stats advert, when this agent's
        model exposes them (the local TPU backend does); None otherwise."""
        snapshot_fn = getattr(self.model, "stats_snapshot", None)
        if snapshot_fn is None:
            return None
        from calfkit_tpu_torch.models.records import EngineStatsRecord

        try:
            try:
                # the heartbeat is THE designated consumer of the
                # per-interval window (single-consumer delta semantics)
                snapshot = snapshot_fn(window=True)
            except TypeError:
                snapshot = snapshot_fn()  # third-party snapshot: no kwarg
            # fleet identity + routability: which instance this
            # is, where to address it, and whether the hosting worker
            # would admit a NEW run right now — re-derived per heartbeat
            # tick, so a drain() flips the advert on the next beat and
            # the router stops picking this replica
            worker = self.resources.get("worker")
            ready, _ = (
                worker.ready() if hasattr(worker, "ready") else (True, "")
            )
            # a wedged engine advertises unready WITHOUT draining:
            # routers stop placing new runs here, and the dead-
            # placement law declares outstanding placements dead so their
            # callers fail over instead of timing out
            if snapshot.get("wedged"):
                ready = False
            # validated from a dict: snapshot keys the record does not
            # know are dropped, as the JAX package's model drops them
            return EngineStatsRecord.model_validate(dict(
                node_id=self.node_id,
                instance_id=self.instance_id,
                replica_topic=self.replica_topic() or "",
                ready=bool(ready),
                draining=bool(getattr(worker, "draining", False)),
                failover_requests=self._failover_requests,
                hedge_requests=self._hedge_requests,
                run_requests=self._run_requests,
                attempt_requests=self._attempt_requests,
                **snapshot,
            )).model_dump()
        except Exception:  # noqa: BLE001 - metrics must never fault serving
            logger.debug("engine stats snapshot failed", exc_info=True)
            return None

    # ------------------------------------------------------ tool resolution
    def _resolve_tools(self, ctx: NodeRunContext) -> list[ToolBinding]:
        """Per-turn resolution (reference: agent.py:621 — selectors resolve
        against the live capability view each turn)."""
        spec = self.tools
        if not spec:
            return []
        if isinstance(spec, (list, tuple)):
            bindings: list[ToolBinding] = []
            node_defs = [t for t in spec if isinstance(t, ToolNodeDef)]
            bindings.extend(eager_tools(*node_defs))
            bindings.extend(t for t in spec if isinstance(t, ToolBinding))
            return bindings
        if hasattr(spec, "resolve"):
            records = self._capability_records(ctx)
            return spec.resolve(records)
        raise NodeFaultError(
            ErrorReport.build_safe(
                FaultTypes.LIFECYCLE_ERROR,
                f"unsupported tools spec {type(spec).__name__}",
                node=self.node_id,
            )
        )

    def _capability_records(self, ctx: NodeRunContext) -> list[CapabilityRecord]:
        view = ctx.resource(CAPABILITY_VIEW_KEY)
        if view is None:
            raise NodeFaultError(
                ErrorReport.build_safe(
                    FaultTypes.CAPABILITY_UNAVAILABLE,
                    f"{self.node_id} uses a discovery selector but no "
                    "capability view is attached (control plane not running?)",
                    node=self.node_id,
                )
            )
        return view.records()

    # ---------------------------------------------------------------- body
    _MAX_REJECTED_LOOPS = 3

    @handler("run")
    async def run(self, ctx: NodeRunContext) -> NodeResult | Observed:
        if ctx.delivery_kind == "call":
            # recovery accounting: count failover/hedge arrivals
            # once per placed call (not per tool-return resumption)
            attempt = ctx.headers.get(protocol.HDR_ATTEMPT)
            if attempt == "failover":
                self._failover_requests += 1
            elif attempt == "hedge":
                self._hedge_requests += 1
            # run accounting: parse_run returns None for a
            # corrupt/missing header — such arrivals count in neither
            # bucket (they are un-linked, not a shared bogus run id)
            parsed_run = protocol.parse_run(
                ctx.headers.get(protocol.HDR_RUN)
            )
            if parsed_run is not None:
                self._attempt_requests += 1
                if parsed_run[1] == 0:
                    self._run_requests += 1
        for _ in range(self._MAX_REJECTED_LOOPS):
            try:
                return await self._run_one_turn(ctx)
            except _AllCallsRejected:
                # tool_results already hold retry parts; loop = next model
                # turn within this same hop
                ctx.delivery_kind = "return"
                continue
        raise NodeFaultError(
            ErrorReport.build_safe(
                FaultTypes.VALIDATION_ERROR,
                f"{self.node_id}: model repeated invalid tool calls "
                f"{self._MAX_REJECTED_LOOPS} times",
                node=self.node_id,
            )
        )

    async def _run_one_turn(self, ctx: NodeRunContext) -> NodeResult | Observed:
        state = ctx.state
        facts: list[Fact] = []

        # ---- build the staged request for this hop
        staged: ModelRequest | None
        if ctx.delivery_kind == "call":
            if state.uncommitted_message is not None:
                # a client-staged prompt (or a redelivered hop) already rides
                # in the state; reuse it instead of double-staging
                staged = state.uncommitted_message
            elif not ctx.payload and state.message_history:
                # a handoff continuation: the history is the conversation;
                # nothing new to stage
                staged = None
            else:
                parts = ctx.payload
                content = render_parts_as_text(parts) if parts else ""
                staged = ModelRequest(parts=[UserPart(content=content)])
                state.uncommitted_message = staged
            state.clear_inflight()
        else:
            staged = self._tool_results_request(ctx)

        # ---- resolve tools, peers & instructions
        bindings = self._resolve_tools(ctx)
        self._guard_reserved_names(bindings)
        peer_defs, peer_targets = self._resolve_peers(ctx)
        instructions = self._render_instructions(ctx)
        # history is POV-projected: foreign turns render as attributed text
        history = project(list(state.message_history), self.name)
        if staged is not None:
            request = staged.model_copy(update={"instructions": instructions})
            messages = history + [request]
        elif history and instructions:
            messages = history[:-1] + [
                history[-1].model_copy(update={"instructions": instructions})
                if isinstance(history[-1], ModelRequest)
                else history[-1]
            ]
        else:
            messages = history

        # ---- ONE model turn (optionally with live token streaming to the
        # run's step stream — BASELINE config 3's downstream-topic tokens)
        model: ModelClient = self.model
        if self.stream_tokens and ctx.root_topic:
            model = _TokenTap(self.model, self, ctx)
        # the turn span: child of the hop span, parent of the engine's
        # prefill/decode spans (propagated via the trace contextvar so the
        # inference client needs no plumbing).  Untraced hops skip it.
        from calfkit_tpu_torch.observability.trace import TRACER, current_context

        turn_span = None
        turn_token = None
        parent_ctx = current_context.get()
        if parent_ctx is not None:
            turn_span = TRACER.start_span(
                "agent.turn",
                parent=parent_ctx,
                kind="agent",
                emitter=self.emitter,
                attrs={"model": self.model.model_name},
            )
            turn_token = current_context.set(turn_span.context)
        # decode-from-offset resume: a failover re-dispatch
        # carries the already-delivered answer text in
        # deps["calfkit.resume_text"]; this model turn CONSUMES it —
        # backends that honor ModelSettings.resume_text prefill the
        # delivered prefix (riding the survivor's prefix cache) and
        # decode only the remainder, instead of silently re-generating
        # the whole answer.  Only the RE-DISPATCHED call's first turn
        # resumes — gated on the x-mesh-attempt: failover marker, which
        # hops never forward: deps ride the whole run's envelope, and
        # without the gate a downstream peer-agent call would consume
        # the TOP agent's delivered prefix as its own answer.  Tool-
        # return re-entries are later turns of a different answer.
        settings = self.model_settings
        resume_text = (
            ctx.deps.get("calfkit.resume_text")
            if (
                ctx.delivery_kind == "call"
                and ctx.headers.get(protocol.HDR_ATTEMPT) == "failover"
            )
            else None
        )
        if isinstance(resume_text, str) and resume_text:
            from calfkit_tpu_torch.engine.model_client import ModelSettings

            settings = (settings or ModelSettings()).model_copy(
                update={"resume_text": resume_text}
            )
        started = time.perf_counter()
        try:
            outcome: TurnOutcome = await run_turn(
                model,
                messages,
                tool_defs=[b.tool for b in bindings] + peer_defs,
                output_type=self.output_type,
                settings=settings,
                author=self.name,
                max_output_retries=self.max_output_retries,
            )
        except BaseException as exc:
            if turn_span is not None:
                import asyncio as _asyncio

                turn_span.end(
                    status="cancelled"
                    if isinstance(exc, _asyncio.CancelledError)
                    else "error"
                )
                current_context.reset(turn_token)
            raise
        elapsed_ms = (time.perf_counter() - started) * 1000.0
        if turn_span is not None:
            turn_span.end(
                decode_ms=round(elapsed_ms, 3),
                prompt_tokens=outcome.usage.input_tokens,
                generated_tokens=outcome.usage.output_tokens,
                tool_calls=len(outcome.tool_calls),
            )
            current_context.reset(turn_token)
        facts.append(
            InferenceFact(
                model_name=self.model.model_name,
                decode_ms=elapsed_ms,
                prompt_tokens=outcome.usage.input_tokens,
                generated_tokens=outcome.usage.output_tokens,
            )
        )

        # ---- commit the hop's messages (staged request + model output)
        if staged is not None:
            state.message_history.append(staged)
        state.message_history.extend(outcome.new_messages)
        state.uncommitted_message = None
        state.clear_inflight()

        # what the hop SAID: final-response text only (internal output-retry
        # chatter never surfaces as a step)
        text = step_preamble(outcome.new_messages)
        if text:
            facts.append(Said(text=text, author=self.name))

        # ---- handoff arbitration (whole-response: first valid wins)
        if any(c.tool_name == HANDOFF_TOOL for c in outcome.tool_calls):
            action = self._arbitrate_handoff(ctx, outcome, peer_targets, facts)
            if action is not None:
                return Observed(action=action, facts=facts)
            # no valid handoff: rejections already materialized as retries

        # ---- dispatch or finalize
        if outcome.tool_calls:
            action = self._dispatch_tool_calls(
                ctx, bindings, outcome, facts, peer_targets
            )
            return Observed(action=action, facts=facts)
        return Observed(action=self._final_action(outcome), facts=facts)

    # ------------------------------------------------------------- helpers
    def _tool_results_request(self, ctx: NodeRunContext) -> ModelRequest:
        """The re-entry request: every in-flight call's materialized result,
        in dispatch order (reference: agent.py:662 DeferredToolResults)."""
        state = ctx.state
        parts: list[Any] = []
        for call_id in state.tool_calls:
            result = state.tool_results.get(call_id)
            if result is None:
                call = state.tool_calls[call_id]
                result = RetryPart(
                    content="No result was produced for this tool call.",
                    tool_call_id=call_id,
                    tool_name=call.tool_name,
                )
            parts.append(result)
        if not parts:
            raise NodeFaultError(
                ErrorReport.build_safe(
                    FaultTypes.STRAY_REPLY,
                    f"{self.node_id} re-entered with no in-flight tool calls",
                    node=self.node_id,
                    route=ctx.route,
                )
            )
        return ModelRequest(parts=parts)

    def _render_instructions(self, ctx: NodeRunContext) -> str | None:
        base = self.instructions
        rendered = base(ctx) if callable(base) else base
        temp = ctx.state.temp_instructions
        if temp:
            rendered = f"{rendered}\n\n{temp}" if rendered else temp
        return rendered

    def _guard_reserved_names(self, bindings: list[ToolBinding]) -> None:
        reserved = {MESSAGE_AGENT_TOOL, HANDOFF_TOOL}
        if self.output_type is not str:
            reserved.add(FINAL_RESULT_TOOL)
        for binding in bindings:
            if binding.tool.name in reserved:
                raise NodeFaultError(
                    ErrorReport.build_safe(
                        FaultTypes.LIFECYCLE_ERROR,
                        f"tool name {binding.tool.name!r} is reserved (peer "
                        "capabilities / structured output)",
                        node=self.node_id,
                    )
                )

    def _resolve_peers(
        self, ctx: NodeRunContext
    ) -> tuple[list[Any], dict[str, set[str]]]:
        """Per-turn peer resolution → (tool defs, kind -> allowed names)."""
        if not self.peers:
            return [], {}
        cards = self._agent_cards(ctx)
        defs: list[Any] = []
        targets: dict[str, set[str]] = {}
        for peer in self.peers:
            allowed = {c.name for c in peer.allowed(cards, self.name)}
            if not allowed:
                continue  # no live targets: don't lure the model into a
                # tool that can only be rejected
            defs.append(peer.tool_def(cards, self.name))
            targets.setdefault(peer.kind, set()).update(allowed)
        return defs, targets

    def _agent_cards(self, ctx: NodeRunContext) -> list[AgentCard]:
        view = ctx.resource(AGENTS_VIEW_KEY)
        if view is not None:
            return view.records()
        # no control plane: curated peer names resolve blindly by topic
        # derivation; discover-mode peers need the live view
        if any(getattr(p, "discover", False) for p in self.peers):
            raise NodeFaultError(
                ErrorReport.build_safe(
                    FaultTypes.CAPABILITY_UNAVAILABLE,
                    f"{self.node_id} uses discover-mode peers but no agents "
                    "view is attached (control plane not running?)",
                    node=self.node_id,
                )
            )
        names = {n for p in self.peers for n in getattr(p, "names", [])}
        return [AgentCard(name=n) for n in sorted(names)]

    def _arbitrate_handoff(
        self,
        ctx: NodeRunContext,
        outcome: TurnOutcome,
        peer_targets: dict[str, set[str]],
        facts: list[Fact],
    ) -> NodeResult | None:
        state = ctx.state
        decision = arbitrate_handoff(
            outcome.tool_calls, peer_targets.get("handoff", set())
        )
        for call in outcome.tool_calls:
            state.tool_calls[call.tool_call_id] = call
        closing: list[Any] = []
        for call_id, stub in decision.stubbed.items():
            call = state.tool_calls[call_id]
            closing.append(
                ToolReturnPart(
                    tool_call_id=call_id, tool_name=call.tool_name, content=stub
                )
            )
            facts.append(
                DeniedCall(
                    tool_call_id=call_id,
                    tool_name=call.tool_name,
                    reason="superseded by handoff",
                )
            )
        for call_id, reason in decision.rejected.items():
            if decision.winner is not None:
                # a later handoff won: close the rejected call in-history so
                # no tool call is left unanswered after the TailCall (real
                # model APIs reject dangling tool_use)
                closing.append(
                    ToolReturnPart(
                        tool_call_id=call_id,
                        tool_name=HANDOFF_TOOL,
                        content=reason,
                    )
                )
            else:
                state.tool_results[call_id] = RetryPart(
                    content=reason,
                    tool_call_id=call_id,
                    tool_name=HANDOFF_TOOL,
                )
            facts.append(
                DeniedCall(
                    tool_call_id=call_id,
                    tool_name=HANDOFF_TOOL,
                    reason="invalid handoff target",
                )
            )
        if decision.winner is None:
            return None  # fall through: rejections loop another model turn
        closing.append(
            ToolReturnPart(
                tool_call_id=decision.winner.tool_call_id,
                tool_name=HANDOFF_TOOL,
                content=f"Handing off to {decision.target}.",
            )
        )
        state.message_history.append(ModelRequest(parts=closing))
        state.clear_inflight()
        facts.append(HandedOff(to_agent=decision.target, from_agent=self.name))
        return TailCall(
            target_topic=protocol.agent_input_topic(decision.target), route="run"
        )

    def _dispatch_tool_calls(
        self,
        ctx: NodeRunContext,
        bindings: list[ToolBinding],
        outcome: TurnOutcome,
        facts: list[Fact],
        peer_targets: dict[str, set[str]] | None = None,
    ) -> NodeResult:
        """Validate each model call and build the Call batch; invalid calls
        become immediate retry results instead of dispatches (reference:
        agent.py:733-932)."""
        state = ctx.state
        peer_targets = peer_targets or {}
        by_name = {b.tool.name: b for b in bindings}
        calls: list[Call] = []
        for tool_call in outcome.tool_calls:
            if tool_call.tool_call_id in state.tool_results:
                continue  # already closed (e.g. rejected handoff)
            state.tool_calls[tool_call.tool_call_id] = tool_call
            if tool_call.tool_name == MESSAGE_AGENT_TOOL:
                peer_call = self._message_agent_call(
                    ctx, tool_call, peer_targets.get("messaging", set()), facts
                )
                if peer_call is not None:
                    calls.append(peer_call)
                continue
            binding = by_name.get(tool_call.tool_name)
            if binding is None:
                state.tool_results[tool_call.tool_call_id] = RetryPart(
                    content=f"Unknown tool {tool_call.tool_name!r}. Available: "
                    f"{sorted(by_name)}",
                    tool_call_id=tool_call.tool_call_id,
                    tool_name=tool_call.tool_name,
                )
                facts.append(
                    DeniedCall(
                        tool_call_id=tool_call.tool_call_id,
                        tool_name=tool_call.tool_name,
                        reason="unknown tool",
                    )
                )
                continue
            try:
                args = tool_call.args_dict()
            except ValueError as exc:
                state.tool_results[tool_call.tool_call_id] = RetryPart(
                    content=f"Malformed arguments for {tool_call.tool_name}: {exc}",
                    tool_call_id=tool_call.tool_call_id,
                    tool_name=tool_call.tool_name,
                )
                facts.append(
                    DeniedCall(
                        tool_call_id=tool_call.tool_call_id,
                        tool_name=tool_call.tool_name,
                        reason=f"malformed arguments: {exc}",
                    )
                )
                continue
            ref = ToolCallRef(
                tool_call_id=tool_call.tool_call_id,
                tool_name=tool_call.tool_name,
                args=args,
            )
            calls.append(
                Call(
                    target_topic=binding.dispatch_topic,
                    route="run",
                    parts=[DataPart(data=ref.model_dump())],
                    tag=tool_call.tool_call_id,
                    marker=ToolCallMarker(
                        tool_call_id=tool_call.tool_call_id,
                        tool_name=tool_call.tool_name,
                    ),
                )
            )
        if not calls:
            # every call was rejected pre-dispatch: absorb this pass's facts
            # (DeniedCall pairs, inference metrics) so they aren't lost, then
            # loop into another model turn on this same hop (bounded)
            ctx.ledger.absorb(facts)
            facts.clear()
            raise _AllCallsRejected()
        return calls if len(calls) > 1 else calls[0]

    def _message_agent_call(
        self,
        ctx: NodeRunContext,
        tool_call: Any,
        allowed: set[str],
        facts: list[Fact],
    ) -> Call | None:
        """Build the isolated-state Call for a model ``message_agent`` call
        (reference: agent.py:540 — isolate_state + degenerate durable
        batch); invalid targets become retries."""
        state = ctx.state
        try:
            args = tool_call.args_dict()
        except ValueError as exc:
            args = None
            reason = f"malformed arguments: {exc}"
        if args is not None:
            target = args.get("agent_name")
            message = args.get("message", "")
            if isinstance(target, str) and target in allowed:
                return Call(
                    target_topic=protocol.agent_input_topic(target),
                    route="run",
                    parts=[TextPart(text=str(message))],
                    tag=tool_call.tool_call_id,
                    marker=ToolCallMarker(
                        tool_call_id=tool_call.tool_call_id,
                        tool_name=MESSAGE_AGENT_TOOL,
                    ),
                    isolate_state=True,
                )
            reason = f"{target!r} is not an available agent"
        state.tool_results[tool_call.tool_call_id] = RetryPart(
            content=f"message_agent failed: {reason}",
            tool_call_id=tool_call.tool_call_id,
            tool_name=MESSAGE_AGENT_TOOL,
        )
        facts.append(
            DeniedCall(
                tool_call_id=tool_call.tool_call_id,
                tool_name=MESSAGE_AGENT_TOOL,
                reason=reason,
            )
        )
        return None

    def _final_action(self, outcome: TurnOutcome) -> ReturnCall:
        output = outcome.output
        if self.output_type is str:
            return ReturnCall(parts=[TextPart(text=output or "")])
        # a structured result keeps the text said alongside it (message-
        # aware preamble: only when the answer rode a final_result call)
        parts: list[Any] = []
        preamble = structured_output_preamble(outcome.new_messages)
        if preamble:
            parts.append(TextPart(text=preamble))
        parts.append(DataPart(data=to_jsonable(output)))
        return ReturnCall(parts=parts)


class _AllCallsRejected(Exception):
    """Internal: every model tool call was denied pre-dispatch; the base
    run() loop catches this and runs another turn on the same hop."""


class _TokenTap(ModelClient):
    """Wraps the agent's model so each request streams internally and
    publishes TokenStep batches to the run's root callback topic WHILE the
    turn generates (the per-hop ledger still carries the terminal steps).

    The FIRST delta of each attempt flushes immediately (true TTFT on the
    wire); later deltas batch up to ``_FLUSH_CHARS``.  When the turn runner
    retries (invalid structured output), a retry-boundary token separates
    the attempts so stream consumers don't see two concatenated answers.
    """

    _FLUSH_CHARS = 24
    RETRY_BOUNDARY = "\n[retrying]\n"

    def __init__(self, inner: ModelClient, node: "BaseAgentNodeDef", ctx: Any):
        self._inner = inner
        self._node = node
        self._ctx = ctx
        self._attempts = 0
        # absolute-offset stamping: ONLY a RESUMED turn (the
        # backend yielded ResumeOffset) stamps its chunks — the ledger's
        # offset space is run-wide, and a non-resumed turn stamping from
        # 0 would make a multi-turn agent's SECOND turn read as a replay
        # of the first (suppressed as duplicate).  Non-resumed turns
        # emit offset=None and ride the ledger's cumulative law, which
        # carries across turns — the older behavior.
        self._offset = 0
        self._stamp = False

    @property
    def model_name(self) -> str:
        return self._inner.model_name

    async def _flush(self, buffer: list[str]) -> None:
        if not buffer:
            return
        text = "".join(buffer)
        buffer.clear()
        offset = self._offset if self._stamp else None
        if offset is not None:
            self._offset += len(text)
        from calfkit_tpu_torch.models.step import StepMessage, TokenStep
        from calfkit_tpu_torch.nodes.steps import publish_step_message

        try:
            await publish_step_message(
                self._node.transport,
                self._ctx.root_topic,
                StepMessage(
                    steps=[
                        TokenStep(
                            text=text, author=self._node.name, offset=offset
                        )
                    ],
                    emitter=self._node.emitter,
                ),
                correlation_id=self._ctx.correlation_id,
                task_id=self._ctx.task_id,
            )
        except Exception:  # noqa: BLE001 - token telemetry never faults a run
            pass

    async def request(self, messages, settings=None, params=None):
        from calfkit_tpu_torch.engine.model_client import (
            ResponseDone,
            ResumeOffset,
            TextDelta,
        )

        self._attempts += 1
        buffer: list[str] = []
        self._stamp = False
        self._offset = 0
        if self._attempts > 1:
            await self._flush([self.RETRY_BOUNDARY])
        first = True
        async for event in self._inner.request_stream(messages, settings, params):
            if isinstance(event, ResumeOffset):
                # the backend resumed decode-from-offset: this turn's
                # deltas begin past the already-delivered prefix — only
                # NOW does offset stamping engage (see __init__), and
                # only on the FIRST attempt: an internal output-retry
                # restarts the answer while the ledger already holds
                # attempt 1's deltas, so a re-stamped retry would read
                # as a partial replay and get suppressed mid-text
                if self._attempts == 1:
                    self._stamp = True
                    self._offset = event.chars
            elif isinstance(event, TextDelta):
                buffer.append(event.text)
                if first or sum(len(b) for b in buffer) >= self._FLUSH_CHARS:
                    first = False
                    await self._flush(buffer)
            elif isinstance(event, ResponseDone):
                await self._flush(buffer)
                return event.response
        raise RuntimeError("model stream ended without a terminal response")


class Agent(BaseAgentNodeDef):
    """The durable-conversation agent (per-run state rides the wire)."""


class StatelessAgent(Agent):
    """Alias reserved for the future durable-thread-memory split
    (reference: agent.py:1023-1031 naming)."""
