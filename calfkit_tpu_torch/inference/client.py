"""TorchLocalModelClient — the ModelClient that serves an agent turn on the
local PyTorch engine.

The port's counterpart of the JAX package's ``JaxLocalModelClient``: an
agent hands it a message history, it renders the history with a
deterministic plain template, tokenizes it, streams the engine's tokens
back as text deltas (re-decoding every few tokens, holding back an
incomplete multi-byte tail and cutting at stop sequences on the host), and
parses ``{"tool_name": ..., "args": ...}`` objects out of the answer as
tool calls (configurable via ``tool_call_parser``).  Like the reference, it
forwards the caller's context from the port's contextvars to the engine
(the trace id as the correlation id, the run, the deadline, the lease and
the priority class) and opens the ``engine.generate`` span with its
``engine.prefill`` and ``engine.decode`` children under the caller's.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, AsyncIterator, Callable

from calfkit_tpu_torch import leases, qos
from calfkit_tpu_torch.cancellation import current_deadline
from calfkit_tpu_torch.engine.model_client import (
    ModelClient,
    ModelRequestParameters,
    ModelSettings,
    ResponseDone,
    ResumeOffset,
    StreamEvent,
    TextDelta,
)
from calfkit_tpu_torch.exceptions import InferenceError
from calfkit_tpu_torch.models.messages import (
    ModelMessage,
    ModelRequest,
    ModelResponse,
    RetryPart,
    SystemPart,
    TextOutput,
    ToolCallOutput,
    ToolReturnPart,
    Usage,
    UserPart,
)
from calfkit_tpu_torch.models.payload import render_parts_as_text
from calfkit_tpu_torch.observability import capacity as _capacity
from calfkit_tpu_torch.observability.trace import TRACER, current_context

ToolCallParser = Callable[[str], tuple[str, list[ToolCallOutput]]]

# the re-decode cadence of a stream: bounds the cost of detokenizing
_EMIT_EVERY = 4


def default_tool_call_parser(text: str) -> tuple[str, list[ToolCallOutput]]:
    """Extract ``{"tool_name": ..., "args": {...}}`` objects (arbitrarily
    nested args) from the text; returns (remaining_text, calls)."""
    decoder = json.JSONDecoder()
    calls: list[ToolCallOutput] = []
    kept: list[str] = []
    i = 0
    while i < len(text):
        start = text.find("{", i)
        if start == -1:
            kept.append(text[i:])
            break
        obj = None
        try:
            obj, consumed = decoder.raw_decode(text, start)
        except ValueError:
            pass
        if isinstance(obj, dict) and isinstance(obj.get("tool_name"), str):
            args = obj.get("args", {})
            calls.append(
                ToolCallOutput(
                    tool_call_id=f"local_{int(time.time()*1000)}_{len(calls)}",
                    tool_name=obj["tool_name"],
                    args=args if isinstance(args, dict) else {},
                )
            )
            kept.append(text[i:start])
            i = consumed
        else:
            kept.append(text[i : start + 1])
            i = start + 1
    return "".join(kept).strip(), calls


def render_messages(
    messages: list[ModelMessage],
    params: ModelRequestParameters,
) -> str:
    """Deterministic chat rendering (the plain template)."""
    lines: list[str] = []
    system: list[str] = []
    for message in messages:
        if isinstance(message, ModelRequest):
            if message.instructions:
                system.append(message.instructions)
            for part in message.parts:
                if isinstance(part, SystemPart):
                    system.append(part.content)
                elif isinstance(part, UserPart):
                    content = (
                        part.content
                        if isinstance(part.content, str)
                        else render_parts_as_text(part.content)
                    )
                    author = f" ({part.author})" if part.author else ""
                    lines.append(f"<|user|>{author}\n{content}")
                elif isinstance(part, ToolReturnPart):
                    lines.append(
                        f"<|tool_result|> {part.tool_name}: "
                        f"{json.dumps(part.content, default=str)}"
                    )
                elif isinstance(part, RetryPart):
                    lines.append(f"<|user|>\n[retry] {part.content}")
        else:  # ModelResponse
            text = message.text()
            calls = message.tool_calls()
            body = text
            for call in calls:
                args = call.args if isinstance(call.args, str) else json.dumps(call.args)
                body += f'\n{{"tool_name": "{call.tool_name}", "args": {args}}}'
            lines.append(f"<|assistant|>\n{body.strip()}")

    tools = params.all_tools()
    if tools:
        tool_block = "\n".join(
            f"- {t.name}: {t.description}\n  parameters: "
            f"{json.dumps(t.parameters_schema)}"
            for t in tools
        )
        system.append(
            "You can call tools by replying with a JSON object "
            '{"tool_name": "<name>", "args": {...}} on its own line.\n'
            f"Available tools:\n{tool_block}"
        )
    header = f"<|system|>\n{chr(10).join(system)}\n" if system else ""
    return header + "\n".join(lines) + "\n<|assistant|>\n"


class TorchLocalModelClient(ModelClient):
    """Local inference on the PyTorch engine.

    Construction is cheap; device work (loading ``checkpoint``, a local HF
    directory, or random weights; engine start) happens on the first
    request or an explicit :meth:`start`.  The engine runs on ``device`` (a
    CUDA card unless ``device="cpu"``)."""

    def __init__(
        self,
        *,
        checkpoint: str | None = None,
        config: Any = None,  # ModelConfig | preset name
        runtime: Any = None,  # RuntimeConfig
        tokenizer: Any = None,
        sampling: Any = None,
        engine: Any = None,  # pre-built InferenceEngine (tests)
        tool_call_parser: ToolCallParser = default_tool_call_parser,
        max_new_tokens: int = 512,
        seed: int = 0,
        draft_checkpoint: str | None = None,
        draft_params: Any = None,
        device: str = "cuda",
    ):
        self._checkpoint = checkpoint
        self._config_spec = config
        self._runtime = runtime
        self._tokenizer = tokenizer
        self._sampling = sampling
        self._engine = engine
        self._parser = tool_call_parser
        self._max_new_tokens = max_new_tokens
        self._seed = seed
        self._draft_checkpoint = draft_checkpoint
        self._draft_params = draft_params
        self._device = device
        self._start_lock: asyncio.Lock | None = None

    @property
    def model_name(self) -> str:
        if self._engine is not None:
            return self._engine.config.name
        if isinstance(self._config_spec, str):
            return self._config_spec
        if self._config_spec is not None:
            return self._config_spec.name
        return self._checkpoint or "torch-local"

    # ------------------------------------------------------------- startup
    async def start(self) -> None:
        def ready() -> bool:
            return (
                self._engine is not None
                and self._engine._running
                and self._tokenizer is not None
            )

        if ready():
            return
        if self._start_lock is None:
            self._start_lock = asyncio.Lock()
        async with self._start_lock:
            if ready():
                return
            if self._engine is None:
                self._engine = await asyncio.to_thread(self._build_engine)
            await self._engine.start()
            if self._tokenizer is None:
                from calfkit_tpu_torch.inference.tokenizer import ByteTokenizer

                self._tokenizer = ByteTokenizer()

    def _build_engine(self) -> Any:
        from calfkit_tpu_torch.inference.config import RuntimeConfig, preset
        from calfkit_tpu_torch.inference.engine import InferenceEngine

        runtime = self._runtime or RuntimeConfig()
        draft_params = self._draft_params
        if self._draft_checkpoint is not None and draft_params is None:
            if runtime.speculative is None or runtime.speculative.draft is None:
                # a draft checkpoint that silently never loads would leave
                # the user speculating on the wrong drafter
                raise InferenceError(
                    "draft_checkpoint given but RuntimeConfig.speculative"
                    ".draft is unset — set SpecConfig(draft=<ModelConfig>)"
                )
            from calfkit_tpu_torch.inference.loader import load_params

            # the draft loads through the same loader as the target (its
            # own, smaller, config), unquantized
            draft_params = load_params(
                self._draft_checkpoint, runtime.speculative.draft, device=self._device
            )
        if self._checkpoint is not None:
            from calfkit_tpu_torch.inference.loader import config_from_hf, load_params
            from calfkit_tpu_torch.inference.tokenizer import HFTokenizer

            config = config_from_hf(self._checkpoint)
            if runtime.tp * runtime.dp > 1:
                from calfkit_tpu_torch.inference.loader import Checkpoint

                # every rank reads its own shard through the shard tree
                params: Any = Checkpoint(str(self._checkpoint))
            else:
                params = load_params(
                    self._checkpoint, config, device=self._device, quantize=runtime.quantization
                )
            if self._tokenizer is None:
                self._tokenizer = HFTokenizer(self._checkpoint)
            return InferenceEngine(
                config, runtime, params=params, sampling=self._sampling, seed=self._seed,
                device=self._device, draft_params=draft_params,
            )
        if isinstance(self._config_spec, str):
            config = preset(self._config_spec)
        elif self._config_spec is not None:
            config = self._config_spec
        else:
            raise InferenceError("TorchLocalModelClient needs a config or a checkpoint path")
        return InferenceEngine(
            config, runtime, sampling=self._sampling, seed=self._seed, device=self._device,
            draft_params=draft_params,
        )

    async def stop(self) -> None:
        if self._engine is not None:
            await self._engine.stop()

    def ready(self) -> "tuple[bool, str]":
        """Readiness probe: True only once the engine is BUILT (weights
        placed), its scheduler task is running and its dispatch-progress
        watchdog does not declare it wedged — distinct from liveness, which
        is true from process start.  Cheap enough to call per scrape."""
        engine = self._engine
        if engine is None:
            return False, "engine not built (weights not loaded)"
        if not engine._running:
            return False, "engine not started"
        if engine._wedged:
            # alive, but a dispatch is hung: routers place nothing new here
            return False, (
                "engine wedged: no dispatch progress for "
                f"{engine.runtime.watchdog_stall_s:.1f}s with work pending"
            )
        return True, "engine running"

    def stats_snapshot(self, *, window: bool = False) -> dict:
        """Live serving metrics (for the control-plane engine-stats advert),
        with the JAX client's key set; safe before start (zeros and the
        configured shape).

        ``window=True`` additionally reports per-interval rates since the
        PREVIOUS window=True call (``EngineStats.snapshot_and_delta`` —
        single-consumer by design: the heartbeat advert passes it; ad-hoc
        pollers must not, or they steal the heartbeat's intervals)."""
        engine = self._engine
        if engine is None:
            from calfkit_tpu_torch.inference.config import RuntimeConfig

            runtime = self._runtime or RuntimeConfig()  # mirror _build_engine
            pages_total = runtime.pool_pages() - 1 if runtime.kv_layout == "paged" else 0
            return {
                "model_name": self.model_name,
                "platform": "",
                "tokens_per_second": 0.0,
                "mean_occupancy": 0.0,
                "active_requests": 0,
                "pending_requests": 0,
                "free_slots": runtime.max_batch_size,
                "max_batch_size": runtime.max_batch_size,
                "kv_layout": runtime.kv_layout,
                "prefill_tokens": 0,
                "decode_tokens": 0,
                "decode_dispatches": 0,
                "overlap_dispatch": runtime.overlap_dispatch,
                "overlap_wasted_tokens": 0,
                # the EFFECTIVE setting: the flag engages only with chunked
                # prefill + overlap dispatch
                "ragged_waves": bool(
                    runtime.ragged_waves and runtime.chunked_prefill
                    and runtime.overlap_dispatch
                ),
                "prefill_absorbed_tokens": 0,
                "unified_dispatches": 0,
                "tokens_per_dispatch": 0.0,
                "max_pending": runtime.max_pending,
                "shed_requests": 0,
                "expired_requests": 0,
                "interactive_shed": 0,
                "batch_shed": 0,
                "interactive_expired": 0,
                "batch_expired": 0,
                "interactive_pending": 0,
                "batch_pending": 0,
                "cancelled_requests": 0,
                "cancel_propagated": 0,
                "delivery_stalled": 0,
                "orphaned_requests": 0,
                "dispatch_ewma_ms": 0.0,
                "wedged": False,
                "watchdog_trips": 0,
                "watchdog_faulted": 0,
                "flightrec": {"appended": 0, "dropped": 0, "dumped": 0},
                "pages_total": pages_total,
                "pages_in_use": 0,
                "prefix_resident_pages": 0,
                "evictions_window": 0,
                "alloc_stalls": 0,
                "capacity": _capacity.PageLedger(pages_total).breakdown(),
                "capacity_samples": {"appended": 0, "dropped": 0, "dumped": 0},
            }
        import torch

        stats = engine.stats
        rt = engine.runtime
        # per-class QUEUED depth (both lanes' queues); a flagged shed victim
        # still in the deque is not depth
        queued = [*engine._pending, *engine._carry, *engine._long_pending]
        interactive_pending = sum(1 for r in queued if not r.cancelled and r.priority != "batch")
        batch_pending = sum(1 for r in queued if not r.cancelled and r.priority == "batch")
        ledger = engine._ledger
        snapshot = {
            "model_name": engine.config.name,
            # JAX's platform names, so fleet consumers keep one vocabulary
            "platform": "gpu" if engine.device.type == "cuda" else "cpu",
            "tokens_per_second": round(stats.tokens_per_second, 1),
            "mean_occupancy": round(stats.mean_occupancy, 4),
            "active_requests": len(engine._active),
            # admitted but not yet holding a slot: active + pending is the
            # fleet router's queue-depth load signal
            "pending_requests": (
                len(engine._pending) + len(engine._carry) + len(engine._long_pending)
            ),
            "free_slots": len(engine._free),
            "max_batch_size": rt.max_batch_size,
            "kv_layout": rt.kv_layout,
            "prefill_tokens": stats.prefill_tokens,
            "decode_tokens": stats.decode_tokens,
            "decode_dispatches": stats.decode_dispatches,
            "overlap_dispatch": rt.overlap_dispatch,
            "overlap_wasted_tokens": stats.overlap_wasted_tokens,
            "ragged_waves": engine._ragged,
            "prefill_absorbed_tokens": stats.prefill_absorbed_tokens,
            "unified_dispatches": stats.unified_dispatches,
            "tokens_per_dispatch": round(stats.mean_tokens_per_dispatch, 3),
            "max_pending": rt.max_pending,
            "shed_requests": stats.shed_requests,
            "expired_requests": stats.expired_requests,
            "interactive_shed": stats.interactive_shed,
            "batch_shed": stats.batch_shed,
            "interactive_expired": stats.interactive_expired,
            "batch_expired": stats.batch_expired,
            "interactive_pending": interactive_pending,
            "batch_pending": batch_pending,
            "cancelled_requests": stats.cancelled_requests,
            "cancel_propagated": stats.cancel_propagated,
            "delivery_stalled": stats.delivery_stalled,
            "orphaned_requests": stats.orphaned_requests,
            "dispatch_ewma_ms": round(stats.dispatch_ewma_ms, 3),
            "wedged": engine._wedged,
            "watchdog_trips": stats.watchdog_trips,
            "watchdog_faulted": stats.watchdog_faulted,
            # ring overflow (dropped) is a signal, never silent truncation
            "flightrec": engine._journal.counts(),
            "pages_total": ledger.pages_total,
            "pages_in_use": ledger.pages_in_use,
            "prefix_resident_pages": ledger.prefix_resident_pages,
            "evictions_window": stats.prefix_evictions,
            "alloc_stalls": stats.alloc_stalls,
            "capacity": ledger.breakdown(),
            "capacity_samples": engine._sampler.counts(),
        }
        # latency percentiles from this engine's own fixed-bucket histograms
        engine._sync_metric_counters()
        m = engine.latency
        snapshot["latency_ms"] = {
            name: round(m[hist].percentile(q), 3)
            for hist, label in (
                ("ttft_ms", "ttft"),
                ("inter_token_ms", "inter_token"),
                ("queue_wait_ms", "queue_wait"),
                ("prefill_ms", "prefill"),
                ("dispatch_gap_ms", "dispatch_gap"),
            )
            for q, name in ((0.5, f"{label}_p50"), (0.99, f"{label}_p99"))
        }
        if window:
            # per-interval rates since the previous heartbeat; the advert's
            # eviction signal is per interval too (a lifetime count
            # flattens toward the mean as uptime grows)
            snapshot["window"] = stats.snapshot_and_delta()[1]
            snapshot["evictions_window"] = snapshot["window"]["prefix_evictions"]
        if rt.speculative is not None:
            snapshot["speculative"] = {
                "k": rt.speculative.k,
                "drafter": "draft-model" if rt.speculative.draft is not None else "ngram",
                "spec_proposed": stats.spec_proposed,
                "spec_accepted": stats.spec_accepted,
                "acceptance_rate": round(stats.acceptance_rate, 4),
                "tokens_per_dispatch": round(stats.tokens_per_dispatch, 3),
            }
        if engine._paged:
            snapshot["free_pages"] = engine._page_alloc.free_pages
            if engine._prefix is not None:
                snapshot["prefix_cached_pages"] = engine._prefix.size
                snapshot["prefix_hits"] = stats.prefix_hits
                snapshot["prefix_reused_tokens"] = stats.prefix_reused_tokens
        if engine.device.type == "cuda":
            # the caching allocator's bytes in use: JAX's bytes_in_use
            snapshot["hbm_gb_in_use"] = round(
                torch.cuda.memory_allocated(engine.device) / 1e9, 3
            )
        return snapshot

    # ------------------------------------------------------------- request
    async def request(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> ModelResponse:
        async for event in self.request_stream(messages, settings, params):
            if isinstance(event, ResponseDone):
                return event.response
        raise InferenceError("stream ended without a terminal response")

    async def request_stream(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> AsyncIterator[StreamEvent]:
        await self.start()
        params = params or ModelRequestParameters()
        settings = settings or ModelSettings()
        tokenizer = self._tokenizer
        prompt_text = render_messages(messages, params)
        prompt = [tokenizer.bos_id, *tokenizer.encode(prompt_text)]
        max_new = settings.max_tokens or self._max_new_tokens

        # decode-from-offset resume: the delivered prefix of a failed-over
        # stream enters as PREFILL (appended to the prompt, so the prefix
        # cache absorbs the shared prompt pages) and decode produces ONLY
        # the remaining budget; under greedy decode the continuation is
        # byte-exact with an unkilled run on a round-trip tokenizer
        resume_tokens: list[int] = []
        prior = ""
        if settings.resume_text:
            resume_tokens = list(tokenizer.encode(settings.resume_text))
            prior = tokenizer.decode(resume_tokens)
            prompt = prompt + resume_tokens
            max_new = max(0, max_new - len(resume_tokens))

        def terminal(full_text: str, generated_tokens: int) -> ResponseDone:
            # ONE terminal builder for both exits (the resumed spent-budget
            # short-circuit and the normal tail): parser gating, parts and
            # usage must not fork.  output_tokens counts what THIS engine
            # generated: a resumed run's delivered prefix is input (it
            # entered via prefill and was billed as output by the attempt
            # that generated it), so summing attempts never double-counts
            remaining, calls = (
                self._parser(full_text)
                if params.tool_defs or params.output_tool
                else (full_text, [])
            )
            parts: list[Any] = []
            if remaining:
                parts.append(TextOutput(text=remaining))
            parts.extend(calls)
            return ResponseDone(
                ModelResponse(
                    parts=parts,
                    usage=Usage(input_tokens=len(prompt), output_tokens=generated_tokens),
                    model_name=self.model_name,
                )
            )

        if settings.resume_text and max_new <= 0:
            # the delivered prefix already spent the whole token budget:
            # nothing to decode — the resumed stream is just its terminal
            yield ResumeOffset(len(prior))
            yield terminal(prior, 0)
            return

        # per-request sampling: each provided knob overrides that knob of
        # the engine default (top_p alone must NOT force greedy by zeroing
        # temperature); the engine batches mixed settings row-wise
        sampling = None
        if (
            settings.temperature is not None
            or settings.top_p is not None
            or settings.top_k is not None
        ):
            from calfkit_tpu_torch.inference.sampler import SamplingParams

            base = self._engine.sampling
            temperature = (
                settings.temperature if settings.temperature is not None else base.temperature
            )
            if temperature <= 0.0 and settings.temperature is None and (
                settings.top_p is not None or settings.top_k is not None
            ):
                # filtering was requested but the default is greedy: sample
                # at T=1 so top_p/top_k actually apply
                temperature = 1.0
            sampling = SamplingParams(
                temperature=temperature,
                top_k=settings.top_k if settings.top_k is not None else base.top_k,
                top_p=settings.top_p if settings.top_p is not None else base.top_p,
            )
        stops = [s for s in settings.stop_sequences if s]
        # stop sequences cut host-side on decoded text; hold back enough of
        # the tail that a sequence spanning an emission boundary is never
        # already streamed when it completes
        holdback = max((len(s) for s in stops), default=1) - 1

        def first_stop(text: str) -> int:
            hits = [i for s in stops if (i := text.find(s)) != -1]
            return min(hits) if hits else -1

        # trace spans: a caller that set the trace contextvar gets
        # engine.generate with prefill/decode children; untraced callers
        # pay one contextvar read
        trace_parent = current_context.get()
        gen_span = prefill_span = decode_span = None
        if trace_parent is not None:
            gen_span = TRACER.start_span(
                "engine.generate",
                parent=trace_parent,
                kind="engine",
                emitter=f"engine/{self.model_name}",
                attrs={
                    "model": self.model_name,
                    "prompt_tokens": len(prompt),
                    "max_new_tokens": max_new,
                },
            )
            prefill_span = TRACER.start_span(
                "engine.prefill", parent=gen_span.context, kind="engine",
                emitter=gen_span.emitter,
            )

        started = time.perf_counter()
        generated: list[int] = []
        # a resumed stream's deltas begin past the already-delivered prefix:
        # everything before ``emitted`` chars is prefill, never re-emitted
        emitted = len(prior)
        stopped_at = -1
        ttft_ms = 0.0
        if resume_tokens:
            yield ResumeOffset(len(prior))
        # the caller's context rides the same contextvar channels as the
        # trace: the engine journals under the trace id, attributes pages to
        # the run, enforces the caller's absolute deadline, registers the run
        # against its lease and orders sheds by its class
        token_stream = self._engine.generate(
            prompt,
            max_new_tokens=max_new,
            stop_tokens=frozenset({tokenizer.eos_id}),
            sampling=sampling,
            seed=settings.seed,
            corr=trace_parent.trace_id if trace_parent is not None else None,
            run=_capacity.current_run.get(),
            deadline=current_deadline.get(),
            lease=leases.current_lease.get(),
            priority=qos.current_priority.get(),
        )
        stream_exc: BaseException | None = None
        timing: dict = {}  # the engine's spans of this request, once landed
        try:
            async for token in token_stream:
                generated.append(token)
                if len(generated) == 1:
                    # the first token IS the TTFT moment: prefill ends and
                    # the decode phase starts here
                    ttft_ms = (time.perf_counter() - started) * 1000.0
                    if prefill_span is not None:
                        # the engine's queue wait, prefill span and reused
                        # tokens: its first token has landed
                        timing = self._engine.request_timing(trace_parent.trace_id) or {}
                        prefill_span.end(
                            ttft_ms=round(ttft_ms, 3),
                            **{k: timing[k] for k in ("queue_wait_ms", "prefill_span_ms")
                               if k in timing},
                        )
                        prefill_span = None
                        decode_span = TRACER.start_span(
                            "engine.decode", parent=gen_span.context,
                            kind="engine", emitter=gen_span.emitter,
                        )
                # the first token is emitted immediately; later ones batch
                # on the re-decode cadence
                if len(generated) % _EMIT_EVERY and len(generated) != 1:
                    continue
                # emit only the prefix that can't change: a trailing
                # replacement char may be a multi-byte sequence completing
                # (resume: the full text includes the prefilled prefix so
                # stop sequences spanning the resume boundary still cut)
                text = tokenizer.decode(resume_tokens + generated).rstrip("�")
                if stops:
                    stopped_at = first_stop(text)
                    if stopped_at != -1:
                        break
                    text = text[: len(text) - holdback] if holdback else text
                if len(text) > emitted:
                    yield TextDelta(text[emitted:])
                    emitted = len(text)
        except BaseException as exc:
            # captured here, not through sys.exc_info() in the finally,
            # which also reports exceptions merely being handled in an
            # enclosing frame (this generator resumes inside the consumer's)
            stream_exc = exc
            raise
        finally:
            # a break above abandons the stream; close NOW (not at GC) so
            # the engine reclaims the slot at its next tick
            await token_stream.aclose()
            # the span status tells HOW the stream ended: an engine fault is
            # error, a consumer abandoning the generator is cancelled, a
            # break or return is ok
            status = (
                None if stream_exc is None
                else "cancelled"
                if isinstance(stream_exc, (GeneratorExit, asyncio.CancelledError))
                else "error"
            )
            if prefill_span is not None:  # zero tokens: no decode phase
                prefill_span.end(status=status)
            if decode_span is not None:
                decode_span.end(status=status, generated_tokens=len(generated))
            if gen_span is not None:
                gen_span.end(
                    status=status, generated_tokens=len(generated), ttft_ms=round(ttft_ms, 3),
                    **{k: timing[k] for k in ("reused_tokens",) if k in timing},
                )

        full_text = tokenizer.decode(resume_tokens + generated)
        if stops and stopped_at == -1:
            stopped_at = first_stop(full_text)
        if stopped_at != -1:
            full_text = full_text[:stopped_at]
        if len(full_text) > emitted:
            yield TextDelta(full_text[emitted:])  # flush the tail
        yield terminal(full_text, len(generated))
