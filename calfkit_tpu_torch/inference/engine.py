"""The continuous-batching inference engine on PyTorch.

The counterpart of ``calfkit_tpu.inference.engine.InferenceEngine``: dense
or paged KV, single-shot or chunked prefill (with ragged unified waves and
the prefix cache), overlapped (or lockstep) multi-step decode dispatches,
and speculative decoding.

- a fixed pool of ``max_batch_size`` slots backed by ONE device-resident KV
  cache: dense [L, B, K, S, hd] rows, or a paged pool [L, N, K, page, hd]
  read and written through per-slot block tables; admission = a batched
  prefill wave that lands in free slots' rows (or reserved pages);
- paged KV reserves each request's whole page footprint at admission; with
  the prefix cache, a prompt's full pages are shared between requests
  that repeat them (an agent re-sending its instructions every turn), and
  idle cached pages are evicted when admission runs dry;
- chunked prefill advances an admission wave one ``prefill_chunk`` per
  scheduler pass; with ragged waves (the default when chunked prefill and
  overlap are on) the chunk rides the decode dispatch of the same tick;
- decode runs for all active slots together: one dispatch generates
  ``decode_steps_per_dispatch`` tokens per slot; the host syncs once per
  dispatch through :meth:`InferenceEngine._sync_host`, nowhere else on the
  launch path;
- overlapped dispatch (the default) enqueues dispatch N+1 before it waits
  for dispatch N, with stop and bound detection on the device, so the
  device never idles while the host fans tokens out.  The one stream of
  the device orders every dispatch after the one before it; the host waits
  on a CUDA event recorded after dispatch N's outputs were copied to pinned
  host memory, so waiting for N never waits for N+1.  A slot that retires
  while a dispatch still covers it keeps its pages (and its references to
  shared prefix pages) until that dispatch lands;
- speculative decoding (``RuntimeConfig.speculative``) replaces the decode
  dispatch with a lockstep verify tick: a drafter (n-gram lookup or a draft
  model) proposes up to ``k`` tokens per active request, one verify forward
  scores all k+1 positions against the cache through the ragged
  multi-query attention kernels, and each row accepts a prefix of its
  drafts plus one correction token.

Parts of the reference engine not ported yet raise instead of pretending:
``ValueError`` at construction for their configuration, ``InferenceError``
at submit for per-request deadlines, leases and priorities.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import logging
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

import numpy as np
import torch

from calfkit_tpu_torch.exceptions import InferenceError
from calfkit_tpu_torch.inference import model as M
from calfkit_tpu_torch.inference import ragged as ragged_math
from calfkit_tpu_torch.inference.config import ModelConfig, RuntimeConfig
from calfkit_tpu_torch.inference.paged import (
    TRASH_PAGE,
    PageAllocator,
    PrefixCache,
    chain_hashes,
    pages_needed,
    table_row,
)
from calfkit_tpu_torch.inference.sampler import (
    SamplingParams,
    fold_in,
    retire_mask_slots,
    sample_slots,
    spec_accept_slots,
)

logger = logging.getLogger(__name__)

_DONE = object()


def _deliver_batch(deliveries: "list[tuple[asyncio.Queue, list]]") -> None:
    """Event-loop side of the batched cross-thread token fan-out: each
    request's whole dispatch-worth of tokens lands as ONE queue item."""
    for queue, items in deliveries:
        queue.put_nowait(items)


def _finalize_wave_math(
    sampled: bool, paged: bool,
    k: torch.Tensor, v: torch.Tensor,  # engine cache or pool (in place)
    sk: torch.Tensor, sv: torch.Tensor,  # [L, R, K, P, hd] wave scratch
    last: torch.Tensor, lens: torch.Tensor,  # [B] engine state (in place)
    slots: torch.Tensor, true_lens: torch.Tensor,  # [R]
    last_logits: torch.Tensor,  # [R, V]
    slot_seeds: torch.Tensor, temp: torch.Tensor,  # [B] engine state (in place)
    top_k: torch.Tensor, top_p: torch.Tensor,
    seeds: torch.Tensor, w_temp: torch.Tensor,  # [R] wave values
    w_top_k: torch.Tensor, w_top_p: torch.Tensor,
    tables: "torch.Tensor | None" = None,  # [B, Pmax] (paged, in place)
    page_rows: "torch.Tensor | None" = None,  # [R, Pmax] the wave's table rows
    scatter_ids: "torch.Tensor | None" = None,  # [R, P // page] destination pages
) -> torch.Tensor:
    """The wave landing on the device, shared by single-shot and chunked
    prefill: copy the scratch K/V into the wave's cache rows (or scatter its
    pages into the pool and install its block-table rows), install per-slot
    sampling state, sample each row's first token from its last-position
    logits and scatter the wave's last/lens rows.  Updates the engine
    tensors in place → firsts [R] int32."""
    if paged:
        M.write_prefill_pages((k, v), (sk, sv), scatter_ids)
        tables[slots] = page_rows
    else:
        P = sk.shape[3]
        k[:, slots, :, :P] = sk
        v[:, slots, :, :P] = sv
    slot_seeds[slots] = seeds
    temp[slots] = w_temp
    top_k[slots] = w_top_k
    top_p[slots] = w_top_p
    if sampled:
        keys = fold_in(seeds, true_lens)
        firsts = sample_slots(last_logits, keys, w_temp, w_top_k, w_top_p)
    else:
        firsts = torch.argmax(last_logits, dim=-1).to(torch.int32)
    last[slots] = firsts
    lens[slots] = true_lens
    return firsts


@dataclass
class GenRequest:
    prompt: list[int]
    max_new_tokens: int
    stop_tokens: frozenset[int]
    sampling: SamplingParams | None = None  # None → engine default
    seed: int | None = None  # None → engine-derived per-admission stream
    out: asyncio.Queue = field(default_factory=asyncio.Queue)
    pages: list[int] = field(default_factory=list)  # paged-KV reservation
    # prefix caching: reused token count, the shared (cache-owned) page
    # prefix of ``pages``, and the prompt's full-page chain hashes
    reuse_len: int = 0
    shared_pages: list[int] = field(default_factory=list)
    page_hashes: list = field(default_factory=list)
    slot: int = -1
    generated: int = 0
    cancelled: bool = False
    corr: "str | None" = None  # the request's correlation id
    # the live _retire_heap entry ([bound, seq, request]); cleared at
    # retirement so the heap stops pinning this request's memory
    heap_entry: Any = None
    # speculative decoding only: prompt + every emitted token, kept by
    # _record_token and the spec tick; the drafters read it.  None when
    # speculation is off
    history: "list[int] | None" = None


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    prefill_waves: int = 0
    prefill_time_s: float = 0.0  # summed wall of prefill waves, launch to landing
    decode_tokens: int = 0
    decode_dispatches: int = 0
    decode_time_s: float = 0.0
    occupancy_sum: float = 0.0
    # dispatch counts per quartile of max_batch_size
    occupancy_hist: list = field(default_factory=lambda: [0, 0, 0, 0])
    short_dispatches: int = 0  # dispatches shortened for a waiting admission
    # pad tokens discarded because their row retired (or cancelled) while
    # the dispatch that generated them was already in flight
    overlap_wasted_tokens: int = 0
    cancelled_requests: int = 0  # consumer-cancelled requests reaped
    cancel_propagated: int = 0  # cancels that arrived via cancel_correlation
    prefix_hits: int = 0  # admissions that reused cached prefix pages
    prefix_reused_tokens: int = 0  # prompt tokens NOT re-prefilled
    # pages reclaimed from the prefix cache under allocation pressure, and
    # admissions whose page alloc came up short on the first try
    prefix_evictions: int = 0
    alloc_stalls: int = 0
    # ragged unified waves: prefill chunk tokens absorbed into decode
    # dispatches, and how many dispatches carried both kinds of work (the
    # absorbed chunk rows count as dispatch participants in the occupancy)
    prefill_absorbed_tokens: int = 0
    unified_dispatches: int = 0
    # speculative decoding: drafts offered to verify dispatches, drafts
    # accepted, tokens the verify dispatches emitted, and the active rows
    # summed over verify dispatches
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_emitted: int = 0
    spec_rows: int = 0

    @property
    def tokens_per_second(self) -> float:
        return self.decode_tokens / self.decode_time_s if self.decode_time_s else 0.0

    @property
    def mean_occupancy(self) -> float:
        if not self.decode_dispatches:
            return 0.0
        return self.occupancy_sum / self.decode_dispatches

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify dispatches accepted."""
        if not self.spec_proposed:
            return 0.0
        return self.spec_accepted / self.spec_proposed

    @property
    def tokens_per_dispatch(self) -> float:
        """Tokens emitted per sequence per verify dispatch: 1.0 is the
        non-speculative ratio, k+1 full acceptance."""
        if not self.spec_rows:
            return 0.0
        return self.spec_emitted / self.spec_rows


def _check_runtime(rt: RuntimeConfig) -> None:
    """Refuse what this engine does not serve yet, naming the later part of
    the port that will, and the configurations the reference refuses."""
    later = {
        "long_context": (rt.long_context, "multi-device"),
        "quantization": (rt.quantization is not None, "quantization/loader"),
        "tp/dp > 1": (rt.tp > 1 or rt.dp > 1, "multi-device"),
        "max_pending": (rt.max_pending > 0, "scheduler robustness"),
        "max_out_blocks": (rt.max_out_blocks > 0, "scheduler robustness"),
        "watchdog_stall_s": (rt.watchdog_stall_s > 0, "scheduler robustness"),
        "capacity_samples": (rt.capacity_samples > 0, "scheduler robustness"),
    }
    for knob, (requested, part) in later.items():
        if requested:
            raise ValueError(
                f"{knob} is not served by the PyTorch engine yet "
                f"(a later slice of the port: {part})"
            )
    if rt.chunked_prefill and rt.max_seq_len % rt.prefill_chunk:
        # buckets cap at max_seq_len; chunked admission needs every bucket
        # to be a whole number of chunks
        raise ValueError(
            "chunked_prefill requires prefill_chunk to divide "
            f"max_seq_len ({rt.prefill_chunk} vs {rt.max_seq_len})"
        )
    if rt.kv_layout not in ("dense", "paged"):
        raise ValueError(f"unsupported kv_layout {rt.kv_layout!r} (dense | paged)")
    if rt.kv_layout == "paged":
        if rt.prefill_chunk % rt.page_size:
            raise ValueError(
                "page_size must divide prefill_chunk "
                f"({rt.page_size} vs {rt.prefill_chunk})"
            )
        if rt.max_seq_len % rt.page_size:
            # a prefill bucket capped at max_seq_len must still be a whole
            # number of pages (page-granular scatter)
            raise ValueError(
                "page_size must divide max_seq_len "
                f"({rt.page_size} vs {rt.max_seq_len})"
            )
        if rt.prefix_cache and not rt.chunked_prefill:
            raise ValueError(
                "prefix_cache=True requires chunked_prefill=True "
                "(reuse seeds the chunk lane's scratch)"
            )
    elif rt.prefix_cache:
        raise ValueError(
            "prefix_cache=True requires kv_layout='paged' "
            "(reuse shares pages between requests)"
        )
    if rt.attention_impl != "auto":
        raise ValueError(
            f"unsupported attention_impl {rt.attention_impl!r}: the PyTorch "
            "engine takes only 'auto' (kernels on CUDA, plain versions on CPU)"
        )
    if rt.max_prefill_wave < 1 or rt.max_prefill_wave & (rt.max_prefill_wave - 1):
        raise ValueError(
            f"max_prefill_wave must be a power of two >= 1 (got {rt.max_prefill_wave})"
        )
    if rt.max_stop_tokens < 1:
        raise ValueError("max_stop_tokens must be >= 1")


def _pow2_floor(n: int) -> int:
    keep = 1
    while keep * 2 <= n:
        keep *= 2
    return keep


class InferenceEngine:
    def __init__(
        self,
        config: ModelConfig,
        runtime: RuntimeConfig | None = None,
        *,
        params: Any = None,
        sampling: SamplingParams | None = None,
        seed: int = 0,
        device: "torch.device | str" = "cuda",
        draft_params: Any = None,  # the speculative draft model's weights
    ):
        self.config = config
        self.runtime = runtime or RuntimeConfig()
        self.sampling = sampling or SamplingParams()
        rt = self.runtime
        _check_runtime(rt)
        self._spec = rt.speculative
        if self._spec is not None:
            if self._spec.k < 1:
                raise ValueError(f"speculative.k must be >= 1 (got {self._spec.k})")
            if self._spec.draft is None and draft_params is not None:
                raise ValueError("draft_params given but speculative.draft is unset")
        elif draft_params is not None:
            raise ValueError("draft_params given but speculation is off")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise InferenceError(
                    "no CUDA device: pass device='cpu' to run on the CPU"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
        dev = self.device
        if params is None:
            logger.info(
                "initializing random %s params (%.2fB)", config.name,
                config.param_count / 1e9,
            )
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
            params = M.init_params(config, generator)
        self.model = M.Decoder(params, dev)
        self.params = self.model.params()

        B, S = rt.max_batch_size, rt.max_seq_len
        self._paged = rt.kv_layout == "paged"
        self._prefix: "PrefixCache | None" = None
        if self._paged:
            n_pages = rt.pool_pages()
            self._k, self._v = M.make_page_pool(config, n_pages, rt.page_size, device=dev)
            self._tables = torch.zeros(
                (B, rt.pages_per_seq()), dtype=torch.int32, device=dev
            )
            self._page_alloc = PageAllocator(n_pages)
            if rt.prefix_cache:
                self._prefix = PrefixCache()
            logger.info(
                "paged KV pool: %d pages x %d tokens (%.2f GB)", n_pages,
                rt.page_size, 2 * self._k.numel() * self._k.element_size() / 1e9,
            )
        else:
            self._k, self._v = M.make_empty_cache(config, B, S, device=dev)
        self._last = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._lens = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._host_lens = np.zeros((B,), np.int64)  # host mirror for windows
        # device-side retirement inputs: each slot's stop tokens as a
        # fixed-shape row (-1 padded) and the absolute cache length at which
        # the row hits its hard generation bound (min(prompt + max_new - 1,
        # max_seq - 2)), written at activation and uploaded only when an
        # activation changed them
        self._stop_np = np.full((B, rt.max_stop_tokens), -1, np.int32)
        self._hard_end = np.zeros((B,), np.int32)
        self._retire_dev: "tuple[torch.Tensor, torch.Tensor] | None" = None
        self._done_zero = torch.zeros((B,), dtype=torch.bool, device=dev)
        # the launched-but-not-landed decode dispatch (overlap mode only)
        self._pend: "dict | None" = None
        self._last_sync_t: "float | None" = None  # the previous landing's clock
        # per-slot sampling state: row-wise knobs are data, so one decode
        # dispatch serves requests with different settings
        self._slot_seeds = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._temp = torch.zeros((B,), dtype=torch.float32, device=dev)
        self._top_k = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._top_p = torch.ones((B,), dtype=torch.float32, device=dev)
        self._admissions = 0  # per-request default seed stream

        self._free: list[int] = list(range(B))
        self._active: dict[int, GenRequest] = {}
        # bound-retirement horizon: a min-heap of [decode-clock step at
        # which the request hits a bound, tiebreak, request]; pushes on the
        # event loop, peeks on the decode thread, hence the lock
        self._retire_heap: list[list] = []
        self._retire_lock = threading.Lock()
        self._retire_seq = itertools.count()
        self._retire_stale = 0
        self._decode_clock = 0
        self._cancel_dirty = False  # at least one .cancelled flag is set
        # cancels whose snapshot lost the race with the decode thread:
        # re-matched on the next scheduler pass
        self._deferred_cancels: set[str] = set()
        # requests whose single-shot admission prefill runs in the worker thread
        self._admitting: list[GenRequest] = []
        self._inflight: "dict | None" = None  # chunked-prefill wave in flight
        self._carry: list[GenRequest] = []  # wave-trimmed, ahead of the queue
        self._pending: deque[GenRequest] = deque()
        # ragged unified waves: effective only where the fused dispatch has
        # both of its substrates, the chunk lane to absorb from and the
        # overlap launch path to ride; anything else runs the bifurcated
        # schedule (the parity oracle at ragged_waves=False)
        self._ragged = bool(rt.ragged_waves and rt.chunked_prefill and rt.overlap_dispatch)
        self._ragged_budget = ragged_math.token_budget(
            rt.ragged_token_budget, B, rt.decode_steps_per_dispatch,
            rt.prefill_chunk, rt.max_prefill_wave,
        )
        self._wake = asyncio.Event()
        self._task: asyncio.Task[None] | None = None
        self._running = False
        self.stats = EngineStats()
        self._drafter: Any = None
        if self._spec is not None:
            from calfkit_tpu_torch.inference.spec import build_drafter

            self._drafter = build_drafter(
                self._spec, rt, dev, draft_params=draft_params, seed=seed + 3
            )
            logger.info(
                "speculative decoding on: %s drafter, k=%d",
                "draft-model" if self._spec.draft is not None else "ngram", self._spec.k,
            )

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._loop = asyncio.get_running_loop()
        self._task = self._loop.create_task(self._serve(), name="inference-engine")

    async def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, timeout=30)
            except asyncio.TimeoutError:
                self._task.cancel()
            self._task = None
        self._finish_all()

    def _finish_all(self) -> None:
        """Terminate every waiter: active slots AND still-queued requests
        (a queued request left without _DONE hangs its generate() forever)."""
        if self._pend is not None:
            # abandon the in-flight dispatch; its deferred frees must
            # still run or the slots/pages leak into the next start()
            self._free_deferred(self._pend)
            self._pend = None
        for request in list(self._active.values()):
            request.out.put_nowait(_DONE)
        self._active.clear()
        for request in self._carry:
            request.out.put_nowait(_DONE)
        self._carry.clear()
        if self._inflight is not None:
            for request in self._inflight["wave"]:
                request.out.put_nowait(_DONE)
            self._inflight = None
        while self._pending:
            self._pending.popleft().out.put_nowait(_DONE)

    # -------------------------------------------------------------- submit
    async def generate(
        self,
        prompt: list[int],
        *,
        max_new_tokens: int = 256,
        stop_tokens: frozenset[int] = frozenset(),
        sampling: SamplingParams | None = None,
        seed: int | None = None,
        corr: str | None = None,
        run: str | None = None,
        deadline: float | None = None,
        lease: "tuple[str, float] | None" = None,
        priority: "str | None" = None,
    ) -> AsyncIterator[int]:
        """Submit a prompt; yields generated token ids as they decode.

        ``sampling``/``seed`` override the engine defaults for this request
        only.  Abandoning the iterator cancels the request: its slot is
        reclaimed at the next scheduler pass.  ``corr`` tags the request
        for :meth:`cancel_correlation`; ``run`` (the caller's run id) is
        accepted and not used by this engine yet.
        ``deadline``, ``lease`` and ``priority`` belong to a later slice of
        the port and raise :class:`InferenceError` when given."""
        for name, value in (("deadline", deadline), ("lease", lease), ("priority", priority)):
            if value is not None:
                raise InferenceError(
                    f"{name}= is not served by the PyTorch engine yet "
                    "(a later slice of the port: scheduler robustness)"
                )
        if not self._running:
            raise InferenceError("engine not started")
        if len(prompt) >= self.runtime.max_seq_len:
            raise InferenceError(
                f"prompt of {len(prompt)} tokens exceeds max_seq_len "
                f"{self.runtime.max_seq_len} (the long-context lane is a later "
                "slice of the port)"
            )
        if (
            self.runtime.overlap_dispatch or self._spec is not None
        ) and len(stop_tokens) > self.runtime.max_stop_tokens:
            # device-side retirement (overlapped decode, and every verify
            # dispatch) scans a fixed-shape per-slot stop table; silently
            # truncating the set would MISS stops
            raise InferenceError(
                f"request has {len(stop_tokens)} stop tokens but device-side"
                f" retirement caps the per-slot table at max_stop_tokens="
                f"{self.runtime.max_stop_tokens}; raise "
                "RuntimeConfig.max_stop_tokens (or set overlap_dispatch=False "
                "with speculation off for the host-side lockstep path)"
            )
        request = GenRequest(
            prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            stop_tokens=stop_tokens,
            sampling=sampling,
            seed=seed,
            corr=corr,
        )
        if self._drafter is not None:
            request.history = list(prompt)  # the drafters read prompt + output
        if self._paged:
            # reject what the pool could NEVER serve: re-queueing it would
            # wait (and starve everything behind it) forever
            reserve = self._reserve_pages(request, self._bucket_of(len(prompt)))
            usable = self._page_alloc.num_pages - 1
            if reserve > usable:
                raise InferenceError(
                    f"request needs {reserve} KV pages but the pool only has "
                    f"{usable}; lower max_new_tokens or raise num_kv_pages"
                )
        self._pending.append(request)
        self._wake.set()
        inner = self._consume(request)
        try:
            async for item in inner:
                yield item
        finally:
            # aclose() on OUR iterator must cancel NOW, not whenever the
            # asyncgen finalizer gets around to collecting the inner one
            await inner.aclose()

    def cancel_correlation(self, corr: str) -> int:
        """Abandon every request tagged ``corr`` (event-loop context);
        returns how many requests were newly flagged.  The scheduler's next
        pass reaps them through the ordinary cancellation path.  The decode
        thread may resize ``_active`` during the snapshot, so it retries and,
        if the race persists, defers the match to the scheduler pass."""
        if not corr:
            return 0
        for _ in range(4):
            try:
                candidates: list[GenRequest] = [
                    *self._active.values(), *self._carry, *self._pending,
                    *self._admitting,
                ]
                break
            except RuntimeError:
                continue
        else:
            self._deferred_cancels.add(corr)
            self._wake.set()
            return 0
        if self._inflight is not None:
            candidates += self._inflight["wave"]
        matched = 0
        for request in candidates:
            if request.corr == corr and not request.cancelled:
                request.cancelled = True
                matched += 1
        if matched:
            self.stats.cancel_propagated += matched
            self._cancel_dirty = True
            self._wake.set()
        return matched

    async def _consume(self, request: GenRequest) -> AsyncIterator[int]:
        """Drain a queued request's tokens; abandoning the iterator flags
        cancellation for the scheduler to reap."""
        done = False
        try:
            while True:
                item = await request.out.get()
                if item is _DONE:
                    done = True
                    return
                for token in item:  # one dispatch's token block
                    if token is _DONE:
                        done = True
                        return
                    yield token
        finally:
            if not done:
                request.cancelled = True
                self._cancel_dirty = True
                self._wake.set()

    # ------------------------------------------------------------ scheduler
    async def _serve(self) -> None:
        try:
            while self._running:
                self._drain_deferred_cancels()
                self._reap_cancelled()
                if self._ragged:
                    # ragged unified waves: ONE scheduler lane — the pass
                    # forms/advances the admission wave and the decode rows
                    # through a single fused dispatch per tick
                    if not await self._ragged_pass():
                        self._wake.clear()
                        if not self._pending and not self._carry:
                            await self._wake.wait()
                    continue
                if self.runtime.chunked_prefill:
                    progressed = await self._admit_chunked()
                else:
                    progressed = await self._admit()
                if self._active:
                    await asyncio.to_thread(
                        self._spec_decode_tick if self._drafter is not None
                        else self._decode_tick
                    )
                elif self._pend is not None:
                    # every participant retired/cancelled while a dispatch
                    # was in flight: land it so the deferred frees happen
                    await asyncio.to_thread(self._drain_decode)
                elif not progressed and self._inflight is None:
                    self._wake.clear()
                    if not self._pending and not self._carry:
                        await self._wake.wait()
        except Exception:  # noqa: BLE001 - the loop's crash rail
            logger.exception("inference engine scheduler crashed")
            self._running = False
            self._finish_all()

    def _drain_deferred_cancels(self) -> None:
        if not self._deferred_cancels:
            return
        pending, self._deferred_cancels = list(self._deferred_cancels), set()
        for corr in pending:
            self.cancel_correlation(corr)

    def _reap_cancelled(self) -> None:
        """Drain cancelled requests: active slots AND still-queued entries
        (event loop, between dispatches; cancellation itself only sets a
        flag).  A chunked inflight wave whose members ALL cancelled is
        aborted outright (slots, page reservations and prefix references
        released, remaining chunks skipped); a partly cancelled wave
        finishes its flight and sheds its cancelled members at activation.
        O(1) unless some flag was set since the last reap."""
        if not self._cancel_dirty:
            return
        self._cancel_dirty = False
        if self._inflight is not None and all(
            r.cancelled for r in self._inflight["wave"]
        ):
            for request in self._inflight["wave"]:
                self.stats.cancelled_requests += 1
                if request.slot != -1:
                    self._retire_slot(request)
                request.out.put_nowait(_DONE)
            self._inflight = None
        for request in list(self._active.values()):
            if request.cancelled:
                self.stats.cancelled_requests += 1
                self._retire_slot(request)
                request.out.put_nowait(_DONE)
        if any(r.cancelled for r in self._carry):
            kept = []
            for request in self._carry:
                if request.cancelled:
                    self.stats.cancelled_requests += 1
                    request.out.put_nowait(_DONE)
                else:
                    kept.append(request)
            self._carry = kept
        if any(r.cancelled for r in self._pending):
            kept_q: deque[GenRequest] = deque()
            for request in self._pending:
                if request.cancelled:
                    self.stats.cancelled_requests += 1
                    request.out.put_nowait(_DONE)
                else:
                    kept_q.append(request)
            self._pending = kept_q

    def _next_pending(self) -> GenRequest | None:
        while self._carry or self._pending:
            request = self._carry.pop(0) if self._carry else self._pending.popleft()
            if request.cancelled:
                self.stats.cancelled_requests += 1
                request.out.put_nowait(_DONE)
                continue
            return request
        return None

    def _peek_pending(self) -> GenRequest | None:
        for request in (*self._carry, *self._pending):
            if not request.cancelled:
                return request
        return None

    def _bucket_of(self, prompt_len: int) -> int:
        rt = self.runtime
        return min(
            -(-prompt_len // rt.prefill_chunk) * rt.prefill_chunk, rt.max_seq_len
        )

    # ------------------------------------------------------ page reservation
    def _reserve_pages(self, request: GenRequest, bucket: int) -> int:
        """Pages a request needs for its whole life: the prefill writes whole
        bucket pages, decode grows to (prompt + max_new), capped by the
        sequence limit."""
        rt = self.runtime
        total = min(len(request.prompt) + request.max_new_tokens + 1, rt.max_seq_len)
        return min(
            max(pages_needed(bucket, rt.page_size), pages_needed(total, rt.page_size)),
            rt.pages_per_seq(),
        )

    def _plan_prefix_reuse(self, request: GenRequest, bucket: int) -> int:
        """Longest cached, alignment-safe prompt prefix for ``request``
        (0 when caching is off or nothing matches).  Sets reuse_len /
        shared_pages / page_hashes on the request; recomputed fresh on
        every attempt (a carried-back request must not keep stale pages).

        Alignment: reuse must be whole PAGES (sharing granularity) and a
        whole number of CHUNKS (the chunk lane resumes at the reused
        offset), and at least the final chunk always recomputes (the first
        token samples from the last chunk's logits)."""
        request.reuse_len = 0
        request.shared_pages = []
        if self._prefix is None:
            return 0
        rt = self.runtime
        ps = rt.page_size
        if not request.page_hashes:  # the prompt is immutable: hash ONCE
            request.page_hashes = chain_hashes(request.prompt, ps)
        if not request.page_hashes:
            return 0
        matched = self._prefix.lookup(request.page_hashes)
        if not matched:
            return 0
        chunk = min(rt.prefill_chunk, bucket)
        align = ps * chunk // math.gcd(ps, chunk)
        candidate = min(
            len(matched) * ps,
            len(request.prompt) - 1,  # never reuse the final position
            bucket - chunk,           # at least one chunk recomputes
        )
        reuse = (candidate // align) * align
        if reuse <= 0:
            return 0
        request.reuse_len = reuse
        request.shared_pages = matched[: reuse // ps]
        return reuse

    def _drop_reuse_plan(self, request: GenRequest) -> None:
        """Undo a formation-time acquisition for a request that will NOT be
        served this pass (alloc failure / wave trim); re-admission replans
        from scratch."""
        if self._prefix is not None and request.shared_pages:
            self._prefix.release(request.shared_pages)
        request.reuse_len = 0
        request.shared_pages = []

    def _alloc_with_eviction(self, slot: int, n: int) -> "list[int] | None":
        pages = self._page_alloc.alloc(slot, n)
        if pages is None:
            self.stats.alloc_stalls += 1
            if self._prefix is not None:
                # idle cache entries are reclaimable capacity, not a leak
                freed = self._prefix.evict(
                    n - self._page_alloc.free_pages, self._page_alloc
                )
                self.stats.prefix_evictions += freed
                pages = self._page_alloc.alloc(slot, n)
        return pages

    # --------------------------------------------------------- wave formation
    def _form_wave(self) -> "tuple[list[GenRequest], int] | None":
        """Scheduling only (no device work): pop a same-bucket wave and
        assign slots (and, when paged, reserve each request's whole page
        footprint: admission control, no mid-flight OOM).  None when
        nothing can be admitted right now."""
        first = self._next_pending() if self._free else None
        if first is None:
            return None
        rt = self.runtime
        wave = [first]
        wave_bucket = self._bucket_of(len(first.prompt))
        # ragged mode: the wave may grow only as wide as the token budget
        # lets a dispatch absorb alongside the CURRENT decode load
        width_cap = self._ragged_wave_cap(wave_bucket)
        head_reuse = self._plan_prefix_reuse(first, wave_bucket)
        if head_reuse:
            # acquire at FORMATION: a later member's _alloc_with_eviction
            # must never reclaim pages an earlier member still needs
            self._prefix.acquire(first.shared_pages)
        while (
            len(wave) < len(self._free)
            and len(wave) < rt.max_prefill_wave
            and len(wave) < width_cap
            and (peeked := self._peek_pending()) is not None
            and self._bucket_of(len(peeked.prompt)) == wave_bucket
        ):
            # one offset per wave: only requests whose reuse TRIMS to the
            # head's length batch together
            planned = self._plan_prefix_reuse(peeked, wave_bucket)
            if head_reuse == 0 and planned != 0:
                break
            if head_reuse > 0:
                if planned < head_reuse:
                    break
                peeked.reuse_len = head_reuse
                peeked.shared_pages = peeked.shared_pages[: head_reuse // rt.page_size]
                self._prefix.acquire(peeked.shared_pages)
            wave.append(self._next_pending())
        # power-of-two waves; trimmed requests go to the FRONT carry list,
        # preserving arrival order
        keep = _pow2_floor(len(wave))
        for trimmed in wave[keep:]:  # balance formation-time acquisitions
            self._drop_reuse_plan(trimmed)
        self._carry = wave[keep:] + self._carry
        wave = wave[:keep]
        if not self._paged:
            for request in wave:
                request.slot = self._free.pop()
            return wave, wave_bucket
        # the tail of an unservable wave waits at the queue front
        granted: list[GenRequest] = []
        for i, request in enumerate(wave):
            slot = self._free.pop()
            shared = request.shared_pages  # acquired at formation
            need = self._reserve_pages(request, wave_bucket) - len(shared)
            pages = self._alloc_with_eviction(slot, need)
            if pages is None:
                self._free.append(slot)
                # EVERY carried member's acquisition is undone, or its
                # refcount leaks and the pages become unevictable forever
                for carried in wave[i:]:
                    self._drop_reuse_plan(carried)
                self._carry = wave[i:] + self._carry
                break
            request.slot = slot
            request.pages = shared + pages
            granted.append(request)
        if not granted:
            return None  # pool exhausted: wait for retirements
        # keep waves power-of-two after page trimming too
        keep = _pow2_floor(len(granted))
        for request in granted[keep:]:
            self._page_alloc.free(request.slot)
            self._free.append(request.slot)
            request.slot = -1
            request.pages = []
            self._drop_reuse_plan(request)
        self._carry = granted[keep:] + self._carry
        return granted[:keep], wave_bucket

    def _activate_wave(self, wave: list[GenRequest]) -> None:
        for request in wave:
            # a request can retire DURING its own prefill (first token was
            # a stop, or max_new_tokens == 1): its slot is already free
            if request.slot == -1:
                continue
            if request.cancelled:
                self.stats.cancelled_requests += 1
                self._retire_slot(request)
                request.out.put_nowait(_DONE)
                continue
            self._active[request.slot] = request
            self._track_retirement(request)
            row = self._stop_np[request.slot]
            row[:] = -1
            stops = sorted(request.stop_tokens)[: row.shape[0]]
            row[: len(stops)] = stops
            self._hard_end[request.slot] = min(
                len(request.prompt) + request.max_new_tokens - 1,
                self.runtime.max_seq_len - 2,
            )
            self._retire_dev = None  # device copies stale: re-upload at launch
            if self._drafter is not None:
                self._drafter.admit(request.slot, request.prompt)

    async def _admit(self) -> bool:
        admitted = False
        while (formed := self._form_wave()) is not None:
            wave, wave_bucket = formed
            self._admitting = wave
            try:
                await asyncio.to_thread(self._prefill_wave, wave, wave_bucket)
            finally:
                self._admitting = []
            self._activate_wave(wave)
            admitted = True
        return admitted

    # ------------------------------------------------------- device work
    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """Host array → device tensor without waiting for queued device
        work: a pinned staging copy and an asynchronous upload."""
        host = torch.from_numpy(np.ascontiguousarray(array).copy())
        if self.device.type == "cpu":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _stage_host(self, tensors: "tuple[torch.Tensor, ...]") -> tuple:
        """Enqueue device → host copies of ``tensors`` into pinned memory,
        then an event after them: :meth:`_sync_host` waits for exactly this
        work, never for dispatches enqueued later."""
        if self.device.type == "cpu":
            return tuple(tensors), None
        hosts = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in tensors
        )
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return hosts, event

    def _sync_host(self, staged: tuple) -> "tuple[np.ndarray, ...]":
        """THE designated device→host sync point of the dispatch loop."""
        hosts, event = staged
        if event is not None:
            event.synchronize()
        return tuple(t.numpy() for t in hosts)

    def _effective_sampling(self, request: GenRequest) -> SamplingParams:
        return request.sampling if request.sampling is not None else self.sampling

    def _wave_arrays(self, wave: list[GenRequest], bucket: int) -> dict:
        """Host-side array prep shared by single-shot and chunked prefill."""
        R = len(wave)
        tokens = np.zeros((R, bucket), np.int32)
        true_lens = np.zeros((R,), np.int32)
        slots = np.zeros((R,), np.int64)
        seeds = np.zeros((R,), np.int64)
        w_temp = np.zeros((R,), np.float32)
        w_top_k = np.zeros((R,), np.int32)
        w_top_p = np.ones((R,), np.float32)
        sampled = False
        for r, request in enumerate(wave):
            tokens[r, : len(request.prompt)] = request.prompt
            true_lens[r] = len(request.prompt)
            slots[r] = request.slot
            self._admissions += 1
            seeds[r] = (
                request.seed if request.seed is not None else self._admissions
            ) & 0xFFFFFFFF
            params = self._effective_sampling(request)
            w_temp[r] = params.temperature
            w_top_k[r] = params.top_k
            w_top_p[r] = params.top_p
            sampled |= not params.is_greedy
        return dict(
            tokens=tokens, true_lens=true_lens, slots=slots, seeds=seeds,
            w_temp=w_temp, w_top_k=w_top_k, w_top_p=w_top_p, sampled=sampled,
        )

    def _paged_wave_args(
        self, wave: list[GenRequest], bucket: int
    ) -> "tuple[np.ndarray, np.ndarray]":
        """The wave's block-table rows [R, Pmax] and the pages its prefill
        scatter writes [R, bucket // page]."""
        rt = self.runtime
        pmax = rt.pages_per_seq()
        npg = bucket // rt.page_size
        page_rows = np.zeros((len(wave), pmax), np.int32)
        scatter_ids = np.zeros((len(wave), npg), np.int64)
        for r, request in enumerate(wave):
            page_rows[r] = table_row(request.pages, pmax)
            # prefill writes whole bucket pages; reservation covers them
            scatter_ids[r] = page_rows[r, :npg]
            # reused pages are SHARED read-only: their scatter writes go to
            # the trash page (the scratch holds a copy of them anyway)
            scatter_ids[r, : request.reuse_len // rt.page_size] = TRASH_PAGE
        return page_rows, scatter_ids

    def _land_math(
        self, wave: list[GenRequest], bucket: int, arrays: dict,
        scratch: "tuple[torch.Tensor, torch.Tensor]", logits: torch.Tensor,
    ) -> torch.Tensor:
        """Enqueue a wave's landing from its scratch and its final chunk's
        logits [R, chunk, V] (the whole bucket for single-shot prefill) →
        firsts [R] (device).  Every row's last prompt position lives in the
        final chunk: the wave shares one bucket."""
        chunk = logits.shape[1]
        idx = np.clip(arrays["true_lens"] - 1 - (bucket - chunk), 0, chunk - 1)
        last_logits = logits[
            torch.arange(len(wave), device=logits.device), self._to_device(idx.astype(np.int64))
        ]
        d = {name: self._to_device(arrays[name]) for name in (
            "slots", "true_lens", "seeds", "w_temp", "w_top_k", "w_top_p",
        )}
        paged: dict = {}
        if self._paged:
            page_rows, scatter_ids = self._paged_wave_args(wave, bucket)
            paged = dict(
                tables=self._tables, page_rows=self._to_device(page_rows),
                scatter_ids=self._to_device(scatter_ids),
            )
        return _finalize_wave_math(
            arrays["sampled"], self._paged, self._k, self._v, *scratch,
            self._last, self._lens, d["slots"], d["true_lens"], last_logits,
            self._slot_seeds, self._temp, self._top_k, self._top_p,
            d["seeds"], d["w_temp"], d["w_top_k"], d["w_top_p"], **paged,
        )

    def _prefill(self, wave: list[GenRequest], bucket: int, arrays: dict) -> torch.Tensor:
        """Batched prefill: R admissions run as one [R, bucket] forward on a
        scratch cache, then land in the slot rows (or reserved pages) →
        firsts [R] (device)."""
        dev = self.device
        R, P = arrays["tokens"].shape
        scratch = M.make_empty_cache(self.config, R, P, dtype=self._k.dtype, device=dev)
        pos = torch.arange(P, dtype=torch.int32, device=dev).expand(R, P)
        logits, _ = M.forward(
            self.params, self.config, self._to_device(arrays["tokens"]), pos, scratch,
            torch.full((R,), P, dtype=torch.int32, device=dev),
        )
        return self._land_math(wave, bucket, arrays, scratch, logits)

    def _land_wave(
        self, wave: list[GenRequest], true_lens: np.ndarray,
        firsts: np.ndarray, elapsed: float,
    ) -> None:
        """Host side of the wave landing: stats, host-mirror lens, and the
        first-token emission, marshalled to the event loop in ONE batch."""
        self.stats.prefill_waves += 1
        self.stats.prefill_time_s += elapsed
        deliveries: list[tuple[asyncio.Queue, list]] = []
        for r, request in enumerate(wave):
            if request.slot == -1:
                continue
            self.stats.prefill_tokens += int(true_lens[r])
            # the prompt occupies [0, true_len); decode inserts from true_len
            self._host_lens[request.slot] = int(true_lens[r])
            items: list = []
            self._record_token(request, int(firsts[r]), items)
            if items:
                deliveries.append((request.out, items))
        if deliveries:
            self._loop.call_soon_threadsafe(_deliver_batch, deliveries)

    def _prefill_wave(self, wave: list[GenRequest], bucket: int) -> None:
        arrays = self._wave_arrays(wave, bucket)
        started = time.perf_counter()
        firsts = self._prefill(wave, bucket, arrays)
        # sync BEFORE timing: the device may still be running the wave
        (firsts,) = self._sync_host(self._stage_host((firsts,)))
        self._land_wave(wave, arrays["true_lens"], firsts, time.perf_counter() - started)

    # --------------------------------------------------- chunked admission
    async def _admit_chunked(self) -> bool:
        """One scheduler pass of chunked admission: start an inflight wave
        if none, then advance it by ONE chunk (finalizing on the last).  A
        decode tick runs between passes, so active streams' inter-token
        latency is bounded by one chunk instead of a whole bucket.  This is
        the bifurcated lane; with ragged waves on, the chunk instead rides
        the decode dispatch (:meth:`_ragged_pass`)."""
        if self._inflight is None:
            formed = self._form_wave()
            if formed is None:
                return False
            self._start_inflight_wave(*formed)
        if await asyncio.to_thread(self._advance_inflight):
            wave = self._inflight["wave"]
            self._inflight = None
            self._activate_wave(wave)
        return True

    def _start_inflight_wave(self, wave: list[GenRequest], bucket: int) -> None:
        """Stage a formed wave for chunked advancement: allocate (or
        prefix-seed) the scratch and record the chunk cursor.  Shared by
        the bifurcated chunked lane and the ragged unified lane."""
        chunk = min(self.runtime.prefill_chunk, bucket)
        reuse = wave[0].reuse_len  # uniform across the wave
        if reuse:
            # seed the scratch with the cached prefix K/V (each row's pages
            # copied from the pool) and resume the chunk loop at the reused
            # offset
            npg = reuse // self.runtime.page_size
            ids = np.asarray([request.pages[:npg] for request in wave], np.int64)
            scratch = self._seed_scratch(bucket, ids)
            self.stats.prefix_hits += len(wave)
            self.stats.prefix_reused_tokens += reuse * len(wave)
        else:
            scratch = M.make_empty_cache(
                self.config, len(wave), bucket, dtype=self._k.dtype, device=self.device
            )
        self._inflight = dict(
            wave=wave, bucket=bucket, chunk=chunk,
            n_chunks=-(-bucket // chunk), idx=reuse // chunk,
            arrays=self._wave_arrays(wave, bucket),
            scratch=scratch,
            started=time.perf_counter(),
        )

    def _seed_scratch(
        self, bucket: int, ids: np.ndarray
    ) -> "tuple[torch.Tensor, torch.Tensor]":
        """A fresh chunk-lane scratch [L, R, K, bucket, hd] whose first
        ``n`` pages per row are copied from the pool (``ids`` [R, n])."""
        cfg = self.config
        R, n = ids.shape
        span = n * self.runtime.page_size
        idx = self._to_device(ids)
        scratch = M.make_empty_cache(cfg, R, bucket, dtype=self._k.dtype, device=self.device)
        for side, pool in zip(scratch, (self._k, self._v)):
            pages = pool[:, idx]  # [L, R, n, K, page, hd]
            side[:, :, :, :span] = pages.permute(0, 1, 3, 2, 4, 5).reshape(
                cfg.n_layers, R, cfg.n_kv_heads, span, cfg.head_dim
            )
        return scratch

    def _chunk(self, inf: dict) -> torch.Tensor:
        """Enqueue the inflight wave's next prefill chunk: a forward of
        [R, chunk] tokens at the cursor's offset into the wave's scratch
        (written in place), then advance the cursor → logits [R, chunk, V]."""
        chunk, idx = inf["chunk"], inf["idx"]
        offset = idx * chunk
        tokens = inf["arrays"]["tokens"][:, offset:offset + chunk]
        R = tokens.shape[0]
        dev = self.device
        pos = (offset + torch.arange(chunk, dtype=torch.int32, device=dev)).expand(R, chunk)
        logits, _ = M.forward(
            self.params, self.config, self._to_device(tokens), pos, inf["scratch"],
            torch.full((R,), offset + chunk, dtype=torch.int32, device=dev),
        )
        inf["idx"] = idx + 1
        return logits

    def _advance_inflight(self) -> bool:
        """Run one chunk of the inflight wave in its OWN invocation (the
        bifurcated lane, and the ragged lane when the token budget refuses
        absorption); finalize after the last.  True when the wave landed."""
        inf = self._inflight
        logits = self._chunk(inf)
        if inf["idx"] < inf["n_chunks"]:
            return False
        return self._finalize_inflight(logits)

    def _finalize_inflight(self, logits: torch.Tensor) -> bool:
        """The chunked wave's landing (last chunk done): the landing math,
        the first-token sync, prefix registration.  One host sync per WAVE,
        shared by the bifurcated and ragged lanes."""
        inf = self._inflight
        wave, arrays = inf["wave"], inf["arrays"]
        firsts = self._land_math(wave, inf["bucket"], arrays, inf["scratch"], logits)
        # the wave's designated landing sync: first tokens must reach the
        # host for delivery (and real TTFT)
        (firsts,) = self._sync_host(self._stage_host((firsts,)))
        self._land_wave(wave, arrays["true_lens"], firsts, time.perf_counter() - inf["started"])
        if self._prefix is not None:
            for request in wave:
                self._register_prefix_pages(request)
        return True

    def _register_prefix_pages(self, request: GenRequest) -> None:
        """After landing: publish the request's freshly written full-prompt
        pages into the prefix cache.  Ownership transfers from the
        allocator (so retirement cannot free shared pages under later
        readers); the owning slot holds a reference until it retires.
        Decode never writes these pages: its first write lands at position
        prompt_len, past every registered page."""
        if request.slot == -1:  # retired during its own prefill
            return
        ps = self.runtime.page_size
        full = len(request.prompt) // ps
        if len(request.page_hashes) < full:
            request.page_hashes = chain_hashes(request.prompt, ps)
        fresh: list[int] = []
        for i in range(len(request.shared_pages), full):
            page = request.pages[i]
            if self._prefix.register(request.page_hashes[i], page):
                fresh.append(page)
            # else another request registered this chain position first:
            # this duplicate page stays private (slot-held, freed at
            # retirement), and LATER positions still register — sessions
            # sharing only a scaffold page must still cache their own
            # chains (equal chain hash ⇒ equal page content)
        if fresh:
            self._page_alloc.transfer_out(request.slot, fresh)
            self._prefix.acquire(fresh)
            request.shared_pages = request.shared_pages + fresh

    # ------------------------------------------------- ragged unified waves
    async def _ragged_pass(self) -> bool:
        """One pass of the unified lane: form a wave when none is in flight
        (its width capped by the token budget), then advance decode and
        chunk through one fused tick.  False only when there was nothing at
        all to do."""
        progressed = False
        if self._inflight is None:
            formed = self._form_wave()
            if formed is not None:
                self._start_inflight_wave(*formed)
                progressed = True
        if self._active or self._inflight is not None or self._pend is not None:
            if await asyncio.to_thread(self._ragged_tick):
                wave = self._inflight["wave"]
                self._inflight = None
                self._activate_wave(wave)
            progressed = True
        return progressed

    def _ragged_tick(self) -> bool:
        """One tick of the unified lane (decode-thread context): launch the
        fused (or decode-only) dispatch, then land the previous one — the
        double-buffered shape of :meth:`_decode_tick`, with the admission
        wave riding the launch.  True when the inflight wave landed."""
        if self._drafter is not None:
            # speculation stays lockstep (the drafter proposes from landed
            # history), so there is no launch to fuse the chunk into: the
            # wave advances in its own invocation right after the verify
            if self._active:
                self._spec_decode_tick()
            if self._inflight is not None:
                return self._advance_inflight()
            return False
        pend = self._pend
        finished = False
        if self._active:
            finished = self._launch_ragged()
        else:
            self._pend = None
            if self._inflight is not None:
                finished = self._advance_inflight()
        if pend is not None:
            deliveries = self._land_decode(pend)
            if not self._active:
                # the landing retired every participant: drain the
                # follow-up before a consumer can observe completion
                self._drain_decode()
            if deliveries:
                self._loop.call_soon_threadsafe(_deliver_batch, deliveries)
        return finished

    def _absorb_fits(self) -> bool:
        """May THIS dispatch absorb the inflight wave's next chunk?"""
        inf = self._inflight
        return inf is not None and ragged_math.fits_budget(
            self._ragged_budget, len(self._active),
            self.runtime.decode_steps_per_dispatch, len(inf["wave"]), inf["chunk"],
        )

    def _ragged_wave_cap(self, bucket: int) -> int:
        """Admission-width bound at formation: how many prefill rows the
        budget lets a dispatch absorb alongside the current decode load,
        charged at the wave's actual chunk, min(prefill_chunk, bucket).
        Without ragged waves, the batch width (no extra bound)."""
        if not self._ragged:
            return self.runtime.max_batch_size
        return ragged_math.wave_width_cap(
            self._ragged_budget, len(self._active),
            self.runtime.decode_steps_per_dispatch,
            min(self.runtime.prefill_chunk, bucket),
        )

    def _launch_ragged(self) -> bool:
        """Enqueue ONE dispatch for this tick: the inflight wave's next
        chunk and the decode dispatch, in that order on the one stream with
        no host sync between them, when a wave is in flight and the token
        budget admits it; else plain decode (with an over-budget chunk
        advancing in its own invocation, so admission never starves).  The
        outputs ride ``self._pend`` to the next tick's landing exactly like
        a plain overlapped launch."""
        inf = self._inflight
        if inf is None or not self._absorb_fits():
            self._launch_decode()
            return self._advance_inflight() if inf is not None else False
        active, window, steps, sampled = self._decode_args()
        if steps < self.runtime.decode_steps_per_dispatch:
            self.stats.short_dispatches += 1
        prev = self._pend
        done_prev = prev["done_dev"] if prev is not None else self._done_zero
        started = time.perf_counter()
        logits = self._chunk(inf)
        toks, n_valid, done = self._dispatch(active, window, steps, sampled, done_prev)
        R = len(inf["wave"])
        self.stats.prefill_absorbed_tokens += R * inf["chunk"]
        self.stats.unified_dispatches += 1
        self._stage_pend(toks, n_valid, done, steps, started, extra_rows=R)
        if inf["idx"] == inf["n_chunks"]:
            return self._finalize_inflight(logits)
        return False

    # ------------------------------------------------------------- decode
    def _window_bucket(self, needed: int) -> int:
        """Smallest configured window ≥ needed (cap max_seq): the decode
        attention scan only reads this prefix of the cache."""
        cap = self.runtime.max_seq_len
        for w in self.runtime.window_buckets:
            if needed <= w <= cap:
                return w
        return cap

    def _decode_fn(
        self, window: int, steps: int, sampled: bool,
        active: torch.Tensor, done_prev: torch.Tensor,
        stop_table: torch.Tensor, hard_end: torch.Tensor,
    ) -> "tuple[torch.Tensor, ...]":
        """The decode dispatch body: ``steps`` ring-buffer decode steps over
        the read-only cache window (dense rows, or ``ceil(window / page)``
        pages per row through the block tables), argmax or ``sample_slots``
        per step, then the ring's consolidation (in place) and
        ``retire_mask_slots``.  Enqueues device work only — no host sync.
        → (last, new_lens, toks [steps, B], n_valid, done)."""
        cfg = self.config
        # ``done_prev`` is the PREVIOUS dispatch's device-side done mask:
        # under overlap a row that retired there is frozen here by pure
        # device dataflow, before the host has seen that block (paged: its
        # consolidation writes go to the trash page)
        active = active & torch.logical_not(done_prev)
        last, lens = self._last, self._lens
        B = last.shape[0]
        ring_shape = (cfg.n_layers, steps, B, cfg.n_kv_heads, cfg.head_dim)
        ring = (
            torch.zeros(ring_shape, dtype=self._k.dtype, device=self.device),
            torch.zeros(ring_shape, dtype=self._v.dtype, device=self.device),
        )
        if self._paged:
            wpages = -(-window // self.runtime.page_size)
            pool, tables = (self._k, self._v), self._tables

            def step(tokens, ring, t):
                return M.decode_step_ring_paged(
                    self.params, cfg, tokens, pool, tables, ring, t, lens, wpages
                )
        else:
            window_kv = (self._k[:, :, :, :window], self._v[:, :, :, :window])

            def step(tokens, ring, t):
                return M.decode_step_ring(self.params, cfg, tokens, window_kv, ring, t, lens)

        toks = []
        for t in range(steps):
            logits, ring = step(last[:, None], ring, t)
            if sampled:
                # per-(request, position) streams: deterministic for a given
                # seed regardless of batch composition / slot reuse
                # (+1: position ``lens`` itself was the prefill's draw)
                keys = fold_in(self._slot_seeds, lens + t + 1)
                nxt = sample_slots(
                    logits[:, -1], keys, self._temp, self._top_k, self._top_p
                )
            else:
                nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            last = torch.where(active, nxt, last)
            toks.append(last)
        block = torch.stack(toks)  # [steps, B]
        if self._paged:
            M.consolidate_ring_paged((self._k, self._v), ring, self._tables, lens, active)
        else:
            M.consolidate_ring((self._k, self._v), ring, lens)
        new_lens = torch.where(active, lens + steps, lens)
        n_valid, done = retire_mask_slots(block.T, stop_table, hard_end - lens, active)
        return last, new_lens, block, n_valid, done

    # ---------------------------------------------------- speculative verify
    def _verify_fn(
        self, window: int, S: int, sampled: bool, active: torch.Tensor,
        drafts: torch.Tensor, ndraft: torch.Tensor,
    ) -> "tuple[torch.Tensor, ...]":
        """The speculative verify dispatch: feed [last, d_0..d_{S-2}] per
        row, score all S positions in one forward against the cache window
        (dense rows, or ``ceil(window / page)`` pages per row through the
        block tables), accept a ragged per-row prefix
        (``spec_accept_slots``), consolidate the chunk's K/V in place and
        advance each row by its own ``emitted``.  Rejected positions land
        past the advanced length and the next wave overwrites them, so
        nothing rolls back.  Inactive rows emit 0 (paged: their writes go to
        the trash page).  Enqueues device work only; updates the engine's
        last/lens → (out_toks [B, S], emitted, n_valid, done)."""
        cfg = self.config
        last, lens = self._last, self._lens
        tokens = torch.cat([last[:, None], drafts], dim=1)
        if self._paged:
            wpages = -(-window // self.runtime.page_size)
            logits, ring = M.verify_step_ring_paged(
                self.params, cfg, tokens, (self._k, self._v), self._tables, lens, wpages
            )
        else:
            window_kv = (self._k[:, :, :, :window], self._v[:, :, :, :window])
            logits, ring = M.verify_step_ring(self.params, cfg, tokens, window_kv, lens)
        out_toks, emitted = spec_accept_slots(
            logits, drafts, ndraft, lens, self._slot_seeds, self._temp, self._top_k,
            self._top_p, sampled=sampled,
        )
        emitted = torch.where(active, emitted, 0)
        if self._paged:
            M.consolidate_ring_paged((self._k, self._v), ring, self._tables, lens, active)
        else:
            M.consolidate_ring((self._k, self._v), ring, lens)
        idx = (emitted - 1).clamp(0, S - 1).to(torch.int64)
        new_last = torch.where(active, out_toks.gather(1, idx[:, None])[:, 0], last)
        stop_table, hard_end = self._retire_args()
        n_valid, done = retire_mask_slots(
            out_toks, stop_table, hard_end - lens, active, emitted=emitted
        )
        self._last, self._lens = new_last, lens + emitted
        return out_toks, emitted, n_valid, done

    def _spec_decode_tick(self) -> None:
        """One speculative wave: draft up to k tokens per active request,
        verify all of them plus the next position in ONE dispatch, deliver
        each row's accepted prefix and correction token.  Takes the place of
        :meth:`_decode_tick` when speculation is on.

        It stays lockstep even with ``overlap_dispatch``: the drafter needs
        the landed tokens of this wave to propose for the next, so nothing
        correct can be launched ahead.  Stop tokens and bounds are still
        classified on the device (``retire_mask_slots``), as in overlapped
        decode."""
        spec = self._spec
        B = self.runtime.max_batch_size
        active_mask = np.zeros((B,), bool)
        max_len = 1
        for slot in self._active:
            active_mask[slot] = True
            max_len = max(max_len, int(self._host_lens[slot]))
        window = self._window_bucket(max_len)
        # k drafts + 1 correction, shrunk so no row's chunk can write past
        # max_seq_len (a clamped write would slide back over valid history)
        cap = max(1, min(spec.k + 1, self.runtime.max_seq_len - max_len))
        # draft first, then size the wave to the longest proposal: a tick
        # whose drafter finds nothing dispatches a 1-wide verify
        proposals: dict[int, list[int]] = {}
        max_nd = 0
        if cap > 1:
            entries = [(slot, request.history) for slot, request in self._active.items()]
            for (slot, _), proposal in zip(entries, self._drafter.propose(entries)):
                proposal = proposal[: cap - 1]
                proposals[slot] = proposal
                max_nd = max(max_nd, len(proposal))
        S = min(cap, max_nd + 1)
        drafts = np.zeros((B, S - 1), np.int32)
        ndraft = np.zeros((B,), np.int32)
        for slot, proposal in proposals.items():
            drafts[slot, : len(proposal)] = proposal
            ndraft[slot] = len(proposal)
        sampled = any(not self._effective_sampling(r).is_greedy for r in self._active.values())
        # the dispatch wall starts after drafting, as in the reference:
        # decode_time_s times the verify dispatches, not the draft model
        started = time.perf_counter()
        out_toks, emitted, n_valid, done = self._sync_host(self._stage_host(self._verify_fn(
            window, S, sampled, self._to_device(active_mask), self._to_device(drafts),
            self._to_device(ndraft),
        )))  # [B, S] + the retirement arrays: the tick's landing sync
        elapsed = time.perf_counter() - started
        self._last_sync_t = time.perf_counter()
        # one verify forward advances the retirement clock by one step
        self._note_dispatch(elapsed, 1)
        deliveries: list[tuple[asyncio.Queue, list]] = []
        for slot, request in list(self._active.items()):
            count = int(emitted[slot])
            self._host_lens[slot] += count
            self.stats.spec_proposed += int(ndraft[slot])
            self.stats.spec_accepted += count - 1
            self.stats.spec_emitted += count
            self.stats.spec_rows += 1
            # the device's retirement classification: deliver the valid
            # prefix, retire on its done flag
            valid = int(n_valid[slot])
            items: list = out_toks[slot, :valid].tolist()
            request.history.extend(items)
            request.generated += valid
            self.stats.decode_tokens += valid
            if done[slot]:
                self._retire_slot(request)
                items.append(_DONE)
            if items:
                deliveries.append((request.out, items))
        if not self._active:
            self._last_sync_t = None
        if deliveries:
            self._loop.call_soon_threadsafe(_deliver_batch, deliveries)

    # ------------------------------------------------- retirement horizon
    def _short_steps(self) -> int:
        """Dispatch length while a waiting admission could actually unblock."""
        steps = self.runtime.decode_steps_per_dispatch
        return min(steps, max(4, steps // 4))

    def _retirement_bound(self, request: GenRequest) -> int:
        """Decode steps until the request hits a hard stop bound."""
        remaining = request.max_new_tokens - request.generated
        seq_room = self.runtime.max_seq_len - 1 - (
            len(request.prompt) + request.generated
        )
        return min(remaining, seq_room)

    def _track_retirement(self, request: GenRequest) -> None:
        with self._retire_lock:
            entry = [
                self._decode_clock + self._retirement_bound(request),
                next(self._retire_seq),
                request,
            ]
            request.heap_entry = entry
            heapq.heappush(self._retire_heap, entry)

    def _untrack_retirement(self, request: GenRequest) -> None:
        """Drop the heap's reference to a retired request now (the entry
        pops lazily); compacts once nulled entries outnumber live ones."""
        entry = request.heap_entry
        if entry is None:
            return
        request.heap_entry = None
        with self._retire_lock:
            entry[2] = None
            self._retire_stale += 1
            if self._retire_stale * 2 > len(self._retire_heap):
                self._retire_heap = [e for e in self._retire_heap if e[2] is not None]
                heapq.heapify(self._retire_heap)
                self._retire_stale = 0

    def _retirement_near(self, horizon: int) -> bool:
        """Will any active request hit a stop bound within ``horizon`` steps?"""
        with self._retire_lock:
            heap = self._retire_heap
            while heap and heap[0][2] is None:
                heapq.heappop(heap)
                self._retire_stale = max(0, self._retire_stale - 1)
            return bool(heap) and heap[0][0] <= self._decode_clock + horizon

    # ---------------------------------------------------------- decode tick
    def _decode_tick(self) -> None:
        """One scheduler tick of the decode lane.  Overlapped mode enqueues
        dispatch N+1 FIRST, then syncs and fans out dispatch N; lockstep
        mode (the oracle) launches, syncs and fans out."""
        if not self.runtime.overlap_dispatch:
            self._decode_tick_lockstep()
            return
        pend = self._pend
        if self._active:
            self._launch_decode()
        else:
            self._pend = None
        if pend is not None:
            deliveries = self._land_decode(pend)
            if not self._active:
                # the landing retired every participant: the dispatch just
                # launched is all zombies.  Land it NOW, before any consumer
                # can observe completion, so slots are fully accounted
                self._drain_decode()
            if deliveries:
                self._loop.call_soon_threadsafe(_deliver_batch, deliveries)

    def _drain_decode(self) -> None:
        """Land an in-flight dispatch whose participants have all retired."""
        pend, self._pend = self._pend, None
        if pend is not None:
            deliveries = self._land_decode(pend)
            if deliveries:
                self._loop.call_soon_threadsafe(_deliver_batch, deliveries)

    def _decode_args(self) -> "tuple[torch.Tensor, int, int, bool]":
        """Host-side inputs of one decode dispatch (shared by the overlap
        launch, the ragged launch and the lockstep tick) → (active mask,
        window, steps, sampled).  Pure host work and an asynchronous
        upload."""
        active_mask = np.zeros((self.runtime.max_batch_size,), bool)
        needed = 1
        for slot in self._active:
            active_mask[slot] = True
            needed = max(needed, int(self._host_lens[slot]))
        # the ring covers in-dispatch growth; the window only needs to cover
        # what's already in the main cache
        window = self._window_bucket(needed)
        full = self.runtime.decode_steps_per_dispatch
        # admissions waiting AND a retirement in reach: shorten the dispatch
        # so the freed slot isn't gated behind a full tick (length checks
        # only: this runs on the decode thread)
        pending = bool(self._carry) or bool(self._pending)
        steps = self._short_steps() if pending and self._retirement_near(full) else full
        sampled = any(
            not self._effective_sampling(r).is_greedy for r in self._active.values()
        )
        return self._to_device(active_mask), window, steps, sampled

    def _retire_args(self) -> "tuple[torch.Tensor, torch.Tensor]":
        """Device copies of the per-slot stop table + hard-bound lens,
        re-uploaded only after an activation rewrote them."""
        if self._retire_dev is None:
            self._retire_dev = (
                self._to_device(self._stop_np), self._to_device(self._hard_end)
            )
        return self._retire_dev

    def _dispatch(
        self, active: torch.Tensor, window: int, steps: int, sampled: bool,
        done_prev: torch.Tensor,
    ) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
        """Enqueue one decode dispatch and advance the engine's device state
        → (toks, n_valid, done) device handles."""
        stop_table, hard_end = self._retire_args()
        last, lens, toks, n_valid, done = self._decode_fn(
            window, steps, sampled, active, done_prev, stop_table, hard_end
        )
        self._last, self._lens = last, lens
        return toks, n_valid, done

    def _launch_decode(self) -> None:
        """Enqueue the next decode dispatch — NO host sync.  The previous
        dispatch's device-side done mask rides in as ``done_prev``, so a
        row that retired in the still-in-flight block is frozen out of
        this one (its slot and pages stay held until that block lands)."""
        active, window, steps, sampled = self._decode_args()
        if steps < self.runtime.decode_steps_per_dispatch:
            self.stats.short_dispatches += 1
        prev = self._pend
        done_prev = prev["done_dev"] if prev is not None else self._done_zero
        started = time.perf_counter()
        toks, n_valid, done = self._dispatch(active, window, steps, sampled, done_prev)
        self._stage_pend(toks, n_valid, done, steps, started)

    def _stage_pend(
        self, toks: torch.Tensor, n_valid: torch.Tensor, done: torch.Tensor,
        steps: int, started: float, extra_rows: int = 0,
    ) -> None:
        """Record a just-enqueued dispatch as the in-flight pend: host lens
        advance, the staged host copies of its outputs, and the snapshot its
        landing fans out against.  ``extra_rows`` counts absorbed prefill
        rows (occupancy participants landed with the dispatch)."""
        for slot in self._active:
            self._host_lens[slot] += steps
        self._pend = dict(
            staged=self._stage_host((toks, n_valid, done)),
            done_dev=done,
            steps=steps,
            started=started,
            participants=list(self._active.items()),
            slot_set=set(self._active.keys()),
            deferred=[],
            extra_rows=extra_rows,
        )

    def _land_decode(self, pend: dict) -> "list[tuple[asyncio.Queue, list]]":
        """Host side of a landed dispatch: ONE sync for the token block plus
        the device-computed retirement arrays, then batched fan-out.  Rows
        whose requests retired or cancelled while this dispatch was in
        flight are pad columns: discarded and counted, with their deferred
        slot/page frees released now.  Returns the deliveries — the CALLER
        posts them, after draining an all-zombie follow-up."""
        block, n_valid, done = self._sync_host(pend["staged"])
        now = time.perf_counter()
        # exclusive wall: clip to the span this dispatch alone occupied
        start = pend["started"]
        if self._last_sync_t is not None and self._last_sync_t > start:
            start = self._last_sync_t
        self._last_sync_t = now
        steps = pend["steps"]
        self._note_dispatch(
            now - start, steps, n_rows=len(pend["participants"]) + pend["extra_rows"]
        )
        deliveries: list[tuple[asyncio.Queue, list]] = []
        block_cols = np.ascontiguousarray(block.T)  # [B, steps]
        wasted = 0
        for slot, request in pend["participants"]:
            if self._active.get(slot) is not request:
                # one-dispatch-late retirement: the whole column is pad
                wasted += steps
                continue
            count = int(n_valid[slot])
            items: list = block_cols[slot][:count].tolist()
            request.generated += count
            self.stats.decode_tokens += count
            if done[slot]:
                self._retire_slot(request)
                items.append(_DONE)
            if items:
                deliveries.append((request.out, items))
        self.stats.overlap_wasted_tokens += wasted
        self._free_deferred(pend)
        if not self._active:
            self._last_sync_t = None  # idle boundary, not a bubble
        return deliveries

    def _free_deferred(self, pend: dict) -> None:
        """Release the slots, pages and prefix references of requests that
        retired while ``pend`` was in flight, now that no in-flight dispatch
        can write through a re-allocated page or read an evicted one."""
        for slot, shared in pend["deferred"]:
            if self._prefix is not None and shared:
                self._prefix.release(shared)
            if self._paged:
                self._page_alloc.free(slot)
            self._free.append(slot)

    def _decode_tick_lockstep(self) -> None:
        """The lockstep reference path: launch, sync, fan out — with the
        HOST as the retirement authority (arbitrary-size stop sets).  The
        overlapped path must produce identical token streams."""
        active, window, steps, sampled = self._decode_args()
        started = time.perf_counter()
        toks, _n_valid, _done = self._dispatch(
            active, window, steps, sampled, self._done_zero
        )
        for slot in self._active:
            self._host_lens[slot] += steps
        (block,) = self._sync_host(self._stage_host((toks,)))  # [steps, B]
        elapsed = time.perf_counter() - started
        self._last_sync_t = time.perf_counter()
        self._note_dispatch(elapsed, steps)
        if steps < self.runtime.decode_steps_per_dispatch:
            self.stats.short_dispatches += 1
        deliveries: list[tuple[asyncio.Queue, list]] = []
        block_cols = np.ascontiguousarray(block.T)  # [B, steps]
        for slot, request in list(self._active.items()):
            toks_row: list = block_cols[slot].tolist()
            # steps until a hard bound — the SAME formula the retire heap
            # predicts with
            bound = max(0, self._retirement_bound(request))
            if not request.stop_tokens or not request.stop_tokens.intersection(toks_row):
                if bound > steps:
                    request.generated += steps
                    self.stats.decode_tokens += steps
                    deliveries.append((request.out, toks_row))
                else:
                    # bound falls inside this block: deliver up to it, retire
                    items = toks_row[:bound]
                    request.generated += bound
                    self.stats.decode_tokens += len(items)
                    self._retire_slot(request)
                    items.append(_DONE)
                    deliveries.append((request.out, items))
                continue
            # a stop token is present: per-token authority loop
            items = []
            for token in toks_row:
                if self._record_token(request, token, items):
                    break
            if items:
                deliveries.append((request.out, items))
        if not self._active:
            self._last_sync_t = None
        if deliveries:
            self._loop.call_soon_threadsafe(_deliver_batch, deliveries)

    def _note_dispatch(
        self, elapsed: float, clock_steps: int, n_rows: int | None = None
    ) -> None:
        """Per-dispatch clock + stats.  ``n_rows`` pins the occupancy to the
        dispatch's participants (under overlap the landing runs after newer
        admissions changed ``_active``)."""
        with self._retire_lock:
            self._decode_clock += clock_steps
        self.stats.decode_dispatches += 1
        self.stats.decode_time_s += elapsed
        rows = n_rows if n_rows is not None else len(self._active)
        occupancy = rows / self.runtime.max_batch_size
        self.stats.occupancy_sum += occupancy
        self.stats.occupancy_hist[min(3, int(occupancy * 4))] += 1

    def _retire_slot(self, request: GenRequest) -> None:
        """Reclaim a request's slot, page reservation and shared-page
        references, and drop the retire-heap's reference, BEFORE any _DONE
        reaches the consumer.  When a launched-but-not-landed dispatch still
        covers the slot, the resource frees defer to that dispatch's landing
        (an in-flight dispatch must never find its pages re-allocated under
        it, nor its shared prefix pages evicted while it still reads them);
        everything observable updates now."""
        self._active.pop(request.slot, None)
        if self._drafter is not None and request.slot != -1:
            self._drafter.retire(request.slot)
        pend = self._pend
        if pend is not None and request.slot in pend["slot_set"]:
            pend["deferred"].append((request.slot, request.shared_pages))
        else:
            if self._prefix is not None and request.shared_pages:
                # shared pages return to the CACHE (refcount), never to the
                # free list while other readers may hold them
                self._prefix.release(request.shared_pages)
            if self._paged:
                self._page_alloc.free(request.slot)
            self._free.append(request.slot)
        request.shared_pages = []
        request.slot = -1
        self._untrack_retirement(request)

    def _record_token(self, request: GenRequest, token: int, items: list) -> bool:
        """THE retirement authority of host-side retirement: bump
        ``generated``, classify stop/exhaustion, reclaim the slot on
        retirement.  Appends deliverable tokens (and the _DONE sentinel) to
        ``items``; returns True when the request retired."""
        request.generated += 1
        hit_stop = token in request.stop_tokens
        if not hit_stop:
            items.append(token)
            self.stats.decode_tokens += 1
            if request.history is not None:  # speculation: drafter context
                request.history.append(token)
        # exhaustion == the retire heap's bound formula reaching zero
        done = hit_stop or self._retirement_bound(request) <= 0
        if done:
            self._retire_slot(request)
            items.append(_DONE)
        return done
