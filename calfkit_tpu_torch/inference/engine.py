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
  drafts plus one correction token;
- weight-only quantization (``RuntimeConfig.quantization``, int8 or int4)
  quantizes full-precision params at construction; the model dequantizes
  each weight at its use.  The draft model's params are not quantized;
- the robustness layer: bounded admission with the QoS shed order
  (``max_pending``), per-request deadlines and caller leases reaped queued
  or active, the delivery stall bound (``max_out_blocks``) and the
  dispatch-progress watchdog (``watchdog_stall_s``), each ending its
  requests with one typed error;
- telemetry: the flight recorder (a ring journal of every scheduling
  decision), the page ledger (who holds which KV page), the occupancy
  sampler (``capacity_samples``) and the ``/metrics`` instruments,
  observed per dispatch or per admission, never per token; the dispatch
  timeline (:mod:`~calfkit_tpu_torch.inference.timeline`): each
  dispatch's device time, the device's idle between dispatches put down
  to the host's phase, and each request's queue wait and prefill span, as
  :class:`EngineStats` counters;
- compiled dispatch: on a card every dispatch body (decode, verify, the
  ragged wave, a chunk, a single-shot prefill, the landing, the prefix
  seed) is captured once per key as a CUDA graph and replayed
  (:mod:`~calfkit_tpu_torch.inference.graphs`), the keys those of the JAX
  engine's jit caches; the bodies read and write the engine's tensors in
  place, at addresses fixed for the engine's life;
- the long-context lane (``RuntimeConfig.long_context``): a prompt of
  ``max_seq_len`` tokens or more is served one request at a time, its
  prefill over the whole padded prompt (monolithic, or a chunk per
  scheduler pass) into a scratch of its own and its decode against that
  prefix merged with a fresh-token cache
  (:mod:`~calfkit_tpu_torch.inference.ring_attention`), one long dispatch
  per scheduler pass between the short lane's.

Tensor and data parallelism (``RuntimeConfig(tp=, dp=)``) run one process
a rank (:mod:`.distributed`): rank 0 is this engine, with the scheduler
and every entry point; every other rank runs the same dispatches on its
shard (:meth:`InferenceEngine._serve_rank`).  Each dispatch rank 0 runs is
mirrored to the other ranks as a descriptor (the graph's recipe: the method
that built it and its key, then its host inputs), so every rank meets
every collective of the model (:mod:`.model`) in the same order.  dp splits
the decode and verify rows of the batch over the dp groups (the dense
cache's rows with them; the page pool stays whole on every group, the
dispatch's new K/V gathered before it is written); prefill waves run on
every group.  The long lane shards its prompt's sequence over every rank
(sp = tp·dp, the reference's layout): rank i holds positions [i·P/sp,
(i+1)·P/sp) of a prompt padded to P, with every kv head, in a prefix
scratch of 1/sp the one-device size; its fresh-token cache follows the
rank's tp shard.
"""

from __future__ import annotations

import asyncio
import functools
import gc
import heapq
import itertools
import logging
import math
import threading
import time
import traceback
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

import numpy as np
import torch

from calfkit_tpu_torch import cancellation, leases, qos
from calfkit_tpu_torch.exceptions import (
    DeadlineExceededError,
    EngineOverloadedError,
    EngineWedgedError,
    InferenceError,
    RunOrphanedError,
)
from calfkit_tpu_torch.inference import graphs
from calfkit_tpu_torch.inference import model as M
from calfkit_tpu_torch.inference import ragged as ragged_math
from calfkit_tpu_torch.inference import ring_attention as RA
from calfkit_tpu_torch.inference.config import ModelConfig, RuntimeConfig
from calfkit_tpu_torch.inference.paged import (
    TRASH_PAGE,
    PageAllocator,
    PrefixCache,
    chain_hashes,
    pages_needed,
    table_row,
)
from calfkit_tpu_torch.inference.quant import (
    bits_of,
    is_quantized,
    is_quantized4,
    quantize_params,
)
from calfkit_tpu_torch.inference.sampler import (
    SamplingParams,
    fold_in,
    retire_mask_slots,
    sample_slots,
    spec_accept_slots,
)
from calfkit_tpu_torch.inference.timeline import DispatchTimeline, EventClock, HostClock
from calfkit_tpu_torch.observability import capacity, flightrec
from calfkit_tpu_torch.observability.metrics import (
    INTER_TOKEN_BUCKETS_MS,
    REGISTRY,
    MetricsRegistry,
)

logger = logging.getLogger(__name__)

_DONE = object()
# the landed requests' timings kept by corr for request_timing
_TIMING_KEPT = 1024

# process-wide active-request aggregation: the shared gauge reports the
# SUM across live engines, not the last dispatching engine's count; the
# lock serializes insert/pop/sum across decode threads and the event loop
_ACTIVE_BY_ENGINE: dict[int, int] = {}
_ACTIVE_LOCK = threading.Lock()


def _drop_engine_active(key: int) -> None:
    """Remove one engine from the aggregation and re-set the gauge (at
    ``stop()`` and when an abandoned engine is collected)."""
    with _ACTIVE_LOCK:
        if _ACTIVE_BY_ENGINE.pop(key, None) is None:
            return
        total = sum(_ACTIVE_BY_ENGINE.values())
    REGISTRY.gauge("calfkit_engine_active_requests").set(total)


def _engine_metrics(
    registry: "MetricsRegistry | None" = None, *, histograms_only: bool = False
) -> dict:
    """The engine's instruments, get-or-create from ``registry`` (default:
    the process registry, shared by every engine of the process for the
    ``/metrics`` exposition; each engine also keeps a private
    ``histograms_only`` set for its own percentiles).  The reference's
    names, help and buckets.  Everything observed here is PER DISPATCH or
    PER ADMISSION, never per token."""
    reg = registry if registry is not None else REGISTRY
    out: dict = {
        "queue_wait_ms": reg.histogram(
            "calfkit_engine_queue_wait_ms", "submit-to-prefill-start wait (ms)",
        ),
        "prefill_ms": reg.histogram(
            "calfkit_engine_prefill_ms", "prefill wave latency, admission to landing (ms)",
        ),
        "ttft_ms": reg.histogram(
            "calfkit_engine_ttft_ms",
            "time to first token: submit to first-token emission (ms)",
        ),
        "inter_token_ms": reg.histogram(
            "calfkit_engine_inter_token_ms",
            "per-sequence inter-token latency (dispatch wall / steps, ms)",
            buckets=INTER_TOKEN_BUCKETS_MS,
        ),
        "decode_dispatch_ms": reg.histogram(
            "calfkit_engine_decode_dispatch_ms",
            "one decode/verify dispatch, enqueue to host sync (ms)",
        ),
        "dispatch_gap_ms": reg.histogram(
            "calfkit_engine_dispatch_gap_ms",
            "device idle before a decode, ragged or verify dispatch, on the "
            "device's clock: previous dispatch's end to this one's start (ms)",
            buckets=INTER_TOKEN_BUCKETS_MS,
        ),
    }
    if histograms_only:
        return out
    out.update(
        decode_tokens=reg.counter("calfkit_engine_decode_tokens_total", "decoded tokens emitted"),
        prefill_tokens=reg.counter(
            "calfkit_engine_prefill_tokens_total", "prompt tokens prefilled"
        ),
        spec_proposed=reg.counter(
            "calfkit_engine_spec_proposed_total",
            "speculative draft tokens offered to verify dispatches",
        ),
        spec_accepted=reg.counter(
            "calfkit_engine_spec_accepted_total",
            "speculative draft tokens accepted by verify dispatches",
        ),
        overlap_wasted_tokens=reg.counter(
            "calfkit_engine_overlap_wasted_tokens_total",
            "pad tokens discarded by one-dispatch-late retirement (overlapped execution)",
        ),
        active_requests=reg.gauge(
            "calfkit_engine_active_requests",
            "requests holding a slot (summed across the process's engines)",
        ),
    )
    return out


def _call_weak(method: "weakref.WeakMethod", *args: Any) -> Any:
    """Run an engine method on the ``asyncio.to_thread`` worker through a
    weak reference: the worker keeps its work item (and so this function's
    arguments) for a moment after the call returns, and a strong bound
    method there would keep a dropped engine alive.  The engine is held
    only by this frame, while the call runs."""
    fn = method()
    if fn is None:
        raise InferenceError("the engine was dropped before its dispatch ran")
    timeline = fn.__self__._timeline
    timeline.phase("prep")
    try:
        return fn(*args)
    finally:
        timeline.phase("loop")


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
    cache_rows: "tuple[int, int] | None" = None,  # dp: (first slot, rows) of a dense cache
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
        rows = slots
        if cache_rows is not None:
            # a dp group's cache holds its own slots' rows: the other
            # groups' slots land in its trash row (index ``rows``)
            lo, n = cache_rows
            rows = torch.where((slots >= lo) & (slots < lo + n), slots - lo, n)
        k[:, rows, :, :P] = sk
        v[:, rows, :, :P] = sv
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
    prefill_ms: float = 0.0
    cancelled: bool = False
    # the absolute deadline (epoch seconds on cancellation.wall_clock),
    # None = undeadlined; ``expired`` marks a deadline reap and ``stalled``
    # a max_out_blocks stall-cancel, so the consumer raises a typed error
    deadline: "float | None" = None
    expired: bool = False
    stalled: bool = False
    # the caller's liveness lease (None = un-leased); ``orphaned`` marks a
    # lease-lapse reap (typed RunOrphanedError)
    lease_id: "str | None" = None
    lease_ttl: float = 0.0
    lease_entry: "list | None" = None  # the live _lease_heap entry
    orphaned: bool = False
    # the QoS class, resolved at submit; ``shed`` marks a QUEUED request
    # evicted for an interactive one at a full lane, with the (lane,
    # pending, limit) seen at the eviction
    priority: str = "interactive"
    shed: bool = False
    shed_detail: "tuple[str, int, int] | None" = None
    # the watchdog faulted this request (typed, retriable EngineWedgedError)
    wedged: bool = False
    deadline_entry: "list | None" = None  # the live _deadline_heap entry
    # the request's correlation id (the flight recorder's join key) and
    # the caller's run id (the page ledger's owner tag): precomputed
    # strings, so journal and ledger appends never format
    corr: "str | None" = None
    run: "str | None" = None
    started_at: float = field(default_factory=time.perf_counter)
    formed_at: float = 0.0  # the formation of the wave that admits it
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
    # the long-context lane's requests (counted at their prefill's landing)
    # and decode dispatches (landed; not decode_dispatches, whose count is
    # mean_occupancy's denominator)
    long_requests: int = 0
    long_dispatches: int = 0
    # admission sheds, deadline expiries, their per-class splits, delivery
    # stall-cancels, lease orphans, and the wedge watchdog's trips and the
    # requests it faulted
    shed_requests: int = 0
    expired_requests: int = 0
    delivery_stalled: int = 0
    orphaned_requests: int = 0
    watchdog_trips: int = 0
    watchdog_faulted: int = 0
    interactive_shed: int = 0
    batch_shed: int = 0
    interactive_expired: int = 0
    batch_expired: int = 0
    # per admitted request (both lanes, at its first token's landing):
    # submit → the formation of its wave, and that formation → the landing
    admitted_requests: int = 0
    queue_wait_s: float = 0.0
    prefill_span_s: float = 0.0
    # steps of every landed decode-kind or mixed dispatch (a verify is one)
    decode_steps: int = 0
    # the dispatch timeline (inference/timeline.py), on the device's clock:
    # dispatch time by kind, the idle between dispatches while the engine
    # held work, that idle split by the host phase it overlapped (the five
    # sum to device_gap_s), and its part that followed a draining sync
    device_decode_s: float = 0.0
    device_mixed_s: float = 0.0
    device_prefill_s: float = 0.0
    device_gap_s: float = 0.0
    gap_schedule_s: float = 0.0
    gap_loop_s: float = 0.0
    gap_prep_s: float = 0.0
    gap_launch_s: float = 0.0
    gap_land_s: float = 0.0
    gap_drained_s: float = 0.0
    # EWMA of decode-dispatch latency (ms), the fleet router's tiebreak: a
    # fold, not a counter (never in _COUNTER_FIELDS or window deltas)
    dispatch_ewma_ms: float = 0.0
    # snapshot_and_delta state: the previous window's counter values and
    # timestamp.  Single-consumer by design (the heartbeat advert): two
    # delta readers would steal each other's intervals
    _window: Any = field(default=None, repr=False, compare=False)
    # the engine's graph pool's counts (graphs.GraphPool.stats), mirrored
    # as graph_captures and graph_capture_s
    _graph_stats: dict = field(
        default_factory=lambda: dict(captures=0, capture_s=0.0), repr=False, compare=False,
    )

    _COUNTER_FIELDS = (
        "prefill_tokens", "decode_tokens", "decode_dispatches",
        "decode_time_s", "occupancy_sum", "short_dispatches",
        "long_requests", "long_dispatches", "prefix_hits",
        "prefix_reused_tokens", "spec_proposed", "spec_accepted",
        "spec_emitted", "spec_rows", "overlap_wasted_tokens",
        "shed_requests", "expired_requests", "cancelled_requests",
        "cancel_propagated", "delivery_stalled", "orphaned_requests",
        "prefill_absorbed_tokens", "unified_dispatches",
        "watchdog_trips", "watchdog_faulted",
        "prefix_evictions", "alloc_stalls",
        "interactive_shed", "batch_shed",
        "interactive_expired", "batch_expired",
        "admitted_requests", "queue_wait_s", "prefill_span_s", "decode_steps",
        "device_decode_s", "device_mixed_s", "device_prefill_s", "device_gap_s",
        "gap_schedule_s", "gap_loop_s", "gap_prep_s", "gap_launch_s", "gap_land_s",
        "gap_drained_s", "graph_captures", "graph_capture_s",
    )

    # EWMA smoothing for dispatch_ewma_ms: about five dispatches of memory
    EWMA_ALPHA = 0.2

    def note_dispatch_ewma(self, sample_ms: float) -> None:
        """Fold one dispatch's wall latency into the EWMA; the first sample
        primes the fold directly (a zero start would under-report)."""
        prev = self.dispatch_ewma_ms
        if prev == 0.0:
            self.dispatch_ewma_ms = sample_ms
        else:
            a = self.EWMA_ALPHA
            self.dispatch_ewma_ms = a * sample_ms + (1.0 - a) * prev

    def counters(self) -> dict:
        """Every cumulative counter as a plain dict (occupancy_hist as a
        copied list): the windowing substrate."""
        out: dict = {f: getattr(self, f) for f in self._COUNTER_FIELDS}
        out["occupancy_hist"] = list(self.occupancy_hist)
        return out

    def snapshot_and_delta(self) -> "tuple[dict, dict]":
        """(cumulative, per-interval delta) since the previous call; the
        first call's delta covers everything since construction."""
        now = time.monotonic()
        cur = self.counters()
        prev, prev_t = self._window or (
            {f: 0 for f in self._COUNTER_FIELDS} | {"occupancy_hist": [0, 0, 0, 0]},
            None,
        )
        delta: dict = {f: cur[f] - prev[f] for f in self._COUNTER_FIELDS}
        delta["occupancy_hist"] = [
            a - b for a, b in zip(cur["occupancy_hist"], prev["occupancy_hist"])
        ]
        delta["interval_s"] = round(now - prev_t, 3) if prev_t is not None else None
        dt = delta["decode_time_s"]
        delta["tokens_per_second"] = round(delta["decode_tokens"] / dt, 1) if dt > 0 else 0.0
        dd = delta["decode_dispatches"]
        delta["mean_occupancy"] = round(delta["occupancy_sum"] / dd, 4) if dd else 0.0
        self._window = (cur, now)
        return cur, delta

    @property
    def graph_captures(self) -> int:
        """CUDA graph captures of the engine's dispatches (each shape's first call on a card)."""
        return self._graph_stats["captures"]

    @property
    def graph_capture_s(self) -> float:
        """Seconds of those first calls: the eager run and the capture."""
        return self._graph_stats["capture_s"]

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
    def mean_tokens_per_dispatch(self) -> float:
        """Tokens processed per decode dispatch: decode tokens plus the
        prefill chunk tokens ragged waves absorbed into those dispatches."""
        if not self.decode_dispatches:
            return 0.0
        return (self.decode_tokens + self.prefill_absorbed_tokens) / self.decode_dispatches

    @property
    def tokens_per_dispatch(self) -> float:
        """Tokens emitted per sequence per verify dispatch: 1.0 is the
        non-speculative ratio, k+1 full acceptance."""
        if not self.spec_rows:
            return 0.0
        return self.spec_emitted / self.spec_rows


def _check_runtime(rt: RuntimeConfig) -> None:
    """Refuse the configurations the reference refuses."""
    if rt.tp < 1 or rt.dp < 1:
        raise ValueError(f"tp and dp must be >= 1 (got tp={rt.tp}, dp={rt.dp})")
    if rt.quantization is not None:
        bits_of(rt.quantization)
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


def _quantized(params: Any, quantization: str) -> Any:
    """``params`` at the runtime's weight-only quantization: full-precision
    params quantize where they lie, each tensor freed as it quantizes (peak
    ~1x the model); params already quantized at that bitness pass through."""
    bits = bits_of(quantization)
    wq = params.get("layers", {}).get("wq")
    matching = is_quantized(wq) if bits == 8 else is_quantized4(wq)
    if (is_quantized(wq) or is_quantized4(wq)) and not matching:
        raise ValueError(
            f"params are pre-quantized at the other bitness than "
            f"runtime quantization={quantization!r}"
        )
    return params if matching else quantize_params(params, consume=True, bits=bits)


def _replicated(method: Any) -> Any:
    """A graph method of the engine: the dispatch it returns carries its
    recipe (the method's name and arguments), by which every other rank of
    a multi-rank engine builds the same dispatch (:meth:`InferenceEngine._serve_rank`)."""
    name = method.__name__

    @functools.wraps(method)
    def build(self: "InferenceEngine", *args: Any) -> graphs.CapturedDispatch:
        fn = method(self, *args)
        if fn.recipe is None:
            fn.recipe = ("engine", name, args)
        return fn

    return build


def _is_rank_fault(exc: BaseException) -> bool:
    from calfkit_tpu_torch.inference.distributed import RankFault

    return isinstance(exc, RankFault)


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
        mesh: Any = None,  # a sharding.Mesh of tp x dp ranks (default: from runtime)
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
        # the multi-rank state: this process's rank, the workers it spawned,
        # the descriptor channel, this rank's layout (None on one device)
        self.mesh = mesh
        self._rank = 0
        self._workers: Any = None
        self._channel: Any = None
        self._layout: Any = None
        self._draft_local: Any = None
        if rt.tp * rt.dp > 1 or (mesh is not None and mesh.size > 1):
            params = self._join_group(params, draft_params, seed)
        else:
            params = self._single_params(params, seed)
        self.model = M.Decoder(params, dev, self._layout)
        self.params = self.model.params()
        self._kv_heads = M.kv_heads(self.params, config)
        # the long lane's sequence axis: every rank of the mesh (its ring's
        # collectives), or this one device
        self._comm = None if self._layout is None else self._layout.comm
        self._sp = 1 if self._comm is None else self._comm.sp

        B, S = rt.max_batch_size, rt.max_seq_len
        # dp: the decode and verify rows this rank computes (None: all)
        self._rows = None if self._layout is None else self._layout.batch_rows(B)
        self._paged = rt.kv_layout == "paged"
        self._prefix: "PrefixCache | None" = None
        if self._paged:
            n_pages = rt.pool_pages()
            self._k, self._v = M.make_page_pool(
                config, n_pages, rt.page_size, device=dev, kv_heads=self._kv_heads
            )
            self._tables = torch.zeros(
                (B, rt.pages_per_seq()), dtype=torch.int32, device=dev
            )
            self._page_alloc = PageAllocator(n_pages)
            # the page-ownership mirror, kept O(1) at every alloc, free and
            # evict site (the allocator's pool less its trash page)
            self._ledger = capacity.PageLedger(n_pages - 1)
            if rt.prefix_cache:
                self._prefix = PrefixCache()
            logger.info(
                "paged KV pool: %d pages x %d tokens (%.2f GB)", n_pages,
                rt.page_size, 2 * self._k.numel() * self._k.element_size() / 1e9,
            )
        elif self._rows is not None:
            # dp: this group's rows of the dense cache, and one trash row
            # that the wave landings of the other groups' slots write to
            rows = self._rows[1]
            self._k_rows, self._v_rows = M.make_empty_cache(
                config, rows + 1, S, device=dev, kv_heads=self._kv_heads
            )
            self._k, self._v = self._k_rows[:, :rows], self._v_rows[:, :rows]
            self._ledger = capacity.PageLedger(0)
        else:
            self._k, self._v = M.make_empty_cache(config, B, S, device=dev, kv_heads=self._kv_heads)
            # a pool-less ledger: the snapshot's keys exist with zeros
            self._ledger = capacity.PageLedger(0)
        # the compiled-dispatch layer: every dispatch body captured once per
        # key as a CUDA graph and replayed (graphs.py), under the keys of the
        # JAX engine's jit caches; the graphs read the engine's tensors
        # below in place, so none of them is ever re-bound
        self._graphs = graphs.GraphPool(dev)
        self._decode_graphs: dict[tuple, graphs.CapturedDispatch] = {}
        self._prefill_graphs: dict[tuple, graphs.CapturedDispatch] = {}
        self._last = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._lens = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._host_lens = np.zeros((B,), np.int64)  # host mirror for windows
        # device-side retirement inputs: each slot's stop tokens as a
        # fixed-shape row (-1 padded) and the absolute cache length at which
        # the row hits its hard generation bound (min(prompt + max_new - 1,
        # max_seq - 2)), written at activation and copied into the device
        # buffers only when an activation changed them
        self._stop_np = np.full((B, rt.max_stop_tokens), -1, np.int32)
        self._hard_end = np.zeros((B,), np.int32)
        self._stop_dev = torch.full((B, rt.max_stop_tokens), -1, dtype=torch.int32, device=dev)
        self._hard_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._retire_dirty = False
        # the latest decode dispatch's done mask: written in place by every
        # decode graph, so it survives the chunk and landing graphs that may
        # replay before the next decode dispatch reads it as ``done_prev``
        self._done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._done_zero = torch.zeros((B,), dtype=torch.bool, device=dev)
        # the prefill waves' scratch K/V, at one address for the engine's
        # life (a graph replays the addresses its capture saw): one flat
        # buffer for the widest wave at max_seq_len positions, of which a
        # wave of R rows takes the [L, R, K, max_seq_len, hd] views
        rows = min(rt.max_prefill_wave, B)
        self._scratch_flat = torch.zeros(
            2 * config.n_layers * rows * self._kv_heads * S * config.head_dim,
            dtype=self._k.dtype, device=dev,
        )
        # the long-context lane's buffers, at fixed addresses too (its
        # graphs, in ``_long_graphs``, replay them): the prefix scratch
        # [L, 1, K, P/sp, hd] in the KV dtype, this rank's block of the
        # longest padded prompt P with every kv head, of which a prompt
        # padded to p takes the [..., :p/sp, :] views; the fresh-token cache
        # [L, 1, kv, cap, hd] in f32, as the JAX engine's, with the kv heads
        # of this rank's shard; and the token that enters the lane's next
        # decode dispatch
        self._long_graphs: dict[tuple, graphs.CapturedDispatch] = {}
        if rt.long_context:
            L, K, hd = config.n_layers, config.n_kv_heads, config.head_dim
            prefix = (L, 1, K, self._long_padded(self._long_max_prompt()) // self._sp, hd)
            fresh = (L, 1, self._kv_heads, self._long_fresh_cap(), hd)
            self._long_scratch = tuple(
                torch.zeros(prefix, dtype=self._k.dtype, device=dev) for _ in range(2)
            )
            self._long_fresh = tuple(
                torch.zeros(fresh, dtype=torch.float32, device=dev) for _ in range(2)
            )
            self._long_last = torch.zeros((1,), dtype=torch.int32, device=dev)
            logger.info(
                "long-context lane: prefix scratch of %d positions, fresh cache of %d "
                "(%.2f GB)", prefix[3], fresh[3], sum(
                    t.numel() * t.element_size() for t in (*self._long_scratch, *self._long_fresh)
                ) / 1e9,
            )
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
        # the deadline reaper's min-heap of [deadline, (class, seq),
        # request] and the orphan reaper's of [lease expiry, ...], peeked
        # once per scheduler pass; event-loop only, lazy pops
        self._deadline_heap: list[list] = []
        self._deadline_seq = itertools.count()
        self._lease_heap: list[list] = []
        self._lease_seq = itertools.count()
        # released-lease sweep cursor: a clean caller close reaps now
        self._lease_release_gen = leases.release_generation()
        # the chaos seam: when set, called with a point name ("tick" per
        # scheduler pass, "dispatch" per decode tick); an exception it
        # raises crosses the dispatch loop like a real engine fault
        self._chaos: Any = None
        # requests whose single-shot admission prefill runs in the worker thread
        self._admitting: list[GenRequest] = []
        self._inflight: "dict | None" = None  # chunked-prefill wave in flight
        self._carry: list[GenRequest] = []  # wave-trimmed, ahead of the queue
        self._pending: deque[GenRequest] = deque()
        # the long-context lane: its queue, its chunked prefill in flight,
        # and the request it decodes (one at a time)
        self._long_pending: deque[GenRequest] = deque()
        self._long_inflight: "dict | None" = None
        self._long: "dict | None" = None
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
        # the dispatch-progress watchdog: its own event-loop task, because
        # a wedged dispatch blocks the serve loop inside asyncio.to_thread.
        # ``_progress_at`` is stamped (on the wall_clock seam) at every
        # dispatch or wave landing; with work pending and no stamp for
        # watchdog_stall_s the engine is declared wedged
        self._wedged = False
        self._wedged_at = 0.0
        self._progress_at = cancellation.wall_clock()
        self._watchdog_task: asyncio.Task[None] | None = None
        self.stats = EngineStats(_graph_stats=self._graphs.stats)
        # the dispatch timeline: every dispatch of the pool is timed on
        # rank 0 (the other ranks follow its dispatches and land none)
        clock = EventClock(dev) if dev.type == "cuda" else HostClock()
        self._timeline = DispatchTimeline(clock, self.stats)
        if self._rank == 0:
            self._graphs.timeline = self._timeline
        # each landed request's queue wait, prefill span and reused tokens
        # by its corr, until request_timing reads them
        self._request_timing: dict = {}
        # the flight recorder: O(1) lock-free appends at every scheduling
        # decision; flightrec_events=0 makes an append one attribute check
        self._journal = flightrec.FlightRecorder(rt.flightrec_events, label=config.name)
        # the occupancy timeline: one sample per dispatch landing
        # (capacity_samples=0 is off), with its HBM roofline constants
        self._sampler = capacity.CapacitySampler(
            rt.capacity_samples, label=config.name, ledger=self._ledger
        )
        self._capacity_on = self._sampler.capacity > 0
        self._hbm_constants = capacity.hbm_constants(config, rt.quantization)
        self._hbm_ctx = rt.max_seq_len / 2.0
        # a mesh cancel reaching any node of the process reaches this
        # engine's requests
        cancellation.register_cancel_target(self)
        # the process-registry instruments, this engine's own histograms
        # (its percentiles), and the cursors that turn cumulative stats
        # into counter increments
        self.metrics = _engine_metrics()
        self._own_registry = MetricsRegistry()
        self.latency = _engine_metrics(self._own_registry, histograms_only=True)
        self._counted = dict.fromkeys(
            ("decode_tokens", "prefill_tokens", "spec_proposed", "spec_accepted",
             "overlap_wasted_tokens"), 0,
        )
        self._counted_lock = threading.Lock()
        # an engine abandoned without stop() must not pin its last active
        # count into the process gauge
        weakref.finalize(self, _drop_engine_active, id(self))
        self._drafter: Any = None
        if self._spec is not None:
            from calfkit_tpu_torch.inference.spec import build_drafter

            if self._draft_local is not None:  # this rank's shard of the draft model
                draft_params, draft_layout = self._draft_local
                self._draft_local = None
            else:
                draft_layout = None
            self._drafter = build_drafter(
                self._spec, rt, dev, draft_params=draft_params, seed=seed + 3,
                pool=self._graphs, layout=draft_layout,
            )
            logger.info(
                "speculative decoding on: %s drafter, k=%d",
                "draft-model" if self._spec.draft is not None else "ngram", self._spec.k,
            )

        if self._channel is not None:
            # every dispatch of every rank leaves its outputs here, where a
            # later dispatch's descriptor names them; rank 0 mirrors each
            # dispatch it runs to the other ranks before running it
            self._graphs.latest = {}
            if self._rank == 0:
                self._graphs.mirror = weakref.WeakMethod(self._mirror)

    # ------------------------------------------------------------- multi-rank
    def _single_params(self, params: Any, seed: int) -> Any:
        """The params of a one-device engine: given, read from a
        checkpoint, or drawn from ``seed``; quantized at the runtime's
        quantization."""
        from calfkit_tpu_torch.inference.loader import Checkpoint, load_params

        rt, config = self.runtime, self.config
        if isinstance(params, Checkpoint):
            return load_params(params.path, config, device=self.device, quantize=rt.quantization)
        if params is None:
            logger.info(
                "initializing random %s params (%.2fB)", config.name,
                config.param_count / 1e9,
            )
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
            params = M.init_params(config, generator)
        if rt.quantization is not None:
            params = _quantized(params, rt.quantization)
        return params

    def _shardings(self, config: ModelConfig) -> Any:
        """The shard tree of ``config`` on this engine's mesh, at the
        runtime's quantization."""
        from calfkit_tpu_torch.inference import sharding as Sh
        from calfkit_tpu_torch.inference.quant import (
            align_quant_sharding_keys,
            quantize_shardings,
        )

        shardings = Sh.param_shardings(config, self.mesh)
        if self.runtime.quantization is None:
            return shardings
        bits = bits_of(self.runtime.quantization)
        if bits == 4:
            Sh.check_q4_alignment(config, self.mesh)
        shardings = quantize_shardings(shardings, bits=bits)
        if bits == 4:
            shardings = align_quant_sharding_keys(shardings, Sh.q4_template(config))
        return shardings

    def _rank_shard(self, params: Any, seed: int, rank: int) -> Any:
        """``rank``'s shard of the target model: ``params`` may be a rank's
        :class:`sharding.RankShard` already, a :class:`loader.Checkpoint`
        (read through the shard tree), a full tree, or ``None`` (drawn from
        ``seed``; quantized params are drawn whole and quantized first, as
        the reference quantizes before it places)."""
        from calfkit_tpu_torch.inference import sharding as Sh
        from calfkit_tpu_torch.inference.loader import Checkpoint, load_params

        rt, config = self.runtime, self.config
        if isinstance(params, Sh.RankShard):
            return params
        if isinstance(params, Checkpoint):
            return load_params(
                params.path, config, device=self.device, quantize=rt.quantization,
                shardings=self._shardings(config),
                rank=rank,
            )
        if params is None and rt.quantization is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
            return Sh.RankShard(
                M.init_params(config, generator, shardings=self._shardings(config), rank=rank)
            )
        params = self._single_params(params, seed)
        return Sh.place_params(params, self._shardings(config), rank=rank)

    def _join_group(self, params: Any, draft_params: Any, seed: int) -> Any:
        """Join (or, on one host with no group yet, make: spawning ranks
        1..n-1) the engine's process group → this rank's local params."""
        import torch.distributed as dist

        from calfkit_tpu_torch.inference import distributed as D
        from calfkit_tpu_torch.inference import sharding as Sh
        from calfkit_tpu_torch.inference.loader import Checkpoint

        rt, config = self.runtime, self.config
        if self.mesh is None:
            self.mesh = Sh.make_mesh(tp=rt.tp, dp=rt.dp, device_type=self.device.type)
        elif (self.mesh.shape["tp"], self.mesh.shape["dp"]) != (rt.tp, rt.dp):
            raise ValueError(
                f"mesh {self.mesh} does not match the runtime's tp={rt.tp} x dp={rt.dp}"
            )
        world = self.mesh.size
        draft_cfg = self._spec.draft if self._spec is not None else None
        if dist.is_initialized():
            rank = dist.get_rank()
            D.assert_engine_fits(D._info(), rt.tp, rt.dp)
            if dist.get_world_size() != world:
                raise ValueError(
                    f"the process group has {dist.get_world_size()} ranks; the engine's "
                    f"mesh needs exactly {world} (one engine spans the whole group)"
                )
            mine = self._rank_shard(params, seed, rank)
        else:
            # one host, no group yet: this process is rank 0 and spawns
            # the rest, each given its shard (or drawing it from the seed)
            rank = 0
            full = None
            if params is not None and not isinstance(params, Checkpoint):
                full = self._single_params(params, seed)
            elif params is None and rt.quantization is not None:
                full = self._single_params(None, seed)
            if full is not None:
                shardings = self._shardings(config)
                shards = [
                    D.to_host(Sh.place_params(full, shardings, rank=r)) for r in range(1, world)
                ]
                mine = Sh.place_params(full, shardings, rank=0)
                del full
            else:
                shards = [params] * (world - 1)  # None or the checkpoint
                mine = self._rank_shard(params, seed, 0)
            draft_shards = [draft_params] * (world - 1)
            if draft_params is not None and draft_cfg is not None:
                dsh = Sh.param_shardings(draft_cfg, self.mesh)
                draft_shards = [
                    D.to_host(Sh.place_params(draft_params, dsh, rank=r)) for r in range(1, world)
                ]
            self._workers = D.spawn_workers(
                world, config, rt, shards, seed, str(self.device), draft_shards,
            )
        self._rank = rank
        comm = D.Comm(self.mesh, rank)
        self._layout = Sh.layout_of(config, self.mesh, rank, comm)
        if draft_cfg is not None:
            dlayout = Sh.layout_of(draft_cfg, self.mesh, rank, comm)
            if draft_params is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(seed + 3)
                dmine = Sh.RankShard(M.init_params(
                    draft_cfg, generator, shardings=Sh.param_shardings(draft_cfg, self.mesh),
                    rank=rank,
                ))
            elif isinstance(draft_params, Sh.RankShard):
                dmine = draft_params
            else:
                dmine = Sh.place_params(
                    draft_params, Sh.param_shardings(draft_cfg, self.mesh), rank=rank
                )
            self._draft_local = (Sh.local_params(dmine, draft_cfg, dlayout), dlayout)
        self._channel = D.engine_channel(rank, world)
        logger.info(
            "rank %d of %d (tp=%d x dp=%d, %s): kv heads %d, vocab %s", rank, world, rt.tp,
            rt.dp, comm.backend, self._layout.kv_heads, self._layout.vocab,
        )
        return Sh.local_params(mine, config, self._layout)

    def _encode_input(self, value: Any) -> Any:
        """A dispatch input as the other ranks rebuild it: a host array as
        it is; a tensor by name (an engine buffer) or as an output of an
        earlier dispatch (which every rank ran alike)."""
        if not isinstance(value, torch.Tensor):
            return np.asarray(value)
        for name in ("_done", "_done_zero"):
            if value is getattr(self, name):
                return ("attr", name)
        for recipe, out in self._graphs.latest.items():
            if out is value:
                return ("out", recipe, None)
            if isinstance(out, tuple):
                for i, part in enumerate(out):
                    if part is value:
                        return ("out", recipe, i)
        raise InferenceError(
            "a dispatch input that is neither a host array, an engine buffer nor an "
            "earlier dispatch's output cannot be mirrored to the other ranks"
        )

    def _decode_input(self, value: Any) -> Any:
        if isinstance(value, tuple):
            if value[0] == "attr":
                return getattr(self, value[1])
            out = self._graphs.latest[value[1]]
            return out if value[2] is None else out[value[2]]
        return value

    def _mirror(self, fn: graphs.CapturedDispatch, args: tuple) -> None:
        """Rank 0: describe the dispatch about to run to the other ranks."""
        if fn.recipe is None:
            raise InferenceError("a dispatch without a recipe cannot run on every rank")
        enc = tuple(self._encode_input(a) for a in args)
        self._channel.send(("call", fn.recipe, enc, graphs.eager_active()))

    def _fill(self, name: str, value: np.ndarray) -> None:
        """Copy a host array into the engine buffer ``name`` on every rank."""
        if self._channel is not None and self._rank == 0:
            self._channel.send(("fill", name, value))
        graphs.fill(getattr(self, name), value)

    def _serve_rank(self, alive: Any = None) -> None:
        """Ranks 1..n-1: run every dispatch rank 0 describes, in its order,
        until rank 0's engine stops."""
        targets = {"engine": self, "drafter": self._drafter}
        try:
            while True:
                message = self._channel.recv(alive)
                kind = message[0]
                if kind == "call":
                    _, (target, name, margs), enc, eager = message
                    fn = getattr(targets[target], name)(*margs)
                    args = [self._decode_input(a) for a in enc]
                    if eager:
                        with graphs.eager():
                            fn(*args)
                    else:
                        fn(*args)
                elif kind == "fill":
                    graphs.fill(getattr(self, message[1]), message[2])
                elif kind == "rpc":
                    _, tag, func, fargs = message
                    try:
                        reply = (True, func(self, *fargs))
                    except Exception:  # noqa: BLE001 - handed to rank 0
                        reply = (False, traceback.format_exc())
                    self._channel.reply(tag, reply)
                elif kind == "stop":
                    break
        finally:
            self._release_graphs()

    def on_ranks(self, func: Any, *args: Any) -> "list[Any]":
        """Rank 0: ``func(engine, *args)`` on every rank → their results by
        rank (``func`` must be importable by name, and must not run a
        collective; rank 0 runs it after the others have answered).  The
        tests and the chip smoke read each rank's launch counts and memory
        through it."""
        if self._channel is None:
            return [func(self, *args)]
        self._rpc_seq = getattr(self, "_rpc_seq", 0) + 1
        tag = str(self._rpc_seq)
        self._channel.send(("rpc", tag, func, args))
        out = []
        alive = self._workers.alive if self._workers is not None else None
        for rank, (ok, value) in enumerate(self._channel.replies(tag, alive), start=1):
            if not ok:
                raise InferenceError(f"rank {rank} failed {func.__name__}:\n{value}")
            out.append(value)
        # after the others: a func that times work does not share the card
        return [func(self, *args), *out]

    def _release_graphs(self) -> None:
        """Free every captured graph of a multi-rank engine whose group is
        ending: a graph that captured NCCL collectives holds the group's
        communicator, and the group's teardown waits for it."""
        for table in (self._decode_graphs, self._prefill_graphs, self._long_graphs,
                      getattr(self._drafter, "_graphs", {})):
            table.clear()
        self._graphs.latest = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _close_group(self) -> None:
        """Rank 0: end the other ranks' loops; join the workers this engine
        spawned and leave the group it made for them."""
        channel, self._channel = self._channel, None
        if channel is None or self._rank != 0:
            return
        self._release_graphs()
        try:
            channel.send(("stop",))
        except Exception:  # noqa: BLE001 - a dead group has nothing to stop
            logger.warning("could not tell the other ranks to stop", exc_info=True)
        workers, self._workers = self._workers, None
        if workers is not None:
            workers.close()

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._loop = asyncio.get_running_loop()
        self._timeline.idle()  # nothing before a start is held work
        # SIGUSR2 dumps every live journal (best-effort: skipped off the
        # main thread)
        flightrec.install_sigusr2()
        self._task = self._loop.create_task(self._serve(), name="inference-engine")
        if self.runtime.watchdog_stall_s > 0:
            self._progress_at = cancellation.wall_clock()
            self._watchdog_task = self._loop.create_task(
                self._watchdog(), name="inference-engine-watchdog"
            )

    async def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            try:
                await self._watchdog_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._watchdog_task = None
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, timeout=30)
            except asyncio.TimeoutError:
                self._task.cancel()
            self._task = None
        self._finish_all()
        try:
            self._close_group()
        finally:
            # a stopped engine must not pin a stale count in the process gauge
            _drop_engine_active(id(self))

    def _finish_all(self) -> None:
        """Terminate every waiter: active slots AND still-queued requests
        (a queued request left without _DONE hangs its generate() forever)."""
        if self._pend is not None:
            # abandon the in-flight dispatch; its deferred frees must
            # still run or the slots/pages leak into the next start()
            self._free_deferred(self._pend)
            self._pend = None
        self._timeline.reset()  # no sync will read what is in flight
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
        if self._long is not None:
            self._long["request"].out.put_nowait(_DONE)
            self._long = None
        if self._long_inflight is not None:
            self._long_inflight["request"].out.put_nowait(_DONE)
            self._long_inflight = None
        while self._long_pending:
            self._long_pending.popleft().out.put_nowait(_DONE)

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
        reclaimed at the next scheduler pass.  ``corr`` tags the request's
        flight-recorder events (and :meth:`cancel_correlation`); ``run``,
        the caller's run id, tags its pages in the page ledger.

        ``deadline`` is the request's ABSOLUTE deadline (epoch seconds on
        :func:`calfkit_tpu_torch.cancellation.wall_clock`): an expired
        submit raises :class:`DeadlineExceededError` at once, and a queued
        or active request whose deadline passes is reaped (its stream
        raises the same error).  ``lease`` is the caller's liveness lease
        ``(lease_id, ttl_s)``: once its beats lapse past the TTL the run is
        reaped, queued or active (:class:`RunOrphanedError`).  ``priority``
        is the caller's QoS class (``"interactive"`` | ``"batch"``; anything
        else is the default class): with ``RuntimeConfig.max_pending`` set,
        a submit that finds its lane full evicts a queued batch request if
        it is interactive, else is shed with :class:`EngineOverloadedError`.
        While the watchdog declares the engine wedged, a submit raises
        :class:`EngineWedgedError`."""
        req_priority = qos.resolve_priority(priority)
        if not self._running:
            raise InferenceError("engine not started")
        if self._wedged:
            # admitting work behind a hung dispatch would only grow the
            # pile the watchdog just faulted: callers should fail over
            self.stats.watchdog_faulted += 1
            raise EngineWedgedError(
                "engine is wedged (no dispatch progress for "
                f"{self.runtime.watchdog_stall_s:.1f}s with work pending); "
                "retry against another replica",
                stalled_s=self.runtime.watchdog_stall_s,
            )
        if deadline is not None:
            overdue = cancellation.wall_clock() - deadline
            if overdue >= 0:
                # expired on arrival: admitting it would burn prefill and
                # decode dispatches for a dead caller
                self.stats.expired_requests += 1
                self._count_expired_class(req_priority)
                self._journal.append(flightrec.EV_EXPIRE, corr, -1, int(overdue * 1000))
                raise DeadlineExceededError(f"request expired {overdue:.3f}s before admission")
        if lease is not None and leases.lease_lapsed(lease[0]):
            # the caller was already gone when this submit arrived
            self.stats.orphaned_requests += 1
            self._journal.append(flightrec.EV_ORPHAN, corr, -1, 0)
            raise RunOrphanedError("caller lease lapsed before admission", lease_id=lease[0])
        long_lane = len(prompt) >= self.runtime.max_seq_len
        if long_lane and not self.runtime.long_context:
            raise InferenceError(
                f"prompt of {len(prompt)} tokens exceeds max_seq_len "
                f"{self.runtime.max_seq_len} (enable RuntimeConfig(long_context=True) "
                "to serve it through the long-context lane)"
            )
        if long_lane and len(prompt) > self._long_max_prompt():
            raise InferenceError(
                f"prompt of {len(prompt)} tokens exceeds long_max_prompt "
                f"{self._long_max_prompt()}"
            )
        request = GenRequest(
            prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            stop_tokens=stop_tokens,
            sampling=sampling,
            seed=seed,
            corr=corr,
            run=run,
            deadline=deadline,
            priority=req_priority,
        )
        if lease is not None:
            request.lease_id, request.lease_ttl = lease
        self._journal.append(flightrec.EV_SUBMIT, corr, -1, len(request.prompt), max_new_tokens)
        if long_lane:
            self._queue_long(request)
        else:
            self._queue_short(request)
        self._submit_deadline(request)
        self._submit_lease(request)
        self._wake.set()
        inner = self._consume(request)
        try:
            async for item in inner:
                yield item
        finally:
            # aclose() on OUR iterator must cancel NOW, not whenever the
            # asyncgen finalizer gets around to collecting the inner one
            await inner.aclose()

    def _queue_short(self, request: GenRequest) -> None:
        """Queue a short-lane request behind the checks of what it asks for
        and the lane's bounded admission."""
        if self._drafter is not None:
            # the drafters read prompt + output (the long lane never speculates)
            request.history = list(request.prompt)
        if (
            self.runtime.overlap_dispatch or self._spec is not None
        ) and len(request.stop_tokens) > self.runtime.max_stop_tokens:
            # device-side retirement (overlapped decode, and every verify
            # dispatch) scans a fixed-shape per-slot stop table; silently
            # truncating the set would MISS stops
            raise InferenceError(
                f"request has {len(request.stop_tokens)} stop tokens but device-side"
                f" retirement caps the per-slot table at max_stop_tokens="
                f"{self.runtime.max_stop_tokens}; raise "
                "RuntimeConfig.max_stop_tokens (or set overlap_dispatch=False "
                "with speculation off for the host-side lockstep path)"
            )
        if self._paged:
            # reject what the pool could NEVER serve: re-queueing it would
            # wait (and starve everything behind it) forever
            reserve = self._reserve_pages(request, self._bucket_of(len(request.prompt)))
            usable = self._page_alloc.num_pages - 1
            if reserve > usable:
                raise InferenceError(
                    f"request needs {reserve} KV pages but the pool only has "
                    f"{usable}; lower max_new_tokens or raise num_kv_pages"
                )
        # requests mid-admission hold queue places and page reservations
        # like queued ones, so they count toward the lane's depth
        self._shed_if_full(
            "short", len(self._pending) + len(self._carry) + len(self._admitting), request
        )
        self._pending.append(request)

    def _queue_long(self, request: GenRequest) -> None:
        """Queue a long-lane request: its token budget against the fresh
        cache's static size (a typed fault, or the clamp the runtime opted
        into), the greedy-only warning, and the lane's bounded admission."""
        rt = self.runtime
        if request.max_new_tokens > rt.long_new_cap:
            # the fresh cache is sized by the cap: the budget cannot be
            # honored, and shrinking it silently would break the caller's
            # accounting, unless the runtime opted into the clamp
            if not rt.long_clamp_new_tokens:
                raise InferenceError(
                    f"long-context request asked for {request.max_new_tokens} new tokens "
                    f"but long_new_cap is {rt.long_new_cap}; lower max_new_tokens, raise "
                    "RuntimeConfig.long_new_cap, or opt in to clamping with "
                    "RuntimeConfig(long_clamp_new_tokens=True)"
                )
            request.max_new_tokens = rt.long_new_cap
            logger.warning(
                "long request clamped to long_new_cap=%d new tokens "
                "(long_clamp_new_tokens=True)", rt.long_new_cap,
            )
        if not self._effective_sampling(request).is_greedy:
            logger.warning(
                "long-context lane decodes greedily; sampling settings are ignored "
                "for this request"
            )
        self._shed_if_full("long", len(self._long_pending), request)
        self._long_pending.append(request)

    # ------------------------------------------------- overload protection
    def _count_shed_class(self, priority: str) -> None:
        if qos.class_rank(priority):
            self.stats.batch_shed += 1
        else:
            self.stats.interactive_shed += 1

    def _count_expired_class(self, priority: str) -> None:
        if qos.class_rank(priority):
            self.stats.batch_expired += 1
        else:
            self.stats.interactive_expired += 1

    def _shed_victim(self, lane: str) -> "GenRequest | None":
        """The QUEUED batch-class request to evict so an arriving
        interactive request takes its place at a full lane: among batch
        requests, the one whose caller lease has the OLDEST beat (un-leased
        or never-beaten requests read age 0, the most alive).  Only queued
        entries of ``lane`` are candidates: evicting an active slot would
        discard paid prefill work.  None when no batch request is queued."""
        queued = (
            self._long_pending if lane == "long"
            else (*self._carry, *self._pending, *self._admitting)
        )
        victim: "GenRequest | None" = None
        victim_age = -1.0
        for r in queued:
            if r.cancelled or not qos.class_rank(r.priority):
                continue
            age = leases.lease_age(r.lease_id)
            age = 0.0 if age is None else age
            if age > victim_age:
                victim, victim_age = r, age
        return victim

    def _shed_queued(self, victim: GenRequest, lane: str, pending: int, limit: int) -> None:
        """Evict one queued batch request through the ordinary cancellation
        path; its consumer raises the same typed, retriable
        EngineOverloadedError (same lane/pending/limit) a shed at submit
        would have."""
        victim.shed = True
        victim.shed_detail = (lane, pending, limit)
        victim.cancelled = True
        self._cancel_dirty = True
        self.stats.shed_requests += 1
        self._count_shed_class(victim.priority)
        self._journal.append(flightrec.EV_SHED, victim.corr, -1, pending, limit)
        self._wake.set()

    def _shed_if_full(self, lane: str, pending: int, request: GenRequest) -> None:
        """Bounded admission, priority-ordered: when the lane's queue is at
        ``max_pending``, an interactive submit evicts a queued batch request
        and is admitted in its place; otherwise the submit itself is refused
        with a typed, retriable error.  An interactive request is never shed
        while a batch request is sheddable."""
        limit = self.runtime.max_pending
        if not limit or pending < limit:
            return
        if not qos.class_rank(request.priority):
            victim = self._shed_victim(lane)
            if victim is not None:
                self._shed_queued(victim, lane, pending, limit)
                return  # admitted in the victim's place
        self.stats.shed_requests += 1
        self._count_shed_class(request.priority)
        self._journal.append(flightrec.EV_SHED, request.corr, -1, pending, limit)
        raise EngineOverloadedError(
            f"{lane} lane has {pending} queued requests (max_pending="
            f"{limit}); retry with backoff or add capacity",
            lane=lane, pending=pending, limit=limit,
        )

    def _reap_order(self, request: GenRequest, seq: int) -> "tuple[int, int]":
        """The reapers' heap key between expiry and request: at EQUAL
        expiry the batch-class entry sorts first."""
        return (1 - qos.class_rank(request.priority), seq)

    def _submit_deadline(self, request: GenRequest) -> None:
        """Register a deadlined request for the scheduler's expiry reap."""
        if request.deadline is None:
            return
        entry = [request.deadline, self._reap_order(request, next(self._deadline_seq)), request]
        request.deadline_entry = entry
        heapq.heappush(self._deadline_heap, entry)

    def _drop_deadline(self, request: GenRequest) -> None:
        """Null a finished request's deadline entry (it pops lazily), so the
        heap holds no reference to the dead request."""
        entry = request.deadline_entry
        if entry is not None:
            entry[2] = None
            request.deadline_entry = None

    def _request_live(self, request: GenRequest) -> bool:
        """Is this request still queued or holding engine resources?"""
        if request.slot != -1:
            return True
        if self._long is not None and self._long["request"] is request:
            return True
        if self._long_inflight is not None and self._long_inflight["request"] is request:
            return True
        return any(
            r is request
            for r in (*self._carry, *self._pending, *self._long_pending, *self._admitting)
        )

    def _check_deadlines(self) -> None:
        """Reap queued AND active requests whose deadline passed, through
        the ordinary cancellation path.  One heap peek when nothing
        expired."""
        heap = self._deadline_heap
        if not heap:
            return
        now = cancellation.wall_clock()
        if heap[0][0] > now:
            return
        while heap and heap[0][0] <= now:
            _, _, request = heapq.heappop(heap)
            if request is None or request.cancelled or not self._request_live(request):
                continue  # finished or already being reaped: a lazy entry
            request.expired = True
            request.cancelled = True
            self._cancel_dirty = True
            self.stats.expired_requests += 1
            self._count_expired_class(request.priority)
            self._journal.append(
                flightrec.EV_EXPIRE, request.corr, request.slot,
                int((now - request.deadline) * 1000),
            )

    # -------------------------------------------------------- orphan reaper
    # A run whose caller's lease lapsed is abandoned through the ordinary
    # cancellation path, with a typed, non-retriable terminal.  Precedence
    # (shared with _raise_terminal): wedged > expired > orphaned > shed >
    # stalled > plain cancel: exactly one typed error per run.

    def _submit_lease(self, request: GenRequest) -> None:
        """Register a leased request for the orphan sweep."""
        if request.lease_id is None:
            return
        expiry = leases.lease_expiry(request.lease_id)
        if expiry is None:
            # a never-beaten lease: the submit itself is proof of life
            expiry = cancellation.wall_clock() + request.lease_ttl
        entry = [expiry, self._reap_order(request, next(self._lease_seq)), request]
        request.lease_entry = entry
        heapq.heappush(self._lease_heap, entry)

    def _drop_lease(self, request: GenRequest) -> None:
        """Null a finished request's lease entry (it pops lazily)."""
        entry = request.lease_entry
        if entry is not None:
            entry[2] = None
            request.lease_entry = None

    def _check_orphans(self) -> None:
        """Reap queued AND active runs whose caller lease lapsed.  One heap
        peek when no registered expiry has arrived; an entry whose lease
        was refreshed since is re-pushed at its new expiry."""
        heap = self._lease_heap
        if not heap:
            return
        now = cancellation.wall_clock()
        gen = leases.release_generation()
        if gen != self._lease_release_gen:
            # a lease was RELEASED (clean caller close): its runs orphan
            # now, ahead of their registered expiry
            self._lease_release_gen = gen
            for entry in heap:
                request = entry[2]
                if (
                    request is not None and not request.cancelled
                    and leases.lease_lapsed(request.lease_id, now)
                ):
                    entry[0] = now
            heapq.heapify(heap)
        if heap[0][0] > now:
            return
        while heap and heap[0][0] <= now:
            entry = heapq.heappop(heap)
            request = entry[2]
            if request is None or request.cancelled or not self._request_live(request):
                continue
            expiry = leases.lease_expiry(request.lease_id)
            if expiry is None:
                expiry = entry[0] + request.lease_ttl
            if expiry > now:
                # the caller beat since registration: re-arm and keep serving
                fresh = [expiry, self._reap_order(request, next(self._lease_seq)), request]
                request.lease_entry = fresh
                heapq.heappush(heap, fresh)
                continue
            request.orphaned = True
            request.cancelled = True
            self._cancel_dirty = True
            self.stats.orphaned_requests += 1
            # clamp: a RELEASED lease reads expiry -inf
            self._journal.append(
                flightrec.EV_ORPHAN, request.corr, request.slot,
                int(min(now - expiry, 86400.0) * 1000),
            )

    def _check_stalls(self) -> None:
        """Bound per-request delivery: a consumer that stopped draining its
        stream (more than ``max_out_blocks`` undrained blocks) is
        stall-cancelled, and its blocks free with the request."""
        bound = self.runtime.max_out_blocks
        if not bound:
            return
        stalled = [r for r in self._active.values() if not r.cancelled and r.out.qsize() > bound]
        if self._long is not None:
            r = self._long["request"]
            if not r.cancelled and r.out.qsize() > bound:
                stalled.append(r)
        for request in stalled:
            request.stalled = True
            request.cancelled = True
            self._cancel_dirty = True
            self.stats.delivery_stalled += 1
            self._journal.append(
                flightrec.EV_CANCEL, request.corr, request.slot, request.out.qsize()
            )

    # ------------------------------------------------------- wedge watchdog
    def _note_progress(self) -> None:
        """A dispatch or wave LANDED: the watchdog's progress signal (on the
        wall_clock seam, so a virtual clock drives wedge detection)."""
        self._progress_at = cancellation.wall_clock()

    def _watchdog_requests(self) -> "list[GenRequest]":
        """Every request the engine owes an outcome: active slots, the
        queues, mid-admission prefills, the inflight chunked wave and the
        long lane."""
        out: list[GenRequest] = [
            *self._active.values(), *self._carry, *self._pending, *self._admitting,
            *self._long_pending,
        ]
        if self._inflight is not None:
            out.extend(self._inflight["wave"])
        if self._long is not None:
            out.append(self._long["request"])
        if self._long_inflight is not None:
            out.append(self._long_inflight["request"])
        return out

    def _work_pending(self) -> bool:
        return bool(
            self._active or self._pending or self._carry or self._admitting
            or self._inflight is not None or self._pend is not None
            or self._long is not None or self._long_inflight is not None
            or self._long_pending
        )

    async def _watchdog(self) -> None:
        """The dispatch-progress watchdog: its OWN task, because a dispatch
        that never returns blocks the serve loop inside asyncio.to_thread.
        Polls on real time, measures the stall on the wall_clock seam."""
        threshold = self.runtime.watchdog_stall_s
        interval = max(0.01, min(threshold / 4.0, 0.25))
        while self._running:
            await asyncio.sleep(interval)
            now = cancellation.wall_clock()
            if self._wedged:
                if self._progress_at > self._wedged_at:
                    # the dispatch came back: serving resumes; the faulted
                    # requests were flagged cancelled, so the ordinary reap
                    # frees their slots and pages
                    self._wedged = False
                    logger.warning(
                        "engine un-wedged: a dispatch landed after the watchdog "
                        "tripped; serving resumes"
                    )
                continue
            if not self._work_pending():
                # idle is not a stall: the next submit's clock starts now
                self._progress_at = now
                continue
            if now - self._progress_at >= threshold:
                self._trip_wedge(now - self._progress_at)

    def _trip_wedge(self, stalled_s: float) -> None:
        """Declare the engine wedged: journal and dump the flight recorder,
        flip readiness, and fault every owed request with the typed,
        retriable EngineWedgedError so callers fail over now.  The requests
        are also flagged cancelled: if the wedge clears, the ordinary reap
        reclaims their slots and pages.  Nothing is freed or retired here:
        an in-flight dispatch may still write through them."""
        self._wedged = True
        self._wedged_at = cancellation.wall_clock()
        self.stats.watchdog_trips += 1
        requests = self._watchdog_requests()
        self._journal.append(flightrec.EV_WEDGE, None, -1, int(stalled_s * 1000), len(requests))
        try:
            path = self._journal.dump(reason="wedge")
            logger.error(
                "engine WEDGED: no dispatch landing for %.1fs with %d request(s) "
                "pending; flight-recorder dump: %s", stalled_s, len(requests), path,
            )
        except Exception:  # noqa: BLE001 - the dump must never mask the fault
            logger.exception("flight-recorder wedge dump failed")
        faulted = 0
        for request in requests:
            if request.wedged:
                continue
            request.wedged = True
            request.cancelled = True
            faulted += 1
            # wake the consumer NOW: the serve loop that normally delivers
            # _DONE is the thing that is stuck
            request.out.put_nowait(_DONE)
        self.stats.watchdog_faulted += faulted
        self._cancel_dirty = True
        self._wake.set()

    def _note_cancel(self, request: GenRequest) -> None:
        """One cancelled request drained from any lane or queue: the
        journal line and the counter.  Expired, stalled, wedged, orphaned
        and shed requests were recorded where they were flagged and have
        their own counters."""
        self._drop_deadline(request)
        self._drop_lease(request)
        if request.expired or request.stalled or request.wedged or request.orphaned or request.shed:
            return
        self._journal.append(flightrec.EV_CANCEL, request.corr, request.slot)
        self.stats.cancelled_requests += 1

    def cancel_correlation(self, corr: str) -> int:
        """Abandon every request tagged ``corr`` (event-loop context; the
        engine is a :mod:`~calfkit_tpu_torch.cancellation` target); returns
        how many requests were newly flagged.  The scheduler's next pass
        reaps them through the ordinary cancellation path.  The decode
        thread may resize ``_active`` during the snapshot, so it retries
        and, if the race persists, defers the match to the scheduler pass."""
        if not corr:
            return 0
        for _ in range(4):
            try:
                candidates: list[GenRequest] = [
                    *self._active.values(), *self._carry, *self._pending,
                    *self._long_pending, *self._admitting,
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
        if self._long is not None:
            candidates.append(self._long["request"])
        if self._long_inflight is not None:
            candidates.append(self._long_inflight["request"])
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

    def _raise_terminal(self, request: GenRequest) -> None:
        """Typed stream endings: an engine-initiated cancel surfaces as a
        typed error at the consumer, not a silent short stream.  THE
        precedence law: **wedged > expired > orphaned > shed > stalled**.
        Wedged first (a live caller must fail over); expired before
        orphaned (the deadline is the caller's own contract); a priority
        shed after the non-retriable causes; stalled last."""
        if request.wedged:
            raise EngineWedgedError(
                "engine wedged while this request was pending "
                f"({request.generated} tokens delivered); retry against another replica",
                stalled_s=self.runtime.watchdog_stall_s,
            )
        if request.expired:
            raise DeadlineExceededError(
                f"request deadline passed after {request.generated} generated tokens"
            )
        if request.orphaned:
            raise RunOrphanedError(
                "caller lease lapsed; the run was reaped after "
                f"{request.generated} generated tokens",
                lease_id=request.lease_id or "",
            )
        if request.shed:
            lane, pending, limit = request.shed_detail or (
                "short", 0, self.runtime.max_pending or 0
            )
            raise EngineOverloadedError(
                f"queued batch-class request was shed from the {lane} "
                f"lane to admit interactive work (pending={pending}, "
                f"max_pending={limit}); retry with backoff",
                lane=lane, pending=pending, limit=limit,
            )
        if request.stalled:
            raise EngineOverloadedError(
                "token delivery stalled past max_out_blocks="
                f"{self.runtime.max_out_blocks}; request was cancelled",
                lane="delivery", pending=request.out.qsize(),
                limit=self.runtime.max_out_blocks,
            )

    async def _consume(self, request: GenRequest) -> AsyncIterator[int]:
        """Drain a queued request's tokens; abandoning the iterator flags
        cancellation for the scheduler to reap."""
        done = False
        try:
            while True:
                item = await request.out.get()
                if item is _DONE:
                    done = True
                    self._raise_terminal(request)
                    return
                for token in item:  # one dispatch's token block
                    if token is _DONE:
                        done = True
                        self._raise_terminal(request)
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
                if self._chaos is not None:
                    self._chaos("tick")
                self._drain_deferred_cancels()
                self._check_deadlines()
                self._check_orphans()
                self._check_stalls()
                self._reap_cancelled()
                if self._ragged:
                    # ragged unified waves: ONE scheduler lane — the pass
                    # forms/advances the admission wave and the decode rows
                    # through a single fused dispatch per tick
                    progressed = await self._ragged_pass()
                    progressed |= await self._advance_long()
                    if not progressed:
                        self._wake.clear()
                        if not self._queued_work():
                            await self._idle_wait()
                    continue
                if self.runtime.chunked_prefill:
                    progressed = await self._admit_chunked()
                else:
                    progressed = await self._admit()
                progressed |= await self._advance_long()
                if self._active:
                    await self._on_worker(
                        self._spec_decode_tick if self._drafter is not None
                        else self._decode_tick
                    )
                elif self._pend is not None:
                    # every participant retired/cancelled while a dispatch
                    # was in flight: land it so the deferred frees happen
                    await self._on_worker(self._drain_decode)
                elif not progressed and self._inflight is None:
                    self._wake.clear()
                    if not self._queued_work():
                        await self._idle_wait()
        except Exception as exc:  # noqa: BLE001 - the loop's crash rail
            logger.exception("inference engine scheduler crashed")
            self._running = False
            if _is_rank_fault(exc):
                # a rank of the group died or stopped answering: every owed
                # request ends with the typed, retriable fault at once
                self._trip_wedge(0.0)
            # the ring holds the decision sequence that led here: dump it
            # next to the traceback, never masking the fault itself
            try:
                self._journal.append(flightrec.EV_FAULT, None, -1, 0, 0, repr(exc))
                path = self._journal.dump(reason="fault")
                logger.error("flight-recorder fault dump: %s", path)
            except Exception:  # noqa: BLE001
                logger.exception("flight-recorder fault dump failed")
            self._finish_all()

    def _queued_work(self) -> bool:
        """Work that a scheduler pass can take up without a wake-up."""
        return bool(self._pending or self._carry or self._long_pending or self._long is not None)

    async def _on_worker(self, method: Any, *args: Any) -> Any:
        """Every dispatch of the engine runs on an ``asyncio.to_thread``
        worker through :func:`_call_weak`, so no worker thread holds the
        engine once the call has returned.  The hop there and back is the
        timeline's ``loop`` phase; the pass resumes in ``schedule``."""
        self._timeline.phase("loop")
        try:
            return await asyncio.to_thread(_call_weak, weakref.WeakMethod(method), *args)
        finally:
            self._timeline.phase("schedule")

    async def _idle_wait(self) -> None:
        """Wait for a submit or a stop holding no work: an idle boundary of
        the timeline (the device's idle until the next dispatch is no gap)."""
        self._timeline.idle()
        await self._wake.wait()
        self._timeline.phase("schedule")

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
                self._note_cancel(request)
                if request.slot != -1:
                    self._retire_slot(request)
                request.out.put_nowait(_DONE)
            self._inflight = None
        for request in list(self._active.values()):
            if request.cancelled:
                self._note_cancel(request)
                self._retire_slot(request)
                request.out.put_nowait(_DONE)
        if any(r.cancelled for r in self._carry):
            kept = []
            for request in self._carry:
                if request.cancelled:
                    self._note_cancel(request)
                    request.out.put_nowait(_DONE)
                else:
                    kept.append(request)
            self._carry = kept
        if any(r.cancelled for r in self._pending):
            kept_q: deque[GenRequest] = deque()
            for request in self._pending:
                if request.cancelled:
                    self._note_cancel(request)
                    request.out.put_nowait(_DONE)
                else:
                    kept_q.append(request)
            self._pending = kept_q
        if self._long is not None and self._long["request"].cancelled:
            self._note_cancel(self._long["request"])
            self._long["request"].out.put_nowait(_DONE)
            self._long = None
        if any(r.cancelled for r in self._long_pending):
            kept_l: deque[GenRequest] = deque()
            for request in self._long_pending:
                if request.cancelled:
                    self._note_cancel(request)
                    request.out.put_nowait(_DONE)
                else:
                    kept_l.append(request)
            self._long_pending = kept_l

    def _next_pending(self) -> GenRequest | None:
        while self._carry or self._pending:
            request = self._carry.pop(0) if self._carry else self._pending.popleft()
            if request.cancelled:
                self._note_cancel(request)
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
            self._journal.append(
                flightrec.EV_PREFIX_REL, request.corr, request.slot, len(request.shared_pages)
            )
            self._prefix.release(request.shared_pages)
            self._ledger.release(request.shared_pages)
        request.reuse_len = 0
        request.shared_pages = []

    def _alloc_with_eviction(
        self, slot: int, n: int, corr: "str | None" = None
    ) -> "list[int] | None":
        pages = self._page_alloc.alloc(slot, n)
        if pages is None:
            self._ledger.note_stall()
            self.stats.alloc_stalls += 1
            if self._prefix is not None:
                # idle cache entries are reclaimable capacity, not a leak;
                # the journal records the shortfall, tagged with the owner
                # whose admission forced the eviction
                self._journal.append(
                    flightrec.EV_PAGE_EVICT, corr, slot, n - self._page_alloc.free_pages
                )
                freed = self._prefix.evict(
                    n - self._page_alloc.free_pages, self._page_alloc, ledger=self._ledger
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
        if not self._free or self._peek_pending() is None:
            return None
        rt = self.runtime
        first = self._next_pending()
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
            self._ledger.acquire(first.shared_pages)
            self._journal.append(
                flightrec.EV_PREFIX_ACQ, first.corr, -1, len(first.shared_pages)
            )
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
                self._ledger.acquire(peeked.shared_pages)
                self._journal.append(
                    flightrec.EV_PREFIX_ACQ, peeked.corr, -1, len(peeked.shared_pages)
                )
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
            self._journal.append(flightrec.EV_WAVE_FORM, None, -1, len(wave), wave_bucket)
            return self._formed(wave), wave_bucket
        # the tail of an unservable wave waits at the queue front
        granted: list[GenRequest] = []
        for i, request in enumerate(wave):
            slot = self._free.pop()
            shared = request.shared_pages  # acquired at formation
            need = self._reserve_pages(request, wave_bucket) - len(shared)
            pages = self._alloc_with_eviction(slot, need, request.corr)
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
            self._journal.append(
                flightrec.EV_PAGE_ALLOC, request.corr, slot, len(request.pages), len(shared)
            )
            self._ledger.alloc(
                slot, len(pages), request.corr, request.run, capacity.lane_kind(request.history)
            )
            granted.append(request)
        if not granted:
            return None  # pool exhausted: wait for retirements
        # keep waves power-of-two after page trimming too
        keep = _pow2_floor(len(granted))
        for request in granted[keep:]:
            self._journal.append(flightrec.EV_PAGE_FREE, request.corr, request.slot)
            self._page_alloc.free(request.slot)
            self._ledger.free(request.slot)
            self._free.append(request.slot)
            request.slot = -1
            request.pages = []
            self._drop_reuse_plan(request)
        self._carry = granted[keep:] + self._carry
        self._journal.append(flightrec.EV_WAVE_FORM, None, -1, keep, wave_bucket)
        return self._formed(granted[:keep]), wave_bucket

    @staticmethod
    def _formed(wave: "list[GenRequest]") -> "list[GenRequest]":
        """Stamp the formation of ``wave``: its members' queue wait ends."""
        now = time.perf_counter()
        for request in wave:
            request.formed_at = now
        return wave

    def _activate_wave(self, wave: list[GenRequest]) -> None:
        for request in wave:
            # a request can retire DURING its own prefill (first token was
            # a stop, or max_new_tokens == 1): its slot is already free
            if request.slot == -1:
                continue
            if request.cancelled:
                # abandoned while its admission was in flight: release the
                # slot and pages instead of activating a corpse
                self._note_cancel(request)
                self._retire_slot(request)
                request.out.put_nowait(_DONE)
                continue
            self._active[request.slot] = request
            self._journal.append(
                flightrec.EV_ADMIT, request.corr, request.slot, len(request.prompt),
                request.reuse_len,
            )
            self._track_retirement(request)
            row = self._stop_np[request.slot]
            row[:] = -1
            stops = sorted(request.stop_tokens)[: row.shape[0]]
            row[: len(stops)] = stops
            self._hard_end[request.slot] = min(
                len(request.prompt) + request.max_new_tokens - 1,
                self.runtime.max_seq_len - 2,
            )
            self._retire_dirty = True  # device copies stale: copy at launch
            if self._drafter is not None:
                self._drafter.admit(request.slot, request.prompt)

    async def _admit(self) -> bool:
        admitted = False
        while (formed := self._form_wave()) is not None:
            wave, wave_bucket = formed
            self._admitting = wave
            try:
                await self._on_worker(self._prefill_wave, wave, wave_bucket)
            finally:
                self._admitting = []
            self._activate_wave(wave)
            admitted = True
        return admitted

    # ------------------------------------------------- long-context lane
    # Prompts that cannot fit a short-lane slot are served one at a time:
    # the prefill runs over the whole padded prompt into the lane's own
    # scratch (monolithic, or one chunk per scheduler pass under chunked
    # prefill), and decode runs against that prefix merged with a
    # fresh-token cache (``ring_attention.decode_sp_dispatch``).  One long
    # dispatch per scheduler pass interleaves with the short lane's ticks,
    # so short streams' inter-token latency stays bounded while a long
    # request is in flight.  Every dispatch is a graph of ``_long_graphs``.

    def _long_max_prompt(self) -> int:
        rt = self.runtime
        return rt.long_max_prompt or 8 * rt.max_seq_len

    def _long_fresh_cap(self) -> int:
        """Static size of the fresh-token cache: one buffer (and one decode
        graph per prefix bucket) whatever a request's max_new_tokens."""
        steps = self.runtime.decode_steps_per_dispatch
        return -(-self.runtime.long_new_cap // steps) * steps

    def _long_padded(self, n: int) -> int:
        """Pad to a power-of-two multiple of lcm(sp, prefill_chunk): the
        sequence must divide over sp, and power-of-two bucketing bounds the
        lane's graphs at log(range) prefix lengths."""
        g = math.lcm(self._sp, self.runtime.prefill_chunk)
        units = -(-n // g)
        p2 = 1
        while p2 < units:
            p2 *= 2
        return g * p2

    def _long_prefix(self, padded: int) -> "tuple[torch.Tensor, torch.Tensor]":
        """The [L, 1, K, padded/sp, hd] views of the lane's prefix scratch:
        this rank's block of a prompt padded to ``padded``."""
        return tuple(side[:, :, :, :padded // self._sp] for side in self._long_scratch)

    async def _advance_long(self) -> bool:
        if not self.runtime.long_context:
            return False
        if self._long is not None:
            await self._on_worker(self._long_decode_tick)
            return True
        if self._long_inflight is not None:
            await self._on_worker(self._advance_long_prefill)
            return True
        request = None
        while self._long_pending:
            candidate = self._long_pending.popleft()
            if candidate.cancelled:
                self._note_cancel(candidate)
                candidate.out.put_nowait(_DONE)
                continue
            request = candidate
            break
        if request is None:
            return False
        self._journal.append(flightrec.EV_ADMIT_LONG, request.corr, -1, len(request.prompt))
        self._formed([request])
        if self.runtime.chunked_prefill:
            # resumable: one chunk per scheduler pass, the short lane's
            # ticks run between chunks
            self._start_long_inflight(request)
            return True
        self._admitting = [request]
        try:
            await self._on_worker(self._long_prefill, request)
        finally:
            self._admitting = []
        return True

    def _long_tokens(self, request: GenRequest, padded: int) -> np.ndarray:
        tokens = np.zeros((1, padded), np.int32)
        tokens[0, : len(request.prompt)] = request.prompt
        return tokens

    def _install_long_state(
        self, request: GenRequest, padded: int, n: int, first: int, started: float
    ) -> None:
        """Shared landing of both long-prefill paths (the first token is in
        ``_long_last`` on the device too): emit it and stage the decode
        state."""
        request.prefill_ms = (time.perf_counter() - started) * 1000.0
        self.stats.prefill_tokens += n
        self.stats.long_requests += 1
        self._note_progress()  # a long prefill landing is watchdog progress
        self._observe("prefill_ms", request.prefill_ms)
        ttft_ms = (time.perf_counter() - request.started_at) * 1000.0
        self._observe("ttft_ms", ttft_ms)
        # the long lane's wait is everything before its prefill started
        self._observe("queue_wait_ms", max(0.0, ttft_ms - request.prefill_ms))
        self._note_admitted(request, time.perf_counter())
        if self._emit_long(request, first):
            return
        self._long = dict(
            request=request, padded=padded, prefix_len=n, t=0, cap=self._long_fresh_cap()
        )

    @_replicated
    def _long_prefill_graph(self, padded: int) -> graphs.CapturedDispatch:
        """The monolithic long prefill: the whole padded prompt through
        ``prefill_sequence_parallel``, this rank's block of its K/V written
        into the prefix scratch, the first token (greedy) into
        ``_long_last`` → fn(tokens [1, padded], n [1]) → ``_long_last``."""

        def build():
            eng, cfg, comm = weakref.proxy(self), self.config, self._comm
            prefix = self._long_prefix(padded)

            def prefill(tokens, n):
                logits, _ = RA.prefill_sequence_parallel(
                    eng.params, cfg, tokens, n, prefix, comm=comm
                )
                eng._long_last.copy_(torch.argmax(logits, dim=-1))
                return eng._long_last

            return prefill, [((1, padded), torch.int32), ((1,), torch.int32)]

        return self._cached(self._long_graphs, ("prefill_sp", padded), build)

    def _long_prefill(self, request: GenRequest) -> None:
        n = len(request.prompt)
        padded = self._long_padded(n)
        started = time.perf_counter()
        first = self._long_prefill_graph(padded)(
            self._long_tokens(request, padded), np.asarray([n], np.int32)
        )
        (first,) = self._sync_host(self._stage_host((first,)))
        self._install_long_state(request, padded, n, int(first[0]), started)

    @_replicated
    def _long_chunk_graph(self, chunk: int, padded: int) -> graphs.CapturedDispatch:
        """One chunk of the chunked long prefill: the short lane's chunk
        body over the prefix scratch's first ``padded`` positions (at sp >
        1, ``prefill_chunk_sequence_parallel`` over this rank's block of
        them), and the greedy token at ``last_idx`` into ``_long_last`` →
        fn(tokens [1, chunk], offset [1], last_idx [1]) → ``_long_last``."""

        def build():
            eng, cfg, comm = weakref.proxy(self), self.config, self._comm
            prefix = self._long_prefix(padded)
            if self._sp == 1:
                chunk_step = self._chunk_body(chunk, 1, prefix)
            else:
                def chunk_step(tokens, offset, last_idx):
                    return RA.prefill_chunk_sequence_parallel(
                        eng.params, cfg, tokens, offset, last_idx, prefix, comm=comm
                    )

            def long_chunk(tokens, offset, last_idx):
                logits = chunk_step(tokens, offset, last_idx)
                eng._long_last.copy_(torch.argmax(logits, dim=-1))
                return eng._long_last

            return long_chunk, self._chunk_specs(chunk, 1)

        return self._cached(self._long_graphs, ("chunk", chunk, 1, padded), build)

    def _start_long_inflight(self, request: GenRequest) -> None:
        """Host-side setup of a resumable chunked long prefill over the
        prefix scratch.  Only the chunks that cover the prompt run; the
        positions past it are never attended (the decode masks them)."""
        n = len(request.prompt)
        padded = self._long_padded(n)
        chunk = min(self.runtime.prefill_chunk, padded)
        self._long_inflight = dict(
            request=request, tokens=self._long_tokens(request, padded), true_len=n,
            padded=padded, chunk=chunk, n_chunks=-(-n // chunk), idx=0,
            started=time.perf_counter(),
        )

    def _advance_long_prefill(self) -> None:
        """One chunk of the inflight long prefill; land on the last."""
        inf = self._long_inflight
        request = inf["request"]
        if request.cancelled:
            self._note_cancel(request)
            self._long_inflight = None
            # runs on the to_thread worker: queue puts marshal to the loop
            self._loop.call_soon_threadsafe(request.out.put_nowait, _DONE)
            return
        chunk, idx, n = inf["chunk"], inf["idx"], inf["true_len"]
        offset = idx * chunk
        # the last prompt-covering chunk holds the final valid position
        last_idx = (n - 1) - (inf["n_chunks"] - 1) * chunk if idx + 1 == inf["n_chunks"] else 0
        first = self._long_chunk_graph(chunk, inf["padded"])(
            inf["tokens"][:, offset:offset + chunk], np.asarray([offset], np.int32),
            np.asarray([last_idx], np.int64),
        )
        inf["idx"] = idx + 1
        if inf["idx"] < inf["n_chunks"]:
            return
        (first,) = self._sync_host(self._stage_host((first,)))
        self._long_inflight = None
        self._install_long_state(request, inf["padded"], n, int(first[0]), inf["started"])

    @_replicated
    def _long_decode_graph(self, steps: int, padded: int) -> graphs.CapturedDispatch:
        """The long lane's decode dispatch: ``steps`` greedy tokens from
        ``_long_last`` against the prefix's first ``padded`` positions and
        the fresh cache (written in place at t0 + i), ``_long_last``
        advanced in place → fn(t0 [1], prefix_len [1]) → toks [1, steps]."""
        cap = self._long_fresh_cap()

        def build():
            eng, cfg, comm = weakref.proxy(self), self.config, self._comm
            prefix, fresh = self._long_prefix(padded), self._long_fresh

            def decode(t0, prefix_len):
                toks, last, _ = RA.decode_sp_dispatch(
                    eng.params, cfg, eng._long_last, prefix, prefix_len, fresh, t0, steps,
                    comm=comm,
                )
                eng._long_last.copy_(last)
                return toks

            return decode, [((1,), torch.int32), ((1,), torch.int32)]

        return self._cached(
            self._long_graphs, ("decode_sp", steps, 1, cap, padded), build, kind="decode"
        )

    def _long_decode_tick(self) -> None:
        """One long-lane pass.  Overlap mode launches the next dispatch
        before it lands the previous one, as the short lane does; the
        block's host copy is staged right after its launch, before the
        follow-up replays over the graph's output.  A stop token found in
        the landed block abandons the launched follow-up (its steps count
        as ``overlap_wasted_tokens``; what it writes into the lane's
        buffers is overwritten by the next request before it is read)."""
        state = self._long
        request = state["request"]
        pend = state.pop("pend", None)
        launched: "dict | None" = None
        if state["t"] < state["cap"]:
            steps = min(self.runtime.decode_steps_per_dispatch, state["cap"] - state["t"])
            started = time.perf_counter()
            toks = self._long_decode_graph(steps, state["padded"])(
                np.asarray([state["t"]], np.int32), np.asarray([state["prefix_len"]], np.int32)
            )
            state["t"] += steps
            launched = dict(staged=self._stage_host((toks,)), steps=steps, started=started)
        if self.runtime.overlap_dispatch:
            # double-buffered: the block launched THIS pass lands next pass,
            # with its follow-up already in flight
            state["pend"] = launched
            landing = pend
        else:
            landing = launched
        if landing is None:
            return  # the first overlapped pass: launch only
        (block,) = self._sync_host(landing["staged"])  # [1, steps]: the lane's sync
        now = time.perf_counter()
        start = landing["started"]
        last_sync = state.get("synced_at")
        if last_sync is not None and last_sync > start:
            start = last_sync  # exclusive wall (see _land_decode)
        state["synced_at"] = now
        # NOT decode_dispatches: that counts mean_occupancy's denominator,
        # and a long dispatch holds no slot
        self._note_progress()
        self.stats.long_dispatches += 1
        self.stats.decode_steps += landing["steps"]
        self.stats.decode_time_s += now - start
        done = False
        for token in block[0]:
            done = self._emit_long(request, int(token))
            if done:
                break
        inflight = state.get("pend")
        if done:
            if inflight is not None:
                # one-dispatch-late retirement: the launched follow-up's
                # block is all pad now
                self.stats.overlap_wasted_tokens += inflight["steps"]
            self._drop_deadline(request)
            self._drop_lease(request)
            self._long = None
        elif state["t"] >= state["cap"] and inflight is None:
            self._drop_deadline(request)
            self._drop_lease(request)
            self._loop.call_soon_threadsafe(request.out.put_nowait, _DONE)
            self._long = None

    def _emit_long(self, request: GenRequest, token: int) -> bool:
        """Record one long-lane token (on the to_thread worker) → True when
        the request retired."""
        items: list = []
        done = self._record_token(request, token, items, long=True)
        if items:
            self._loop.call_soon_threadsafe(_deliver_batch, [(request.out, items)])
        return done

    # ------------------------------------------------------- device work
    def _stage_host(self, tensors: "tuple[torch.Tensor, ...]") -> tuple:
        """Enqueue device → host copies of ``tensors`` into pinned memory,
        then an event after them: :meth:`_sync_host` waits for exactly this
        work, never for dispatches enqueued later.  Staged right after the
        dispatch that wrote them, before any other dispatch replays over
        them (graph outputs live until the next replay; ``_done`` until the
        next decode dispatch)."""
        mark = self._timeline.mark()
        if self.device.type == "cpu":
            return tuple(t.clone() for t in tensors), None, mark
        hosts = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in tensors
        )
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return hosts, event, mark

    def _sync_host(self, staged: tuple) -> "tuple[np.ndarray, ...]":
        """THE designated device→host sync point of the dispatch loop.  The
        landing begins at its call; once it returns, the timeline reads the
        marks of every dispatch enqueued before the staged event, and the
        dispatch-gap histogram observes the flagged ones."""
        hosts, event, mark = staged
        self._timeline.phase("land")
        if event is not None:
            event.synchronize()
        for gap in self._timeline.sync(mark):
            self._observe("dispatch_gap_ms", gap * 1000.0)
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

    def _scratch(self, rows: int) -> "tuple[torch.Tensor, torch.Tensor]":
        """The wave scratch of ``rows`` rows: [L, rows, K, max_seq_len, hd]
        K and V views of the engine's flat buffer, the same for every wave
        of that width (a wave of bucket P uses positions [0, P))."""
        cfg = self.config
        shape = (cfg.n_layers, rows, self._kv_heads, self.runtime.max_seq_len, cfg.head_dim)
        n = math.prod(shape)
        half = self._scratch_flat.numel() // 2
        return (
            self._scratch_flat[:n].view(shape), self._scratch_flat[half:half + n].view(shape)
        )

    def _wave_specs(self, rows: int, bucket: int) -> list:
        """Static inputs of a wave landing: slots, true_lens, seeds, w_temp,
        w_top_k, w_top_p (and paged: table rows, scatter pages)."""
        specs = [
            ((rows,), torch.int64), ((rows,), torch.int32), ((rows,), torch.int64),
            ((rows,), torch.float32), ((rows,), torch.int32), ((rows,), torch.float32),
        ]
        if self._paged:
            specs += [
                ((rows, self.runtime.pages_per_seq()), torch.int32),
                ((rows, bucket // self.runtime.page_size), torch.int64),
            ]
        return specs

    def _wave_inputs(self, wave: list[GenRequest], bucket: int, arrays: dict) -> list:
        """The host arrays of :meth:`_wave_specs` for ``wave``."""
        inputs = [arrays[name] for name in (
            "slots", "true_lens", "seeds", "w_temp", "w_top_k", "w_top_p",
        )]
        if self._paged:
            inputs += self._paged_wave_args(wave, bucket)
        return inputs

    def _cached(
        self, table: dict, key: tuple, build: Any, kind: str = "prefill",
    ) -> graphs.CapturedDispatch:
        """The dispatch of ``key`` in ``table``, made at the key's first use
        from ``build()`` → (body, static input specs), timed as ``kind``
        (decode, mixed or prefill).  A body reaches the engine through a
        weak proxy: the graphs the engine holds must not hold the engine,
        or a dropped engine's weights, caches and graph pool would wait for
        the cycle collector."""
        fn = table.get(key)
        if fn is None:
            fn = table[key] = graphs.CapturedDispatch(self._graphs, *build(), kind=kind)
        return fn

    def _land_body(self, bucket: int, rows: int, sampled: bool) -> Any:
        """The wave landing's body over the scratch's first ``bucket``
        positions → fn(last_logits [R, V], *wave inputs) → firsts [R]."""
        eng = weakref.proxy(self)
        sk, sv = (side[:, :, :, :bucket] for side in self._scratch(rows))
        split = self._rows is not None and not self._paged
        k, v = (self._k_rows, self._v_rows) if split else (self._k, self._v)
        cache_rows = self._rows if split else None

        def land(last_logits, slots, true_lens, seeds, w_temp, w_top_k, w_top_p, *paged):
            if paged:  # (page_rows, scatter_ids)
                paged = (eng._tables, *paged)
            else:
                paged = (None, None, None)
            return _finalize_wave_math(
                sampled, eng._paged, k, v, sk, sv,
                eng._last, eng._lens, slots, true_lens, last_logits,
                eng._slot_seeds, eng._temp, eng._top_k, eng._top_p,
                seeds, w_temp, w_top_k, w_top_p, *paged, cache_rows=cache_rows,
            )

        return land

    @_replicated
    def _prefill_graph(self, bucket: int, rows: int, sampled: bool) -> graphs.CapturedDispatch:
        """Single-shot prefill: R admissions run as one [R, bucket] forward
        on the scratch, then land in the slot rows (or reserved pages), in
        one graph → fn(tokens, last_idx, *wave inputs) → firsts [R]."""

        def build():
            eng, cfg, dev = weakref.proxy(self), self.config, self.device
            scratch = self._scratch(rows)
            land = self._land_body(bucket, rows, sampled)

            def prefill(tokens, last_idx, *wave):
                pos = torch.arange(bucket, dtype=torch.int32, device=dev).expand(rows, bucket)
                logits, _ = M.forward(
                    eng.params, cfg, tokens, pos, scratch,
                    torch.full((rows,), bucket, dtype=torch.int32, device=dev),
                    attn_window=bucket,
                )
                return land(logits[torch.arange(rows, device=dev), last_idx], *wave)

            specs = [((rows, bucket), torch.int32), ((rows,), torch.int64)]
            return prefill, specs + self._wave_specs(rows, bucket)

        return self._cached(self._prefill_graphs, (bucket, rows, sampled), build)

    @_replicated
    def _final_graph(self, bucket: int, rows: int, sampled: bool) -> graphs.CapturedDispatch:
        """The chunked wave's landing from its scratch and its final chunk's
        last-position logits → fn(last_logits, *wave inputs) → firsts [R]."""

        def build():
            # logits come in the activations' dtype, the embedding's
            specs = [((rows, self.config.vocab_size), self.params["embed"].dtype)]
            return self._land_body(bucket, rows, sampled), specs + self._wave_specs(rows, bucket)

        return self._cached(self._prefill_graphs, ("final", bucket, rows, sampled), build)

    def _prefill(self, wave: list[GenRequest], bucket: int, arrays: dict) -> torch.Tensor:
        """Batched prefill of a formed wave through its graph → firsts [R]
        (device)."""
        R = len(wave)
        last_idx = np.clip(arrays["true_lens"] - 1, 0, bucket - 1).astype(np.int64)
        return self._prefill_graph(bucket, R, arrays["sampled"])(
            arrays["tokens"], last_idx, *self._wave_inputs(wave, bucket, arrays)
        )

    def _land_wave(
        self, wave: list[GenRequest], true_lens: np.ndarray,
        firsts: np.ndarray, elapsed: float,
    ) -> None:
        """Host side of the wave landing: stats, latency observations,
        host-mirror lens, and the first-token emission, marshalled to the
        event loop in ONE batch."""
        self.stats.prefill_waves += 1
        elapsed_ms = elapsed * 1000.0
        deliveries: list[tuple[asyncio.Queue, list]] = []
        self._note_progress()  # a wave landing is watchdog progress
        self._observe("prefill_ms", elapsed_ms)
        self._journal.append(flightrec.EV_WAVE_LAND, None, -1, len(wave), int(elapsed_ms))
        now = time.perf_counter()
        for r, request in enumerate(wave):
            if request.slot == -1:
                continue
            request.prefill_ms = elapsed_ms
            self.stats.prefill_tokens += int(true_lens[r])
            # the wave lands the first token, so submit → now IS the TTFT;
            # what precedes the prefill work is queue wait (per admission,
            # never per token)
            ttft_ms = (now - request.started_at) * 1000.0
            self._observe("ttft_ms", ttft_ms)
            self._observe("queue_wait_ms", max(0.0, ttft_ms - elapsed_ms))
            self._note_admitted(request, now)
            # the prompt occupies [0, true_len); decode inserts from true_len
            self._host_lens[request.slot] = int(true_lens[r])
            items: list = []
            self._record_token(request, int(firsts[r]), items)
            if items:
                deliveries.append((request.out, items))
        if deliveries:
            self._loop.call_soon_threadsafe(_deliver_batch, deliveries)

    def _note_admitted(self, request: GenRequest, landed: float) -> None:
        """A request's first token landed at ``landed``: its queue wait
        (submit → its wave's formation) and prefill span (formation →
        landing) into the counters, and by its corr for
        :meth:`request_timing`."""
        wait = request.formed_at - request.started_at
        span = landed - request.formed_at
        stats = self.stats
        stats.admitted_requests += 1
        stats.queue_wait_s += wait
        stats.prefill_span_s += span
        if request.corr is not None:
            timing = self._request_timing
            timing[request.corr] = dict(
                queue_wait_ms=round(wait * 1e3, 3), prefill_span_ms=round(span * 1e3, 3),
                reused_tokens=request.reuse_len,
            )
            if len(timing) > _TIMING_KEPT:  # corrs nobody reads: oldest out
                del timing[next(iter(timing))]

    def request_timing(self, corr: str) -> "dict | None":
        """The newest landed request tagged ``corr``: ``queue_wait_ms``
        (submit → the formation of the wave that admitted it),
        ``prefill_span_ms`` (that formation → its first token's landing)
        and ``reused_tokens`` (prompt tokens the prefix cache served) →
        None before its landing.  Reading it forgets it."""
        return self._request_timing.pop(corr, None)

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
        if await self._on_worker(self._advance_inflight):
            wave = self._inflight["wave"]
            self._inflight = None
            self._activate_wave(wave)
        return True

    def _start_inflight_wave(self, wave: list[GenRequest], bucket: int) -> None:
        """Stage a formed wave for chunked advancement: prefix-seed the
        scratch where the wave reuses cached pages, and record the chunk
        cursor.  Shared by the bifurcated chunked lane and the ragged
        unified lane."""
        chunk = min(self.runtime.prefill_chunk, bucket)
        reuse = wave[0].reuse_len  # uniform across the wave
        if reuse:
            # seed the scratch with the cached prefix K/V (each row's pages
            # copied from the pool) and resume the chunk loop at the reused
            # offset
            npg = reuse // self.runtime.page_size
            ids = np.asarray([request.pages[:npg] for request in wave], np.int64)
            self._seed_graph(bucket, npg, len(wave))(ids)
            self.stats.prefix_hits += len(wave)
            self.stats.prefix_reused_tokens += reuse * len(wave)
        arrays = self._wave_arrays(wave, bucket)
        # every row's last prompt position lies in the final chunk (the
        # wave shares one bucket): its index there
        arrays["last_idx"] = np.clip(
            arrays["true_lens"] - 1 - (bucket - chunk), 0, chunk - 1
        ).astype(np.int64)
        self._inflight = dict(
            wave=wave, bucket=bucket, chunk=chunk,
            n_chunks=-(-bucket // chunk), idx=reuse // chunk,
            arrays=arrays,
            started=time.perf_counter(),
        )

    @_replicated
    def _seed_graph(self, bucket: int, n_pages: int, rows: int) -> graphs.CapturedDispatch:
        """The prefix seed: the first ``n_pages`` pages of each scratch row
        copied from the pool → fn(ids [R, n_pages]).  The positions after
        them are written by the wave's chunks before any query reads them."""

        def build():
            eng, cfg = weakref.proxy(self), self.config
            span = n_pages * self.runtime.page_size
            scratch = self._scratch(rows)

            def seed(ids):
                for side, pool in zip(scratch, (eng._k, eng._v)):
                    pages = pool[:, ids]  # [L, R, n, K, page, hd]
                    side[:, :, :, :span] = pages.permute(0, 1, 3, 2, 4, 5).reshape(
                        cfg.n_layers, rows, eng._kv_heads, span, cfg.head_dim
                    )

            return seed, [((rows, n_pages), torch.int64)]

        return self._cached(self._prefill_graphs, ("seed", bucket, n_pages, rows), build)

    def _chunk_body(self, chunk: int, rows: int, scratch: "tuple | None" = None) -> Any:
        """The prefill-chunk body, shared by the chunk, the ragged and the
        long lane's chunk graphs: a forward of [R, chunk] tokens at a device
        offset into ``scratch`` (default: the wave's), written in place →
        fn(tokens, offset [1], last_idx [R]) → the logits [R, V] at each
        row's ``last_idx``."""
        eng, cfg, dev = weakref.proxy(self), self.config, self.device
        scratch = self._scratch(rows) if scratch is None else scratch

        def chunk_step(tokens, offset, last_idx):
            pos = (offset + torch.arange(chunk, dtype=torch.int32, device=dev)).expand(rows, chunk)
            logits, _ = M.forward(
                eng.params, cfg, tokens, pos, scratch, (offset + chunk).expand(rows)
            )
            return logits[torch.arange(rows, device=dev), last_idx]

        return chunk_step

    def _chunk_specs(self, chunk: int, rows: int) -> list:
        return [((rows, chunk), torch.int32), ((1,), torch.int32), ((rows,), torch.int64)]

    @_replicated
    def _chunk_graph(self, chunk: int, rows: int) -> graphs.CapturedDispatch:
        return self._cached(
            self._prefill_graphs, ("chunk", chunk, rows),
            lambda: (self._chunk_body(chunk, rows), self._chunk_specs(chunk, rows)),
        )

    def _chunk_inputs(self, inf: dict) -> list:
        """The inflight wave's next chunk as the chunk body's inputs, and
        the cursor advanced."""
        chunk, idx = inf["chunk"], inf["idx"]
        offset = idx * chunk
        inf["idx"] = idx + 1
        return [
            inf["arrays"]["tokens"][:, offset:offset + chunk],
            np.asarray([offset], np.int32), inf["arrays"]["last_idx"],
        ]

    def _advance_inflight(self) -> bool:
        """Run one chunk of the inflight wave in its OWN invocation (the
        bifurcated lane, and the ragged lane when the token budget refuses
        absorption); finalize after the last.  True when the wave landed."""
        inf = self._inflight
        logits = self._chunk_graph(inf["chunk"], len(inf["wave"]))(*self._chunk_inputs(inf))
        self._journal.append(flightrec.EV_PREFILL_CHUNK, None, -1, inf["idx"], inf["n_chunks"])
        if inf["idx"] < inf["n_chunks"]:
            return False
        return self._finalize_inflight(logits)

    def _finalize_inflight(self, last_logits: torch.Tensor) -> bool:
        """The chunked wave's landing (last chunk done) from the final
        chunk's last-position logits: the landing graph, the first-token
        sync, prefix registration.  One host sync per WAVE, shared by the
        bifurcated and ragged lanes."""
        inf = self._inflight
        wave, arrays, bucket = inf["wave"], inf["arrays"], inf["bucket"]
        firsts = self._final_graph(bucket, len(wave), arrays["sampled"])(
            last_logits, *self._wave_inputs(wave, bucket, arrays)
        )
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
        fresh_hashes: list = []
        for i in range(len(request.shared_pages), full):
            page = request.pages[i]
            if self._prefix.register(request.page_hashes[i], page):
                fresh.append(page)
                fresh_hashes.append(request.page_hashes[i])
            # else another request registered this chain position first:
            # this duplicate page stays private (slot-held, freed at
            # retirement), and LATER positions still register — sessions
            # sharing only a scaffold page must still cache their own
            # chains (equal chain hash ⇒ equal page content)
        if fresh:
            self._page_alloc.transfer_out(request.slot, fresh)
            self._prefix.acquire(fresh)
            # the pages leave the slot's private count and enter chain
            # ownership at refcount 1 (this request's own reference)
            self._ledger.transfer(request.slot, fresh, fresh_hashes)
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
            if await self._on_worker(self._ragged_tick):
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
        if self._chaos is not None and self._active:
            self._chaos("dispatch")
        pend = self._pend
        finished = False
        if self._active:
            finished = self._launch_ragged()
        elif self._inflight is not None:
            finished = self._advance_inflight()
        if pend is not None:
            self._land_pend(pend)
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
        done_prev = self._done if self._pend is not None else self._done_zero
        R = len(inf["wave"])
        self._observe_gap()
        self._journal.append(flightrec.EV_DISPATCH_LAUNCH, None, -1, steps, len(self._active))
        self._journal.append(flightrec.EV_RAGGED_WAVE, None, -1, len(self._active), R)
        started = time.perf_counter()
        self._copy_retire_args()
        fn = self._ragged_graph(window, steps, sampled, inf["chunk"], R)
        logits, toks, n_valid, done = fn(*self._chunk_inputs(inf), active, done_prev)
        self._journal.append(flightrec.EV_PREFILL_CHUNK, None, -1, inf["idx"], inf["n_chunks"])
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

    def _decode_body(self, window: int, steps: int, sampled: bool) -> Any:
        """The decode dispatch body, shared by the decode and the ragged
        graphs: ``steps`` ring-buffer decode steps over the read-only cache
        window (dense rows, or ``ceil(window / page)`` pages per row through
        the block tables), argmax or ``sample_slots`` per step, then the
        ring's consolidation and ``retire_mask_slots``; ``last``, ``lens``
        and ``_done`` are updated in place.  Enqueues device work only — no
        host sync.  → fn(active [B], done_prev [B]) → (toks [steps, B],
        n_valid, done).

        With dp, a rank computes its group's rows ``mine`` of the batch and
        the groups' token blocks are gathered; paged, so is the ring, which
        every group writes into its whole copy of the pool."""
        eng, cfg, dev = weakref.proxy(self), self.config, self.device
        B = self.runtime.max_batch_size
        first, n_rows = self._rows or (0, B)
        mine = slice(first, first + n_rows)
        gather = None if self._rows is None else self._layout.comm.dp_gather
        ring_shape = (cfg.n_layers, steps, n_rows, self._kv_heads, cfg.head_dim)
        if self._paged:
            wpages = -(-window // self.runtime.page_size)

            def step(tokens, ring, t, lens):
                return M.decode_step_ring_paged(
                    eng.params, cfg, tokens, (eng._k, eng._v), eng._tables[mine], ring, t, lens,
                    wpages,
                )
        else:
            window_kv = (self._k[:, :, :, :window], self._v[:, :, :, :window])

            def step(tokens, ring, t, lens):
                return M.decode_step_ring(eng.params, cfg, tokens, window_kv, ring, t, lens)

        def decode(active, done_prev):
            # ``done_prev`` is the PREVIOUS dispatch's device-side done
            # mask: under overlap a row that retired there is frozen here by
            # pure device dataflow, before the host has seen that block
            # (paged: its consolidation writes go to the trash page)
            active = active & torch.logical_not(done_prev)
            lens = eng._lens
            last, my_lens, my_active = eng._last[mine], lens[mine], active[mine]
            ring = (
                torch.zeros(ring_shape, dtype=eng._k.dtype, device=dev),
                torch.zeros(ring_shape, dtype=eng._v.dtype, device=dev),
            )
            toks = []
            for t in range(steps):
                logits, ring = step(last[:, None], ring, t, my_lens)
                if sampled:
                    # per-(request, position) streams: deterministic for a
                    # given seed regardless of batch composition / slot
                    # reuse (+1: position ``lens`` itself was the prefill's
                    # draw)
                    keys = fold_in(eng._slot_seeds[mine], my_lens + t + 1)
                    nxt = sample_slots(
                        logits[:, -1], keys, eng._temp[mine], eng._top_k[mine], eng._top_p[mine]
                    )
                else:
                    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                last = torch.where(my_active, nxt, last)
                toks.append(last)
            block = torch.stack(toks)  # [steps, rows]
            if gather is not None:
                block = gather(block, dim=1)  # [steps, B]
            if eng._paged:
                if gather is not None:
                    ring = (gather(ring[0], dim=2), gather(ring[1], dim=2))
                M.consolidate_ring_paged((eng._k, eng._v), ring, eng._tables, lens, active)
            else:
                M.consolidate_ring((eng._k, eng._v), ring, my_lens)
            n_valid, done = retire_mask_slots(block.T, eng._stop_dev, eng._hard_dev - lens, active)
            eng._lens.copy_(torch.where(active, lens + steps, lens))
            eng._last.copy_(block[-1])
            eng._done.copy_(done)
            return block, n_valid, eng._done

        return decode

    @_replicated
    def _decode_graph(self, window: int, steps: int, sampled: bool) -> graphs.CapturedDispatch:
        if self._paged:
            key: tuple = (-(-window // self.runtime.page_size), steps, sampled, "paged")
        else:
            key = (window, steps, sampled)
        B = self.runtime.max_batch_size
        return self._cached(
            self._decode_graphs, key,
            lambda: (self._decode_body(window, steps, sampled), [((B,), torch.bool)] * 2),
            kind="decode",
        )

    @_replicated
    def _ragged_graph(
        self, window: int, steps: int, sampled: bool, chunk: int, rows: int
    ) -> graphs.CapturedDispatch:
        """THE unified prefill+decode dispatch: the inflight wave's next
        chunk, then the decode dispatch, in one graph → fn(chunk inputs,
        active, done_prev) → (last_logits, toks, n_valid, done)."""

        def build():
            chunk_step = self._chunk_body(chunk, rows)
            decode = self._decode_body(window, steps, sampled)

            def ragged(tokens, offset, last_idx, active, done_prev):
                last_logits = chunk_step(tokens, offset, last_idx)
                return (last_logits, *decode(active, done_prev))

            B = self.runtime.max_batch_size
            return ragged, self._chunk_specs(chunk, rows) + [((B,), torch.bool)] * 2

        wkey = -(-window // self.runtime.page_size) if self._paged else window
        return self._cached(
            self._decode_graphs, ("ragged", wkey, steps, sampled, chunk, rows), build, kind="mixed"
        )

    # ---------------------------------------------------- speculative verify
    @_replicated
    def _verify_graph(self, window: int, S: int, sampled: bool) -> graphs.CapturedDispatch:
        """The speculative verify dispatch: feed [last, d_0..d_{S-2}] per
        row, score all S positions in one forward against the cache window
        (dense rows, or ``ceil(window / page)`` pages per row through the
        block tables), accept a ragged per-row prefix
        (``spec_accept_slots``), consolidate the chunk's K/V in place and
        advance each row by its own ``emitted``.  Rejected positions land
        past the advanced length and the next wave overwrites them, so
        nothing rolls back.  Inactive rows emit 0 (paged: their writes go to
        the trash page).  Enqueues device work only; updates the engine's
        last/lens in place → fn(active [B], drafts [B, S-1], ndraft [B]) →
        (out_toks [B, S], emitted, n_valid, done)."""
        wpages = -(-window // self.runtime.page_size)

        def build():
            eng, cfg = weakref.proxy(self), self.config
            window_kv = (self._k[:, :, :, :window], self._v[:, :, :, :window])
            # dp: this group's rows (as the decode body's), gathered after
            first, n_rows = self._rows or (0, self.runtime.max_batch_size)
            mine = slice(first, first + n_rows)
            gather = None if self._rows is None else self._layout.comm.dp_gather

            def verify(active, drafts, ndraft):
                last, lens = eng._last, eng._lens
                my_lens = lens[mine]
                tokens = torch.cat([last[mine][:, None], drafts[mine]], dim=1)
                if eng._paged:
                    logits, ring = M.verify_step_ring_paged(
                        eng.params, cfg, tokens, (eng._k, eng._v), eng._tables[mine], my_lens,
                        wpages,
                    )
                else:
                    logits, ring = M.verify_step_ring(eng.params, cfg, tokens, window_kv, my_lens)
                out_toks, emitted = spec_accept_slots(
                    logits, drafts[mine], ndraft[mine], my_lens, eng._slot_seeds[mine],
                    eng._temp[mine], eng._top_k[mine], eng._top_p[mine], sampled=sampled,
                )
                if gather is not None:
                    out_toks, emitted = gather(out_toks, dim=0), gather(emitted, dim=0)
                emitted = torch.where(active, emitted, 0)
                if eng._paged:
                    if gather is not None:
                        ring = (gather(ring[0], dim=2), gather(ring[1], dim=2))
                    M.consolidate_ring_paged((eng._k, eng._v), ring, eng._tables, lens, active)
                else:
                    M.consolidate_ring((eng._k, eng._v), ring, my_lens)
                idx = (emitted - 1).clamp(0, S - 1).to(torch.int64)
                new_last = torch.where(active, out_toks.gather(1, idx[:, None])[:, 0], last)
                n_valid, done = retire_mask_slots(
                    out_toks, eng._stop_dev, eng._hard_dev - lens, active, emitted=emitted
                )
                eng._lens.copy_(lens + emitted)
                eng._last.copy_(new_last)
                return out_toks, emitted, n_valid, done

            B = self.runtime.max_batch_size
            return verify, [((B,), torch.bool), ((B, S - 1), torch.int32), ((B,), torch.int32)]

        if self._paged:
            key: tuple = ("verify", wpages, S, sampled, "paged")
        else:
            key = ("verify", window, S, sampled)
        return self._cached(self._decode_graphs, key, build, kind="decode")

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
        self._observe_gap()  # just before the enqueue: drafting is prep too
        self._journal.append(flightrec.EV_DISPATCH_LAUNCH, None, -1, S, len(self._active))
        # the dispatch wall starts after drafting, as in the reference:
        # decode_time_s times the verify dispatches, not the draft model
        started = time.perf_counter()
        self._copy_retire_args()
        out_toks, emitted, n_valid, done = self._sync_host(self._stage_host(
            self._verify_graph(window, S, sampled)(active_mask, drafts, ndraft)
        ))  # [B, S] + the retirement arrays: the tick's landing sync
        elapsed = time.perf_counter() - started
        self._last_sync_t = time.perf_counter()
        # one verify forward advances the retirement clock by one step; its
        # inter-token latency divides by what each row emitted
        n_active = len(self._active)
        self._note_dispatch(
            elapsed, 1, tokens_per_row=float(emitted.sum()) / n_active if n_active else 1.0
        )
        # the verify sync IS the landing: one event carries the wave's
        # draft offer against what it emitted
        self._journal.append(
            flightrec.EV_SPEC_TICK, None, -1, int(ndraft.sum()), int(emitted.sum())
        )
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
        if self._chaos is not None:
            self._chaos("dispatch")
        if not self.runtime.overlap_dispatch:
            self._decode_tick_lockstep()
            return
        pend = self._pend
        if self._active:
            self._launch_decode()
        if pend is not None:
            self._land_pend(pend)

    def _land_pend(self, pend: dict) -> None:
        """Land the previous dispatch ``pend`` after this tick's launch (if
        any).  When nothing was launched, ``_pend`` still holds ``pend``
        through its landing and is cleared only after its deferred frees
        ran: an observer on the event loop that sees ``_pend is None`` also
        sees every slot, page and prefix reference released.  When the
        landing retired every participant of a launched dispatch, that
        dispatch is all zombies: it is drained NOW, before any consumer can
        observe completion, so slots are fully accounted."""
        deliveries = self._land_decode(pend)
        if self._pend is pend:
            self._pend = None
        elif not self._active:
            self._drain_decode()
        if deliveries:
            self._loop.call_soon_threadsafe(_deliver_batch, deliveries)

    def _drain_decode(self) -> None:
        """Land an in-flight dispatch whose participants have all retired.
        ``_pend`` is cleared only after the landing's deferred frees ran
        (see :meth:`_land_pend`)."""
        pend = self._pend
        if pend is not None:
            deliveries = self._land_decode(pend)
            self._pend = None
            if deliveries:
                self._loop.call_soon_threadsafe(_deliver_batch, deliveries)

    def _decode_args(self) -> "tuple[np.ndarray, int, int, bool]":
        """Host-side inputs of one decode dispatch (shared by the overlap
        launch, the ragged launch and the lockstep tick) → (active mask,
        window, steps, sampled).  Pure host work."""
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
        return active_mask, window, steps, sampled

    def _copy_retire_args(self) -> None:
        """Copy the per-slot stop table and hard-bound lens into the device
        buffers the decode and verify graphs read, only after an activation
        rewrote them (stream order: a dispatch already enqueued reads the
        previous values)."""
        if self._retire_dirty:
            self._retire_dirty = False
            self._fill("_stop_dev", self._stop_np)
            self._fill("_hard_dev", self._hard_end)

    def _observe_gap(self) -> None:
        """Just before a decode, ragged or verify enqueue: the dispatch is
        flagged for the dispatch-gap histogram, which observes the device's
        idle before it (previous dispatch's end to its start, on the
        device's clock) once a landing sync has passed it.  Flagged while a
        dispatch is in flight or since a landing that left rows active; not
        across idle periods."""
        if self._pend is not None or self._last_sync_t is not None:
            self._timeline.flag_next()

    def _dispatch(
        self, active: np.ndarray, window: int, steps: int, sampled: bool,
        done_prev: torch.Tensor,
    ) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
        """Enqueue one decode dispatch, which advances the engine's device
        state in place → (toks, n_valid, done) device handles."""
        self._copy_retire_args()
        return self._decode_graph(window, steps, sampled)(active, done_prev)

    def _launch_decode(self) -> None:
        """Enqueue the next decode dispatch — NO host sync.  The previous
        dispatch's device-side done mask rides in as ``done_prev``, so a
        row that retired in the still-in-flight block is frozen out of
        this one (its slot and pages stay held until that block lands)."""
        active, window, steps, sampled = self._decode_args()
        if steps < self.runtime.decode_steps_per_dispatch:
            self.stats.short_dispatches += 1
        # the in-flight dispatch's done mask, in ``_done`` until this one
        # replaces it
        done_prev = self._done if self._pend is not None else self._done_zero
        self._observe_gap()
        self._journal.append(flightrec.EV_DISPATCH_LAUNCH, None, -1, steps, len(self._active))
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
        self._journal.append(flightrec.EV_DISPATCH_LAND, None, -1, steps, wasted)
        self._free_deferred(pend)
        if not self._active:
            self._last_sync_t = None  # idle boundary, not a bubble
        return deliveries

    def _free_deferred(self, pend: dict) -> None:
        """Release the slots, pages and prefix references of requests that
        retired while ``pend`` was in flight, now that no in-flight dispatch
        can write through a re-allocated page or read an evicted one.  Each
        deferred entry carries its owner's corr, so the frees attribute to
        the request whose pages they are, in the journal and the ledger."""
        for slot, shared, corr in pend["deferred"]:
            if self._prefix is not None and shared:
                self._journal.append(flightrec.EV_PREFIX_REL, corr, slot, len(shared))
                self._prefix.release(shared)
                self._ledger.release(shared)
            if self._paged:
                self._journal.append(flightrec.EV_PAGE_FREE, corr, slot)
                self._page_alloc.free(slot)
                self._ledger.free(slot)
            self._free.append(slot)
            self._journal.append(flightrec.EV_SLOT_FREE, corr, slot)

    def _decode_tick_lockstep(self) -> None:
        """The lockstep reference path: launch, sync, fan out — with the
        HOST as the retirement authority (arbitrary-size stop sets).  The
        overlapped path must produce identical token streams."""
        active, window, steps, sampled = self._decode_args()
        self._observe_gap()
        self._journal.append(flightrec.EV_DISPATCH_LAUNCH, None, -1, steps, len(self._active))
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
        self._journal.append(flightrec.EV_DISPATCH_LAND, None, -1, steps, 0)
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
        self, elapsed: float, clock_steps: int,
        tokens_per_row: float | None = None, n_rows: int | None = None,
    ) -> None:
        """Per-dispatch clock, stats and telemetry, shared by the decode and
        verify ticks.  ``tokens_per_row`` is the inter-token latency's
        denominator where it differs from the clock (a verify advances the
        clock by 1 but emits each row's accepted prefix); ``n_rows`` pins
        the occupancy to the dispatch's participants (under overlap the
        landing runs after newer admissions changed ``_active``).  Every
        observation here is O(1): per dispatch, never per token."""
        with self._retire_lock:
            self._decode_clock += clock_steps
        self.stats.decode_steps += clock_steps
        self._note_progress()  # every landed dispatch is watchdog progress
        self.stats.decode_dispatches += 1
        self.stats.decode_time_s += elapsed
        rows = n_rows if n_rows is not None else len(self._active)
        occupancy = rows / self.runtime.max_batch_size
        self.stats.occupancy_sum += occupancy
        self.stats.occupancy_hist[min(3, int(occupancy * 4))] += 1
        denom = tokens_per_row if tokens_per_row else clock_steps
        if self._capacity_on:
            self._sampler.append(
                self._ledger.pages_in_use,
                self._page_alloc.free_pages if self._paged else 0,
                self._ledger.prefix_resident_pages,
                rows,
                len(self._pending),
                float(denom) * rows,
                capacity.hbm_bytes_per_token(self._hbm_constants, self._hbm_ctx, max(rows, 1)),
            )
        self._observe("decode_dispatch_ms", elapsed * 1000.0)
        self.stats.note_dispatch_ewma(elapsed * 1000.0)
        self._observe("inter_token_ms", elapsed * 1000.0 / max(1.0, denom))
        self._update_active_gauge()
        self._sync_metric_counters()

    def _update_active_gauge(self) -> None:
        """The process gauge sums across live engines; called per dispatch
        AND per retirement (an idle engine must not pin its last count).
        The running check sits inside the lock, so stop()'s pop can never
        interleave and leave a stale entry."""
        with _ACTIVE_LOCK:
            if not self._running:
                return
            _ACTIVE_BY_ENGINE[id(self)] = len(self._active)
            total = sum(_ACTIVE_BY_ENGINE.values())
        self.metrics["active_requests"].set(total)

    def _observe(self, key: str, value: float) -> None:
        """One latency observation, recorded in the process-shared
        instrument (the /metrics exposition) and this engine's own (its
        percentiles)."""
        self.metrics[key].observe(value)
        self.latency[key].observe(value)

    def _sync_metric_counters(self) -> None:
        """Fold cumulative stats into the process-registry counters as
        increments (per dispatch and at snapshot time).  Locked: the decode
        thread and the event loop both run this."""
        m, counted, stats = self.metrics, self._counted, self.stats
        with self._counted_lock:
            for key in counted:
                value = getattr(stats, key)
                if value != counted[key]:
                    m[key].inc(value - counted[key])
                    counted[key] = value

    def _retire_slot(self, request: GenRequest) -> None:
        """Reclaim a request's slot, page reservation and shared-page
        references, and drop the retire-heap's reference, BEFORE any _DONE
        reaches the consumer.  When a launched-but-not-landed dispatch still
        covers the slot, the resource frees defer to that dispatch's landing
        (an in-flight dispatch must never find its pages re-allocated under
        it, nor its shared prefix pages evicted while it still reads them);
        everything observable updates now."""
        self._drop_deadline(request)
        self._drop_lease(request)
        self._active.pop(request.slot, None)
        if self._drafter is not None and request.slot != -1:
            self._drafter.retire(request.slot)
        pend = self._pend
        if pend is not None and request.slot in pend["slot_set"]:
            # the journal records both moments: RETIRE_DEFER here, the
            # frees at the landing; the deferred entry carries the owner
            self._journal.append(
                flightrec.EV_RETIRE_DEFER, request.corr, request.slot, request.generated
            )
            pend["deferred"].append((request.slot, request.shared_pages, request.corr))
        else:
            self._journal.append(
                flightrec.EV_RETIRE, request.corr, request.slot, request.generated
            )
            if self._prefix is not None and request.shared_pages:
                # shared pages return to the CACHE (refcount), never to the
                # free list while other readers may hold them
                self._journal.append(
                    flightrec.EV_PREFIX_REL, request.corr, request.slot,
                    len(request.shared_pages),
                )
                self._prefix.release(request.shared_pages)
                self._ledger.release(request.shared_pages)
            if self._paged:
                self._journal.append(flightrec.EV_PAGE_FREE, request.corr, request.slot)
                self._page_alloc.free(request.slot)
                self._ledger.free(request.slot)
            self._free.append(request.slot)
            self._journal.append(flightrec.EV_SLOT_FREE, request.corr, request.slot)
        request.shared_pages = []
        request.slot = -1
        self._untrack_retirement(request)
        self._update_active_gauge()

    def _record_token(
        self, request: GenRequest, token: int, items: list, *, long: bool = False
    ) -> bool:
        """THE retirement authority of host-side retirement (and of the
        long lane): bump ``generated``, classify stop/exhaustion, reclaim
        the slot on retirement.  Appends deliverable tokens (and the _DONE
        sentinel) to ``items``; returns True when the request retired."""
        request.generated += 1
        hit_stop = token in request.stop_tokens
        if not hit_stop:
            items.append(token)
            self.stats.decode_tokens += 1
            if request.history is not None:  # speculation: drafter context
                request.history.append(token)
        if long:
            # the long lane holds no slot, and its room is the fresh cache,
            # which long_new_cap bounds: its retirement is recorded here
            done = hit_stop or request.generated >= request.max_new_tokens
            if done:
                self._journal.append(flightrec.EV_RETIRE, request.corr, -1, request.generated)
        else:
            # exhaustion == the retire heap's bound formula reaching zero
            done = hit_stop or self._retirement_bound(request) <= 0
            if done:
                self._retire_slot(request)
        if done:
            items.append(_DONE)
        return done
