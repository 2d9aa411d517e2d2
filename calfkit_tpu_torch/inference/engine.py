"""The continuous-batching inference engine on PyTorch: the dense path.

The counterpart of ``calfkit_tpu.inference.engine.InferenceEngine`` for the
default configuration: dense KV layout, single-shot prefill waves, and
overlapped (or lockstep) multi-step decode dispatches, without speculation.

- a fixed pool of ``max_batch_size`` slots backed by ONE device-resident KV
  cache [L, B, K, S, hd]; admission = a batched prefill wave that lands in
  free slots' rows;
- decode runs for all active slots together: one dispatch generates
  ``decode_steps_per_dispatch`` tokens per slot; the host syncs once per
  dispatch through :meth:`InferenceEngine._sync_host`, nowhere else on the
  launch path;
- overlapped dispatch (the default) enqueues dispatch N+1 before it waits
  for dispatch N, with stop and bound detection on the device, so the
  device never idles while the host fans tokens out.  The one stream of
  the device orders every dispatch after the one before it; the host waits
  on a CUDA event recorded after dispatch N's outputs were copied to pinned
  host memory, so waiting for N never waits for N+1.

Parts of the reference engine not ported yet raise instead of pretending:
``ValueError`` at construction for their configuration, ``InferenceError``
at submit for per-request deadlines, leases and priorities.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

import numpy as np
import torch

from calfkit_tpu_torch.exceptions import InferenceError
from calfkit_tpu_torch.inference import model as M
from calfkit_tpu_torch.inference.config import ModelConfig, RuntimeConfig
from calfkit_tpu_torch.inference.sampler import (
    SamplingParams,
    fold_in,
    retire_mask_slots,
    sample_slots,
)

logger = logging.getLogger(__name__)

_DONE = object()


def _deliver_batch(deliveries: "list[tuple[asyncio.Queue, list]]") -> None:
    """Event-loop side of the batched cross-thread token fan-out: each
    request's whole dispatch-worth of tokens lands as ONE queue item."""
    for queue, items in deliveries:
        queue.put_nowait(items)


def _finalize_wave_math(
    sampled: bool,
    k: torch.Tensor, v: torch.Tensor,  # [L, B, K, S, hd] engine cache (in place)
    sk: torch.Tensor, sv: torch.Tensor,  # [L, R, K, P, hd] wave scratch
    last: torch.Tensor, lens: torch.Tensor,  # [B] engine state (in place)
    slots: torch.Tensor, true_lens: torch.Tensor,  # [R]
    last_logits: torch.Tensor,  # [R, V]
    slot_seeds: torch.Tensor, temp: torch.Tensor,  # [B] engine state (in place)
    top_k: torch.Tensor, top_p: torch.Tensor,
    seeds: torch.Tensor, w_temp: torch.Tensor,  # [R] wave values
    w_top_k: torch.Tensor, w_top_p: torch.Tensor,
) -> torch.Tensor:
    """The wave landing on the device: copy the scratch K/V into the wave's
    cache rows, install per-slot sampling state, sample each row's first
    token from its last-position logits and scatter the wave's last/lens
    rows.  Updates the engine tensors in place → firsts [R] int32."""
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
    slot: int = -1
    generated: int = 0
    cancelled: bool = False
    corr: "str | None" = None  # the request's correlation id
    # the live _retire_heap entry ([bound, seq, request]); cleared at
    # retirement so the heap stops pinning this request's memory
    heap_entry: Any = None


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

    @property
    def tokens_per_second(self) -> float:
        return self.decode_tokens / self.decode_time_s if self.decode_time_s else 0.0

    @property
    def mean_occupancy(self) -> float:
        if not self.decode_dispatches:
            return 0.0
        return self.occupancy_sum / self.decode_dispatches


def _check_runtime(rt: RuntimeConfig) -> None:
    """Refuse what this engine does not serve yet, naming the later part of
    the port that will."""
    later = {
        "kv_layout='paged'": (rt.kv_layout == "paged", "paged KV"),
        "chunked_prefill": (rt.chunked_prefill, "chunked/ragged lane"),
        "speculative": (rt.speculative is not None, "speculative decoding"),
        "long_context": (rt.long_context, "multi-device"),
        "quantization": (rt.quantization is not None, "quantization/loader"),
        "tp/dp > 1": (rt.tp > 1 or rt.dp > 1, "multi-device"),
        "prefix_cache": (rt.prefix_cache, "paged KV"),
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
    if rt.kv_layout != "dense":
        raise ValueError(f"unsupported kv_layout {rt.kv_layout!r} (dense)")
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
    ):
        self.config = config
        self.runtime = runtime or RuntimeConfig()
        self.sampling = sampling or SamplingParams()
        rt = self.runtime
        _check_runtime(rt)
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
        # requests whose admission prefill is running in the worker thread
        self._admitting: list[GenRequest] = []
        self._carry: list[GenRequest] = []  # wave-trimmed, ahead of the queue
        self._pending: deque[GenRequest] = deque()
        self._wake = asyncio.Event()
        self._task: asyncio.Task[None] | None = None
        self._running = False
        self.stats = EngineStats()

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
            # still run or the slots leak into the next start()
            self._free_deferred(self._pend)
            self._pend = None
        for request in list(self._active.values()):
            request.out.put_nowait(_DONE)
        self._active.clear()
        for request in self._carry:
            request.out.put_nowait(_DONE)
        self._carry.clear()
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
            self.runtime.overlap_dispatch
            and len(stop_tokens) > self.runtime.max_stop_tokens
        ):
            # device-side retirement scans a fixed-shape per-slot stop table;
            # silently truncating the set would MISS stops
            raise InferenceError(
                f"request has {len(stop_tokens)} stop tokens but device-side"
                f" retirement caps the per-slot table at max_stop_tokens="
                f"{self.runtime.max_stop_tokens}; raise "
                "RuntimeConfig.max_stop_tokens (or set overlap_dispatch=False "
                "for the host-side lockstep path)"
            )
        request = GenRequest(
            prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            stop_tokens=stop_tokens,
            sampling=sampling,
            seed=seed,
            corr=corr,
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
                progressed = await self._admit()
                if self._active:
                    await asyncio.to_thread(self._decode_tick)
                elif self._pend is not None:
                    # every participant retired/cancelled while a dispatch
                    # was in flight: land it so the deferred frees happen
                    await asyncio.to_thread(self._drain_decode)
                elif not progressed:
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
        flag).  O(1) unless some flag was set since the last reap."""
        if not self._cancel_dirty:
            return
        self._cancel_dirty = False
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

    def _form_wave(self) -> "tuple[list[GenRequest], int] | None":
        """Scheduling only (no device work): pop a same-bucket wave and
        assign slots.  None when nothing can be admitted right now."""
        first = self._next_pending() if self._free else None
        if first is None:
            return None
        wave = [first]
        wave_bucket = self._bucket_of(len(first.prompt))
        while (
            len(wave) < len(self._free)
            and len(wave) < self.runtime.max_prefill_wave
            and (peeked := self._peek_pending()) is not None
            and self._bucket_of(len(peeked.prompt)) == wave_bucket
        ):
            wave.append(self._next_pending())
        # power-of-two waves; trimmed requests go to the FRONT carry list,
        # preserving arrival order
        keep = 1
        while keep * 2 <= len(wave):
            keep *= 2
        self._carry = wave[keep:] + self._carry
        wave = wave[:keep]
        for request in wave:
            request.slot = self._free.pop()
        return wave, wave_bucket

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
        """Host-side array prep of a prefill wave."""
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

    def _prefill(self, arrays: dict) -> torch.Tensor:
        """Batched prefill: R admissions run as one [R, bucket] forward on a
        scratch cache, then land in the slot rows → firsts [R] (device)."""
        cfg = self.config
        dev = self.device
        d = {name: self._to_device(arrays[name]) for name in (
            "tokens", "slots", "true_lens", "seeds", "w_temp", "w_top_k", "w_top_p",
        )}
        R, P = arrays["tokens"].shape
        sk, sv = M.make_empty_cache(cfg, R, P, dtype=self._k.dtype, device=dev)
        pos = torch.arange(P, dtype=torch.int32, device=dev).expand(R, P)
        logits, (sk, sv) = M.forward(
            self.params, cfg, d["tokens"], pos, (sk, sv),
            torch.full((R,), P, dtype=torch.int32, device=dev),
        )
        idx = (d["true_lens"].to(torch.int64) - 1).clamp(0, P - 1)
        last_logits = logits[torch.arange(R, device=dev), idx]
        return _finalize_wave_math(
            arrays["sampled"], self._k, self._v, sk, sv, self._last, self._lens,
            d["slots"], d["true_lens"], last_logits,
            self._slot_seeds, self._temp, self._top_k, self._top_p,
            d["seeds"], d["w_temp"], d["w_top_k"], d["w_top_p"],
        )

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
        firsts = self._prefill(arrays)
        # sync BEFORE timing: the device may still be running the wave
        (firsts,) = self._sync_host(self._stage_host((firsts,)))
        self._land_wave(wave, arrays["true_lens"], firsts, time.perf_counter() - started)

    def _window_bucket(self, needed: int) -> int:
        """Smallest configured window ≥ needed (cap max_seq): the decode
        attention scan only reads this prefix of the cache."""
        cap = self.runtime.max_seq_len
        for w in self.runtime.window_buckets:
            if needed <= w <= cap:
                return w
        return cap

    def _decode_fn_dense(
        self, window: int, steps: int, sampled: bool,
        active: torch.Tensor, done_prev: torch.Tensor,
        stop_table: torch.Tensor, hard_end: torch.Tensor,
    ) -> "tuple[torch.Tensor, ...]":
        """The dense decode dispatch body: ``steps`` ring-buffer decode
        steps over the read-only cache window, argmax or ``sample_slots``
        per step, then ``consolidate_ring`` (in place) and
        ``retire_mask_slots``.  Enqueues device work only — no host sync.
        → (last, new_lens, toks [steps, B], n_valid, done)."""
        cfg = self.config
        dev = self.device
        # ``done_prev`` is the PREVIOUS dispatch's device-side done mask:
        # under overlap a row that retired there is frozen here by pure
        # device dataflow, before the host has seen that block
        active = active & torch.logical_not(done_prev)
        last, lens = self._last, self._lens
        B = last.shape[0]
        kw = self._k[:, :, :, :window]
        vw = self._v[:, :, :, :window]
        ring_shape = (cfg.n_layers, steps, B, cfg.n_kv_heads, cfg.head_dim)
        ring = (
            torch.zeros(ring_shape, dtype=self._k.dtype, device=dev),
            torch.zeros(ring_shape, dtype=self._v.dtype, device=dev),
        )
        toks = []
        for t in range(steps):
            logits, ring = M.decode_step_ring(
                self.params, cfg, last[:, None], (kw, vw), ring, t, lens
            )
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
        M.consolidate_ring((self._k, self._v), ring, lens)
        new_lens = torch.where(active, lens + steps, lens)
        n_valid, done = retire_mask_slots(block.T, stop_table, hard_end - lens, active)
        return last, new_lens, block, n_valid, done

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
        launch and the lockstep tick) → (active mask, window, steps,
        sampled).  Pure host work and an asynchronous upload."""
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
        last, lens, toks, n_valid, done = self._decode_fn_dense(
            window, steps, sampled, active, done_prev, stop_table, hard_end
        )
        self._last, self._lens = last, lens
        return toks, n_valid, done

    def _launch_decode(self) -> None:
        """Enqueue the next decode dispatch — NO host sync.  The previous
        dispatch's device-side done mask rides in as ``done_prev``, so a
        row that retired in the still-in-flight block is frozen out of
        this one (its slot stays held until that block lands)."""
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
        steps: int, started: float,
    ) -> None:
        """Record a just-enqueued dispatch as the in-flight pend: host lens
        advance, the staged host copies of its outputs, and the snapshot its
        landing fans out against."""
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
        )

    def _land_decode(self, pend: dict) -> "list[tuple[asyncio.Queue, list]]":
        """Host side of a landed dispatch: ONE sync for the token block plus
        the device-computed retirement arrays, then batched fan-out.  Rows
        whose requests retired or cancelled while this dispatch was in
        flight are pad columns: discarded and counted, with their deferred
        slot frees released now.  Returns the deliveries — the CALLER posts
        them, after draining an all-zombie follow-up."""
        block, n_valid, done = self._sync_host(pend["staged"])
        now = time.perf_counter()
        # exclusive wall: clip to the span this dispatch alone occupied
        start = pend["started"]
        if self._last_sync_t is not None and self._last_sync_t > start:
            start = self._last_sync_t
        self._last_sync_t = now
        steps = pend["steps"]
        self._note_dispatch(now - start, steps, n_rows=len(pend["participants"]))
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
        """Release the slots of requests that retired while ``pend`` was in
        flight, now that no in-flight dispatch can write through them."""
        for slot in pend["deferred"]:
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
        """Reclaim a request's slot and drop the retire-heap's reference,
        BEFORE any _DONE reaches the consumer.  When a launched-but-not-
        landed dispatch still covers the slot, the free-list return defers
        to that dispatch's landing; everything observable updates now."""
        self._active.pop(request.slot, None)
        pend = self._pend
        if pend is not None and request.slot in pend["slot_set"]:
            pend["deferred"].append(request.slot)
        else:
            self._free.append(request.slot)
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
        # exhaustion == the retire heap's bound formula reaching zero
        done = hit_stop or self._retirement_bound(request) <= 0
        if done:
            self._retire_slot(request)
            items.append(_DONE)
        return done
