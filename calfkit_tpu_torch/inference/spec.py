"""Speculative-decoding drafters: the proposal half of the scheme.

The port's own copy of ``calfkit_tpu.inference.spec``.  Each spec tick the
engine asks the drafter for up to ``k`` candidate tokens per active request;
one verify dispatch then scores all k+1 positions against the KV cache and
accepts a (possibly empty) prefix per row (``engine.InferenceEngine.
_spec_decode_tick``, ``sampler.spec_accept_slots``).  Drafters only
propose: a useless drafter degrades to one token per dispatch, never to a
wrong token.

- :class:`NgramDrafter`: prompt-lookup decoding.  Match the tail of the
  sequence against the prompt + generated history and propose the
  continuation of its most recent earlier occurrence.  No weights, no device
  work; agents repeat tool schemas, quoted documents and instruction
  blocks, which is where lookup hits.
- :class:`DraftModelDrafter`: a second model proposes greedily from its own
  dense KV cache on the engine's device, catching up on whatever the target
  emitted since its last call.  Rejected speculation is overwritten by the
  next catch-up, as in the target's cache.

The spec tick stays lockstep: both drafters propose from the landed token
history, so nothing correct can be launched before the previous verify
dispatch has landed.
"""

from __future__ import annotations

import logging
import weakref
from typing import Any, Protocol

import numpy as np
import torch

from calfkit_tpu_torch.inference import graphs
from calfkit_tpu_torch.inference import model as M
from calfkit_tpu_torch.inference.config import ModelConfig, RuntimeConfig, SpecConfig

logger = logging.getLogger(__name__)


class Drafter(Protocol):
    """What the engine's spec tick needs from a proposal source."""

    k: int

    def admit(self, slot: int, prompt: list[int]) -> None:
        """A request was activated into ``slot``."""

    def retire(self, slot: int) -> None:
        """``slot``'s request retired (or was cancelled)."""

    def propose(self, requests: "list[tuple[int, list[int]]]") -> "list[list[int]]":
        """Per (slot, token history) entry: up to ``k`` draft tokens for the
        positions after the history's final token.  Fewer (or none) is fine:
        the verify wave pads and masks."""


class NgramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most recent
    earlier occurrence of the sequence tail.

    Longest tails first (``ngram_max`` down to ``ngram_min``): a longer match
    carries more context.  The search runs over the int32 byte view of the
    history with ``bytearray.rfind`` and keeps only hits on a 4-byte token
    boundary; the byte view of each slot grows incrementally with its
    history instead of being rebuilt every tick."""

    def __init__(self, spec: SpecConfig):
        self.k = spec.k
        self.ngram_max = max(1, spec.ngram_max)
        self.ngram_min = max(1, min(spec.ngram_min, self.ngram_max))
        self._bufs: dict[int, bytearray] = {}  # slot -> history byte view

    def admit(self, slot: int, prompt: "list[int]") -> None:
        self._bufs[slot] = bytearray()

    def retire(self, slot: int) -> None:
        self._bufs.pop(slot, None)

    def _slot_bytes(self, slot: int, history: "list[int]") -> bytearray:
        buf = self._bufs.setdefault(slot, bytearray())
        synced = len(buf) // 4
        if synced > len(history):  # a slot reused without admit()
            buf.clear()
            synced = 0
        if synced < len(history):
            buf += np.asarray(history[synced:], np.int32).tobytes()
        return buf

    def _lookup(self, buf: bytearray, history: "list[int]") -> "list[int]":
        L = len(history)
        if L < 2:
            return []
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            tail = buf[(L - n) * 4:]
            # rightmost earlier occurrence, excluding the tail matching
            # itself; byte hits must land on token boundaries
            end = (L - 1) * 4  # candidate start strictly before L - n
            while end >= n * 4:
                hit = buf.rfind(tail, 0, end)
                if hit < 0:
                    break
                if hit % 4 == 0:
                    # the end bound forces start <= L-1: at least one
                    # continuation token exists
                    start = hit // 4 + n
                    return history[start:start + self.k]
                end = hit + len(tail) - 1
        return []

    def propose(self, requests: "list[tuple[int, list[int]]]") -> "list[list[int]]":
        return [
            self._lookup(self._slot_bytes(slot, history), history)
            for slot, history in requests
        ]


class DraftModelDrafter:
    """A second model drafting greedily from its own dense KV cache
    [L, B, K, max_seq_len, hd] on the engine's device.

    ``_dlen[slot]`` tokens of the request's history are in the draft cache.
    Each :meth:`propose` feeds the catch-up delta ``history[_dlen:]``
    (padded to a power-of-two width) through ``model.forward`` at per-row
    offsets, then rolls ``k - 1`` more greedy single-token forwards, as one
    captured dispatch a width (``_graphs``, in the engine's ``pool``).
    Draft K/V written during speculation sits past ``_dlen`` afterwards and
    the next catch-up overwrites it."""

    def __init__(
        self,
        spec: SpecConfig,
        runtime: RuntimeConfig,
        device: "torch.device | str",
        params: Any = None,
        seed: int = 17,
        *,
        pool: graphs.GraphPool,
        layout: Any = None,
    ):
        if spec.draft is None:
            raise ValueError("DraftModelDrafter needs SpecConfig.draft")
        self.k = spec.k
        self.config: ModelConfig = spec.draft
        self.device = torch.device(device)
        self._runtime = runtime
        if params is None:
            # correctness never depends on the draft, but random draft
            # weights mean ~0 acceptance while every draft forward is paid
            logger.warning(
                "draft model %s initialized with RANDOM weights; pass "
                "draft_params to the engine for a real drafter and expect "
                "~zero acceptance until then",
                self.config.name,
            )
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
            params = M.init_params(self.config, generator)
        # tensors already on the device are wrapped, not copied: a draft
        # that shares the target's weights costs no second copy of them
        # on a rank of a multi-rank engine: this rank's shard of the draft
        # model (``layout``), whose proposer runs the model's collectives
        self.params = M.Decoder(params, self.device, layout).params()
        B, S = runtime.max_batch_size, runtime.max_seq_len
        self._kc, self._vc = M.make_empty_cache(
            self.config, B, S, device=self.device, kv_heads=M.kv_heads(self.params, self.config)
        )
        self._dlen = np.zeros((B,), np.int64)
        self._pool = pool
        self._graphs: dict[int, graphs.CapturedDispatch] = {}  # catch-up width ->

    def admit(self, slot: int, prompt: "list[int]") -> None:
        # lazy: the first propose's catch-up covers the whole prompt
        self._dlen[slot] = 0

    def retire(self, slot: int) -> None:
        self._dlen[slot] = 0

    def _propose_graph(self, width: int) -> graphs.CapturedDispatch:
        """The proposer of one catch-up width, captured at its first call
        (the JAX package's ``_propose_jit(width)``): fn(catchup [B, width],
        base [B], cat_len [B], fed_nothing [B]) forwards the catch-up chunk
        at per-row offsets ``base`` (``cat_len`` valid tokens a row), then
        rolls ``k - 1`` greedy single-token steps → drafts [B, k] on the
        device.  The draft cache is written in place at its fixed address,
        which stands in for the reference's donation of it.

        A request's row fed nothing this round (``fed_nothing``; its
        ``cat_len`` and ``base`` are 0) still writes its padded catch-up at
        position 0, as the JAX drafter's does, and keeps those K/V for
        later rounds; its queries see no key, and the JAX drafter's XLA
        attention gives them the mean of v, which ``M.forward``'s
        ``keyless_mean`` reproduces.  A slot with no request is written
        alike, but is re-fed from position 0 when a request arrives, so
        its queries keep the kernel's cheaper answer."""
        fn = self._graphs.get(width)
        if fn is not None:
            return fn
        # the graph must not hold the drafter (nor, through it, the engine)
        drafter, cfg, dev, k_steps = weakref.proxy(self), self.config, self.device, self.k

        def propose(catchup, base, cat_len, fed_nothing):
            pos = base[:, None] + torch.arange(width, dtype=torch.int32, device=dev)[None, :]
            seq_lens = base + cat_len
            cache = (drafter._kc, drafter._vc)
            # logits at each row's last catch-up token only: the LM head
            # over the whole [B, width] chunk would hold B x width x vocab
            # values in the graph pool for nothing
            idx = (cat_len.to(torch.int64) - 1).clamp(0, width - 1)
            logits, _ = M.forward(drafter.params, cfg, catchup, pos, cache, seq_lens,
                                  insert_at=base, logits_at=idx, keyless_mean=fed_nothing)
            cur = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            outs = [cur]
            lens = seq_lens
            for _ in range(k_steps - 1):
                logits, _ = M.forward(drafter.params, cfg, cur[:, None], lens[:, None], cache,
                                      lens + 1)
                cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                outs.append(cur)
                lens = lens + 1
            return torch.stack(outs, dim=1)

        B = self._runtime.max_batch_size
        specs = [((B, width), torch.int32), ((B,), torch.int32), ((B,), torch.int32),
                 ((B,), torch.bool)]
        fn = self._graphs[width] = graphs.CapturedDispatch(self._pool, propose, specs,
                                                          kind="decode")
        fn.recipe = ("drafter", "_propose_graph", (width,))
        return fn

    def propose(self, requests: "list[tuple[int, list[int]]]") -> "list[list[int]]":
        if not requests:
            return []
        B = self._runtime.max_batch_size
        S = self._runtime.max_seq_len
        deltas = [len(history) - int(self._dlen[slot]) for slot, history in requests]
        width = 1
        while width < max(max(deltas), 1):
            width *= 2
        # the catch-up bucket never exceeds the draft cache; a row whose
        # delta still exceeds the clamped width feeds only its tail
        width = min(width, S)
        catchup = np.zeros((B, width), np.int32)
        base = np.zeros((B,), np.int32)
        cat_len = np.zeros((B,), np.int32)
        fed_nothing = np.zeros((B,), np.bool_)
        live: list[tuple[int, int]] = []  # (slot, room) rows actually fed
        for (slot, history), delta in zip(requests, deltas):
            if delta <= 0:  # history never shrinks mid-request
                fed_nothing[slot] = True
                continue
            d = int(self._dlen[slot])
            if delta > width:
                d = len(history) - width
                delta = width
            elif d + width > S:
                # the batch-wide width would overhang this row's cache end,
                # where a clamped write would slide back over valid early
                # positions: re-feed from S - width instead (positions
                # [d, dlen) rewrite identically, nothing clamps)
                d = max(0, S - width)
                delta = len(history) - d
            catchup[slot, :delta] = history[d:]
            base[slot] = d
            cat_len[slot] = delta
            self._dlen[slot] = len(history)
            # cap proposals by the room left in the draft cache
            live.append((slot, S - len(history) - 1))
        # the spec tick's second host sync (the first lands the previous
        # verify): the drafts must reach the host to form the verify wave
        drafts = self._propose_graph(width)(catchup, base, cat_len, fed_nothing).cpu().numpy()
        if self._pool.timeline is not None:
            self._pool.timeline.drained()  # that sync left nothing queued
        by_slot = {
            slot: [int(t) for t in drafts[slot, : max(0, min(self.k, room))]]
            for slot, room in live
        }
        return [by_slot.get(slot, []) for slot, _ in requests]


def build_drafter(
    spec: SpecConfig,
    runtime: RuntimeConfig,
    device: "torch.device | str",
    draft_params: Any = None,
    seed: int = 17,
    *,
    pool: graphs.GraphPool,
    layout: Any = None,
) -> Drafter:
    """The drafter ``spec`` asks for; a draft model's proposer is captured
    into ``pool`` (the engine's, so its captures and replays count in the
    engine's graph stats)."""
    if spec.draft is not None:
        return DraftModelDrafter(spec, runtime, device, params=draft_params, seed=seed,
                                 pool=pool, layout=layout)
    return NgramDrafter(spec)
