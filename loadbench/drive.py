"""Driving the engine: the request records, the traffic's context, and the
preparation of the dispatch shapes the window will use.

A :class:`Record` is one request as the client saw it: when it was due,
when it was submitted, its prompt, the tokens that came back and when each
came.  :class:`Context` is what a traffic generator submits through.
"""

from __future__ import annotations

import asyncio
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Record:
    tag: str
    due: float
    submit: float
    prompt: list
    max_new: int
    tokens: list = field(default_factory=list)
    times: list = field(default_factory=list)
    error: "str | None" = None

    @property
    def complete(self) -> bool:
        return self.error is None and len(self.tokens) == self.max_new


class Context:
    """The clock, the stop time and the submit call of one run's traffic."""

    def __init__(self, engine, start_at: float, stop_at: float):
        self.engine = engine
        self.start_at = start_at
        self.stop_at = stop_at
        self.records: list[Record] = []

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    async def sleep_until(self, t: float) -> None:
        delay = t - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)

    async def submit(self, prompt: list, max_new: int, due: float, tag: str) -> Record:
        """Submit one greedy request with no stop tokens and collect its
        tokens with their arrival times."""
        record = Record(tag, due, time.perf_counter(), list(prompt), max_new)
        self.records.append(record)
        try:
            async for token in self.engine.generate(record.prompt, max_new_tokens=max_new):
                record.tokens.append(token)
                record.times.append(time.perf_counter())
        except Exception as exc:  # noqa: BLE001 -- a failed request is counted, not fatal
            record.error = f"{type(exc).__name__}: {exc}"
        return record


RESERVE_BYTES = 12 << 30  # card memory kept free for shapes captured while serving


def _bucket(n: int, chunk: int, cap: int) -> int:
    return min(-(-n // chunk) * chunk, cap)


def _windows(runtime, lo: int, hi: int) -> list[int]:
    """The decode windows (in tokens) that the longest active request can
    call for between ``lo`` and ``hi`` tokens: the engine's window buckets,
    capped at the sequence limit."""
    cap = runtime.max_seq_len
    edges = sorted({w for w in runtime.window_buckets if w <= cap} | {cap})

    def window(n: int) -> int:
        return next((w for w in edges if n <= w), cap)

    return [w for w in edges if window(lo) <= w <= window(hi)]


def prepare_shapes(engine, gen, plan, log=sys.stderr) -> dict:
    """Capture, before any request, every dispatch the window can call for,
    from the ranges the traffic's plan states: each decode dispatch (at
    every window the longest active request can need, full and shortened),
    each prefill chunk riding it or running alone, and each wave landing
    and prefix seed (each prompt bucket, each wave width; seeds of one and
    two rows), the likeliest first, while the card keeps ``RESERVE_BYTES``
    free.  Each is called once on an idle engine with every row
    inactive and every page write aimed at the trash page, which changes
    no request's state.  These are the engine's own graph builders, called
    by their names and positional arguments: a builder that is missing or
    whose arguments no longer fit raises, and the run fails with its
    traceback rather than leave its shapes to be captured inside the
    window → {kind: count}."""
    import torch

    rt = engine.runtime
    B, chunk, page = rt.max_batch_size, rt.prefill_chunk, rt.page_size
    full = rt.decode_steps_per_dispatch
    steps = sorted({full, min(full, max(4, full // 4))})
    rows = [1 << i for i in range(int(math.log2(min(rt.max_prefill_wave, B))) + 1)]
    lo, hi = gen.context_range(plan)
    p_lo, p_hi = gen.prompt_range(plan)
    buckets = list(range(_bucket(p_lo, chunk, rt.max_seq_len), _bucket(p_hi, chunk, rt.max_seq_len) + 1, chunk))
    off = np.zeros((B,), bool)
    vocab = engine.config.vocab_size
    done: dict = {}

    def chunk_args(r: int) -> tuple:
        return (np.zeros((r, chunk), np.int32), np.zeros((1,), np.int32), np.zeros((r,), np.int64))

    def wave_args(r: int, bucket: int) -> tuple:
        return (
            np.arange(r, dtype=np.int64), np.full((r,), bucket, np.int32), np.zeros((r,), np.int64),
            np.zeros((r,), np.float32), np.zeros((r,), np.int32), np.ones((r,), np.float32),
            np.zeros((r, rt.pages_per_seq()), np.int32), np.zeros((r, bucket // page), np.int64),
        )

    def call(kind: str, fn, *args) -> None:
        fn(*args)
        done[kind] = done.get(kind, 0) + 1

    started = time.perf_counter()
    cuda = engine.device.type == "cuda"

    def available() -> int:
        """Free card memory once the allocator has handed back what it
        caches (a graph's own memory stays with the graph)."""
        torch.cuda.empty_cache()
        return torch.cuda.mem_get_info(engine.device)[0]

    def memory() -> str:
        return f"{available() / 2**30:.2f} GiB free" if cuda else "-"

    def kind_of(calls, kind: str) -> None:
        """Every call of one kind, while the card keeps ``RESERVE_BYTES``
        free; the rest of a kind the card cannot hold is left to the
        warm-up traffic."""
        for fn, args in calls:
            if cuda and available() < RESERVE_BYTES:
                print(f"loadbench: the rest of the {kind} shapes left to the warm-up traffic", file=log)
                break
            call(kind, fn, *args)
        print(f"loadbench: prepared {done.get(kind, 0)} {kind} ({memory()})", file=log)

    def decode_calls():
        for w in _windows(rt, lo, hi):
            for s in steps:
                yield engine._decode_graph(w, s, False), (off, off)
                for r in rows:
                    yield engine._ragged_graph(w, s, False, chunk, r), (*chunk_args(r), off, off)

    def final_calls(widths):
        for bucket in buckets:
            for r in widths:
                last = torch.zeros((r, vocab), dtype=engine.params["embed"].dtype, device=engine.device)
                yield engine._final_graph(bucket, r, False), (last, *wave_args(r, bucket))

    def seed_calls(widths):
        align = page * chunk // math.gcd(page, chunk)
        for bucket in buckets:
            for reuse in range(align, bucket - chunk + 1, align):
                for r in widths:
                    ids = np.zeros((r, reuse // page), np.int64)
                    yield engine._seed_graph(bucket, reuse // page, r), (ids,)

    kind_of(decode_calls(), "decode")
    kind_of(((engine._chunk_graph(chunk, r), chunk_args(r)) for r in rows), "chunk")
    # the likeliest first: waves of one row, then wider ones
    if rt.prefix_cache:
        kind_of(seed_calls(rows[:1]), "seed")
    kind_of(final_calls(rows[:2]), "final")
    if rt.prefix_cache:
        kind_of(seed_calls(rows[1:2]), "seed")
    kind_of(final_calls(rows[2:]), "final")
    if cuda:
        torch.cuda.synchronize(engine.device)
    print(
        f"loadbench: prepared {done} in {time.perf_counter() - started:.1f} s "
        f"(context {lo}..{hi}, prompt buckets {buckets[0] if buckets else '-'}.."
        f"{buckets[-1] if buckets else '-'})", file=log,
    )
    return done


def graph_captures(engine) -> "int | None":
    """The engine's CUDA graph captures so far (None where it keeps no such count)."""
    graphs = getattr(engine, "_graphs", None)
    stats = getattr(graphs, "stats", None)
    return stats.get("captures") if isinstance(stats, dict) else None
