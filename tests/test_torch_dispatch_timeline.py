"""The port engine's dispatch timeline (``inference/timeline.py``): each
dispatch's device time by kind, the device's idle between dispatches put
down to the host phase it overlapped, the per-request queue wait and
prefill span, and the benchmark's readers of those counters.

The timeline's marks sit behind a clock seam: the unit tests script both
the device's marks and the host's clock, so each gap's place on the host's
timeline is known exactly; the engine tests run the port's engine on the
CPU, where a dispatch's interval is the host wall of its call, or with a
scripted device clock installed in the engine.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

from calfkit_tpu_torch.inference import TorchLocalModelClient
from calfkit_tpu_torch.inference.config import RuntimeConfig, preset
from calfkit_tpu_torch.inference.engine import EngineStats, InferenceEngine
from calfkit_tpu_torch.inference.timeline import PHASES, DispatchTimeline
from calfkit_tpu_torch.models import user_message
from calfkit_tpu_torch.observability import flightrec
from calfkit_tpu_torch.observability import trace as port_trace
from loadbench.harness import per_layer
from loadbench.readings import Readings
from tests._torch_port import PORT_ONLY_COUNTERS

torch.set_num_threads(1)

CFG = preset("debug")
BASE = dict(
    max_batch_size=4, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4,
    kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True,
    flightrec_events=1 << 12,
)
CONFIGS = {
    "ragged": {},
    "bifurcated": dict(ragged_waves=False),
    "lockstep": dict(overlap_dispatch=False),
    "dense-single-shot": dict(kv_layout="dense", prefix_cache=False, chunked_prefill=False),
}
PREFIX = [(11 * i + 5) % 512 for i in range(32)]
PROMPTS = [PREFIX + [(7 * i + j) % 512 for i in range(4 + 3 * j)] for j in range(5)] + [
    [(13 * i + 2) % 512 for i in range(20)],
]


# ----------------------------------------------------------- scripted clocks
class Script:
    """A scripted device clock and host clock: a mark is the device time the
    test set when it was recorded; the host clock reads ``host``."""

    def __init__(self):
        self.host = 0.0
        self.device = 0.0

    def now(self) -> float:
        return self.host

    def record(self) -> float:
        return self.device

    def seconds(self, a: float, b: float) -> float:
        return b - a

    def release(self, mark: float) -> None:
        pass


def _timeline():
    script, stats = Script(), EngineStats()
    return script, stats, DispatchTimeline(script, stats, now=script.now)


def _dispatch(script, timeline, host, start, end, kind="decode") -> int:
    """One dispatch begun at host time ``host``, on the device from
    ``start`` to ``end`` → its number."""
    script.host, script.device = host, start
    rec = timeline.begin()
    timeline.phase("launch")
    script.device = end
    timeline.end(rec, kind)
    return rec[0]


def _phase(script, timeline, host, name):
    script.host = host
    timeline.phase(name)


def _sync(script, timeline, host, upto) -> list:
    """A landing's sync, as the engine's ``_sync_host`` makes it."""
    _phase(script, timeline, host, "land")
    return timeline.sync(upto)


def test_scripted_gap_lands_in_the_phases_its_host_interval_overlaps():
    """A gap e_1 → s_2 of 4 s, ending at dispatch 2's start on the host's
    clock, overlaps 1 s of landing, 2 s of the event loop and 1 s of the
    scheduler's pass: each phase gets its overlap; the dispatches' device
    times go to their kinds."""
    script, stats, tl = _timeline()
    _phase(script, tl, 0.0, "schedule")
    n1 = _dispatch(script, tl, 0.5, 0.5, 10.0, kind="prefill")
    _sync(script, tl, 10.0, n1)  # "land" from 10
    _phase(script, tl, 11.0, "loop")
    _phase(script, tl, 13.0, "schedule")
    n2 = _dispatch(script, tl, 14.0, 14.0, 20.0, kind="mixed")
    _sync(script, tl, 20.0, n2)
    assert stats.device_prefill_s == pytest.approx(9.5)
    assert stats.device_mixed_s == pytest.approx(6.0)
    assert stats.device_gap_s == pytest.approx(4.0)
    assert (stats.gap_land_s, stats.gap_loop_s, stats.gap_schedule_s) == pytest.approx(
        (1.0, 2.0, 1.0)
    )
    assert stats.gap_prep_s == stats.gap_launch_s == 0.0


def test_scripted_phases_sum_to_the_device_gap():
    """Over many dispatches with gaps that straddle every phase boundary,
    the five phase counters sum to ``device_gap_s`` to 1e-9 s."""
    script, stats, tl = _timeline()
    host = device = 0.0
    for i in range(200):
        for name in PHASES:
            host += 0.001 * (1 + (i * 7 + len(name)) % 5)
            _phase(script, tl, host, name)
        start = max(device, host - 0.0007 * (i % 4))
        device = start + 0.003
        n = _dispatch(script, tl, host, start, device, kind=("decode", "mixed", "prefill")[i % 3])
        if i % 2:
            _sync(script, tl, host, n)
    _sync(script, tl, host + 1.0, tl.mark())
    assert stats.device_gap_s > 0.01
    assert sum(getattr(stats, f"gap_{p}_s") for p in PHASES) == pytest.approx(
        stats.device_gap_s, abs=1e-9
    )
    assert stats.device_decode_s + stats.device_mixed_s + stats.device_prefill_s == pytest.approx(
        0.6
    )


def test_scripted_drained_gap_counts_only_after_a_sync_that_left_nothing_queued():
    """A sync that passed the newest dispatch drained the device: the gap
    before the next dispatch is drained.  A sync with a dispatch queued
    behind it (overlap) leaves the next gap undrained."""
    script, stats, tl = _timeline()
    n1 = _dispatch(script, tl, 0.0, 0.0, 1.0)
    _sync(script, tl, 1.0, n1)  # nothing queued behind dispatch 1
    n2 = _dispatch(script, tl, 1.5, 1.5, 2.5)  # gap 0.5, drained
    n3 = _dispatch(script, tl, 2.0, 2.5, 3.5)  # queued behind 2: no gap
    _sync(script, tl, 2.5, n2)  # dispatch 3 still queued: not drained
    n4 = _dispatch(script, tl, 3.75, 3.75, 4.0)  # gap 0.25 after 3, undrained
    _sync(script, tl, 4.0, n4)
    assert n3 < n4
    assert stats.device_gap_s == pytest.approx(0.75)
    assert stats.gap_drained_s == pytest.approx(0.5)


def test_scripted_gap_across_an_idle_boundary_is_not_counted():
    """The engine held no work between two dispatches: the device's idle
    there is no gap, in any counter; a flagged dispatch still reports its
    device gap (the histogram's observation)."""
    script, stats, tl = _timeline()
    n1 = _dispatch(script, tl, 0.0, 0.0, 1.0)
    _sync(script, tl, 1.0, n1)
    tl.idle()
    tl.flag_next()
    n2 = _dispatch(script, tl, 9.0, 9.0, 10.0)
    assert _sync(script, tl, 10.0, n2) == [pytest.approx(8.0)]
    assert stats.device_gap_s == stats.gap_drained_s == 0.0
    assert sum(getattr(stats, f"gap_{p}_s") for p in PHASES) == 0.0
    n3 = _dispatch(script, tl, 10.5, 10.5, 11.0)  # held work again: counted
    _sync(script, tl, 11.0, n3)
    assert stats.device_gap_s == pytest.approx(0.5)


def test_scripted_marks_are_read_only_once_a_sync_has_passed_them():
    """Dispatches enqueued after the synced event stay unread until a later
    sync passes them."""
    script, stats, tl = _timeline()
    n1 = _dispatch(script, tl, 0.0, 0.0, 1.0)
    mark = tl.mark()
    _dispatch(script, tl, 0.5, 1.0, 2.0)
    _sync(script, tl, 1.0, mark)
    assert stats.device_decode_s == pytest.approx(1.0) and n1 == mark
    _sync(script, tl, 2.0, tl.mark())
    assert stats.device_decode_s == pytest.approx(2.0)


# ------------------------------------------------------------ the engine
async def _serve(engine, prompts=PROMPTS, n=10):
    await engine.start()
    try:
        out = []
        for burst in (prompts[:3], prompts[3:]):
            out += await asyncio.gather(*[
                _collect(engine, p, n, corr=f"r{i}-{len(out)}") for i, p in enumerate(burst)
            ])
        return out
    finally:
        await engine.stop()


async def _collect(engine, prompt, n, **kw):
    return [t async for t in engine.generate(prompt, max_new_tokens=n, **kw)]


def _engine(**over) -> InferenceEngine:
    return InferenceEngine(CFG, RuntimeConfig(**{**BASE, **over}), device="cpu")


class DeviceScript:
    """A scripted device clock for an engine: every dispatch takes exactly
    1 ms on the device and starts 0.5 ms after the previous one ended."""

    def __init__(self):
        self.marks = 0

    def record(self) -> float:
        i, self.marks = self.marks, self.marks + 1
        return 1.5e-3 * (i // 2) + (1e-3 if i % 2 else 0.0)

    def seconds(self, a: float, b: float) -> float:
        return b - a

    def release(self, mark: float) -> None:
        pass


@pytest.mark.parametrize("name", list(CONFIGS))
async def test_engine_phases_sum_to_device_gap(name):
    """Served on the CPU (each dispatch's interval the host wall of its
    call), the engine's five phase counters sum to ``device_gap_s``, and
    device time by kind plus the gaps fit inside the serving's wall."""
    engine = _engine(**CONFIGS[name])
    loop = asyncio.get_running_loop()
    started = loop.time()
    await _serve(engine)
    wall = loop.time() - started
    s = engine.stats
    assert s.device_gap_s > 0.0
    assert sum(getattr(s, f"gap_{p}_s") for p in PHASES) == pytest.approx(s.device_gap_s, abs=1e-9)
    assert 0.0 <= s.gap_drained_s <= s.device_gap_s
    busy = s.device_decode_s + s.device_mixed_s + s.device_prefill_s
    assert busy > 0.0 and busy + s.device_gap_s <= wall
    assert (s.device_mixed_s > 0.0) == (name == "ragged")


async def test_engine_with_a_scripted_device_clock_counts_each_dispatch_once():
    """With the scripted clock installed in the engine, the device time by
    kind sums to 1 ms a dispatch, every counted gap is 0.5 ms, and every
    observation of the dispatch-gap histogram reads the scripted 0.5 ms."""
    engine = _engine()
    script = engine._timeline.clock = DeviceScript()
    await _serve(engine)
    s = engine.stats
    dispatches = script.marks // 2
    assert dispatches > 10
    busy = s.device_decode_s + s.device_mixed_s + s.device_prefill_s
    assert busy == pytest.approx(1e-3 * dispatches)
    gaps = s.device_gap_s / 0.5e-3
    assert gaps == pytest.approx(round(gaps)) and 0 < round(gaps) < dispatches
    hist = engine.latency["dispatch_gap_ms"]
    assert hist.count > 0 and hist.sum == pytest.approx(0.5 * hist.count)


async def test_engine_request_spans_sum_the_formation_and_landing_stamps():
    """``queue_wait_s`` and ``prefill_span_s`` are the sums, over admitted
    requests, of submit → formation and formation → landing, stamped where
    the engine forms each wave and lands its first tokens."""
    engine = _engine()
    stamps = []
    note = engine._note_admitted

    def recording(request, landed):
        stamps.append((request.started_at, request.formed_at, landed))
        note(request, landed)

    engine._note_admitted = recording
    await _serve(engine)
    s = engine.stats
    assert len(stamps) == s.admitted_requests == len(PROMPTS)
    assert s.queue_wait_s == pytest.approx(sum(f - a for a, f, _ in stamps), abs=1e-9)
    assert s.prefill_span_s == pytest.approx(sum(t - f for _, f, t in stamps), abs=1e-9)
    assert all(a <= f <= t for a, f, t in stamps)


LONG = dict(long_context=True, max_seq_len=64, long_max_prompt=256, long_new_cap=8)


@pytest.mark.parametrize("name", ["ragged", "lockstep", "long-lane"])
async def test_engine_admitted_requests_equal_the_ttft_histogram_count(name):
    """Every admitted request, on both lanes, is counted once where its
    TTFT is observed."""
    over = LONG if name == "long-lane" else CONFIGS[name]
    prompts = PROMPTS
    if name == "long-lane":
        prompts = PROMPTS[:3] + [[(5 * i + 1) % 512 for i in range(100)]] + PROMPTS[3:5]
    engine = _engine(**over)
    await _serve(engine, prompts, n=6)
    assert engine.stats.admitted_requests == engine.latency["ttft_ms"].count == len(prompts)
    if name == "long-lane":
        assert engine.stats.long_requests == 1


@pytest.mark.parametrize("name", list(CONFIGS))
async def test_engine_decode_steps_and_graph_captures_at_quiescence(name):
    """At quiescence (speculation and the long lane off), ``decode_steps``
    is the sum of the steps the journal's dispatch launches carry, and
    ``graph_captures`` mirrors the graph pool's captures."""
    engine = _engine(**CONFIGS[name])
    await _serve(engine)
    launches = [
        row[5] for row in engine._journal.snapshot() if row[2] == flightrec.EV_DISPATCH_LAUNCH
    ]
    assert launches and engine.stats.decode_steps == sum(launches)
    counters = engine.stats.counters()
    assert counters["graph_captures"] == engine._graphs.stats["captures"]
    assert counters["graph_capture_s"] == engine._graphs.stats["capture_s"]


def test_engine_stats_keep_the_new_counters_and_no_prefill_wall():
    """The counters the benchmark reads are numbers in ``counters()`` and in
    every window; ``prefill_time_s`` (a host wall) is gone."""
    stats = EngineStats()
    counters = stats.counters()
    assert set(PORT_ONLY_COUNTERS) <= set(counters)
    assert all(isinstance(counters[k], (int, float)) for k in PORT_ONLY_COUNTERS)
    assert not hasattr(stats, "prefill_time_s")
    _, delta = stats.snapshot_and_delta()
    assert set(PORT_ONLY_COUNTERS) <= set(delta)


async def test_client_spans_carry_the_engine_request_timing():
    """Under a trace context, the model client's ``engine.prefill`` span
    carries the engine's queue wait and prefill span of the request, and
    ``engine.generate`` its reused prompt tokens; the span tree is as
    before."""
    client = TorchLocalModelClient(engine=_engine(), max_new_tokens=4)
    token = port_trace.current_context.set(
        port_trace.TraceContext(trace_id="timing-trace", span_id="root-span")
    )
    try:
        await client.request([user_message("hello there")])
        await client.request([user_message("hello there")])
    finally:
        port_trace.current_context.reset(token)
        await client.stop()
    spans = port_trace.TRACER.finished("timing-trace")
    prefills = [s for s in spans if s.name == "engine.prefill"]
    generates = [s for s in spans if s.name == "engine.generate"]
    assert len(prefills) == len(generates) == 2
    for span in prefills:
        assert span.attrs["queue_wait_ms"] >= 0.0 and span.attrs["prefill_span_ms"] > 0.0
    assert all(isinstance(s.attrs["reused_tokens"], int) for s in generates)
    assert client._engine.request_timing("timing-trace") is None  # read once


# ------------------------------------------------ the benchmark's readers
def _readings(counters: dict) -> Readings:
    return Readings({}, {}, "cpu", [], (100.0, 110.0), counters, None)


SCRIPTED = dict(
    admitted_requests=4, queue_wait_s=2.0, prefill_span_s=1.0, decode_steps=100,
    device_decode_s=1.5, device_mixed_s=0.5, device_gap_s=0.5, gap_loop_s=0.2,
    gap_launch_s=0.05, gap_drained_s=0.1,
)
READERS = {
    "queue_wait_ms.ttft": 500.0, "queue_wait_ms.tok": 500.0, "prefill_span_ms.ttft": 250.0,
    "device_step_ms.tok": 20.0, "dispatch_gap_share.ttft": 5.0, "dispatch_gap_share.tok": 5.0,
    "gap_loop_share.tok": 40.0, "gap_launch_share.tok": 10.0, "gap_drained_share.ttft": 20.0,
}


@pytest.mark.parametrize("name", list(READERS))
def test_reader_reads_the_scripted_counters(name):
    assert per_layer([name], _readings(dict(SCRIPTED))) == {name: pytest.approx(READERS[name])}


@pytest.mark.parametrize("name", list(READERS))
def test_reader_finds_nothing_in_empty_or_zero_counters(name):
    """A parent without the counters, or a window with no admission, step or
    gap, gives no value."""
    assert per_layer([name], _readings({})) == {}
    zeros = {k: 0 for k in SCRIPTED}
    expect = {name: 0.0} if name.startswith("dispatch_gap_share") else {}
    assert per_layer([name], _readings(zeros)) == expect
