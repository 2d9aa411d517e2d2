"""The PyTorch engine's telemetry against ``calfkit_tpu``'s.

The robustness drill (``tests/_torch_port.py:robustness_drill``, the same
runs ``tests/test_torch_robustness.py`` reads) leaves in each engine a
flight-recorder journal, latency instruments, a page ledger and an
occupancy timeline.  What must be EQUAL between the two engines, in the
four configurations: the journal's event sequence (event, correlation id,
slot and every argument that is not a time in ms), the instruments' names
and counts, the ledger's attribution (by owner, by chain, evictions) at
the drill's snapshots, and every occupancy sample.  Also equal: the spec
tick's journal, the model client's spans (names, parents, statuses) and
forwarded caller context, and each copied module's answers (flight-recorder
dump → parse → timeline, histogram text, the page ledger, the sampler's
dump and the HBM roofline).
"""

import asyncio

import pytest

jax = pytest.importorskip("jax")

import calfkit_tpu.observability.capacity as JCap  # noqa: E402
import calfkit_tpu.observability.flightrec as JF  # noqa: E402
import calfkit_tpu.observability.metrics as JMet  # noqa: E402
import calfkit_tpu.observability.trace as JT  # noqa: E402
import calfkit_tpu_torch.observability.capacity as PCap  # noqa: E402
import calfkit_tpu_torch.observability.flightrec as PF  # noqa: E402
import calfkit_tpu_torch.observability.metrics as PMet  # noqa: E402
import calfkit_tpu_torch.observability.trace as PT  # noqa: E402
from calfkit_tpu.inference.client import JaxLocalModelClient  # noqa: E402
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.config import SpecConfig as JaxSpec  # noqa: E402
from calfkit_tpu.inference.config import preset as jax_preset  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu.models import messages as JM  # noqa: E402
from calfkit_tpu.sim.stubs import BijectiveTokenizer  # noqa: E402
from calfkit_tpu_torch.inference import TorchLocalModelClient  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig, preset  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from calfkit_tpu_torch.models import user_message  # noqa: E402
from tests._torch_port import (  # noqa: E402
    DRILL_CONFIGS,
    MeshModelClient,
    drills,
    jax_params,
    journal_rows,
    metric_counts,
    torch_params,
    virtual_clock,
)

JAX_CFG = jax_preset("debug", dtype="float32")
TORCH_CFG = preset("debug", dtype="float32")


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


@pytest.fixture(autouse=True)
def _dump_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("CALFKIT_FLIGHTREC_DIR", str(tmp_path))


def _events(journal, name):
    return [row for row in journal if row[0] == name]


# --------------------------------------------------------------------------- #
# the drill's telemetry through both engines
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(DRILL_CONFIGS))
async def test_journal_matches_reference(weights, name):
    ref, port = await drills(weights, name)
    assert port["journal"] == ref["journal"]
    journal, c = port["journal"], port["counters"]
    # each robustness counter equals the count of its event
    assert c["shed_requests"] == len(_events(journal, "SHED"))
    assert c["expired_requests"] == len(_events(journal, "EXPIRE"))
    assert c["orphaned_requests"] == len(_events(journal, "ORPHAN"))
    cancels = _events(journal, "CANCEL")
    assert c["delivery_stalled"] == sum(1 for row in cancels if row[3])  # a = undrained blocks
    assert c["cancelled_requests"] == sum(1 for row in cancels if not row[3])
    wedges = _events(journal, "WEDGE")
    assert c["watchdog_trips"] == len(wedges) == 1
    # b = the requests owed at the trip; one more submit was refused
    wedged = sum(1 for o in port["outcomes"].values() if o[0] == "EngineWedgedError")
    assert c["watchdog_faulted"] == wedges[0][4] + 1 == wedged
    assert c["decode_dispatches"] == len(_events(journal, "DISPATCH_LAND")) + (
        len(_events(journal, "SPEC_TICK"))
    )
    # every request but the one refused during the wedge was journaled in
    submits = {row[1] for row in _events(journal, "SUBMIT")}
    assert submits == set(port["outcomes"]) - {"wg-late"}
    if name.startswith("paged"):
        assert len(_events(journal, "PAGE_EVICT")) == c["alloc_stalls"] >= 1


@pytest.mark.parametrize("name", list(DRILL_CONFIGS))
async def test_instruments_match_reference(weights, name):
    """The engine's own histograms: the reference's names and counts; the
    dispatch histogram counts every decode dispatch, the TTFT histogram
    every admitted request."""
    ref, port = await drills(weights, name)
    assert port["latency"] == ref["latency"]
    lat, c = port["latency"], port["counters"]
    assert set(lat) == {
        f"calfkit_engine_{k}" for k in ("queue_wait_ms", "prefill_ms", "ttft_ms",
                                         "inter_token_ms", "decode_dispatch_ms",
                                         "dispatch_gap_ms")
    }
    assert lat["calfkit_engine_decode_dispatch_ms"] == c["decode_dispatches"]
    assert lat["calfkit_engine_inter_token_ms"] == c["decode_dispatches"]
    assert lat["calfkit_engine_ttft_ms"] == lat["calfkit_engine_queue_wait_ms"] > 0


@pytest.mark.parametrize("name", list(DRILL_CONFIGS))
async def test_ledger_attribution_matches_reference(weights, name):
    ref, port = await drills(weights, name)
    assert port["ledgers"] == ref["ledgers"]
    assert port["samples"] == ref["samples"]
    final = port["ledgers"][-1]
    assert final["pages_in_use"] == 0 and final["by_owner"] == []  # drained
    assert len(port["samples"]) == port["counters"]["decode_dispatches"]
    if name.startswith("paged"):
        mid = port["ledgers"][0]
        assert [o["corr"] for o in mid["by_owner"]] and mid["by_chain"]
        assert final["evicted_pages"] == port["counters"]["prefix_evictions"] >= 1
        # at every occupancy sample: pages by owner + free pages == the pool
        assert port["samples_ok"] and all(port["samples_ok"])


async def test_process_metrics_text_names_match_reference(weights):
    """The process registry's exposition carries the reference's engine
    instruments."""
    await drills(weights, "dense-overlap")
    names = {k for k in metric_counts(PMet.metrics_text()) if k.startswith("calfkit_engine_")}
    ref = {k for k in metric_counts(JMet.metrics_text()) if k.startswith("calfkit_engine_")}
    assert names == ref
    assert "calfkit_engine_active_requests" in PMet.metrics_text()


SPEC_RT = dict(max_batch_size=4, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4,
               page_size=16, flightrec_events=1 << 12)
SPEC_PROMPTS = [[1, 5, 9, 13], [7, 8, 9] * 5, [2, 4, 6], list(range(2, 30))]


@pytest.mark.parametrize("layout", ["dense", "paged"])
async def test_spec_tick_journal_matches_reference(weights, layout):
    """The verify tick journals its launch (S, rows) and one SPEC_TICK
    (proposed, emitted) at its landing, as the reference does."""

    async def serve(engine):
        await engine.start()
        try:
            return await asyncio.gather(*[
                _collect(engine, p, 12, corr=f"sp-{i}") for i, p in enumerate(SPEC_PROMPTS)
            ])
        finally:
            await engine.stop()

    ref_engine = JaxEngine(
        JAX_CFG, JaxRuntime(**SPEC_RT, kv_layout=layout, speculative=JaxSpec(k=3),
                            attention_impl="pallas_interpret"), params=weights[0],
    )
    port_engine = InferenceEngine(
        TORCH_CFG, RuntimeConfig(**SPEC_RT, kv_layout=layout, speculative=SpecConfig(k=3)),
        params=weights[1], device="cpu",
    )
    assert await serve(port_engine) == await serve(ref_engine)
    port = journal_rows(port_engine, PF.EVENT_NAMES)
    assert port == journal_rows(ref_engine, JF.EVENT_NAMES)
    ticks = _events(port, "SPEC_TICK")
    assert len(ticks) == port_engine.stats.decode_dispatches
    assert sum(row[3] for row in ticks) == port_engine.stats.spec_proposed
    assert sum(row[4] for row in ticks) == port_engine.stats.spec_emitted
    assert port_engine.latency["inter_token_ms"].count == len(ticks)


async def _collect(engine, prompt, n, **kw):
    return [t async for t in engine.generate(prompt, max_new_tokens=n, **kw)]


# --------------------------------------------------------------------------- #
# the model client: spans, forwarded context, latency
# --------------------------------------------------------------------------- #

RT = dict(max_batch_size=2, max_seq_len=256, prefill_chunk=16, decode_steps_per_dispatch=4,
          kv_layout="paged", page_size=16, chunked_prefill=True, prefix_cache=True)


def _span_tree(records, root):
    """(name, parent's name or "root", status, kind) of each span of a
    trace, in finishing order."""
    names = {r.span_id: r.name for r in records}
    return [(r.name, names.get(r.parent_span_id, "root" if r.parent_span_id == root else "?"),
             r.status, r.kind) for r in records]


async def test_client_spans_and_context_match_reference(weights):
    """Under a caller's trace context, deadline, lease, priority and run,
    both clients open the same spans and hand their engines the same
    context; the engines journal under the trace id."""
    import calfkit_tpu.cancellation as JC
    import calfkit_tpu.leases as JL
    import calfkit_tpu.qos as JQ
    import calfkit_tpu_torch.cancellation as PC
    import calfkit_tpu_torch.leases as PL
    import calfkit_tpu_torch.qos as PQ

    results = {}
    with virtual_clock() as clock:
        for pkg in ("jax", "port"):
            if pkg == "jax":
                engine = JaxEngine(JAX_CFG, JaxRuntime(**RT, attention_impl="pallas_interpret"),
                                   params=weights[0])
                client = JaxLocalModelClient(config=JAX_CFG, engine=engine, max_new_tokens=6,
                                             tokenizer=BijectiveTokenizer())
                mods, msg = (JT, JC, JL, JQ, JCap), JM.user_message("hi")
            else:
                engine = InferenceEngine(TORCH_CFG, RuntimeConfig(**RT), params=weights[1],
                                         device="cpu")
                client = TorchLocalModelClient(engine=engine, max_new_tokens=6,
                                               tokenizer=BijectiveTokenizer())
                mods, msg = (PT, PC, PL, PQ, PCap), user_message("hi")
            trace, canc, leases, qos, cap = mods
            seen = []
            generate = engine.generate

            def recording(prompt, _generate=generate, _seen=seen, **kw):
                _seen.append({k: kw[k] for k in ("corr", "run", "deadline", "lease", "priority")})
                return _generate(prompt, **kw)

            engine.generate = recording
            tid = f"trace-{pkg}"
            leases.note_beat(f"lease-{pkg}", 9.0)
            tokens = [
                trace.current_context.set(trace.TraceContext(trace_id=tid, span_id="root-span")),
                canc.current_deadline.set(clock.now + 50),
                leases.current_lease.set((f"lease-{pkg}", 9.0)),
                qos.current_priority.set("batch"),
                cap.current_run.set("run-1"),
            ]
            try:
                response = await client.request([msg])
                stream = client.request_stream([msg])
                await stream.__anext__()
                with pytest.raises(ZeroDivisionError):  # a fault mid-stream: status error
                    await stream.athrow(ZeroDivisionError())
                stream = client.request_stream([msg])
                await stream.__anext__()
                await stream.aclose()  # an abandoned stream: status cancelled
            finally:
                for var, token in zip(
                    (trace.current_context, canc.current_deadline, leases.current_lease,
                     qos.current_priority, cap.current_run), tokens,
                ):
                    var.reset(token)
                await client.stop()
            journal = journal_rows(engine, (JF if pkg == "jax" else PF).EVENT_NAMES)
            results[pkg] = dict(
                text=response.text(),
                spans=_span_tree(trace.TRACER.finished(tid), "root-span"),
                context=[dict(c, corr=c["corr"] == tid,
                              lease=(c["lease"][0] == f"lease-{pkg}", c["lease"][1]))
                         for c in seen],
                submits=[row[1] == tid for row in _events(journal, "SUBMIT")],
                latency=sorted(client.stats_snapshot()["latency_ms"]),
            )
    assert results["port"] == results["jax"]
    port = results["port"]
    assert [s[:3] for s in port["spans"]] == [
        ("engine.prefill", "engine.generate", "ok"), ("engine.decode", "engine.generate", "ok"),
        ("engine.generate", "root", "ok"),
        ("engine.prefill", "engine.generate", "ok"), ("engine.decode", "engine.generate", "error"),
        ("engine.generate", "root", "error"),
        ("engine.prefill", "engine.generate", "ok"),
        ("engine.decode", "engine.generate", "cancelled"), ("engine.generate", "root", "cancelled"),
    ]
    assert port["context"][0]["priority"] == "batch" and port["context"][0]["run"] == "run-1"
    assert port["submits"] == [True] * 3


async def test_agent_turn_under_a_deadline_reaches_the_port_engine(weights):
    """Through ``MeshModelClient``'s bridge, an ``Agent`` turn carries the
    mesh's deadline, lease, priority and trace to the port's engine as the
    JAX client carries them to its own."""
    from calfkit_tpu import Agent, Client, InMemoryMesh, Worker

    async def turn(model, engine):
        seen = []
        generate = engine.generate

        def recording(prompt, **kw):
            seen.append(kw)
            return generate(prompt, **kw)

        engine.generate = recording
        agent = Agent(name="local", model=model, instructions="Answer briefly.")
        mesh = InMemoryMesh()
        async with Worker([agent], mesh=mesh):
            client = Client.connect(mesh)
            try:
                await client.agent("local").execute("hi", timeout=90, priority="batch")
            finally:
                await client.close()
        return [(kw["deadline"], kw["priority"], kw["corr"] is not None,
                 kw["lease"] is None) for kw in seen]

    with virtual_clock() as clock:
        ref_engine = JaxEngine(JAX_CFG, JaxRuntime(**RT, attention_impl="pallas_interpret"),
                               params=weights[0])
        ref_client = JaxLocalModelClient(config=JAX_CFG, engine=ref_engine, max_new_tokens=4)
        port_engine = InferenceEngine(TORCH_CFG, RuntimeConfig(**RT), params=weights[1],
                                      device="cpu")
        port_client = TorchLocalModelClient(engine=port_engine, max_new_tokens=4)
        try:
            ref = await turn(ref_client, ref_engine)
            port = await turn(MeshModelClient(port_client), port_engine)
        finally:
            await ref_client.stop()
            await port_client.stop()
        assert port == ref
        assert port and port[0][0] == clock.now + 90 and port[0][1] == "batch" and port[0][2]


# --------------------------------------------------------------------------- #
# unit parity of the copied modules
# --------------------------------------------------------------------------- #


def test_flight_recorder_codes_dump_and_timeline_match_reference(tmp_path):
    """The same appends → the same dump (times aside), the same parse and
    the same per-request timeline, through a file of each package."""
    assert PF.EVENT_NAMES == JF.EVENT_NAMES and PF.ARG_LABELS == JF.ARG_LABELS
    assert [getattr(PF, f"EV_{n}") for n in PF.EVENT_NAMES] == list(range(len(PF.EVENT_NAMES)))
    assert PF.default_dump_dir() == JF.default_dump_dir() == str(tmp_path)
    script = [
        ("SUBMIT", "a", -1, 5, 8), ("WAVE_FORM", None, -1, 1, 16), ("PAGE_ALLOC", "a", 0, 2, 0),
        ("ADMIT", "a", 0, 5, 0), ("DISPATCH_LAUNCH", None, -1, 4, 1), ("SUBMIT", "b", -1, 3, 4),
        ("RETIRE_DEFER", "a", 0, 8, 0), ("DISPATCH_LAND", None, -1, 4, 0),
        ("PAGE_FREE", "a", 0, 0, 0), ("SLOT_FREE", "a", 0, 0, 0), ("FAULT", None, -1, 0, 0),
    ] * 3
    parsed = {}
    for pkg, fr in (("jax", JF), ("port", PF)):
        rec = fr.FlightRecorder(16, label="t")
        for name, corr, slot, a, b in script:
            rec.append(getattr(fr, f"EV_{name}"), corr, slot, a, b,
                       "boom" if name == "FAULT" else None)
        path = rec.dump(reason="test")
        with open(path) as f:
            lines = f.read().splitlines()
        events = fr.parse_dump(lines)
        parsed[pkg] = (
            rec.counts(), rec.capacity,
            [{k: v for k, v in e.items() if k != "t_s"} for e in events],
            [e["event"] for e in fr.timeline_events(events, "a")],
            fr.timeline_events(events, "zz"),
            {k: v for k, v in __import__("json").loads(lines[0])["flightrec"].items()
             if k not in ("pid", "dumped_at_s")},
        )
        assert any(rec is j for j in fr.journals())
    assert parsed["port"] == parsed["jax"]
    assert parsed["port"][0] == {"appended": 33, "dropped": 17, "dumped": 1}
    assert PF.FlightRecorder(0).capacity == 0


def test_histogram_buckets_and_text_match_reference():
    samples = [0.05, 0.1, 0.3, 1.0, 2.4, 7.0, 60.0, 5000.0, 1e6, "x", None]
    texts = {}
    for pkg, m in (("jax", JMet), ("port", PMet)):
        reg = m.MetricsRegistry()
        hist = reg.histogram("calfkit_engine_inter_token_ms", "h", buckets=m.INTER_TOKEN_BUCKETS_MS)
        lat = reg.histogram("lat-ms", "default buckets")
        for v in samples:
            hist.observe(v)
            lat.observe(v)
        reg.counter("c_total", "c").inc(3)
        reg.counter("c_total").inc(-1)
        reg.gauge("g", "g").set(2.5)
        with pytest.raises(ValueError):
            reg.counter("g")
        texts[pkg] = (m.metrics_text(reg), hist.percentile(0.5), lat.percentile(0.99),
                      hist.snapshot_and_delta(), reg.counter("c_total").snapshot_and_delta())
    assert texts["port"] == texts["jax"]
    assert PMet.INTER_TOKEN_BUCKETS_MS == JMet.INTER_TOKEN_BUCKETS_MS
    assert PMet.DEFAULT_LATENCY_BUCKETS_MS == JMet.DEFAULT_LATENCY_BUCKETS_MS


@pytest.mark.parametrize("model", ["debug", "llama-3-8b"])
@pytest.mark.parametrize("quantization", [None, "int8", "int4"])
def test_hbm_roofline_matches_reference(model, quantization):
    ref = JCap.hbm_constants(jax_preset(model), quantization)
    port = PCap.hbm_constants(preset(model), quantization)
    assert port == ref
    for ctx, bs in ((0.0, 1), (512.0, 16), (1024.0, 0)):
        assert PCap.hbm_bytes_per_token(port, ctx, bs) == JCap.hbm_bytes_per_token(ref, ctx, bs)


def test_page_ledger_and_sampler_match_reference():
    """The same ownership transitions → the same breakdown; the same
    samples → the same dump, read back by each package's parser."""
    out = {}
    for pkg, cap in (("jax", JCap), ("port", PCap)):
        led = cap.PageLedger(20)
        led.alloc(0, 5, "a", "run-1", cap.lane_kind(None))
        led.alloc(1, 4, "b", None, cap.lane_kind([1]))
        led.transfer(0, [3, 4], [b"\x01\x02", b"\x03"])
        led.acquire([3, 4, 99])
        led.release([4, 4, 4, 98])
        led.note_stall()
        led.evicted(4)
        led.evicted(77)
        led.free(7)
        snap = led.breakdown(top=1)
        led.free(1)
        sampler = cap.CapacitySampler(4, label="t", ledger=led, wall_anchor=False)
        for i in range(6):
            sampler.append(i, 20 - i, 2, 1, 0, 4.0, 1e6, t=float(i))
        meta, samples = cap.parse_dump(sampler.dump_lines(reason="test"))
        meta.pop("pid")
        out[pkg] = (snap, led.breakdown(), led.headroom_pages, sampler.counts(), meta, samples,
                    cap.lane_kind(None, long_lane=True), cap.SAMPLE_FIELDS)
        assert cap.CapacitySampler(0).capacity == 0
    assert out["port"] == out["jax"]


def test_tracer_matches_reference():
    """Spans parent, end once and export to the ring and an installed sink
    as the reference's do; a record carries the reference's fields."""
    out = {}
    for pkg, tr in (("jax", JT), ("port", PT)):
        tracer = tr.Tracer(ring_size=3)
        root = tracer.start_span("root", trace_id="t1", kind="client", attrs={"a": 1})
        child = tracer.start_span("child", parent=root.context, emitter="e")
        sink, token = tr.collect_spans()
        rec = child.end(status="error", n=2)
        again = child.end()
        tr.release_spans(token)
        root.end()
        for i in range(3):
            tracer.start_span(f"s{i}").end()
        headers = tr.TraceContext("t9", "s9").headers()
        out[pkg] = (
            (rec.name, rec.parent_span_id == root.context.span_id, rec.status, rec.attrs,
             rec.kind, rec.emitter, rec.trace_id, rec.span_key() == f"t1/{rec.span_id}"),
            again, [r.name for r in sink], [r.name for r in tracer.finished()],
            [r.name for r in tracer.finished("t1")], headers,
            vars(tr.TraceContext.from_headers(headers)), tr.TraceContext.from_headers({}),
        )
        tracer.clear()
        assert tracer.finished() == []
    assert out["port"] == out["jax"]
    assert set(PT.SpanRecord.__dataclass_fields__) == set(JT.SpanRecord.model_fields)
