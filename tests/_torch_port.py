"""Shared helpers of the PyTorch port's parity tests: the JAX package is the
oracle, and both packages get the same inputs as numpy arrays; the model
client's messages cross between the two packages by field, and one virtual
clock is THE wall clock of both."""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch
from pydantic import BaseModel

import calfkit_tpu.cancellation as mesh_cancellation
import calfkit_tpu.engine.model_client as mesh_model_client
import calfkit_tpu.exceptions as mesh_exceptions
import calfkit_tpu.leases as mesh_leases
import calfkit_tpu.models.capability as mesh_capability
import calfkit_tpu.models.messages as mesh_messages
import calfkit_tpu.models.payload as mesh_payload
import calfkit_tpu.observability.capacity as mesh_capacity
import calfkit_tpu.observability.flightrec as mesh_flightrec
import calfkit_tpu.observability.metrics as mesh_metrics
import calfkit_tpu.observability.trace as mesh_trace
import calfkit_tpu.qos as mesh_qos
import calfkit_tpu_torch.cancellation as port_cancellation
import calfkit_tpu_torch.engine.model_client as port_model_client
import calfkit_tpu_torch.exceptions as port_exceptions
import calfkit_tpu_torch.leases as port_leases
import calfkit_tpu_torch.models.capability as port_capability
import calfkit_tpu_torch.models.messages as port_messages
import calfkit_tpu_torch.models.payload as port_payload
import calfkit_tpu_torch.observability.capacity as port_capacity
import calfkit_tpu_torch.observability.flightrec as port_flightrec
import calfkit_tpu_torch.observability.metrics as port_metrics
import calfkit_tpu_torch.observability.trace as port_trace
import calfkit_tpu_torch.qos as port_qos
from calfkit_tpu.inference import model as JM
from calfkit_tpu.inference import quant as JQ
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime
from calfkit_tpu.inference.config import preset as jax_preset
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine
from calfkit_tpu.sim.clock import virtual_clock as mesh_virtual_clock
from calfkit_tpu_torch.inference.config import RuntimeConfig as TorchRuntime
from calfkit_tpu_torch.inference.config import preset as torch_preset
from calfkit_tpu_torch.inference.engine import InferenceEngine
from calfkit_tpu_torch.inference.weights import params_from_numpy
from chip_smoke import Pace, quiescent  # the chip smoke's overload phase drives alike

JAX_CFG = jax_preset("debug")
TORCH_CFG = torch_preset("debug")

# EngineStats counters the port keeps and the reference has not: the
# dispatch timeline's device times and host phases, the per-request queue
# wait and prefill span, decode steps and graph captures.  A comparison of
# counters() or snapshot_and_delta() windows with the reference drops them
PORT_ONLY_COUNTERS = (
    "admitted_requests", "queue_wait_s", "prefill_span_s", "decode_steps",
    "device_decode_s", "device_mixed_s", "device_prefill_s", "device_gap_s",
    "gap_schedule_s", "gap_loop_s", "gap_prep_s", "gap_launch_s", "gap_land_s",
    "gap_drained_s", "graph_captures", "graph_capture_s",
)

# the suite runs in several worker processes on few cores: one thread per
# worker for these tiny tensors keeps torch from crowding out the others
torch.set_num_threads(1)


def jax_params(seed: int = 0):
    """The reference tests' debug-preset params: f32, from a JAX key."""
    return JM.init_params(JAX_CFG, jax.random.key(seed), dtype=jnp.float32)


def torch_params(params) -> dict:
    """The same weights as the port's tensors on the CPU."""
    tree = jax.tree.map(np.asarray, params)
    return params_from_numpy(tree, device="cpu")


def quantized_params(bits: int, seed: int = 0):
    """The reference tests' debug-preset params quantized by the JAX
    package (``bits`` 8 or 4), and the same quantized tree as the port's
    CPU tensors (int8 or uint8 payloads, f32 scales)."""
    params = JQ.quantize_params(jax_params(seed), bits=bits)
    return params, torch_params(params)


def t(array, dtype=None) -> torch.Tensor:
    """numpy → CPU tensor."""
    out = torch.from_numpy(np.ascontiguousarray(array).copy())
    return out if dtype is None else out.to(dtype)


def j(array, dtype=None):
    """numpy → JAX array."""
    return jnp.asarray(array) if dtype is None else jnp.asarray(array, dtype)


def n(x) -> np.ndarray:
    """tensor or JAX array → f32-or-int numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if np.issubdtype(x.dtype, np.floating) or x.dtype.name == "bfloat16" else x


@contextlib.contextmanager
def virtual_clock():
    """The JAX package's chaos ``VirtualClock``, installed as the
    ``cancellation.wall_clock`` of BOTH packages for the block: deadlines,
    lease lapse and the watchdog of both engines advance only when the test
    advances the clock."""
    with mesh_virtual_clock() as clock:
        previous = port_cancellation.wall_clock
        port_cancellation.wall_clock = clock
        try:
            yield clock
        finally:
            port_cancellation.wall_clock = previous


# --------------------------------------------------------------------------- #
# the model-client seam: the mesh's pydantic types <-> the port's dataclasses
# --------------------------------------------------------------------------- #


def _types(*modules) -> dict:
    """Every class defined in ``modules``, by name."""
    return {
        name: obj for module in modules for name, obj in vars(module).items()
        if isinstance(obj, type) and obj.__module__ == module.__name__
    }


_PORT_TYPES = _types(port_payload, port_capability, port_messages, port_model_client)
_MESH_TYPES = _types(mesh_payload, mesh_capability, mesh_messages, mesh_model_client)


def to_port(obj):
    """A mesh (pydantic) message, part, setting or parameter object, or a
    list or dict of them → the port's dataclass of the same name, field by
    field."""
    if isinstance(obj, BaseModel):
        cls = _PORT_TYPES[type(obj).__name__]
        return cls(**{name: to_port(getattr(obj, name)) for name in type(obj).model_fields})
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


def to_mesh(obj):
    """The inverse of :func:`to_port`: a port dataclass (a message, part or
    stream event) → the mesh's type of the same name."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _MESH_TYPES[type(obj).__name__]
        return cls(**{f.name: to_mesh(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_mesh(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_mesh(v) for k, v in obj.items()}
    return obj


class MeshModelClient(mesh_model_client.ModelClient):
    """The port's ``TorchLocalModelClient`` as the mesh's ``ModelClient``:
    an ``Agent`` checks ``isinstance`` against the mesh's own types, which
    the port may not import, so this test-only adapter converts the
    messages, settings and parameters in and the stream events out."""

    def __init__(self, client):
        self.client = client

    @property
    def model_name(self) -> str:
        return self.client.model_name

    async def request(self, messages, settings=None, params=None):
        async for event in self.request_stream(messages, settings, params):
            if isinstance(event, mesh_model_client.ResponseDone):
                return event.response
        raise RuntimeError("stream ended without a terminal response")

    async def request_stream(self, messages, settings=None, params=None):
        # the caller context the mesh's node kernel set for this delivery,
        # copied into the port's contextvars (which the port's client reads)
        trace = mesh_trace.current_context.get()
        context = [
            (port_cancellation.current_deadline, mesh_cancellation.current_deadline.get()),
            (port_leases.current_lease, mesh_leases.current_lease.get()),
            (port_qos.current_priority, mesh_qos.current_priority.get()),
            (port_capacity.current_run, mesh_capacity.current_run.get()),
            (port_trace.current_context, None if trace is None else port_trace.TraceContext(
                trace_id=trace.trace_id, span_id=trace.span_id,
                parent_span_id=trace.parent_span_id,
            )),
        ]
        tokens = [(var, var.set(value)) for var, value in context]
        stream = self.client.request_stream(
            to_port(messages), to_port(settings), to_port(params)
        )
        try:
            async for event in stream:
                yield to_mesh(event)
        finally:
            await stream.aclose()
            for var, token in reversed(tokens):
                with contextlib.suppress(ValueError):  # closed from another context
                    var.reset(token)


# --------------------------------------------------------------------------- #
# the robustness drill: one scripted drive through either package's engine
# --------------------------------------------------------------------------- #

# event arguments that are times in ms (masked when journals are compared)
_TIMED_ARGS = {"WAVE_LAND": (False, True), "EXPIRE": (True, False),
               "ORPHAN": (True, False), "WEDGE": (True, False)}


def live(engine, corr):
    """The active request tagged ``corr`` (None when it holds no slot)."""
    return next((r for r in list(engine._active.values()) if r.corr == corr), None)


def _outcome(exc) -> tuple:
    name = type(exc).__name__
    if name == "EngineOverloadedError":
        return name, exc.lane, exc.pending, exc.limit
    if name == "RunOrphanedError":
        return name, exc.lease_id
    if name == "EngineWedgedError":
        return name, exc.stalled_s
    return (name,)


def journal_rows(engine, names) -> "list[tuple]":
    """The engine's journal as (event, corr, slot, a, b), oldest first, with
    the arguments that are times in ms masked."""
    rows = []
    for _seq, _t, code, corr, slot, a, b, _note in engine._journal.snapshot():
        name = names[code]
        mask_a, mask_b = _TIMED_ARGS.get(name, (False, False))
        rows.append((name, corr, slot, None if mask_a else a, None if mask_b else b))
    return rows


def metric_counts(text: str) -> dict:
    """Prometheus text → {instrument name: count} for histograms (their
    ``_count`` sample) and {name: value} for counters."""
    out, kinds = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            if name.endswith("_count") and kinds.get(name[:-6]) == "histogram":
                out[name[:-6]] = int(value)
            elif kinds.get(name) == "counter":
                out[name] = float(value)
    return out


async def robustness_drill(engine, pkg, clock, tag: str) -> dict:
    """Drive a started-to-be engine (either package's) through the
    robustness drills in one run, phase after phase, each phase's actions
    fired by :class:`Pace` at scheduler ticks → every outcome the parity
    tests compare.  ``pkg`` names the package's modules: ``leases``,
    ``exceptions``, ``flightrec``, ``capacity``, ``metrics``; ``tag`` makes
    lease ids unique per run (each package has its own lease store).

    1. overload: eight submits at once past a full lane (max_pending=4):
       batch work is shed first, an interactive submit evicts a queued batch
       request, and an interactive one is shed only when none is queued;
    2. deadlines: one active and one queued request expire mid-decode;
    3. orphans: a dead lease reaps an active and a queued run, a live one
       is served, and a run whose deadline and lease lapse together raises
       the deadline's error (the precedence law);
    4. a consumer that stops reading is stall-cancelled (max_out_blocks);
    5. cancels: a consumer closes its stream, another by correlation id;
    6. wedge: a blocked dispatch trips the watchdog, every owed request
       faults typed, a submit during the wedge is refused, the engine
       un-wedges and serves again."""
    pace = Pace()
    engine._chaos = pace
    outcomes: dict = {}
    ledgers: list = []
    samples_ok: list = []
    prefix = list(range(1, 17))  # two pages of 8, one chunk of 16
    other = list(range(200, 216))
    leases = pkg.leases

    def prompt(i, base=prefix):
        return base + [100 + 7 * i + k for k in range(3 + i % 5)]

    async def run(corr, p, n, *, close_after=None, hold=None, **kw):
        toks = []
        agen = engine.generate(p, max_new_tokens=n, corr=corr, **kw)
        try:
            async for tok in agen:
                toks.append(tok)
                if close_after is not None and len(toks) == close_after:
                    break
                if hold is not None and len(toks) == 1:
                    await hold.wait()
            outcomes[corr] = ("ok", toks)
        except TYPED as exc:
            outcomes[corr] = _outcome(exc)
        finally:
            await agen.aclose()

    async def phase(*jobs):
        await asyncio.gather(*jobs)
        for _ in range(400):
            if quiescent(engine):
                break
            await asyncio.sleep(0.01)
        assert quiescent(engine), f"{tag}: engine never settled"
        await asyncio.sleep(0.02)

    TYPED = tuple(getattr(pkg.exceptions, name) for name in (
        "EngineOverloadedError", "EngineWedgedError", "DeadlineExceededError", "RunOrphanedError",
    ))
    if engine._paged:
        # at every occupancy sample: pages by owner + free pages == the pool
        class Checked(pkg.capacity.CapacitySampler):
            def append(self, *args, **kw):
                b = engine._ledger.breakdown()
                samples_ok.append(
                    b["private_pages"] + b["prefix_resident_pages"]
                    + engine._page_alloc.free_pages == engine._page_alloc.num_pages - 1
                )
                super().append(*args, **kw)

        engine._sampler = Checked(
            engine._sampler.capacity, label="drill", ledger=engine._ledger
        )
    await engine.start()
    try:
        # 1. overload and QoS
        pace.when(lambda: len(engine._active) == 2,
                  lambda: ledgers.append(engine._ledger.breakdown()))
        classes = ["batch", "batch", "interactive", "interactive", "interactive", "batch",
                   "interactive", "interactive"]
        await phase(*[run(f"shed-{i}", prompt(i, other), 6, priority=c)
                      for i, c in enumerate(classes)])
        # 2. deadlines: active and queued requests expire mid-decode
        now = clock.now
        pace.when(lambda: (r := live(engine, "dl-a")) is not None and r.generated >= 5,
                  lambda: (ledgers.append(engine._ledger.breakdown()), clock.advance(10.0)))
        await phase(run("dl-a", prompt(6), 24, deadline=now + 5),
                    run("dl-b", prompt(7), 12),
                    run("dl-q", prompt(8), 24, deadline=now + 5, priority="batch"))
        # 3. orphans and the precedence law
        dead, both, alive = (f"{tag}-dead", f"{tag}-both", f"{tag}-live")
        leases.note_beat(dead, 5.0)
        leases.note_beat(both, 5.0)
        leases.note_beat(alive, 20.0)
        now = clock.now
        pace.when(lambda: (r := live(engine, "or-dead")) is not None and r.generated >= 5,
                  lambda: clock.advance(6.0))
        await phase(run("or-dead", prompt(9), 24, lease=(dead, 5.0)),
                    run("or-both", prompt(10), 24, deadline=now + 5, lease=(both, 5.0)),
                    run("or-live", prompt(11), 10, lease=(alive, 20.0)),
                    run("or-dead-q", prompt(12), 10, lease=(dead, 5.0)))
        # 4. a stalled consumer
        hold = asyncio.Event()
        stuck = asyncio.ensure_future(run("st-stuck", prompt(13), 24, hold=hold))
        await phase(run("st-ok", prompt(14), 16))
        hold.set()
        await stuck
        # 5. cancels
        pace.when(lambda: (r := live(engine, "cx-corr")) is not None and r.generated >= 3,
                  lambda: engine.cancel_correlation("cx-corr"))
        await phase(run("cx-close", prompt(15), 24, close_after=3),
                    run("cx-corr", prompt(16), 24), run("cx-ok", prompt(17), 10))
        # 6. wedge: a blocked dispatch trips the watchdog
        gate = threading.Event()
        pace.when(lambda: (r := live(engine, "wg-0")) is not None and r.generated >= 3,
                  lambda: pace.block_next_dispatch(gate))
        wedged = asyncio.gather(run("wg-0", prompt(18), 24), run("wg-1", prompt(19), 24),
                                run("wg-2", prompt(20), 24))
        try:
            for _ in range(800):
                if pace.blocked:
                    break
                await asyncio.sleep(0.01)
            assert pace.blocked, f"{tag}: the dispatch never blocked"
            clock.advance(60.0)
            for _ in range(800):
                if engine._wedged:
                    break
                await asyncio.sleep(0.01)
            assert engine._wedged, f"{tag}: the watchdog never tripped"
            await wedged
            await run("wg-late", prompt(21), 4)
        finally:
            clock.advance(0.01)
            gate.set()
        for _ in range(800):
            if not engine._wedged and quiescent(engine):
                break
            await asyncio.sleep(0.01)
        assert not engine._wedged, f"{tag}: a landing never un-wedged the engine"
        await phase(run("wg-after", prompt(22), 6))
    finally:
        await engine.stop()
    counters = engine.stats.counters()
    for name in ("decode_time_s", *PORT_ONLY_COUNTERS):  # the reference has none of these
        counters.pop(name, None)
    return dict(
        outcomes=outcomes,
        counters=counters,
        journal=journal_rows(engine, pkg.flightrec.EVENT_NAMES),
        latency=metric_counts(pkg.metrics.metrics_text(engine._own_registry)),
        ledgers=ledgers + [engine._ledger.breakdown()],
        samples=[row[2:] for row in engine._sampler.snapshot()],
        samples_ok=samples_ok,
        free=sorted(engine._free),
        pages=(engine._page_alloc.free_pages + (engine._prefix.size if engine._prefix else 0)
               if engine._paged else None),
    )


# the drill's configurations: f32 debug weights and KV (no bf16 near-ties),
# two slots, overload, stall and watchdog bounds; dense and paged + prefix
# cache + chunked prefill (a pool small enough to evict), each overlapped
# and lockstep
_JAX_F32 = jax_preset("debug", dtype="float32")
_TORCH_F32 = torch_preset("debug", dtype="float32")
_DRILL_BASE = dict(
    max_batch_size=2, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4,
    max_pending=4, max_out_blocks=2, watchdog_stall_s=30.0, capacity_samples=256,
    flightrec_events=1 << 14,
)
DRILL_PAGED = dict(
    kv_layout="paged", page_size=8, num_kv_pages=13, chunked_prefill=True, prefix_cache=True,
)
DRILL_CONFIGS = {
    "dense-overlap": dict(_DRILL_BASE, overlap_dispatch=True),
    "dense-lockstep": dict(_DRILL_BASE, overlap_dispatch=False),
    "paged-overlap": dict(_DRILL_BASE, **DRILL_PAGED, overlap_dispatch=True),
    "paged-lockstep": dict(_DRILL_BASE, **DRILL_PAGED, overlap_dispatch=False),
}
_JAX_PKG = SimpleNamespace(
    leases=mesh_leases, exceptions=mesh_exceptions, flightrec=mesh_flightrec,
    capacity=mesh_capacity, metrics=mesh_metrics,
)
_PORT_PKG = SimpleNamespace(
    leases=port_leases, exceptions=port_exceptions, flightrec=port_flightrec,
    capacity=port_capacity, metrics=port_metrics,
)


_DRILLS: dict = {}


async def drills(weights, name) -> "tuple[dict, dict]":
    """(the JAX engine's drill, the port's) for configuration ``name``, run
    once per process: both test files of the drill read the same runs."""
    if name not in _DRILLS:
        rt = DRILL_CONFIGS[name]
        with virtual_clock() as clock:
            ref = await robustness_drill(
                JaxEngine(_JAX_F32, JaxRuntime(**rt, attention_impl="pallas_interpret"),
                          params=weights[0]),
                _JAX_PKG, clock, name,
            )
        with virtual_clock() as clock:
            port = await robustness_drill(
                InferenceEngine(_TORCH_F32, TorchRuntime(**rt), params=weights[1], device="cpu"),
                _PORT_PKG, clock, name,
            )
        _DRILLS[name] = ref, port
    return _DRILLS[name]




# --------------------------------------------------------------------------- #
# the long-context lane's drill: one scripted drive through either engine
# --------------------------------------------------------------------------- #

LONG_BASE = dict(
    max_batch_size=2, max_seq_len=64, prefill_chunk=16, decode_steps_per_dispatch=4,
    long_context=True, long_new_cap=24, long_max_prompt=128, max_pending=3,
    flightrec_events=1 << 14,
)
LONG_PAGED = dict(kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True)
# name → (runtime, speculative k or None): dense (the monolithic long
# prefill), paged + prefix cache + chunked prefill with ragged waves (the
# chunked long prefill), and that with speculation, each overlapped and
# lockstep
LONG_CONFIGS = {
    f"{name}-{mode}": (dict(LONG_BASE, **over, overlap_dispatch=mode == "overlap"), k)
    for name, over, k in (("dense", {}, None), ("paged", LONG_PAGED, None),
                          ("paged-spec", LONG_PAGED, 3))
    for mode in ("overlap", "lockstep")
}
# the drill's long prompts (each >= max_seq_len 64), by request
LONG_PROMPTS = {
    "alone": [(7 * i + 3) % 512 for i in range(100)],
    "inter": [(3 * i + 1) % 512 for i in range(90)],
    "cx": [(i + 2) % 512 for i in range(80)],
    "prog": [(i + 4) % 512 for i in range(120)],
    "budget": [(i + 9) % 512 for i in range(70)],
    "reap": [(5 * i + 7) % 512 for i in range(75)],
}


def long_idle(engine) -> bool:
    """Nothing queued, admitting, in flight or active in either lane."""
    return (quiescent(engine) and engine._long is None and engine._long_inflight is None
            and not engine._long_pending)


def _long_live(engine, corr):
    """The long request tagged ``corr`` while the lane decodes it."""
    state = engine._long
    return state["request"] if state is not None and state["request"].corr == corr else None


async def long_lane_drill(engine, pkg, clock, tag: str) -> dict:
    """Drive a started-to-be engine (either package's) through the long
    lane's cases in one run, phase after phase, each action fired by
    :class:`Pace` at a scheduler tick when a state condition holds, so both
    engines take it at the same point:

    1. a long prompt alone; 2. a long prompt and three short ones at once;
    3. a cancel by correlation id while the lane decodes, one while the
       chunked long prefill is in flight (chunked runtimes), and the lane
       serving again after them;
    4. a budget over ``long_new_cap`` (a typed fault) and a prompt over
       ``long_max_prompt`` (refused), then a budget within the cap;
    5. a short and a long prompt at once: the short stream decodes while
       the long prompt is admitted (the short tokens that arrive while a
       chunked long prefill is in flight are counted);
    6. a deadline and a lapsed lease reaping the long request mid-decode;
    7. five long submits at once past ``max_pending`` 3: the queued batch
       request is shed for an interactive one, then an interactive one is
       refused."""
    pace = Pace()
    engine._chaos = pace
    outcomes: dict = {}
    during = [0]
    P = LONG_PROMPTS
    TYPED = tuple(getattr(pkg.exceptions, name) for name in (
        "EngineOverloadedError", "DeadlineExceededError", "RunOrphanedError", "InferenceError",
    ))

    async def run(corr, p, n, *, count_during=False, **kw):
        toks = []
        agen = engine.generate(p, max_new_tokens=n, corr=corr, **kw)
        try:
            async for tok in agen:
                toks.append(tok)
                if count_during and engine._long_inflight is not None:
                    during[0] += 1
            outcomes[corr] = ("ok", toks)
        except TYPED as exc:
            outcomes[corr] = _outcome(exc)
        finally:
            await agen.aclose()

    async def phase(*jobs):
        await asyncio.gather(*jobs)
        for _ in range(400):
            if long_idle(engine):
                break
            await asyncio.sleep(0.01)
        assert long_idle(engine), f"{tag}: engine never settled"
        await asyncio.sleep(0.02)

    await engine.start()
    try:
        await phase(run("alone", P["alone"], 8))
        await phase(run("inter-long", P["inter"], 12),
                    *[run(f"inter-{i}", [5 + i, 6, 7], 6) for i in range(3)])
        pace.when(lambda: (r := _long_live(engine, "cx-decode")) is not None and r.generated >= 1,
                  lambda: engine.cancel_correlation("cx-decode"))
        await phase(run("cx-decode", P["cx"], 24))
        if engine.runtime.chunked_prefill:
            pace.when(lambda: (inf := engine._long_inflight) is not None and inf["idx"] >= 2,
                      lambda: engine.cancel_correlation("cx-prefill"))
            await phase(run("cx-prefill", P["prog"], 8))
        await phase(run("cx-after", P["cx"], 4))
        await phase(run("over-cap", P["budget"], 1000), run("ceiling", list(range(200)), 4))
        await phase(run("in-budget", P["budget"], 4))
        # submitted together, before the scheduler's next pass (a submit
        # racing a dispatch on the worker thread would order the journal
        # by timing): the short is admitted, the long follows in the lane
        await phase(run("prog-short", [5, 6, 7], 24, count_during=True),
                    run("prog-long", P["prog"], 8))
        now = clock.now
        pace.when(lambda: (r := _long_live(engine, "dl")) is not None and r.generated >= 2,
                  lambda: clock.advance(10.0))
        await phase(run("dl", P["reap"], 16, deadline=now + 5))
        dead = f"{tag}-dead"
        pkg.leases.note_beat(dead, 5.0)
        pace.when(lambda: (r := _long_live(engine, "or")) is not None and r.generated >= 2,
                  lambda: clock.advance(6.0))
        await phase(run("or", P["reap"], 16, lease=(dead, 5.0)))
        classes = ["batch", "interactive", "interactive", "interactive", "interactive"]
        await phase(*[run(f"shed-{i}", P["reap"][i:] + P["cx"][:i], 4, priority=c)
                      for i, c in enumerate(classes)])
    finally:
        await engine.stop()
    counters = engine.stats.counters()
    for name in ("decode_time_s", *PORT_ONLY_COUNTERS):  # the reference has none of these
        counters.pop(name, None)
    return dict(
        outcomes=outcomes, counters=counters, during_prefill=during[0],
        journal=journal_rows(engine, pkg.flightrec.EVENT_NAMES),
        free=sorted(engine._free),
        pages=(engine._page_alloc.free_pages + (engine._prefix.size if engine._prefix else 0)
               if engine._paged else None),
        idle=long_idle(engine),
    )


_LONG_DRILLS: dict = {}


async def long_drills(weights, name) -> "tuple[dict, dict, dict]":
    """(the JAX engine's long-lane drill, the port's, the port engine) for
    configuration ``name`` of :data:`LONG_CONFIGS`, on the f32 debug
    weights, run once per process."""
    if name not in _LONG_DRILLS:
        from calfkit_tpu.inference.config import SpecConfig as JaxSpec
        from calfkit_tpu_torch.inference.config import SpecConfig as TorchSpec

        rt, k = LONG_CONFIGS[name]
        with virtual_clock() as clock:
            ref = await long_lane_drill(
                JaxEngine(_JAX_F32, JaxRuntime(**rt, attention_impl="pallas_interpret",
                                               speculative=JaxSpec(k=k) if k else None),
                          params=weights[0]),
                _JAX_PKG, clock, name,
            )
        engine = InferenceEngine(_TORCH_F32, TorchRuntime(
            **rt, speculative=TorchSpec(k=k) if k else None), params=weights[1], device="cpu")
        with virtual_clock() as clock:
            port = await long_lane_drill(engine, _PORT_PKG, clock, name)
        _LONG_DRILLS[name] = ref, port, engine
    return _LONG_DRILLS[name]
