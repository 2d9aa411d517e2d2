"""The compiled-dispatch layer (``calfkit_tpu_torch/inference/graphs.py``).

- Key-set parity: after the same drive, the port engine's graph caches
  (``_decode_graphs``, ``_prefill_graphs``) hold exactly the keys of the JAX
  engine's jit caches (``_decode_jits``, ``_prefill_jits``), in four
  configurations; the JAX engine runs its Pallas kernels in interpret mode.
- Static buffers: a captured dispatch called again and again with changing
  inputs returns what fresh eager calls of its body return, exactly (on the
  CPU a call copies its inputs into the static buffers and runs the body
  over them: the code a card captures).
- The ``done_prev`` chain: a row that retired in the previous decode
  dispatch is frozen in the next one through the engine's ``_done`` buffer.
- The long-context lane's graphs (``_long_graphs``) against the programs
  the JAX lane traced: its lru keys and the padded length each retraces on.
- A dropped engine is freed at once, even while a dispatch worker thread
  still holds the work item of its last call.

The card-side laws (replay == ``eager()`` bit for bit, launch counts,
tickets, steady memory) are in ``tests/test_torch_kernels_cuda.py``.
"""

import asyncio

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.config import SpecConfig as JaxSpec  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu.inference.sampler import SamplingParams as JaxSampling  # noqa: E402
from calfkit_tpu_torch.inference import graphs  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from calfkit_tpu_torch.inference.sampler import SamplingParams  # noqa: E402
from tests._torch_port import JAX_CFG, TORCH_CFG, jax_params, torch_params  # noqa: E402

BASE = dict(max_batch_size=4, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4)
PAGED = dict(kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True)
PREFIX = [(11 * i + 5) % 512 for i in range(32)]


def _tail(n, seed):
    return [(7 * i + seed) % 512 for i in range(n)]


# six requests over four slots, then a second burst: waves of several
# widths and buckets, short dispatches while admissions wait, windows that
# grow past a bucket; (prompt, max_new_tokens, sampled)
DRIVE = [
    [(PREFIX + _tail(10, 1), 8, False), (PREFIX + _tail(13, 2), 6, True),
     (_tail(20, 3), 7, False), (_tail(3, 4), 12, False), (_tail(40, 5), 5, False),
     (_tail(9, 6), 9, False)],
    [(PREFIX + _tail(7, 4), 8, False), (PREFIX + _tail(12, 5), 5, False),
     (_tail(5, 6), 9, False), (PREFIX + _tail(10, 1), 4, False)],
]
# name → (runtime overrides, speculative k or None)
CONFIGS = {
    "dense": (dict(window_buckets=(32, 64)), None),
    "paged-chunked-prefix-ragged": (PAGED, None),
    "dense-spec": (dict(), 4),
    "paged-spec": (PAGED, 3),
}


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


async def _drive(engine, sampling_cls, spec: bool):
    """Serve ``DRIVE`` burst by burst; speculative engines serve it greedy
    (their verify widths follow the streams, which equal only greedy)."""

    async def one(prompt, n, sampled):
        kw = {}
        if sampled and not spec:
            kw = dict(sampling=sampling_cls(temperature=0.8, top_p=0.9), seed=3)
        return [tok async for tok in engine.generate(prompt, max_new_tokens=n, **kw)]

    await engine.start()
    try:
        for burst in DRIVE:
            await asyncio.gather(*[one(*job) for job in burst])
    finally:
        await engine.stop()


@pytest.mark.parametrize("name", list(CONFIGS))
async def test_graph_keys_equal_the_reference_jit_keys(weights, name):
    over, k = CONFIGS[name]
    jax_rt = JaxRuntime(
        **BASE, **over, attention_impl="pallas_interpret",
        speculative=JaxSpec(k=k) if k else None,
    )
    reference = JaxEngine(JAX_CFG, jax_rt, params=weights[0])
    await _drive(reference, JaxSampling, spec=bool(k))
    port_rt = RuntimeConfig(**BASE, **over, speculative=SpecConfig(k=k) if k else None)
    port = InferenceEngine(TORCH_CFG, port_rt, params=weights[1], device="cpu")
    await _drive(port, SamplingParams, spec=bool(k))
    assert set(port._decode_graphs) == set(reference._decode_jits)
    assert set(port._prefill_graphs) == set(reference._prefill_jits)
    # every dispatch went through the layer: each cache entry was called
    assert all(fn.calls for fn in (*port._decode_graphs.values(), *port._prefill_graphs.values()))


# the long-context lane beside the short one: long prompts (>= max_seq_len
# 128) of three padded lengths (256, 256, 512) and a second one of 256
# while short bursts run, dense (the monolithic long prefill) and paged +
# chunked + prefix + ragged (the chunked long prefill)
LONG_DRIVE = [
    [(_tail(200, 7), 6, False), (_tail(150, 8), 5, False)] + DRIVE[0][2:],
    [(_tail(300, 9), 4, False), (_tail(140, 3), 6, False)] + DRIVE[1],
]
LONG_RT = dict(long_context=True, long_new_cap=16, long_max_prompt=512)
LONG_CONFIGS = {"dense-long": dict(window_buckets=(32, 64)), "paged-chunked-long": PAGED}


async def _drive_bursts(engine, bursts):
    async def one(prompt, n, _sampled):
        return [tok async for tok in engine.generate(prompt, max_new_tokens=n)]

    await engine.start()
    try:
        for burst in bursts:
            await asyncio.gather(*[one(*job) for job in burst])
    finally:
        await engine.stop()


@pytest.mark.parametrize("name", list(LONG_CONFIGS))
async def test_long_lane_graph_keys_equal_the_reference_traces(weights, name, monkeypatch):
    """The lane's graphs (``_long_graphs``) against the JAX lane's traced
    programs after the same drive: its ``_prefill_sp_jit`` and
    ``_decode_sp_jit`` (process-wide lru caches, cleared first) and the
    chunk jit that serves both lanes, each of which retraces per padded
    length.  Equal: the port's keys and the reference's (lru key, traced
    padded length) pairs; each kind's count of graphs and its jits'
    ``_cache_size()``; and the short lane's tables as they were."""
    from calfkit_tpu.inference import ring_attention as JR

    traced: set = set()
    jits: dict = {"prefill_sp": [], "decode_sp": []}

    def recording(kind, build, padded_of):
        def wrapped(config, mesh, axis, *key):
            fn = build(config, mesh, axis, *key)
            jits[kind].append(fn)

            def call(params, *args):
                traced.add((kind, *key, padded_of(args)))
                return fn(params, *args)

            call._cache_size = fn._cache_size
            return call

        return wrapped

    # prefill_sp(params, tokens [B, S], ...); decode_sp(params, token, k_prefix [L, B, K, S, hd], ...)
    monkeypatch.setattr(JR, "_build_prefill_sp", recording(
        "prefill_sp", JR._build_prefill_sp, lambda args: args[0].shape[1]))
    monkeypatch.setattr(JR, "_build_decode_sp", recording(
        "decode_sp", JR._build_decode_sp, lambda args: args[1].shape[3]))
    JR._prefill_sp_jit.cache_clear()
    JR._decode_sp_jit.cache_clear()
    over = LONG_CONFIGS[name]
    try:
        reference = JaxEngine(JAX_CFG, JaxRuntime(**BASE, **over, **LONG_RT,
                                                  attention_impl="pallas_interpret"),
                              params=weights[0])
        await _drive_bursts(reference, LONG_DRIVE)
    finally:
        JR._prefill_sp_jit.cache_clear()
        JR._decode_sp_jit.cache_clear()
    port = InferenceEngine(TORCH_CFG, RuntimeConfig(**BASE, **over, **LONG_RT),
                           params=weights[1], device="cpu")
    await _drive_bursts(port, LONG_DRIVE)
    long_keys = set(port._long_graphs)
    chunks = {key for key in long_keys if key[0] == "chunk"}
    assert long_keys - chunks == traced
    assert chunks == ({("chunk", 16, 1, p) for p in (256, 512)} if "paged" in name else set())
    # a JAX jit also keys a trace on whether its array arguments are
    # committed to a device: a carried program (decode_sp, a chunk) traces a
    # shape twice, for a request's first call on fresh arrays and for the
    # later calls on the previous call's outputs; one graph serves both
    carried = {"prefill_sp": 1, "decode_sp": 2}
    for kind, times in carried.items():
        assert sum(fn._cache_size() for fn in jits[kind]) == times * sum(
            key[0] == kind for key in long_keys)
    # the reference's ("chunk", chunk, 1) serves both lanes; the port's
    # short table keeps exactly the short lane's keys
    assert set(port._decode_graphs) == set(reference._decode_jits)
    assert set(port._prefill_graphs) | {key[:3] for key in chunks} == set(reference._prefill_jits)
    for key in {key[:3] for key in chunks}:
        short = 1 if key in port._prefill_graphs else 0
        assert reference._prefill_jits[key]._cache_size() == 2 * (short + sum(
            k[:3] == key for k in chunks))
    assert port.stats.long_requests == reference.stats.long_requests == 4
    assert port.stats.long_dispatches == reference.stats.long_dispatches
    assert all(fn.calls for fn in port._long_graphs.values())


def test_static_buffers_equal_fresh_eager_calls():
    """A body that reads its static inputs, engine state in place and
    writes state in place: every call through the captured dispatch equals
    the body called eagerly on fresh copies of the same inputs and state."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))

    def make_body(state):
        def body(x, idx, scale):
            y = torch.tanh(x @ w) * scale[0]
            state.add_(y[idx.to(torch.int64)].sum(dim=0))
            return y, state.clone()
        return body

    state = torch.zeros(8)
    pool = graphs.GraphPool(torch.device("cpu"))
    fn = graphs.CapturedDispatch(
        pool, make_body(state),
        [((4, 8), torch.float32), ((2,), torch.int32), ((1,), torch.float32)],
    )
    fresh_state = torch.zeros(8)
    fresh = make_body(fresh_state)
    for step in range(5):
        x = rng.standard_normal((4, 8)).astype(np.float32)
        idx = rng.integers(0, 4, 2).astype(np.int32)
        scale = np.asarray([0.5 + step], np.float32)
        got = fn(x, idx, scale)
        want = fresh(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(scale))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        # the inputs landed in the static buffers, which the body read
        assert np.array_equal(fn.inputs[0].numpy(), x)
    assert torch.equal(state, fresh_state)
    assert fn.calls == 5
    assert pool.stats == dict(captures=0, replays=0, eager=0, capture_s=0.0)  # the CPU runs bodies
    with pytest.raises(ValueError, match="static input"):
        fn(np.zeros((3, 8), np.float32), idx, scale)
    made: list = []

    def make():
        made.append(1)
        return lambda n: made.append(n)

    assert not graphs.on_replay("tag", make) and not made  # no capture on this thread
    graphs._capture.hooks = hooks = {}  # as a capture on this thread sets them
    try:
        assert all(graphs.on_replay("tag", make) for _ in range(3))
    finally:
        graphs._capture.hooks = None
    assert made == [1] and hooks["tag"][0] == 3  # one hook, built once, told 3 a replay


def test_done_prev_freezes_a_row_retired_in_the_previous_dispatch(weights):
    """Two rows decode; row 0 hits its hard bound in dispatch 1.  Dispatch
    2 reads ``_done`` (dispatch 1's mask, written in place) as its
    ``done_prev`` and freezes row 0: its length and last token stay, its
    column repeats the last token; row 1 advances.  With a zero
    ``done_prev`` the same dispatch would advance row 0."""
    rt = RuntimeConfig(**BASE)
    engine = InferenceEngine(TORCH_CFG, rt, params=weights[1], device="cpu")
    steps = rt.decode_steps_per_dispatch
    engine._lens[:2] = torch.tensor([5, 9], dtype=torch.int32)
    engine._last[:2] = torch.tensor([17, 23], dtype=torch.int32)
    engine._hard_end[:2] = [5 + 1, 100]  # row 0's bound falls inside dispatch 1
    engine._retire_dirty = True
    active = np.asarray([True, True, False, False])
    toks, n_valid, done = engine._dispatch(active, 32, steps, False, engine._done_zero)
    assert done.tolist() == [True, False, False, False] and n_valid[0] == 1
    assert engine._lens[:2].tolist() == [5 + steps, 9 + steps]
    lens_before, last_before = engine._lens.clone(), engine._last.clone()

    toks, _, _ = engine._dispatch(active, 32, steps, False, engine._done)
    assert engine._lens[0] == lens_before[0] and engine._last[0] == last_before[0]
    assert toks[:, 0].tolist() == [int(last_before[0])] * steps
    assert engine._lens[1] == lens_before[1] + steps
    assert not engine._done[0]  # a frozen row is inactive: never done again

    engine._dispatch(active, 32, steps, False, engine._done_zero)
    assert engine._lens[0] == lens_before[0] + steps  # without the chain it would advance


async def test_graphs_do_not_keep_a_dropped_engine_alive(weights):
    """The bodies reach the engine through a weak proxy: a stopped engine
    whose graph caches are full is freed as soon as its last reference
    goes, without the cycle collector (on a card its weights, caches and
    graph pool go with it)."""
    import gc
    import weakref

    engine = InferenceEngine(
        TORCH_CFG, RuntimeConfig(**BASE, **PAGED), params=weights[1], device="cpu"
    )
    await _drive(engine, SamplingParams, spec=False)
    assert engine._decode_graphs and engine._prefill_graphs
    ref = weakref.ref(engine)
    gc.disable()
    try:
        del engine
        assert ref() is None
    finally:
        gc.enable()


async def test_dropped_engine_freed_while_worker_lingers(weights, monkeypatch):
    """A dispatch worker of ``asyncio.to_thread`` keeps its work item (the
    function and arguments it ran) after the call returned, until its
    loop drops it: held there for 0.3 s after every call, as a loaded
    machine may hold it, a stopped engine is still freed as soon as its
    last reference goes, without the cycle collector."""
    import concurrent.futures.thread as worker
    import gc
    import time
    import weakref

    run = worker._WorkItem.run

    def lingering(item):
        run(item)
        time.sleep(0.3)

    monkeypatch.setattr(worker._WorkItem, "run", lingering)
    engine = InferenceEngine(
        TORCH_CFG, RuntimeConfig(**BASE, **PAGED), params=weights[1], device="cpu"
    )
    await _drive(engine, SamplingParams, spec=False)
    ref = weakref.ref(engine)
    gc.disable()
    try:
        del engine
        assert ref() is None
    finally:
        gc.enable()
