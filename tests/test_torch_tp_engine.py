"""The port's tensor- and data-parallel engine against ``calfkit_tpu``'s on
the same mesh.

The JAX engine runs on its 8-device virtual CPU mesh (GSPMD places the
work); the port's engine is rank 0 of a process group whose other ranks it
spawns itself (gloo, one CPU process a rank).  Both serve the same f32
``debug`` weights (f32 KV too: the ranks' partial sums round in another
order than one device's), in two bursts sharing a prefix and a third of
second turns that re-send a first turn's prompt and answer: the greedy
streams and every ``EngineStats`` counter but the timings must be equal;
afterwards every page is free or cached, and every worker process has
exited.
"""

import asyncio
import dataclasses

import pytest

jax = pytest.importorskip("jax")

from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.config import SpecConfig as JaxSpec  # noqa: E402
from calfkit_tpu.inference.config import preset as jax_preset  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu.inference.sharding import make_mesh as jax_mesh  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig, preset  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from calfkit_tpu_torch.inference.engine import EngineStats  # noqa: E402
from tests._torch_port import (  # noqa: E402
    PORT_ONLY_COUNTERS,
    jax_params,
    quantized_params,
    torch_params,
)

JAX_CFG = jax_preset("debug", dtype="float32")
TORCH_CFG = preset("debug", dtype="float32")

BASE = dict(max_batch_size=4, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4)
PAGED = dict(kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True)
# (runtime over BASE, weights): every multi-rank layout the reference's rule
# gives the debug preset (H=4, K=2, F=128, V=512)
CONFIGS = {
    "tp2-dense": (dict(tp=2), "f32"),
    "tp2-paged": (dict(PAGED, tp=2), "f32"),
    "dp2-paged": (dict(PAGED, dp=2), "f32"),
    "tp2xdp2-paged": (dict(PAGED, tp=2, dp=2), "f32"),
    "tp2xdp2-dense": (dict(tp=2, dp=2), "f32"),
    "tp4-replicated-kv": (dict(PAGED, tp=4), "f32"),
    "tp8-replicated-attention": (dict(tp=8), "f32"),
    "tp2-int8": (dict(PAGED, tp=2, quantization="int8"), "int8"),
    "tp2-int4": (dict(tp=2, quantization="int4"), "int4"),
    "tp2-spec-paged": (dict(PAGED, tp=2, speculative="draft"), "f32"),
}
TIMINGS = ("decode_time_s",)

PREFIX = [(11 * i + 5) % 512 for i in range(32)]


def _tail(n, seed):
    return [(7 * i + seed) % 512 for i in range(n)]


BURSTS = [
    [(PREFIX + _tail(10, 1), 8), (PREFIX + _tail(13, 2), 6), (_tail(20, 3), 7),
     (_tail(9, 9), 5)],
    [(PREFIX + _tail(7, 4), 8), (PREFIX + _tail(12, 5), 5), (_tail(5, 6), 9)],
]


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return {"f32": (p, torch_params(p)), "int8": quantized_params(8), "int4": quantized_params(4)}


async def _gen(engine, prompt, n):
    return [tok async for tok in engine.generate(prompt, max_new_tokens=n)]


async def _serve(engine):
    """Both bursts, then each first-burst request's second turn (its prompt,
    its answer and a new tail: pages its first turn decoded, on whichever
    dp group served it) → (streams, counters)."""
    await engine.start()
    try:
        streams = []
        for burst in BURSTS:
            streams += await asyncio.gather(*[_gen(engine, p, n) for p, n in burst])
        second = [
            (p + out + _tail(3 + i, 20 + i), 4)
            for i, ((p, _), out) in enumerate(zip(BURSTS[0], streams))
        ]
        streams += await asyncio.gather(*[_gen(engine, p, n) for p, n in second])
        counters = engine.stats.counters()
        for name in TIMINGS + PORT_ONLY_COUNTERS:
            counters.pop(name, None)
        return streams, counters
    finally:
        await engine.stop()


def _runtime(cls, spec_cls, cfg, over):
    over = dict(over)
    if over.get("speculative") == "draft":
        over["speculative"] = spec_cls(k=3, draft=cfg)
    return cls(**BASE, **over)


_REFERENCE: dict = {}


async def _reference(weights, name):
    if name not in _REFERENCE:
        over, kind = CONFIGS[name]
        rt = _runtime(JaxRuntime, JaxSpec, JAX_CFG, over)
        params = weights[kind][0]
        draft = dict(draft_params=params) if rt.speculative is not None else {}
        engine = JaxEngine(JAX_CFG, dataclasses.replace(rt, attention_impl="xla"),
                           params=params, mesh=jax_mesh(tp=rt.tp, dp=rt.dp), **draft)
        _REFERENCE[name] = await _serve(engine)
    return _REFERENCE[name]


def _port(weights, name):
    over, kind = CONFIGS[name]
    rt = _runtime(RuntimeConfig, SpecConfig, TORCH_CFG, over)
    params = weights[kind][1]
    draft = dict(draft_params=params) if rt.speculative is not None else {}
    return InferenceEngine(TORCH_CFG, rt, params=params, device="cpu", **draft)


def _assert_no_leak(engine):
    assert sorted(engine._free) == list(range(BASE["max_batch_size"]))
    assert not engine._active and engine._pend is None and engine._inflight is None
    if engine._paged:
        alloc = engine._page_alloc
        cached = engine._prefix.size if engine._prefix is not None else 0
        assert alloc.free_pages + cached == alloc.num_pages - 1


@pytest.mark.parametrize("name", list(CONFIGS))
async def test_streams_and_counters_match_reference(weights, name):
    ref_streams, ref_counters = await _reference(weights, name)
    import torch.distributed as dist

    from calfkit_tpu_torch.inference import distributed as D

    engine = _port(weights, name)
    workers = list(engine._workers.procs)
    assert engine._layout is not None and engine._rank == 0
    # the group's store is a TCP store this process hosts: the descriptors
    # the channel deletes are freed (a FileStore would grow for ever)
    assert isinstance(D._STORE, dist.TCPStore)
    streams, counters = await _serve(engine)
    assert streams == ref_streams
    assert counters == ref_counters
    _assert_no_leak(engine)
    assert engine._workers is None and engine._channel is None
    assert all(not p.is_alive() and p.exitcode == 0 for p in workers)


def test_rank_layouts_follow_the_reference_rule(weights):
    """The layouts the configurations above exercise: tp=4 splits the 4
    query heads to 1 a rank over replicated K/V (each rank attends kv
    head t // 2), tp=8 replicates the attention and splits the MLP."""
    from calfkit_tpu_torch.inference import sharding as Sh

    cfg = TORCH_CFG
    tp4 = [Sh.layout_of(cfg, Sh.make_mesh(tp=4, device_type="cpu"), r) for r in range(4)]
    assert [(lay.heads, lay.kv, lay.ff, lay.vocab) for lay in tp4] == [
        (True, (t // 2, 1), True, (128 * t, 128)) for t in range(4)]
    tp8 = Sh.layout_of(cfg, Sh.make_mesh(tp=8, device_type="cpu"), 5)
    assert (tp8.heads, tp8.kv, tp8.ff, tp8.vocab) == (False, (0, 2), True, (320, 64))
    dp = Sh.layout_of(cfg, Sh.make_mesh(tp=2, dp=2, device_type="cpu"), 3)
    assert (dp.t, dp.d, dp.batch_rows(4), dp.batch_rows(3)) == (1, 1, (2, 2), None)


async def test_dead_worker_ends_requests_with_the_typed_fault(weights):
    """Rank 1 killed mid-stream: rank 0's next collective fails at once
    (the dead rank's sockets close), and the request ends with the
    engine's typed, retriable fault, long before the group's timeout."""
    from calfkit_tpu_torch.exceptions import EngineWedgedError

    engine = InferenceEngine(TORCH_CFG, RuntimeConfig(**BASE, tp=2), params=weights["f32"][1],
                             device="cpu")
    await engine.start()
    try:
        stream = engine.generate(list(range(1, 6)), max_new_tokens=120)
        await stream.__anext__()
        engine._workers.procs[0].kill()

        async def drain():
            async for _ in stream:
                pass

        with pytest.raises(EngineWedgedError):
            await asyncio.wait_for(drain(), timeout=60)
        assert engine.stats.watchdog_faulted == 1
    finally:
        await engine.stop()
    assert engine._workers is None


def test_a_rank_that_dies_while_starting_fails_the_spawn_at_once():
    """Rank 1 dies before it joins (it cannot load its arguments): rank 0
    stops waiting at the group's barrier as soon as it sees the process
    gone, long before the group's timeout, and joins no group."""
    import time

    import torch.distributed as dist

    from calfkit_tpu_torch.inference import distributed as D
    from tests._torch_ranks import Unloadable

    started = time.monotonic()
    with pytest.raises(D.RankFault, match="gone"):
        D.spawn_workers(2, TORCH_CFG, RuntimeConfig(**BASE, tp=2), [Unloadable()], 0, "cpu",
                        [None])
    assert time.monotonic() - started < 60 < D.GROUP_TIMEOUT_S
    assert not dist.is_initialized()


def test_a_teardown_that_does_not_end_is_a_rank_fault(monkeypatch):
    """Leaving the group runs on a thread with a bound: a teardown that
    blocks (a communicator still held) is reported, never waited for."""
    import time

    from calfkit_tpu_torch.inference import distributed as D

    monkeypatch.setattr(D, "shutdown_group", lambda: time.sleep(5))
    monkeypatch.setattr(D.Workers, "LEAVE_S", 0.2)
    with pytest.raises(D.RankFault, match="teardown did not end"):
        D.Workers([]).close()


def test_fresh_engine_stats_are_zero():
    """The counters compared above start from zero on both sides."""
    assert all(v == 0 for k, v in EngineStats().counters().items() if k != "occupancy_hist")
