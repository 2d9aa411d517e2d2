"""The port's long-context lane over the ranks of a multi-process engine
(sp = tp·dp) against ``calfkit_tpu``'s on the same mesh.

The JAX engine runs on its 8-device virtual CPU mesh (``jax_mesh(tp, dp)``;
its lane's ``sp`` mesh is every device of it); the port's engine is rank 0
of a gloo group whose other ranks it spawns itself.  Both serve the f32
``debug`` weights (int8 in one configuration) through one drive: a long
prompt alone, a long prompt and two short ones submitted together, and a
longer prompt (another padded bucket); between the phases the engine
settles.  The long lane runs monolithic or chunked (prefill chunk 64, so at
sp = 4 a chunk spans two ranks' blocks of 32), overlapped or lockstep, at
tp = 2, dp = 2, tp = 2 x dp = 2 and tp = 4 (the debug preset's 2 kv heads
replicated and narrowed: each rank's queries read one of them).

What must be EQUAL: every greedy stream, every ``EngineStats`` counter but
the timings (``long_requests`` and ``long_dispatches`` among them) and the
journal (times masked).  Each rank's prefix scratch holds 1/sp of the
positions of the one-device scratch, with every kv head, and its fresh
cache the kv heads of its tp shard; every worker has exited afterwards.
"""

import asyncio

import pytest

jax = pytest.importorskip("jax")

from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.config import preset as jax_preset  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu.inference.sharding import make_mesh as jax_mesh  # noqa: E402
from calfkit_tpu.observability import flightrec as jax_flightrec  # noqa: E402
from calfkit_tpu_torch.inference import sharding as Sh  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, preset  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from calfkit_tpu_torch.observability import flightrec as port_flightrec  # noqa: E402
from tests._torch_port import (  # noqa: E402
    PORT_ONLY_COUNTERS,
    jax_params,
    journal_rows,
    long_idle,
    quantized_params,
    torch_params,
)
from chip_smoke import _rank_long  # noqa: E402  (a rank's long-lane buffers)

JAX_CFG = jax_preset("debug", dtype="float32")
TORCH_CFG = preset("debug", dtype="float32")

BASE = dict(
    max_batch_size=2, max_seq_len=64, prefill_chunk=64, decode_steps_per_dispatch=4,
    long_context=True, long_new_cap=12, long_max_prompt=256, flightrec_events=1 << 12,
)
PAGED = dict(kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True)
LOCKSTEP = dict(overlap_dispatch=False)
# name → (runtime over BASE, weights); "chunked" runs the chunked long
# prefill (the paged short lane), else the monolithic one
CONFIGS = {
    "tp2-monolithic": (dict(tp=2), "f32"),
    "dp2-chunked": (dict(PAGED, dp=2), "f32"),
    "tp2xdp2-monolithic-lockstep": (dict(tp=2, dp=2, **LOCKSTEP), "f32"),
    "tp2xdp2-chunked": (dict(PAGED, tp=2, dp=2), "f32"),
    "tp4-replicated-kv-chunked": (dict(PAGED, tp=4), "f32"),
    "tp2-int8-chunked-lockstep": (dict(PAGED, tp=2, quantization="int8", **LOCKSTEP), "int8"),
}
# the long prompts (each >= max_seq_len 64): padded to 128, 128 and 256
LONG = {
    "alone": [(7 * i + 3) % 512 for i in range(100)],
    "mixed": [(3 * i + 1) % 512 for i in range(70)],
    "longer": [(5 * i + 2) % 512 for i in range(150)],
}
SHORT = [[5, 6, 7], [9, 10, 11, 12]]


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return {"f32": (p, torch_params(p)), "int8": quantized_params(8)}


async def _drive(engine, names, ranks: bool) -> dict:
    """The drive (module docstring) on a fresh engine of either package →
    streams by correlation id, counters, journal, and (``ranks``) every
    rank's long-lane buffers, read before ``stop()``."""
    streams: dict = {}

    async def run(corr, prompt, n):
        streams[corr] = [t async for t in engine.generate(prompt, max_new_tokens=n, corr=corr)]

    async def phase(*jobs):
        await asyncio.gather(*jobs)
        for _ in range(400):
            if long_idle(engine):
                break
            await asyncio.sleep(0.01)
        assert long_idle(engine)
        await asyncio.sleep(0.02)

    await engine.start()
    try:
        await phase(run("alone", LONG["alone"], 8))
        await phase(run("mixed-long", LONG["mixed"], 12),
                    *[run(f"mixed-{i}", p, 6) for i, p in enumerate(SHORT)])
        await phase(run("longer", LONG["longer"], 5))
        buffers = engine.on_ranks(_rank_long) if ranks else None
    finally:
        await engine.stop()
    counters = engine.stats.counters()
    for name in ("decode_time_s", *PORT_ONLY_COUNTERS):  # the reference has none of these
        counters.pop(name, None)
    return dict(streams=streams, counters=counters, journal=journal_rows(engine, names),
                buffers=buffers)


_RUNS: dict = {}


def _runs(weights, name) -> "tuple[dict, dict, list]":
    """(the JAX engine's drive, the port's, the port's worker processes)
    for configuration ``name``, run once per process (each drive on an
    event loop of its own: the tests are not bound by the async tests' 60
    s, which a loaded host can take for both drives together)."""
    if name not in _RUNS:
        over, kind = CONFIGS[name]
        jax_rt = JaxRuntime(**BASE, **over, attention_impl="xla")
        ref = asyncio.run(_drive(
            JaxEngine(JAX_CFG, jax_rt, params=weights[kind][0],
                      mesh=jax_mesh(tp=jax_rt.tp, dp=jax_rt.dp)),
            jax_flightrec.EVENT_NAMES, ranks=False,
        ))
        engine = InferenceEngine(TORCH_CFG, RuntimeConfig(**BASE, **over),
                                 params=weights[kind][1], device="cpu")
        workers = list(engine._workers.procs)
        port = asyncio.run(_drive(engine, port_flightrec.EVENT_NAMES, ranks=True))
        port["closed"] = engine._workers is None and engine._channel is None
        _RUNS[name] = ref, port, workers
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sp_lane_streams_equal_reference(weights, name):
    ref, port, _ = _runs(weights, name)
    assert port["streams"] == ref["streams"]
    lens = {corr: len(s) for corr, s in port["streams"].items()}
    assert lens == {"alone": 8, "mixed-long": 12, "mixed-0": 6, "mixed-1": 6, "longer": 5}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sp_lane_counters_equal_reference(weights, name):
    ref, port, _ = _runs(weights, name)
    assert port["counters"] == ref["counters"]
    c = port["counters"]
    assert c["long_requests"] == 3 and c["long_dispatches"] > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sp_lane_journal_equals_reference(weights, name):
    ref, port, _ = _runs(weights, name)
    assert port["journal"] == ref["journal"]
    events = [row[0] for row in port["journal"]]
    assert events.count("ADMIT_LONG") == 3, events


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sp_lane_holds_a_block_per_rank(weights, name):
    """Each rank's prefix scratch is its 1/sp block of the one-device
    scratch (every kv head), its fresh cache the kv heads of its tp shard,
    and every worker exits 0 after ``stop()``."""
    _, port, workers = _runs(weights, name)
    over, _ = CONFIGS[name]
    tp, dp = over.get("tp", 1), over.get("dp", 1)
    sp = tp * dp
    L, K, hd = TORCH_CFG.n_layers, TORCH_CFG.n_kv_heads, TORCH_CFG.head_dim
    mesh = Sh.make_mesh(tp=tp, dp=dp, device_type="cpu")
    # one device's scratch: K and V in f32 for the longest prompt's 256
    # padded positions
    one_device_bytes = 2 * 4 * L * K * 256 * hd
    assert [b["sp_index"] for b in port["buffers"]] == list(range(sp))
    for rank, b in enumerate(port["buffers"]):
        assert b["scratch"] == [L, 1, K, 256 // sp, hd]
        assert b["scratch_bytes"] * sp == one_device_bytes
        kv = Sh.layout_of(TORCH_CFG, mesh, rank).kv_heads
        assert b["fresh"] == [L, 1, kv, 12, hd]
    assert port["closed"]
    assert all(not p.is_alive() and p.exitcode == 0 for p in workers)
