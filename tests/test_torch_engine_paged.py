"""The PyTorch port's paged / chunked / ragged / prefix-cache engine against
``calfkit_tpu``'s engine.

Both engines serve the same converted ``debug`` weights on the CPU; the JAX
engine runs its Pallas kernels in interpret mode.  Two bursts are served one
after the other: requests sharing a 32-token prefix plus unrelated prompts,
then more of the same prefix (the second burst reuses the first's cached
pages).  Greedy streams must be IDENTICAL, and so must the scheduler's
outcomes: prefix hits, reused tokens, evictions, allocation stalls, absorbed
prefill tokens and unified dispatches.
"""

import asyncio

import pytest

jax = pytest.importorskip("jax")

from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from tests._torch_port import JAX_CFG, TORCH_CFG, jax_params, torch_params  # noqa: E402

BASE = dict(
    max_batch_size=4, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4,
    kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True,
)
CONFIGS = {
    "ragged": {},
    "bifurcated": dict(ragged_waves=False),
    "dense-chunked": dict(kv_layout="dense", prefix_cache=False),
    "evicting": dict(num_kv_pages=16),
}
COUNTERS = (
    "prefix_hits", "prefix_reused_tokens", "prefix_evictions", "alloc_stalls",
    "prefill_absorbed_tokens", "unified_dispatches",
)

PREFIX = [(11 * i + 5) % 512 for i in range(32)]


def _tail(n, seed):
    return [(7 * i + seed) % 512 for i in range(n)]


BURSTS = [
    [  # buckets 48, 48, 32: the second wave's chunks ride the first's decode
        (PREFIX + _tail(10, 1), 8),
        (PREFIX + _tail(13, 2), 6),
        (_tail(20, 3), 7),
    ],
    [  # reuse of the cached prefix pages, and an exact repeat
        (PREFIX + _tail(7, 4), 8),
        (PREFIX + _tail(12, 5), 5),
        (_tail(5, 6), 9),
        (PREFIX + _tail(10, 1), 4),
    ],
]


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


async def _gen(engine, prompt, n, **kw):
    return [tok async for tok in engine.generate(prompt, max_new_tokens=n, **kw)]


async def _serve_bursts(engine):
    await engine.start()
    try:
        streams = []
        for burst in BURSTS:
            streams += await asyncio.gather(*[_gen(engine, p, n) for p, n in burst])
        return streams, {name: getattr(engine.stats, name) for name in COUNTERS}
    finally:
        await engine.stop()


_REFERENCE: dict = {}


async def _reference(weights, name):
    """The JAX engine's streams and counters under configuration ``name``,
    computed once per configuration for this module."""
    if name not in _REFERENCE:
        runtime = JaxRuntime(**{**BASE, **CONFIGS[name]}, attention_impl="pallas_interpret")
        _REFERENCE[name] = await _serve_bursts(JaxEngine(JAX_CFG, runtime, params=weights[0]))
    return _REFERENCE[name]


def _port(weights, **over):
    return InferenceEngine(
        TORCH_CFG, RuntimeConfig(**{**BASE, **over}), params=weights[1], device="cpu"
    )


def _assert_no_leak(engine):
    """Every page is free or held by the prefix cache, every slot is free."""
    assert sorted(engine._free) == list(range(BASE["max_batch_size"]))
    assert not engine._active and engine._pend is None and engine._inflight is None
    if engine._paged:
        alloc = engine._page_alloc
        cached = engine._prefix.size if engine._prefix is not None else 0
        assert alloc.free_pages + cached == alloc.num_pages - 1
        assert not alloc.held_slots
        assert len(set(alloc._free)) == len(alloc._free)  # nothing freed twice


@pytest.mark.parametrize("name", list(CONFIGS))
async def test_streams_and_counters_match_reference(weights, name):
    ref_streams, ref_counters = await _reference(weights, name)
    engine = _port(weights, **CONFIGS[name])
    streams, counters = await _serve_bursts(engine)
    assert streams == ref_streams
    assert [len(s) for s in streams] == [n for burst in BURSTS for _, n in burst]
    assert counters == ref_counters
    _assert_no_leak(engine)
    # each configuration exercises what it is here for
    if name in ("ragged", "dense-chunked", "evicting"):
        assert counters["unified_dispatches"] > 0
    if name != "dense-chunked":
        assert counters["prefix_hits"] >= 3
    if name == "evicting":
        assert counters["prefix_evictions"] > 0 and counters["alloc_stalls"] > 0


async def test_paged_matches_dense_streams(weights):
    """The paged layout computes what the dense layout computes."""
    paged, _ = await _serve_bursts(_port(weights))
    dense, _ = await _serve_bursts(_port(weights, kv_layout="dense", prefix_cache=False))
    assert paged == dense


async def test_paged_cancel_mid_flight_frees_pages_once(weights):
    engine = _port(weights)
    await engine.start()
    try:
        agen = engine.generate(PREFIX + _tail(9, 7), max_new_tokens=60, corr="c-1")
        got = []
        async for token in agen:
            got.append(token)
            if len(got) >= 2:
                break
        await agen.aclose()  # cancel with a dispatch in flight
        for _ in range(200):
            await asyncio.sleep(0.01)
            if engine._pend is None and not engine._active:
                break
        assert engine.stats.cancelled_requests == 1
        _assert_no_leak(engine)
        assert engine._prefix.size > 0  # the prompt's full pages stay cached
        # the engine still serves, and reuses the cancelled request's pages
        assert len(await _gen(engine, PREFIX + _tail(9, 8), 4)) == 4
        assert engine.stats.prefix_hits == 1
        _assert_no_leak(engine)
    finally:
        await engine.stop()


async def test_request_larger_than_the_pool_is_refused(weights):
    from calfkit_tpu_torch.exceptions import InferenceError

    engine = _port(weights, num_kv_pages=4)
    await engine.start()
    try:
        with pytest.raises(InferenceError, match="KV pages"):
            await _gen(engine, list(range(40)), 8)
    finally:
        await engine.stop()


@pytest.mark.parametrize(
    "over",
    [
        dict(chunked_prefill=False), dict(page_size=12),
        dict(max_seq_len=120), dict(kv_layout="dense"),
    ],
    ids=[
        "prefix-cache-without-chunked", "page-does-not-divide-chunk",
        "chunk-does-not-divide-max-seq", "prefix-cache-without-paged",
    ],
)
def test_configuration_errors_match_reference(weights, over):
    with pytest.raises(ValueError):
        JaxEngine(JAX_CFG, JaxRuntime(**{**BASE, **over}), params=weights[0])
    with pytest.raises(ValueError):
        _port(weights, **over)
