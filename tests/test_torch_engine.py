"""The PyTorch port's serving engine against ``calfkit_tpu``'s engine.

Both engines serve the same converted ``debug`` weights (f32 params, the
preset's bf16 KV cache) on the CPU.  The JAX engine runs its Pallas kernels
in interpret mode, which are the semantics the port's kernels and their
plain versions implement, so greedy token streams must be IDENTICAL — for
concurrent requests, a stop token mid-block, a generation bound inside a
block, and overlapped as well as lockstep dispatch.

Cancellation mid-flight and seeded sampling are held to the port's own
contracts: a cancelled request frees its slot exactly once, and a seeded
stream depends on its seed alone, not on the batch around it (``jax.random``
and the port's counter-based draws cannot match bit for bit).
"""

import asyncio

import pytest

jax = pytest.importorskip("jax")

from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from calfkit_tpu_torch.inference.sampler import SamplingParams  # noqa: E402
from tests._torch_port import JAX_CFG, TORCH_CFG, jax_params, torch_params  # noqa: E402

RT = dict(
    max_batch_size=4, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4
)
JOBS = [  # (prompt, max_new_tokens): buckets 16 and 32, one request per slot
    ([1, 2, 3], 10),
    (list(range(5, 25)), 12),
    ([7] * 30, 9),
    ([9, 8], 11),
]


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


async def _gen(engine, prompt, n, **kw):
    return [tok async for tok in engine.generate(prompt, max_new_tokens=n, **kw)]


async def _serve(engine, jobs):
    await engine.start()
    try:
        return await asyncio.gather(*[_gen(engine, p, n, **kw) for p, n, kw in jobs])
    finally:
        await engine.stop()


def _jobs(**kw):
    return [(p, n, dict(kw)) for p, n in JOBS]


_REFERENCE: dict = {}


async def _reference(weights, jobs):
    """The JAX engine's streams for ``jobs`` (overlapped; its own tests hold
    overlap == lockstep), computed once per job list for this module."""
    key = repr(jobs)
    if key not in _REFERENCE:
        runtime = JaxRuntime(**RT, attention_impl="pallas_interpret")
        _REFERENCE[key] = await _serve(JaxEngine(JAX_CFG, runtime, params=weights[0]), jobs)
    return _REFERENCE[key]


def _port(weights, overlap=True, **over):
    runtime = RuntimeConfig(**{**RT, **over}, overlap_dispatch=overlap)
    return InferenceEngine(TORCH_CFG, runtime, params=weights[1], device="cpu")


@pytest.mark.parametrize("overlap", [True, False])
async def test_greedy_streams_match_reference(weights, overlap):
    jobs = _jobs()
    ref = await _reference(weights, jobs)
    engine = _port(weights, overlap)
    out = await _serve(engine, jobs)
    assert out == ref
    assert [len(s) for s in out] == [n for _, n in JOBS]
    assert len(engine._free) == RT["max_batch_size"] and not engine._active
    if not overlap:
        assert engine.stats.overlap_wasted_tokens == 0


async def test_overlap_matches_lockstep(weights):
    jobs = _jobs()
    on = await _serve(_port(weights, overlap=True), jobs)
    off = await _serve(_port(weights, overlap=False), jobs)
    assert on == off


@pytest.mark.parametrize("overlap", [True, False])
async def test_stop_token_mid_block(weights, overlap):
    plain = await _serve(_port(weights), _jobs())
    # stop on request 0's 6th token: inside the second decode block
    stop = plain[0][5]
    jobs = [(p, n, dict(stop_tokens=frozenset({stop}))) for p, n in JOBS]
    ref = await _reference(weights, jobs)
    out = await _serve(_port(weights, overlap), jobs)
    assert out == ref
    assert out[0] == plain[0][: plain[0].index(stop)]


@pytest.mark.parametrize("overlap", [True, False])
async def test_bound_inside_block(weights, overlap):
    # 1 token from prefill + 4-step blocks: 6 and 7 end inside a block
    jobs = [([3, 1, 4], 6, {}), ([1, 5, 9, 2], 7, {}), ([6], 1, {})]
    ref = await _reference(weights, jobs)
    out = await _serve(_port(weights, overlap), jobs)
    assert out == ref and [len(s) for s in out] == [6, 7, 1]


async def test_cancel_mid_flight_frees_once(weights):
    engine = _port(weights, overlap=True)
    await engine.start()
    try:
        agen = engine.generate([1, 2, 3], max_new_tokens=64, corr="c-1")
        got = []
        async for token in agen:
            got.append(token)
            if len(got) >= 2:
                break
        request = next(iter(engine._active.values()))
        await agen.aclose()  # cancel with a dispatch in flight
        for _ in range(100):
            await asyncio.sleep(0.01)
            if engine._pend is None and not engine._active:
                break
        assert not engine._active and engine._pend is None
        assert sorted(engine._free) == list(range(RT["max_batch_size"]))
        assert engine.stats.cancelled_requests == 1
        while not request.out.empty():
            request.out.get_nowait()
        for _ in range(10):
            await asyncio.sleep(0.005)
        assert request.out.empty(), "delivery to a cancelled consumer after the reap"
        # cancel by correlation id, then the engine still serves
        agen2 = engine.generate([4, 5], max_new_tokens=64, corr="c-2")
        first = await agen2.__anext__()
        assert isinstance(first, int)
        assert engine.cancel_correlation("c-2") == 1
        rest = [tok async for tok in agen2]
        assert len(rest) < 63 and engine.stats.cancel_propagated == 1
        assert len(await _gen(engine, [4, 5], 4)) == 4
        assert sorted(engine._free) == list(range(RT["max_batch_size"]))
    finally:
        await engine.stop()


async def test_sampled_stream_independent_of_batch(weights):
    sampling = SamplingParams(temperature=0.9, top_k=40, top_p=0.95)
    job = ([2, 7, 1, 8], 10, dict(sampling=sampling, seed=1234))
    alone = await _serve(_port(weights), [job])
    crowded = await _serve(_port(weights), [([5] * 20, 7, {}), job, ([3, 3], 9, {})])
    assert crowded[1] == alone[0]
    other_seed = await _serve(_port(weights), [(job[0], 10, dict(sampling=sampling, seed=99))])
    assert other_seed[0] != alone[0]


@pytest.mark.parametrize(
    "over",
    [
        dict(kv_layout="paged"), dict(kv_layout="ring"),
        dict(speculative=SpecConfig(k=0)),
        dict(quantization="fp8"), dict(tp=2, long_context=True), dict(prefix_cache=True),
        dict(attention_impl="xla"),
    ],
    ids=[
        "paged-page64-does-not-divide-chunk16", "unknown-kv-layout",
        "speculative", "unsupported-quantization", "tp2-long-lane",
        "prefix-cache-without-paged", "attention-impl-xla",
    ],
)
def test_later_slices_raise(weights, over):
    """Configurations of later slices (the long lane over several ranks:
    tp/dp themselves are served since the multi-device slice), and the
    reference's own refusals (speculation is served since the spec slice:
    k < 1 still raises)."""
    with pytest.raises(ValueError):
        _port(weights, **over)


@pytest.mark.parametrize(
    "kw", [dict(deadline=1e12), dict(lease=("l", 5.0)), dict(priority="batch")],
    ids=["deadline", "lease", "priority"],
)
async def test_request_knobs_serve_as_reference(weights, kw):
    """A far deadline, a never-beaten lease and the batch class are served
    as the JAX engine serves them: the same streams, nothing reaped."""
    jobs = [(p, n, dict(kw)) for p, n in JOBS]
    ref = await _reference(weights, jobs)
    engine = _port(weights)
    out = await _serve(engine, jobs)
    assert out == ref and [len(s) for s in out] == [n for _, n in JOBS]
    assert engine.stats.expired_requests == engine.stats.orphaned_requests == 0
