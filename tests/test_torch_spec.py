"""The PyTorch port's speculative decoding against ``calfkit_tpu``'s.

Both engines serve the same converted ``debug`` weights (f32 params, the
preset's bf16 KV cache) on the CPU; the JAX engine runs its Pallas kernels in
interpret mode, the semantics of the port's ragged kernels and their plain
versions.  Spec-on greedy streams and the speculation counters must be
IDENTICAL between the two engines, across KV layouts, admission lanes and
drafters.  Spec-on against spec-off inside the port is held with f32 KV: in
bf16 the verify and decode paths round their probabilities at different
places, which can flip a near-tie (the reference's own weak-draft test fails
so, on a logit gap of 1.05e-3).
"""

import asyncio

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.config import SpecConfig as JaxSpec  # noqa: E402
from calfkit_tpu.inference.config import preset as jax_preset  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu.inference.spec import NgramDrafter as JaxNgram  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig, preset  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from calfkit_tpu_torch.inference.sampler import SamplingParams  # noqa: E402
from calfkit_tpu_torch.inference.spec import NgramDrafter  # noqa: E402
from tests._torch_port import JAX_CFG, TORCH_CFG, jax_params, torch_params  # noqa: E402

RT = dict(
    max_batch_size=4, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4,
    page_size=16,
)
COUNTERS = (
    "spec_proposed", "spec_accepted", "spec_emitted", "spec_rows", "decode_dispatches",
    "prefix_hits",
)
PROMPTS = [[1, 5, 9, 13], list(range(2, 34)), [7, 8, 9] * 5, [2, 4, 6]]
PREFIX = list(range(2, 50))  # three full pages of 16: a cacheable prefix
# The draft model's config: the target's, with an f32 KV cache.  The JAX
# drafter runs the XLA attention, whose probabilities are rounded to the
# cache dtype whatever ``attention_impl`` says, while the port's draft runs
# the prefill kernel's plain version (f32 probabilities); with an f32 draft
# cache the two compute the same function, so proposals, and the counters,
# can be held equal.  The draft reads the target's own weights.
JAX_DRAFT = jax_preset("debug", dtype="float32")
TORCH_DRAFT = preset("debug", dtype="float32")

# name → (runtime overrides, k, draft model?, bursts of (prompt, max_new_tokens))
CONFIGS = {
    "dense-k4": (dict(), 4, False, [[(p, 16) for p in PROMPTS]]),
    "paged-k3": (dict(kv_layout="paged"), 3, False, [[(p, 16) for p in PROMPTS]]),
    "chunked": (
        dict(chunked_prefill=True, ragged_waves=False), 4, False,
        [[(list(range(2, 50)), 16), ([7, 8, 9] * 5, 12)]],
    ),
    # six requests over four slots, twice: slot churn, prefix reuse in the
    # second burst, admission waves riding the ragged lane
    "paged-chunked-prefix-ragged": (
        dict(kv_layout="paged", chunked_prefill=True, prefix_cache=True), 4, False,
        [[(PREFIX + [i], 12) for i in range(6)], [(PREFIX + [9, i], 12) for i in range(6)]],
    ),
    "draft-is-target": (dict(), 4, True, [[([1, 5, 9, 13], 20), (list(range(3, 20)), 20)]]),
    # 16 prompt tokens, room for 15 new: the verify wave shrinks to fit
    "near-max-seq": (dict(max_seq_len=32), 4, False, [[(list(range(2, 18)), 100)]]),
}


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


async def _gen(engine, prompt, n, **kw):
    return [tok async for tok in engine.generate(prompt, max_new_tokens=n, **kw)]


async def _serve_bursts(engine, bursts):
    await engine.start()
    try:
        streams = []
        for burst in bursts:
            streams += await asyncio.gather(*[_gen(engine, p, n) for p, n in burst])
        return streams, {name: getattr(engine.stats, name) for name in COUNTERS}
    finally:
        await engine.stop()


def _port(weights, k=4, draft=False, **over):
    spec = SpecConfig(k=k, draft=TORCH_DRAFT if draft else None)
    return InferenceEngine(
        TORCH_CFG, RuntimeConfig(**{**RT, **over}, speculative=spec), params=weights[1],
        draft_params=weights[1] if draft else None, device="cpu",
    )


_REFERENCE: dict = {}


async def _reference(weights, name):
    """The JAX engine's streams and counters under configuration ``name``,
    computed once per configuration for this module."""
    if name not in _REFERENCE:
        over, k, draft, bursts = CONFIGS[name]
        runtime = JaxRuntime(
            **{**RT, **over}, speculative=JaxSpec(k=k, draft=JAX_DRAFT if draft else None),
            attention_impl="pallas_interpret",
        )
        engine = JaxEngine(
            JAX_CFG, runtime, params=weights[0], draft_params=weights[0] if draft else None
        )
        _REFERENCE[name] = await _serve_bursts(engine, bursts)
    return _REFERENCE[name]


def _assert_no_leak(engine):
    """Every slot free; every page free or held by the prefix cache."""
    assert sorted(engine._free) == list(range(engine.runtime.max_batch_size))
    assert not engine._active and engine._pend is None and engine._inflight is None
    if engine._paged:
        alloc = engine._page_alloc
        cached = engine._prefix.size if engine._prefix is not None else 0
        assert alloc.free_pages + cached == alloc.num_pages - 1
        assert not alloc.held_slots


@pytest.mark.parametrize("name", list(CONFIGS))
async def test_streams_and_counters_match_reference(weights, name):
    over, k, draft, bursts = CONFIGS[name]
    ref_streams, ref_counters = await _reference(weights, name)
    engine = _port(weights, k, draft, **over)
    streams, counters = await _serve_bursts(engine, bursts)
    assert streams == ref_streams
    assert counters == ref_counters
    _assert_no_leak(engine)
    assert counters["spec_rows"] > 0 and counters["spec_proposed"] > 0
    if name == "paged-chunked-prefix-ragged":
        assert counters["prefix_hits"] >= 6
    if name == "draft-is-target":
        assert engine.stats.acceptance_rate > 0.9 and engine.stats.tokens_per_dispatch > 2.0
    if name == "near-max-seq":
        assert len(streams[0]) < 100  # the sequence bound engaged


async def test_greedy_row_unperturbed_by_sampled_neighbors(weights):
    """Sampled rows in the same verify waves leave a greedy row's stream
    exactly as the JAX engine decodes it alone."""
    ref_streams, _ = await _reference(weights, "dense-k4")
    engine = _port(weights, k=3)
    await engine.start()
    try:
        sampled = [
            _gen(engine, [3 + i, 7, 11], 10, sampling=SamplingParams(1.5, top_p=0.9), seed=i)
            for i in (1, 2)
        ]
        crowd, *rest = await asyncio.gather(_gen(engine, [2, 4, 6], 10), *sampled)
        again = await asyncio.gather(*[
            _gen(engine, [3 + i, 7, 11], 10, sampling=SamplingParams(1.5, top_p=0.9), seed=i)
            for i in (1, 2)
        ])
    finally:
        await engine.stop()
    assert crowd == ref_streams[PROMPTS.index([2, 4, 6])][:10]
    assert rest == again and all(len(s) == 10 for s in rest)  # seeded: reproducible
    assert engine.stats.spec_rows > 0


async def test_cancel_mid_wave_holds_no_pages(weights):
    engine = _port(weights, k=4, kv_layout="paged")
    await engine.start()
    try:
        agen = engine.generate([7, 8, 9] * 5, max_new_tokens=64)
        got = 0
        async for _ in agen:
            got += 1
            if got >= 3:
                break  # abandon while speculation waves run
        await agen.aclose()
        assert len(await _gen(engine, [4, 5], 6)) == 6
        for _ in range(100):
            if not engine._page_alloc.held_slots and not engine._active:
                break
            await asyncio.sleep(0.01)
        assert engine.stats.cancelled_requests == 1
        _assert_no_leak(engine)
    finally:
        await engine.stop()


# --------------------------------------------------------------------------- #
# spec on against spec off, inside the port (f32 KV)
# --------------------------------------------------------------------------- #

F32_CFG = preset("debug", dtype="float32")


@pytest.mark.parametrize(
    "case",
    ["ngram-dense", "ngram-paged-chunked-prefix", "draft-is-target", "weak-draft"],
)
async def test_spec_on_equals_spec_off_in_f32(weights, case):
    params = weights[1]
    over = dict(kv_layout="paged", chunked_prefill=True, prefix_cache=True) \
        if case == "ngram-paged-chunked-prefix" else {}
    prompts = [[2, 4, 6, 8], [1, 5, 9, 13], [7, 8, 9] * 5, PREFIX, PREFIX + [3]]
    base = InferenceEngine(
        F32_CFG, RuntimeConfig(**{**RT, **over}), params=params, device="cpu"
    )
    draft_params = None
    if case == "weak-draft":  # other (random) weights: drafts mostly wrong
        draft_params = torch_params(jax_params(99))
    elif case == "draft-is-target":
        draft_params = params
    spec = InferenceEngine(
        F32_CFG,
        RuntimeConfig(
            **{**RT, **over},
            speculative=SpecConfig(k=3, draft=F32_CFG if draft_params is not None else None),
        ),
        params=params, draft_params=draft_params, device="cpu",
    )
    want, _ = await _serve_bursts(base, [[(p, 16)] for p in prompts])
    got, counters = await _serve_bursts(spec, [[(p, 16)] for p in prompts])
    assert got == want
    assert counters["spec_rows"] > 0
    if case == "ngram-paged-chunked-prefix":
        assert counters["prefix_hits"] >= 1
    if case == "draft-is-target":
        assert spec.stats.acceptance_rate > 0.9


# --------------------------------------------------------------------------- #
# the n-gram drafter and the constructor's refusals
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(4))
def test_ngram_proposals_match_reference(seed):
    """Random histories over a small alphabet (so tails recur), grown token
    by token through the same slots: byte-for-byte the reference's lookup,
    including its incremental per-slot buffers."""
    rng = np.random.default_rng(seed)
    k, nmax, nmin = int(rng.integers(1, 6)), int(rng.integers(1, 5)), 1
    ours = NgramDrafter(SpecConfig(k=k, ngram_max=nmax, ngram_min=nmin))
    ref = JaxNgram(JaxSpec(k=k, ngram_max=nmax, ngram_min=nmin))
    histories = {slot: [] for slot in range(3)}
    for drafter in (ours, ref):
        for slot in histories:
            drafter.admit(slot, [])
    for _ in range(60):
        for slot, history in histories.items():
            # tokens near 2**8 and 2**16 probe the byte-alignment check
            history.append(int(rng.choice([1, 2, 3, 4, 256, 257, 65536, 513])))
        entries = list(histories.items())
        assert ours.propose(entries) == ref.propose(entries)


@pytest.mark.parametrize("seed", range(3))
def test_draft_model_proposals_match_reference(weights, seed):
    """The port's proposer (one captured dispatch a catch-up width) against
    the JAX drafter's ``_propose_jit`` on the same histories, in f32: each
    round's drafts, and the widths each compiled (``_graphs`` == ``_jits``).
    Three slots grow by 0-4 tokens a round, and a slot is now and then
    retired and re-admitted with a new prompt, whose whole catch-up widens
    the batch's bucket until a row near the cache's end is re-fed from
    ``S - width``.

    A row fed nothing in a round (``cat_len`` 0) proposes nothing in both,
    but both packages still write its padded catch-up at ``base`` 0 over
    the start of its draft cache; its queries see no key, and the port's
    drafter answers them with the mean of v, as the JAX drafter's XLA
    attention does.  So every row's drafts are compared in every round,
    the rounds after one it was fed nothing in included."""
    import torch

    from calfkit_tpu.inference.sharding import make_mesh
    from calfkit_tpu.inference.spec import DraftModelDrafter as JaxDrafter
    from calfkit_tpu_torch.inference.graphs import GraphPool
    from calfkit_tpu_torch.inference.spec import DraftModelDrafter

    B, S, k = 3, 48, 3
    ref = JaxDrafter(JaxSpec(k=k, draft=JAX_DRAFT), JaxRuntime(max_batch_size=B, max_seq_len=S),
                     make_mesh(tp=1, dp=1), params=weights[0])
    ours = DraftModelDrafter(SpecConfig(k=k, draft=TORCH_DRAFT),
                             RuntimeConfig(max_batch_size=B, max_seq_len=S), "cpu",
                             params=weights[1], pool=GraphPool(torch.device("cpu")))
    rng = np.random.default_rng(seed)
    histories: dict = {}
    compared = after_empty = 0
    fed_nothing: set = set()  # slots fed nothing in an earlier round since admission

    def admit(slot):
        histories[slot] = rng.integers(1, 500, int(rng.integers(2, 24))).tolist()
        fed_nothing.discard(slot)
        for drafter in (ref, ours):
            drafter.retire(slot)
            drafter.admit(slot, histories[slot])

    for slot in range(B):
        admit(slot)
    for _ in range(16):
        entries = [(slot, list(h)) for slot, h in histories.items()]
        empty = {slot for slot, h in entries if len(h) == ours._dlen[slot]}
        got, want = ours.propose(entries), ref.propose(entries)
        for (slot, _), a, b in zip(entries, got, want):
            assert a == b, slot
            if slot not in empty:
                compared += 1
                after_empty += slot in fed_nothing
        fed_nothing |= empty
        for slot, history in histories.items():
            if len(history) > S - 6 or rng.random() < 0.1:
                admit(slot)
            else:
                history += rng.integers(1, 500, int(rng.integers(0, 5))).tolist()
    assert compared >= 20 and after_empty >= 3, (compared, after_empty)
    assert set(ours._graphs) == set(ref._jits) and len(ours._graphs) > 2
    assert all(fn.calls for fn in ours._graphs.values())


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(speculative=True, k=0), "speculative.k"),
        (dict(speculative=True, k=2, draft_params=True), "draft_params"),
        (dict(speculative=False, draft_params=True), "draft_params"),
    ],
    ids=["k-below-1", "draft-params-without-draft", "draft-params-with-spec-off"],
)
def test_constructor_refusals_match_reference(weights, kw, match):
    def build(runtime_cls, spec_cls, engine_cls, cfg, params, **extra):
        spec = spec_cls(k=kw["k"]) if kw["speculative"] else None
        return engine_cls(
            cfg, runtime_cls(**RT, speculative=spec), params=params,
            draft_params=params if kw.get("draft_params") else None, **extra,
        )

    with pytest.raises(ValueError, match=match):
        build(JaxRuntime, JaxSpec, JaxEngine, JAX_CFG, weights[0])
    with pytest.raises(ValueError, match=match):
        build(RuntimeConfig, SpecConfig, InferenceEngine, TORCH_CFG, weights[1], device="cpu")
