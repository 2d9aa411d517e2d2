"""The PyTorch engine's long-context lane against ``calfkit_tpu``'s engine.

One scripted drive (``tests/_torch_port.py:long_lane_drill``) runs through
both engines, built from the same f32 debug weights under one virtual wall
clock, in six configurations (``LONG_CONFIGS``): dense (the monolithic long
prefill), paged + prefix cache + chunked prefill with ragged waves (the
chunked long prefill) and that with speculation, each overlapped and
lockstep; the JAX engine runs its Pallas kernels in interpret mode on its
default one-device mesh, so its lane's ring is sp = 1.  The drive holds the
cases of the reference's ``TestLongContextLane``: a long prompt alone, long
and short requests interleaved, cancels mid-decode and mid chunked prefill
with the lane serving again after them, a budget over ``long_new_cap``, a
prompt over ``long_max_prompt``, short streams progressing during a chunked
long prefill; and a deadline, a lapsed lease and a ``max_pending`` shed on
the long lane.

What must be EQUAL between the two engines: the full greedy stream or the
typed error of every request, every ``EngineStats`` counter
(``long_requests``, ``long_dispatches``, ``decode_dispatches`` and
``overlap_wasted_tokens`` among them) and the journal (times masked).  And
in f32: the long lane's stream equals the short lane's of a roomier engine,
and the chunked long prefill's equals the monolithic one's.
"""

import asyncio

import pytest

jax = pytest.importorskip("jax")

from calfkit_tpu.exceptions import InferenceError as JaxInferenceError  # noqa: E402
from calfkit_tpu.inference.client import JaxLocalModelClient  # noqa: E402
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu.models import messages as JM  # noqa: E402
from calfkit_tpu_torch.exceptions import InferenceError  # noqa: E402
from calfkit_tpu_torch.inference import TorchLocalModelClient  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, preset  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine, _check_runtime  # noqa: E402
from calfkit_tpu_torch.inference.tokenizer import ByteTokenizer  # noqa: E402
from calfkit_tpu_torch.models import user_message  # noqa: E402
from tests._torch_port import (  # noqa: E402
    LONG_BASE,
    LONG_CONFIGS,
    LONG_PROMPTS,
    Pace,
    jax_params,
    long_drills,
    to_mesh,
    torch_params,
)
from calfkit_tpu.inference.config import preset as jax_preset  # noqa: E402

TORCH_F32 = preset("debug", dtype="float32")
JAX_F32 = jax_preset("debug", dtype="float32")
# the client's turns render to 165 tokens: the default ceiling, 8 x max_seq_len
CLIENT_RT = dict(LONG_BASE, long_max_prompt=0)
SHORT_ROOMY = dict(max_batch_size=2, max_seq_len=256, prefill_chunk=16,
                   decode_steps_per_dispatch=4)


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


def _chunked(name) -> bool:
    return LONG_CONFIGS[name][0].get("chunked_prefill", False)


async def _gen(engine, prompt, n, **kw):
    return [tok async for tok in engine.generate(prompt, max_new_tokens=n, **kw)]


async def _serve(engine, prompt, n, **kw):
    await engine.start()
    try:
        return await _gen(engine, prompt, n, **kw)
    finally:
        await engine.stop()


# --------------------------------------------------------------------------- #
# the drill through both engines
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(LONG_CONFIGS))
async def test_long_lane_outcomes_equal_reference(weights, name):
    ref, port, _ = await long_drills(weights, name)
    assert port["outcomes"] == ref["outcomes"]
    out = port["outcomes"]
    assert [len(out[c][1]) for c in ("alone", "inter-long", "cx-after", "in-budget",
                                     "prog-short", "prog-long")] == [8, 12, 4, 4, 24, 8]
    assert all(len(out[f"inter-{i}"][1]) == 6 for i in range(3))
    # a cancel by correlation ends the stream short, without an error
    assert out["cx-decode"][0] == "ok" and len(out["cx-decode"][1]) < 24
    if _chunked(name):
        assert out["cx-prefill"] == ("ok", [])  # cancelled before its first token
    assert out["cx-after"][1][0] == out["cx-decode"][1][0]
    assert out["over-cap"] == out["ceiling"] == ("InferenceError",)
    assert out["dl"] == ("DeadlineExceededError",)
    assert out["or"] == ("RunOrphanedError", f"{name}-dead")
    shed = ("EngineOverloadedError", "long")
    assert [out[f"shed-{i}"][:2] for i in range(5)] == [
        shed, ("ok", out["shed-1"][1]), ("ok", out["shed-2"][1]), ("ok", out["shed-3"][1]), shed,
    ]
    assert out["shed-0"][2:] == (3, 3) and out["shed-4"][2:] == (4, 3)


@pytest.mark.parametrize("name", list(LONG_CONFIGS))
async def test_long_lane_counters_equal_reference(weights, name):
    ref, port, _ = await long_drills(weights, name)
    assert port["counters"] == ref["counters"]
    c = port["counters"]
    # alone, inter, cx-decode, cx-after, in-budget, prog-long, dl, or, and
    # the three shed survivors landed a long prefill (cx-prefill never did)
    assert c["long_requests"] == 11
    assert c["long_dispatches"] > 0 and c["cancel_propagated"] >= 1
    assert c["expired_requests"] == c["orphaned_requests"] == 1
    assert c["shed_requests"] == 2
    if not LONG_CONFIGS[name][0]["overlap_dispatch"]:
        assert c["overlap_wasted_tokens"] == 0


@pytest.mark.parametrize("name", list(LONG_CONFIGS))
async def test_long_lane_journal_equals_reference(weights, name):
    ref, port, _ = await long_drills(weights, name)
    assert port["journal"] == ref["journal"]
    events = [row[0] for row in port["journal"]]
    assert events.count("ADMIT_LONG") == 11 + _chunked(name)


@pytest.mark.parametrize("name", list(LONG_CONFIGS))
async def test_long_lane_laws(weights, name):
    """The port's own laws after the drill: the lane idle and every slot and
    page free or cached; the long stream equal to the short lane's of a
    roomier engine; short tokens delivered while a chunked long prefill was
    in flight; the lane's graphs under the reference's keys."""
    ref, port, engine = await long_drills(weights, name)
    rt = LONG_CONFIGS[name][0]
    assert port["idle"] and port["free"] == list(range(rt["max_batch_size"]))
    if engine._paged:
        assert port["pages"] == engine._page_alloc.num_pages - 1
    short = InferenceEngine(TORCH_F32, RuntimeConfig(**SHORT_ROOMY), params=weights[1],
                            device="cpu")
    assert port["outcomes"]["alone"][1] == await _serve(short, LONG_PROMPTS["alone"], 8)
    if _chunked(name):
        assert port["during_prefill"] > 0 and ref["during_prefill"] > 0
        kinds = {key[0] for key in engine._long_graphs}
        assert kinds == {"chunk", "decode_sp"}
    else:
        assert {key[0] for key in engine._long_graphs} == {"prefill_sp", "decode_sp"}
    assert all(fn.calls for fn in engine._long_graphs.values())


async def test_chunked_long_prefill_equals_monolithic(weights):
    """The same long prompts through the monolithic (dense) and the chunked
    (paged) long prefill, overlapped and lockstep: the same streams."""
    runs = [await long_drills(weights, name) for name in LONG_CONFIGS]
    keys = ("alone", "inter-long", "cx-after", "in-budget", "prog-long")
    streams = [[port["outcomes"][k][1] for k in keys] for _, port, _ in runs]
    assert all(s == streams[0] for s in streams[1:])


# --------------------------------------------------------------------------- #
# submit-time refusals and the clamp
# --------------------------------------------------------------------------- #


async def test_long_disabled_rejects(weights):
    """Without ``long_context`` a prompt of max_seq_len tokens or more is
    refused with the reference's message."""
    rt = dict(max_batch_size=2, max_seq_len=32, prefill_chunk=16)
    errors = []
    for engine, error in (
        (JaxEngine(JAX_F32, JaxRuntime(**rt), params=weights[0]), JaxInferenceError),
        (InferenceEngine(TORCH_F32, RuntimeConfig(**rt), params=weights[1], device="cpu"),
         InferenceError),
    ):
        await engine.start()
        try:
            with pytest.raises(error, match="long_context") as info:
                await _gen(engine, list(range(40)), 4)
            errors.append(str(info.value).split(" (")[0])
            assert engine.stats.long_requests == 0
        finally:
            await engine.stop()
    assert errors[0] == errors[1]


async def test_long_budget_clamped_only_with_opt_in(weights):
    """``long_clamp_new_tokens`` clamps a budget over ``long_new_cap`` to
    the cap, in both engines, to the same stream."""
    rt = dict(LONG_BASE, long_new_cap=8, long_clamp_new_tokens=True)
    ref = await _serve(JaxEngine(JAX_F32, JaxRuntime(**rt, attention_impl="pallas_interpret"),
                                 params=weights[0]), LONG_PROMPTS["budget"], 1000)
    port = InferenceEngine(TORCH_F32, RuntimeConfig(**rt), params=weights[1], device="cpu")
    assert await _serve(port, LONG_PROMPTS["budget"], 1000) == ref
    assert len(ref) == 8 and port.stats.long_requests == 1


def test_long_context_constructs_and_multi_device_refuses(weights):
    """``long_context=True`` builds the lane's buffers at construction (the
    prefix scratch for the padded ceiling, the f32 fresh cache); tp/dp > 1
    is no longer refused (the lane over several ranks:
    ``tests/test_torch_sp_engine.py``)."""
    engine = InferenceEngine(TORCH_F32, RuntimeConfig(**LONG_BASE), params=weights[1],
                             device="cpu")
    cfg = TORCH_F32
    assert tuple(engine._long_scratch[0].shape) == (
        cfg.n_layers, 1, cfg.n_kv_heads, 128, cfg.head_dim)
    assert engine._long_scratch[0].dtype == engine._k.dtype
    assert tuple(engine._long_fresh[0].shape) == (
        cfg.n_layers, 1, cfg.n_kv_heads, 24, cfg.head_dim)
    assert [engine._long_padded(n) for n in (64, 65, 100, 128, 129)] == [64, 128, 128, 128, 256]
    for over in (dict(tp=2), dict(dp=2)):
        _check_runtime(RuntimeConfig(**LONG_BASE, **over))  # served: nothing raises


# --------------------------------------------------------------------------- #
# the model client
# --------------------------------------------------------------------------- #


async def test_client_serves_over_long_conversations(weights):
    """Two agent turns whose rendered conversations exceed ``max_seq_len``,
    sent at once, go through the long lane in both clients: the same
    events, two long requests each, and while the lane decodes the first
    the snapshot's ``pending_requests`` counts the second in the long
    queue."""
    words = " ".join(f"word{i}" for i in range(20))
    texts = [f"Summarize: {words}", f"Condense: {words}"]
    assert len(ByteTokenizer().encode(texts[0])) > LONG_BASE["max_seq_len"]
    jax_engine = JaxEngine(JAX_F32, JaxRuntime(**CLIENT_RT, attention_impl="pallas_interpret"),
                           params=weights[0])
    port_engine = InferenceEngine(TORCH_F32, RuntimeConfig(**CLIENT_RT), params=weights[1],
                                  device="cpu")
    runs = {}
    for name, client, engine, message in (
        ("jax", JaxLocalModelClient(config=JAX_F32, engine=jax_engine, max_new_tokens=12),
         jax_engine, JM.user_message),
        ("port", TorchLocalModelClient(engine=port_engine, max_new_tokens=12), port_engine,
         user_message),
    ):
        pace, seen = Pace(), []
        engine._chaos = pace
        pace.when(lambda e=engine: e._long is not None and len(e._long_pending) == 1,
                  lambda c=client: seen.append(c.stats_snapshot()["pending_requests"]))

        async def turn(text, client=client, message=message):
            return [e async for e in client.request_stream([message(text)])]

        try:
            events = await asyncio.gather(*[turn(text) for text in texts])
        finally:
            await client.stop()
        runs[name] = events, seen, engine.stats.long_requests
    (ref, ref_seen, ref_long), (got, seen, long_requests) = runs["jax"], runs["port"]
    for port_events, ref_events in zip(got, ref):
        assert [to_mesh(e) for e in port_events] == ref_events
        assert port_events[-1].response.text()
    assert seen == ref_seen == [1]
    assert long_requests == ref_long == 2
