"""The PyTorch port's model client against ``calfkit_tpu``'s
``JaxLocalModelClient``.

Both clients serve the same converted ``debug`` weights (f32 params) on the
CPU; the JAX engine runs its Pallas kernels in interpret mode.  What must be
EQUAL:

- ``render_messages`` over a corpus of histories, ``default_tool_call_parser``
  (tool call ids masked: they carry a timestamp) and ``ByteTokenizer``;
- the full event list of greedy ``request_stream``s (text-delta boundaries,
  ``ResumeOffset``, the terminal response's parts and usage) on a dense and
  a paged + prefix-cache + chunked + ragged runtime: a stop sequence that
  spans an emission boundary, ``max_tokens``, a resume cut right after a
  multi-byte character, a resume whose budget is spent, and four concurrent
  requests;
- the ``SamplingParams`` each client hands its engine for every combination
  of temperature, top_p and top_k over a greedy and a sampled default;
- ``stats_snapshot``'s key sets (cold and live, ``latency_ms`` included)
  and the values of every counter both engines keep, windows included;
- an ``Agent``'s two turns over the in-memory mesh (text, usage, prefix
  reuse), the port's client reaching the agent through a test-only adapter.

A seeded sampled stream cannot match ``jax.random``: the port holds that
the same seed gives the same text twice.
"""

import asyncio
import itertools
import json
from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")

from calfkit_tpu.engine.model_client import (  # noqa: E402
    ModelRequestParameters as JaxParams,
)
from calfkit_tpu.engine.model_client import ModelSettings as JaxSettings  # noqa: E402
from calfkit_tpu.inference.client import JaxLocalModelClient  # noqa: E402
from calfkit_tpu.inference.client import default_tool_call_parser as jax_parser  # noqa: E402
from calfkit_tpu.inference.client import render_messages as jax_render  # noqa: E402
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.config import SpecConfig as JaxSpec  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu.inference.sampler import SamplingParams as JaxSampling  # noqa: E402
from calfkit_tpu.inference.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from calfkit_tpu.models import capability as JC  # noqa: E402
from calfkit_tpu.models import messages as JM  # noqa: E402
from calfkit_tpu.models import payload as JP  # noqa: E402
from calfkit_tpu_torch.engine.model_client import (  # noqa: E402
    ModelRequestParameters,
    ModelSettings,
    ResponseDone,
    ResumeOffset,
    TextDelta,
)
from calfkit_tpu_torch.exceptions import InferenceError  # noqa: E402
from calfkit_tpu_torch.inference import TorchLocalModelClient  # noqa: E402
from calfkit_tpu_torch.inference.client import default_tool_call_parser, render_messages  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from calfkit_tpu_torch.inference.sampler import SamplingParams  # noqa: E402
from calfkit_tpu_torch.inference.tokenizer import ByteTokenizer  # noqa: E402
from calfkit_tpu_torch.models import (  # noqa: E402
    FilePart,
    ModelRequest,
    ModelResponse,
    TextOutput,
    ToolCallOutput,
    ToolDef,
    Usage,
    UserPart,
    user_message,
)
from tests._torch_port import (  # noqa: E402
    JAX_CFG,
    PORT_ONLY_COUNTERS,
    TORCH_CFG,
    MeshModelClient,
    jax_params,
    to_mesh,
    to_port,
    torch_params,
)

DENSE = dict(max_batch_size=4, max_seq_len=256, prefill_chunk=32, decode_steps_per_dispatch=4)
PAGED = dict(
    DENSE, prefill_chunk=16, kv_layout="paged", page_size=8, chunked_prefill=True,
    prefix_cache=True,
)
RUNTIMES = {"dense": DENSE, "paged": PAGED}
MAX_NEW = 16
# the counters both engines keep, compared by value after the same workload
SHARED_COUNTERS = (
    "prefill_tokens", "decode_tokens", "decode_dispatches", "prefill_absorbed_tokens",
    "unified_dispatches", "cancelled_requests", "active_requests", "pending_requests",
    "free_slots", "pages_total", "pages_in_use", "prefix_resident_pages", "alloc_stalls",
    "evictions_window", "free_pages", "prefix_cached_pages", "prefix_hits",
    "prefix_reused_tokens",
)
# the window's keys whose values are host wall-clock measurements
TIMED = ("decode_time_s", "interval_s", "tokens_per_second")


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


def _jax_client(weights, runtime, max_new_tokens=MAX_NEW):
    engine = JaxEngine(
        JAX_CFG, JaxRuntime(**runtime, attention_impl="pallas_interpret"), params=weights[0]
    )
    return JaxLocalModelClient(config=JAX_CFG, engine=engine, max_new_tokens=max_new_tokens)


def _port_client(weights, runtime, max_new_tokens=MAX_NEW):
    engine = InferenceEngine(TORCH_CFG, RuntimeConfig(**runtime), params=weights[1], device="cpu")
    return TorchLocalModelClient(engine=engine, max_new_tokens=max_new_tokens)


async def _events(client, messages, settings=None):
    return [e async for e in client.request_stream(messages, settings)]


async def _drained(engine):
    """Wait (at most 100 scheduler ticks of 50 ms) until the engine holds no
    slot; False if it still does."""
    for _ in range(100):
        if not engine._active and len(engine._free) == engine.runtime.max_batch_size:
            return True
        await asyncio.sleep(0.05)
    return False


def _boundary_stop(events) -> str:
    """Two characters of the answer that span the end of one emitted delta
    and the start of the next, and occur nowhere earlier in the answer."""
    full = events[-1].response.text()
    end = 0
    for event in events[:-1]:
        end += len(event.text)
        stop = full[end - 1:end + 1]
        if 0 < end < len(full) and full.find(stop) == end - 1:
            return stop
    raise AssertionError(f"no emission boundary to cut at in {events}")


async def _scenario(client, user, settings_type):
    """One client's workload, each step's events in order; settings that
    depend on an earlier answer derive from that answer (equal answers give
    equal settings).  Returns (events by step, live snapshot, windows)."""
    hi = [user("hi")]
    out = {"hi": await _events(client, hi)}
    windows = [client.stats_snapshot(window=True)["window"]]
    out["yo"] = await _events(client, [user("yo")])
    windows.append(client.stats_snapshot(window=True)["window"])
    full = out["hi"][-1].response.text()
    stop = _boundary_stop(out["hi"])
    out["stop"] = await _events(client, hi, settings_type(stop_sequences=[stop]))
    out["stop_reclaimed"] = await _drained(client._engine)
    out["max_tokens"] = await _events(client, hi, settings_type(max_tokens=5))
    # cut right after the first character past ASCII: a multi-byte character
    # (or the replacement of an incomplete one), which re-encodes to bytes
    # the model did not generate
    k = next(i for i, c in enumerate(full) if ord(c) > 127) + 1
    out["resume"] = await _events(client, hi, settings_type(resume_text=full[:k]))
    out["resume_spent"] = await _events(
        client, hi, settings_type(max_tokens=4, resume_text=full[:8])
    )
    out["concurrent"] = await asyncio.gather(
        *[_events(client, [user(w)]) for w in ("hi", "yo", "ok", "go")]
    )
    assert await _drained(client._engine)
    return out, client.stats_snapshot(), windows


_REFERENCE: dict = {}


async def _both(weights, name):
    """(JAX, port) scenario results on runtime ``name``; the JAX side is
    computed once per runtime for this module."""
    if name not in _REFERENCE:
        client = _jax_client(weights, RUNTIMES[name])
        try:
            _REFERENCE[name] = await _scenario(client, JM.user_message, JaxSettings)
        finally:
            await client.stop()
    client = _port_client(weights, RUNTIMES[name])
    try:
        port = await _scenario(client, user_message, ModelSettings)
    finally:
        await client.stop()
    return _REFERENCE[name], port


# --------------------------------------------------------------------------- #
# rendering, tool-call parsing, tokenizer
# --------------------------------------------------------------------------- #


def _corpus():
    """Histories in the mesh's types: system parts, instructions, an author,
    multi-part user content, tool returns, a retry, responses with str and
    dict tool args, and tool definitions with an output tool."""
    tools = JaxParams(
        tool_defs=[
            JC.ToolDef(name="get_weather", description="Weather by city",
                       parameters_schema={"type": "object",
                                          "properties": {"city": {"type": "string"}}}),
            JC.ToolDef(name="noop"),
        ],
        output_tool=JC.ToolDef(name="final_result", description="The answer"),
    )
    request = JM.ModelRequest(
        instructions="Be brief.",
        parts=[
            JM.SystemPart(content="You are a helper."),
            JM.UserPart(content="plain"),
            JM.UserPart(author="ana", content=[
                JP.TextPart(text="héllo"),
                JP.DataPart(data={"k": [1, 2.5, None], "ü": "✓"}),
                JP.DataPart(data={1, 2}),  # not JSON: rendered by str()
                JP.FilePart(name="a.txt", data_base64="YQ=="),
                JP.FilePart(uri="s3://bucket/b.pdf"),
                JP.ToolCallPart(tool_call_id="c0", tool_name="seen", args={"x": 1}),
            ]),
        ],
    )
    response = JM.ModelResponse(parts=[
        JM.TextOutput(text="Let me look."),
        JM.ThinkingOutput(text="hidden"),
        JM.ToolCallOutput(tool_call_id="c1", tool_name="get_weather", args={"city": "SF"}),
        JM.ToolCallOutput(tool_call_id="c2", tool_name="noop", args='{"raw": true}'),
    ])
    returns = JM.ModelRequest(parts=[
        JM.ToolReturnPart(tool_call_id="c1", tool_name="get_weather",
                          content={"temp": 18, "when": object.__name__}),
        JM.RetryPart(content="bad args", tool_call_id="c2", tool_name="noop"),
    ])
    return [
        ([JM.user_message("hello")], JaxParams()),
        ([JM.user_message("hi", author="bo"), JM.ModelResponse(parts=[])], JaxParams()),
        ([request, response, returns], tools),
        ([request, response, returns, JM.user_message("and again")], JaxParams()),
        ([JM.ModelRequest(parts=[JM.UserPart(content=[])])], JaxParams(tool_defs=tools.tool_defs)),
    ]


@pytest.mark.parametrize("case", range(len(_corpus())))
def test_render_messages_matches_reference(case):
    messages, params = _corpus()[case]
    assert render_messages(to_port(messages), to_port(params)) == jax_render(messages, params)


def test_render_messages_template():
    """The reference's template law: user and assistant turns, the tool
    grammar in the system block, the open assistant turn at the end."""
    text = render_messages(
        [user_message("hello"), ModelResponse(parts=[TextOutput(text="hi there")]),
         user_message("and again")],
        ModelRequestParameters(tool_defs=[ToolDef(name="t", description="d")]),
    )
    assert "<|user|>\nhello" in text
    assert "<|assistant|>\nhi there" in text
    assert '"tool_name"' in text
    assert text.endswith("<|assistant|>\n")


PARSER_CASES = [
    'Let me check.\n{"tool_name": "get_weather", "args": {"city": "SF"}}\nok',
    '{"tool_name": "a", "args": {"deep": {"list": [1, {"x": "}"}]}}}'
    ' and {"tool_name": "b"} then {"tool_name": "c", "args": [1]}',
    "set {x | x > 0} and {not json} {\"tool_name\": 5} {'tool_name': 'q'}",
    '{"tool_name": "broken", "args": {',
    "no braces at all",
    '{"a": {"tool_name": "inner"}} {"tool_name": "é", "args": {"ü": "✓"}}',
]


def _masked(calls):
    return [(c.tool_name, c.args) for c in calls]


@pytest.mark.parametrize("text", PARSER_CASES)
def test_tool_call_parser_matches_reference(text):
    remaining, calls = default_tool_call_parser(text)
    ref_remaining, ref_calls = jax_parser(text)
    assert remaining == ref_remaining
    assert _masked(calls) == _masked(ref_calls)
    assert all(c.tool_call_id.startswith("local_") for c in calls)


def test_tool_call_parser():
    text = 'Let me check.\n{"tool_name": "get_weather", "args": {"city": "SF"}}\nok'
    remaining, calls = default_tool_call_parser(text)
    assert calls[0].tool_name == "get_weather"
    assert calls[0].args == {"city": "SF"}
    assert "tool_name" not in remaining


TOKENIZER_IDS = [
    [],
    list(range(0, 259)),
    [3 + b for b in "héllo ✓ 𝄞".encode()],
    [3 + 0xC3],  # an incomplete two-byte sequence
    [3 + 0xE2, 3 + 0x9C, 300, 511, 3 + 0x93],  # ids past 258 inside a character
    [3 + 0xFF, 3 + 0xFE, 3 + 0x80, 0, 1, 2],  # bytes never valid in UTF-8, specials
    [258, 259, 260, 1000],
]


@pytest.mark.parametrize("ids", TOKENIZER_IDS)
def test_byte_tokenizer_decode_matches_reference(ids):
    port, ref = ByteTokenizer(), JaxByteTokenizer()
    assert port.decode(ids) == ref.decode(ids)
    text = port.decode(ids)
    assert port.encode(text) == ref.encode(text)
    assert port.decode(port.encode(text)) == text  # decoded text round-trips


@pytest.mark.parametrize("text", ["", "plain ascii", "héllo ✓ 𝄞", "\x00\x7f", "�"])
def test_byte_tokenizer_round_trip(text):
    port, ref = ByteTokenizer(), JaxByteTokenizer()
    assert port.encode(text) == ref.encode(text)
    assert port.decode(port.encode(text)) == text
    assert (port.bos_id, port.eos_id, port.pad_id, port.vocab_size) == (
        ref.bos_id, ref.eos_id, ref.pad_id, ref.vocab_size
    )


def test_seam_types_cross_by_field():
    """Either package's message, part, setting and parameter types build
    from the other's fields, and keep the reference's methods."""
    messages, params = _corpus()[2]
    assert to_mesh(to_port(messages)) == messages
    assert to_mesh(to_port(params)) == params
    assert to_port(params).all_tools() == to_port(params.all_tools())
    response = to_port(messages[1])
    assert response.text() == messages[1].text()
    assert response.tool_calls() == to_port(messages[1].tool_calls())
    assert [c.args_dict() for c in response.tool_calls()] == [
        c.args_dict() for c in messages[1].tool_calls()
    ]
    settings = JaxSettings(stop_sequences=["x"], resume_text="ab", extra={"k": 1})
    assert to_mesh(to_port(settings)) == settings
    assert to_port(JaxSettings()) == ModelSettings()
    assert Usage(input_tokens=1, output_tokens=2) + Usage(cache_read_tokens=3) == Usage(
        input_tokens=1, output_tokens=2, cache_read_tokens=3
    )
    assert ToolDef(name="t").parameters_schema == JC.ToolDef(name="t").parameters_schema
    with pytest.raises(ValueError, match="exactly one"):
        FilePart(name="neither")
    with pytest.raises(ValueError, match="JSON object"):
        ToolCallOutput(tool_call_id="i", tool_name="t", args="[1]").args_dict()


# --------------------------------------------------------------------------- #
# streams: the full event lists
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(RUNTIMES))
async def test_event_streams_match_reference(weights, name):
    (ref, ref_live, ref_windows), (port, live, windows) = await _both(weights, name)
    assert list(port) == list(ref)
    for step in ref:
        assert to_mesh(port[step]) == ref[step], step
    # the cases hold what they are named for
    stop = _boundary_stop(port["hi"])
    assert stop not in port["stop"][-1].response.text()
    assert len(port["stop"][-1].response.text()) < len(port["hi"][-1].response.text())
    assert port["stop_reclaimed"]
    assert port["max_tokens"][-1].response.usage.output_tokens == 5
    full = port["hi"][-1].response.text()
    assert isinstance(port["resume"][0], ResumeOffset)
    assert port["resume"][-1].response.text().startswith(full[:port["resume"][0].chars])
    assert [type(e) for e in port["resume_spent"]] == [ResumeOffset, ResponseDone]
    assert port["resume_spent"][-1].response.text() == full[:8]
    assert port["resume_spent"][-1].response.usage.output_tokens == 0
    for events in [port["hi"], *port["concurrent"]]:
        deltas = "".join(e.text for e in events if isinstance(e, TextDelta))
        assert deltas == events[-1].response.text()


@pytest.mark.parametrize("name", list(RUNTIMES))
async def test_stats_snapshot_matches_reference(weights, name):
    (_, ref_live, ref_windows), (_, live, windows) = await _both(weights, name)
    assert set(live) == set(ref_live)
    assert set(live["latency_ms"]) == set(ref_live["latency_ms"])
    assert set(live["capacity"]) == set(ref_live["capacity"])
    assert live["platform"] == ref_live["platform"] == "cpu"
    shared = [k for k in SHARED_COUNTERS if k in ref_live]
    assert {k: live[k] for k in shared} == {k: ref_live[k] for k in shared}
    assert live["pages_in_use"] == 0  # drained
    if name == "paged":
        assert live["prefix_hits"] > 0 and live["prefix_resident_pages"] > 0
    for window, ref_window in zip(windows, ref_windows):
        window = {k: v for k, v in window.items() if k not in PORT_ONLY_COUNTERS}
        assert set(window) == set(ref_window)
        assert {k: v for k, v in window.items() if k not in TIMED} == {
            k: v for k, v in ref_window.items() if k not in TIMED
        }


async def test_chip_smoke_key_sets_are_the_reference_key_sets(weights):
    """``chip_smoke.py``'s client phase holds the card's snapshots to fixed
    key sets (it imports no JAX): they are the JAX client's, cold and live
    on the paged runtime, with the card's ``hbm_gb_in_use``."""
    import chip_smoke

    (_, ref_live, _), _ = await _both(weights, "paged")
    cold = JaxLocalModelClient(config="debug", runtime=JaxRuntime(**PAGED)).stats_snapshot()
    assert chip_smoke.CLIENT_COLD_KEYS == set(cold)
    assert chip_smoke.CLIENT_LIVE_KEYS - {"hbm_gb_in_use"} == set(ref_live)


@pytest.mark.parametrize("name", list(RUNTIMES))
async def test_second_window_holds_only_the_second_request(weights, name):
    _, (port, _, windows) = await _both(weights, name)
    usage = port["yo"][-1].response.usage
    assert windows[1]["decode_tokens"] == usage.output_tokens
    reused = windows[1]["prefix_reused_tokens"]
    assert windows[1]["prefill_tokens"] + reused == usage.input_tokens


@pytest.mark.parametrize("spec", [False, True])
def test_cold_stats_snapshot_keys_match_reference(spec):
    for runtime in RUNTIMES.values():
        kw = dict(runtime, speculative=SpecConfig(k=3) if spec else None)
        port = TorchLocalModelClient(config="debug", runtime=RuntimeConfig(**kw)).stats_snapshot()
        ref_kw = dict(runtime, speculative=JaxSpec(k=3) if spec else None)
        ref = JaxLocalModelClient(config="debug", runtime=JaxRuntime(**ref_kw)).stats_snapshot()
        assert port == ref


async def test_spec_live_snapshot_keys_match_reference(weights):
    """Speculation adds its block to the live snapshot, as the reference's."""
    ref = _jax_client(weights, PAGED)
    port_engine = InferenceEngine(
        TORCH_CFG, RuntimeConfig(**PAGED, speculative=SpecConfig(k=2)),
        params=weights[1], device="cpu",
    )
    port = TorchLocalModelClient(engine=port_engine, max_new_tokens=4)
    try:
        await ref.start()
        await port.request([user_message("hi")])
        snap = port.stats_snapshot(window=True)
        ref_keys = set(ref.stats_snapshot(window=True))
    finally:
        await ref.stop()
        await port.stop()
    assert set(snap) == ref_keys | {"speculative"}
    assert set(snap["speculative"]) == {
        "k", "drafter", "spec_proposed", "spec_accepted", "acceptance_rate",
        "tokens_per_dispatch",
    }
    assert snap["speculative"]["drafter"] == "ngram"
    assert snap["capacity"]["by_lane"].keys() <= {"spec", "shared"}


# --------------------------------------------------------------------------- #
# sampling resolution, read through an injected recording engine
# --------------------------------------------------------------------------- #


class _RecordingEngine:
    """Stands in for an engine: records what ``generate`` is handed and
    emits one token."""

    def __init__(self, sampling):
        self.sampling = sampling
        self.config = SimpleNamespace(name="recording")
        self._running = False
        self.calls: list[dict] = []

    async def start(self):
        self._running = True

    async def stop(self):
        self._running = False

    async def generate(self, prompt, **kw):
        self.calls.append(kw)
        yield 3 + ord("a")


def _knobs(sampling):
    return None if sampling is None else (sampling.temperature, sampling.top_k, sampling.top_p)


KNOBS = list(itertools.product((None, 0.0, 0.7), (None, 0.9), (None, 40)))


@pytest.mark.parametrize("default", [(0.0, 0, 1.0), (0.8, 50, 0.95)], ids=["greedy", "sampled"])
async def test_sampling_resolution_matches_reference(default):
    t, k, p = default
    port_engine = _RecordingEngine(SamplingParams(temperature=t, top_k=k, top_p=p))
    ref_engine = _RecordingEngine(JaxSampling(temperature=t, top_k=k, top_p=p))
    port = TorchLocalModelClient(engine=port_engine)
    ref = JaxLocalModelClient(engine=ref_engine)
    for temperature, top_p, top_k in KNOBS:
        knobs = dict(temperature=temperature, top_p=top_p, top_k=top_k, seed=5)
        await port.request([user_message("x")], ModelSettings(**knobs))
        await ref.request([JM.user_message("x")], JaxSettings(**knobs))
    assert [_knobs(c["sampling"]) for c in port_engine.calls] == [
        _knobs(c["sampling"]) for c in ref_engine.calls
    ]
    assert [c["seed"] for c in port_engine.calls] == [5] * len(KNOBS)
    # the port forwards the caller context the reference forwards (none is
    # set here, so every one is None in both)
    context = ("corr", "run", "deadline", "lease", "priority")
    assert [c.keys() for c in port_engine.calls] == [c.keys() for c in ref_engine.calls]
    assert [[c[k] for k in context] for c in port_engine.calls] == [
        [c[k] for k in context] for c in ref_engine.calls
    ]


async def test_temperature_seed_reproducible(weights):
    client = _port_client(weights, DENSE)
    try:
        settings = ModelSettings(temperature=0.9, top_k=40, seed=11)
        r1 = await client.request([user_message("hello")], settings)
        r2 = await client.request([user_message("hello")], settings)
        assert r1.text() == r2.text()
        assert r1.usage == r2.usage
    finally:
        await client.stop()


# --------------------------------------------------------------------------- #
# the client's own contracts (the reference's client tests, mirrored)
# --------------------------------------------------------------------------- #


async def test_request_roundtrip_bytes():
    client = TorchLocalModelClient(
        config=TORCH_CFG,
        runtime=RuntimeConfig(max_batch_size=2, max_seq_len=256, prefill_chunk=32),
        max_new_tokens=16, device="cpu",
    )
    assert client.ready() == (False, "engine not built (weights not loaded)")
    await asyncio.gather(client.start(), client.start())  # lazy and idempotent
    engine = client._engine
    await client.start()
    assert client._engine is engine
    assert client.ready() == (True, "engine running")
    resp = await client.request([user_message("hi")])
    assert resp.model_name == "debug"
    assert resp.usage.output_tokens > 0
    await client.stop()
    assert client.ready() == (False, "engine not started")


async def test_ready_reads_every_engine_state(weights):
    """``ready()`` and ``stats_snapshot()['wedged']`` read every engine
    state the JAX client's read: not built, not started, running, and
    wedged by the dispatch-progress watchdog (the same reason text)."""
    assert TorchLocalModelClient(config="debug").ready() == (
        False, "engine not built (weights not loaded)"
    )
    port = _port_client(weights, DENSE)
    ref = _jax_client(weights, DENSE)
    assert port.ready() == ref.ready() == (False, "engine not started")
    try:
        await port.start()
        await ref.start()
        assert port.ready() == ref.ready() == (True, "engine running")
        for client in (port, ref):
            client._engine._wedged = True
        assert port.ready() == ref.ready()
        assert port.ready()[0] is False and "wedged" in port.ready()[1]
        assert port.stats_snapshot()["wedged"] is ref.stats_snapshot()["wedged"] is True
        for client in (port, ref):
            client._engine._wedged = False
    finally:
        await port.stop()
        await ref.stop()
    assert port.ready() == ref.ready() == (False, "engine not started")


async def test_stop_sequences_terminate(weights):
    client = _port_client(weights, DENSE)
    try:
        full = (await client.request([user_message("hi")])).text()
        assert full  # the byte tokenizer on random weights emits text
        stop = full[1:3]
        r = await client.request([user_message("hi")], ModelSettings(stop_sequences=[stop]))
        assert stop not in r.text()
        assert len(r.text()) < len(full)
        assert await _drained(client._engine)  # the cut stream's slot is reclaimed
    finally:
        await client.stop()


async def test_max_tokens_respected(weights):
    client = _port_client(weights, DENSE)
    try:
        r = await client.request([user_message("hi")], ModelSettings(max_tokens=5))
        assert r.usage.output_tokens <= 5
    finally:
        await client.stop()


async def test_resume_generates_only_remaining_tokens(weights):
    """The reference's resume law (a bijective tokenizer makes re-encoding
    the delivered prefix exact): offset first, then ONLY the continuation,
    a terminal with the full answer, and decode paid only the rest."""
    from calfkit_tpu.sim.stubs import BijectiveTokenizer

    engine = InferenceEngine(TORCH_CFG, RuntimeConfig(**PAGED), params=weights[1], device="cpu")
    client = TorchLocalModelClient(engine=engine, tokenizer=BijectiveTokenizer(), max_new_tokens=48)
    messages = [ModelRequest(parts=[UserPart(content="tell a story")])]
    try:
        full = (await client.request(messages)).text()
        assert len(full) >= 8
        k = len(full) // 2
        p0, d0, hits0 = (engine.stats.prefill_tokens, engine.stats.decode_tokens,
                         engine.stats.prefix_hits)
        events = await _events(client, messages, ModelSettings(resume_text=full[:k]))
        assert events[0] == ResumeOffset(k)
        assert "".join(e.text for e in events if isinstance(e, TextDelta)) == full[k:]
        assert events[-1].response.text() == full
        assert engine.stats.decode_tokens - d0 == len(full) - k
        assert engine.stats.prefill_tokens - p0 > k
        assert engine.stats.prefix_hits > hits0
    finally:
        await client.stop()


async def test_resume_with_spent_budget_decodes_nothing(weights):
    from calfkit_tpu.sim.stubs import BijectiveTokenizer

    engine = InferenceEngine(TORCH_CFG, RuntimeConfig(**DENSE), params=weights[1], device="cpu")
    client = TorchLocalModelClient(engine=engine, tokenizer=BijectiveTokenizer(), max_new_tokens=4)
    try:
        prior = "".join(chr(0x100 + i) for i in (9, 10, 11, 12))
        events = await _events(
            client, [ModelRequest(parts=[UserPart(content="hi")])],
            ModelSettings(resume_text=prior),
        )
        assert isinstance(events[0], ResumeOffset)
        assert events[-1].response.text() == prior
        assert engine.stats.decode_tokens == engine.stats.prefill_tokens == 0
    finally:
        await client.stop()


async def test_capacity_counts_live_pages(weights):
    """Mid-stream the paged pool's occupancy counts the request's pages
    (private plus referenced cached pages); drained, it counts none and the
    cache keeps its pages resident."""
    client = _port_client(weights, PAGED)
    try:
        await client.request([user_message("hi")])  # cache the prompt's pages
        stream = client.request_stream([user_message("hi")], ModelSettings(max_tokens=64))
        await anext(stream)
        live = client.stats_snapshot()
        cap = live["capacity"]
        assert live["active_requests"] == 1 and live["pages_in_use"] > 0
        assert cap["private_pages"] > 0 and cap["shared_referenced_pages"] > 0
        assert cap["pages_in_use"] == cap["private_pages"] + cap["shared_referenced_pages"]
        assert cap["headroom_pages"] == live["pages_total"] - live["pages_in_use"]
        assert live["free_pages"] == live["pages_total"] - cap["private_pages"] - (
            live["prefix_resident_pages"]
        )
        assert cap["by_lane"] == {"decode": cap["private_pages"],
                                  "shared": cap["shared_referenced_pages"]}
        await stream.aclose()
        assert await _drained(client._engine)
        drained = client.stats_snapshot()
        assert drained["pages_in_use"] == 0
        assert drained["prefix_resident_pages"] == drained["prefix_cached_pages"] > 0
    finally:
        await client.stop()


async def test_abandoned_stream_gives_back_its_slot(weights):
    client = _port_client(weights, DENSE)
    try:
        stream = client.request_stream([user_message("hi")], ModelSettings(max_tokens=64))
        assert isinstance(await anext(stream), TextDelta)
        await stream.aclose()
        assert await _drained(client._engine)
    finally:
        await client.stop()


def test_tool_calls_parsed_only_with_tools():
    """Parsing is gated on tool definitions, as in the reference."""

    async def run(params):
        engine = _RecordingEngine(SamplingParams())
        engine.generate = _emit(json.dumps({"tool_name": "t", "args": {"a": 1}}))
        return await TorchLocalModelClient(engine=engine).request([user_message("x")], None, params)

    plain = asyncio.run(run(None))
    tooled = asyncio.run(run(ModelRequestParameters(tool_defs=[ToolDef(name="t")])))
    assert plain.tool_calls() == [] and "tool_name" in plain.text()
    assert [(c.tool_name, c.args) for c in tooled.tool_calls()] == [("t", {"a": 1})]
    assert tooled.text() == ""


def _emit(text):
    async def generate(prompt, **kw):
        for b in text.encode():
            yield b + 3

    return generate


async def test_no_config_raises():
    client = TorchLocalModelClient(device="cpu")
    assert client.model_name == "torch-local"
    with pytest.raises(InferenceError, match="needs a config"):
        await client.start()


# --------------------------------------------------------------------------- #
# an Agent turn end to end on the in-memory mesh
# --------------------------------------------------------------------------- #

AGENT_RT = dict(PAGED, max_batch_size=2, max_seq_len=256)
INSTRUCTIONS = "You serve on the local engine. This block spans several KV pages."


async def _agent_turns(model, engine):
    from calfkit_tpu import Agent, Client, InMemoryMesh, Worker

    agent = Agent(name="local", model=model, instructions=INSTRUCTIONS)
    mesh = InMemoryMesh()
    turns = []
    async with Worker([agent], mesh=mesh):
        client = Client.connect(mesh)
        try:
            for _ in range(2):
                result = await client.agent("local").execute("say anything", timeout=120)
                response = result.state.latest_response()
                turns.append((
                    str(result.output), response.text(), response.usage,
                    engine.stats.prefix_hits, engine.stats.prefix_reused_tokens,
                ))
        finally:
            await client.close()
    return turns


async def test_agent_turns_match_reference(weights):
    ref_model = _jax_client(weights, AGENT_RT, max_new_tokens=8)
    port_client = _port_client(weights, AGENT_RT, max_new_tokens=8)
    try:
        ref = await _agent_turns(ref_model, ref_model._engine)
        port = await _agent_turns(MeshModelClient(port_client), port_client._engine)
    finally:
        await ref_model.stop()
        await port_client.stop()
    assert port == ref
    assert port[1][3] >= 1 and port[1][4] > port[0][4]  # turn 2 reused turn 1's pages
