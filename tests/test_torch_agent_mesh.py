"""The port's agent mesh against ``calfkit_tpu``'s: the same scripted agents
through each package's own ``Agent``, ``agent_tool``, ``Worker``,
``Client`` and ``InMemoryMesh``.

Every id either package mints (correlation, task, frame, run and span ids,
node instance ids, client ids, scripted tool-call ids) comes from
``uuid.uuid4``, replaced for each drive by one counter seeded alike, so
the two drives mint the same ids in the same order.  What must be EQUAL:

- the result's output, the message history (each message's JSON), the
  step-event kinds in order, a fault's typed report;
- every record published on the mesh, as (topic, key, parsed JSON value),
  wall-clock fields and tracebacks (which name each package's files)
  masked, in order within each (topic, key) — the order the mesh
  guarantees; concurrent publishers of different keys may interleave
  differently from run to run.  The workers' control-plane heartbeat is
  set past the drive's length in both packages, so the adverts are the
  ones published at start and stop;
- the quickstart, a multi-turn history, parallel tool calls through the
  durable fan-out, a tool fault, a timeout, ``send``, the firehose, and
  ``stream_tokens=True`` token steps before the terminal;
- two local-engine turns (and a scripted tool call followed by the local
  engine's turn) through ``TorchLocalModelClient(device="cpu")`` against
  ``JaxLocalModelClient`` (Pallas in interpret mode) on the same debug
  weights: text, usage, prefix hits, reused tokens, and the caller
  context (correlation id, run id, deadline, lease, priority) each engine
  receives from its own node kernel, with no adapter.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import json
import random
import uuid
from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")

from calfkit_tpu.inference.client import JaxLocalModelClient  # noqa: E402
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu_torch.inference import TorchLocalModelClient  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from tests._torch_port import (  # noqa: E402
    JAX_CFG,
    TORCH_CFG,
    jax_params,
    journal_rows,
    torch_params,
    virtual_clock,
)

ROOTS = {"ref": "calfkit_tpu", "port": "calfkit_tpu_torch"}
# record fields that hold host wall-clock readings or durations, and the
# tracebacks (they name each package's own files)
MASKED = frozenset({
    "started_at", "heartbeat_at", "finished_at", "window_end", "start_s",
    "duration_ms", "traceback", "prefill_ms", "decode_ms", "tokens_per_second",
    "queue_wait_s", "device_time_s", "ttft_ms",
})
# span attributes only the port's model client sets (the engine's timing of
# the request, two of them host wall-clock spans): the reference's spans
# carry none, so they are left out of the comparison
PORT_ONLY = frozenset({"queue_wait_ms", "prefill_span_ms", "reused_tokens"})


def pkg(name: str) -> SimpleNamespace:
    root = ROOTS[name]

    def m(sub: str):
        return importlib.import_module(f"{root}.{sub}")

    return SimpleNamespace(
        name=name,
        Agent=m("nodes").Agent,
        agent_tool=m("nodes").agent_tool,
        Worker=m("worker").Worker,
        Client=m("client").Client,
        InMemoryMesh=m("mesh").InMemoryMesh,
        InvocationResult=m("models.node_result").InvocationResult,
        engine=m("engine"),
        mc=m("engine.model_client"),
        models=m("models"),
        exceptions=m("exceptions"),
        flightrec=m("observability.flightrec"),
    )


@contextlib.contextmanager
def seeded_ids(seed: int = 0):
    """``uuid.uuid4`` (the one source of every id both packages mint) as a
    seeded counter for the block."""
    rng = random.Random(seed)
    original = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)
    try:
        yield
    finally:
        uuid.uuid4 = original


def _masked(value):
    if isinstance(value, dict):
        return {k: "<masked>" if k in MASKED else _masked(v)
                for k, v in value.items() if k not in PORT_ONLY}
    if isinstance(value, list):
        return [_masked(v) for v in value]
    return value


def _parsed(value: bytes):
    if not value:
        return None  # a tombstone
    return _masked(json.loads(value))


def recording(mesh, log: list) -> None:
    """Every record published on ``mesh`` appended to ``log`` as
    (topic, key, value bytes)."""
    publish = mesh.publish

    async def recorded(topic, value, *, key=None, headers=None):
        log.append((topic, key, value))
        return await publish(topic, value, key=key, headers=headers)

    mesh.publish = recorded


def worker(P, nodes, mesh):
    """``P.Worker`` with the control-plane heartbeat set past any drive:
    its timed re-adverts (and their SLO rollups) depend on the wall clock."""
    config = importlib.import_module(f"{ROOTS[P.name]}.controlplane").ControlPlaneConfig
    return P.Worker(nodes, mesh=mesh, owns_transport=True,
                    control_plane=config(heartbeat_interval=3600.0))


def by_key(records: list) -> dict:
    """(topic, key) → the parsed values published under it, in order."""
    out: dict = {}
    for topic, key, value in records:
        out.setdefault((topic, key), []).append(value)
    return out


def history(result) -> list:
    return [m.model_dump(mode="json") for m in result.state.message_history]


def weather_tool(P):
    @P.agent_tool
    def get_weather(city: str) -> dict:
        """Get the current weather for a city.

        Args:
            city: Name of the city to look up.
        """
        return {"city": city, "conditions": "sunny", "temp_c": 21.5}

    return get_weather


# --------------------------------------------------------------------------- #
# the scripted scenarios: one body, run on either package
# --------------------------------------------------------------------------- #


async def quickstart(P, log) -> dict:
    get_weather = weather_tool(P)
    agent = P.Agent(
        "weather_agent",
        model=P.engine.TestModelClient(custom_output_text="It is sunny in SF, 21.5C"),
        instructions="You are a weather assistant.",
        tools=[get_weather],
    )
    mesh = P.InMemoryMesh()
    recording(mesh, log)
    async with worker(P, [agent, get_weather], mesh):
        client = P.Client.connect(mesh)
        handle = await client.agent("weather_agent").start("Weather in SF?", timeout=10)
        events = [e async for e in handle.stream()]
        result = events[-1]
        await client.close()
    assert isinstance(result, P.InvocationResult)
    return {
        "output": result.output,
        "history": history(result),
        "kinds": [e.step.kind for e in events if hasattr(e, "step")],
    }


async def multi_turn(P, log) -> dict:
    agent = P.Agent("chat", model=P.engine.EchoModelClient())
    mesh = P.InMemoryMesh()
    recording(mesh, log)
    async with worker(P, [agent], mesh):
        client = P.Client.connect(mesh)
        gateway = client.agent("chat")
        r1 = await gateway.execute("first", timeout=10)
        r2 = await gateway.execute(
            "second", message_history=r1.state.message_history, timeout=10
        )
        await client.close()
    return {"output": [r1.output, r2.output], "history": history(r2)}


async def fanout(P, log) -> dict:
    M = P.models

    @P.agent_tool
    def city_temp(city: str) -> float:
        """Temperature lookup.

        Args:
            city: City name.
        """
        return {"sf": 18.0, "nyc": 25.0}.get(city.lower(), 20.0)

    def scripted(messages, params):
        if not any(isinstance(m, M.ModelResponse) for m in messages):
            return M.ModelResponse(parts=[
                M.ToolCallOutput(tool_call_id="a", tool_name="city_temp", args={"city": "SF"}),
                M.ToolCallOutput(tool_call_id="b", tool_name="city_temp", args={"city": "NYC"}),
            ])
        return M.ModelResponse(parts=[M.TextOutput(text="SF 18, NYC 25")])

    agent = P.Agent("multi", model=P.engine.FunctionModelClient(scripted), tools=[city_temp])
    mesh = P.InMemoryMesh()
    recording(mesh, log)
    async with worker(P, [agent, city_temp], mesh):
        client = P.Client.connect(mesh)
        handle = await client.agent("multi").start("temps?", timeout=10)
        events = [e async for e in handle.stream()]
        await client.close()
    result = events[-1]
    return {
        "output": result.output,
        "history": history(result),
        "kinds": [e.step.kind for e in events if hasattr(e, "step")],
    }


async def tool_fault(P, log) -> dict:
    M = P.models

    @P.agent_tool
    def bomb() -> str:
        raise RuntimeError("tool exploded")

    def scripted(messages, params):
        return M.ModelResponse(parts=[M.ToolCallOutput(tool_call_id="x", tool_name="bomb", args={})])

    agent = P.Agent("bomber", model=P.engine.FunctionModelClient(scripted), tools=[bomb])
    mesh = P.InMemoryMesh()
    recording(mesh, log)
    async with worker(P, [agent, bomb], mesh):
        client = P.Client.connect(mesh)
        with pytest.raises(P.exceptions.NodeFaultError) as caught:
            await client.agent("bomber").execute("go", timeout=10)
        await client.close()
    report = caught.value.report
    assert report.error_type == M.FaultTypes.CALLEE_FAULT
    return {
        "output": (report.error_type, report.root_cause().message, report.describe()),
        "report": _masked(report.model_dump(mode="json")),
    }


async def timeout(P, log) -> dict:
    mesh = P.InMemoryMesh()
    recording(mesh, log)
    await mesh.start()  # no worker: nobody will reply
    client = P.Client.connect(mesh)
    with pytest.raises(P.exceptions.ClientTimeoutError) as caught:
        await client.agent("nobody").execute("hello", timeout=0.3)
    await client.close()
    await mesh.stop()
    return {"output": type(caught.value).__name__}


async def send(P, log) -> dict:
    agent = P.Agent("fire", model=P.engine.EchoModelClient())
    mesh = P.InMemoryMesh()
    recording(mesh, log)
    async with worker(P, [agent], mesh):
        client = P.Client.connect(mesh)
        cid = await client.agent("fire").send("hello")
        # the run completes without a listener: wait for its reply record
        for _ in range(500):
            if any(t == client.inbox_topic and b'"reply"' in v for t, _, v in log):
                break
            await asyncio.sleep(0.01)
        await client.close()
    return {"output": cid}


async def firehose(P, log) -> dict:
    get_weather = weather_tool(P)
    agent = P.Agent(
        "noisy", model=P.engine.TestModelClient(custom_output_text="ok"), tools=[get_weather]
    )
    mesh = P.InMemoryMesh()
    recording(mesh, log)
    async with worker(P, [agent, get_weather], mesh):
        client = P.Client.connect(mesh)
        stream = client.events()
        await client.agent("noisy").execute("a", timeout=10)
        await client.agent("noisy").execute("b", timeout=10)
        await asyncio.sleep(0.2)
        stream.close()
        events = [e async for e in stream]
        await client.close()
    return {"output": [(e.correlation_id, e.node, e.step.kind) for e in events]}


class _Chunked:
    """A streaming model: five text chunks, each after a short sleep."""

    model_name = "chunked"

    def __init__(self, P):
        self.P = P

    async def request(self, messages, settings=None, params=None):
        async for event in self.request_stream(messages, settings, params):
            if isinstance(event, self.P.mc.ResponseDone):
                return event.response

    async def request_stream(self, messages, settings=None, params=None):
        M, mc = self.P.models, self.P.mc
        text = ""
        for i in range(5):
            await asyncio.sleep(0.02)
            chunk = f"chunk-{i} of the answer. "
            text += chunk
            yield mc.TextDelta(chunk)
        yield mc.ResponseDone(M.ModelResponse(parts=[M.TextOutput(text=text)]))


async def stream_tokens(P, log) -> dict:
    agent = P.Agent("paced", model=_Chunked(P), stream_tokens=True)
    mesh = P.InMemoryMesh()
    recording(mesh, log)
    async with worker(P, [agent], mesh):
        client = P.Client.connect(mesh)
        handle = await client.agent("paced").start("go", timeout=30)
        events = [e async for e in handle.stream()]
        await client.close()
    kinds = [e.step.kind for e in events if hasattr(e, "step")]
    assert kinds.count("token") >= 2 and isinstance(events[-1], P.InvocationResult)
    return {
        "output": events[-1].output,
        "kinds": kinds,
        "tokens": [e.step.text for e in events if hasattr(e, "step") and e.step.kind == "token"],
    }


SCENARIOS = {
    f.__name__: f
    for f in (quickstart, multi_turn, fanout, tool_fault, timeout, send, firehose, stream_tokens)
}


def fresh_run_stores() -> None:
    """Both packages' process-wide runs stores emptied: the SLO advert a
    worker publishes at stop folds every run the process's store saw inside
    its window, other tests' workers' runs included."""
    for root in ROOTS.values():
        importlib.import_module(f"{root}.observability.runledger").reset_run_window_store()


async def drive(name: str, scenario: str) -> dict:
    log: list = []
    fresh_run_stores()
    with seeded_ids():
        out = await SCENARIOS[scenario](pkg(name), log)
    out["records"] = [(topic, key, _parsed(value)) for topic, key, value in log]
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
async def test_scenario_matches_reference(scenario):
    ref = await drive("ref", scenario)
    port = await drive("port", scenario)
    assert ref["records"], "the drive published nothing"
    assert port.keys() == ref.keys()
    for key in ref:
        if key != "records":
            assert port[key] == ref[key], key
    assert len(port["records"]) == len(ref["records"])
    assert by_key(port["records"]) == by_key(ref["records"])


async def test_quickstart_with_the_three_port_imports():
    from calfkit_tpu_torch import Agent, Client, Worker
    from calfkit_tpu_torch.engine import TestModelClient
    from calfkit_tpu_torch.mesh import InMemoryMesh
    from calfkit_tpu_torch.nodes import agent_tool

    @agent_tool
    def get_weather(city: str) -> dict:
        """Get the current weather for a city.

        Args:
            city: Name of the city to look up.
        """
        return {"city": city, "conditions": "sunny", "temp_c": 21.5}

    weather_agent = Agent(
        "weather_agent", model=TestModelClient(),
        instructions="You are a weather assistant.", tools=[get_weather],
    )
    mesh = InMemoryMesh()
    async with Worker([weather_agent, get_weather], mesh=mesh, owns_transport=True):
        client = Client.connect(mesh)
        result = await client.agent("weather_agent").execute("Weather in SF?", timeout=10)
        await client.close()
    assert json.loads(result.output) == {"tools_called": ["get_weather"], "replies": 1}
    assert [m.role for m in result.state.message_history] == [
        "request", "response", "request", "response"
    ]


def test_refusals_are_typed():
    from calfkit_tpu_torch import Agent, Client
    from calfkit_tpu_torch.engine import EchoModelClient
    from calfkit_tpu_torch.engine.schema import ToolSchemaError
    from calfkit_tpu_torch.mesh import InMemoryMesh, KafkaWireMesh, TcpMesh
    from calfkit_tpu_torch.mesh.urls import mesh_from_url

    # the transports resolve to the port's own classes (not the JAX package's)
    assert type(mesh_from_url("tcp://localhost:9092")) is TcpMesh
    assert type(mesh_from_url("kafka://localhost:9092")) is KafkaWireMesh
    assert type(mesh_from_url("kafka+wire://h:1")) is KafkaWireMesh
    assert TcpMesh.__module__ == "calfkit_tpu_torch.mesh.tcp"
    assert KafkaWireMesh.__module__ == "calfkit_tpu_torch.mesh.kafka_wire"
    assert isinstance(mesh_from_url("memory://"), InMemoryMesh)
    # a policy name builds the client's own FleetRouter; close() stops it
    from calfkit_tpu_torch.fleet import FleetRouter, LeastLoaded

    async def routed_client():
        routed = Client(InMemoryMesh(), router="least-loaded")
        assert isinstance(routed.router, FleetRouter)
        assert isinstance(routed.router.policy, LeastLoaded)
        await routed.router.start()
        assert routed.router._started
        await routed.close()
        assert not routed.router._started

    asyncio.run(routed_client())
    # a structured agent is no refusal: it offers the reference's output
    # tool and advertises structured output; a type with no schema is
    # refused when the output tool is derived, as pydantic refuses it
    from calfkit_tpu.engine.schema import output_tool_def as ref_output_tool_def
    from calfkit_tpu_torch.engine.schema import output_tool_def

    typed = Agent("typed", model=EchoModelClient(), output_type=dict)
    assert typed.output_type is dict
    assert typed.agent_card().structured_output is True
    assert output_tool_def(dict).model_dump(mode="json") == \
        ref_output_tool_def(dict).model_dump(mode="json")
    with pytest.raises(ToolSchemaError):
        output_tool_def(type("NoSchema", (), {}))


# --------------------------------------------------------------------------- #
# the local engine through the mesh
# --------------------------------------------------------------------------- #

AGENT_RT = dict(
    max_batch_size=2, max_seq_len=1024, prefill_chunk=16, decode_steps_per_dispatch=4,
    kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True,
)
INSTRUCTIONS = "You serve on the local engine. This block spans several KV pages."


@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


def _clients(weights):
    jax_engine = JaxEngine(
        JAX_CFG, JaxRuntime(**AGENT_RT, attention_impl="pallas_interpret"), params=weights[0]
    )
    port_engine = InferenceEngine(TORCH_CFG, RuntimeConfig(**AGENT_RT), params=weights[1], device="cpu")
    return {
        "ref": JaxLocalModelClient(config=JAX_CFG, engine=jax_engine, max_new_tokens=8),
        "port": TorchLocalModelClient(engine=port_engine, max_new_tokens=8),
    }


class _ToolFirst:
    """A scripted first step that calls ``get_weather``; every later step
    is the local engine's turn over the history holding the tool's return."""

    def __init__(self, P, local):
        self.P, self.local = P, local

    @property
    def model_name(self):
        return self.local.model_name

    def _scripted(self, messages):
        if any(isinstance(m, self.P.models.ModelResponse) for m in messages):
            return None
        return self.P.models.ModelResponse(parts=[self.P.models.ToolCallOutput(
            tool_call_id="w1", tool_name="get_weather", args={"city": "Paris"},
        )])

    async def request(self, messages, settings=None, params=None):
        scripted = self._scripted(messages)
        if scripted is not None:
            return scripted
        return await self.local.request(messages, settings, params)

    async def request_stream(self, messages, settings=None, params=None):
        scripted = self._scripted(messages)
        if scripted is not None:
            yield self.P.mc.ResponseDone(scripted)
            return
        async for event in self.local.request_stream(messages, settings, params):
            yield event


def _capture_generate(engine, calls: list) -> None:
    generate = engine.generate

    def captured(prompt, **kw):
        calls.append({k: kw.get(k) for k in ("corr", "run", "deadline", "lease", "priority")})
        return generate(prompt, **kw)

    engine.generate = captured


async def _agent_turns(P, local, engine, *, with_tool: bool) -> dict:
    tools = [weather_tool(P)] if with_tool else []
    model = _ToolFirst(P, local) if with_tool else local
    agent = P.Agent(name="local", model=model, instructions=INSTRUCTIONS, tools=tools)
    mesh = P.InMemoryMesh()
    calls: list = []
    _capture_generate(engine, calls)
    turns = []
    async with P.Worker([agent, *tools], mesh=mesh):
        client = P.Client.connect(mesh, lease_ttl=30.0, priority="batch")
        try:
            history_ = None
            for prompt in ("say anything", "and again"):
                result = await client.agent("local").execute(
                    prompt, message_history=history_, timeout=120
                )
                history_ = result.state.message_history
                response = result.state.latest_response()
                turns.append((
                    str(result.output), response.text(), response.usage.model_dump(),
                    engine.stats.prefix_hits, engine.stats.prefix_reused_tokens,
                ))
        finally:
            await client.close()
    names = {code: name for name, code in vars(P.flightrec).items()
             if name.startswith("EV_") and isinstance(code, int)}
    submits = [row[:2] for row in journal_rows(engine, {c: n[3:] for c, n in names.items()})
               if row[0] == "SUBMIT"]
    return {"turns": turns, "history": history(result), "calls": calls, "submits": submits}


@pytest.mark.parametrize("with_tool", [False, True], ids=["two_turns", "tool_then_engine"])
async def test_local_engine_turns_match_reference(weights, with_tool):
    clients = _clients(weights)
    out = {}
    try:
        with virtual_clock():
            for name in ("ref", "port"):
                with seeded_ids():
                    out[name] = await _agent_turns(
                        pkg(name), clients[name], clients[name]._engine, with_tool=with_tool
                    )
    finally:
        for client in clients.values():
            await client.stop()
    ref, port = out["ref"], out["port"]
    assert port == ref
    turns = port["turns"]
    assert turns[1][3] >= 1 and turns[1][4] > turns[0][4]  # turn 2 reused turn 1's pages
    for call in port["calls"]:
        # the node kernel set every caller contextvar the engine reads
        assert call["corr"] and call["run"] and call["deadline"] is not None
        assert call["lease"] is not None and call["priority"] == "batch"
    assert [c["corr"] for c in port["calls"]] == [corr for _, corr in port["submits"]]


async def _faulted_turn(P, local, point: str) -> dict:
    """One agent turn on ``local``'s engine with an exception raised through
    the engine's chaos seam at ``point`` ("tick": before the prompt's
    prefill; "dispatch": at the first decode tick, after the prefill's
    token)."""
    engine = local._engine

    def chaos(at: str) -> None:
        if at == point:
            raise RuntimeError("injected engine fault")

    engine._chaos = chaos
    agent = P.Agent(name="local", model=local, instructions=INSTRUCTIONS)
    mesh = P.InMemoryMesh()
    async with P.Worker([agent], mesh=mesh):
        client = P.Client.connect(mesh)
        try:
            result = await client.agent("local").execute("say anything", timeout=120)
            return {"output": result.output, "history": history(result)}
        except P.exceptions.NodeFaultError as exc:
            return {"error_type": exc.report.error_type, "message": exc.report.message}
        finally:
            await client.close()


@pytest.mark.parametrize("point", ["tick", "dispatch"])
async def test_engine_fault_ends_alike(weights, point, tmp_path, monkeypatch):
    """An engine fault during an agent turn ends the same in both packages:
    the engine finishes the request with what it streamed before the fault,
    and the agent answers with that text (empty when the fault came before
    the first token) — neither package raises a typed fault to the caller."""
    monkeypatch.setenv("CALFKIT_FLIGHTREC_DIR", str(tmp_path))
    clients = _clients(weights)
    out = {}
    try:
        with virtual_clock():
            for name in ("ref", "port"):
                with seeded_ids():
                    out[name] = await _faulted_turn(pkg(name), clients[name], point)
    finally:
        for client in clients.values():
            await client.stop()
    assert out["port"] == out["ref"]
    assert out["port"]["output"] == ("" if point == "tick" else out["port"]["output"])
    assert (out["port"]["output"] == "") == (point == "tick")
