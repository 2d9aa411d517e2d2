"""Typed agents on the port against the JAX package: the type adapter,
structured output, and a typed conversation of ``chip_smoke.py``'s phase 18
through both packages.

**The adapter against pydantic.**  ``calfkit_tpu_torch.models._adapter.Adapter``
against ``pydantic.TypeAdapter`` over a hypothesis strategy of generated
types (``tests/_torch_types.py``: dataclasses with defaults and factories,
``TypedDict`` total or not, enums plain and mixed-in, literals, tuples
variadic and fixed, sets, frozensets, dicts with str/int/enum/literal keys,
optionals and unions, dates; nested to depth 3) and over every type the
JAX package's tests use (their pydantic models through the model protocol,
dataclass twins of them, phase 18's ``TripPlan``) and 47 of the port's wire
types against the JAX package's models of the same names: the JSON schema
as ``json.dumps`` renders it (key order included), the output tool
``output_tool_def`` gives, lax validation's accept or refuse with the
coerced values (types too) and the errors' ``(type, loc)``, and the JSON
dump against ``to_jsonable_python``.

**The JAX package's structured cases, rebound** (``tests/_torch_rebind.py``):
``tests/test_engine.py``'s four (a typed answer through the output tool, a
retry then success, exhausted retries as ``mesh.validation_error``, the
test model's stub arguments), ``tests/test_e2e.py::test_structured_output``,
``tests/test_agent_behaviors.py``'s ``final_result`` collision,
``tests/test_schema_extraction.py``'s nested-model and output-tool cases
and ``tests/test_projection.py``'s structured preamble.

**One typed conversation, two packages.**  Phase 18's shape on each
package's CPU engine (the same debug weights, the JAX engine on its plain
XLA attention; ``tests/test_torch_agent_mesh.py``'s seeded ids and virtual
clock): a typed ``Agent`` with a nested-argument
tool, an MCP toolbox (the phase's stdio server) and a consumer; the
scripted first step and attempt 3, the engine's attempts 1 and 2.  Equal:
the typed outputs, the fault reports, the histories, every mesh record by
(topic, key), the token steps, the consumer's records and the prompt
tokens each engine was given — with pydantic's documentation-link lines
(``For further information visit ...``), which the port's
``ValidationError`` does not render, taken out of the JAX package's text.
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime
import enum
import importlib
import json
import re
import sys
from typing import Any, Literal, Optional, TypedDict

import pytest

pytest.importorskip("pydantic")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from pydantic import BaseModel, TypeAdapter  # noqa: E402
from pydantic import ValidationError as RefValidationError  # noqa: E402
from pydantic_core import to_jsonable_python  # noqa: E402

import chip_smoke  # noqa: E402
from calfkit_tpu.engine.schema import output_tool_def as ref_output_tool_def  # noqa: E402
from calfkit_tpu_torch.engine.schema import output_tool_def  # noqa: E402
from calfkit_tpu_torch.models._adapter import Adapter, ToolSchemaError  # noqa: E402
from calfkit_tpu_torch.models._wire import ValidationError  # noqa: E402
from tests._torch_rebind import ported_module  # noqa: E402
from tests._torch_types import built_value, json_values, types_strategy  # noqa: E402


def _outcome(validate, value):
    try:
        return "ok", validate(value)
    except (ValidationError, RefValidationError) as exc:
        return "refused", sorted(((e["type"], e["loc"]) for e in exc.errors()), key=repr)


def _types(value):
    """The types of a value, containers and record fields included."""
    if isinstance(value, dict):
        return ("dict", [(_types(k), _types(v)) for k, v in value.items()])
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, [_types(v) for v in value])
    if isinstance(value, (set, frozenset)):
        return (type(value).__name__, sorted(repr(_types(v)) for v in value))
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,
                [_types(getattr(value, f.name)) for f in dataclasses.fields(value)])
    return type(value).__name__


def assert_same_validation(tp, port: Adapter, value) -> None:
    got, want = _outcome(port.validate_python, value), _outcome(TypeAdapter(tp).validate_python,
                                                                value)
    assert got[0] == want[0], (value, got, want)
    if got[0] == "refused":
        assert got == want, value
        return
    assert got[1] == want[1] and _types(got[1]) == _types(want[1]), (value, got, want)
    assert port.dump(got[1]) == to_jsonable_python(want[1]), value


def assert_same_schema(tp) -> Adapter:
    port = Adapter(tp)
    assert json.dumps(port.json_schema()) == json.dumps(TypeAdapter(tp).json_schema()), tp
    assert json.dumps(output_tool_def(tp).model_dump(mode="json")) == json.dumps(
        ref_output_tool_def(tp).model_dump(mode="json")), tp
    return port


# --------------------------------------------------------------------------- #
# generated types
# --------------------------------------------------------------------------- #


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(tp=types_strategy())
def test_json_schema_matches_pydantic(tp):
    assert_same_schema(tp)


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(data=st.data())
def test_validation_and_dump_match_pydantic_lax_mode(data):
    tp = data.draw(types_strategy())
    port = Adapter(tp)
    for _ in range(3):
        assert_same_validation(tp, port, data.draw(built_value(tp) | json_values))


# --------------------------------------------------------------------------- #
# the types the JAX package's tests and phase 18 use
# --------------------------------------------------------------------------- #


class Weather(BaseModel):
    city: str
    temp_c: float


class Filters(BaseModel):
    tags: list[str]
    min_score: float = 0.0


class Answer(BaseModel):
    """The final answer."""

    value: int


@dataclasses.dataclass
class WeatherRecord:
    city: str
    temp_c: float


@dataclasses.dataclass
class Point:
    x: int
    y: int


class Shade(enum.Enum):
    LIGHT = "light"
    DARK = "dark"


class Doc(TypedDict, total=False):
    """A note with optional fields."""

    title: str
    shade: Shade
    at: datetime.date


@dataclasses.dataclass
class Nested:
    points: list[Point]
    where: Optional[Point] = None
    doc: Optional[Doc] = None
    tags: frozenset[str] = frozenset()
    pair: tuple[int, Literal["a", "b"]] = (0, "a")
    index: dict[Shade, list[int]] = dataclasses.field(default_factory=dict)


TABLE_TYPES = [Weather, Filters, Answer, WeatherRecord, Point, Shade, Doc, Nested,
               chip_smoke.TripPlan, chip_smoke.Leg, chip_smoke.TripPace, list[Point],
               dict[str, Nested], "int | str", tuple, set[int], complex, dict[int, str]]
TABLE_VALUES = [
    {"city": "SF", "temp_c": "18.5"}, {"city": "SF"}, {"tags": ["a"], "min_score": "x"},
    {"value": "3"}, {"x": 1, "y": "2", "z": 3}, "light", "dim",
    {"title": "t", "shade": "dark", "at": "2026-01-02"}, {"at": "2026-13-01"},
    {"points": [{"x": 1, "y": 2}], "where": None, "doc": {"title": 1}, "tags": ["a", "a"],
     "pair": [1, "b"], "index": {"light": ["1", 2]}},
    {"traveller": "Ana", "legs": [{"origin": "Oslo", "destination": "Lima", "km": "7"}],
     "pace": "brisk", "budget": "mid", "nights": None, "notes": ["x"]},
    {"traveller": "Bo", "legs": [], "pace": "slow", "budget": "mid", "nights": "many"},
    [{"x": 1, "y": 2}], {"k": {"points": []}}, 3, "3", [1, "2"], (1, 2), "1+2j", {"1": "a"},
]


@pytest.mark.parametrize("tp", TABLE_TYPES, ids=lambda t: getattr(t, "__name__", str(t)))
def test_repo_types_match_pydantic(tp):
    if isinstance(tp, str):
        tp = eval(tp)  # noqa: S307 - a union spelled as text
    port = assert_same_schema(tp)
    for value in TABLE_VALUES:
        assert_same_validation(tp, port, value)


def _wire_pairs():
    ref, port = importlib.import_module("calfkit_tpu.models"), importlib.import_module(
        "calfkit_tpu_torch.models")
    return [(name, getattr(ref, name), getattr(port, name)) for name in sorted(set(dir(port)))
            if isinstance(getattr(port, name), type) and hasattr(getattr(port, name), "_dump_fields")
            and hasattr(ref, name) and name not in WIRE_LEFT_OUT]


# the wire types whose reference models differ from the port's dataclasses
# in a way the schema shows: a docstring the port reworded, a generic
# output field
WIRE_LEFT_OUT = {"InvocationResult", "StepEvent", "StepMessage", "TokenStep"}
WIRE_PAIRS = _wire_pairs()


@pytest.mark.parametrize("name,ref,port", WIRE_PAIRS, ids=[p[0] for p in WIRE_PAIRS])
def test_wire_type_schemas_match_reference_models(name, ref, port):
    assert json.dumps(Adapter(port).json_schema()) == json.dumps(TypeAdapter(ref).json_schema())


def test_the_wire_table_is_whole():
    assert len(WIRE_PAIRS) == 47


def test_a_type_with_no_schema_is_refused_by_both():
    class NoSchema:
        pass

    with pytest.raises(ToolSchemaError):
        Adapter(NoSchema)
    with pytest.raises(TypeError):
        TypeAdapter(NoSchema).json_schema()
    with pytest.raises(ToolSchemaError):
        Adapter(dict[list[int], str])


# --------------------------------------------------------------------------- #
# the JAX package's structured cases, rebound
# --------------------------------------------------------------------------- #

REBOUND = [
    ("tests.test_engine", "TestRunTurn", "test_structured_output_via_tool"),
    ("tests.test_engine", "TestRunTurn", "test_structured_output_retry_then_success"),
    ("tests.test_engine", "TestRunTurn", "test_structured_output_exhausted_retries"),
    ("tests.test_engine", "TestTestModel", "test_structured_output_stub"),
    ("tests.test_e2e", "TestQuickstart", "test_structured_output"),
    ("tests.test_agent_behaviors", "TestReservedNames", "test_reserved_tool_name_faults"),
    ("tests.test_schema_extraction", "TestSignatureExtraction", "test_nested_pydantic_model_schema"),
    ("tests.test_schema_extraction", "TestValidatedCall", "test_nested_model_instantiated_not_dict"),
    ("tests.test_schema_extraction", "TestOutputTool", "test_output_tool_from_model"),
    ("tests.test_schema_extraction", "TestOutputTool", "test_output_tool_custom_name"),
    ("tests.test_projection", "TestPreambles", "test_structured_preamble_only_with_final_result_call"),
]


def _run(result, timeout: float = 120):
    if asyncio.iscoroutine(result):
        loop = asyncio.new_event_loop()
        try:
            return loop.run_until_complete(asyncio.wait_for(result, timeout=timeout))
        finally:
            loop.close()
    return result


@pytest.mark.parametrize("module_name,suite_name,name", REBOUND, ids=[r[2] for r in REBOUND])
def test_reference_structured_case_on_the_port(module_name, suite_name, name):
    g = ported_module(module_name)
    # the rebound suite runs on the port's classes
    assert all(getattr(v, "__module__", "").split(".")[0] != "calfkit_tpu"
               for k, v in g.items() if k[:1].isupper() and isinstance(v, type)
               and k not in (suite_name,))
    _run(getattr(g[suite_name](), name)())


# --------------------------------------------------------------------------- #
# one typed conversation through both packages
# --------------------------------------------------------------------------- #

jax = pytest.importorskip("jax")

import tests.test_torch_agent_mesh as T  # noqa: E402
from calfkit_tpu.inference.client import JaxLocalModelClient  # noqa: E402
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from calfkit_tpu_torch.inference import TorchLocalModelClient  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from tests._torch_port import JAX_CFG, TORCH_CFG, virtual_clock  # noqa: E402

TYPED_RT = dict(max_batch_size=2, max_seq_len=4096, kv_layout="paged", page_size=64,
                prefill_chunk=512, chunked_prefill=True, prefix_cache=True,
                decode_steps_per_dispatch=4)
CONVERSATIONS = (0, 1, 2, 3)  # two typed results, two validation faults
_DOC_LINK = re.compile(r"\n    For further information visit https://errors\.pydantic\.dev/\S+")


def _unlinked(value):
    """``value`` with pydantic's documentation-link lines taken out of its
    text."""
    if isinstance(value, str):
        return _DOC_LINK.sub("", value)
    if isinstance(value, dict):
        return {k: _unlinked(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_unlinked(v) for v in value)
    return value


class TypedScript:
    """Phase 18's model on package ``P``: ``chip_smoke.typed_step`` for a
    conversation's first step and attempt 3, the local engine's turn for
    attempts 1 and 2."""

    def __init__(self, P, local):
        self.P, self.local = P, local

    @property
    def model_name(self):
        return self.local.model_name

    async def request(self, messages, settings=None, params=None):
        async for event in self.request_stream(messages, settings, params):
            if isinstance(event, self.P.mc.ResponseDone):
                return event.response
        raise RuntimeError("no terminal response")

    async def request_stream(self, messages, settings=None, params=None):
        if chip_smoke.typed_attempt(messages) in (0, 3):
            yield self.P.mc.ResponseDone(chip_smoke.typed_step(self.P.models, messages))
            return
        async for event in self.local.request_stream(messages, settings, params):
            yield event


async def _typed_drive(P, local, server: str) -> dict:
    mcp = importlib.import_module(f"{T.ROOTS[P.name]}.mcp")
    mixed_tools = importlib.import_module(f"{T.ROOTS[P.name]}.mcp.toolbox").mixed_tools
    nodes = importlib.import_module(f"{T.ROOTS[P.name]}.nodes")
    protocol = importlib.import_module(f"{T.ROOTS[P.name]}.protocol")
    book = P.agent_tool(chip_smoke.book)
    seen: list = []

    @nodes.consumer(topics=[protocol.agent_publish_topic(chip_smoke.TYPED_AGENT)],
                    name="trip_audit")
    def trip_audit(ctx) -> None:
        reply = ctx.envelope.reply if ctx.envelope is not None else None
        if reply is not None and reply.kind == "return":
            seen.append((ctx.correlation_id, [p.data for p in reply.parts if p.kind == "data"]))

    toolbox = mcp.MCPToolboxNode(mcp.MCPServerSpec(name="geo", command=[sys.executable, server]))
    agent = P.Agent(chip_smoke.TYPED_AGENT, model=TypedScript(P, local),
                    instructions=chip_smoke.TYPED_INSTRUCTIONS,
                    tools=mixed_tools(book, mcp.Toolbox("geo")),
                    output_type=chip_smoke.TripPlan, max_output_retries=chip_smoke.TYPED_RETRIES,
                    stream_tokens=True)
    prompts: list = []
    generate = local._engine.generate

    def captured(prompt, **kw):
        prompts.append(list(prompt))
        return generate(prompt, **kw)

    local._engine.generate = captured
    mesh = P.InMemoryMesh()
    log: list = []
    T.recording(mesh, log)
    out: dict = {"runs": [], "tokens": {}}
    async with T.worker(P, [agent, book, toolbox, trip_audit], mesh):
        client = P.Client.connect(mesh)
        firehose = client.events()

        async def watch() -> None:
            async for event in firehose:
                if event.step.kind == "token":
                    out["tokens"].setdefault(event.correlation_id, []).append(event.step.text)

        watcher = asyncio.create_task(watch())
        try:
            texts = chip_smoke.typed_prompts("Typed trips")
            gateway = client.agent(chip_smoke.TYPED_AGENT, output_type=chip_smoke.TripPlan)
            for i in CONVERSATIONS:
                try:
                    result = await gateway.execute(texts[i], timeout=300)
                    out["runs"].append(("ok", result.output, T.history(result)))
                except P.exceptions.NodeFaultError as exc:
                    out["runs"].append(("fault", exc.report.error_type, exc.report.message))
            await asyncio.sleep(0.1)
        finally:
            firehose.close()
            watcher.cancel()
            await asyncio.gather(watcher, return_exceptions=True)
            await client.close()
    out.update(seen=seen, prompts=prompts,
               records=[(topic, key, T._parsed(value)) for topic, key, value in log])
    return _unlinked(out)


@pytest.fixture(scope="module")
def typed_clients():
    from tests._torch_port import jax_params, torch_params

    p = jax_params()
    # the reference's plain attention (XLA): the drive's 3,000-token prompts
    # through the kernels in interpret mode take minutes on the CPU
    jax_engine = JaxEngine(JAX_CFG, JaxRuntime(**TYPED_RT, attention_impl="xla"), params=p)
    port_engine = InferenceEngine(TORCH_CFG, RuntimeConfig(**TYPED_RT), params=torch_params(p),
                                  device="cpu")
    return {"ref": JaxLocalModelClient(config=JAX_CFG, engine=jax_engine, max_new_tokens=8),
            "port": TorchLocalModelClient(engine=port_engine, max_new_tokens=8)}


def test_typed_conversation_matches_reference(typed_clients, tmp_path):
    server = tmp_path / "geo_mcp_server.py"
    server.write_text(chip_smoke.MCP_SERVER_SOURCE)
    out = {}

    async def both() -> None:
        try:
            with virtual_clock():
                for name in ("ref", "port"):
                    T.fresh_run_stores()
                    with T.seeded_ids():
                        out[name] = await _typed_drive(T.pkg(name), typed_clients[name],
                                                       str(server))
        finally:
            for client in typed_clients.values():
                await client.stop()

    _run(both(), timeout=240)
    ref, port = out["ref"], out["port"]
    assert port["runs"] == ref["runs"]
    assert port["tokens"] == ref["tokens"] and port["seen"] == ref["seen"]
    assert port["prompts"] == ref["prompts"]
    assert len(port["records"]) == len(ref["records"])
    assert T.by_key(port["records"]) == T.by_key(ref["records"])
    # the drive's shape: typed results for the even conversations, typed
    # validation faults after 3 attempts for the odd, two engine attempts a
    # conversation, the retry boundary twice in each conversation's tokens
    kinds = [run[0] for run in port["runs"]]
    assert kinds == ["ok", "fault", "ok", "fault"]
    for run in port["runs"]:
        if run[0] == "ok":
            assert isinstance(run[1], chip_smoke.TripPlan)
        else:
            assert "mesh.validation_error" in run[2] and "after 3 attempts" in run[2]
    assert len(port["prompts"]) == 2 * len(CONVERSATIONS)
    boundary = "\n[retrying]\n"
    assert all("".join(t).count(boundary) == 2 for t in port["tokens"].values())
    assert len(port["seen"]) == 2
