"""The port's pydantic-free tool schemas (``calfkit_tpu_torch.engine.schema``)
against the JAX package's pydantic extraction.

- ``function_schema(fn).tool_def`` equals the reference's — the JSON schema
  byte for byte as ``json.dumps`` renders it into a prompt (key order
  included) — for a table of tool signatures: the quickstart's
  ``get_weather``, every tool signature of ``examples/`` and ``tests/``,
  and every annotation of the supported set (``str``, ``int``, ``float``,
  ``bool``, ``None``, ``Any``, ``Optional[X]``, ``X | None``, ``list[X]``,
  ``dict[str, X]``, ``Literal[...]``, defaults, docstring ``Args:``);
- ``validate_args`` accepts and refuses the same argument dicts as the
  reference's lax mode, with the same coerced values and the same failing
  fields (hypothesis over the supported set, plus a fixed table: missing,
  extra, wrong type, ``"3"`` and ``3.0`` for ``int``, bool strings);
- an annotation outside the set raises ``ToolSchemaError`` at definition;
- a tool called with bad arguments through the mesh answers the model
  with a retry part that starts ``Invalid arguments for {name}:`` and names
  the same fields in both packages (pydantic's exact wording differs).
"""

from __future__ import annotations

import json
from typing import Any, Literal, Optional

import pytest

pytest.importorskip("pydantic")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from pydantic import ValidationError as RefValidationError  # noqa: E402

from calfkit_tpu.engine.schema import function_schema as ref_schema  # noqa: E402
from calfkit_tpu_torch.engine.schema import (  # noqa: E402
    ToolSchemaError,
    ValidationError,
    function_schema,
)


def get_weather(city: str) -> dict:
    """Get the current weather for a city.

    Args:
        city: Name of the city to look up.
    """
    return {"city": city}


def find_hotels(city: str, nights: int = 2) -> list[dict]:
    """Find hotels.

    Args:
        city: City name.
        nights: How many nights.
    """
    return []


def find_flights(origin: str, destination: str) -> list[dict]:
    return []


def scalars(s: str, i: int, f: float, b: bool, n: None, a: Any) -> str:
    """Every scalar annotation.

    Args:
        s: a string
        i (int): an integer
        f: a number
    """
    return s


def optionals(a: Optional[int], b: "str | None", c: Optional[float] = None, d: "bool | None" = True) -> str:
    return ""


def containers(a: list[str], b: list[int], c: dict[str, int], d: dict[str, Any],
               e: list, f: dict, g: list[Optional[float]] = [1.5],  # noqa: B006
               h: dict[str, list[int]] = {"x": [1]}) -> str:  # noqa: B006
    return ""


def literals(mode: Literal["fast", "slow"], level: Literal[1, 2, 3] = 2,
             flag: Literal[True] = True, one: Literal["only"] = "only",
             maybe: Optional[Literal["a", "b"]] = None) -> str:
    return ""


def defaults(a: str = "x", b: int = 3, c: float = 1, d: bool = False, e: Any = None,
             f: int = None, g: "list[str] | None" = None) -> str:  # type: ignore[assignment]
    """Defaults.

    :param a: sphinx-style description
    """
    return ""


def unannotated(ctx, q, limit: int = 5) -> str:
    return ""


def no_args() -> str:
    return ""


SIGNATURES = [get_weather, find_hotels, find_flights, scalars, optionals, containers,
              literals, defaults, unannotated, no_args]


@pytest.mark.parametrize("fn", SIGNATURES, ids=lambda f: f.__name__)
def test_tool_def_equals_reference(fn):
    port, ref = function_schema(fn), ref_schema(fn)
    assert port.tool_def.model_dump(mode="json") == ref.tool_def.model_dump(mode="json")
    # the rendering a prompt sees: key order included
    assert json.dumps(port.tool_def.parameters_schema) == json.dumps(ref.tool_def.parameters_schema)
    assert port.takes_ctx == ref.takes_ctx
    assert port.tool_def.description == ref.tool_def.description


def _example_tools():
    """Every ``@agent_tool`` function of the repo's examples and tests,
    rebuilt from its source with the port's decorator."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    found = {}
    for path in sorted([*root.glob("examples/**/*.py"), *root.glob("tests/*.py")]):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            names = [getattr(d, "id", getattr(getattr(d, "func", None), "id", None))
                     for d in node.decorator_list]
            if "agent_tool" in names:
                node.decorator_list = []
                src = ast.unparse(node)
                found.setdefault((node.name, ast.unparse(node.args)), src)
    return sorted(found.items())


EXAMPLE_TOOLS = _example_tools()


@pytest.mark.parametrize("key,src", EXAMPLE_TOOLS, ids=[k[0] for k, _ in EXAMPLE_TOOLS])
def test_repo_tool_signatures_equal_reference(key, src):
    namespace: dict = {"Any": Any, "Optional": Optional, "Literal": Literal}
    exec(src, namespace)  # noqa: S102 - the repo's own tool definitions
    fn = namespace[key[0]]
    port, ref = function_schema(fn), ref_schema(fn)
    assert json.dumps(port.tool_def.model_dump(mode="json")) == json.dumps(
        ref.tool_def.model_dump(mode="json")
    )


def test_the_table_covers_every_repo_tool_annotation():
    assert len(EXAMPLE_TOOLS) >= 20
    seen = set()
    for (_, args), _src in EXAMPLE_TOOLS:
        seen.update(part.split(":")[1].split("=")[0].strip() for part in args.split(", ") if ":" in part)
    assert seen <= {"str", "int", "float", "bool", "dict", "list[str]", "list[dict]"}, seen


@pytest.mark.parametrize("annotation", [tuple, set[int], "int | str", complex, dict[int, str]],
                         ids=str)
def test_unsupported_annotations_raise_at_definition(annotation):
    def tool(x) -> str:
        return ""

    tool.__annotations__ = {"x": annotation, "return": str}
    with pytest.raises(ToolSchemaError):
        function_schema(tool)


def _outcome(schema, args):
    try:
        return "ok", schema.validate_args(args)
    except (ValidationError, RefValidationError) as exc:
        return "refused", sorted((e["type"], e["loc"]) for e in exc.errors())


TABLE = [
    (find_hotels, {"city": "Paris"}),
    (find_hotels, {}),
    (find_hotels, {"city": "Paris", "nights": "3"}),
    (find_hotels, {"city": "Paris", "nights": 3.0}),
    (find_hotels, {"city": "Paris", "nights": 3.5}),
    (find_hotels, {"city": "Paris", "nights": True}),
    (find_hotels, {"city": 3}),
    (find_hotels, {"city": "Paris", "zzz": 1}),
    (find_hotels, {"city": None, "nights": "x", "extra": [1]}),
    (scalars, {"s": "a", "i": " 7 ", "f": "1e3", "b": "yes", "n": None, "a": [1]}),
    (scalars, {"s": "a", "i": "1_000", "f": 2, "b": "off", "n": None, "a": None}),
    (scalars, {"s": "a", "i": 1, "f": "nan", "b": "TRUE", "n": 0, "a": 1}),
    (scalars, {"s": "a", "i": 1, "f": 1.0, "b": 2, "n": None, "a": 1}),
    (scalars, {"s": "a", "i": 1, "f": 1.0, "b": 1.0, "n": None, "a": 1}),
    (optionals, {"a": None, "b": None}),
    (optionals, {"a": "4", "b": "s", "c": "2.5", "d": "no"}),
    (containers, {"a": ["x"], "b": ["1", 2.0], "c": {"k": "3"}, "d": {"k": None}, "e": [1], "f": {}}),
    (containers, {"a": "x", "b": [1.5], "c": {"k": None}, "d": [], "e": {}, "f": []}),
    (literals, {"mode": "fast"}),
    (literals, {"mode": "medium", "level": 4}),
    (literals, {"mode": "slow", "level": 2.0, "flag": 1, "maybe": "b"}),
    (literals, {"mode": "slow", "level": "2", "flag": "true", "maybe": "c"}),
    (defaults, {}),
    (unannotated, {"q": {"any": "thing"}}),
    (no_args, {}),
    (no_args, {"x": 1}),
]


@pytest.mark.parametrize("fn,args", TABLE, ids=[f"{f.__name__}-{i}" for i, (f, _) in enumerate(TABLE)])
def test_validate_args_table(fn, args):
    port, ref = _outcome(function_schema(fn), args), _outcome(ref_schema(fn), args)
    assert port == ref
    if port[0] == "ok":
        assert [type(v) for v in port[1].values()] == [type(v) for v in ref[1].values()]


# hypothesis over the supported set: JSON values against each signature
json_values = st.recursive(
    st.none() | st.booleans() | st.integers(-10**6, 10**6)
    | st.floats(allow_nan=False, allow_infinity=False, width=32)
    | st.sampled_from(["0", "1", "3", "3.0", "-2", " 4 ", "1_0", "true", "False", "yes",
                       "off", "n", "fast", "slow", "a", "b", "2.5", "1e2", "", "x"])
    | st.text(max_size=4),
    lambda children: st.lists(children, max_size=3) | st.dictionaries(
        st.sampled_from(["k", "x", "1"]), children, max_size=2
    ),
    max_leaves=6,
)


def _arg_dicts(fn):
    import inspect

    names = [n for n in inspect.signature(fn).parameters if n not in ("ctx",)]
    return st.dictionaries(st.sampled_from(names + ["zzz"]), json_values, max_size=len(names) + 1)


@pytest.mark.parametrize("fn", [scalars, optionals, containers, literals, defaults, find_hotels],
                         ids=lambda f: f.__name__)
@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_validate_args_matches_reference_lax_mode(fn, data):
    args = data.draw(_arg_dicts(fn))
    port, ref = _outcome(function_schema(fn), args), _outcome(ref_schema(fn), args)
    assert port == ref, args
    if port[0] == "ok":
        assert [type(v) for v in port[1].values()] == [type(v) for v in ref[1].values()]


@pytest.mark.parametrize("root", ["calfkit_tpu", "calfkit_tpu_torch"])
async def test_bad_arguments_answer_the_model_with_a_retry(root):
    import importlib

    nodes = importlib.import_module(f"{root}.nodes")
    M = importlib.import_module(f"{root}.models")
    engine = importlib.import_module(f"{root}.engine")
    InMemoryMesh = importlib.import_module(f"{root}.mesh").InMemoryMesh
    Worker = importlib.import_module(f"{root}.worker").Worker
    Client = importlib.import_module(f"{root}.client").Client

    @nodes.agent_tool
    def fussy(x: int, mode: Literal["a", "b"] = "a") -> str:
        return "fine"

    seen: list = []

    def scripted(messages, params):
        if len(messages) == 1:
            return M.ModelResponse(parts=[M.ToolCallOutput(
                tool_call_id="c1", tool_name="fussy", args={"x": "nope", "mode": "c", "q": 1},
            )])
        seen.append(messages[-1].parts[0])
        return M.ModelResponse(parts=[M.TextOutput(text="done")])

    agent = nodes.Agent("retrier", model=engine.FunctionModelClient(scripted), tools=[fussy])
    mesh = InMemoryMesh()
    async with Worker([agent, fussy], mesh=mesh, owns_transport=True):
        client = Client.connect(mesh)
        result = await client.agent("retrier").execute("go", timeout=10)
        await client.close()
    assert result.output == "done"
    part = seen[0]
    assert part.kind == "retry" and part.tool_name == "fussy"
    assert part.content.startswith("Invalid arguments for fussy:")
    assert "3 validation errors for fussy_args" in part.content
    for field in ("\nx\n", "\nmode\n", "\nq\n"):
        assert field in part.content


def test_chip_smoke_tools_derive_the_hand_written_schemas():
    """Phase 15 of the card's smoke script holds the port's derivation of
    its three tools equal to ``MESH_TOOLS`` (the hand-written ``AGENT_TOOLS``
    with the keys a derived schema adds); here the JAX package's pydantic
    derivation of the same functions gives the same, byte for byte as the
    prompt renders it."""
    import chip_smoke

    fns = (chip_smoke.get_weather, chip_smoke.search_flights, chip_smoke.book_hotel)
    assert [function_schema(fn).tool_def for fn in fns] == chip_smoke.MESH_TOOLS
    assert [json.dumps(ref_schema(fn).tool_def.model_dump()) for fn in fns] == [
        json.dumps(t.model_dump()) for t in chip_smoke.MESH_TOOLS
    ]
