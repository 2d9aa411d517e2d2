"""The port's wire codec (``calfkit_tpu_torch.models._wire``) against the
JAX package's pydantic models.

For every wire type on the mesh's path, records are generated from seeded
random field values (numpy, driven by the port's field annotations: nested
wire types, discriminated unions on ``kind``/``role``, Optionals, Literals,
lists, dicts and free JSON under ``Any``).  The same JSON data is validated
by both packages' class of the same name, and:

- the port's ``model_dump_json`` parses to the reference's
  ``model_dump(mode="json")`` (with and without ``exclude_none``), and the
  python-mode dumps and the ``str()`` forms are equal;
- cross-decoding holds both ways: the reference's ``model_validate_json``
  of the port's bytes, and the port's decode of the reference's bytes;
- unknown keys are dropped alike (kept where the type allows extras), and
  the refusals agree: a missing required field, an unknown union tag, a
  ``FilePart`` with both or neither source, an ``AgentCard`` whose name is
  no topic or whose description is too long.
"""

from __future__ import annotations

import importlib
import inspect
import json
import typing

import numpy as np
import pytest

pytest.importorskip("pydantic")

from pydantic import ValidationError as RefValidationError  # noqa: E402

from calfkit_tpu_torch.models._wire import ValidationError, Wire, to_jsonable  # noqa: E402

MODULES = (
    "payload", "messages", "capability", "session_context", "state", "actions",
    "reply", "error_report", "marker", "tool_dispatch", "step", "node_result",
    "agents", "fanout", "records",
)


def _wire_types() -> "list[tuple[str, str]]":
    out = []
    for module in MODULES:
        port = importlib.import_module(f"calfkit_tpu_torch.models.{module}")
        for name, obj in vars(port).items():
            if (inspect.isclass(obj) and issubclass(obj, Wire)
                    and obj.__module__ == port.__name__ and not name.startswith("_")):
                out.append((module, name))
    return out


TYPES = _wire_types()
SEEDS = (0, 1, 2)


def classes(module: str, name: str):
    port = getattr(importlib.import_module(f"calfkit_tpu_torch.models.{module}"), name)
    ref = getattr(importlib.import_module(f"calfkit_tpu.models.{module}"), name)
    return port, ref


# --------------------------------------------------------------------------- #
# seeded random records, driven by the port's annotations
# --------------------------------------------------------------------------- #

_TEXT = list("abcdefghijklmnopqrstuvwxyz0123456789 _-.:/é中\"\\\n")
_SAFE = list("abcdefghijklmnopqrstuvwxyz0123456789_-.")


def _text(rng, safe=False) -> str:
    pool = _SAFE if safe else _TEXT
    return "".join(rng.choice(pool, size=int(rng.integers(1 if safe else 0, 12))))


def _json(rng, depth: int):
    kind = int(rng.integers(0, 7 if depth < 2 else 5))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-10**6, 10**6))
    if kind == 3:
        return float(np.round(rng.normal() * 100, 4))
    if kind == 4:
        return _text(rng)
    if kind == 5:
        return [_json(rng, depth + 1) for _ in range(int(rng.integers(0, 3)))]
    return {_text(rng, safe=True): _json(rng, depth + 1) for _ in range(int(rng.integers(0, 3)))}


def _members(tp):
    if typing.get_origin(tp) in (typing.Union, __import__("types").UnionType):
        return typing.get_args(tp)
    return None


def gen(tp, rng, depth: int = 0):
    """A JSON-compatible value of annotation ``tp``."""
    if tp is typing.Any or isinstance(tp, typing.TypeVar):
        return _json(rng, depth)
    if tp is type(None):
        return None
    if tp is str:
        return _text(rng)
    if tp is bool:
        return bool(rng.integers(0, 2))
    if tp is int:
        return int(rng.integers(-1000, 10**6))
    if tp is float:
        return float(np.round(rng.exponential() * 1000, 6))
    members = _members(tp)
    if members is not None:
        if type(None) in members and rng.random() < 0.3:
            return None
        choices = [m for m in members if m is not type(None)]
        if depth > 3:  # keep recursion shallow: prefer leaves
            leaves = [m for m in choices if not (inspect.isclass(m) and issubclass(m, Wire))]
            choices = leaves or choices
        return gen(choices[int(rng.integers(0, len(choices)))], rng, depth)
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Literal:
        return args[int(rng.integers(0, len(args)))]
    if origin is list or tp is list:
        n = int(rng.integers(0, 3 if depth < 3 else 1))
        return [gen(args[0] if args else typing.Any, rng, depth + 1) for _ in range(n)]
    if origin is dict or tp is dict:
        n = int(rng.integers(0, 3 if depth < 3 else 1))
        return {_text(rng, safe=True): gen(args[1] if args else typing.Any, rng, depth + 1)
                for _ in range(n)}
    if inspect.isclass(tp) and issubclass(tp, Wire):
        return gen_record(tp, rng, depth + 1)
    raise AssertionError(f"no generator for {tp!r}")


def gen_record(cls, rng, depth: int = 0) -> dict:
    hints = typing.get_type_hints(cls)
    import dataclasses

    data = {}
    for f in dataclasses.fields(cls):
        required = f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
        # a union member's tag (its Literal field) is always on the wire
        tag = typing.get_origin(hints[f.name]) is typing.Literal
        # ids and wall-clock stamps minted by a default factory differ
        # between any two constructions: always give them
        minted = getattr(f.default_factory, "__name__", "") in ("new_id", "_now")
        if required or tag or minted or rng.random() < 0.8:
            data[f.name] = gen(hints[f.name], rng, depth)
    if cls.__name__ == "FilePart":
        source = "uri" if rng.random() < 0.5 else "data_base64"
        other = "data_base64" if source == "uri" else "uri"
        data[source], data[other] = _text(rng) or "x", None
    if cls.__name__ == "AgentCard":
        data["name"] = _text(rng, safe=True)
        data["description"] = _text(rng)
    return data


def _normalized(value):
    """JSON-parsed data with ints and floats compared as numbers of one kind
    (``1.0`` and ``1`` parse alike)."""
    return json.loads(json.dumps(value))


# --------------------------------------------------------------------------- #
# the laws
# --------------------------------------------------------------------------- #


def test_every_reference_wire_type_has_a_port():
    import pydantic

    for module in MODULES:
        ref = importlib.import_module(f"calfkit_tpu.models.{module}")
        names = {
            n for n, o in vars(ref).items()
            if inspect.isclass(o) and issubclass(o, pydantic.BaseModel)
            and o.__module__ == ref.__name__ and not n.startswith("_")
        }
        assert names <= {n for m, n in TYPES if m == module}, module


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("module,name", TYPES, ids=[n for _, n in TYPES])
def test_encoding_and_cross_decoding_match(module, name, seed):
    port_cls, ref_cls = classes(module, name)
    rng = np.random.default_rng([seed, TYPES.index((module, name))])
    data = gen_record(port_cls, rng)
    ref = ref_cls.model_validate(data)
    port = port_cls.model_validate(data)

    want = ref.model_dump(mode="json")
    assert json.loads(port.model_dump_json()) == want
    assert port.model_dump(mode="json") == want
    assert json.loads(port.model_dump_json(exclude_none=True)) == ref.model_dump(
        mode="json", exclude_none=True
    )
    assert port.model_dump() == ref.model_dump()
    assert list(port.model_dump(mode="json")) == list(want)  # field order
    assert str(port) == str(ref)

    # cross-decoding, both ways
    assert ref_cls.model_validate_json(port.model_dump_json()) == ref
    back = port_cls.model_validate_json(ref.model_dump_json())
    assert back == port
    assert back.model_dump(mode="json") == want
    assert _normalized(to_jsonable(port)) == _normalized(want)

    # unknown keys: dropped alike, or kept where the type allows extras
    extra = dict(data, zz_future_field=[1, "two"])
    assert port_cls.model_validate(extra).model_dump(mode="json") == ref_cls.model_validate(
        extra
    ).model_dump(mode="json")


@pytest.mark.parametrize("module,name", TYPES, ids=[n for _, n in TYPES])
def test_missing_required_fields_are_refused_alike(module, name):
    import dataclasses

    port_cls, ref_cls = classes(module, name)
    required = [
        f.name for f in dataclasses.fields(port_cls)
        if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
    ]
    data = gen_record(port_cls, np.random.default_rng(7))
    for field in required:
        partial = {k: v for k, v in data.items() if k != field}
        with pytest.raises(RefValidationError):
            ref_cls.model_validate(partial)
        with pytest.raises(ValidationError) as caught:
            port_cls.model_validate(partial)
        assert ("missing", (field,)) in [(e["type"], e["loc"]) for e in caught.value.errors()]


def test_discriminated_unions_pick_and_refuse_alike():
    from calfkit_tpu.models import messages as RM
    from calfkit_tpu.models import state as RS
    from calfkit_tpu_torch.models import messages as PM
    from calfkit_tpu_torch.models import state as PS

    data = {"message_history": [
        {"role": "request", "parts": [{"kind": "system", "content": "s"},
                                      {"kind": "user", "content": [{"kind": "text", "text": "t"}]},
                                      {"kind": "tool_return", "tool_call_id": "1", "tool_name": "f",
                                       "content": {"a": 1}},
                                      {"kind": "retry", "content": "again"}]},
        {"role": "response", "parts": [{"kind": "text", "text": "x"},
                                       {"kind": "tool_call", "tool_call_id": "2", "tool_name": "g",
                                        "args": "{\"q\": 1}"}]},
    ], "tool_results": {"1": {"kind": "retry", "content": "r"}}}
    ref, port = RS.State.model_validate(data), PS.State.model_validate(data)
    assert port.model_dump(mode="json") == ref.model_dump(mode="json")
    assert [type(m).__name__ for m in port.message_history] == ["ModelRequest", "ModelResponse"]
    assert isinstance(port.message_history[0].parts[1].content[0], __import__(
        "calfkit_tpu_torch.models.payload", fromlist=["TextPart"]).TextPart)
    assert isinstance(port.message_history[1], PM.ModelResponse)
    assert isinstance(ref.message_history[1], RM.ModelResponse)
    for bad in ({"role": "nope", "parts": []}, {"parts": []},
                {"role": "request", "parts": [{"kind": "bogus"}]},
                {"role": "request", "parts": [{"content": "no kind"}]}):
        with pytest.raises(RefValidationError):
            RS.State.model_validate({"message_history": [bad]})
        with pytest.raises(ValidationError):
            PS.State.model_validate({"message_history": [bad]})


@pytest.mark.parametrize("data", [
    {"kind": "file"},
    {"kind": "file", "uri": "u", "data_base64": "AA=="},
])
def test_file_part_source_law(data):
    from calfkit_tpu.models.payload import FilePart as RefFilePart
    from calfkit_tpu_torch.models.payload import FilePart

    with pytest.raises(RefValidationError):
        RefFilePart.model_validate(data)
    with pytest.raises(ValidationError, match="exactly one of data_base64 or uri"):
        FilePart.model_validate(data)
    with pytest.raises(ValueError):
        FilePart(**{k: v for k, v in data.items() if k != "kind"})


@pytest.mark.parametrize("data", [
    {"name": "bad name!"},
    {"name": "x" * 300},
    {"name": "ok", "description": "d" * 513},
])
def test_agent_card_validators_refuse_alike(data):
    from calfkit_tpu.models.agents import AgentCard as RefCard
    from calfkit_tpu_torch.models.agents import AgentCard

    with pytest.raises(RefValidationError) as ref_caught:
        RefCard.model_validate(data)
    with pytest.raises(ValidationError) as caught:
        AgentCard.model_validate(data)
    assert [e["loc"] for e in caught.value.errors()] == [e["loc"] for e in ref_caught.value.errors()]
    with pytest.raises(ValueError):
        AgentCard(**data)
    ok = {**data, "name": "ok", "description": "fine"}
    assert AgentCard(**ok).derive_input_topic() == RefCard(**ok).derive_input_topic()


def test_envelope_wire_bytes_cross_decode():
    from calfkit_tpu.models import session_context as RC
    from calfkit_tpu_torch.models import session_context as PC

    data = gen_record(PC.Envelope, np.random.default_rng(11))
    ref, port = RC.Envelope.model_validate(data), PC.Envelope.model_validate(data)
    assert json.loads(port.to_wire()) == json.loads(ref.to_wire())
    assert PC.Envelope.from_wire(ref.to_wire()) == port
    assert RC.Envelope.from_wire(port.to_wire()) == ref


def test_construction_copies_containers_and_widens_floats():
    from calfkit_tpu.models.step import InferenceStep as RefStep
    from calfkit_tpu_torch.models.messages import ModelRequest, UserPart
    from calfkit_tpu_torch.models.step import InferenceStep

    parts = [UserPart(content="a")]
    request = ModelRequest(parts=parts)
    parts.append(UserPart(content="b"))
    assert len(request.parts) == 1
    assert InferenceStep(prefill_ms=5).model_dump_json() == RefStep(prefill_ms=5).model_dump_json()
    assert type(InferenceStep(prefill_ms=5).prefill_ms) is float


def test_to_jsonable_refuses_what_the_reference_refuses():
    from pydantic_core import to_jsonable_python

    class Opaque:
        pass

    for value in ({"a": (1, 2), 3: {4}}, [b"bytes", float("inf")], ("x", None)):
        assert to_jsonable(value) == to_jsonable_python(value)
    with pytest.raises(ValueError):
        to_jsonable_python(Opaque())
    with pytest.raises(TypeError):
        to_jsonable(Opaque())
