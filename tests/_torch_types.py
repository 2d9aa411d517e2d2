"""Hypothesis strategies over Python types and the values they validate,
for holding the port's ``Adapter`` against pydantic's ``TypeAdapter``.

:func:`types_strategy` draws annotations nested to depth 3: the scalars,
``Any``, ``datetime``/``date``, ``Literal``, generated ``Enum`` classes
(plain and ``str``/``int`` mixins), ``list``, ``tuple[X, ...]`` and fixed
tuples, ``set``/``frozenset`` of hashable types, ``dict`` with ``str``,
``int``, ``Enum`` and ``Literal`` keys, ``Optional``, unions of two or
three members, generated dataclasses (defaults and ``default_factory``
fields among them) and ``TypedDict`` classes (total or not).
:func:`values_for` draws input values for one type: values built from the
type (valid, or one step off: a field missing, an extra key, a wrong leaf)
and free JSON-like values.
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
import itertools
import typing
from typing import Any, Literal, Optional, TypedDict, Union

from hypothesis import strategies as st

_NAMES = itertools.count()
FIELD_NAMES = ["a", "b_c", "leg", "x1", "name", "km", "nights", "tags"]
LITERALS = ["fast", "slow", "a", 1, 2, True, 0]


def _fresh(prefix: str) -> str:
    return f"{prefix}{next(_NAMES)}"


def _enum_class(kind: str, n: int) -> type:
    if kind == "int":
        return enum.Enum(_fresh("Level"), {f"L{i}": i + 1 for i in range(n)})
    if kind == "int-mixin":
        return enum.IntEnum(_fresh("Rank"), {f"R{i}": i for i in range(n)})
    if kind == "str-mixin":
        return enum.StrEnum(_fresh("Mode"), {f"M{i}": f"m{i}" for i in range(n)})
    return enum.Enum(_fresh("Color"), {f"C{i}": f"c{i}" for i in range(n)})


enums = st.builds(_enum_class, st.sampled_from(["str", "int", "int-mixin", "str-mixin"]),
                  st.integers(1, 3))
literals = st.lists(st.sampled_from(LITERALS), min_size=1, max_size=3, unique_by=repr).map(
    lambda vs: Literal[tuple(vs)])
scalars = st.sampled_from([str, int, float, bool, Any, datetime.date, datetime.datetime])
hashables = st.one_of(st.sampled_from([str, int, bool]), enums, literals)
dict_keys = st.one_of(st.sampled_from([str, int]), enums,
                      st.sampled_from([Literal["a", "b"], Literal["x"]]))


def _default_for(tp: Any) -> Any:
    """A default of type ``tp`` a dataclass may hold, or ``dataclasses.MISSING``."""
    if tp is int:
        return 0
    if tp is str:
        return "x"
    if tp is bool:
        return False
    if typing.get_origin(tp) is Literal:
        return typing.get_args(tp)[0]
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return next(iter(tp))
    if typing.get_origin(tp) is Union and type(None) in typing.get_args(tp):
        return None
    if typing.get_origin(tp) is tuple and typing.get_args(tp)[-1:] == (Ellipsis,):
        return ()
    return dataclasses.MISSING


def _factory_for(tp: Any) -> Any:
    origin = typing.get_origin(tp)
    return {list: list, dict: dict, set: set}.get(origin, dataclasses.MISSING)


@st.composite
def _dataclass(draw, children):
    names = draw(st.lists(st.sampled_from(FIELD_NAMES), min_size=1, max_size=4, unique=True))
    fields = []
    for name in names:
        tp = draw(children)
        how = draw(st.sampled_from(["required", "default", "factory"]))
        default, factory = _default_for(tp), _factory_for(tp)
        if how == "default" and default is not dataclasses.MISSING:
            fields.append((name, tp, dataclasses.field(default=default)))
        elif how == "factory" and factory is not dataclasses.MISSING:
            fields.append((name, tp, dataclasses.field(default_factory=factory)))
        else:
            fields.append((name, tp))
    # required fields first, as a dataclass needs them
    fields.sort(key=lambda f: len(f) == 3)
    return dataclasses.make_dataclass(_fresh("Rec"), fields)


@st.composite
def _typeddict(draw, children):
    names = draw(st.lists(st.sampled_from(FIELD_NAMES), min_size=1, max_size=4, unique=True))
    return TypedDict(_fresh("Doc"), {n: draw(children) for n in names},
                     total=draw(st.booleans()))


def _extend(children):
    return st.one_of(
        st.builds(lambda t: list[t], children),
        st.builds(lambda t: tuple[t, ...], children),
        st.lists(children, min_size=1, max_size=3).map(lambda ts: tuple[tuple(ts)]),
        st.builds(lambda t: set[t], hashables),
        st.builds(lambda t: frozenset[t], hashables),
        st.builds(lambda k, v: dict[k, v], dict_keys, children),
        st.builds(lambda t: Optional[t], children),
        st.lists(children, min_size=2, max_size=3).map(lambda ts: Union[tuple(ts)]),
        _dataclass(children),
        _typeddict(children),
    )


def types_strategy():
    """Annotations nested to depth 3."""
    leaves = st.one_of(scalars, literals, enums)
    return st.recursive(leaves, _extend, max_leaves=5)


json_values = st.recursive(
    st.none() | st.booleans() | st.integers(-5, 5) | st.floats(allow_nan=False,
                                                              allow_infinity=False, width=32)
    | st.sampled_from(["0", "1", "3.0", " 4 ", "true", "no", "fast", "a", "c0", "m1", "x",
                       "2026-01-02", "2026-01-02T03:04:05", "2026-01-02T03:04:05Z", ""]),
    lambda kids: st.lists(kids, max_size=3) | st.dictionaries(
        st.sampled_from(FIELD_NAMES + ["1", "zz"]), kids, max_size=3),
    max_leaves=6,
)


@st.composite
def built_value(draw, tp: Any, depth: int = 0) -> Any:
    """A value made from ``tp``: valid at most places, one step off at some."""
    if draw(st.integers(0, 9)) == 0 or depth > 4:
        return draw(json_values)
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if tp is Any:
        return draw(json_values)
    if tp in (str, int, float, bool):
        return draw({str: st.text(max_size=3) | st.sampled_from(["1", "x"]),
                     int: st.integers(-3, 3) | st.sampled_from(["2", 2.0]),
                     float: st.floats(-2, 2, width=32) | st.integers(-2, 2),
                     bool: st.booleans() | st.sampled_from([0, 1, "yes"])}[tp])
    if tp is datetime.date:
        return draw(st.sampled_from(["2026-01-02", datetime.date(2026, 1, 2), 0]))
    if tp is datetime.datetime:
        return draw(st.sampled_from(["2026-01-02T03:04:05", "2026-01-02T03:04:05Z",
                                     datetime.datetime(2026, 1, 2), 1700000000]))
    if origin is Literal:
        return draw(st.sampled_from(args))
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        member = draw(st.sampled_from(list(tp)))
        return draw(st.sampled_from([member, member.value]))
    if origin is Union:
        return draw(built_value(draw(st.sampled_from(args)), depth + 1))
    if origin in (list, set, frozenset) or (origin is tuple and args[-1:] == (Ellipsis,)):
        items = draw(st.lists(built_value(args[0], depth + 1), max_size=3))
        return draw(st.sampled_from([items, tuple(items)]))
    if origin is tuple:
        items = [draw(built_value(a, depth + 1)) for a in args]
        return items[: draw(st.integers(len(items) - 1, len(items)))] if items else items
    if origin is dict:
        keys = draw(st.lists(built_value(args[0], depth + 1), max_size=2))
        out = {}
        for k in keys:
            try:
                out[k] = draw(built_value(args[1], depth + 1))
            except TypeError:  # an unhashable key
                pass
        return out
    hints = typing.get_type_hints(tp)
    out = {name: draw(built_value(hint, depth + 1)) for name, hint in hints.items()
           if draw(st.integers(0, 5))}
    if draw(st.booleans()):
        out["zz"] = 1
    if dataclasses.is_dataclass(tp) and draw(st.integers(0, 4)) == 0:
        try:
            return tp(**{k: v for k, v in out.items() if k in hints})
        except TypeError:
            pass
    return out
