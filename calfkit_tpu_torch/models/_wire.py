"""The wire codec of the port's mesh types: dataclass <-> JSON dict <-> bytes.

Every record body that travels on the mesh (envelopes, step batches,
control-plane adverts, fan-out tables) is a dataclass deriving from
:class:`Wire`.  The codec gives those dataclasses the serialization laws
of the JAX package's pydantic models of the same names, without pydantic
(the card's machine has none):

- **encode** (:meth:`Wire.model_dump`, :meth:`Wire.model_dump_json`):
  fields in declaration order (base class first), nested wire types as
  dicts, ``exclude_none`` dropping ``None`` fields of every wire type in
  the tree (never ``None`` values of a plain dict), and in ``json`` mode
  tuples and sets as lists, bytes as text and non-string dict keys as
  strings (non-finite floats stay floats in the data and are ``null`` in
  the JSON text);
- **decode** (:meth:`Wire.model_validate`, :meth:`Wire.model_validate_json`):
  type-directed over the field annotations (``Optional``, ``Literal``,
  lists, dicts, nested wire types, discriminated unions on ``kind`` /
  ``role``), defaults and ``default_factory`` for absent fields, unknown
  keys dropped (forward compatibility) unless the class keeps them
  (``__wire_extra__ = "allow"``) or refuses them (``"forbid"``), and the
  lax law of :func:`coerce` (``"3"`` for an ``int``, ``1`` for a
  ``float``, ``"yes"`` for a ``bool``; tuples, sets, enums, dataclasses,
  ``TypedDict``, dates and other unions as pydantic's lax mode takes
  them, a union's choice by its smart mode), which
  :mod:`calfkit_tpu_torch.models._adapter` validates every type through;
- **construction** copies list and dict fields (a caller's later mutation
  of the list it passed does not reach the record) and widens an ``int``
  given to a ``float`` field, as validation at construction does there.

Failures raise :class:`ValidationError` (a ``ValueError``).  The same
law validates tool arguments in :mod:`calfkit_tpu_torch.engine.schema`.
"""

from __future__ import annotations

import collections as _collections
import copy as _copy
import dataclasses
import datetime as _dt
import enum
import functools
import json
import math
import re
import types
import typing
from typing import Any, ClassVar, Literal, Union

__all__ = ["ValidationError", "Wire", "coerce", "to_jsonable"]

_MISSING = dataclasses.MISSING


# --------------------------------------------------------------------------- #
# errors
# --------------------------------------------------------------------------- #


class ValidationError(ValueError):
    """A value did not satisfy its declared type.

    ``errors()`` lists one dict a failing location (``type``, ``loc``,
    ``msg``, ``input``); ``str()`` renders them one location a block."""

    def __init__(self, title: str, errors: list[dict[str, Any]]):
        self.title = title
        self._errors = errors
        super().__init__(self._render())

    def errors(self) -> list[dict[str, Any]]:
        return [dict(e) for e in self._errors]

    def error_count(self) -> int:
        return len(self._errors)

    def _render(self) -> str:
        n = len(self._errors)
        lines = [f"{n} validation error{'' if n == 1 else 's'} for {self.title}"]
        for e in self._errors:
            loc = ".".join(str(p) for p in e["loc"])
            value = e["input"]
            lines.append(loc)
            lines.append(
                f"  {e['msg']} [type={e['type']}, input_value={_short_repr(value)}, "
                f"input_type={type(value).__name__}]"
            )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self._render()


def _short_repr(value: Any) -> str:
    try:
        text = repr(value)
    except Exception:  # noqa: BLE001 - hostile __repr__
        text = object.__repr__(value)
    return text if len(text) <= 100 else text[:49] + "..." + text[-48:]


class _Fail(Exception):
    """One failure at a location inside a value (internal)."""

    def __init__(self, kind: str, msg: str, value: Any, loc: tuple = ()):
        self.kind, self.msg, self.value, self.loc = kind, msg, value, loc

    def at(self, *prefix: Any) -> "_Fail":
        return _Fail(self.kind, self.msg, self.value, (*prefix, *self.loc))

    def as_dict(self) -> dict[str, Any]:
        return {"type": self.kind, "loc": self.loc, "msg": self.msg, "input": self.value}


# --------------------------------------------------------------------------- #
# the lax scalar law
# --------------------------------------------------------------------------- #

_INT_TEXT = re.compile(r"[+-]?\d+(?:_\d+)*(?:\.0*)?")
_FLOAT_TEXT = re.compile(
    r"[+-]?(?:(?:\d+(?:_\d+)*)?\.?\d+(?:_\d+)*(?:[eE][+-]?\d+)?|\d+(?:_\d+)*\.|inf|infinity|nan)",
    re.IGNORECASE,
)
_TRUE_TEXT = frozenset({"1", "on", "t", "true", "y", "yes"})
_FALSE_TEXT = frozenset({"0", "off", "f", "false", "n", "no"})


def _int(v: Any) -> int:
    if type(v) is int:
        return v
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, enum.Enum) and not isinstance(v, int) \
            and isinstance(v.value, (int, str)) and not isinstance(v.value, bool):
        return v.value  # a plain enum's member stands for its value (as there)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise _Fail("finite_number", "Input should be a finite number", v)
        if v != int(v):
            raise _Fail(
                "int_from_float",
                "Input should be a valid integer, got a number with a fractional part",
                v,
            )
        if not -(2**63) < v < 2**63:
            raise _Fail(
                "int_parsing_size",
                "Unable to parse input string as an integer, exceeded maximum size",
                v,
            )
        return int(v)
    if isinstance(v, (str, bytes)):
        text = v.decode() if isinstance(v, bytes) else v
        text = text.strip()
        if text.isascii() and _INT_TEXT.fullmatch(text):
            return int(text.split(".")[0].replace("_", ""))
        raise _Fail(
            "int_parsing",
            "Input should be a valid integer, unable to parse string as an integer",
            v,
        )
    if isinstance(v, int):
        return int(v)
    raise _Fail("int_type", "Input should be a valid integer", v)


def _float(v: Any) -> float:
    if isinstance(v, float):
        return v
    if isinstance(v, (bool, int)):
        return float(v)
    if isinstance(v, (str, bytes)):
        text = (v.decode() if isinstance(v, bytes) else v).strip()
        if text.isascii() and _FLOAT_TEXT.fullmatch(text):
            return float(text)
        raise _Fail(
            "float_parsing",
            "Input should be a valid number, unable to parse string as a number",
            v,
        )
    raise _Fail("float_type", "Input should be a valid number", v)


def _bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        if v in (0, 1):
            return bool(v)
        raise _Fail(
            "bool_parsing", "Input should be a valid boolean, unable to interpret input", v
        )
    if isinstance(v, float):
        if v in (0.0, 1.0):
            return bool(v)
        if math.isfinite(v) and v == int(v) and -(2**63) < v < 2**63:
            raise _Fail(
                "bool_parsing", "Input should be a valid boolean, unable to interpret input", v
            )
        raise _Fail("bool_type", "Input should be a valid boolean", v)
    if isinstance(v, str):
        text = v.strip().lower()
        if text in _TRUE_TEXT:
            return True
        if text in _FALSE_TEXT:
            return False
        raise _Fail(
            "bool_parsing", "Input should be a valid boolean, unable to interpret input", v
        )
    raise _Fail("bool_type", "Input should be a valid boolean", v)


def _str(v: Any) -> str:
    if isinstance(v, str):
        return v if type(v) is str or not isinstance(v, enum.Enum) else str.__str__(v)
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, enum.Enum) and isinstance(v.value, (str, int)) \
            and not isinstance(v.value, bool):
        return str(v.value)
    raise _Fail("string_type", "Input should be a valid string", v)


def _complex(v: Any) -> complex:
    if isinstance(v, complex):
        return v
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return complex(v)
    if isinstance(v, str):
        try:
            return complex(v.strip())
        except ValueError:
            pass
    raise _Fail(
        "complex_type",
        "Input should be a valid python complex object, a number, or a valid complex string "
        "following the rules at https://docs.python.org/3/library/functions.html#complex",
        v,
    )


_SCALARS: dict[Any, Any] = {int: _int, float: _float, bool: _bool, str: _str, complex: _complex}

# how exactly a value matched its type, the key of a union's choice
# (pydantic's smart mode): coerced, already valid under the strict law
# (an int for a float, a subclass, an ``Any``), or of exactly the type
_LAX, _STRICT, _EXACT = 0, 1, 2


class _State:
    """One validation's running exactness, and the count of fields the
    last record validated (a dataclass, TypedDict or model) took from its
    input: a union prefers the choice that set more fields, then the more
    exact one."""

    __slots__ = ("exact", "fields")

    def __init__(self) -> None:
        self.exact = _EXACT
        self.fields: "int | None" = None

    def floor(self, level: int) -> None:
        if level < self.exact:
            self.exact = level


def _scalar_exactness(tp: type, v: Any) -> int:
    if type(v) is tp:
        return _EXACT
    if tp is bool or isinstance(v, bool):
        return _LAX
    if isinstance(v, tp) or (tp is float and isinstance(v, int)):
        return _STRICT
    return _LAX


def _expected(values: "list | tuple") -> str:
    """pydantic's listing of the allowed values: ``'a', 1 or None``."""
    shown = [repr(v) for v in values]
    return shown[0] if len(shown) == 1 else ", ".join(shown[:-1]) + " or " + shown[-1]


def _literal(args: tuple, v: Any) -> Any:
    """The allowed value ``v`` stands for: one of its own type first, then
    one equal under the lax law (a literal match counts as exact there)."""
    for allowed in args:
        if type(v) is type(allowed) and v == allowed:
            return allowed
    for allowed in args:
        if isinstance(allowed, bool):
            if isinstance(v, bool) or (type(v) in (int, float) and v in (0, 1)):
                if bool(v) is allowed:
                    return allowed
        elif isinstance(allowed, int):
            if isinstance(v, (bool, int, float)) and not isinstance(v, str) and v == allowed:
                return allowed
        elif allowed is None and v is None:
            return None
    raise _Fail("literal_error", f"Input should be {_expected(args)}", v)


def _enum(cls: type, v: Any, st: _State) -> Any:
    if isinstance(v, cls):
        return v
    members = list(cls)
    key = v
    try:
        if issubclass(cls, bool):
            key = _bool(v)
        elif issubclass(cls, int):
            key = _int(v)
        elif issubclass(cls, float):
            key = _float(v)
        elif issubclass(cls, str):
            key = _str(v)
    except _Fail:
        key = _MISSING
    for member in members:
        try:
            if member.value == key and hash(member.value) == hash(key):
                st.floor(_LAX)
                return member
        except TypeError:  # an unhashable input matches no member
            break
    raise _Fail("enum", f"Input should be {_expected([m.value for m in members])}", v)


def _enum_label(cls: type) -> str:
    for base, name in ((int, "int-enum"), (str, "str-enum"), (float, "float-enum")):
        if issubclass(cls, base):
            return f"{name}[{cls.__name__}]"
    return f"enum[{cls.__name__}]"


def _label(tp: Any) -> str:
    """pydantic's short name of a union choice (an error's location step)."""
    if tp is Any or tp is object:
        return "any"
    if tp is None or tp is type(None):
        return "none"
    if tp in _SCALARS or tp in (_dt.datetime, _dt.date):
        return tp.__name__
    members = _union_members(tp)
    if members is not None:
        choices = [m for m in members if m is not type(None)]
        inner = _label(choices[0]) if len(choices) == 1 else (
            "union[" + ",".join(_label(m) for m in choices) + "]")
        return f"nullable[{inner}]" if len(choices) < len(members) else inner
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin is Literal:
        return "literal[" + ",".join(repr(a) for a in args) + "]"
    for kind in (list, set, frozenset):
        if tp is kind or origin is kind:
            return f"{kind.__name__}[{_label(args[0]) if args else 'any'}]"
    if tp is tuple or origin is tuple:
        if not args and tp is tuple:
            return "tuple[any, ...]"
        if len(args) == 2 and args[1] is Ellipsis:
            return f"tuple[{_label(args[0])}, ...]"
        return "tuple[" + ", ".join(_label(a) for a in args) + "]"
    if tp is dict or origin is dict:
        k, v = (_label(a) for a in args) if args else ("any", "any")
        return f"dict[{k},{v}]"
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return _enum_label(tp)
    return getattr(tp, "__name__", repr(tp))


def _union_members(tp: Any) -> tuple | None:
    origin = typing.get_origin(tp)
    if origin is Union or origin is types.UnionType:
        return typing.get_args(tp)
    return None


_TAGS = ("kind", "role")


@functools.lru_cache(maxsize=None)
def _discriminator(members: tuple) -> tuple[str, dict[Any, type]] | None:
    """(tag field, tag value -> member) when every member is a wire type
    whose ``kind`` (or ``role``) field is a Literal."""
    if not all(isinstance(m, type) and issubclass(m, Wire) for m in members):
        return None
    for tag in _TAGS:
        table: dict[Any, type] = {}
        for member in members:
            hint = _spec(member).hints.get(tag)
            if typing.get_origin(hint) is not Literal:
                break
            for value in typing.get_args(hint):
                table[value] = member
        else:
            return tag, table
    return None


def _tagged(members: tuple, tag: str, table: dict, v: Any, st: _State) -> Any:
    for member in members:
        if isinstance(v, member):
            return v
    if not isinstance(v, dict):
        raise _Fail("model_attributes_type", "Input should be a valid dictionary or object", v)
    if tag not in v:
        raise _Fail("union_tag_not_found", f"Unable to extract tag using discriminator '{tag}'", v)
    member = table.get(v[tag]) if isinstance(v[tag], (str, int)) else None
    if member is None:
        expected = ", ".join(repr(k) for k in table)
        raise _Fail(
            "union_tag_invalid",
            f"Input tag {v[tag]!r} found using '{tag}' does not match any of "
            f"the expected tags: {expected}",
            v,
        )
    try:
        return _load_wire(member, v, st)
    except _Fail as fail:
        raise fail.at(v[tag])


def _union(members: tuple, v: Any, st: _State) -> Any:
    """pydantic's smart mode: every choice is tried; an exact match that
    set no fields wins at once, else the choice that set the most fields,
    then the most exact one, then the first."""
    if v is None and type(None) in members:
        return None
    found = _discriminator(members)
    if found is not None:
        return _tagged(members, *found, v, st)
    choices = [m for m in members if m is not type(None)]
    if len(choices) == 1:
        return _coerce(choices[0], v, st)
    best: "tuple[Any, _State] | None" = None
    fails: list[_Fail] = []
    for member in choices:
        sub = _State()
        try:
            out = _coerce(member, v, sub)
        except _Fail as fail:
            if best is None:
                fails.extend(_flat(fail.at(_label(member))))
            continue
        if sub.exact == _EXACT and sub.fields is None:
            return out
        if best is None:
            best = (out, sub)
            continue
        cur = best[1]
        if cur.fields is not None and sub.fields is not None and cur.fields != sub.fields:
            better = cur.fields < sub.fields
        else:
            better = cur.exact < sub.exact
        if better:
            best = (out, sub)
    if best is None:
        _raise_all(fails)
    out, sub = best
    st.floor(sub.exact)
    if sub.fields is not None:
        st.fields = sub.fields
    return out


_ITERABLES = (list, tuple, set, frozenset, _collections.deque, type({}.keys()),
              type({}.values()), types.GeneratorType)


def _items(v: Any, container: type, kind: str, msg: str, st: _State) -> list:
    """``v``'s items when it can stand for a ``container`` (lax: any of the
    plain iterables, never a str, bytes or dict)."""
    if type(v) is container:
        return list(v)
    if isinstance(v, _ITERABLES):
        st.floor(_LAX)
        return list(v)
    raise _Fail(kind, msg, v)


def _each(tp: Any, items: list, st: _State) -> list:
    out, fails = [], []
    for i, item in enumerate(items):
        try:
            out.append(_coerce(tp, item, st))
        except _Fail as fail:
            fails.extend(_flat(fail.at(i)))
    _raise_all(fails)
    return out


def _tuple(tp: Any, v: Any, st: _State) -> tuple:
    items = _items(v, tuple, "tuple_type", "Input should be a valid tuple", st)
    args = typing.get_args(tp)
    if tp is tuple or (len(args) == 2 and args[1] is Ellipsis):
        return tuple(_each(args[0] if args else Any, items, st))
    if len(items) > len(args):
        raise _Fail(
            "too_long",
            f"Tuple should have at most {len(args)} item{'' if len(args) == 1 else 's'} "
            f"after validation, not {len(items)}",
            v,
        )
    out, fails = [], []
    for i, arg in enumerate(args):
        if i >= len(items):
            fails.append(_Fail("missing", "Field required", v, (i,)))
            continue
        try:
            out.append(_coerce(arg, items[i], st))
        except _Fail as fail:
            fails.extend(_flat(fail.at(i)))
    _raise_all(fails)
    return tuple(out)


_DT_TEXT = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})(?:[Tt ](\d{2}):(\d{2})(?::(\d{2})(?:[.,](\d{1,6})\d*)?)?"
    r"\s*(Z|z|[+-]\d{2}(?::?\d{2})?)?)?"
)


_NUMBER_TEXT = re.compile(r"[+-]?\d+(?:\.\d*)?")


def _parse_datetime(text: str, kind: str, what: str, v: Any) -> _dt.datetime:
    if _NUMBER_TEXT.fullmatch(text) and len(text) < 20:  # a unix timestamp, as text
        return _timestamp(float(text) if "." in text else int(text), kind, what, v)
    m = _DT_TEXT.fullmatch(text)
    if m is None:
        reason = "input is too short" if len(text) < 10 else "invalid character in year"
        raise _Fail(kind, f"Input should be a valid {what}, {reason}", v)
    year, month, day, hour, minute, second, frac, zone = m.groups()
    tz = None
    if zone in ("Z", "z"):
        tz = _dt.timezone.utc
    elif zone:
        sign = -1 if zone[0] == "-" else 1
        digits = zone[1:].replace(":", "")
        minutes = int(digits[:2]) * 60 + int(digits[2:] or 0)
        tz = _dt.timezone(sign * _dt.timedelta(minutes=minutes))
    try:
        return _dt.datetime(int(year), int(month), int(day), int(hour or 0), int(minute or 0),
                            int(second or 0), int((frac or "0").ljust(6, "0")), tzinfo=tz)
    except ValueError as exc:
        raise _Fail(kind, f"Input should be a valid {what}, {exc}", v) from None


def _timestamp(v: "int | float", kind: str, what: str, value: Any) -> _dt.datetime:
    seconds = v / 1000 if abs(v) > 2e10 else v
    try:
        return _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc) + _dt.timedelta(seconds=seconds)
    except OverflowError:
        side = "after 9999" if v > 0 else "before 0000"
        raise _Fail(kind, f"Input should be a valid {what}, dates {side} are not supported as "
                    "unix timestamps", value) from None


def _datetime(v: Any, st: _State) -> _dt.datetime:
    if isinstance(v, _dt.datetime):
        return v
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        st.floor(_LAX)
        return _timestamp(v, "datetime_parsing", "datetime", v)
    if isinstance(v, (str, bytes)):
        st.floor(_LAX)
        text = v.decode() if isinstance(v, bytes) else v
        return _parse_datetime(text, "datetime_from_date_parsing", "datetime or date", v)
    raise _Fail("datetime_type", "Input should be a valid datetime", v)


def _date(v: Any, st: _State) -> _dt.date:
    if isinstance(v, _dt.date) and not isinstance(v, _dt.datetime):
        return v
    if isinstance(v, (int, float, str, bytes, _dt.datetime)) and not isinstance(v, bool):
        st.floor(_LAX)
        if isinstance(v, _dt.datetime):
            at = v
        elif isinstance(v, (int, float)):
            at = _timestamp(v, "date_from_datetime_parsing", "date or datetime", v)
        else:
            text = v.decode() if isinstance(v, bytes) else v
            at = _parse_datetime(text, "date_from_datetime_parsing", "date or datetime", v)
        if at.time() != _dt.time(0):
            raise _Fail(
                "date_from_datetime_inexact",
                "Datetimes provided to dates should have zero time - e.g. be exact dates",
                v,
            )
        return at.date()
    raise _Fail("date_type", "Input should be a valid date", v)


@functools.lru_cache(maxsize=None)
def _typeddict_fields(cls: type) -> "tuple[tuple[str, Any, bool], ...]":
    required = getattr(cls, "__required_keys__", frozenset())
    return tuple((name, hint, name in required)
                 for name, hint in typing.get_type_hints(cls).items())


def _load_typeddict(cls: type, v: Any, st: _State) -> dict:
    if not isinstance(v, dict):
        raise _Fail("dict_type", "Input should be a valid dictionary", v)
    out: dict[str, Any] = {}
    fails: list[_Fail] = []
    for name, hint, required in _typeddict_fields(cls):
        if name in v:
            try:
                out[name] = _coerce(hint, v[name], st)
            except _Fail as fail:
                fails.extend(_flat(fail.at(name)))
        elif required:
            fails.append(_Fail("missing", "Field required", v, (name,)))
    _raise_all(fails)
    st.fields = len(out)
    return out


def is_model_type(tp: Any) -> bool:
    """Whether ``tp`` follows the model protocol (``model_json_schema``,
    ``model_validate``, ``model_dump``) of a pydantic ``BaseModel`` — found
    by duck typing, so a user's model works wherever pydantic is
    installed and this package imports none."""
    return (isinstance(tp, type) and not issubclass(tp, Wire)
            and all(callable(getattr(tp, name, None))
                    for name in ("model_json_schema", "model_validate", "model_dump")))


def _load_model(cls: type, v: Any, st: _State) -> Any:
    if isinstance(v, cls):
        return v
    try:
        out = cls.model_validate(v)
    except ValueError as exc:  # the model's own ValidationError is a ValueError
        errors = getattr(exc, "errors", None)
        if not callable(errors):
            raise
        _raise_all([_Fail(e["type"], e["msg"], e.get("input"), tuple(e["loc"]))
                    for e in errors()])
        raise
    st.floor(_STRICT)
    fields_set = getattr(out, "model_fields_set", None)
    if fields_set is not None:
        st.fields = len(fields_set)
    return out


def coerce(tp: Any, v: Any) -> Any:
    """Validate ``v`` against the annotation ``tp`` under the lax law and
    return the coerced value; raises :class:`_Fail` (internal) on refusal."""
    return _coerce(tp, v, _State())


def _coerce(tp: Any, v: Any, st: _State) -> Any:
    if tp is Any or tp is object or isinstance(tp, typing.TypeVar):
        st.floor(_STRICT)  # in a union, an Any beats a lax coercion
        return v
    if tp is None or tp is type(None):
        if v is None:
            return None
        raise _Fail("none_required", "Input should be None", v)
    scalar = _SCALARS.get(tp)
    if scalar is not None:
        out = scalar(v)
        st.floor(_scalar_exactness(tp, v))
        return out
    members = _union_members(tp)
    if members is not None:
        return _union(members, v, st)
    origin = typing.get_origin(tp)
    if origin is Literal:
        return _literal(typing.get_args(tp), v)
    if tp is list or origin is list:
        items = _items(v, list, "list_type", "Input should be a valid list", st)
        args = typing.get_args(tp)
        return _each(args[0], items, st) if args else items
    if tp is tuple or origin is tuple:
        return _tuple(tp, v, st)
    if tp in (set, frozenset) or origin in (set, frozenset):
        kind = tp if origin is None else origin
        items = (_items(v, set, "set_type", "Input should be a valid set", st) if kind is set
                 else _items(v, frozenset, "frozen_set_type", "Input should be a valid frozenset",
                             st))
        args = typing.get_args(tp)
        return kind(_each(args[0], items, st) if args else items)
    if tp is dict or origin is dict:
        if not isinstance(v, dict):
            raise _Fail("dict_type", "Input should be a valid dictionary", v)
        args = typing.get_args(tp)
        if not args:
            return dict(v)
        out_d = {}
        fails: list[_Fail] = []
        for key, item in v.items():
            # an error's location names a key by its int or str value, else its repr
            at = (int(key) if isinstance(key, int) else str.__str__(key) if isinstance(key, str)
                  else repr(key))
            k = _MISSING
            try:
                k = _coerce(args[0], key, st)
            except _Fail as fail:
                fails.extend(_flat(fail.at(at, "[key]")))
            try:
                item = _coerce(args[1], item, st)
            except _Fail as fail:
                fails.extend(_flat(fail.at(at)))
                continue
            if k is not _MISSING:
                out_d[k] = item
        _raise_all(fails)
        return out_d
    if isinstance(tp, type):
        if issubclass(tp, Wire):
            return _load_wire(tp, v, st)
        if issubclass(tp, enum.Enum):
            return _enum(tp, v, st)
        if dataclasses.is_dataclass(tp):
            return _load_dataclass(tp, v, st)
        if typing.is_typeddict(tp):
            return _load_typeddict(tp, v, st)
        if tp is _dt.datetime:
            return _datetime(v, st)
        if tp is _dt.date:
            return _date(v, st)
        if is_model_type(tp):
            return _load_model(tp, v, st)
        if isinstance(v, tp):
            return v
    raise _Fail("is_instance_of", f"Input should be an instance of {tp!r}", v)


# --------------------------------------------------------------------------- #
# per-class field tables
# --------------------------------------------------------------------------- #


class _Spec:
    __slots__ = ("fields", "names", "hints", "copies", "floats")

    def __init__(self, cls: type):
        self.fields = [f for f in dataclasses.fields(cls) if f.init]
        self.names = frozenset(f.name for f in self.fields)
        self.hints = typing.get_type_hints(cls)
        self.copies: list[tuple[str, type]] = []
        self.floats: list[str] = []
        for f in self.fields:
            hint = self.hints.get(f.name, Any)
            kind = _container(hint)
            if kind is not None:
                self.copies.append((f.name, kind))
            if _is_float(hint):
                self.floats.append(f.name)


def _container(hint: Any) -> type | None:
    """``list`` / ``dict`` when the annotation declares that container
    (directly, or as a member of an Optional or a union)."""
    members = _union_members(hint)
    for member in members if members is not None else (hint,):
        if member is list or typing.get_origin(member) is list:
            return list
        if member is dict or typing.get_origin(member) is dict:
            return dict
    return None


def _is_float(hint: Any) -> bool:
    members = _union_members(hint)
    return hint is float or (members is not None and float in members and int not in members)


def _spec(cls: type) -> _Spec:
    spec = cls.__dict__.get("_wire_spec")
    if spec is None:
        spec = _Spec(cls)
        type.__setattr__(cls, "_wire_spec", spec)
    return spec


def _load_fields(cls: type, v: Any, st: _State) -> "tuple[dict[str, Any], dict[str, Any]]":
    """A dataclass's init fields read from the dict ``v``: (the coerced
    values given, the keys that are no field); a missing field without a
    default, or a refused value, raises."""
    spec = _spec(cls)
    kwargs: dict[str, Any] = {}
    fails: list[_Fail] = []
    for f in spec.fields:
        if f.name in v:
            try:
                kwargs[f.name] = _coerce(spec.hints.get(f.name, Any), v[f.name], st)
            except _Fail as fail:
                fails.extend(_flat(fail.at(f.name)))
        elif f.default is _MISSING and f.default_factory is _MISSING:
            fails.append(_Fail("missing", "Field required", v, (f.name,)))
    extras = {k: val for k, val in v.items() if k not in spec.names}
    if getattr(cls, "__wire_extra__", "ignore") == "forbid":
        fails += [_Fail("extra_forbidden", "Extra inputs are not permitted", val, (key,))
                  for key, val in extras.items()]
    _raise_all(fails)
    st.floor(_STRICT)
    st.fields = len(kwargs)
    return kwargs, extras


def _load_dataclass(cls: type, v: Any, st: _State) -> Any:
    if isinstance(v, cls):
        return v
    if not isinstance(v, dict):
        raise _Fail(
            "dataclass_type", f"Input should be a dictionary or an instance of {cls.__name__}", v
        )
    kwargs, _ = _load_fields(cls, v, st)
    return cls(**kwargs)


def _load_wire(cls: type, v: Any, st: "_State | None" = None) -> Any:
    if isinstance(v, cls):
        return v
    if not isinstance(v, dict):
        raise _Fail(
            "model_type",
            f"Input should be a valid dictionary or instance of {cls.__name__}",
            v,
        )
    kwargs, extras = _load_fields(cls, v, st or _State())
    try:
        obj = cls(**kwargs)
    except ValidationError as exc:
        raise _Many([_Fail(e["type"], e["msg"], e["input"], e["loc"]) for e in exc.errors()])
    if extras and cls.__wire_extra__ == "allow":
        for key, val in extras.items():
            object.__setattr__(obj, key, val)
        object.__setattr__(obj, "_wire_extras", tuple(extras))
    return obj


def _flat(fail: _Fail) -> list[_Fail]:
    return list(fail.fails) if isinstance(fail, _Many) else [fail]


def _raise_all(fails: list[_Fail]) -> None:
    if len(fails) == 1:
        raise fails[0]
    if fails:
        raise _Many(fails)


class _Many(_Fail):
    def __init__(self, fails: list[_Fail]):
        super().__init__(fails[0].kind, fails[0].msg, fails[0].value, fails[0].loc)
        self.fails = fails

    def at(self, *prefix: Any) -> "_Many":
        return _Many([f.at(*prefix) for f in self.fails])


def _raise(title: str, fail: _Fail) -> typing.NoReturn:
    fails = fail.fails if isinstance(fail, _Many) else [fail]
    raise ValidationError(title, [f.as_dict() for f in fails]) from None


# --------------------------------------------------------------------------- #
# encode
# --------------------------------------------------------------------------- #


# encode modes: python objects; JSON-compatible data (non-finite floats
# kept, as a float field's JSON-mode dump keeps them); JSON text (they
# become null)
_PY, _JSON, _TEXT = 0, 1, 2


def _dump(v: Any, json_mode: int, exclude_none: bool) -> Any:
    if v is None or isinstance(v, (str, bool, int)):
        return v
    if isinstance(v, float):
        if json_mode == _TEXT and not math.isfinite(v):
            return None
        return v
    if isinstance(v, Wire):
        return v._dump_fields(json_mode, exclude_none)
    if isinstance(v, dict):
        if json_mode:
            return {_key(k): _dump(x, json_mode, exclude_none) for k, x in v.items()}
        return {k: _dump(x, json_mode, exclude_none) for k, x in v.items()}
    if isinstance(v, list):
        return [_dump(x, json_mode, exclude_none) for x in v]
    if isinstance(v, tuple):
        out = [_dump(x, json_mode, exclude_none) for x in v]
        return out if json_mode else tuple(out)
    if isinstance(v, (set, frozenset)):
        out = [_dump(x, json_mode, exclude_none) for x in v]
        return out if json_mode else type(v)(out)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {
            f.name: _dump(getattr(v, f.name), json_mode, exclude_none)
            for f in dataclasses.fields(v)
        }
    if is_model_type(type(v)):
        return v.model_dump(mode="json" if json_mode else "python", exclude_none=exclude_none)
    if not json_mode:
        return v
    if isinstance(v, enum.Enum):
        return _dump(v.value, json_mode, exclude_none)
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).decode("utf-8")
    if isinstance(v, _dt.datetime) and v.utcoffset() == _dt.timedelta(0):
        return v.replace(tzinfo=None).isoformat() + "Z"
    if isinstance(v, (_dt.datetime, _dt.date, _dt.time)):
        return v.isoformat()
    if isinstance(v, complex):
        return str(v).strip("()")
    raise TypeError(f"Unable to serialize unknown type: {type(v)!r}")


def _key(k: Any) -> str:
    if isinstance(k, str):
        return k
    if isinstance(k, tuple):
        return ",".join(_key(x) for x in k)
    if isinstance(k, bool):
        return "true" if k else "false"
    if isinstance(k, enum.Enum):
        return _key(k.value)
    return str(k)


def to_jsonable(obj: Any) -> Any:
    """``obj`` as JSON-compatible data: wire types and dataclasses as dicts,
    tuples and sets as lists, bytes as text.  Raises ``TypeError`` for a value of any other type."""
    return _dump(obj, _JSON, False)


# --------------------------------------------------------------------------- #
# the base
# --------------------------------------------------------------------------- #


class Wire:
    """Base of every wire dataclass (see the module docstring)."""

    __wire_extra__: ClassVar[str] = "ignore"

    def __post_init__(self) -> None:
        spec = _spec(type(self))
        for name, kind in spec.copies:
            value = getattr(self, name)
            if kind is list and isinstance(value, (list, tuple)):
                object.__setattr__(self, name, list(value))
            elif kind is dict and isinstance(value, dict):
                object.__setattr__(self, name, dict(value))
        for name in spec.floats:
            value = getattr(self, name)
            if type(value) is int:
                object.__setattr__(self, name, float(value))

    def __str__(self) -> str:
        # the fields as ``name=repr`` joined by spaces (a turn's usage
        # estimate of the test models counts these characters)
        return " ".join(
            f"{f.name}={getattr(self, f.name)!r}" for f in _spec(type(self)).fields
        )

    # ------------------------------------------------------------- encode
    def _dump_fields(self, json_mode: int, exclude_none: bool) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for f in _spec(type(self)).fields:
            value = getattr(self, f.name)
            if exclude_none and value is None:
                continue
            out[f.name] = _dump(value, json_mode, exclude_none)
        for key in self.__dict__.get("_wire_extras", ()):
            value = getattr(self, key)
            if not (exclude_none and value is None):
                out[key] = _dump(value, json_mode, exclude_none)
        return out

    def model_dump(self, *, mode: str = "python", exclude_none: bool = False) -> dict[str, Any]:
        return self._dump_fields(_JSON if mode == "json" else _PY, exclude_none)

    def model_dump_json(self, *, exclude_none: bool = False) -> str:
        return json.dumps(
            self._dump_fields(_TEXT, exclude_none),
            ensure_ascii=False,
            separators=(",", ":"),
            allow_nan=False,
        )

    # ------------------------------------------------------------- decode
    @classmethod
    def model_validate(cls, obj: Any) -> Any:
        try:
            return _load_wire(cls, obj)
        except _Fail as fail:
            _raise(cls.__name__, fail)

    @classmethod
    def model_validate_json(cls, data: "bytes | bytearray | str") -> Any:
        try:
            parsed = json.loads(data)
        except (TypeError, ValueError) as exc:
            raise ValidationError(
                cls.__name__,
                [{"type": "json_invalid", "loc": (), "msg": f"Invalid JSON: {exc}", "input": data}],
            ) from None
        return cls.model_validate(parsed)

    # --------------------------------------------------------------- copy
    def model_copy(self, *, update: "dict[str, Any] | None" = None, deep: bool = False) -> Any:
        """A copy, shallow unless ``deep``, with ``update``'s fields set as
        given (unvalidated)."""
        clone = _copy.deepcopy(self) if deep else _copy.copy(self)
        for key, value in (update or {}).items():
            object.__setattr__(clone, key, value)
        return clone

    @classmethod
    def model_construct(cls, **values: Any) -> Any:
        """An instance from trusted values, defaults filling the rest."""
        obj = object.__new__(cls)
        for f in dataclasses.fields(cls):
            if f.name in values:
                value = values[f.name]
            elif f.default is not _MISSING:
                value = f.default
            elif f.default_factory is not _MISSING:
                value = f.default_factory()
            else:
                continue
            object.__setattr__(obj, f.name, value)
        return obj


def invalid(title: str, field: "str | None", message: str, value: Any) -> ValidationError:
    """The error a validator raises (``type=value_error``): a field's, or
    the whole record's when ``field`` is ``None``."""
    loc = (field,) if field is not None else ()
    return ValidationError(
        title, [{"type": "value_error", "loc": loc, "msg": f"Value error, {message}", "input": value}]
    )
