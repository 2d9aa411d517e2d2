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
  lax scalar law of :func:`coerce` (``"3"`` for an ``int``, ``1`` for a
  ``float``, ``"yes"`` for a ``bool``);
- **construction** copies list and dict fields (a caller's later mutation
  of the list it passed does not reach the record) and widens an ``int``
  given to a ``float`` field, as validation at construction does there.

Failures raise :class:`ValidationError` (a ``ValueError``).  The same
scalar law validates tool arguments in :mod:`calfkit_tpu_torch.engine.schema`.
"""

from __future__ import annotations

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
        return v
    if isinstance(v, bytes):
        return v.decode()
    raise _Fail("string_type", "Input should be a valid string", v)


_SCALARS: dict[Any, Any] = {int: _int, float: _float, bool: _bool, str: _str}


def _literal(args: tuple, v: Any) -> Any:
    for allowed in args:
        if isinstance(allowed, bool):
            if isinstance(v, bool) or (type(v) is int and v in (0, 1)):
                if bool(v) is allowed:
                    return allowed
        elif isinstance(allowed, int):
            if isinstance(v, (bool, int, float)) and not isinstance(v, str) and v == allowed:
                return allowed
        elif type(v) is type(allowed) and v == allowed:
            return allowed
        elif allowed is None and v is None:
            return None
    expected = " or ".join(repr(a) for a in args)
    raise _Fail("literal_error", f"Input should be {expected}", v)


def _strict_ok(tp: Any, v: Any) -> bool:
    """Whether ``v`` is already exactly of type ``tp`` (a union's first pass)."""
    if tp is Any or tp is object:
        return True
    if tp is type(None):
        return v is None
    if tp in (int, float, str):
        return type(v) is tp
    if tp is bool:
        return isinstance(v, bool)
    origin = typing.get_origin(tp)
    if origin is Literal:
        return any(type(v) is type(a) and v == a for a in typing.get_args(tp))
    if origin is list or tp is list:
        return isinstance(v, list)
    if origin is dict or tp is dict:
        return isinstance(v, dict)
    if isinstance(tp, type) and issubclass(tp, Wire):
        return isinstance(v, tp)
    return False


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


def coerce(tp: Any, v: Any) -> Any:
    """Validate ``v`` against the annotation ``tp`` under the lax law and
    return the coerced value; raises :class:`_Fail` (internal) on refusal."""
    if tp is Any or tp is object or isinstance(tp, typing.TypeVar):
        return v
    if tp is None or tp is type(None):
        if v is None:
            return None
        raise _Fail("none_required", "Input should be None", v)
    scalar = _SCALARS.get(tp)
    if scalar is not None:
        return scalar(v)
    members = _union_members(tp)
    if members is not None:
        if v is None and type(None) in members:
            return None
        found = _discriminator(members)
        if found is not None:
            tag, table = found
            for member in members:
                if isinstance(v, member):
                    return v
            if not isinstance(v, dict):
                raise _Fail("model_attributes_type", "Input should be a valid dictionary or object", v)
            if tag not in v:
                raise _Fail(
                    "union_tag_not_found",
                    f"Unable to extract tag using discriminator '{tag}'",
                    v,
                )
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
                return _load_wire(member, v)
            except _Fail as fail:
                raise fail.at(v[tag])
        candidates = [m for m in members if m is not type(None)]
        for member in candidates:
            if _strict_ok(member, v):
                return coerce(member, v)
        first: _Fail | None = None
        for member in candidates:
            try:
                return coerce(member, v)
            except _Fail as fail:
                first = first or fail
        assert first is not None
        raise first
    origin = typing.get_origin(tp)
    if origin is Literal:
        return _literal(typing.get_args(tp), v)
    if tp is list or origin is list:
        if not isinstance(v, (list, tuple, set, frozenset)):
            raise _Fail("list_type", "Input should be a valid list", v)
        args = typing.get_args(tp)
        if not args:
            return list(v)
        out = []
        fails: list[_Fail] = []
        for i, item in enumerate(v):
            try:
                out.append(coerce(args[0], item))
            except _Fail as fail:
                fails.extend(_flat(fail.at(i)))
        _raise_all(fails)
        return out
    if tp is dict or origin is dict:
        if not isinstance(v, dict):
            raise _Fail("dict_type", "Input should be a valid dictionary", v)
        args = typing.get_args(tp)
        if not args:
            return dict(v)
        out_d = {}
        fails = []
        for key, item in v.items():
            try:
                k = coerce(args[0], key)
            except _Fail as fail:
                fails.extend(_flat(fail.at(key, "[key]")))
                continue
            try:
                out_d[k] = coerce(args[1], item)
            except _Fail as fail:
                fails.extend(_flat(fail.at(key)))
        _raise_all(fails)
        return out_d
    if isinstance(tp, type) and issubclass(tp, Wire):
        return _load_wire(tp, v)
    if isinstance(tp, type) and isinstance(v, tp):
        return v
    raise _Fail("is_instance_of", f"Input should be an instance of {tp!r}", v)


# --------------------------------------------------------------------------- #
# per-class field tables
# --------------------------------------------------------------------------- #


class _Spec:
    __slots__ = ("fields", "hints", "copies", "floats")

    def __init__(self, cls: type):
        self.fields = [f for f in dataclasses.fields(cls) if f.init]
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


def _load_wire(cls: type, v: Any) -> Any:
    if isinstance(v, cls):
        return v
    if not isinstance(v, dict):
        raise _Fail(
            "model_type",
            f"Input should be a valid dictionary or instance of {cls.__name__}",
            v,
        )
    spec = _spec(cls)
    kwargs: dict[str, Any] = {}
    fails: list[_Fail] = []
    names = set()
    for f in spec.fields:
        names.add(f.name)
        if f.name in v:
            try:
                kwargs[f.name] = coerce(spec.hints.get(f.name, Any), v[f.name])
            except _Fail as fail:
                fails.append(fail.at(f.name))
        elif f.default is _MISSING and f.default_factory is _MISSING:
            fails.append(_Fail("missing", "Field required", v, (f.name,)))
    extras = {k: val for k, val in v.items() if k not in names}
    if cls.__wire_extra__ == "forbid":
        fails += [_Fail("extra_forbidden", "Extra inputs are not permitted", val, (key,))
                  for key, val in extras.items()]
    if fails:
        if len(fails) == 1:
            raise fails[0]
        raise _Many(fails)
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
    if not json_mode:
        return v
    if isinstance(v, enum.Enum):
        return _dump(v.value, json_mode, exclude_none)
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).decode("utf-8")
    if isinstance(v, (_dt.datetime, _dt.date, _dt.time)):
        return v.isoformat()
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
