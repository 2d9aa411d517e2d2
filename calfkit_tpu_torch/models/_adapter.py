"""A type's JSON schema, validation and JSON dump without pydantic.

The port's counterpart of the ``pydantic.TypeAdapter`` the JAX package
builds for structured output and tool arguments.  ``Adapter(tp)`` gives

- :meth:`Adapter.json_schema`: pydantic's ``TypeAdapter(tp).json_schema()``
  — nested classes under ``$defs`` and ``$ref``, titles, ``required``,
  defaults, and its key order (every mapping's keys sorted, except those of
  ``properties`` and of a ``default``);
- :meth:`Adapter.validate_python`: pydantic's lax-mode answer — the same
  values accepted, coerced the same way, refused with the same error
  ``type`` and ``loc`` — through :func:`calfkit_tpu_torch.models._wire.coerce`;
- :meth:`Adapter.dump`: ``to_jsonable_python``'s JSON-compatible data.

The types: ``str``, ``int``, ``float``, ``bool``, ``complex``, ``None``,
``Any``, ``Literal``, ``Enum`` (plain, ``str`` and ``int`` valued), ``list``,
``tuple[X, ...]`` and fixed tuples, ``set``/``frozenset``, ``dict[K, V]``
with ``str``, ``int``, ``Enum`` or ``Literal`` keys, any ``Union`` and
``Optional`` (pydantic's smart mode), ``datetime``/``date``, dataclasses
(nested, with defaults and ``default_factory``), ``TypedDict`` (total or
not), the port's :class:`~calfkit_tpu_torch.models._wire.Wire` types, and a
class with the model protocol (``model_json_schema``, ``model_validate``,
``model_dump``; a pydantic ``BaseModel``), driven through those methods.
Any other annotation raises :class:`ToolSchemaError` when the adapter is
made, as pydantic refuses a type it has no schema for.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import enum
import inspect
import re
import types
import typing
from typing import Any, Literal, Union

from calfkit_tpu_torch.models._wire import (
    ValidationError,
    Wire,
    _Fail,
    _discriminator,
    _label,
    _raise,
    coerce,
    is_model_type,
    to_jsonable,
)

__all__ = ["OPTIONAL", "REQUIRED", "Adapter", "ToolSchemaError", "ValidationError",
           "object_schema"]


class ToolSchemaError(TypeError):
    """A type (or a tool signature) has no JSON schema."""


_NULL = type(None)
_SCALAR_TYPES = {str: "string", int: "integer", float: "number", bool: "boolean"}
_JSON_TYPES = {str: "string", int: "integer", float: "number", bool: "boolean",
               list: "array", _NULL: "null"}


def _members(tp: Any) -> "tuple | None":
    origin = typing.get_origin(tp)
    if origin is Union or origin is types.UnionType:
        return typing.get_args(tp)
    return None


def _is_defined(tp: Any) -> bool:
    """Whether ``tp`` lives under ``$defs`` (a class with fields, an enum,
    a model)."""
    return isinstance(tp, type) and (
        dataclasses.is_dataclass(tp) or typing.is_typeddict(tp)
        or issubclass(tp, enum.Enum) or is_model_type(tp)
    )


def _titled(tp: Any) -> bool:
    """Whether a field of type ``tp`` gets a title (pydantic leaves it off
    a reference, alone or in an Optional)."""
    members = _members(tp)
    if members is not None:
        choices = [m for m in members if m is not _NULL]
        return not (len(choices) == 1 and _is_defined(choices[0]))
    return not _is_defined(tp)


def _field_title(name: str) -> str:
    return name.title().replace("_", " ").strip()


def _flat_any_of(schemas: "list[dict]") -> dict:
    members: list[dict] = []
    for schema in schemas:
        if len(schema) == 1 and "anyOf" in schema:
            members.extend(schema["anyOf"])
        else:
            members.append(schema)
    unique = list({_hashable(m): m for m in members}.values())
    return unique[0] if len(unique) == 1 else {"anyOf": unique}


def _hashable(value: Any) -> Any:
    if isinstance(value, dict):
        return tuple(sorted((k, _hashable(v)) for k, v in value.items()))
    if isinstance(value, list):
        return tuple(_hashable(v) for v in value)
    return value


def _sorted(value: Any, parent: "str | None" = None) -> Any:
    """pydantic's key order: sorted, except the keys of ``properties`` and of
    a ``default``."""
    if isinstance(value, dict):
        keys = value.keys() if parent in ("properties", "default") else sorted(value)
        return {k: _sorted(value[k], k) for k in keys}
    if isinstance(value, list):
        return [_sorted(v, parent) for v in value]
    return value


def _literal_schema(values: tuple) -> dict:
    expected = [v.value if isinstance(v, enum.Enum) else v for v in values]
    out: dict[str, Any] = {"const": expected[0]} if len(expected) == 1 else {"enum": expected}
    kinds = {type(v) for v in expected}
    if len(kinds) == 1 and next(iter(kinds)) in _JSON_TYPES:
        out["type"] = _JSON_TYPES[next(iter(kinds))]
    return out


def _docstring(cls: type) -> "str | None":
    doc = cls.__doc__
    if not doc or doc == "An enumeration.":
        return None
    return inspect.cleandoc(doc)


class _Schemas:
    """One schema's generation: the definitions it references, by class."""

    def __init__(self) -> None:
        self.defs: dict[type, dict] = {}
        self.extra_defs: dict[str, dict] = {}

    # ------------------------------------------------------------ naming
    def ref(self, cls: type) -> dict:
        if cls not in self.defs:
            self.defs[cls] = {}  # placeholder: a recursive class refers to itself
            self.defs[cls] = self.class_schema(cls)
        return {"$ref": f"#/$defs/{_ref_key(cls)}"}

    def final_names(self) -> dict[str, str]:
        """Each class's ``$defs`` name: its own name unless two classes with
        different schemas share it (then module and qualified name, then
        an occurrence number)."""
        by_name: dict[str, list[type]] = {}
        for cls in self.defs:
            by_name.setdefault(cls.__name__, []).append(cls)
        out: dict[str, str] = {}
        for name, classes in by_name.items():
            if len({_hashable(self.defs[c]) for c in classes}) == 1:
                for c in classes:
                    out[_ref_key(c)] = name
                continue
            counts: dict[str, int] = {}
            for c in classes:
                long = _normalize(f"{c.__module__}.{c.__qualname__}")
                counts[long] = counts.get(long, 0) + 1
            seen: dict[str, int] = {}
            for c in classes:
                long = _normalize(f"{c.__module__}.{c.__qualname__}")
                seen[long] = seen.get(long, 0) + 1
                out[_ref_key(c)] = long if counts[long] == 1 else f"{long}__{seen[long]}"
        return out

    # ----------------------------------------------------------- schemas
    def schema(self, tp: Any, where: str) -> dict:
        if tp is Any or tp is object:
            return {}
        if tp is None or tp is _NULL:
            return {"type": "null"}
        if tp in _SCALAR_TYPES:
            return {"type": _SCALAR_TYPES[tp]}
        if tp is complex:
            return {"type": "string"}
        if tp is _dt.datetime:
            return {"format": "date-time", "type": "string"}
        if tp is _dt.date:
            return {"format": "date", "type": "string"}
        members = _members(tp)
        if members is not None:
            choices = [m for m in members if m is not _NULL]
            tagged = _discriminator(tuple(choices)) if len(choices) > 1 else None
            if tagged is not None:
                # wire types told apart by a literal tag: pydantic's
                # discriminated union
                tag, table = tagged
                refs = [self.schema(m, where) for m in choices]
                inner = {"discriminator": {"mapping": {
                    value: self.schema(member, where)["$ref"] for value, member in table.items()
                }, "propertyName": tag}, "oneOf": refs}
            else:
                inner = (self.schema(choices[0], where) if len(choices) == 1
                         else _flat_any_of([self.schema(m, where) for m in choices]))
            if len(choices) == len(members):
                return inner
            null = {"type": "null"}
            return null if inner == null else _flat_any_of([inner, null])
        origin, args = typing.get_origin(tp), typing.get_args(tp)
        if origin is Literal:
            if not all(isinstance(v, (str, int, bool, enum.Enum)) or v is None for v in args):
                raise ToolSchemaError(f"{where}: Literal values must be str, int, bool or None")
            return _literal_schema(args)
        if tp is list or origin is list:
            return {"items": self.schema(args[0], where) if args else {}, "type": "array"}
        if tp in (set, frozenset) or origin in (set, frozenset):
            return {"items": self.schema(args[0], where) if args else {}, "type": "array",
                    "uniqueItems": True}
        if tp is tuple or origin is tuple:
            if tp is tuple:
                return {"items": {}, "type": "array"}
            if len(args) == 2 and args[1] is Ellipsis:
                return {"items": self.schema(args[0], where), "type": "array"}
            out: dict[str, Any] = {"type": "array"}
            if args:
                out["prefixItems"] = [self.schema(a, where) for a in args]
            out["minItems"] = out["maxItems"] = len(args)
            return out
        if tp is dict or origin is dict:
            return self.dict_schema(args, where)
        if _is_defined(tp) or (isinstance(tp, type) and issubclass(tp, Wire)):
            return self.ref(tp)
        raise ToolSchemaError(f"{where}: annotation {tp!r} has no JSON schema")

    def dict_schema(self, args: tuple, where: str) -> dict:
        out: dict[str, Any] = {"type": "object"}
        keys = self.schema(args[0], where).copy() if args else {}
        if args and not (args[0] in (str, int, Any) or _is_defined(args[0])
                         or typing.get_origin(args[0]) is Literal):
            raise ToolSchemaError(f"{where}: dict keys must be str, int, Enum or Literal, "
                                  f"got {args[0]!r}")
        values = self.schema(args[1], where).copy() if args else {}
        values.pop("title", None)
        out["additionalProperties"] = values if values else True
        if (keys.get("type") == "string" and len(keys) > 1) or "$ref" in keys:
            keys.pop("type", None)
            out["propertyNames"] = keys
        return out

    def fields_schema(self, fields: "list[tuple[str, Any, Any]]", where: str) -> dict:
        """An object of named fields: (name, annotation, default), the
        default ``REQUIRED`` for a required field and ``OPTIONAL`` for one
        that may be left out with no default in the schema."""
        properties: dict[str, Any] = {}
        required: list[str] = []
        for name, annotation, default in fields:
            prop = self.schema(annotation, f"{where} field {name!r}").copy()
            if default is REQUIRED:
                required.append(name)
            elif default is not OPTIONAL:
                prop["default"] = to_jsonable(default)
            if "title" not in prop and _titled(annotation):
                prop["title"] = _field_title(name)
            properties[name] = prop
        out: dict[str, Any] = {"type": "object", "properties": properties}
        if required:
            out["required"] = required
        return out

    def class_schema(self, cls: type) -> dict:
        where = f"type {cls.__name__!r}"
        if issubclass(cls, enum.Enum):
            out: dict[str, Any] = {"title": cls.__name__}
            doc = _docstring(cls)
            if doc:
                out["description"] = doc
            out["enum"] = [to_jsonable(m.value) for m in cls]
            kinds = {type(v) for v in out["enum"]}
            if len(kinds) == 1 and next(iter(kinds)) in _JSON_TYPES:
                out["type"] = _JSON_TYPES[next(iter(kinds))]
            return out
        if is_model_type(cls):
            schema = cls.model_json_schema(ref_template="#/$defs/{model}")
            self.extra_defs.update(schema.pop("$defs", {}))
            return schema
        if typing.is_typeddict(cls):
            hints = typing.get_type_hints(cls)
            required = getattr(cls, "__required_keys__", frozenset(hints))
            out = self.fields_schema(
                [(name, hint, REQUIRED if name in required else OPTIONAL)
                 for name, hint in hints.items()],
                where,
            )
            out["title"] = cls.__name__
            doc = _docstring(cls)
            if doc:
                out["description"] = doc
            return out
        hints = _hints(cls)
        out = self.fields_schema([
            (f.name, hints.get(f.name, Any),
             f.default if f.default is not dataclasses.MISSING
             # a default made by a factory is left out of the schema
             else OPTIONAL if f.default_factory is not dataclasses.MISSING else REQUIRED)
            for f in dataclasses.fields(cls) if f.init
        ], where)
        out["title"] = cls.__name__
        if issubclass(cls, Wire):
            doc = cls.__doc__ or ""
            if doc and not doc.startswith(f"{cls.__name__}("):
                out["description"] = inspect.cleandoc(doc)
            extra = cls.__wire_extra__
            if extra in ("allow", "forbid"):
                out["additionalProperties"] = extra == "allow"
        return out

    def finish(self, root: dict) -> dict:
        """The root inlined when it is the only reference to its class, the
        definitions renamed and attached, and the keys in pydantic's order."""
        names = self.final_names()
        defs = {names[_ref_key(cls)]: schema for cls, schema in self.defs.items()}
        defs.update(self.extra_defs)
        text_refs = {key: f"#/$defs/{name}" for key, name in names.items()}

        def rename(value: Any) -> Any:
            if isinstance(value, dict):
                return {k: rename(v) for k, v in value.items()}
            if isinstance(value, list):
                return [rename(v) for v in value]
            if isinstance(value, str) and value.startswith("#/$defs/"):
                return text_refs.get(value[len("#/$defs/"):], value)
            return value

        root, defs = rename(root), {k: rename(v) for k, v in defs.items()}
        ref = root.get("$ref") if len(root) == 1 else None
        if ref is not None:
            name = ref[len("#/$defs/"):]
            if _count_refs([root, *defs.values()], ref) == 1 and name in defs:
                root = dict(defs.pop(name))
        used = _reachable(root, defs)
        defs = {k: v for k, v in defs.items() if k in used}
        if defs:
            root["$defs"] = defs
        return _sorted(root)


REQUIRED = object()  # a field the input must give
OPTIONAL = object()  # a field the input may leave out, with no default shown


def _ref_key(cls: type) -> str:
    return f"{cls.__module__}.{cls.__qualname__}:{id(cls)}"


def _normalize(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9.\-_]", "_", name).replace(".", "__")


def _hints(cls: type) -> dict:
    try:
        return typing.get_type_hints(cls)
    except Exception:  # noqa: BLE001 - unresolvable annotations degrade to Any
        return {}


def _count_refs(values: list, ref: str) -> int:
    count = 0
    for value in values:
        if isinstance(value, dict):
            count += value.get("$ref") == ref
            count += _count_refs(list(value.values()), ref)
        elif isinstance(value, list):
            count += _count_refs(value, ref)
    return count


def _reachable(root: dict, defs: dict) -> set:
    seen: set = set()
    stack = [root]
    while stack:
        value = stack.pop()
        if isinstance(value, dict):
            ref = value.get("$ref")
            if isinstance(ref, str) and ref.startswith("#/$defs/"):
                name = ref[len("#/$defs/"):]
                if name not in seen and name in defs:
                    seen.add(name)
                    stack.append(defs[name])
            stack.extend(value.values())
        elif isinstance(value, list):
            stack.extend(value)
    return seen


def object_schema(fields: "list[tuple[str, Any, Any]]", *, where: str,
                  extra: "str | None" = None) -> dict:
    """The JSON schema of a synthesized object of named fields, (name,
    annotation, default or ``REQUIRED``) in order — a tool's arguments — with
    ``additionalProperties`` false for ``extra="forbid"``."""
    gen = _Schemas()
    out = gen.fields_schema(fields, where)
    if extra == "forbid":
        out["additionalProperties"] = False
    return gen.finish(out)


class Adapter:
    """``Adapter(tp)``: the JSON schema, lax validation and JSON dump of one
    type (see the module docstring); raises :class:`ToolSchemaError` for a
    type with no schema."""

    def __init__(self, tp: Any):
        self.tp = tp
        self.title = _label(tp)
        self._schema = self._make_schema()

    def _make_schema(self) -> dict:
        if is_model_type(self.tp):
            return self.tp.model_json_schema()
        gen = _Schemas()
        return gen.finish(gen.schema(self.tp, f"type {self.title!r}"))

    def json_schema(self) -> dict:
        return _copy_schema(self._schema)

    def validate_python(self, value: Any) -> Any:
        """``value`` validated and coerced; raises :class:`ValidationError`
        (a ``ValueError``) listing every refused location."""
        if is_model_type(self.tp):
            return self.tp.model_validate(value)
        try:
            return coerce(self.tp, value)
        except _Fail as fail:
            _raise(self.title, fail)

    def dump(self, value: Any) -> Any:
        """``value`` as JSON-compatible data."""
        return to_jsonable(value)


def _copy_schema(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _copy_schema(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_copy_schema(v) for v in value]
    return value

