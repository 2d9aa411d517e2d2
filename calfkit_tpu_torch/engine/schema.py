"""Function-signature → JSON-schema extraction and validated invocation.

The port's own copy of ``calfkit_tpu.engine.schema``, without pydantic:

- parameters come from the signature's annotations
  (``inspect.signature`` + ``get_type_hints``), rendered as the JSON
  schema the JAX package's pydantic extraction gives for the supported
  set — ``str``, ``int``, ``float``, ``bool``, ``None``, ``Any``,
  ``Optional[X]`` / ``X | None``, ``list[X]``, ``dict[str, X]``,
  ``Literal[...]`` of str/int/bool, and defaults; any other annotation
  raises :class:`ToolSchemaError` when the tool is defined;
- arguments are validated and coerced under the lax law of
  :func:`calfkit_tpu_torch.models._wire.coerce`, with unknown argument
  names refused (``extra="forbid"``); a refusal raises
  :class:`ValidationError`, the model-retry trigger;
- descriptions come from a Google/NumPy/Sphinx-tolerant docstring scan;
- a leading ``ctx`` parameter (by name, or annotated with a type whose name
  ends in ``RunContext``/``Context``) receives the node's run context and is
  excluded from the model-facing schema;
- ``call()`` validates args, injects ctx, and awaits coroutine functions.
"""

from __future__ import annotations

import asyncio
import inspect
import re
from dataclasses import dataclass
from typing import Any, Callable, get_type_hints

import types
import typing

from calfkit_tpu_torch.models._wire import ValidationError, _Fail, coerce
from calfkit_tpu_torch.models.capability import ToolDef

__all__ = [
    "FunctionSchema",
    "ToolSchemaError",
    "ValidationError",
    "function_schema",
    "output_tool_def",
]


class ToolSchemaError(TypeError):
    pass


_DOC_ARG = re.compile(
    r"^\s*(?:Args?|Arguments|Parameters)\s*:?\s*$", re.IGNORECASE
)
_DOC_PARAM = re.compile(r"^\s{2,}(\*{0,2}\w+)\s*(?:\(([^)]*)\))?\s*:\s*(.+)$")
_SPHINX_PARAM = re.compile(r"^\s*:param\s+(\w+)\s*:\s*(.+)$")


def _docstring_info(fn: Callable[..., Any]) -> tuple[str, dict[str, str]]:
    """(summary, {param: description}) from the docstring, best-effort."""
    doc = inspect.getdoc(fn) or ""
    lines = doc.splitlines()
    summary_lines: list[str] = []
    for line in lines:
        if not line.strip():
            break
        summary_lines.append(line.strip())
    params: dict[str, str] = {}
    in_args = False
    for line in lines:
        sphinx = _SPHINX_PARAM.match(line)
        if sphinx:
            params[sphinx.group(1)] = sphinx.group(2).strip()
            continue
        if _DOC_ARG.match(line):
            in_args = True
            continue
        if in_args:
            if line.strip() and not line.startswith(" "):
                in_args = False
                continue
            m = _DOC_PARAM.match(line)
            if m:
                params[m.group(1).lstrip("*")] = m.group(3).strip()
    return " ".join(summary_lines), params


def _is_context_param(name: str, annotation: Any) -> bool:
    if name in ("ctx", "context"):
        return True
    ann_name = getattr(annotation, "__name__", "")
    return ann_name.endswith(("RunContext", "Context"))


_NULL = type(None)
_SCALAR_TYPES = {str: "string", int: "integer", float: "number", bool: "boolean"}


def _literal_type(values: tuple) -> str | None:
    kinds = {
        "boolean" if isinstance(v, bool) else _SCALAR_TYPES.get(type(v)) for v in values
    }
    return kinds.pop() if len(kinds) == 1 and None not in kinds else None


def _annotation_schema(tp: Any, where: str) -> dict[str, Any]:
    """The JSON schema of one annotation, keys sorted as the JAX package's
    extraction sorts them; ``ToolSchemaError`` outside the supported set."""
    if tp is Any or tp is object:
        return {}
    if tp is None or tp is _NULL:
        return {"type": "null"}
    if tp in _SCALAR_TYPES:
        return {"type": _SCALAR_TYPES[tp]}
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union or origin is types.UnionType:
        if _NULL not in args or len(args) != 2:
            raise ToolSchemaError(f"{where}: only X | None unions are supported, got {tp!r}")
        return {"anyOf": [_annotation_schema(a, where) for a in args]}
    if origin is typing.Literal:
        if not all(isinstance(v, (str, int, bool)) or v is None for v in args):
            raise ToolSchemaError(f"{where}: Literal values must be str, int or bool")
        out: dict[str, Any] = (
            {"const": args[0]} if len(args) == 1 else {"enum": list(args)}
        )
        kind = _literal_type(args)
        if kind is not None:
            out["type"] = kind
        return out
    if tp is list or origin is list:
        items = _annotation_schema(args[0], where) if args else {}
        return {"items": items, "type": "array"}
    if tp is dict or origin is dict:
        if args and args[0] is not str:
            raise ToolSchemaError(f"{where}: dict keys must be str, got {args[0]!r}")
        values: Any = True
        if args and args[1] is not Any:
            values = _annotation_schema(args[1], where)
        return {"additionalProperties": values, "type": "object"}
    raise ToolSchemaError(
        f"{where}: annotation {tp!r} is not supported by calfkit_tpu_torch's "
        "tool schemas yet (ROADMAP Queue 1)"
    )


def _property_schema(tp: Any, default: Any, where: str) -> dict[str, Any]:
    prop = _annotation_schema(tp, where)
    if default is not ...:
        prop["default"] = default
    return dict(sorted(prop.items()))


@dataclass
class _ArgsValidator:
    """Validates a tool's raw argument dict against its parameters."""

    title: str
    fields: dict[str, tuple[Any, Any]]  # name -> (annotation, default | ...)

    def validate_python(self, args: Any) -> dict[str, Any]:
        if not isinstance(args, dict):
            raise ValidationError(
                self.title,
                [{"type": "model_type", "loc": (), "input": args,
                  "msg": f"Input should be a valid dictionary or instance of {self.title}"}],
            )
        out: dict[str, Any] = {}
        errors: list[dict[str, Any]] = []
        for name, (annotation, default) in self.fields.items():
            if name in args:
                try:
                    out[name] = coerce(annotation, args[name])
                except _Fail as fail:
                    errors.extend(
                        f.at(name).as_dict() for f in getattr(fail, "fails", [fail])
                    )
            elif default is ...:
                errors.append(
                    {"type": "missing", "loc": (name,), "msg": "Field required", "input": args}
                )
            else:
                out[name] = default
        for name, value in args.items():
            if name not in self.fields:
                errors.append(
                    {"type": "extra_forbidden", "loc": (name,),
                     "msg": "Extra inputs are not permitted", "input": value}
                )
        if errors:
            raise ValidationError(self.title, errors)
        return out


@dataclass
class FunctionSchema:
    tool_def: ToolDef
    fn: Callable[..., Any]
    takes_ctx: bool
    _adapter: _ArgsValidator
    _param_names: list[str]

    def validate_args(self, args: dict[str, Any]) -> dict[str, Any]:
        """Validate/coerce raw args against the signature; raises
        :class:`ValidationError` on mismatch (the model-retry trigger)."""
        validated = self._adapter.validate_python(args)
        return {name: validated[name] for name in self._param_names}

    async def call(self, args: dict[str, Any], ctx: Any = None) -> Any:
        kwargs = self.validate_args(args)
        if self.takes_ctx:
            result = self.fn(ctx, **kwargs)
        else:
            result = self.fn(**kwargs)
        if asyncio.iscoroutine(result):
            result = await result
        return result


def function_schema(
    fn: Callable[..., Any],
    *,
    name: str | None = None,
    description: str | None = None,
) -> FunctionSchema:
    sig = inspect.signature(fn)
    try:
        hints = get_type_hints(fn)
    except Exception:  # noqa: BLE001 - unresolvable annotations degrade to Any
        hints = {}
    summary, param_docs = _docstring_info(fn)

    fields: dict[str, Any] = {}
    takes_ctx = False
    param_names: list[str] = []
    for i, (pname, param) in enumerate(sig.parameters.items()):
        if param.kind in (param.VAR_POSITIONAL, param.VAR_KEYWORD):
            raise ToolSchemaError(
                f"tool {fn.__name__!r}: *args/**kwargs are not schema-expressible"
            )
        annotation = hints.get(pname, param.annotation)
        if i == 0 and _is_context_param(pname, annotation):
            takes_ctx = True
            continue
        if annotation is inspect.Parameter.empty:
            annotation = Any
        default = ... if param.default is inspect.Parameter.empty else param.default
        fields[pname] = (annotation, default)
        param_names.append(pname)

    # forbid extras: a model hallucinating an argument name must get a
    # ValidationError (the retry trigger), not have it silently dropped
    title = f"{fn.__name__}_args"
    adapter = _ArgsValidator(title, fields)
    properties: dict[str, Any] = {
        pname: _property_schema(annotation, default, f"tool {fn.__name__!r} parameter {pname!r}")
        for pname, (annotation, default) in fields.items()
    }
    schema: dict[str, Any] = {"additionalProperties": False, "properties": properties}
    required = [pname for pname, (_, default) in fields.items() if default is ...]
    if required:
        schema["required"] = required
    schema["type"] = "object"
    for prop_name, prop in schema.get("properties", {}).items():
        if prop_name in param_docs:
            prop.setdefault("description", param_docs[prop_name])

    return FunctionSchema(
        tool_def=ToolDef(
            name=name or fn.__name__,
            description=description if description is not None else summary,
            parameters_schema=schema,
        ),
        fn=fn,
        takes_ctx=takes_ctx,
        _adapter=adapter,
        _param_names=param_names,
    )


def output_tool_def(output_type: type, *, name: str = "final_result") -> ToolDef:
    """The structured-output tool: not ported yet (ROADMAP Queue 1).
    Raises :class:`ToolSchemaError`."""
    raise ToolSchemaError(
        f"output_type {output_type!r}: structured output is not ported to "
        "calfkit_tpu_torch yet (ROADMAP Queue 1); use str"
    )
