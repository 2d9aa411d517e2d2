"""Function-signature → JSON-schema extraction and validated invocation.

The port's own copy of ``calfkit_tpu.engine.schema``, without pydantic:

- parameters come from the signature's annotations
  (``inspect.signature`` + ``get_type_hints``), rendered by
  :mod:`calfkit_tpu_torch.models._adapter` as the JSON schema the JAX
  package's pydantic extraction gives (every type the adapter takes:
  scalars, ``Literal``, enums, lists, tuples, sets, dicts, unions,
  dates, dataclasses, ``TypedDict``, wire types and models); an
  annotation with no schema raises :class:`ToolSchemaError` when the tool
  is defined;
- arguments are validated and coerced under the lax law of
  :func:`calfkit_tpu_torch.models._wire.coerce` (nested dataclasses and
  models are instantiated), with unknown argument names refused
  (``extra="forbid"``); a refusal raises :class:`ValidationError`, the
  model-retry trigger;
- descriptions come from a Google/NumPy/Sphinx-tolerant docstring scan;
- a leading ``ctx`` parameter (by name, or annotated with a type whose name
  ends in ``RunContext``/``Context``) receives the node's run context and is
  excluded from the model-facing schema;
- ``call()`` validates args, injects ctx, and awaits coroutine functions;
- :func:`output_tool_def` is the structured-output tool an
  ``Agent(output_type=...)`` offers the model.
"""

from __future__ import annotations

import asyncio
import inspect
import re
from dataclasses import dataclass
from typing import Any, Callable, get_type_hints

from calfkit_tpu_torch.models._adapter import REQUIRED, Adapter, ToolSchemaError, object_schema
from calfkit_tpu_torch.models._wire import ValidationError, _Fail, _flat, coerce
from calfkit_tpu_torch.models.capability import ToolDef

__all__ = [
    "FunctionSchema",
    "ToolSchemaError",
    "ValidationError",
    "function_schema",
    "output_tool_def",
]


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
                    errors.extend(f.as_dict() for f in _flat(fail.at(name)))
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
    adapter = _ArgsValidator(f"{fn.__name__}_args", fields)
    schema = object_schema(
        [(pname, annotation, REQUIRED if default is ... else default)
         for pname, (annotation, default) in fields.items()],
        where=f"tool {fn.__name__!r}", extra="forbid",
    )
    for prop_name, prop in schema.get("properties", {}).items():
        prop.pop("title", None)
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
    """The structured-output tool: the model 'calls' it with the final answer.

    Deliberately does NOT force ``extra="forbid"`` the way tool-args models
    do: args models are framework-synthesized from a signature (no user
    config exists, so strictness is ours to choose), while the output type
    is USER-owned — its own ``extra`` policy is law here.
    """
    schema = Adapter(output_type).json_schema()
    schema.pop("title", None)
    return ToolDef(
        name=name,
        description="Submit the final result of this conversation.",
        parameters_schema=schema,
    )
