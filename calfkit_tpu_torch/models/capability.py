"""Model-facing tool definitions: the port's own copy of the JAX package's
``ToolDef``, as a dataclass with the same fields and defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass(kw_only=True)
class ToolDef:
    """A model-facing tool definition (name + JSON-schema parameters)."""

    name: str
    description: str = ""
    parameters_schema: dict[str, Any] = field(
        default_factory=lambda: {"type": "object", "properties": {}}
    )
