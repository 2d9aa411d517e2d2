"""Content parts: the unit of user-visible payloads a model turn renders.

The port's own copy of the JAX package's content-part vocabulary, as plain
dataclasses with the same class names, field names and defaults, so either
package's part can be built from the other's fields.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Literal, Union


@dataclass(kw_only=True)
class _Part:
    metadata: dict[str, Any] | None = None


@dataclass(kw_only=True)
class TextPart(_Part):
    kind: Literal["text"] = "text"
    text: str


@dataclass(kw_only=True)
class FilePart(_Part):
    """A file by inline base64 payload or by URI (exactly one must be set)."""

    kind: Literal["file"] = "file"
    name: str | None = None
    media_type: str | None = None
    data_base64: str | None = None
    uri: str | None = None

    def __post_init__(self) -> None:
        if (self.data_base64 is None) == (self.uri is None):
            raise ValueError("FilePart requires exactly one of data_base64 or uri")


@dataclass(kw_only=True)
class DataPart(_Part):
    kind: Literal["data"] = "data"
    data: Any = None


@dataclass(kw_only=True)
class ToolCallPart(_Part):
    """A surfaced (not dispatched) tool call, for telemetry payloads."""

    kind: Literal["tool_call"] = "tool_call"
    tool_call_id: str
    tool_name: str
    args: dict[str, Any] = field(default_factory=dict)


ContentPart = Union[TextPart, FilePart, DataPart, ToolCallPart]


def render_parts_as_text(parts: list[ContentPart]) -> str:
    """Collapse parts to a single text blob (model-facing rendering)."""
    chunks: list[str] = []
    for part in parts:
        if isinstance(part, TextPart):
            chunks.append(part.text)
        elif isinstance(part, DataPart):
            try:
                chunks.append(json.dumps(part.data, ensure_ascii=False, default=str))
            except (TypeError, ValueError):
                chunks.append(str(part.data))
        elif isinstance(part, FilePart):
            label = part.name or part.uri or "file"
            chunks.append(f"[file: {label}]")
        elif isinstance(part, ToolCallPart):
            chunks.append(f"[tool call: {part.tool_name}]")
    return "\n".join(chunks)
