"""Content parts: the unit of user-visible payloads a model turn renders.

The port's own copy of the JAX package's content-part vocabulary, as wire
dataclasses (:mod:`calfkit_tpu_torch.models._wire`) with the same class
names, field names and defaults, so either package's part can be built from
the other's fields and each reads the other's JSON.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Literal, Union

from calfkit_tpu_torch.models._wire import Wire, invalid

RETRY_KEY = "mesh.retry"


@dataclass(kw_only=True)
class _Part(Wire):
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
        super().__post_init__()
        if (self.data_base64 is None) == (self.uri is None):
            raise invalid(
                "FilePart", None, "FilePart requires exactly one of data_base64 or uri", self
            )


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


def retry_text_part(text: str) -> TextPart:
    """A text part marked as a model-retry request (tool asked the model to
    try again, e.g. bad arguments)."""
    return TextPart(text=text, metadata={RETRY_KEY: True})


def is_retry(part: ContentPart) -> bool:
    return bool(part.metadata and part.metadata.get(RETRY_KEY))


def text_parts(*texts: str) -> list[ContentPart]:
    return [TextPart(text=t) for t in texts]
