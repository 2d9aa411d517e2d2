"""Model-turn message vocabulary: the input and output of the model client.

The port's own copy of the JAX package's message types, as dataclasses
with the same class names, field names, defaults and methods, so either
package's message can be built from the other's fields.  Requests and
responses carry an optional ``author`` (the agent name) so multi-agent
histories can be re-projected per point of view.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Literal, Union

from calfkit_tpu_torch.models.payload import ContentPart


@dataclass(kw_only=True)
class Usage:
    input_tokens: int = 0
    output_tokens: int = 0
    cache_read_tokens: int = 0

    def __add__(self, other: "Usage") -> "Usage":
        return Usage(
            input_tokens=self.input_tokens + other.input_tokens,
            output_tokens=self.output_tokens + other.output_tokens,
            cache_read_tokens=self.cache_read_tokens + other.cache_read_tokens,
        )


# --------------------------------------------------------------------------- #
# request parts (caller -> model)
# --------------------------------------------------------------------------- #


@dataclass(kw_only=True)
class SystemPart:
    kind: Literal["system"] = "system"
    content: str


@dataclass(kw_only=True)
class UserPart:
    kind: Literal["user"] = "user"
    content: Union[str, list[ContentPart]]
    author: str | None = None  # attribution for POV projection


@dataclass(kw_only=True)
class ToolReturnPart:
    kind: Literal["tool_return"] = "tool_return"
    tool_call_id: str
    tool_name: str
    content: Any = None


@dataclass(kw_only=True)
class RetryPart:
    """Ask the model to retry: validation failure or tool-requested retry."""

    kind: Literal["retry"] = "retry"
    content: str
    tool_call_id: str | None = None
    tool_name: str | None = None


RequestPart = Union[SystemPart, UserPart, ToolReturnPart, RetryPart]


@dataclass(kw_only=True)
class ModelRequest:
    role: Literal["request"] = "request"
    parts: list[RequestPart] = field(default_factory=list)
    instructions: str | None = None


# --------------------------------------------------------------------------- #
# response parts (model -> caller)
# --------------------------------------------------------------------------- #


@dataclass(kw_only=True)
class TextOutput:
    kind: Literal["text"] = "text"
    text: str


@dataclass(kw_only=True)
class ThinkingOutput:
    kind: Literal["thinking"] = "thinking"
    text: str


@dataclass(kw_only=True)
class ToolCallOutput:
    kind: Literal["tool_call"] = "tool_call"
    tool_call_id: str
    tool_name: str
    args: Union[str, dict[str, Any]] = field(default_factory=dict)

    def args_dict(self) -> dict[str, Any]:
        """Parse args to a dict; raises ``ValueError`` on malformed JSON."""
        if isinstance(self.args, dict):
            return self.args
        if not self.args.strip():
            return {}
        parsed = json.loads(self.args)
        if not isinstance(parsed, dict):
            raise ValueError(f"tool args must be a JSON object, got {type(parsed)}")
        return parsed


ResponsePart = Union[TextOutput, ThinkingOutput, ToolCallOutput]


@dataclass(kw_only=True)
class ModelResponse:
    role: Literal["response"] = "response"
    parts: list[ResponsePart] = field(default_factory=list)
    usage: Usage = field(default_factory=Usage)
    model_name: str | None = None
    author: str | None = None  # attribution for POV projection

    def text(self) -> str:
        return "".join(p.text for p in self.parts if isinstance(p, TextOutput))

    def tool_calls(self) -> list[ToolCallOutput]:
        return [p for p in self.parts if isinstance(p, ToolCallOutput)]


ModelMessage = Union[ModelRequest, ModelResponse]


def user_message(content: str, *, author: str | None = None) -> ModelRequest:
    return ModelRequest(parts=[UserPart(content=content, author=author)])
