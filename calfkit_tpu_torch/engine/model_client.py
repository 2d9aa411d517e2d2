"""The provider interface: what a model backend must implement.

The port's own copy of the JAX package's model-client seam: the settings
and parameters of a request are dataclasses with the same names, fields
and defaults, and the stream events and the ``ModelClient`` ABC are the
same.  :class:`calfkit_tpu_torch.inference.TorchLocalModelClient`
implements it.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Union

from calfkit_tpu_torch.models.capability import ToolDef
from calfkit_tpu_torch.models.messages import ModelMessage, ModelResponse


@dataclass(kw_only=True)
class ModelSettings:
    """Per-request generation knobs (all optional; backends ignore unknowns)."""

    max_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    stop_sequences: list[str] = field(default_factory=list)
    seed: int | None = None
    # decode-from-offset resume: text of THIS answer already delivered to
    # the caller by a failed-over attempt.  A backend that honors it admits
    # the prefix via prefill, decodes only the remaining tokens, yields a
    # ResumeOffset stream event first, and returns the FULL answer (prefix
    # + continuation) in its terminal response.
    resume_text: str | None = None
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class ModelRequestParameters:
    """What the agent loop hands the model besides messages."""

    tool_defs: list[ToolDef] = field(default_factory=list)
    # structured output via an output tool (the model "calls" this tool with
    # the final answer); None means plain-text output
    output_tool: ToolDef | None = None
    allow_text_output: bool = True

    def all_tools(self) -> list[ToolDef]:
        return self.tool_defs + ([self.output_tool] if self.output_tool else [])


@dataclass(frozen=True)
class TextDelta:
    """Incremental generated text."""

    text: str


@dataclass(frozen=True)
class ResumeOffset:
    """First event of a RESUMED stream: the backend honored
    ``ModelSettings.resume_text`` and this attempt's TextDeltas begin at
    character ``chars`` of the answer — nothing before that offset is
    re-generated.  Consumers that ignore it see only the fresh text."""

    chars: int


@dataclass(frozen=True)
class ResponseDone:
    """Terminal stream event carrying the complete response."""

    response: ModelResponse


StreamEvent = Union[TextDelta, ResumeOffset, ResponseDone]


class ModelClient(abc.ABC):
    """A model backend.  Implementations must be safe for concurrent
    ``request`` calls (the worker batches them)."""

    @property
    @abc.abstractmethod
    def model_name(self) -> str: ...

    @abc.abstractmethod
    async def request(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> ModelResponse: ...

    async def request_stream(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> AsyncIterator[StreamEvent]:
        """Streaming generation; the default adapter degrades to one shot."""
        response = await self.request(messages, settings, params)
        text = response.text()
        if text:
            yield TextDelta(text)
        yield ResponseDone(response)
