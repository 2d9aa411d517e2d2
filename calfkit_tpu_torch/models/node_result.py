"""Schema-on-read projection of a terminal reply into a typed result.

Reference: calfkit/models/node_result.py:25-134 (``InvocationResult`` /
``from_envelope``): the wire carries parts; the *caller's* declared output
type decides how to read them — at read time, not at publish time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Generic, TypeVar

from calfkit_tpu_torch.models._wire import Wire
from calfkit_tpu_torch.models.payload import ContentPart, render_parts_as_text
from calfkit_tpu_torch.models.session_context import Envelope
from calfkit_tpu_torch.models.state import State

OutputT = TypeVar("OutputT")


@dataclass(kw_only=True)
class InvocationResult(Wire, Generic[OutputT]):
    __wire_extra__ = "allow"

    output: OutputT
    parts: list[ContentPart] = field(default_factory=list)
    state: State = field(default_factory=State)
    deps: dict[str, Any] = field(default_factory=dict)
    correlation_id: str | None = None
    task_id: str | None = None
    state_elided: bool = False

    @classmethod
    def from_envelope(
        cls,
        envelope: Envelope,
        output_type: type[OutputT] = str,  # type: ignore[assignment]
        *,
        correlation_id: str | None = None,
        task_id: str | None = None,
    ) -> "InvocationResult[OutputT]":
        from calfkit_tpu_torch.models.reply import ReturnMessage

        reply = envelope.reply
        if not isinstance(reply, ReturnMessage):
            raise ValueError("envelope does not carry a return reply")
        output = project_output(reply.parts, output_type)
        return cls(
            output=output,
            parts=list(reply.parts),
            state=envelope.context.state,
            deps=envelope.context.deps,
            correlation_id=correlation_id,
            task_id=task_id,
            state_elided=envelope.state_elided,
        )


def project_output(parts: list[ContentPart], output_type: type[OutputT]) -> OutputT:
    """Project reply parts into ``output_type``.

    - ``str``: rendered text of all parts.
    - any other type (structured output) is not ported yet: it raises
      ``TypeError`` naming the ROADMAP item that ports it.
    """
    if output_type is str:
        return render_parts_as_text(parts)  # type: ignore[return-value]
    raise TypeError(
        f"output_type {output_type!r}: structured output is not ported to "
        "calfkit_tpu_torch yet (ROADMAP Queue 1); use str"
    )
