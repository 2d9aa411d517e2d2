"""Schema-on-read projection of a terminal reply into a typed result.

Reference: calfkit/models/node_result.py:25-134 (``InvocationResult`` /
``from_envelope``): the wire carries parts; the *caller's* declared output
type decides how to read them — at read time, not at publish time.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Generic, TypeVar

from calfkit_tpu_torch.models._adapter import Adapter
from calfkit_tpu_torch.models._wire import Wire
from calfkit_tpu_torch.models.payload import ContentPart, DataPart, TextPart, render_parts_as_text
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
    - any other type (a dataclass, a model, ...): the first DataPart
      validated against it, falling back to parsing text parts as JSON
      (``extract_lenient``, reference: node_result.py:330).
    """
    if output_type is str:
        return render_parts_as_text(parts)  # type: ignore[return-value]
    adapter = Adapter(output_type)
    for part in parts:
        if isinstance(part, DataPart):
            return adapter.validate_python(part.data)
    for part in parts:
        if isinstance(part, TextPart):
            return extract_lenient(part.text, adapter)
    raise ValueError(f"no part projects into {output_type!r}")


def extract_lenient(text: str, adapter: Adapter) -> Any:
    """Parse JSON out of model text, tolerating fences and surrounding prose."""
    candidates = [text.strip()]
    stripped = text.strip()
    if stripped.startswith("```"):
        body = stripped.split("```")[1] if "```" in stripped[3:] else stripped[3:]
        body = body.removeprefix("json").strip()
        candidates.insert(0, body)
    start, end = stripped.find("{"), stripped.rfind("}")
    if 0 <= start < end:
        candidates.append(stripped[start : end + 1])
    last_error: Exception | None = None
    for cand in candidates:
        try:
            return adapter.validate_python(json.loads(cand))
        except Exception as exc:  # noqa: BLE001 - try the next candidate form
            last_error = exc
    raise ValueError(f"could not project text into typed output: {last_error}")
