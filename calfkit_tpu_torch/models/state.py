"""Conversation state that crosses the wire with every envelope.

The node holds zero in-process run state — the envelope carries all of it, so
any worker replica can continue any run (the checkpoint/resume property,
reference: calfkit/models/state.py:22-145 and SURVEY.md §5 checkpoint notes).
"""

from __future__ import annotations

from typing import Union

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire

from calfkit_tpu_torch.models.messages import (
    ModelMessage,
    ModelRequest,
    ModelResponse,
    RetryPart,
    ToolCallOutput,
    ToolReturnPart,
)

ToolResult = Union[ToolReturnPart, RetryPart]


@dataclass(kw_only=True)
class State(Wire):
    """The agent's durable conversation state.

    - ``message_history``: committed model turns (requests + responses).
    - ``uncommitted_message``: the staged incoming user prompt; committed by
      the agent when a turn completes so retried deliveries don't duplicate it.
    - ``temp_instructions``: per-run instruction override.
    - ``tool_calls`` / ``tool_results``: the in-flight tool ledger — calls the
      model issued that are out on the wire, and results that have landed but
      have not yet been fed back into a model turn.
    """


    message_history: list[ModelMessage] = field(default_factory=list)
    uncommitted_message: ModelRequest | None = None
    temp_instructions: str | None = None
    tool_calls: dict[str, ToolCallOutput] = field(default_factory=dict)
    tool_results: dict[str, ToolResult] = field(default_factory=dict)

    def latest_response(self) -> ModelResponse | None:
        for msg in reversed(self.message_history):
            if isinstance(msg, ModelResponse):
                return msg
        return None

    def latest_tool_calls(self) -> list[ToolCallOutput]:
        """Tool calls from the most recent model response
        (reference: calfkit/models/state.py:98 ``latest_tool_calls``)."""
        resp = self.latest_response()
        return resp.tool_calls() if resp else []

    def pending_tool_call_ids(self) -> set[str]:
        return set(self.tool_calls) - set(self.tool_results)

    def commit_message(self, message: ModelMessage) -> None:
        self.message_history.append(message)

    def clear_inflight(self) -> None:
        self.tool_calls.clear()
        self.tool_results.clear()
