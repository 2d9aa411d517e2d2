"""Handoff: transfer the current obligation to another agent.

The model calls ``handoff_to_agent(agent_name)``; the node retargets its own
frame (TailCall) so the target agent replies directly to the original
caller.  Whole-response arbitration: the FIRST valid handoff in a model turn
wins; sibling tool calls in the same turn are stubbed as superseded
(reference: calfkit/peers/handoff.py:27-191, ``arbitrate_handoff`` at :162).
"""

from __future__ import annotations

from dataclasses import dataclass

from calfkit_tpu_torch.models.agents import AgentCard
from calfkit_tpu_torch.models.capability import ToolDef
from calfkit_tpu_torch.models.messages import ToolCallOutput
from calfkit_tpu_torch.peers.directory import render_directory
from calfkit_tpu_torch.utils_names import validate_curated_or_discover

HANDOFF_TOOL = "handoff_to_agent"

# pinned model-visible strings (reference keeps these stable for the model)
SUPERSEDED_STUB = "This call was not executed: the conversation was handed off."
INVALID_TARGET = "Hand-off rejected: {name!r} is not an available agent."


class Handoff:
    kind = "handoff"

    def __init__(self, *names: str, discover: bool = False):
        validate_curated_or_discover("Handoff", names, discover)
        self.names = list(names)
        self.discover = discover

    def allowed(self, cards: list[AgentCard], self_name: str) -> list[AgentCard]:
        cards = [c for c in cards if c.name != self_name]
        if self.discover:
            return cards
        by_name = {c.name: c for c in cards}
        return [by_name[n] for n in self.names if n in by_name]

    def tool_def(self, cards: list[AgentCard], self_name: str) -> ToolDef:
        allowed = self.allowed(cards, self_name)
        names = [c.name for c in allowed]
        return ToolDef(
            name=HANDOFF_TOOL,
            description=(
                "Hand the whole conversation off to another agent; it will "
                "answer the user directly and you will not see the reply.\n"
                + render_directory(allowed)
            ),
            parameters_schema={
                "type": "object",
                "properties": {
                    "agent_name": (
                        {"type": "string", "enum": names}
                        if names
                        else {"type": "string"}
                    ),
                },
                "required": ["agent_name"],
            },
        )


@dataclass(frozen=True)
class HandoffDecision:
    winner: ToolCallOutput | None
    target: str | None
    # calls to stub as superseded (id -> stub text), incl. losing handoffs
    stubbed: dict[str, str]
    # invalid handoff attempts (id -> retry text)
    rejected: dict[str, str]


def arbitrate_handoff(
    calls: list[ToolCallOutput], allowed_names: set[str]
) -> HandoffDecision:
    """First valid handoff wins; everything else in the turn is stubbed."""
    winner: ToolCallOutput | None = None
    target: str | None = None
    stubbed: dict[str, str] = {}
    rejected: dict[str, str] = {}
    for call in calls:
        if call.tool_name != HANDOFF_TOOL:
            continue
        try:
            name = call.args_dict().get("agent_name")
        except ValueError:
            name = None
        if winner is not None:
            stubbed[call.tool_call_id] = SUPERSEDED_STUB
            continue
        if isinstance(name, str) and name in allowed_names:
            winner = call
            target = name
        else:
            rejected[call.tool_call_id] = INVALID_TARGET.format(name=name)
    if winner is not None:
        for call in calls:
            if call.tool_name != HANDOFF_TOOL:
                stubbed.setdefault(call.tool_call_id, SUPERSEDED_STUB)
    return HandoffDecision(
        winner=winner, target=target, stubbed=stubbed, rejected=rejected
    )
