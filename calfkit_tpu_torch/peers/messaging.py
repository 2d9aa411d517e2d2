"""Messaging: the ``message_agent`` built-in peer capability.

The model calls ``message_agent(agent_name, message)``; the agent node
dispatches it as an isolated-state Call to the target agent's input topic
(a degenerate durable batch — the caller's conversation never leaks to the
callee, and the caller's state survives outside the wire).  Reference:
calfkit/peers/messaging.py:12 + nodes/agent.py:540.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from calfkit_tpu_torch.models.agents import AgentCard
from calfkit_tpu_torch.models.capability import ToolDef
from calfkit_tpu_torch.peers.directory import render_directory
from calfkit_tpu_torch.utils_names import validate_curated_or_discover

if TYPE_CHECKING:
    pass

MESSAGE_AGENT_TOOL = "message_agent"


class Messaging:
    """Curated names XOR discover: which live agents this agent may message."""

    kind = "messaging"

    def __init__(self, *names: str, discover: bool = False):
        validate_curated_or_discover("Messaging", names, discover)
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
            name=MESSAGE_AGENT_TOOL,
            description=(
                "Send a message to another agent and wait for its reply.\n"
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
                    "message": {"type": "string"},
                },
                "required": ["agent_name", "message"],
            },
        )
