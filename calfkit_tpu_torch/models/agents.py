"""Agent directory records (the ``mesh.agents`` compacted topic).

Reference: calfkit/models/agents.py:29-87 (AgentCard is name-keyed, carries a
bounded human description, and derives the agent's input topic so callers can
dispatch by name alone).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire, invalid

from calfkit_tpu_torch import protocol

MAX_DESCRIPTION = 512


@dataclass(kw_only=True)
class AgentCard(Wire):

    name: str
    description: str = ""
    structured_output: bool = False
    tools: list[str] = field(default_factory=list)  # advertised tool names, directory only

    def __post_init__(self) -> None:
        super().__post_init__()
        try:
            protocol.require_topic_safe(self.name, what="agent name")
        except ValueError as exc:
            raise invalid("AgentCard", "name", str(exc), self.name) from None
        if len(self.description) > MAX_DESCRIPTION:
            raise invalid(
                "AgentCard", "description",
                f"description exceeds {MAX_DESCRIPTION} chars", self.description,
            )

    def derive_input_topic(self) -> str:
        return protocol.agent_input_topic(self.name)

    def derive_publish_topic(self) -> str:
        return protocol.agent_publish_topic(self.name)
