"""Agent-to-agent capabilities (SURVEY.md §1 layer 6)."""

from calfkit_tpu_torch.peers.handoff import HANDOFF_TOOL, Handoff, arbitrate_handoff
from calfkit_tpu_torch.peers.messaging import MESSAGE_AGENT_TOOL, Messaging
from calfkit_tpu_torch.peers.directory import render_directory

__all__ = [
    "HANDOFF_TOOL",
    "Handoff",
    "MESSAGE_AGENT_TOOL",
    "Messaging",
    "arbitrate_handoff",
    "render_directory",
]
