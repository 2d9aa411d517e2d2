"""Live-peer directory rendering (reference: calfkit/peers/directory.py)."""

from __future__ import annotations

from calfkit_tpu_torch.models.agents import AgentCard


def render_directory(cards: list[AgentCard]) -> str:
    if not cards:
        return "No agents are currently available."
    lines = ["Available agents:"]
    for card in sorted(cards, key=lambda c: c.name):
        description = card.description or "(no description)"
        lines.append(f"- {card.name}: {description}")
    return "\n".join(lines)
