"""``ck chat`` — REPL against a live mesh with step streaming."""

from __future__ import annotations

import asyncio

from calfkit_tpu_torch.cli._common import CliError, command, echo, option, prompt_int


@command("chat", option("--mesh", "mesh_url"),
         option("--agent", "agent_name", help="agent to talk to"))
def chat_command(mesh_url: str | None, agent_name: str | None) -> None:
    """Chat with a live agent (steps stream inline)."""
    from calfkit_tpu_torch.cli._common import resolve_mesh_for_cli

    asyncio.run(_chat(resolve_mesh_for_cli(mesh_url, hosts_worker=False), agent_name))


async def _chat(mesh, agent_name: str | None) -> None:
    from calfkit_tpu_torch.client import Client

    client = Client.connect(mesh)
    try:
        if agent_name is None:
            cards = await client.mesh_directory.get_agents()
            if not cards:
                raise CliError("no live agents on the mesh")
            if len(cards) == 1:
                agent_name = cards[0].name
            else:
                for i, card in enumerate(cards):
                    echo(f"  [{i}] {card.name}: {card.description}")
                index = prompt_int("agent", default=0)
                agent_name = cards[index].name
        echo(f"chatting with {agent_name!r} (ctrl-d to exit)")
        await repl(client, agent_name)
    finally:
        await client.close()
        await mesh.stop()


async def repl(client, agent_name: str) -> None:
    """The chat loop, reusable by ``ck dev run`` (history carries over)."""
    gateway = client.agent(agent_name)
    history = None
    while True:
        try:
            prompt = await asyncio.to_thread(input, f"\nyou> ")
        except (EOFError, KeyboardInterrupt):
            echo("\nbye")
            return
        if not prompt.strip():
            continue
        handle = await gateway.start(prompt, message_history=history, timeout=300)
        async for event in handle.stream():
            if hasattr(event, "step"):
                step = event.step
                if step.kind == "tool_call":
                    echo(f"  ⚙ {step.tool_name}({step.args})")
                elif step.kind == "tool_result":
                    mark = "✓" if step.ok else "✗"
                    echo(f"  {mark} {step.tool_name} → {step.content[:120]}")
                elif step.kind == "handoff":
                    echo(f"  ↪ handoff → {step.to_agent}")
                elif step.kind == "token":
                    echo(step.text, nl=False)
                elif step.kind == "inference":
                    echo(
                        f"  ∙ {step.model_name}: {step.generated_tokens} tok "
                        f"in {step.decode_ms:.0f}ms"
                    )
            else:
                echo(f"\n{agent_name}> {event.output}")
                history = event.state.message_history
