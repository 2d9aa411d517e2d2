"""``ck topics`` — provisioning."""

from __future__ import annotations

import asyncio

from calfkit_tpu_torch.cli._common import (
    Argument,
    Group,
    echo,
    flag,
    load_nodes,
    option,
    resolve_mesh_for_cli,
)

topics_group = Group("topics", help="topic provisioning")


@topics_group.command(
    "provision",
    Argument("specs", nargs=-1),
    option("--mesh", "mesh_url"),
    flag("--dry-run", help="print the topic plan only"),
)
def provision_command(specs: tuple[str, ...], mesh_url: str | None,
                      dry_run: bool) -> None:
    """Create every topic the given nodes need."""
    from calfkit_tpu_torch.provisioning import (
        framework_topics_for_nodes,
        provision,
        topics_for_nodes,
    )

    nodes = load_nodes(specs)
    if dry_run:
        for topic in topics_for_nodes(nodes):
            echo(f"  {topic}")
        for topic in framework_topics_for_nodes(nodes):
            echo(f"  {topic} (compacted)")
        return

    async def main() -> None:
        mesh = resolve_mesh_for_cli(mesh_url, hosts_worker=False)
        await mesh.start()
        result = await provision(mesh, nodes)
        echo(
            f"provisioned {len(result['plain'])} topics "
            f"+ {len(result['compacted'])} compacted"
        )
        await mesh.stop()

    asyncio.run(main())
