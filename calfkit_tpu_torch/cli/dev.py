"""``ck dev`` — the zero-setup dev loop.

Two modes:

- **Single-process**: ``ck dev run file.py:agent`` hosts the nodes AND the
  chat REPL in one process on an in-memory mesh — no broker, no setup.
- **Multi-process**: a managed native meshd broker (connect-or-spawn with a
  spawn-race file lock) plus detached agent daemons —
  ``ck dev serve file.py:agent`` detaches a worker, ``ck dev chat`` talks
  to it, ``ck dev status`` / ``stop`` / ``down`` manage the fleet.
"""

from __future__ import annotations

import asyncio

from calfkit_tpu_torch.cli._common import Argument, CliError, Group, echo, flag, option

dev_group = Group("dev", help="dev mesh: serve + chat, managed broker + daemons")
# the managed broker's port, shared by the broker-facing subcommands
_PORT = option("--port", type=int, help="broker port (default: 19092 meshd, 19392 kafkad)")


@dev_group.command("run", Argument("specs", nargs=-1), option("--agent", "agent_name"))
def dev_run(specs: tuple[str, ...], agent_name: str | None) -> None:
    """Serve nodes on an in-memory mesh and chat with them (one process)."""
    from calfkit_tpu_torch.cli._common import load_nodes
    from calfkit_tpu_torch.cli.chat import repl
    from calfkit_tpu_torch.client import Client
    from calfkit_tpu_torch.mesh import InMemoryMesh
    from calfkit_tpu_torch.worker import Worker

    nodes = load_nodes(specs)

    async def main() -> None:
        mesh = InMemoryMesh()
        async with Worker(nodes, mesh=mesh, owns_transport=True):
            client = Client.connect(mesh)
            name = agent_name
            if name is None:
                agents = [n.name for n in nodes if n.kind == "agent"]
                if not agents:
                    raise CliError("no agent nodes among the specs")
                name = agents[0]
            echo(f"dev mesh up: {[n.name for n in nodes]}; chatting with {name!r}")
            await repl(client, name)
            await client.close()

    asyncio.run(main())


@dev_group.command(
    "mesh",
    _PORT,
    flag("--kafka", "use_kafka",
         help="manage the kafkad broker (real Kafka wire protocol) instead of meshd"),
    flag("--detach", help="leave the broker running and return"),
    flag("--durable",
         help="kafkad only: keep topics/records/offsets across broker "
              "restarts (append-only WAL under the dev dir)"),
)
def dev_mesh(port: int | None, use_kafka: bool, detach: bool,
             durable: bool) -> None:
    """Ensure the native dev broker is up — connect-or-spawn.

    Default broker is meshd (native line protocol); ``--kafka`` manages
    kafkad, the in-repo broker speaking the real Kafka wire protocol
    (the reference's dev broker is Kafka-compatible too).  Safe to run
    from several terminals at once: a file lock guarantees exactly one
    spawn wins and the rest connect.
    """
    from calfkit_tpu_torch.cli._dev_state import ensure_broker

    kind = "kafkad" if use_kafka else "meshd"
    if durable and not use_kafka:
        raise CliError("--durable requires --kafka (kafkad WAL)")
    try:
        # flag unset -> None: inherit the port's recorded durability (a
        # crashed durable broker must not be silently demoted on respawn)
        info = ensure_broker(port, kind, durable=True if durable else None)
    except (FileNotFoundError, RuntimeError, TimeoutError) as exc:
        raise CliError(str(exc)) from exc
    verb = "spawned" if info.spawned else "already up"
    echo(
        f"{kind} {verb} on {info.url} — export CALFKIT_MESH_URL={info.url}"
    )
    if detach or not info.spawned:
        return
    echo("(ctrl-c to stop)")
    import signal

    try:
        signal.pause()
    except KeyboardInterrupt:
        from calfkit_tpu_torch.cli._dev_state import stop_broker

        stop_broker(info.port, kind)
        echo(f"{kind} stopped")


@dev_group.command(
    "serve",
    Argument("specs", nargs=-1),
    option("--name", "daemon_name", help="daemon name (default: first spec's attr)"),
    _PORT,
    flag("--kafka", "use_kafka", help="serve on the kafkad broker (real Kafka wire protocol)"),
)
def dev_serve(specs: tuple[str, ...], daemon_name: str | None,
              port: int | None, use_kafka: bool) -> None:
    """Detach a worker daemon serving SPECS on the managed dev broker."""
    from calfkit_tpu_torch.cli._dev_state import ensure_broker, spawn_daemon

    try:
        broker = ensure_broker(port, "kafkad" if use_kafka else "meshd")
    except (FileNotFoundError, RuntimeError, TimeoutError) as exc:
        raise CliError(str(exc)) from exc
    name = daemon_name or specs[0].rsplit(":", 1)[-1]
    try:
        info = spawn_daemon(name, list(specs), broker.url)
    except RuntimeError as exc:
        raise CliError(str(exc)) from exc
    echo(
        f"daemon {info.name!r} up (pid {info.pid}) on {broker.url}; "
        f"logs: {info.log_path}"
    )


@dev_group.command(
    "chat",
    option("--agent", "agent_name"),
    _PORT,
    flag("--kafka", "use_kafka", help="chat over the kafkad broker (real Kafka wire protocol)"),
)
def dev_chat(agent_name: str | None, port: int | None, use_kafka: bool) -> None:
    """Chat with the detached dev-mesh agents."""
    from calfkit_tpu_torch.cli._dev_state import broker_status
    from calfkit_tpu_torch.cli.chat import _chat
    from calfkit_tpu_torch.mesh.urls import mesh_from_url

    kind = "kafkad" if use_kafka else "meshd"
    status = broker_status(port, kind)
    if not status["up"]:
        flag = " --kafka" if use_kafka else ""
        raise CliError(
            f"{kind} is down on port {status['port']} — start it with "
            f"`ck dev mesh{flag}` (or `ck dev serve{flag} file.py:agent`)"
        )
    try:
        asyncio.run(_chat(mesh_from_url(status["url"]), agent_name))
    except OSError as exc:
        raise CliError(f"mesh connection failed: {exc}") from exc


@dev_group.command(
    "status", flag("--stats", help="also query live agents + engine metrics off the mesh")
)
def dev_status(stats: bool) -> None:
    """Broker + daemon liveness (add --stats for mesh-level detail).

    Each broker kind is probed on the port this registry recorded for it
    (falling back to its default), so custom ``ck dev mesh --port``
    spawns show up without re-passing the port here."""
    from calfkit_tpu_torch.cli._dev_state import broker_status, list_daemons

    statuses = [
        broker_status(None, kind) for kind in ("meshd", "kafkad")
    ]
    for broker in statuses:
        state = "up" if broker["up"] else "down"
        owner = f" (managed pid {broker['pid']})" if broker["pid"] else ""
        echo(f"broker {broker['url']}: {state}{owner}")
    daemons = list_daemons()
    if not daemons:
        echo("daemons: none")
    for d in daemons:
        mark = "alive" if d.alive else "DEAD"
        echo(f"  {d.name}: {mark} pid {d.pid} specs={','.join(d.specs)}")
    live = next((b for b in statuses if b["up"]), None)
    if stats and live is not None:
        try:
            asyncio.run(_mesh_stats(live["url"]))
        except Exception as exc:  # noqa: BLE001 - CLI boundary
            raise CliError(f"mesh stats unavailable: {exc}") from exc


async def _mesh_stats(url: str) -> None:
    from calfkit_tpu_torch.client import Client

    client = Client.connect(url)
    try:
        cards = await client.mesh_directory.get_agents()
        echo(f"live agents: {[c.name for c in cards] or 'none'}")
        for rec in await client.mesh_directory.get_engine_stats():
            pages = (
                f" free_pages={rec.free_pages}"
                if rec.free_pages is not None else ""
            )
            hbm = (
                f" hbm={rec.hbm_gb_in_use}GB"
                if rec.hbm_gb_in_use is not None else ""
            )
            echo(
                f"  engine {rec.node_id}: {rec.model_name} "
                f"[{rec.kv_layout}] tok/s={rec.tokens_per_second} "
                f"occ={rec.mean_occupancy} "
                f"slots={rec.max_batch_size - rec.free_slots}/"
                f"{rec.max_batch_size}{pages}{hbm}"
            )
    finally:
        await client.mesh_directory.close()
        await client.close()


@dev_group.command("stop", Argument("names", nargs=-1, required=False))
def dev_stop(names: tuple[str, ...]) -> None:
    """Stop named daemons (or all of them with no argument)."""
    from calfkit_tpu_torch.cli._dev_state import list_daemons, stop_daemon

    targets = list(names) or [d.name for d in list_daemons()]
    if not targets:
        echo("no daemons to stop")
        return
    for name in targets:
        echo(
            f"{name}: {'stopped' if stop_daemon(name) else 'not found'}"
        )


@dev_group.command("down")
def dev_down() -> None:
    """Stop every daemon AND the managed brokers (meshd + kafkad).

    Each broker is stopped on the port this registry recorded for it —
    a broker someone else runs is left alone."""
    from calfkit_tpu_torch.cli._dev_state import list_daemons, stop_broker, stop_daemon

    for d in list_daemons():
        stop_daemon(d.name)
        echo(f"daemon {d.name}: stopped")
    for kind in ("meshd", "kafkad"):
        if stop_broker(None, kind):
            echo(f"{kind}: stopped")
        else:
            echo(f"{kind}: not managed here (left alone)")
