"""``ck run module:attr ...`` — serve nodes.

``ck run <run-id>`` — when the single argument is id-shaped
(hex run id, which node specs can never be: specs carry ``:`` or a
path) the command instead prints the run's stitched cross-attempt
timeline from ``mesh.runs`` + ``mesh.traces``.
"""

from __future__ import annotations

from calfkit_tpu_torch.cli._common import (
    Argument,
    command,
    echo,
    flag,
    load_nodes,
    option,
    resolve_mesh_for_cli,
)


def _is_run_id(spec: str) -> bool:
    """True when a spec can only be a run id (32-hex ``new_id()``), never
    a servable node spec.  Specs are ``module:attr`` or ``path.py:attr``
    — always carrying ``:``, a dot, or a path separator — so a bare hex
    token was previously a guaranteed load error, making this dispatch
    regression-free."""
    if len(spec) < 12 or any(c in spec for c in ":/.\\"):
        return False
    try:
        int(spec, 16)
    except ValueError:
        return False
    return True


@command(
    "run",
    Argument("specs", nargs=-1),
    option("--mesh", "mesh_url", help="memory:// | tcp://host:port | kafka://host:port"),
    option("--max-workers", default=8, type=int, show_default=True),
    option("--group-id", help="override per-node consumer groups"),
    option("--timeout", default=15.0, type=float, show_default=True,
           help="catch-up timeout (s) for the run-timeline view"),
    option("--dump", "dump_path",
           help="flight-recorder dump to join into the run timeline "
           "(default: newest local dump)"),
    flag("--reload", "reload_", help="restart when watched .py files change (dev loop)"),
)
def run_command(specs: tuple[str, ...], mesh_url: str | None, max_workers: int,
                group_id: str | None, timeout: float,
                dump_path: str | None, reload_: bool) -> None:
    """Serve the given nodes until interrupted — or, given a single run
    id, print that run's stitched cross-attempt timeline."""
    if len(specs) == 1 and _is_run_id(specs[0]):
        from calfkit_tpu_torch.cli.obs import show_run_timeline

        show_run_timeline(
            specs[0], mesh_url, timeout, dump_path=dump_path
        )
        return
    if reload_:
        from calfkit_tpu_torch.cli._reload import (
            reload_child_argv,
            serve_with_reload,
            watch_roots_for_specs,
        )

        passthrough = ["--max-workers", str(max_workers)]
        if mesh_url:
            passthrough += ["--mesh", mesh_url]
        if group_id:
            passthrough += ["--group-id", group_id]
        roots = watch_roots_for_specs(specs)
        echo(f"watching {', '.join(str(r) for r in roots)} for changes")
        raise SystemExit(
            serve_with_reload(
                reload_child_argv(specs, passthrough), roots, echo=echo
            )
        )

    from calfkit_tpu_torch.worker import Worker

    nodes = load_nodes(specs)
    mesh = resolve_mesh_for_cli(mesh_url)
    echo(f"serving {len(nodes)} node(s): {[n.name for n in nodes]}")
    worker = Worker(
        nodes, mesh=mesh, owns_transport=True, max_workers=max_workers,
        group_id=group_id,
    )
    worker.run()
