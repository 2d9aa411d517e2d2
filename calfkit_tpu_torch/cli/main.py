"""``ck`` entry point."""

from __future__ import annotations

import calfkit_tpu_torch
from calfkit_tpu_torch.cli._common import Group

main = Group(
    "ck", help="calfkit-tpu: TPU-native agent-mesh framework CLI",
    version=calfkit_tpu_torch.__version__,
)


def _register() -> None:
    """Attach every subcommand: ``main.commands`` maps each name to its
    command, as the JAX package's click group does."""
    from importlib import import_module

    for module_name, attr in (
        ("calfkit_tpu_torch.cli.run", "run_command"),
        ("calfkit_tpu_torch.cli.dev", "dev_group"),
        ("calfkit_tpu_torch.cli.chat", "chat_command"),
        ("calfkit_tpu_torch.cli.topics", "topics_group"),
        ("calfkit_tpu_torch.cli.obs", "trace_command"),
        ("calfkit_tpu_torch.cli.obs", "stats_command"),
        ("calfkit_tpu_torch.cli.obs", "fleet_command"),
        ("calfkit_tpu_torch.cli.obs", "leases_command"),
        ("calfkit_tpu_torch.cli.obs", "timeline_command"),
        ("calfkit_tpu_torch.cli.obs", "slo_command"),
        ("calfkit_tpu_torch.cli.obs", "capacity_command"),
        ("calfkit_tpu_torch.cli.sim", "sim_command"),
    ):
        main.add_command(getattr(import_module(module_name), attr))


_register()


if __name__ == "__main__":
    main(prog_name="ck")
