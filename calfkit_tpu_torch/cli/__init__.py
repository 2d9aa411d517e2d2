"""The ``ck`` command-line interface: ``python -m calfkit_tpu_torch.cli``.

The JAX package's ``ck`` (``run``, ``dev``, ``chat``, ``topics``, the
operator views ``trace``, ``stats``, ``fleet``, ``leases``, ``timeline``,
``slo``, ``capacity``, and ``sim``), with the same subcommands, options,
defaults and environment variables, on ``argparse``.
"""
