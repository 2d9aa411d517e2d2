"""The load benchmark of the PyTorch and CUDA serving engine
(``calfkit_tpu_torch``): one cell is one model configuration under one
traffic mix, named in ``BENCHMARK.json`` at the repository's root.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (read by the
generator ``traffic/<kind>.py`` that the file names), ``metrics/<metric>.py``
and ``limits/<cell>.json``.  See ``README.md``.
"""
