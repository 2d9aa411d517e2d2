"""Traffic mixes: ``traffic/<name>.json`` holds a mix's parameters and its
``kind``; the generator ``traffic/<kind>.py`` reads it.  A generator module
has four functions:

- ``plan(spec, seed, vocab, max_seq_len, horizon_s) -> plan``: the
  requests of ``horizon_s`` seconds; sizes and arrivals come from the
  mix's own ``shape_seed``, the run's seed draws the token ids, so every
  seed offers the same work;
- ``async drive(plan, ctx)``: submits the mix through ``ctx.submit`` until
  ``ctx.stop_at`` (see :class:`loadbench.drive.Context`);
- ``context_range(plan)``: the least and the most context (prompt plus
  generated tokens) that the longest active request can hold while the mix
  runs at its steady load, and ``prompt_range(plan)``: the shortest and
  the longest prompt; the preparation reads both to capture the dispatch
  shapes the window will meet.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from typing import Any

import numpy as np

from loadbench import manifest


def load(name: str) -> dict:
    path = manifest.BENCH_DIR / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic file {path}")
    return json.loads(path.read_text())


def generator(kind: str) -> Any:
    """The generator module of ``kind`` (``traffic/<kind>.py``)."""
    path = manifest.BENCH_DIR / "traffic" / f"{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic generator {path}")
    name = f"loadbench_traffic_{kind}".replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # a dataclass resolves its module by name
    spec.loader.exec_module(module)
    return module


def strata(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` probabilities, one drawn inside each of ``n`` equal strata of
    (0, 1), in an order drawn from ``rng``: a block of ``n`` draws that
    follows its law closely even when ``n`` is small."""
    return rng.permutation((np.arange(n) + rng.uniform(0.0, 1.0, n)) / n)


def lengths(rng: np.random.Generator, law: dict, n: int) -> np.ndarray:
    """``n`` integer lengths drawn by ``law`` (stratified, :func:`strata`):
    ``{"median", "sigma", "min", "max"}`` is a lognormal clipped to
    [min, max]; ``{"min", "max"}`` alone is uniform over the whole numbers
    of [min, max]."""
    lo, hi = int(law["min"]), int(law["max"])
    u = strata(rng, n)
    if "median" in law:
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        return np.clip(np.rint(law["median"] * np.exp(law["sigma"] * z)), lo, hi).astype(np.int64)
    return (lo + np.floor(u * (hi - lo + 1))).astype(np.int64)


def shares(rng: np.random.Generator, weights: np.ndarray, n: int) -> np.ndarray:
    """``n`` picks among ``len(weights)`` choices, each taken in proportion
    to its weight (largest remainders), in an order drawn from ``rng``."""
    want = n * weights / weights.sum()
    counts = np.floor(want).astype(np.int64)
    for i in np.argsort(-(want - counts))[: n - counts.sum()]:
        counts[i] += 1
    return rng.permutation(np.repeat(np.arange(len(weights)), counts))


def token_ids(seed: int, stream: tuple, n: int, vocab: int) -> list[int]:
    """``n`` token ids of one stream (a tuple of whole numbers naming what
    they are for), drawn from the run's seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), *stream])
    return rng.integers(0, vocab, size=n).tolist()
