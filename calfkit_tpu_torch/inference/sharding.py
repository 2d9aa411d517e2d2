"""The dp x tp layout of the port's multi-process engine.

The counterpart of ``calfkit_tpu.inference.sharding``, with the same axes,
the same per-leaf specs and the same divisibility rule:

- ``tp`` splits attention heads, the MLP hidden and the vocabulary inside
  one model replica;
- ``dp`` splits the batch of the dense KV cache and the token buffers;
- a leaf whose dimension does not divide by its axis is replicated on that
  axis (:func:`_spec`).

The reference hands these specs to GSPMD, which inserts the collectives.
The port runs one process per rank and writes them itself: each rank holds
the slice of every leaf that its coordinates select (:func:`place_params`),
and :class:`Layout` tells the model which products of that rank end in an
all-reduce (only those whose reduction dimension was split) and which
outputs are gathered (the vocab-split logits).

A :class:`Mesh` is a grid of process ranks, ``ranks[d, t]``; a
:class:`Sharding` is a mesh and a spec, one entry a dimension (``"dp"``,
``"tp"`` or ``None``), as a ``PartitionSpec``'s entries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from calfkit_tpu_torch.inference.config import ModelConfig
from calfkit_tpu_torch.inference.quant import (
    DEFAULT_Q4_GROUP,
    LAYER_REDUCTION_AXES,
    LM_HEAD_REDUCTION_AXES,
    _q4_group_for,
    q4_key_of,
)

Params = dict[str, Any]


class RankShard(dict):
    """A params tree that is one rank's shard (:func:`place_params`), not
    a full model: the engine takes it as it is."""


class Mesh:
    """A ``dp x tp`` grid of process ranks: rank ``ranks[d, t]`` holds the
    tp-th slice of every tp-split leaf of the d-th replica."""

    axis_names = ("dp", "tp")

    def __init__(self, ranks: "np.ndarray | list"):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        if self.ranks.ndim != 2:
            raise ValueError(f"a mesh is a [dp, tp] grid of ranks, got shape {self.ranks.shape}")
        dp, tp = self.ranks.shape
        self.shape = {"dp": int(dp), "tp": int(tp)}

    @property
    def size(self) -> int:
        return self.ranks.size

    def coords(self, rank: int) -> "dict[str, int]":
        """The (dp, tp) coordinates of ``rank``."""
        found = np.argwhere(self.ranks == rank)
        if not len(found):
            raise ValueError(f"rank {rank} is not in the mesh {self.ranks.tolist()}")
        d, t = (int(i) for i in found[0])
        return {"dp": d, "tp": t}

    def tp_ranks(self, d: int) -> "list[int]":
        return [int(r) for r in self.ranks[d]]

    def dp_ranks(self, t: int) -> "list[int]":
        return [int(r) for r in self.ranks[:, t]]

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Mesh) and np.array_equal(self.ranks, other.ranks)

    def __hash__(self) -> int:
        return hash(self.ranks.tobytes())

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, ranks={self.ranks.tolist()})"


def default_devices(device_type: str = "cuda") -> "list[int]":
    """The ranks a mesh may span by default: the process group's world when
    one is initialized; else one rank a card (``cuda``), or, on the CPU,
    as many as are asked for (``None``: a CPU rank is a process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    if device_type == "cuda":
        return list(range(torch.cuda.device_count())) if torch.cuda.is_available() else []
    return None  # type: ignore[return-value]


def make_mesh(
    tp: int = 1, dp: int = 1, *, devices: "list[int] | None" = None,
    device_type: str = "cuda",
) -> Mesh:
    """A ``dp x tp`` mesh over the first ``tp * dp`` of ``devices`` (ranks;
    default :func:`default_devices`); raises as the reference does when
    there are fewer."""
    need = tp * dp
    if devices is None:
        devices = default_devices(device_type)
        if devices is None:
            devices = list(range(need))
    if len(devices) < need:
        raise ValueError(
            f"mesh needs {need} devices (tp={tp} × dp={dp}), have {len(devices)}"
        )
    return Mesh(np.array(devices[:need]).reshape(dp, tp))


@dataclass(frozen=True)
class Sharding:
    """A leaf's layout: its mesh and one spec entry a dimension."""

    mesh: Mesh
    spec: tuple

    def slices(self, shape: "tuple[int, ...]", rank: int) -> tuple:
        """The index of ``rank``'s shard of a leaf of ``shape``."""
        coords = self.mesh.coords(rank)
        out = []
        for dim, size in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if size % n:
                raise ValueError(f"dimension {dim} of {shape} does not divide by {axis}={n}")
            step = size // n
            out.append(slice(coords[axis] * step, (coords[axis] + 1) * step))
        return tuple(out)

    def shard(self, x: Any, rank: int) -> Any:
        """``rank``'s slice of ``x`` (a view)."""
        return x[self.slices(tuple(x.shape), rank)]


def _spec(mesh: Mesh, dims: "list[tuple[int, str | None]]") -> tuple:
    """A spec, dropping axis names whose size does not divide the dim
    (replicate instead): the reference's rule, leaf for leaf."""
    parts: list = []
    for size, axis in dims:
        if axis is None or size % mesh.shape[axis] != 0:
            parts.append(None)
        else:
            parts.append(axis)
    return tuple(parts)


def param_shardings(config: ModelConfig, mesh: Mesh) -> Params:
    """The :class:`Sharding` tree matching :func:`model.init_params`."""
    D, H, K, hd, F, V = (
        config.d_model, config.n_heads, config.n_kv_heads, config.head_dim,
        config.d_ff, config.vocab_size,
    )

    def ns(dims: "list[tuple[int, str | None]]") -> Sharding:
        return Sharding(mesh, _spec(mesh, dims))

    L = (config.n_layers, None)
    shardings: Params = {
        "embed": ns([(V, "tp"), (D, None)]),
        "layers": {
            "wq": ns([L, (D, None), (H, "tp"), (hd, None)]),
            "wk": ns([L, (D, None), (K, "tp"), (hd, None)]),
            "wv": ns([L, (D, None), (K, "tp"), (hd, None)]),
            "wo": ns([L, (H, "tp"), (hd, None), (D, None)]),
            "w_gate": ns([L, (D, None), (F, "tp")]),
            "w_up": ns([L, (D, None), (F, "tp")]),
            "w_down": ns([L, (F, "tp"), (D, None)]),
            "attn_norm": ns([L, (D, None)]),
            "mlp_norm": ns([L, (D, None)]),
        },
        "final_norm": ns([(D, None)]),
    }
    if not config.tie_embeddings:
        shardings["lm_head"] = ns([(D, None), (V, "tp")])
    return shardings


def cache_sharding(config: ModelConfig, mesh: Mesh, batch: int) -> Sharding:
    """KV cache [L, B, K, S, hd]: batch over dp, kv heads over tp."""
    return Sharding(mesh, _spec(mesh, [
        (config.n_layers, None), (batch, "dp"), (config.n_kv_heads, "tp"), (1, None),
        (config.head_dim, None),
    ]))


def pool_sharding(config: ModelConfig, mesh: Mesh) -> Sharding:
    """Paged KV pool [L, N, K, page, hd]: kv heads over tp; the pages are
    NOT split over dp (block tables address the whole pool)."""
    return Sharding(mesh, _spec(mesh, [
        (config.n_layers, None), (1, None), (config.n_kv_heads, "tp"), (1, None),
        (config.head_dim, None),
    ]))


def batch_sharding(mesh: Mesh, batch: int) -> Sharding:
    return Sharding(mesh, _spec(mesh, [(batch, "dp")]))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _map(fn: Any, params: Any, shardings: Any) -> Any:
    if isinstance(shardings, dict):
        return {k: _map(fn, params[k], v) for k, v in shardings.items()}
    return fn(params, shardings)


def place_params(params: Params, shardings: Params, *, rank: int) -> Params:
    """``rank``'s shard of every leaf of ``params`` (the reference's
    ``device_put`` onto the layout, seen from one rank): a leaf that is cut
    is copied out of the full tensor, so the full one can be freed; a
    replicated leaf is passed through.  The shards stay on the full
    tensors' device (:class:`model.Decoder` moves them)."""

    def place(x: torch.Tensor, sh: Sharding) -> torch.Tensor:
        part = sh.shard(x, rank)
        return part.clone() if part.numel() != x.numel() else x

    return RankShard(_map(place, params, shardings))


# --------------------------------------------------------------------------- #
# a rank's view of the model
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Layout:
    """How one rank's shard of a model computes: the products whose
    reduction dimension is split over tp end in a tp all-reduce, the
    vocab-split embedding and logits are rejoined, and the rank's
    attention reads the kv heads ``kv = (lo, n)`` of its leaves (its cache
    holds only those).  ``comm`` runs the collectives
    (:class:`distributed.Comm`); ``None`` only in a layout that is
    described, never run."""

    tp: int
    t: int
    dp: int
    d: int
    vocab: "tuple[int, int] | None"  # this rank's (first row, rows) when split
    heads: bool  # wq/wo split over tp: wo's product is partial
    ff: bool  # w_gate/w_up/w_down split over tp: w_down's product is partial
    kv: "tuple[int, int]"  # (first, count) of the kv heads this rank attends
    kv_heads: int  # the kv heads this rank's cache holds (== kv[1])
    comm: Any = None

    def batch_rows(self, batch: int) -> "tuple[int, int] | None":
        """This rank's (first row, rows) of a dp-split batch, or ``None``
        when the batch is replicated (dp = 1, or ``batch % dp``)."""
        if self.dp == 1 or batch % self.dp:
            return None
        rows = batch // self.dp
        return self.d * rows, rows


def layout_of(config: ModelConfig, mesh: Mesh, rank: int, comm: Any = None) -> Layout:
    """``rank``'s :class:`Layout` of ``config`` on ``mesh``, read from
    :func:`param_shardings`' specs: a product ends in a tp all-reduce only
    where the spec split its reduction dimension."""
    coords = mesh.coords(rank)
    tp, t = mesh.shape["tp"], coords["tp"]
    specs = param_shardings(config, mesh)
    sl = specs["layers"]

    def split(sh: Sharding, dim: int) -> bool:
        return tp > 1 and sh.spec[dim] == "tp"

    H, K, V = config.n_heads, config.n_kv_heads, config.vocab_size
    heads = split(sl["wo"], 1)  # [L, H, hd, D]
    vocab = (t * (V // tp), V // tp) if split(specs["embed"], 0) else None
    if split(sl["wk"], 2) or tp == 1:
        kv = (0, K // tp)  # the rank's own kv shard, whole
    elif heads:
        # kv replicated, queries split: the rank attends the kv heads its
        # query heads read (global head h reads kv head h // G)
        Hl, G = H // tp, H // K
        lo, hi = t * Hl // G, ((t + 1) * Hl - 1) // G + 1
        if Hl % G and G % Hl:
            raise ValueError(
                f"tp={tp} splits {H} query heads into {Hl} a rank, which neither "
                f"holds whole kv groups of {G} nor lies inside one"
            )
        kv = (lo, hi - lo)
    else:
        kv = (0, K)
    return Layout(
        tp=tp, t=t, dp=mesh.shape["dp"], d=coords["dp"], vocab=vocab, heads=heads,
        ff=split(sl["w_down"], 1), kv=kv, kv_heads=kv[1], comm=comm,
    )


def _q4_scale_rows(leaf: Params, axis: int, rank_rows: "tuple[int, int]") -> Params:
    """An int4 leaf whose packing axis is split: the reference replicates
    the scale there, so the rank takes the scale rows of its own slice."""
    key, n_right, group = q4_key_of(leaf)
    lo, n = rank_rows  # unpacked rows of the packing axis this rank holds
    scale = leaf["scale"]
    if n % group == 0:
        rows = scale.narrow(axis, lo // group, n // group)
        return {key: leaf[key], "scale": rows.contiguous()}
    if group % n == 0:
        # the rank's rows lie inside one group: its scale row, and a
        # group of the rank's whole axis
        rows = scale.narrow(axis, lo // group, 1)
        return {f"q4an{n_right}g{n}": leaf[key], "scale": rows.contiguous()}
    raise ValueError(
        f"int4 group {group} does not align with the {n} rows a rank holds of the "
        f"packed axis (a rank's rows must be whole groups or lie inside one)"
    )


def local_params(params: Params, config: ModelConfig, layout: Layout) -> Params:
    """A rank's shard (:func:`place_params`) as its model computes with it:
    wk/wv narrowed to the kv heads the rank attends where they are
    replicated, and each int4 leaf whose packing axis is split given the
    scale rows of its own slice."""
    layers = dict(params["layers"])
    K = config.n_kv_heads
    lo, n = layout.kv
    for name in ("wk", "wv"):
        leaf = layers[name]
        full = (leaf["scale"] if isinstance(leaf, dict) else leaf).shape[2]
        if n != full:
            if full != K:
                raise ValueError(f"{name} holds {full} kv heads, expected {K}")
            if isinstance(leaf, dict):
                layers[name] = {k: v.narrow(2, lo, n).contiguous() for k, v in leaf.items()}
            else:
                layers[name] = leaf.narrow(2, lo, n).contiguous()
    if layout.ff:
        leaf = layers["w_down"]
        if isinstance(leaf, dict) and q4_key_of(leaf) is not None:
            F = config.d_ff
            n_rows = F // layout.tp
            axis = 1  # [L, F, D]: F is the packing axis
            layers["w_down"] = _q4_scale_rows(leaf, axis, (layout.t * n_rows, n_rows))
    return RankShard({**params, "layers": layers})


def q4_template(config: ModelConfig) -> Params:
    """The tree ``config``'s params quantize to at 4 bits, with the int4
    leaves' keys (``q4an<n>g<group>``) and ``None`` values: what
    :func:`quant.align_quant_sharding_keys` reads, before any tensor
    exists."""
    L, D, H, K, hd, F, V = (
        config.n_layers, config.d_model, config.n_heads, config.n_kv_heads,
        config.head_dim, config.d_ff, config.vocab_size,
    )
    shapes = {
        "wq": (L, D, H, hd), "wk": (L, D, K, hd), "wv": (L, D, K, hd), "wo": (L, H, hd, D),
        "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D),
    }

    def leaf(shape: tuple, axes: tuple) -> dict:
        axis = axes[-1]
        group = _q4_group_for(shape[axis], DEFAULT_Q4_GROUP)
        return {f"q4an{len(shape) - axis}g{group}": None, "scale": None}

    layers: Params = {n: leaf(sh, LAYER_REDUCTION_AXES[n]) for n, sh in shapes.items()}
    layers.update(attn_norm=None, mlp_norm=None)
    tree: Params = {"embed": None, "final_norm": None, "layers": layers}
    if not config.tie_embeddings:
        tree["lm_head"] = leaf((D, V), LM_HEAD_REDUCTION_AXES)
    return tree


def check_q4_alignment(config: ModelConfig, mesh: Mesh, group: int = DEFAULT_Q4_GROUP) -> None:
    """Raise where a tp split of an int4 leaf's packing axis cuts a scale
    group (the only packing axis tp splits is w_down's F)."""
    tp = mesh.shape["tp"]
    F = config.d_ff
    if tp == 1 or F % tp:
        return
    n = F // tp
    g = group if F % group == 0 else F
    if n % g and g % n:
        raise ValueError(
            f"int4 at tp={tp}: d_ff/tp = {n} is neither a whole number of groups of "
            f"{g} nor inside one"
        )
