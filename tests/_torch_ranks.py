"""Spawned gloo ranks for the port's multi-process tests.

:func:`run_ranks` starts ``world`` processes (``spawn``), joins them in one
gloo group over a ``file://`` store under a temporary directory (no TCP
port to clash across test workers), runs ``fn(rank, *args)`` on each and
returns the results in rank order.  Every process has a deadline and is
killed at teardown: a hung collective fails the test, never the suite.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import traceback
from typing import Any, Callable

RANK_TIMEOUT_S = 120.0


def _child(path: str, world: int, rank: int, fn: Callable, args: tuple, out: Any) -> None:
    import torch

    torch.set_num_threads(1)
    from calfkit_tpu_torch.inference import distributed

    try:
        distributed.init_group("file://" + path, world, rank, backend="gloo", timeout_s=60.0)
        result = fn(rank, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - the parent reports it
        out.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown_group()


def run_ranks(world: int, fn: Callable, *args: Any, timeout_s: float = RANK_TIMEOUT_S) -> list:
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="calfkit-ranks-") as tmp:
        path = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_child, args=(path, world, r, fn, args, out), daemon=True)
            for r in range(world)
        ]
        for proc in procs:
            proc.start()
        results: dict = {}
        try:
            while len(results) < world:
                try:
                    rank, ok, value = out.get(timeout=timeout_s)
                except queue.Empty:
                    raise AssertionError(
                        f"ranks hung: {sorted(set(range(world)) - set(results))} gave no result "
                        f"in {timeout_s}s"
                    ) from None
                if not ok:
                    raise AssertionError(f"rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for proc in procs:
                proc.join(5.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join(5.0)
    return [results[r] for r in range(world)]


def sharded_forwards(rank: int, meshes: list, params_np: dict, tokens: Any) -> list:
    """On every rank of the world: for each ``(tp, dp)`` of ``meshes`` (each
    spanning the whole world), this rank's shard of ``params_np`` (the
    debug preset in f32) run through ``model.forward`` with the plain
    attention → the logits, one array a mesh."""
    import torch

    from calfkit_tpu_torch.inference import distributed as D
    from calfkit_tpu_torch.inference import model as M
    from calfkit_tpu_torch.inference import sharding as S
    from calfkit_tpu_torch.inference.config import preset
    from calfkit_tpu_torch.inference.weights import params_from_numpy

    cfg = preset("debug", dtype="float32")
    full = params_from_numpy(params_np, device="cpu")
    B, T = tokens.shape
    out = []
    for tp, dp in meshes:
        mesh = S.make_mesh(tp=tp, dp=dp, device_type="cpu")
        layout = S.layout_of(cfg, mesh, rank, D.Comm(mesh, rank))
        shard = S.place_params(full, S.param_shardings(cfg, mesh), rank=rank)
        params = M.Decoder(S.local_params(shard, cfg, layout), "cpu", layout).params()
        cache = M.make_empty_cache(cfg, B, 16, device="cpu", kv_heads=layout.kv_heads)
        logits, _ = M.forward(
            params, cfg, torch.from_numpy(tokens), torch.arange(T).expand(B, T), cache,
            torch.full((B,), T), attn_impl="plain",
        )
        out.append(logits.numpy())
    return out


def sp_functions(rank: int, params_np: dict, inputs: dict, meshes: list) -> dict:
    """On every rank of the world (sp = world): the long lane's functions
    of ``calfkit_tpu_torch.inference.ring_attention`` over this rank's
    blocks of ``inputs`` (numpy, made by the test).  The attention
    functions run on a ``dp = sp`` mesh; the prefill (monolithic and by
    chunks) and two carried decode dispatches run once a ``(tp, dp)`` of
    ``meshes`` (each spanning the world), on this rank's shard of the f32
    debug weights ``params_np`` → every output, keyed by case."""
    import torch

    from calfkit_tpu_torch.inference import distributed as D
    from calfkit_tpu_torch.inference import model as M
    from calfkit_tpu_torch.inference import ring_attention as RA
    from calfkit_tpu_torch.inference import sharding as S
    from calfkit_tpu_torch.inference.config import preset
    from calfkit_tpu_torch.inference.weights import params_from_numpy

    cfg = preset("debug", dtype="float32")
    full = params_from_numpy(params_np, device="cpu")
    T = torch.from_numpy
    out: dict = {}
    import torch.distributed as dist

    comm = D.Comm(S.make_mesh(dp=dist.get_world_size(), device_type="cpu"), rank)
    n, i = comm.sp, comm.sp_index

    def block(x: "torch.Tensor", dim: int) -> "torch.Tensor":
        blk = x.shape[dim] // n
        return x.narrow(dim, i * blk, blk)

    for name, (q, k, v, lens) in inputs["ring"].items():
        out["ring", name] = RA.ring_attention(
            block(T(q), 1), block(T(k), 1), block(T(v), 1), None if lens is None else T(lens),
            comm=comm,
        ).numpy()
    q, kp, vp, lens = inputs["context"]
    out["context"] = [x.numpy() for x in RA.context_parallel_attention(
        T(q), block(T(kp), 2), block(T(vp), 2), T(lens), comm=comm)]
    try:
        RA.prefill_sequence_parallel(full, cfg, T(inputs["indivisible"]), comm=comm)
    except ValueError as exc:
        out["indivisible"] = str(exc)
    tokens, lens = T(inputs["tokens"]), T(inputs["lens"])
    B, P = tokens.shape
    chunk, steps, cap = inputs["chunk"], inputs["steps"], inputs["cap"]
    for tp, dp in meshes:
        mesh = S.make_mesh(tp=tp, dp=dp, device_type="cpu")
        layout = S.layout_of(cfg, mesh, rank, D.Comm(mesh, rank))
        shard = S.place_params(full, S.param_shardings(cfg, mesh), rank=rank)
        params = M.Decoder(S.local_params(shard, cfg, layout), "cpu", layout).params()
        c = layout.comm
        logits, prefix = RA.prefill_sequence_parallel(params, cfg, tokens, lens, comm=c)
        # the chunked prefill over a zeroed scratch of this rank's block:
        # each row's logits from the chunk holding its last position
        scratch = tuple(torch.zeros_like(side) for side in prefix)
        by_chunk = []
        for off in range(0, P, chunk):
            last = (lens.to(torch.int64) - 1 - off).clamp(0, chunk - 1)
            by_chunk.append(RA.prefill_chunk_sequence_parallel(
                params, cfg, tokens[:, off:off + chunk], torch.tensor([off], dtype=torch.int32),
                last, scratch, comm=c))
        chunked = torch.stack([by_chunk[(int(m) - 1) // chunk][b] for b, m in enumerate(lens)])
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        fresh = tuple(torch.zeros((cfg.n_layers, B, layout.kv_heads, cap, cfg.head_dim))
                      for _ in range(2))
        last, toks = first, []
        for t0 in (0, steps):
            got, last, fresh = RA.decode_sp_dispatch(
                params, cfg, last, prefix, lens, fresh, torch.tensor([t0], dtype=torch.int32),
                steps, comm=c)
            toks.append(got.numpy())
        one_shot = RA.decode_with_sharded_prefix(params, cfg, first, prefix, lens, 2 * steps,
                                                 comm=c)
        out["mesh", tp, dp] = dict(
            logits=logits.numpy(), k=prefix[0].numpy(), v=prefix[1].numpy(),
            chunked=chunked.numpy(), chunk_k=scratch[0].numpy(), chunk_v=scratch[1].numpy(),
            toks=toks, last=last.numpy(), fresh=[f.numpy() for f in fresh],
            one_shot=one_shot.numpy(), kv=S.kv_span(cfg, tp, layout.t),
        )
    return out


def _refuse_to_load() -> None:
    raise RuntimeError("this argument cannot be loaded in the spawned rank")


class Unloadable:
    """An argument a spawned rank fails to unpickle: the rank dies while
    starting, before it joins its group."""

    def __reduce__(self) -> tuple:
        return _refuse_to_load, ()
