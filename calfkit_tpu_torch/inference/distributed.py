"""Multi-process bring-up and the collectives of the port's engine.

The counterpart of ``calfkit_tpu.inference.distributed``.  The reference is
single-controller: one process, one scheduler, and GSPMD placing the work
on every device of a pod.  The port runs ONE PROCESS A RANK, each with its
own card (or, on the CPU, its own process), joined by a
``torch.distributed`` process group:

- rank 0 owns the engine's scheduler and every public entry point;
- ranks 1..n-1 run :func:`serve_worker`'s loop: for each dispatch rank 0
  runs, they receive its descriptor (the graph's recipe, its key, and the
  host inputs copied into its static buffers) and run the same dispatch on
  their own shard, so every rank meets every collective in the same order;
- the collectives (:class:`Comm`: the tp all-reduces after the
  row-parallel products, the vocab gathers, the dp gathers) run inside the
  dispatch bodies (:mod:`.model`).

On one host, ``InferenceEngine(config, RuntimeConfig(tp=2))`` starts its
workers itself (:func:`spawn_workers`).  Across hosts, every host calls
:func:`initialize_multihost` first; rank 0 then builds its engine and every
other rank calls :func:`serve_worker` with the same configuration, which
blocks until rank 0's engine stops:

    CALFKIT_COORDINATOR=10.0.0.1:8476 CALFKIT_NUM_PROCESSES=2 \\
    CALFKIT_PROCESS_ID=1 python -c 'from calfkit_tpu_torch.inference import \\
        distributed as d; d.initialize_multihost(); d.serve_worker(cfg, rt)'

Descriptors travel through the rendezvous store (:class:`Channel`), never
through a collective, so an idle engine never runs a worker into the
group's timeout; the collectives themselves have a finite timeout, and a
peer that died ends rank 0's requests with a typed fault (:class:`RankFault`).
The spawned group's store is a TCP store that rank 0 hosts on a loopback
port, where the channel's deleted descriptors are freed; a ``file://``
store only appends, so its file grows with every dispatch (serve long on a
``host:port`` coordinator).
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import pickle
import socket
import threading
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import torch

from calfkit_tpu_torch.exceptions import InferenceError

logger = logging.getLogger(__name__)

_ENV_COORDINATOR = "CALFKIT_COORDINATOR"
_ENV_NUM_PROCESSES = "CALFKIT_NUM_PROCESSES"
_ENV_PROCESS_ID = "CALFKIT_PROCESS_ID"

# the collectives' timeout: a peer that stops answering fails the dispatch
# after this long (a peer that died fails it at once: its sockets close)
GROUP_TIMEOUT_S = 300.0

# the store this process's group was made over (the descriptor channel
# rides it), and the multi-rank engines built on the group so far
_STORE: Any = None
_ENGINES = 0


class RankFault(InferenceError):
    """A collective or a descriptor of the engine's process group failed:
    a rank died, or stopped answering within the group's timeout."""


@dataclass(frozen=True)
class MultihostInfo:
    """What the engine needs to know after bring-up."""

    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1


def _local_device_count() -> int:
    if torch.cuda.is_available():
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def _info() -> MultihostInfo:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        return MultihostInfo(
            process_id=dist.get_rank(), num_processes=world, local_devices=1,
            global_devices=world,
        )
    n = _local_device_count()
    return MultihostInfo(process_id=0, num_processes=1, local_devices=n, global_devices=n)


def _cluster_env() -> "tuple[str, int, int] | None":
    """torchrun's (or any launcher's) coordinates: ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, when all are set."""
    env = os.environ
    if all(env.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        return f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def initialize_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> MultihostInfo:
    """Join this process to the engine's process group; safe to call on one
    host.

    Resolution order per coordinate: explicit argument →
    ``CALFKIT_COORDINATOR``/``CALFKIT_NUM_PROCESSES``/``CALFKIT_PROCESS_ID``
    env vars → a launcher's cluster environment (torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``).  With no
    coordinates from any source, this is a no-op single-process setup.

    ``coordinator`` is ``host:port`` (rank 0 serves the store there) or
    ``file://path`` (a shared file).  ``backend`` defaults to NCCL where
    there are cards (each rank then drives card ``process_id % cards``)
    and gloo on the CPU; NCCL on a card another rank of the group also
    drives raises, as NCCL itself does.  ``backend="gloo"`` on cards is
    legal when asked for: its collectives stage through the host and
    cannot be captured in a CUDA graph (such an engine serves under
    ``graphs.eager()``).

    After it returns, rank 0 builds its engine with ``tp``/``dp`` sized to
    the world, and every other rank calls :func:`serve_worker`.  Rank 0
    admits every request (the reference's hosts each admit their own)."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get(_ENV_COORDINATOR)
    if num_processes is None and (raw := os.environ.get(_ENV_NUM_PROCESSES)):
        num_processes = int(raw)
    if process_id is None and (raw := os.environ.get(_ENV_PROCESS_ID)):
        process_id = int(raw)

    given = {
        "coordinator": coordinator is not None,
        "num_processes": num_processes is not None,
        "process_id": process_id is not None,
    }
    if any(given.values()) and not all(given.values()):
        missing = [k for k, ok in given.items() if not ok]
        raise ValueError(
            "multi-host coordinates must be set together "
            f"(missing: {', '.join(missing)}); set all three of "
            f"{_ENV_COORDINATOR}/{_ENV_NUM_PROCESSES}/{_ENV_PROCESS_ID} "
            "or none"
        )
    if not all(given.values()) and (cluster := _cluster_env()) is not None:
        coordinator, num_processes, process_id = cluster
        given = dict.fromkeys(given, True)
    if all(given.values()) and not dist.is_initialized():
        init_group(coordinator, num_processes, process_id, backend=backend)
        logger.info(
            "torch.distributed initialized: process %s of %s via %s (%s)",
            process_id, num_processes, coordinator, dist.get_backend(),
        )
    return _info()


def assert_engine_fits(info: MultihostInfo, tp: int, dp: int) -> None:
    """Loudly reject a mesh that over-asks — or, multi-host, under-uses —
    the pod.

    Single-host under-use is legitimate (an engine on 1 of 8 chips).
    Multi-host under-use is not: a mesh that omits another process's
    addressable devices hangs or errors at the first collective, so every
    pod device must be in the mesh.
    """
    need = tp * dp
    if need > info.global_devices:
        raise ValueError(
            f"engine mesh tp={tp} x dp={dp} needs {need} devices but the "
            f"{'pod' if info.is_multihost else 'host'} has "
            f"{info.global_devices}"
        )
    if info.is_multihost and need != info.global_devices:
        raise ValueError(
            f"multi-host engine mesh must span the whole pod: tp x dp = "
            f"{need} but {info.num_processes} processes contribute "
            f"{info.global_devices} devices (a partial mesh omits another "
            "process's devices and deadlocks at the first collective)"
        )


# --------------------------------------------------------------------------- #
# the process group
# --------------------------------------------------------------------------- #


def _make_store(coordinator: str, world: int, rank: int, timeout: timedelta) -> Any:
    import torch.distributed as dist

    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], world)
    host, _, port = coordinator.rpartition(":")
    host = host.removeprefix("tcp://") or "127.0.0.1"
    return dist.TCPStore(host, int(port), world, rank == 0, timeout, wait_for_workers=False)


def _poll_keys(
    store: Any, keys: "list[str]", alive: Any, timeout_s: float, what: str, every_s: float,
) -> None:
    """Wait until ``keys`` are all in ``store``, checking every ``every_s``
    (a check never blocks, so a store's wait timing out logs nothing):
    :class:`RankFault` after ``timeout_s``, or once ``alive()`` says the
    other side is gone."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            if store.check(keys):
                return
        except RuntimeError as exc:  # the store's host is gone
            raise RankFault(f"{what}: {exc}") from exc
        if alive is not None and not alive():
            raise RankFault(f"{what}: the other side is gone")
        if time.monotonic() > deadline:
            raise RankFault(f"{what}: nothing within {timeout_s:.0f} s")
        time.sleep(every_s)


def _store_barrier(store: Any, name: str, world: int, timeout_s: float, alive: Any) -> None:
    if store.add(name, 1) == world:
        store.set(name + "/all", b"1")
    _poll_keys(store, [name + "/all"], alive, timeout_s, f"the group's ranks at {name!r}", 0.02)


def init_group(
    coordinator: str, world: int, rank: int, *, backend: str | None = None,
    timeout_s: float = GROUP_TIMEOUT_S, store: Any = None, alive: Any = None,
) -> None:
    """``torch.distributed.init_process_group`` over a store made from
    ``coordinator`` (or ``store``, made already), with a finite timeout.
    Every rank first meets the others at a barrier of the store, which
    ends at once when ``alive()`` turns false (a peer that died while
    starting).  On cards, rank r takes card ``r % cards`` (``LOCAL_RANK``
    when a launcher sets it)."""
    global _STORE, _ENGINES
    import torch.distributed as dist

    timeout = timedelta(seconds=timeout_s)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r} (nccl | gloo)")
    if backend == "nccl" and not torch.cuda.is_available():
        raise ValueError("backend='nccl' needs CUDA cards: use 'gloo' on the CPU")
    if store is None:
        store = _make_store(coordinator, world, rank, timeout)
    _store_barrier(store, "calfkit/joined", world, timeout_s, alive)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        card = local % torch.cuda.device_count()
        torch.cuda.set_device(card)
        if backend == "nccl":
            # NCCL refuses two ranks on one card: refuse here, on every
            # rank that shares it, before the first collective hangs on it
            key = f"calfkit/card/{socket.gethostname()}/{card}"
            store.add(key, 1)
            _store_barrier(store, "calfkit/cards", world, timeout_s, alive)
            if store.add(key, 0) > 1:
                raise ValueError(
                    f"NCCL: card {card} of {socket.gethostname()} is shared by "
                    f"{store.add(key, 0)} ranks (NCCL needs a card a rank; pass "
                    "backend='gloo' to share one)"
                )
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timeout)
    _STORE, _ENGINES = store, 0


def shutdown_group() -> None:
    """Leave the process group this process joined, if any."""
    global _STORE
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STORE = None


class Comm:
    """The collectives of one rank of an engine's mesh: the tp sub-group
    (all-reduce, gather), the dp sub-group (gather) and the sp group of
    the long-context lane (every rank of the mesh in its rank order: the
    ring exchange, all-reduce max and sum).  Every rank builds every
    sub-group, in the same order (``new_group`` is collective).

    With gloo, a tensor on a card is staged through the host, and a
    collective met while a CUDA graph is being captured raises: gloo work
    cannot live in a graph.  Any failure of a collective is a
    :class:`RankFault`."""

    def __init__(self, mesh: Any, rank: int):
        import torch.distributed as dist

        self.mesh, self.rank = mesh, rank
        self.backend = dist.get_backend()
        coords = mesh.coords(rank)
        timeout = timedelta(seconds=GROUP_TIMEOUT_S)
        self.tp_group = self.dp_group = None
        self.tp, self.dp = mesh.shape["tp"], mesh.shape["dp"]
        if self.tp > 1:
            for d in range(self.dp):
                group = dist.new_group(mesh.tp_ranks(d), timeout=timeout)
                if d == coords["dp"]:
                    self.tp_group = group
        if self.dp > 1:
            for t in range(self.tp):
                group = dist.new_group(mesh.dp_ranks(t), timeout=timeout)
                if t == coords["tp"]:
                    self.dp_group = group
        # the sp ring: rank ranks[d, t] is its position d * tp + t
        self.sp_ranks = [int(r) for r in mesh.ranks.reshape(-1)]
        self.sp, self.sp_index = len(self.sp_ranks), self.sp_ranks.index(rank)
        self.sp_group = dist.new_group(self.sp_ranks, timeout=timeout) if self.sp > 1 else None
        self.gloo = self.backend == "gloo"
        self.stats = dict(all_reduce=0, all_gather=0, ring=0, seconds=0.0)

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cuda" and self.gloo:
            if torch.cuda.is_current_stream_capturing():
                raise InferenceError(
                    "a gloo collective met inside a CUDA-graph capture: an engine on a "
                    "gloo group serves only under graphs.eager() (use NCCL, one card a "
                    "rank, to serve on graphs)"
                )
            return x.cpu()
        return x

    def _run(self, op: Any) -> Any:
        started = time.perf_counter()
        try:
            return op()
        except RuntimeError as exc:
            raise RankFault(f"collective failed (a rank died or timed out): {exc}") from exc
        finally:
            self.stats["seconds"] += time.perf_counter() - started

    def _reduce(self, x: torch.Tensor, group: Any, op: Any = None) -> torch.Tensor:
        import torch.distributed as dist

        self.stats["all_reduce"] += 1
        y = self._host(x).contiguous()
        op = dist.ReduceOp.SUM if op is None else op
        self._run(lambda: dist.all_reduce(y, op=op, group=group))
        return y.to(x.device)

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the tp group, in ``x``'s dtype (``x`` is a
        product's fresh output: it is summed in place)."""
        return self._reduce(x, self.tp_group)

    def sp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the sp group (every rank), in ``x``'s dtype;
        ``x`` is summed in place: pass a tensor nothing else reads."""
        return self._reduce(x, self.sp_group)

    def sp_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over the sp group, in place as
        :meth:`sp_sum`."""
        import torch.distributed as dist

        return self._reduce(x, self.sp_group, dist.ReduceOp.MAX)

    def sp_ring(self, *tensors: torch.Tensor) -> "tuple[torch.Tensor, ...]":
        """One hop of the sp ring: each tensor sent to the next rank, (i + 1)
        mod sp, and its counterpart received from the previous one, (i - 1)
        mod sp, in one batch of point-to-point operations (at sp = 2 both
        are the one other rank) → the received tensors, on ``tensors``'
        device."""
        import torch.distributed as dist

        self.stats["ring"] += 1
        n, i = self.sp, self.sp_index
        nxt, prev = self.sp_ranks[(i + 1) % n], self.sp_ranks[(i - 1) % n]
        sends = [self._host(t).contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, nxt, group=self.sp_group) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, prev, group=self.sp_group) for t in recvs]

        def exchange() -> None:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        self._run(exchange)
        return tuple(r.to(t.device) for r, t in zip(recvs, tensors))

    def _gather(self, x: torch.Tensor, dim: int, group: Any, n: int) -> torch.Tensor:
        import torch.distributed as dist

        self.stats["all_gather"] += 1
        y = self._host(x).contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        self._run(lambda: dist.all_gather(parts, y, group=group))
        return torch.cat(parts, dim=dim).to(x.device)

    def tp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x``'s tp shards joined along ``dim``, in rank order."""
        return self._gather(x, dim, self.tp_group, self.tp)

    def dp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x``'s dp shards joined along ``dim``, in rank order."""
        return self._gather(x, dim, self.dp_group, self.dp)


# --------------------------------------------------------------------------- #
# the descriptor channel
# --------------------------------------------------------------------------- #


class Channel:
    """Rank 0's descriptors to the other ranks, in order, through the store:
    descriptor n is key ``<prefix>/n``, deleted ``KEEP`` descriptors later.
    A receiver blocks in the store's wait, a while at a time, so an idle
    engine costs nothing and a sender that died is noticed: at once on a
    TCP store, which rank 0 hosts (the wait's connection breaks), else by
    ``alive()`` between waits.  Replies (:meth:`reply` / :meth:`replies`)
    use keys of their own."""

    KEEP = 256  # descriptors kept in the store behind the newest

    def __init__(self, store: Any, prefix: str, rank: int, world: int):
        import torch.distributed as dist

        self._store = dist.PrefixStore(prefix, store)
        self.rank, self.world = rank, world
        # a wait that times out logs a line on a TCP store, and a FileStore
        # cannot tell that its writer died: wait long on the one, poll the other
        self._wait_s = 1.0 if isinstance(store, dist.FileStore) else 60.0
        self._seq = 0
        self.sent_s = 0.0  # rank 0's seconds spent sending descriptors
        self.sent = 0

    def send(self, message: Any) -> None:
        started = time.perf_counter()
        self._seq += 1
        try:
            self._store.set(str(self._seq), pickle.dumps(message, protocol=pickle.HIGHEST_PROTOCOL))
            if self._seq > self.KEEP:
                self._store.delete_key(str(self._seq - self.KEEP))
        except Exception as exc:  # noqa: BLE001 - any store failure is the group's
            raise RankFault(f"descriptor channel failed: {exc}") from exc
        self.sent += 1
        self.sent_s += time.perf_counter() - started

    def recv(self, alive: Any = None) -> Any:
        self._seq += 1
        key = str(self._seq)
        while True:
            try:
                self._store.wait([key], timedelta(seconds=self._wait_s))
                break
            except RuntimeError as exc:  # DistStoreError is one
                if "time" not in str(exc).lower():
                    raise RankFault(f"descriptor channel: {exc}") from exc
            if alive is not None and not alive():
                raise RankFault("descriptor channel: rank 0 is gone")
        return pickle.loads(self._store.get(key))

    def reply(self, tag: str, value: Any) -> None:
        self._store.set(f"reply/{tag}/{self.rank}", pickle.dumps(value))

    def replies(self, tag: str, alive: Any = None) -> "list[Any]":
        keys = [f"reply/{tag}/{r}" for r in range(1, self.world)]
        _poll_keys(self._store, keys, alive, GROUP_TIMEOUT_S, f"the ranks' replies to {tag!r}",
                   0.001)
        out = [pickle.loads(self._store.get(k)) for k in keys]
        for k in keys:
            self._store.delete_key(k)
        return out


def engine_channel(rank: int, world: int) -> Channel:
    """The descriptor channel of this process's next multi-rank engine: the
    n-th engine rank 0 builds pairs with the n-th :func:`serve_worker`
    call of every other rank."""
    global _ENGINES
    if _STORE is None:
        raise InferenceError("no process group: call initialize_multihost() first")
    _ENGINES += 1
    return Channel(_STORE, f"calfkit/engine/{_ENGINES}", rank, world)


# --------------------------------------------------------------------------- #
# the worker side
# --------------------------------------------------------------------------- #


def serve_worker(
    config: Any, runtime: Any, *, params: Any = None, seed: int = 0,
    device: "torch.device | str | None" = None, draft_params: Any = None, alive: Any = None,
) -> None:
    """Run this rank's part of rank 0's engine until it stops: build the
    engine's shard (from ``params``: full, already this rank's
    :class:`sharding.RankShard`, or a :class:`loader.Checkpoint`, which
    this rank reads through the shard tree; or random from ``seed``, as
    rank 0 builds it), then run every dispatch rank 0 describes.  Call it
    on every rank but 0, with what rank 0's engine was given.  It runs on
    this process's card unless ``device="cpu"``."""
    import torch.distributed as dist

    from calfkit_tpu_torch.inference.engine import InferenceEngine

    if not dist.is_initialized() or dist.get_rank() == 0:
        raise InferenceError("serve_worker runs on ranks 1..n-1 of an initialized group")
    if device is None:
        # no card: the engine raises, naming device="cpu"
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
            else "cuda"
    engine = InferenceEngine(
        config, runtime, params=params, seed=seed, device=device, draft_params=draft_params,
    )
    engine._serve_rank(alive)


def _spawned_worker(
    coordinator: str, world: int, rank: int, backend: str, parent: int, config: Any,
    runtime: Any, params: Any, seed: int, device: str, draft_params: Any,
) -> None:
    if device == "cpu":
        torch.set_num_threads(1)  # a CPU rank a process: don't crowd the host

    def alive() -> bool:
        return os.getppid() == parent

    init_group(coordinator, world, rank, backend=backend, alive=alive)
    try:
        serve_worker(
            config, runtime, params=params, seed=seed, device=device,
            draft_params=draft_params, alive=alive,
        )
    finally:
        shutdown_group()


class Workers:
    """The worker processes an engine spawned on its own host, and the
    process group it made for them (this process is its rank 0)."""

    LEAVE_S = 10.0  # the group's teardown's bound

    def __init__(self, procs: list):
        self.procs = procs

    def alive(self) -> bool:
        return all(proc.is_alive() for proc in self.procs)

    def close(self, timeout_s: float = 30.0) -> None:
        """Leave the group while the workers (told to stop) leave it, and
        join them: an NCCL rank's teardown waits for its peers', so rank 0
        must not wait for the workers to exit first.  A worker that does
        not exit in ``timeout_s`` is killed.  The teardown runs on a
        thread, ``LEAVE_S`` at most past the workers' end (a collective of
        a dead peer, or a communicator a graph still holds, can block it):
        one that does not end is a :class:`RankFault`, its thread left
        behind."""
        global _STORE
        store = _STORE  # hosts the workers' store until they are gone
        leaving = threading.Thread(target=shutdown_group, name="calfkit-leave-group",
                                   daemon=True)
        leaving.start()
        deadline = time.monotonic() + timeout_s
        for proc in self.procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in self.procs:
            if proc.is_alive():
                logger.warning("worker %s did not exit: killing it", proc.pid)
                proc.kill()
                proc.join(5.0)
        del store
        leaving.join(self.LEAVE_S)
        if leaving.is_alive():
            _STORE = None
            raise RankFault(
                f"the process group's teardown did not end within {self.LEAVE_S:.0f} s"
            )


def spawn_workers(
    world: int, config: Any, runtime: Any, shards: "list[Any]", seed: int, device: str,
    draft_shards: "list[Any]", backend: "str | None" = None,
) -> Workers:
    """Start ranks 1..world-1 of a new group on this host (``spawn``), and
    join this process to it as rank 0.  ``shards[r - 1]`` is rank r's
    params (its :class:`sharding.RankShard`, or ``None``: drawn from
    ``seed``)."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise InferenceError(
            "this process is already in a process group: build the engine on rank 0 of "
            "that group (initialize_multihost) instead"
        )
    if backend is None:
        backend = "nccl" if device.startswith("cuda") else "gloo"
    # this process hosts the group's store on a loopback port the system
    # picks: no port to clash, and what the channel deletes is freed
    store = dist.TCPStore("127.0.0.1", 0, world, True, timedelta(seconds=GROUP_TIMEOUT_S),
                          wait_for_workers=False)
    coordinator = f"127.0.0.1:{store.port}"
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for rank in range(1, world):
        proc = ctx.Process(
            target=_spawned_worker, name=f"calfkit-rank-{rank}", daemon=True,
            args=(coordinator, world, rank, backend, os.getpid(), config, runtime,
                  shards[rank - 1], seed, device if not device.startswith("cuda")
                  else f"cuda:{rank % max(torch.cuda.device_count(), 1)}",
                  draft_shards[rank - 1]),
        )
        proc.start()
        procs.append(proc)
    try:
        init_group(coordinator, world, 0, backend=backend, store=store,
                   alive=lambda: all(proc.is_alive() for proc in procs))
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.join(5.0)
        raise
    return Workers(procs)


def to_host(tree: Any) -> Any:
    """A params tree (a :class:`sharding.RankShard` too) with every tensor
    on the CPU, for a spawned rank's pickled arguments."""
    if isinstance(tree, dict):
        return type(tree)({k: to_host(v) for k, v in tree.items()})
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree
