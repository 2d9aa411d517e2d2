"""Compiled dispatch: each engine dispatch captured once per key as a CUDA
graph and replayed.

The counterpart of the JAX engine's jit caches (``_decode_jits`` and
``_prefill_jits``): where the reference traces a dispatch once per key and
replays the compiled program, the port captures the dispatch's body once
per key into a :class:`torch.cuda.CUDAGraph` and replays it, so a decode
dispatch of 32 layers x 32 steps is one launch from the host instead of
thousands of kernels enqueued from Python.

A :class:`CapturedDispatch` owns static input buffers; a call copies the
caller's arrays into them (non-blocking, from pinned host memory) and then:

- on the CPU, runs the body eagerly over those same buffers (the CPU tests
  run the exact code that is captured on the card);
- on a card, the first call runs the body eagerly on the engine's capture
  stream (that is the call's own work, and the warm-up a capture needs:
  kernel builds, ``cudaFuncSetAttribute``, cuBLAS workspaces and the
  attention tickets all happen there, outside any capture), then captures
  it into the engine's one shared memory pool; every later call copies
  its inputs and replays.

A body reads every other tensor it needs (weights, caches, engine state)
in place at a fixed address and writes engine state in place.  What it
returns is held by the graph and overwritten by its next replay, and its
intermediates share the pool with every other graph of the engine: a
caller copies an output (to the host, or into another dispatch's inputs)
before any other dispatch replays.  An output that must outlive other
replays is an engine-owned buffer the body writes with ``copy_``.

A capture or a replay that fails raises :class:`InferenceError`; nothing
falls back to eager execution.

A multi-rank engine (:mod:`.distributed`) sets two hooks on its pool: rank
0's ``mirror`` describes each dispatch to the other ranks before it runs
(by the dispatch's ``recipe``, the method and key that built it), and
``latest`` keeps every dispatch's newest outputs by recipe, where a later
dispatch's descriptor names its tensor inputs.  Every rank captures the
same keys; with NCCL its collectives are captured with the rest, while a
gloo collective met inside a capture raises (such an engine serves under
:func:`eager`).  :func:`eager` (the counterpart of
``jax.disable_jit``) runs every body eagerly on the card, with the same
kernels, while it is active: the tests and the chip smoke compare the two.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from calfkit_tpu_torch.exceptions import InferenceError
from calfkit_tpu_torch.inference import attention as A

# eager() nesting depth: process-wide, because the engine's dispatches run
# on worker threads (asyncio.to_thread), not on the thread that entered it
_eager_depth = 0
_eager_lock = threading.Lock()
# the replay hooks of the capture running on this thread (on_replay)
_capture = threading.local()
# one capture at a time in the process: entering a capture synchronizes the
# device and empties the allocator's cache, which CUDA refuses while another
# thread's capture is open (two engines in one process, each dispatching
# on its own worker thread, would otherwise break each other's captures)
_capture_lock = threading.Lock()


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """While active, every captured dispatch runs its body eagerly on the
    card (no capture, no replay; the same kernels and buffers)."""
    global _eager_depth
    with _eager_lock:
        _eager_depth += 1
    try:
        yield
    finally:
        with _eager_lock:
            _eager_depth -= 1


def eager_active() -> bool:
    return _eager_depth > 0


def on_replay(tag: Any, make: Callable[[], Callable[[int], None]]) -> bool:
    """Register a hook with the graph being captured on this thread: at the
    tag's first registration in the capture, ``make()`` builds the hook
    (inside the capture: any device work it does becomes part of the
    graph); after each replay, the hook is called with n, the number of
    times ``tag`` was registered during the capture.  → False, registering
    nothing, when no capture runs on this thread.  An observer of the
    wrappers' calls (a launch tally) counts replays through this, as the
    graph layer counts ``launch_counts``."""
    hooks = getattr(_capture, "hooks", None)
    if hooks is None:
        return False
    entry = hooks.get(tag)
    if entry is None:
        hooks[tag] = entry = [0, make()]
    entry[0] += 1
    return True


def fill(buf: torch.Tensor, value: "np.ndarray | torch.Tensor") -> None:
    """Copy ``value`` (a host array, or a tensor) into the static buffer
    ``buf`` of the same shape, in stream order: a host array goes through
    pinned memory, so the copy never waits for queued device work."""
    if tuple(value.shape) != tuple(buf.shape):
        raise ValueError(f"static input of shape {tuple(buf.shape)} got {tuple(value.shape)}")
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
        if buf.device.type == "cuda":
            value = value.pin_memory()
    buf.copy_(value, non_blocking=True)


class GraphPool:
    """One engine's graphs: the memory pool they share, the stream they are
    captured on, and their counts (``captures`` = first calls, each captured
    after its eager run; ``replays`` = later calls; ``eager`` = calls run
    eagerly on the card under :func:`eager`; ``capture_s`` = seconds spent
    in first calls)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.stats = dict(captures=0, replays=0, eager=0, capture_s=0.0)
        self.mirror: Any = None  # rank 0 of a multi-rank engine: a WeakMethod
        self.latest: "dict | None" = None  # a multi-rank engine's outputs by recipe


class CapturedDispatch:
    """A dispatch body over static inputs of the given (shape, dtype)
    ``specs``: called with one array or tensor per spec, it returns the
    body's outputs (see the module's docstring for their lifetime)."""

    def __init__(
        self, owner: GraphPool, body: Callable[..., Any],
        specs: "Sequence[tuple[tuple[int, ...], torch.dtype]]",
    ):
        self._owner = owner
        self._body = body
        # allocated here, outside any capture: never in the graph pool
        self.inputs = tuple(
            torch.zeros(shape, dtype=dtype, device=owner.device) for shape, dtype in specs
        )
        self._graph: "torch.cuda.CUDAGraph | None" = None
        self._outputs: Any = None
        self._launches: dict[str, int] = {}  # kernel launches of one replay
        self._hooks: dict[Any, list] = {}  # on_replay's, by tag
        self.calls = 0
        self.capture_s = 0.0  # its first call's seconds on a card (eager run + capture)
        self.recipe: Any = None  # how every rank builds this dispatch (multi-rank)

    @property
    def captured(self) -> bool:
        """Whether the body is captured (a card's first call outside
        :func:`eager`); every later call replays it."""
        return self._graph is not None

    def __call__(self, *args: "np.ndarray | torch.Tensor") -> Any:
        if len(args) != len(self.inputs):
            raise ValueError(f"dispatch takes {len(self.inputs)} inputs, got {len(args)}")
        owner = self._owner
        if owner.mirror is not None:
            owner.mirror()(self, args)
        out = self._call(args)
        if owner.latest is not None:
            owner.latest[self.recipe] = out
        return out

    def _call(self, args: tuple) -> Any:
        self.calls += 1
        for buf, value in zip(self.inputs, args):
            fill(buf, value)
        owner = self._owner
        if not owner.cuda:
            return self._body(*self.inputs)
        if eager_active():
            owner.stats["eager"] += 1
            return self._body(*self.inputs)
        if self._graph is None:
            return self._run_and_capture()
        try:
            self._graph.replay()
        except RuntimeError as exc:
            raise InferenceError(f"CUDA graph replay failed: {exc}") from exc
        for name, n in self._launches.items():
            A.add_launches(name, n)
        for n, fn in self._hooks.values():
            fn(n)
        owner.stats["replays"] += 1
        return self._outputs

    def _run_and_capture(self) -> Any:
        """The first call on a card: the body's eager run on the capture
        stream (this call's work), then its capture → the eager run's
        outputs."""
        owner = self._owner
        started = time.perf_counter()
        current = torch.cuda.current_stream(owner.device)
        owner.stream.wait_stream(current)  # after this call's input copies
        with torch.cuda.stream(owner.stream):
            out = self._body(*self.inputs)
        current.wait_stream(owner.stream)
        graph = torch.cuda.CUDAGraph()
        _capture.hooks = self._hooks
        # a capture launches nothing: its wrapper calls count at each replay
        A._capturing.counts = self._launches
        try:
            with _capture_lock, torch.cuda.graph(
                graph, pool=owner.pool, stream=owner.stream, capture_error_mode="thread_local"
            ):
                captured = self._body(*self.inputs)
        except RuntimeError as exc:
            raise InferenceError(f"CUDA graph capture failed: {exc}") from exc
        finally:
            _capture.hooks = None
            A._capturing.counts = None
        self._graph, self._outputs = graph, captured
        self.capture_s = time.perf_counter() - started
        owner.stats["captures"] += 1
        owner.stats["capture_s"] += self.capture_s
        return out
