"""Where the device's time goes between dispatches, on the device's clock.

Every engine dispatch goes through :class:`~.graphs.CapturedDispatch`,
which brackets it with two marks on the engine's stream: ``s`` before its
input fills, ``e`` after its replay (or its eager body).  A dispatch's
device time is ``s_N → e_N``; the device's idle before it, its *gap*, is
``e_{N-1} → s_N``.  Marks are read only after a host sync that the engine
makes anyway has passed them (:meth:`DispatchTimeline.sync`, called from
the engine's ``_sync_host``): the timeline adds no synchronisation.

The host's side of the same timeline is a log of phase stamps
(:data:`PHASES`) that tile the host's time while the engine holds work:

- ``schedule``: the engine's own pass on the event loop (checks, reaps,
  wave formation, activation);
- ``loop``: the hop to the dispatch thread and back, and everything the
  event loop runs meanwhile (token delivery, consumers, the traffic);
- ``prep``: on the dispatch thread, from a tick's start (or a dispatch's
  start) to its replay call: argument prep and the input fills;
- ``launch``: the replay call, and the staging of its outputs' host copies;
- ``land``: from a landing sync's call to the tick's end (the wait itself
  holds no gap but the sync's wake-up): fan-out, retirement, frees.

A dispatch that found the device idle has its ``s`` complete within µs of
its record, so its gap lies on the host's clock at ``[t(s) - gap, t(s)]``;
the gap's seconds go to the phases that interval overlaps.  A gap that
follows a host sync which left nothing queued behind it (a wave's landing,
a lockstep tick, a drain) is counted apart as drained: the device had run
out of work, rather than the host falling behind a device with work
queued.  Gaps across an idle boundary (:meth:`DispatchTimeline.idle`: the
engine held no work between two dispatches) are not gaps.

The marks come from a :class:`EventClock` on a card (timing events from a
reused pool) or a :class:`HostClock` on the CPU (the host wall of the
synchronous call); tests put a scripted clock behind the same seam.
"""

from __future__ import annotations

import ctypes
import time
from collections import deque
from typing import Any, Callable

import torch

from calfkit_tpu_torch.exceptions import InferenceError

PHASES = ("schedule", "loop", "prep", "launch", "land")
KINDS = ("decode", "mixed", "prefill")

# phase stamps kept while gaps that may reach back to them are unsettled:
# a bound for a pass that stamps without dispatching (a stalled queue)
_LOG_MAX = 4096


class HostClock:
    """Marks on the host's clock: on the CPU a dispatch runs synchronously,
    so its interval is the host wall of the call."""

    def record(self) -> float:
        return time.perf_counter()

    def seconds(self, a: float, b: float) -> float:
        return b - a

    def release(self, mark: Any) -> None:
        pass


def _cudart() -> Any:
    """The CUDA runtime library torch runs on, opened by its name (the
    process has it loaded already); its functions hold the interpreter's
    lock through each call."""
    name = f"libcudart.so.{(torch.version.cuda or '').split('.')[0]}"
    try:
        return ctypes.PyDLL(name)
    except OSError as exc:
        raise InferenceError(f"the dispatch timeline cannot open {name}: {exc}") from exc


class EventClock:
    """Marks on a card's stream: CUDA timing events, from a pool that marks
    return to once read, so a dispatch allocates none.  A mark is (event,
    its handle).  An event is made by its first record, through torch;
    later records and every read go through the CUDA runtime's library
    holding the interpreter's lock.  Torch's own calls release it, and the
    dispatch thread then waits for the event loop to hand it back: on an
    H100 under a busy loop, ~56 µs a record through torch against ~8."""

    def __init__(self, device: torch.device):
        self.device = device
        self._free: list = []
        self._rt = _cudart()
        self._index = ctypes.c_int(device.index or 0)
        self._stream: Any = None  # the engine's stream's handle
        self._ms = ctypes.c_float()

    def record(self) -> tuple:
        if not self._free:
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(self.device))
            return event, ctypes.c_void_p(event.cuda_event)
        mark = self._free.pop()
        if self._stream is None:
            self._stream = ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream)
        _check(self._rt.cudaSetDevice(self._index), "cudaSetDevice")
        _check(self._rt.cudaEventRecord(mark[1], self._stream), "cudaEventRecord")
        return mark

    def seconds(self, a: tuple, b: tuple) -> float:
        _check(self._rt.cudaEventElapsedTime(ctypes.byref(self._ms), a[1], b[1]),
               "cudaEventElapsedTime")
        return self._ms.value / 1e3

    def release(self, mark: tuple) -> None:
        self._free.append(mark)


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise InferenceError(f"{call} failed with CUDA error {rc}")


class DispatchTimeline:
    """One engine's dispatches on the device's clock and its host phases,
    summed into ``stats`` (an :class:`~.engine.EngineStats`):
    ``device_<kind>_s``, ``device_gap_s``, ``gap_<phase>_s`` and
    ``gap_drained_s``."""

    def __init__(self, clock: Any, stats: Any, now: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._stats = stats
        self._now = now
        self._seq = 0  # dispatches begun
        # begun, not yet settled: [seq, kind, s, e, t(s), counted, flagged,
        # drained]
        self._open: deque = deque()
        self._last_end: Any = None  # e of the newest settled dispatch
        self._idle = True  # an idle boundary since the newest dispatch began
        self._flag = False  # the next dispatch reports its gap (flagged)
        self._drained_at = -1  # the newest dispatch a sync left nothing behind
        self._log: deque = deque(maxlen=_LOG_MAX)  # (host time, phase)

    # ---------------------------------------------------------- host phases
    def phase(self, name: str) -> None:
        """From now on the host is in phase ``name``."""
        self._log.append((self._now(), name))

    def idle(self) -> None:
        """An idle boundary: the engine holds no work, so the device's idle
        up to the next dispatch is no gap."""
        self._idle = True

    def flag_next(self) -> None:
        """The next dispatch reports its gap at settlement (the engine's
        dispatch-gap histogram)."""
        self._flag = True

    # ----------------------------------------------------------- dispatches
    def begin(self) -> list:
        """Before a dispatch's input fills: its start mark → its record."""
        s = self.clock.record()
        t = self._now()
        drained = self._drained_at == self._seq
        self._seq += 1
        rec = [self._seq, None, s, None, t, not self._idle, self._flag, drained]
        self._idle = self._flag = False
        self._log.append((t, "prep"))
        return rec

    def end(self, rec: list, kind: str) -> None:
        """After the replay: the dispatch's end mark."""
        rec[1], rec[3] = kind, self.clock.record()
        self._open.append(rec)

    def mark(self) -> int:
        """The newest dispatch begun: what an event recorded now follows."""
        return self._seq

    # ----------------------------------------------------------- settlement
    def sync(self, upto: int) -> list:
        """A landing's host sync (begun in the ``land`` phase) has passed
        every dispatch up to ``upto``: their marks are read → the gaps, in
        seconds, of the flagged dispatches among them."""
        if upto >= self._seq:
            self._drained_at = upto
        return self._settle(upto)

    def drained(self) -> None:
        """A host sync outside the landings (the draft model's proposal)
        waited for every dispatch begun so far."""
        self._drained_at = self._seq

    def _settle(self, upto: int) -> list:
        stats, clock = self._stats, self.clock
        flagged = []
        while self._open and self._open[0][0] <= upto:
            _, kind, s, e, t, counted, flag, drained = self._open.popleft()
            attr = f"device_{kind}_s"
            setattr(stats, attr, getattr(stats, attr) + clock.seconds(s, e))
            prev = self._last_end
            if prev is not None:
                gap = max(0.0, clock.seconds(prev, s))
                if flag:
                    flagged.append(gap)
                if counted and gap > 0.0:
                    stats.device_gap_s += gap
                    if drained:
                        stats.gap_drained_s += gap
                    self._attribute(t - gap, t, gap)
                clock.release(prev)
            elif flag:
                flagged.append(0.0)
            clock.release(s)
            self._last_end = e
            self._prune(t)
        return flagged

    def _attribute(self, a: float, b: float, gap: float) -> None:
        """Add the gap's seconds to the host phases that [a, b] overlaps,
        walking the log back from its newest stamp; the part before the
        log's first stamp goes to that stamp's phase."""
        stats, log = self._stats, self._log
        if not log:
            stats.gap_schedule_s += gap
            return
        shares: dict = {}
        hi = b  # the overlap's end within the stamp walked next
        for t0, name in reversed(log):
            lo = a if t0 <= a else t0
            if hi > lo:
                shares[name] = shares.get(name, 0.0) + (hi - lo)
            if t0 <= a:
                break
            hi = min(hi, t0)
        else:
            name = log[0][1]
            shares[name] = shares.get(name, 0.0) + max(0.0, hi - a)
        # the shares sum to the gap exactly: the largest takes the rounding
        if not shares:
            shares[log[-1][1]] = 0.0
        top = max(shares, key=shares.get)
        shares[top] += gap - sum(shares.values())
        for name, seconds in shares.items():
            attr = f"gap_{name}_s"
            setattr(stats, attr, getattr(stats, attr) + seconds)

    def _prune(self, t: float) -> None:
        """Drop the stamps no later gap can reach: a later gap starts after
        this dispatch started, at ``t``; the stamp in force then stays."""
        log = self._log
        while len(log) > 1 and log[1][0] <= t:
            log.popleft()

    def reset(self) -> None:
        """Forget every unsettled dispatch (an engine stopped with one in
        flight): the next dispatch starts the timeline afresh."""
        self._open.clear()
        self._last_end = None
        self._idle = True
        self._flag = False
        self._drained_at = -1
        self._log.clear()
