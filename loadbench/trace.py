"""The reduction of one traced slice of the window (``torch.profiler`` with
CPU and CUDA activities) to what the per-layer readers and the result's
``breakdown`` read: every device operation as (name, start, end), the host
operations, the slice's host-clock length, and the device's busy time, the
length of the union of the device operations' intervals (the arithmetic of
``scripts/torch_profile_serving.py``'s ``busy_us``, copied)."""

from __future__ import annotations

from dataclasses import dataclass


def busy_us(intervals: "list[tuple[float, float]]") -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps_us(intervals: "list[tuple[float, float]]") -> "list[tuple[float, float]]":
    """The holes between the union's pieces, as (start, end)."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


@dataclass
class Slice:
    """One traced slice: device operations and host operations on the
    profiler's clock (microseconds), and the slice's bounds on the host's
    clock (``time.perf_counter`` seconds), by which the readers pick the
    requests and tokens that fell inside it."""

    device_ops: "list[tuple[str, float, float]]"
    host_ops: "list[tuple[str, float, float]]"
    host_start: float
    host_end: float

    @property
    def window_s(self) -> float:
        return self.host_end - self.host_start

    @property
    def busy_s(self) -> float:
        return busy_us([(s, e) for _, s, e in self.device_ops]) / 1e6

    def seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match(name)`` is true."""
        return sum(e - s for name, s, e in self.device_ops if match(name)) / 1e6

    def top_ops(self, n: int = 10) -> "list[list]":
        """The ``n`` device operations (by name) that took most time."""
        by_name: dict[str, float] = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], t / 1e6] for name, t in top]

    def idle_gaps(self, n: int = 10) -> "list[list]":
        """The ``n`` longest idle gaps of the device, each named by the host
        operation that overlapped it most (what the host was doing)."""
        holes = sorted(gaps_us([(s, e) for _, s, e in self.device_ops]), key=lambda g: g[0] - g[1])
        host = sorted(self.host_ops, key=lambda op: op[1])
        out = []
        for start, end in holes[:n]:
            best, name = 0.0, "host: no traced operation"
            for op, s, e in host:
                if s >= end:
                    break
                overlap = min(e, end) - max(s, start)
                if overlap > best:
                    best, name = overlap, f"host: {op}"[:120]
            out.append([name, (end - start) / 1e6])
        return out


def reduce(prof, host_start: float, host_end: float) -> Slice:
    """A :class:`Slice` from a stopped ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        (device if e.device_type == cuda else host).append(span)
    return Slice(device, host, host_start, host_end)
