"""What a per-layer reader (``metrics/<name>.py``, or ``metrics/<stem>.py``
shared by every metric of one stem) reads: the run's records, the engine's
counter deltas over the window, the traced slice (which runs before the
window, so that the window runs untraced), the configuration, and the
work counts of :mod:`loadbench.work`.  A reader is ``read(r: Readings) -> float | None``;
None means it found nothing to read, and the metric is left out.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from loadbench import work


@dataclass
class Readings:
    arch: dict
    runtime: dict  # the deployment's RuntimeConfig fields
    device_name: str
    records: list
    window: "tuple[float, float]"  # host clock
    counters: dict  # the engine's counter deltas over the window
    captures: "int | None"  # CUDA graph captures inside the window
    trace: object = None  # loadbench.trace.Slice
    _cached: "dict | None" = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def peaks(self) -> "dict | None":
        return work.peaks(self.device_name)

    def in_window(self) -> list:
        """The requests due inside the window."""
        lo, hi = self.window
        return [r for r in self.records if lo <= r.due < hi]

    def cached(self, record) -> int:
        """Positions of the record's prompt an earlier prompt held."""
        if self._cached is None:
            self._cached = work.cached_prefixes(self.records, self.runtime["page_size"])
        return self._cached[id(record)]

    def step_s(self, lo: float, hi: float) -> "float | None":
        """Seconds per decode step in [lo, hi) on the host clock: the mean
        gap before each token after a request's first that came then.  A
        decode step gives every active row one token, and a dispatch of
        ``s`` steps lands its rows' ``s`` tokens at once after ``s`` steps'
        time, so the gaps of a row's tokens sum to the time it decoded,
        whatever the steps of each dispatch."""
        total, n = 0.0, 0
        for r in self.records:
            for j in range(1, len(r.times)):
                if lo <= r.times[j] < hi:
                    total += r.times[j] - r.times[j - 1]
                    n += 1
        return total / n if n else None

    def flops(self, lo: float, hi: float) -> int:
        """Model operations of the work done in [lo, hi) on the host clock:
        the uncached prompt positions of every request whose first token
        came then, and every later token that came then."""
        total = 0
        for r in self.records:
            for j, t in enumerate(r.times):
                if not lo <= t < hi:
                    continue
                if j == 0:
                    total += work.prefill_flops(self.arch, self.cached(r), len(r.prompt))
                else:
                    total += work.decode_flops(self.arch, len(r.prompt) + j)
        return total
