"""Dependency-free metrics: counters, gauges, fixed-bucket histograms.

The port's own copy of ``calfkit_tpu.observability.metrics`` (same names,
same behaviour, same text).  Every instrument is stdlib-only,
``observe()`` is an O(1) bucket increment under one small lock, and
rendering is Prometheus **text exposition format v0**, so any scraper (or
``curl``) reads it; no ``prometheus_client`` is needed.  Instruments are
get-or-create by name from a registry, so repeated engine construction
shares one instrument per metric instead of colliding.

Failure policy: recording must never fault serving.  ``inc`` / ``set`` /
``observe`` swallow bad values instead of raising; only *registration*
(a programming error: same name, different type) is loud.

Windowing: histograms and counters expose :meth:`snapshot_and_delta` for
periodic consumers that want per-interval rates.  The delta state is
per-instrument and single-consumer by design.
"""

from __future__ import annotations

import bisect
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "metrics_text",
]

# latency buckets in milliseconds: sub-ms queue waits through multi-second
# long-context prefills, ~2.5x spacing (13 buckets + +Inf)
DEFAULT_LATENCY_BUCKETS_MS: tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)

# inter-token latency needs finer low-end resolution (the north-star rate
# is hundreds of microseconds per token)
INTER_TOKEN_BUCKETS_MS: tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0,
)


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = _sanitize(name)
        self.help = help
        self._registry = registry
        self._lock = threading.Lock()

    @property
    def _on(self) -> bool:
        return self._registry.enabled

    def render(self) -> str:
        raise NotImplementedError

    def _head(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n"
            f"# TYPE {self.name} {self.kind}\n"
        )


def _fmt(v: float) -> str:
    """Render a sample value: integers without the trailing ``.0``."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        super().__init__(name, help, registry)
        self._value = 0.0
        self._window = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._on:
            return
        try:
            if n < 0:
                return  # counters are monotonic; a negative inc is a bug upstream
            with self._lock:
                self._value += n
        except TypeError:
            return  # non-numeric: recording never raises

    @property
    def value(self) -> float:
        return self._value

    def snapshot_and_delta(self) -> tuple[float, float]:
        """(cumulative, delta-since-last-call)."""
        with self._lock:
            cur = self._value
            delta = cur - self._window
            self._window = cur
        return cur, delta

    def render(self) -> str:
        return f"{self._head()}{self.name} {_fmt(self._value)}\n"


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        super().__init__(name, help, registry)
        self._value = 0.0
        self._fn: "object | None" = None

    def set(self, v: float) -> None:
        if not self._on:
            return
        try:
            self._value = float(v)
        except (TypeError, ValueError):
            return

    def set_fn(self, fn: "object | None") -> None:
        """Computed gauge: ``value``/``render`` call ``fn()`` at SCRAPE
        time instead of reporting the last ``set()``.  This is for
        staleness-style signals ("seconds since the last heartbeat
        publish") where a value written at event time is always 0 and the
        interesting number only exists when somebody reads it.  ``fn``
        must be cheap and never block; errors fall back to the last
        ``set()`` value.  Pass None to clear."""
        self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())  # type: ignore[operator]
            except Exception:  # noqa: BLE001 - a broken fn reads as the last set
                pass
        return self._value

    def render(self) -> str:
        return f"{self._head()}{self.name} {_fmt(self.value)}\n"


class Histogram(_Instrument):
    """Fixed-bucket histogram: ``observe`` is one ``bisect`` + three adds
    under the lock — O(log buckets), constant-size state, no per-sample
    allocation (the hot-path contract)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        registry: "MetricsRegistry",
        buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_MS,
    ):
        super().__init__(name, help, registry)
        self.buckets: tuple[float, ...] = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._window = (list(self._counts), 0.0, 0)

    def observe(self, v: float) -> None:
        if not self._on:
            return
        try:
            i = bisect.bisect_left(self.buckets, v)
            with self._lock:
                self._counts[i] += 1
                self._sum += v
                self._count += 1
        except TypeError:
            return

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Approximate quantile from the bucket distribution: the upper
        bound of the bucket holding the q-th sample (the standard
        bucketed-histogram estimate; exact enough for dashboards)."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if not total:
            return 0.0
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                if i < len(self.buckets):
                    return self.buckets[i]
                return self.buckets[-1] if self.buckets else 0.0
        return self.buckets[-1] if self.buckets else 0.0

    def snapshot_and_delta(self) -> tuple[dict, dict]:
        """(cumulative, delta-since-last-call) — each a dict with
        ``count``, ``sum``, and per-bucket ``counts``."""
        with self._lock:
            cur_counts = list(self._counts)
            cur = {"count": self._count, "sum": self._sum, "counts": cur_counts}
            prev_counts, prev_sum, prev_count = self._window
            delta = {
                "count": self._count - prev_count,
                "sum": self._sum - prev_sum,
                "counts": [a - b for a, b in zip(cur_counts, prev_counts)],
            }
            self._window = (cur_counts, self._sum, self._count)
        return cur, delta

    def render(self) -> str:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        lines = [self._head()]
        cumulative = 0
        for bound, c in zip(self.buckets, counts):
            cumulative += c
            lines.append(
                f'{self.name}_bucket{{le="{_fmt(bound)}"}} {cumulative}\n'
            )
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {total}\n')
        lines.append(f"{self.name}_sum {_fmt(round(s, 6))}\n")
        lines.append(f"{self.name}_count {total}\n")
        return "".join(lines)


class MetricsRegistry:
    """Get-or-create instrument registry; same name must keep one type."""

    def __init__(self) -> None:
        self._instruments: dict[str, _Instrument] = {}
        self._lock = threading.Lock()
        self.enabled = True

    def set_enabled(self, on: bool) -> None:
        """Global kill switch (the overhead bench's tracing-off mode):
        recording becomes a single attribute check + return."""
        self.enabled = bool(on)

    def _get(self, cls: type, name: str, help: str, **kwargs) -> _Instrument:
        key = _sanitize(name)
        with self._lock:
            existing = self._instruments.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {key!r} already registered as "
                        f"{type(existing).__name__}, not {cls.__name__}"
                    )
                return existing
            inst = cls(name, help, self, **kwargs)
            self._instruments[key] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        inst = self._get(Counter, name, help)
        assert isinstance(inst, Counter)
        return inst

    def gauge(self, name: str, help: str = "") -> Gauge:
        inst = self._get(Gauge, name, help)
        assert isinstance(inst, Gauge)
        return inst

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_MS,
    ) -> Histogram:
        inst = self._get(Histogram, name, help, buckets=buckets)
        assert isinstance(inst, Histogram)
        return inst

    def render(self) -> str:
        """Prometheus text exposition v0 for every registered instrument."""
        with self._lock:
            instruments = sorted(
                self._instruments.values(), key=lambda i: i.name
            )
        return "".join(i.render() for i in instruments)


# the process default: engine + dispatcher instruments live here unless a
# caller wires its own registry
REGISTRY = MetricsRegistry()


def metrics_text(registry: MetricsRegistry | None = None) -> str:
    """The one public render entrypoint (and what the HTTP endpoint
    serves): Prometheus text exposition v0 of ``registry`` (default: the
    process registry)."""
    return (registry or REGISTRY).render()
