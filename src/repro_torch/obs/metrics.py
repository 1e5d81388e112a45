"""Process-wide metrics registry: counters, gauges, P²-backed histograms.

Complements span tracing (:mod:`repro_torch.obs.trace`) with the aggregate
view: counts of records/faults/retries/sheds, gauges for brownout rung
and backlog, and latency/solve-time histograms whose quantiles come from
the same streaming P² estimators the SLO tracker uses
(:class:`repro_torch.core.slo.P2Quantile` — O(1) memory, no sample buffers).

Snapshots serialise through the existing JSONL record stream:
:class:`MetricSnapshot` is registered with :mod:`repro_torch.runtime.records`,
so ``dump_records(path, registry.snapshot())`` round-trips like any
fault/record stream. The discriminator field is ``metric`` (``counter`` /
``gauge`` / ``histogram``) — ``kind`` is reserved by the record codec.
"""
from __future__ import annotations

import dataclasses
import math
import threading

from repro_torch.core.slo import P2Quantile

__all__ = ["Counter", "Gauge", "Histogram", "MetricSnapshot",
           "MetricsRegistry", "REGISTRY", "counter", "gauge", "histogram"]


def _finite(x: float) -> float | None:
    """JSON-safe: non-finite stats become None rather than NaN tokens."""
    return float(x) if isinstance(x, (int, float)) and math.isfinite(x) \
        else None


@dataclasses.dataclass(frozen=True)
class MetricSnapshot:
    """One metric's state at a point in time, JSONL-persistable."""
    name: str
    metric: str          # "counter" | "gauge" | "histogram"
    value: float         # count / gauge level / observation count
    at: float = 0.0      # caller-supplied timestamp (seconds)
    stats: dict = dataclasses.field(default_factory=dict)


class Counter:
    """Monotone event count."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self, at: float = 0.0) -> MetricSnapshot:
        return MetricSnapshot(self.name, "counter", self._value, at)


class Gauge:
    """Last-write-wins level (brownout rung, backlog seconds, ...)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += dv

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self, at: float = 0.0) -> MetricSnapshot:
        return MetricSnapshot(self.name, "gauge", self._value, at)


class Histogram:
    """Streaming distribution: count/mean/min/max plus P² p50/p95/p99."""

    QS = (0.5, 0.95, 0.99)

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._q = {q: P2Quantile(q) for q in self.QS}
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            return
        with self._lock:
            self._count += 1
            self._sum += x
            self._min = min(self._min, x)
            self._max = max(self._max, x)
            for est in self._q.values():
                est.observe(x)

    @property
    def count(self) -> int:
        return self._count

    def stats(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            out = {"count": self._count,
                   "mean": _finite(self._sum / self._count),
                   "min": _finite(self._min), "max": _finite(self._max)}
            for q, est in self._q.items():
                out[f"p{int(q * 100)}"] = _finite(est.value())
            return out

    def snapshot(self, at: float = 0.0) -> MetricSnapshot:
        return MetricSnapshot(self.name, "histogram", float(self._count),
                              at, self.stats())


class MetricsRegistry:
    """Get-or-create registry; one instance (:data:`REGISTRY`) serves the
    whole process, mirroring how production metric libraries work."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, kind: str, name: str):
        cls = self._TYPES[kind]
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name)

    def histogram(self, name: str) -> Histogram:
        return self._get("histogram", name)

    def snapshot(self, at: float = 0.0) -> list[MetricSnapshot]:
        """Every metric's current state, ready for ``dump_records``."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return [m.snapshot(at) for m in metrics]

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: the process-wide registry used by the instrumented runtime.
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)
