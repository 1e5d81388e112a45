"""Streaming SLO tail metrics: bounded-memory quantiles and trackers.

Overload control (runtime/admission.py, runtime/online.py) needs
p50/p95/p99 of TTFT / TPOT / end-to-end latency over an unbounded
record stream without holding the stream.  Two estimators cover the
two uses:

* :class:`P2Quantile` — the Jain & Chlamtac P-squared algorithm: five
  markers, O(1) memory, piecewise-parabolic marker adjustment.  Below
  five observations it keeps the exact sorted buffer, so short windows
  are exact and the empty window is explicitly ``nan``.
* :func:`quantile` — exact linear-interpolation quantile on a concrete
  list, used for the small *recent* windows where exactness matters
  (guardrail decisions) and by tests as the reference.

:class:`SLOTracker` bundles per-metric estimators plus a bounded
recent window and renders the ``slo`` snapshot that lands in reports
and ``BENCH_allocation.json``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from math import nan, isnan

__all__ = ["quantile", "P2Quantile", "SLOConfig", "SLOTracker"]


def quantile(values, q: float) -> float:
    """Exact quantile with linear interpolation (numpy's default rule).

    Returns ``nan`` on an empty sequence instead of raising, because
    every caller is a streaming window that starts empty.
    """
    xs = sorted(values)
    if not xs:
        return nan
    if len(xs) == 1:
        return float(xs[0])
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


class P2Quantile:
    """Jain & Chlamtac's P-squared streaming quantile estimator.

    Five markers track (min, q/2, q, (1+q)/2, max); each observation
    shifts marker heights by a piecewise-parabolic rule (linear
    fallback when the parabola would cross a neighbour).  Memory is
    O(1) regardless of stream length.  With fewer than five
    observations the exact sorted buffer is the estimate, so short
    windows never extrapolate and ``value()`` on an empty stream is
    ``nan``.
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._heights: list[float] = []          # marker heights
        self._pos: list[int] = []                # actual marker positions
        self._desired: list[float] = []          # desired positions
        self._incr = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]
        self.count = 0

    def observe(self, x: float) -> None:
        self.count += 1
        h = self._heights
        if self.count <= 5:
            h.append(float(x))
            h.sort()
            if self.count == 5:
                self._pos = [0, 1, 2, 3, 4]
                self._desired = [4.0 * inc for inc in self._incr]
            return
        # locate the cell containing x, clamping the extreme markers
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1
        for i in range(5):
            self._desired[i] += self._incr[i]
        # adjust interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._desired[i] - self._pos[i]
            if (d >= 1.0 and self._pos[i + 1] - self._pos[i] > 1) or (
                    d <= -1.0 and self._pos[i - 1] - self._pos[i] < -1):
                step = 1 if d >= 1.0 else -1
                cand = self._parabolic(i, step)
                if h[i - 1] < cand < h[i + 1]:
                    h[i] = cand
                else:
                    h[i] = self._linear(i, step)
                self._pos[i] += step

    def _parabolic(self, i: int, d: int) -> float:
        h, n = self._heights, self._pos
        num = d / (n[i + 1] - n[i - 1])
        left = (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
        right = (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        return h[i] + num * (left + right)

    def _linear(self, i: int, d: int) -> float:
        h, n = self._heights, self._pos
        return h[i] + d * (h[i + d] - h[i]) / (n[i + d] - n[i])

    def value(self) -> float:
        """Current estimate; exact below 5 observations, nan when empty."""
        if self.count == 0:
            return nan
        if self.count < 5:
            return quantile(self._heights, self.q)
        return self._heights[2]


@dataclass(frozen=True)
class SLOConfig:
    """Service-level objective for the online guardrail.

    ``target_s`` bounds the ``metric`` (ttft | tpot | e2e) at
    ``quantile`` over the most recent ``window`` completed tasks.  The
    brownout ladder deepens when the recent quantile exceeds
    ``target_s * enter_ratio`` and restores a rung once it falls below
    ``target_s * exit_ratio`` — the hysteresis gap prevents rung
    flapping at the boundary.  No guardrail decision fires before
    ``min_window`` completions.
    """

    target_s: float
    metric: str = "e2e"
    quantile: float = 0.99
    window: int = 32
    min_window: int = 4
    enter_ratio: float = 1.0
    exit_ratio: float = 0.7

    def __post_init__(self):
        if self.metric not in ("ttft", "tpot", "e2e"):
            raise ValueError(f"unknown SLO metric {self.metric!r}")
        if self.target_s <= 0:
            raise ValueError("SLO target must be positive")
        if not 0.0 < self.exit_ratio <= self.enter_ratio:
            raise ValueError("need 0 < exit_ratio <= enter_ratio")


_QUANTS = (0.5, 0.95, 0.99)


@dataclass
class _MetricStream:
    estimators: dict = field(default_factory=lambda: {
        q: P2Quantile(q) for q in _QUANTS})
    count: int = 0
    total: float = 0.0
    peak: float = nan

    def observe(self, x: float) -> None:
        self.count += 1
        self.total += x
        self.peak = x if isnan(self.peak) else max(self.peak, x)
        for est in self.estimators.values():
            est.observe(x)

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else nan,
            "max": self.peak,
            **{f"p{int(q * 100)}": est.value()
               for q, est in self.estimators.items()},
        }


class SLOTracker:
    """Per-task latency metrics against an :class:`SLOConfig`.

    ``observe`` takes one completed task's (ttft, tpot, e2e) seconds;
    lifetime percentiles stream through P-squared while a bounded
    ``recent`` deque backs the exact guardrail quantile.
    """

    def __init__(self, config: SLOConfig):
        self.config = config
        self._streams = {m: _MetricStream() for m in ("ttft", "tpot", "e2e")}
        self._recent: deque[float] = deque(maxlen=config.window)
        self._n_ok = 0

    @property
    def count(self) -> int:
        return self._streams["e2e"].count

    def observe(self, ttft: float, tpot: float, e2e: float) -> None:
        vals = {"ttft": ttft, "tpot": tpot, "e2e": e2e}
        for m, x in vals.items():
            self._streams[m].observe(x)
        guarded = vals[self.config.metric]
        self._recent.append(guarded)
        if guarded <= self.config.target_s:
            self._n_ok += 1

    def recent_quantile(self) -> float | None:
        """Exact guardrail quantile over the recent window.

        ``None`` until ``min_window`` observations exist — callers must
        not act on an empty or barely-populated window.
        """
        if len(self._recent) < self.config.min_window:
            return None
        return quantile(self._recent, self.config.quantile)

    def attainment(self) -> float:
        """Lifetime fraction of guarded observations within target."""
        n = self.count
        return self._n_ok / n if n else nan

    def snapshot(self) -> dict:
        return {
            "target_s": self.config.target_s,
            "metric": self.config.metric,
            "quantile": self.config.quantile,
            "count": self.count,
            "attainment": self.attainment(),
            "metrics": {m: s.snapshot() for m, s in self._streams.items()},
        }
