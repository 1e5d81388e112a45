"""Prediction-accountability ledger: every prediction meets its outcome.

The paper's §5 claim — metric models predict makespan and accuracy
"generally within 10% of the run-time performance" — is only checkable
post-hoc in the bench JSON today. The ledger makes it a *live* metric:
each time the runtime acts on a solver prediction (per-record latency,
whole-run makespan, delivered accuracy CI) the instrumented paths call
:meth:`PredictionLedger.observe` with the matching measurement, keyed by
(platform, task family, round). Re-solves, degradation rungs and
brownout transitions simply keep observing under later round indices, so
the error stream spans the whole adaptive trajectory.

Relative error uses the same zero-measured convention as
``RuntimeReport.makespan_error``: ``inf`` when the measured value is
zero (e.g. an all-shed open-loop round), never a ``ZeroDivisionError``.
Infinite errors are tallied separately (they would poison the P² marker
state) and count against the within-tolerance fraction.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque

from repro_torch.core.slo import P2Quantile

__all__ = ["LedgerEntry", "PredictionLedger", "relative_error"]


def relative_error(predicted: float, measured: float) -> float:
    """|predicted - measured| / |measured|; ``inf`` when measured == 0
    and predicted != 0; 0.0 when both are zero."""
    if measured == 0.0:
        return 0.0 if predicted == 0.0 else math.inf
    return abs(predicted - measured) / abs(measured)


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    """One prediction paired with its measured outcome."""
    phase: str        # "latency" | "makespan" | "accuracy"
    platform: str
    family: str       # task launch-key family ("-" when not applicable)
    round: int        # online round index; -1 for whole-run entries
    predicted: float
    measured: float

    @property
    def error(self) -> float:
        return relative_error(self.predicted, self.measured)


class _ErrorStream:
    """Streaming error stats for one (phase[, platform]) bucket."""

    QS = (0.5, 0.9, 0.99)
    #: flush the pending buffer into the P2 markers at this size even
    #: without a query, bounding memory on very long runs.
    FLUSH_AT = 4096

    def __init__(self, tol: float, qs: tuple = QS):
        self.tol = tol
        self.count = 0
        self.inf_count = 0
        self.within_count = 0
        self.max_error = 0.0
        self._q = {q: P2Quantile(q) for q in qs}
        #: errors not yet folded into the P2 markers. observe() sits on
        #: the per-record hot path of instrumented runs, so it only bumps
        #: counters and appends here; the marker updates are amortised
        #: into the (rare) quantile queries.
        self._pending: list[float] = []

    def observe(self, err: float) -> None:
        self.count += 1
        if not math.isfinite(err):
            self.inf_count += 1
            return
        if err <= self.tol:
            self.within_count += 1
        if err > self.max_error:
            self.max_error = err
        self._pending.append(err)
        if len(self._pending) >= self.FLUSH_AT:
            self._flush()

    def _flush(self) -> None:
        if self._pending:
            for est in self._q.values():
                for err in self._pending:
                    est.observe(err)
            self._pending.clear()

    def quantiles(self) -> dict:
        self._flush()
        out = {}
        for q, est in self._q.items():
            v = est.value()
            out[f"p{int(q * 100)}"] = float(v) if math.isfinite(v) else None
        return out

    def summary(self) -> dict:
        return {"count": self.count, "inf_errors": self.inf_count,
                f"within_{int(self.tol * 100)}pct":
                    (self.within_count / self.count) if self.count else None,
                "max_error": self.max_error if self.count > self.inf_count
                    else None,
                **self.quantiles()}


class PredictionLedger:
    """Thread-safe ledger of prediction-vs-measurement pairs.

    Keeps the most recent ``max_entries`` raw entries (for reports and
    JSONL export) plus O(1)-memory streaming error stats per phase and
    per (phase, platform) — the live within-10% view.
    """

    def __init__(self, tol: float = 0.1, max_entries: int = 50_000):
        self.tol = tol
        self._lock = threading.Lock()
        self._entries: deque[LedgerEntry] = deque(maxlen=max_entries)
        self._phases: dict[str, _ErrorStream] = {}
        self._plat: dict[tuple[str, str], _ErrorStream] = {}

    def observe(self, phase: str, platform: str, family: str,
                round_idx: int, predicted: float,
                measured: float) -> LedgerEntry:
        entry = LedgerEntry(phase, platform, family, int(round_idx),
                            float(predicted), float(measured))
        err = entry.error
        with self._lock:
            self._entries.append(entry)
            st = self._phases.get(phase)
            if st is None:
                st = self._phases[phase] = _ErrorStream(self.tol)
            st.observe(err)
            key = (phase, platform)
            pst = self._plat.get(key)
            if pst is None:
                # per-platform buckets only ever report p50 + within, so
                # they carry one P2 marker set — observe() sits on the
                # per-record hot path of instrumented runs
                pst = self._plat[key] = _ErrorStream(self.tol, qs=(0.5,))
            pst.observe(err)
        return entry

    # -- queries -----------------------------------------------------------

    def entries(self, phase: str | None = None) -> list[LedgerEntry]:
        with self._lock:
            es = list(self._entries)
        return es if phase is None else [e for e in es if e.phase == phase]

    @property
    def count(self) -> int:
        return sum(st.count for st in self._phases.values())

    def error_quantiles(self, phase: str) -> dict:
        """{"p50": ..., "p90": ..., "p99": ...} for one phase (None when
        the phase has no finite errors yet)."""
        with self._lock:
            st = self._phases.get(phase)
            return st.quantiles() if st is not None else \
                {"p50": None, "p90": None, "p99": None}

    def within(self, phase: str, tol: float | None = None) -> float:
        """Fraction of ``phase`` entries with error <= tol (infinite
        errors count as misses). NaN when the phase is empty."""
        tol = self.tol if tol is None else tol
        es = self.entries(phase)
        if not es:
            return math.nan
        hits = sum(1 for e in es
                   if math.isfinite(e.error) and e.error <= tol)
        return hits / len(es)

    def summary(self) -> dict:
        """Per-phase streaming error summary (the live §5 scoreboard)."""
        with self._lock:
            return {phase: st.summary()
                    for phase, st in sorted(self._phases.items())}

    def platform_summary(self, phase: str) -> dict:
        with self._lock:
            return {plat: st.summary()
                    for (ph, plat), st in sorted(self._plat.items())
                    if ph == phase}

    # -- rendering ---------------------------------------------------------

    def render(self) -> str:
        """Text scoreboard for ``examples/trace_report.py``."""
        lines = ["prediction ledger (predicted vs measured, relative "
                 f"error, tol {self.tol:.0%})"]
        summ = self.summary()
        if not summ:
            return lines[0] + "\n  (empty)"
        wkey = f"within_{int(self.tol * 100)}pct"
        lines.append(f"  {'phase':<10s} {'n':>6s} {'p50':>8s} {'p90':>8s} "
                     f"{'p99':>8s} {'within':>7s} {'inf':>4s}")
        for phase, st in summ.items():
            lines.append(
                f"  {phase:<10s} {st['count']:>6d}"
                f" {_pct(st['p50']):>8s} {_pct(st['p90']):>8s}"
                f" {_pct(st['p99']):>8s} {_pct(st[wkey]):>7s}"
                f" {st['inf_errors']:>4d}")
        plat = self.platform_summary("latency")
        if plat:
            lines.append("  latency by platform:")
            for name, st in plat.items():
                lines.append(f"    {name:<22s} n={st['count']:<5d} "
                             f"p50 {_pct(st['p50'])}  "
                             f"within {_pct(st[wkey])}")
        return "\n".join(lines)


def _pct(v) -> str:
    return "-" if v is None else f"{v:.1%}"
