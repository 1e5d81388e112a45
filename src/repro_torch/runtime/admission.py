"""Bounded admission control: backpressure, load shedding, brownout events.

The online loop (PR 4) admits every scenario arrival unconditionally,
which is correct for finite closed workloads but catastrophic under
sustained open-loop load: when offered load exceeds fleet capacity the
pending queue — and with it every latency percentile — grows without
bound.  The only robust saturation behaviours are *bounded* queues,
*backpressure* (admit less when utilisation is high), and *shedding*
(reject excess with a typed, logged outcome the client can see).

:class:`AdmissionController` implements all three as pure round-barrier
arithmetic: the queue bound derives from predicted per-platform service
rates and remaining KV capacity, the backpressure signal is an EWMA of
fleet utilisation, and every rejected task becomes a :class:`ShedEvent`
that persists through :mod:`repro_torch.runtime.records` JSONL like any other
execution record.  No wall clocks, no randomness — identical seeds
reproduce identical shed streams in concurrent and sequential modes.

:class:`BrownoutTransition` lives here too: the SLO guardrail in
:mod:`repro_torch.runtime.online` walks the PR 6 ``degrade_quality`` rungs
when the recent tail quantile breaches the SLO and restores quality
when pressure clears; each rung move is one typed, persistable event.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections import deque
from typing import Any

__all__ = ["ShedEvent", "RejectedTask", "BrownoutTransition",
           "AdmissionConfig", "AdmissionController", "predicted_unit_rates"]


@dataclasses.dataclass(frozen=True)
class ShedEvent:
    """One task rejected by admission control (persisted via records.py).

    ``reason`` is one of ``"queue-full"`` (bounded queue at its computed
    limit), ``"capacity"`` (no alive platform can ever hold the task's
    KV footprint), or ``"timeout"`` (queued longer than the configured
    max wait — the client would have given up).
    """

    task_id: int
    t: float
    reason: str
    queue_depth: int
    utilisation: float
    round: int = -1


@dataclasses.dataclass(frozen=True)
class RejectedTask:
    """A shed task paired with its event — what ``offer`` hands back."""

    task: Any
    event: ShedEvent


@dataclasses.dataclass(frozen=True)
class BrownoutTransition:
    """One rung move of the SLO brownout ladder (persisted via records.py).

    ``direction`` is ``"deepen"`` (tail breached the SLO, quality drops
    one rung) or ``"restore"`` (pressure cleared, quality returns one
    rung).  ``observed`` is the recent guardrail quantile that triggered
    the move, against ``target_s``.
    """

    round: int
    at: float
    rung_from: int
    rung_to: int
    direction: str
    observed: float
    target_s: float


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Tuning for :class:`AdmissionController`.

    ``queue_s`` is the backlog budget in *seconds of predicted fleet
    work*: both the queue-depth bound (how many tasks may wait) and the
    per-round admission budget derive from it.  ``max_queue`` optionally
    caps the computed depth bound.  When EWMA utilisation exceeds
    ``util_high`` the admission budget shrinks by
    ``backpressure_factor`` — backpressure engages *before* the queue
    overflows.  ``max_wait_s`` sheds tasks that have queued longer than
    a client would plausibly wait (None disables timeout shedding).
    """

    queue_s: float = 2.0
    max_queue: int | None = None
    util_high: float = 0.9
    ewma_alpha: float = 0.4
    backpressure_factor: float = 0.5
    max_wait_s: float | None = None

    def __post_init__(self):
        if self.queue_s <= 0:
            raise ValueError("queue_s must be positive")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if not 0.0 < self.backpressure_factor <= 1.0:
            raise ValueError("backpressure_factor must be in (0, 1]")


def predicted_unit_rates(models: dict, alive=None,
                         typical_units: float = 8.0) -> dict[str, float]:
    """Predicted work-units/second per platform from fitted latency models.

    Eq. 7 prices a ``typical_units``-sized dispatch at
    ``beta * units + gamma`` seconds, so the sustained service rate is
    ``units / (median(beta) * units + median(gamma))`` — the gamma term
    matters: an RTT-dominated platform (tiny beta, large constant) has a
    *finite* dispatch rate, and a pure ``1/beta`` estimate would credit
    it near-infinite headroom.  Medians over the platform's fitted task
    models keep the estimate robust to one weird family.  Placeholder
    models for unreachable pairs carry 1e9-scale sentinels and are
    excluded; platforms with no usable model get rate 0 (they cannot
    serve, so they add no queue headroom).
    """
    per: dict[str, tuple[list[float], list[float]]] = {}
    for (pname, _tid), model in models.items():
        if alive is not None and pname not in alive:
            continue
        beta = float(model.latency.beta)
        gamma = float(model.latency.gamma)
        if 0.0 <= beta < 1e8 and 0.0 <= gamma < 1e8 and beta + gamma > 0:
            betas, gammas = per.setdefault(pname, ([], []))
            betas.append(beta)
            gammas.append(gamma)
    u = max(typical_units, 1e-9)
    out: dict[str, float] = {}
    for pname, (betas, gammas) in per.items():
        cost = statistics.median(betas) * u + statistics.median(gammas)
        out[pname] = u / max(cost, 1e-12)
    if alive is not None:
        for pname in alive:
            out.setdefault(pname, 0.0)
    return out


class AdmissionController:
    """Bounded queue + EWMA backpressure between a trace and the scheduler.

    Lifecycle per online round (all quantities round-barrier, so
    executor modes agree bitwise):

    1. ``update_fleet`` — recompute the queue bound from predicted
       service rates and remaining per-platform capacity.
    2. ``observe_utilisation`` — fold this round's busy fraction into
       the EWMA backpressure signal.
    3. ``offer`` each new arrival — queue it, or shed it with a typed
       reason when the queue is at bound / the task can never fit.
    4. ``admit`` — release queued tasks (FIFO) while the scheduler's
       backlog stays inside the (possibly backpressured) budget, and
       time out tasks that waited too long.
    """

    def __init__(self, config: AdmissionConfig | None = None, tracer=None):
        self.config = config or AdmissionConfig()
        #: optional repro_torch.obs.Tracer; every shed becomes an instant event
        #: on the admission track
        self.tracer = tracer
        self.pending: deque[tuple[float, Any, float]] = deque()
        self.util = 0.0
        self.n_offered = 0
        self.n_admitted = 0
        self.n_shed = 0
        self._queue_limit = 1
        self._fleet_rate = 0.0

    # -- round-barrier signal updates --------------------------------------

    def update_fleet(self, unit_rates: dict[str, float],
                     capacity_rem: dict[str, float],
                     task_units: float, task_resource: float) -> None:
        """Size the queue bound from service rate and remaining capacity.

        Per platform the headroom is the *smaller* of (a) how many
        typical tasks it can serve inside the ``queue_s`` budget at its
        predicted rate and (b) how many typical KV footprints still fit
        in its remaining capacity; the fleet bound is the sum.  A fleet
        that is both fast and full sheds; one that is slow but empty
        sheds too — capacity and rate are separate ceilings.
        """
        cfg = self.config
        task_units = max(task_units, 1e-9)
        total = 0.0
        for pname, rate in unit_rates.items():
            by_rate = rate * cfg.queue_s / task_units
            cap = capacity_rem.get(pname)
            if cap is not None and task_resource > 0:
                by_cap = max(cap, 0.0) / task_resource
                total += max(min(by_rate, by_cap), 0.0)
            else:
                total += max(by_rate, 0.0)
        limit = max(int(total), 1)
        if cfg.max_queue is not None:
            limit = min(limit, cfg.max_queue)
        self._queue_limit = limit
        self._fleet_rate = sum(max(r, 0.0) for r in unit_rates.values())

    def observe_utilisation(self, busy_s: float, span_s: float,
                            n_platforms: int) -> None:
        """Fold one round's busy fraction into the EWMA signal."""
        denom = span_s * max(n_platforms, 1)
        sample = min(busy_s / denom, 1.0) if denom > 1e-12 else 0.0
        a = self.config.ewma_alpha
        self.util = a * sample + (1.0 - a) * self.util

    # -- admission decisions -----------------------------------------------

    @property
    def queue_limit(self) -> int:
        return self._queue_limit

    @property
    def fleet_rate(self) -> float:
        return self._fleet_rate

    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    def cost_s(self, units: float) -> float:
        """Predicted fleet-seconds to serve ``units`` of work."""
        return units / self._fleet_rate if self._fleet_rate > 0 else 0.0

    def offer(self, task: Any, t: float, round_idx: int, *,
              cost_s: float, fits: bool) -> RejectedTask | None:
        """Offer one arrival; returns a :class:`RejectedTask` when shed,
        None when queued."""
        self.n_offered += 1
        if not fits:
            return self._shed(task, t, "capacity", round_idx)
        if len(self.pending) >= self._queue_limit:
            return self._shed(task, t, "queue-full", round_idx)
        self.pending.append((t, task, cost_s))
        return None

    def admit(self, now: float, round_idx: int,
              backlog_s: float) -> tuple[list[tuple[float, Any]],
                                         list[RejectedTask]]:
        """Release queued tasks while backlog stays inside the budget.

        ``backlog_s`` is the scheduler's currently-planned work in
        predicted fleet-seconds; each admitted task adds its own cost.
        Under high utilisation the budget shrinks by
        ``backpressure_factor`` so the queue drains before refilling.
        Tasks older than ``max_wait_s`` shed with reason ``timeout``.
        """
        cfg = self.config
        timed_out: list[RejectedTask] = []
        if cfg.max_wait_s is not None:
            keep: deque[tuple[float, Any, float]] = deque()
            for arr_t, task, cost in self.pending:
                if now - arr_t > cfg.max_wait_s:
                    timed_out.append(
                        self._shed(task, arr_t, "timeout", round_idx))
                else:
                    keep.append((arr_t, task, cost))
            self.pending = keep
        budget = cfg.queue_s
        if self.util > cfg.util_high:
            budget *= cfg.backpressure_factor
        admitted: list[tuple[float, Any]] = []
        while self.pending and backlog_s < budget:
            arr_t, task, cost = self.pending.popleft()
            admitted.append((arr_t, task))
            backlog_s += cost
            self.n_admitted += 1
        return admitted, timed_out

    def _shed(self, task: Any, t: float, reason: str,
              round_idx: int) -> RejectedTask:
        self.n_shed += 1
        event = ShedEvent(
            task_id=int(getattr(task, "task_id", -1)), t=t, reason=reason,
            queue_depth=len(self.pending),
            utilisation=round(self.util, 12), round=round_idx)
        if self.tracer is not None:
            self.tracer.instant(f"shed:{reason}", track="admission",
                                cat="admission", task_id=event.task_id,
                                queue_depth=event.queue_depth,
                                round=round_idx)
        return RejectedTask(task=task, event=event)
