"""Online re-allocation: the drift-aware feedback loop (closing Fig. 1).

The paper's workflow is one-shot — characterise once, solve once, execute
once — yet its own premise (§2) is that metric models are *populated at
run time* and that execute-time records are the very shape
characterisation consumes. The companion work (arXiv:1408.4965) frames the
runtime as a continuously accessible service, and Memeti & Pllana
(arXiv:1606.05134) measure re-optimising the work distribution mid-run
paying off when system behaviour shifts. :class:`OnlineScheduler` closes
that loop:

    dispatch a tranche ──▶ records ──▶ fold into model windows
         ▲                                   │
         │                         drift? outage? arrivals?
         │                                   │ yes
    re-solve remaining work ◀── re-fit ◀─────┘
    (incumbent warm start)

Each round dispatches a tranche of the remaining work according to the
current allocation (via :meth:`Scheduler.dispatch_plan`), folds the
records back into per-(platform, task) windows, and watches a rolling
predicted-vs-measured latency ratio per platform (:class:`DriftDetector`).
Only when drift fires — or a platform dies (repeated dispatch failures),
or tasks arrive — are the models re-fitted (``Domain.fit_models`` over the
accumulated windows) and the allocation re-solved **for the remaining work
only** (:func:`repro_torch.core.restrict_problem`: surviving platforms, active
tasks, work scaled by remaining fraction), with the executing allocation
as warm-start incumbent so a re-solve that cannot improve matters is
skipped (:func:`repro_torch.core.heuristic.incumbent_shortcut`). An unperturbed
run therefore solves exactly once.

Round tranche sizes are *staggered* (alternating weights) so the
execute-time records of any pair span distinct unit counts — what keeps
the (beta, gamma) re-fit full-rank from tranche records alone — and are
floored per (platform, task) so a high-RTT platform is not billed its
constant every round for a sliver of work.

Determinism: tranche seeds derive from (platform, launch key, round) via
:func:`repro_torch.runtime.domain.seed_for`, rounds are barriers, and each
platform's work is serial inside its dispatch job, so concurrent and
sequential online runs produce bitwise-identical records — drift, outages
and all.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Hashable

import numpy as np

from repro_torch.core import (
    Allocation,
    CapacityError,
    SUPPORT_ATOL,
    expand_allocation,
    patch_allocation,
    restrict_allocation,
    restrict_problem,
)
from repro_torch.core.metrics import AccuracyModel, CombinedModel, LatencyModel
from repro_torch.core.slo import SLOConfig, SLOTracker, quantile
from repro_torch.obs import lift_solver_phases, metrics as obs_metrics
from .admission import (
    AdmissionConfig,
    AdmissionController,
    BrownoutTransition,
    predicted_unit_rates,
)
from .domain import RunRecordLike, seed_for
from .faults import (
    HALF_OPEN,
    CircuitBreaker,
    DegradationEvent,
    DispatchFault,
    FaultEvent,
    RetryPolicy,
    check_records,
    count_retries,
    fault_kind,
)
from .scenario import PlatformOutage, Scenario
from .scheduler import SOLVERS, Scheduler

__all__ = ["OnlineScheduler", "OnlineConfig", "OnlineReport", "DriftDetector",
           "TailDriftDetector", "RoundLog"]


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Knobs of the feedback loop; defaults suit the shipped simulators."""

    #: target number of dispatch tranches for a plan (late rounds flush
    #: whatever remains, so a run takes ~rounds rounds absent failures).
    rounds: int = 8
    #: hard stop — a safety net against pathological non-progress.
    max_rounds: int = 64
    #: |median measured/predicted - 1| per platform that fires drift.
    drift_threshold: float = 0.5
    #: records per platform in the rolling drift window. Small on purpose:
    #: the median flips only once half the window sits in the new regime,
    #: so detection latency is ~window/2 records on the drifting platform.
    drift_window: int = 6
    #: observations required before a platform can fire.
    min_drift_records: int = 3
    #: consecutive failed rounds before a platform is declared dead.
    outage_failures: int = 2
    #: warm-start skip tolerance forwarded to the solvers on re-solves.
    warm_tol: float = 0.05
    #: records kept per (platform, task) re-fit window (characterise rungs
    #: seed it; execute records push the stalest out).
    refit_window: int = 32
    #: alternating tranche weights — distinct per-round unit counts keep
    #: the re-fit full-rank from execute records alone.
    stagger: tuple[float, ...] = (1.25, 0.75)
    #: per-dispatch work floor, in multiples of the pair's gamma constant:
    #: a shard is grown until beta*units >= gamma_duty*gamma, consolidating
    #: a high-RTT platform's share of a task into few large dispatches —
    #: round-based dispatch pays gamma per visit, and without the floor a
    #: platform like AWS EC1 (89 ms RTT) would be billed it every round.
    #: 16 caps the constant at ~6% of each dispatch's work.
    gamma_duty: float = 16.0
    #: retry policy arming the per-dispatch fault layer (transient blips
    #: and corrupt results re-dispatched with deterministic backoff — see
    #: :class:`repro_torch.runtime.faults.RetryPolicy`). None leaves faults
    #: unhandled: a transient fault then fails the round like an outage.
    retry: RetryPolicy | None = None
    #: circuit-breaker cooldown, in *workload elapsed virtual time*: an
    #: OPEN (dead) platform goes HALF_OPEN after this long and is probed
    #: with a cheap seeded dispatch; success re-admits it to allocation.
    #: The default inf reproduces the legacy one-way dead set (platforms
    #: never come back).
    breaker_cooldown: float = math.inf
    #: graceful-degradation rung ladder: cumulative relaxation steps fed
    #: to ``Domain.degrade_quality`` when a re-solve is infeasible
    #: (CapacityError) or blows ``deadline_s``. Empty = degradation off:
    #: an infeasible re-solve propagates.
    degrade_steps: tuple[float, ...] = ()
    #: predicted-finish deadline (virtual seconds) that triggers quality
    #: degradation when the surviving fleet cannot meet it. None = no
    #: deadline pressure; CapacityError still triggers the ladder.
    deadline_s: float | None = None
    #: arrivals-only re-solves (no drift, no deaths, no revivals) take the
    #: O(k) incremental path: only the k new columns are solved against
    #: the fleet's committed shares (:func:`repro_torch.core.patch_allocation`),
    #: and the model re-fit is skipped — nothing about the old tasks'
    #: evidence changed. False restores the full re-solve on every arrival.
    patch_arrivals: bool = True
    #: patched-makespan tolerance vs the fresh full-problem heuristic bound
    #: before the patch is discarded for a full re-solve.
    patch_tol: float = 0.25
    #: open-loop serving mode: rounds are time barriers on a shared fleet
    #: clock (idle platforms advance to each round's start), the per-round
    #: tranche fraction is 1 (arrivals drive the pacing, not stagger), an
    #: idle fleet fast-forwards to the trace's next arrival instead of
    #: force-draining it, and exhausting ``max_rounds`` truncates the trace
    #: rather than raising — open-loop load has no drain-to-empty contract.
    open_loop: bool = False
    #: bounded admission control (queue sizing, backpressure, shedding);
    #: None admits every arrival unconditionally — the legacy behaviour,
    #: and the "guardrail off" control leg of the overload A/B.
    admission: AdmissionConfig | None = None
    #: SLO tail tracking (TTFT/TPOT/e2e percentiles per completed task);
    #: with ``degrade_steps`` set it also arms the brownout ladder, which
    #: walks quality down a rung when the recent guardrail quantile
    #: breaches the SLO and restores it when pressure clears.
    slo: SLOConfig | None = None
    #: tail-ratio drift threshold: |p-quantile(measured/predicted) - 1| per
    #: platform that fires a re-solve even when the median is quiet.
    #: None disables the tail detector (median-only, the legacy detector).
    tail_threshold: float | None = None
    #: records per platform in the tail detector's rolling window (larger
    #: than the median's — a p99 of 6 records is meaningless).
    tail_window: int = 12
    #: which tail the tail detector watches.
    tail_quantile: float = 0.99
    #: observations required before the tail detector can fire.
    min_tail_records: int = 6
    #: adopt fitted models for arrivals whose launch key matches an
    #: already-characterised task (see :meth:`Scheduler.adopt_models`)
    #: instead of re-benchmarking every arrival — the only admission cost
    #: that scales to trace-driven load. Off by default: adoption skips
    #: the arrival's own characterise records, which changes record
    #: streams for closed-loop runs that assert on them.
    adopt_family_models: bool = False


#: effectively-infinite per-unit latency, but small enough that the MILP's
#: constraint matrix stays numerically sane — 1e30-scale coefficients make
#: HiGHS declare the model infeasible, silently degrading every re-solve
#: to the heuristic fallback. 1e9 seconds/unit is ~9 orders above any real
#: coefficient here while staying comfortably inside solver tolerances.
_UNREACHABLE = 1e9


class _UnreachableModel:
    """Model placeholder for (dead platform, task) pairs.

    Tasks arriving after a platform dies cannot be benchmarked there, yet
    the scheduler's model matrices are total over platforms x tasks. This
    placeholder keeps them total while guaranteeing no solver would ever
    place work on the pair (and the online loop's restricted sub-problems
    drop the dead rows before solving anyway). The accuracy model says the
    pair needs ~no work so it never drives a task's remaining-work
    fraction; its huge delta keeps any share away regardless."""

    combined = CombinedModel(delta=_UNREACHABLE, gamma=0.0)
    latency = LatencyModel(beta=_UNREACHABLE, gamma=0.0)
    accuracy = AccuracyModel(alpha=1e-300)


class _RatioWindow:
    """Rolling predicted-vs-measured latency ratios per platform.

    Every executed record contributes ``measured / predicted`` under the
    models the *current allocation was solved with* (re-fitting must not
    wash out the signal it is meant to raise); a platform drifts when a
    subclass's summary statistic over the rolling window strays from 1 by
    more than the threshold.  An empty window reads as ratio 1.0 (zero
    error): no evidence is not evidence of drift.
    """

    def __init__(self, window: int, threshold: float, min_records: int):
        self.window = window
        self.threshold = threshold
        self.min_records = min_records
        self._ratios: dict[str, deque[float]] = {}

    def observe(self, platform: str, predicted: float, measured: float) -> None:
        self._ratios.setdefault(platform, deque(maxlen=self.window)).append(
            measured / max(predicted, 1e-12))

    def _statistic(self, ratios: list[float]) -> float:
        raise NotImplementedError

    def ratio(self, platform: str) -> float:
        """The window's summary ratio; 1.0 on an empty window."""
        rs = self._ratios.get(platform)
        return self._statistic(list(rs)) if rs else 1.0

    def error(self, platform: str) -> float:
        """|summary ratio - 1|: the rolling relative latency error."""
        if not self._ratios.get(platform):
            return 0.0
        return abs(self.ratio(platform) - 1.0)

    def drifted(self, alive: dict[str, bool] | None = None) -> tuple[str, ...]:
        fired = []
        for pn, rs in self._ratios.items():
            if alive is not None and not alive.get(pn, True):
                continue
            if len(rs) >= self.min_records and self.error(pn) > self.threshold:
                fired.append(pn)
        return tuple(sorted(fired))

    def reset(self) -> None:
        self._ratios.clear()


class DriftDetector(_RatioWindow):
    """Median-gated drift detector (the re-solve trigger since PR 4).

    The median — not the mean — gates the decision deliberately: a lone
    straggler record cannot trigger a re-solve, and by the time the median
    moves, the majority of the window sits in the new regime, so the
    median ratio doubles as an immediately usable drift-correction factor
    for stale window records at re-fit time (a mean-gated detector fires
    earlier but with a correction factor of ~1, wasting the re-solve).
    """

    def __init__(self, window: int = 8, threshold: float = 0.5,
                 min_records: int = 3):
        super().__init__(window, threshold, min_records)

    def _statistic(self, ratios: list[float]) -> float:
        return float(np.median(ratios))

    def median_ratio(self, platform: str) -> float:
        return self.ratio(platform)


class TailDriftDetector(_RatioWindow):
    """Tail-quantile companion to :class:`DriftDetector`.

    Watches the p-quantile (default p99) of the same per-platform ratio
    window: a platform whose *tail* latencies blow up — contention,
    stragglers, queueing — while the median stays quiet breaches the SLO
    long before the median detector notices.  Needs a larger window and a
    looser threshold than the median (a p99 over six records is noise).
    """

    def __init__(self, window: int = 12, threshold: float = 1.0,
                 min_records: int = 6, q: float = 0.99):
        super().__init__(window, threshold, min_records)
        self.q = q

    def _statistic(self, ratios: list[float]) -> float:
        return float(quantile(ratios, self.q))

    def tail_ratio(self, platform: str) -> float:
        return self.ratio(platform)


@dataclasses.dataclass(frozen=True)
class RoundLog:
    """What one feedback round did (the report's audit trail)."""

    round: int
    dispatched_units: dict[str, int]
    drifted: tuple[str, ...]
    failed: tuple[str, ...]
    arrivals: int
    resolved: bool
    #: "solved" | "skipped" (warm-start early exit) | "patched" (O(k)
    #: incremental arrival patch) | "patch-fallback" (patch discarded for a
    #: full solve) | None (no re-solve).
    solve_outcome: str | None
    #: platforms whose breaker probe succeeded this round (re-admitted).
    revived: tuple[str, ...] = ()
    #: platforms whose tail (p99) ratio fired this round (overload drift).
    tail_drifted: tuple[str, ...] = ()
    #: arrivals offered to admission control this round (== arrivals when
    #: admission is off).
    offered: int = 0
    #: arrivals shed this round (queue-full / capacity / timeout).
    shed: int = 0
    #: admission-queue depth at the end of the round.
    queue_depth: int = 0
    #: outstanding dispatch quota units at the end of the round — the
    #: quantity whose boundedness (vs monotone growth) is the overload
    #: acceptance criterion.
    backlog_units: float = 0.0
    #: brownout ladder rung in force at the end of the round.
    brownout_rung: int = 0
    #: tasks that completed (all quotas drained) this round.
    completions: int = 0
    #: fleet-clock time (max platform timeline) at the end of the round.
    t: float = 0.0
    #: min over alive platforms of remaining KV capacity (bytes) at the
    #: admission barrier — negative would mean the fleet oversubscribed.
    #: inf when admission control is off (no audit is computed).
    kv_headroom: float = math.inf


@dataclasses.dataclass
class OnlineReport:
    """Outcome of an online run: final state plus the adaptation history."""

    allocation: Allocation
    predicted_makespan: float       # the initial solve's prediction
    measured_makespan: float        # max over platforms of summed latency
    platform_latencies: dict[str, float]
    records: list[RunRecordLike]
    summary: dict = dataclasses.field(default_factory=dict)
    rounds: list[RoundLog] = dataclasses.field(default_factory=list)
    n_solves: int = 0               # total solves (initial + re-solves)
    n_resolves: int = 0             # re-solves that actually ran a solver
    n_skipped: int = 0              # re-solves short-circuited by warm start
    n_refits: int = 0               # model re-fit passes
    solve_wall_s: float = 0.0       # wall time inside solvers, initial incl.
    resolve_wall_s: float = 0.0     # wall time of mid-run re-solves only
    dead_platforms: tuple[str, ...] = ()
    arrivals: int = 0
    platform_wall_s: dict[str, float] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    mode: str = "sequential"
    #: fault-layer audit trails (see repro_torch.runtime.faults)
    fault_events: list = dataclasses.field(default_factory=list)
    degradations: list = dataclasses.field(default_factory=list)
    breaker_transitions: list = dataclasses.field(default_factory=list)
    n_retries: int = 0              # retried dispatch attempts, all rounds
    n_probes: int = 0               # breaker recovery probes dispatched
    recovered_platforms: tuple[str, ...] = ()  # died then re-admitted
    n_patched: int = 0              # arrivals absorbed by the O(k) patch
    #: solver telemetry per solve that ran (initial + re-solves + patches):
    #: build_s/solve_s phases, n_vars/n_constraints, incremental outcome.
    solve_metas: list = dataclasses.field(default_factory=list)
    #: overload-control audit trails (see repro_torch.runtime.admission)
    shed_events: list = dataclasses.field(default_factory=list)
    brownout_transitions: list = dataclasses.field(default_factory=list)
    n_offered: int = 0              # arrivals offered to admission control
    n_shed: int = 0                 # arrivals shed (all reasons)
    brownout_rung: int = 0          # final brownout rung
    #: rounds spent at each brownout rung (rung -> round count).
    brownout_occupancy: dict = dataclasses.field(default_factory=dict)
    #: SLOTracker.snapshot() when config.slo is set, else None: lifetime
    #: p50/p95/p99 of TTFT/TPOT/e2e over completed tasks + attainment.
    slo: dict | None = None
    #: per-completed-task latency metrics: tid -> {ttft, tpot, e2e, units}.
    task_metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def shed_fraction(self) -> float:
        """Fraction of offered arrivals shed (0.0 when nothing offered)."""
        return self.n_shed / self.n_offered if self.n_offered else 0.0

    @property
    def makespan_error(self) -> float:
        """Initial-model prediction error — under drift this is exactly the
        gap adaptation closes for the *allocation*, not the forecast."""
        if self.measured_makespan == 0:
            return math.inf
        return abs(self.predicted_makespan - self.measured_makespan) / self.measured_makespan


class OnlineScheduler:
    """Executes a workload in drift-aware rounds over a :class:`Scheduler`.

        online = OnlineScheduler(Scheduler(make_domain("pricing", tasks,
                                                       platforms)))
        report = online.run(quality=0.05, method="milp")

    Platform perturbations (slowdowns, outages) live on the simulated
    platforms via ``attach_scenario``; pass the same :class:`Scenario`
    to :meth:`run` only so queued *arrivals* can join the workload.
    """

    def __init__(self, scheduler: Scheduler, config: OnlineConfig | None = None):
        self.scheduler = scheduler
        self.config = config or OnlineConfig()
        # per-pair work totals memo for _solve, keyed on (models_version,
        # task count, surviving rows, quality bytes): totals only change
        # when the models or the frame do, yet the O(mu*tau) Python loop
        # that builds them used to run on every re-solve
        self._totals_cache: tuple[tuple, dict] | None = None

    # -- helpers -----------------------------------------------------------

    @property
    def domain(self):
        return self.scheduler.domain

    def _solve(self, quality, method: str, solver_kw: dict,
               alive: dict[str, bool], done: dict[int, float],
               incumbent_A: np.ndarray | None,
               elapsed: dict[str, float] | None = None,
               done_pair: dict[tuple[str, int], float] | None = None,
               patch_tids: set[int] | None = None):
        """(Re-)solve the allocation over the remaining work only.

        Returns (allocation, A_full, quotas) — A_full is the sub-solution
        expanded back to the full frame (zero rows for dead platforms,
        zero columns for completed tasks) and ``quotas`` maps each
        supported (platform, task_id) pair to the work units it owes:
        ``ceil(share * remaining_i(task))`` under *that platform's own*
        quality->work inversion, exactly the unit accounting the one-shot
        :meth:`Scheduler.shards` uses. Rounds then drain quotas, so an
        unperturbed online run dispatches the same totals per pair as a
        single execute pass (± one unit of per-tranche rounding).

        When the problem carries a capacity dimension, ``done_pair`` (work
        units already served per (platform, task)) converts into resource
        already *held*: shards of still-active tasks keep their pages until
        the task completes, so each platform enters the restricted problem
        with only its remaining capacity — a drift-triggered re-solve
        cannot oversubscribe a platform that is part-way through its plan.

        ``patch_tids`` switches to the O(k) incremental path: the columns
        whose task ids it names are solved by :func:`patch_allocation`
        against the incumbent's committed shares (held fixed) instead of
        re-solving the whole restricted problem — the arrivals-only round's
        fast path, with patch_allocation's own bound test falling back to
        the full restricted solve when holding the old shares costs more
        than ``config.patch_tol``.
        """
        domain, sched = self.domain, self.scheduler
        c = sched.quality_vector(quality)
        problem = sched.problem(quality)
        rows = [i for i, p in enumerate(domain.platforms)
                if alive[domain.platform_name(p)]]
        if not rows:
            raise RuntimeError("every platform is down; cannot re-allocate")
        # per-(platform, task) totals and remaining under each platform's
        # own fitted model; a task stays active while any surviving
        # platform's inversion says work is outstanding. Totals are memoed
        # on the model generation — only refit/characterise change them.
        cache_key = (sched.models_version, len(domain.tasks), tuple(rows),
                     c.tobytes())
        if self._totals_cache is not None and self._totals_cache[0] == cache_key:
            totals = self._totals_cache[1]
        else:
            totals = {}
            for j, t in enumerate(domain.tasks):
                for i in rows:
                    pname = domain.platform_name(domain.platforms[i])
                    totals[(pname, t.task_id)] = max(domain.work_units(
                        sched.models[(pname, t.task_id)], float(c[j])), 1e-12)
            self._totals_cache = (cache_key, totals)
        frac_by_col: dict[int, float] = {}
        for j, t in enumerate(domain.tasks):
            best = 0.0
            for i in rows:
                pname = domain.platform_name(domain.platforms[i])
                total = totals[(pname, t.task_id)]
                rem = max(total - done.get(t.task_id, 0.0), 0.0)
                best = max(best, rem / total)
            if best > 0:
                frac_by_col[j] = min(best, 1.0)
        cols = sorted(frac_by_col)
        if not cols:
            return None, None, {}
        # each platform's elapsed busy time rides along as its offset, so
        # the re-solve minimises *finish* time — completed shares are fixed
        # history the remaining work must be balanced around
        offsets = np.array([
            (elapsed or {}).get(domain.platform_name(p), 0.0)
            for p in domain.platforms])
        # remaining capacity: pages held by already-served shards of tasks
        # still in flight stay committed on their platform until the task
        # completes; completed tasks have freed theirs (absent from cols)
        cap_rem = None
        if problem.capacity is not None:
            active = {domain.tasks[j].task_id for j in cols}
            held = np.zeros(problem.mu)
            for i, p in enumerate(domain.platforms):
                pname = domain.platform_name(p)
                for t in domain.tasks:
                    if t.task_id in active:
                        held[i] += (domain.resource_per_unit(p, t)
                                    * (done_pair or {}).get((pname, t.task_id), 0.0))
            cap_rem = np.maximum(problem.capacity - held, 0.0)
        sub = restrict_problem(problem, rows, cols,
                               [frac_by_col[j] for j in cols],
                               offsets=offsets, capacity=cap_rem)
        new_idx = ([] if not patch_tids else
                   [k for k, j in enumerate(cols)
                    if domain.tasks[j].task_id in patch_tids])
        if new_idx and incumbent_A is not None and len(new_idx) < len(cols):
            # patch base: the incumbent's shares for the columns it has
            # already committed, exact zeros for the newcomers (they carry
            # no mass yet — restrict_allocation's uniform orphan fill would
            # violate patch_allocation's precondition)
            base = np.asarray(incumbent_A, dtype=np.float64)[
                np.ix_(rows, cols)].copy()
            base[:, new_idx] = 0.0
            colsum = base.sum(axis=0)
            old = np.ones(len(cols), dtype=bool)
            old[new_idx] = False
            orphan = old & (colsum <= SUPPORT_ATOL)
            if orphan.any():
                base[:, orphan] = 1.0 / len(rows)
                colsum = base.sum(axis=0)
            base[:, old] /= colsum[old]
            alloc = patch_allocation(sub, base, new_idx, method,
                                     patch_tol=self.config.patch_tol,
                                     **solver_kw)
        else:
            kw = dict(solver_kw)
            if incumbent_A is not None and method in ("milp", "ml"):
                kw["incumbent"] = restrict_allocation(incumbent_A, rows, cols)
                kw.setdefault("warm_tol", self.config.warm_tol)
            alloc = SOLVERS[method](sub, **kw)
        A_full = expand_allocation(alloc.A, problem.mu, problem.tau, rows, cols)
        quotas: dict[tuple[str, int], float] = {}
        for i in rows:
            pname = domain.platform_name(domain.platforms[i])
            for j in cols:
                tid = domain.tasks[j].task_id
                share = A_full[i, j]
                if share <= SUPPORT_ATOL:
                    continue
                rem = max(totals[(pname, tid)] - done.get(tid, 0.0), 0.0)
                quota = float(np.ceil(share * rem))
                if quota > 0:
                    quotas[(pname, tid)] = quota
        return alloc, A_full, quotas

    def _effective_quality(self, quality, rung: int):
        """Quality target at degradation ``rung`` (0 = the original).

        Recomputed from the *base* quality over the current task list each
        time, so arrivals are covered and rung k applies the ladder's
        cumulative step, not a compounding of earlier rungs."""
        if rung == 0:
            return quality
        step = self.config.degrade_steps[rung - 1]
        c = self.scheduler.quality_vector(quality)
        return np.array([self.domain.degrade_quality(float(cj), step)
                         for cj in c])

    def _degrade(self, quality, rung: int, active_tids, round_idx: int,
                 reason: str, degradations: list) -> int:
        """Step the rung ladder down one notch, itemising per active task."""
        sched = self.scheduler
        sched.tracer.instant(f"degrade:{reason}", track="online",
                             cat="degrade", rung=rung + 1, round=round_idx)
        c_from = sched.quality_vector(self._effective_quality(quality, rung))
        c_to = sched.quality_vector(self._effective_quality(quality, rung + 1))
        for j, t in enumerate(self.domain.tasks):
            if active_tids is None or t.task_id in active_tids:
                degradations.append(DegradationEvent(
                    task_id=t.task_id, round=round_idx,
                    quality_from=float(c_from[j]), quality_to=float(c_to[j]),
                    rung=rung + 1, reason=reason))
        return rung + 1

    def _solve_degraded(self, quality, rung: int, method: str, solver_kw: dict,
                        alive: dict[str, bool], done: dict[int, float],
                        incumbent_A, elapsed=None, done_pair=None,
                        active_tids=None, round_idx: int = -1,
                        degradations: list | None = None,
                        patch_tids: set[int] | None = None):
        """:meth:`_solve` wrapped in the graceful-degradation ladder.

        An infeasible restricted problem (typed :class:`CapacityError` —
        the surviving fleet cannot even hold the active tasks' resources)
        or a feasible plan whose predicted finish blows ``deadline_s``
        relaxes the quality targets one rung (``Domain.degrade_quality``)
        and re-solves, trading the paper's central asset — accuracy — for
        latency instead of failing. The rung is monotone across the run
        (quality never silently recovers mid-workload: reporting is
        simpler and re-fit windows stay regime-consistent). Ladder
        exhausted: CapacityError propagates, a blown deadline is accepted
        as best effort. Returns (alloc, A_full, quotas, rung)."""
        cfg = self.config
        degradations = degradations if degradations is not None else []
        while True:
            try:
                alloc, A_full, quotas = self._solve(
                    self._effective_quality(quality, rung), method, solver_kw,
                    alive, done, incumbent_A, elapsed=elapsed,
                    done_pair=done_pair, patch_tids=patch_tids)
            except CapacityError:
                if rung >= len(cfg.degrade_steps):
                    raise
                rung = self._degrade(quality, rung, active_tids, round_idx,
                                     "capacity", degradations)
                continue
            if (alloc is not None and cfg.deadline_s is not None
                    and alloc.makespan > cfg.deadline_s
                    and rung < len(cfg.degrade_steps)):
                rung = self._degrade(quality, rung, active_tids, round_idx,
                                     "deadline", degradations)
                continue
            return alloc, A_full, quotas, rung

    def _probe(self, p, round_idx: int, seed: int, elapsed: float,
               quotas: dict[tuple[str, int], float]):
        """Cheap seeded dispatch testing a HALF_OPEN platform's health.

        The platform idled while its breaker was open, but wall time kept
        passing — ``Domain.advance_platform`` syncs its virtual clock to
        the fleet's elapsed time first, so a finite outage window ends
        after a bounded number of probes instead of never (the clock would
        otherwise only creep by one retry cost per probe). The probe is
        ``min_chunk`` units of the first still-active task: real work, so
        a successful probe's records count toward completion. Returns None
        when no active work remains to probe with, else
        (ok, records, FaultEvent)."""
        domain = self.domain
        pname = domain.platform_name(p)
        active = {tid for (_pn, tid), q in quotas.items() if q > 0}
        task = next((t for t in domain.tasks if t.task_id in active), None)
        if task is None:
            return None
        domain.advance_platform(p, elapsed)
        clock0 = getattr(p, "clock", None)
        probe_seed = seed_for(seed, pname, ("probe", domain.launch_key(task)),
                              round_idx)
        try:
            recs = domain.dispatch_batch(p, [task], [domain.min_chunk],
                                         seed=probe_seed)
            check_records(recs)
            return True, recs, FaultEvent(
                pname, task.task_id, round_idx, "probe", "probe-ok")
        except DispatchFault as exc:
            salvaged = list(getattr(exc, "records", []))
            burned = 0.0
            if clock0 is not None:
                burned = max(getattr(p, "clock", clock0) - clock0
                             - sum(r.latency for r in salvaged), 0.0)
            return False, salvaged, FaultEvent(
                pname, task.task_id, round_idx, fault_kind(exc),
                "probe-failed", latency=burned)

    def _plan_round(self, quotas: dict[tuple[str, int], float],
                    alive: dict[str, bool], round_idx: int,
                    solve_models: dict) -> list[tuple[Any, list[list[tuple[Any, int]]]]]:
        """Turn the outstanding quotas into this round's dispatch tranche."""
        cfg, domain = self.config, self.domain
        rounds_left = max(cfg.rounds - round_idx, 1)
        w = cfg.stagger[round_idx % len(cfg.stagger)] if cfg.stagger else 1.0
        # the final planned round flushes everything — a sub-1 stagger
        # weight there would leak a sliver into an extra leftover round.
        # Open-loop runs flush every round: the trace paces the work, and
        # holding quota back would just queue admitted requests longer.
        frac = (1.0 if rounds_left == 1 or cfg.open_loop
                else min(w / rounds_left, 1.0))
        plan = []
        for p in domain.platforms:
            pname = domain.platform_name(p)
            if not alive[pname]:
                continue
            groups: dict[Hashable, list[tuple[Any, int]]] = {}
            for t in domain.tasks:
                quota = quotas.get((pname, t.task_id), 0.0)
                if quota <= 0:
                    continue
                planned = quota * frac
                beta, gamma = domain.latency_params(
                    solve_models[(pname, t.task_id)])
                # consolidation floor: do not pay the per-dispatch constant
                # for a shard whose work does not dwarf it
                floor = cfg.gamma_duty * gamma / max(beta, 1e-300)
                units = int(np.ceil(min(
                    max(planned, floor, float(domain.min_chunk)), quota)))
                if units <= 0:
                    continue
                groups.setdefault(domain.launch_key(t), []).append((t, units))
            if groups:
                plan.append((p, list(groups.values())))
        return plan

    def _heal_unreachable(self, alive: dict[str, bool], mode,
                          characterise_kw: dict | None) -> None:
        """Retry characterisation of placeholder pairs on living platforms.

        A task arriving while a platform sits in a *transient* outage gets
        an :class:`_UnreachableModel` there; once the platform is back the
        placeholder would otherwise stick forever — harmless to MILP/ML
        (they just avoid the pair) but poisonous to the proportional
        heuristic, whose per-platform share folds every task's work into
        one latency. Each re-solve therefore re-benchmarks the stale pairs
        (outage-tolerant: still-down platforms keep their placeholder)."""
        sched, domain = self.scheduler, self.domain
        stale: dict[str, list] = {}
        for p in domain.platforms:
            pname = domain.platform_name(p)
            if not alive[pname]:
                continue
            for t in domain.tasks:
                if isinstance(sched.models.get((pname, t.task_id)),
                              _UnreachableModel):
                    stale.setdefault(pname, []).append(t)
        for p in domain.platforms:
            pname = domain.platform_name(p)
            if pname in stale:
                sched.characterise_tasks(stale[pname], mode=mode,
                                         platforms=[p],
                                         **(characterise_kw or {}))

    def _refit(self, windows: dict, detector: DriftDetector,
               drifted: tuple[str, ...], alive: dict[str, bool],
               solve_models: dict) -> None:
        """Fold the accumulated record windows back into the metric models.

        For a drifted platform the window straddles two regimes, and fresh
        tranche records alone may not identify (beta, gamma) — a pair often
        repeats one shard size. So stale records (those whose own
        measured/predicted ratio sits far from the platform's median) are
        *projected onto the new regime's line*: latency replaced by
        ``model(units) * median_ratio``. They keep their unit-count spread
        (anchoring the slope/intercept split) while the genuinely fresh
        records supply the new level. Non-drifted platforms refit from
        their raw windows — the routine fold of execute-time evidence.
        """
        updates: dict[tuple[str, int], list] = {}
        for key, win in windows.items():
            pname, _tid = key
            if not alive[pname]:
                continue
            recs = list(win)
            # tasks that arrived this round have no solve-time model yet;
            # their windows (fresh characterise rungs) pass through raw
            model = solve_models.get(key)
            if pname in drifted and recs and model is not None:
                med = detector.median_ratio(pname)
                fixed = []
                for r in recs:
                    pred = self.domain.predicted_latency(
                        model, self.domain.record_units(r))
                    ratio = r.latency / max(pred, 1e-12)
                    if med > 0 and abs(ratio - med) / med > 0.5:
                        r = dataclasses.replace(r, latency=pred * med)
                    fixed.append(r)
                recs = fixed
            updates[key] = recs
        self.scheduler.refit(updates)

    # -- the loop ----------------------------------------------------------

    def run(self, quality=None, method: str = "milp", seed: int = 3,
            mode: str | None = None, scenario: Scenario | None = None,
            characterise_kw: dict | None = None, **solver_kw) -> OnlineReport:
        """Execute the workload in rounds; adapt only when evidence demands.

        ``scenario`` here feeds *task arrivals* into the loop (slowdowns
        and outages act through the platforms they are attached to); a
        task joins once the workload's elapsed virtual makespan passes its
        arrival time, is characterised incrementally, and forces a
        re-solve so the new work is placed.
        """
        cfg, sched, domain = self.config, self.scheduler, self.domain
        t_run = time.perf_counter()
        tracer, ledger = sched.tracer, sched.ledger
        obs_on = tracer.enabled
        # task family names for the ledger's (platform, family, round) keys
        task_family: dict[int, str] = (
            {t.task_id: str(domain.launch_key(t)) for t in domain.tasks}
            if obs_on else {})
        if scenario is not None:
            # the arrival cursor belongs to a run, not the scenario object,
            # so rewind it here. (Replaying a scenario across runs also
            # needs fresh platform virtual clocks — re-attach it via each
            # simulator's attach_scenario; this loop is domain-agnostic and
            # cannot reach them.)
            scenario.reset()
            if scenario.pending_arrivals and quality is not None and np.ndim(quality) > 0:
                raise ValueError(
                    "streaming arrivals need a scalar quality or the domain "
                    "default — a per-task quality vector cannot be extended "
                    "for tasks that join mid-workload")
        if sched.models is None:
            sched.characterise(mode=mode, **(characterise_kw or {}))

        names = [domain.platform_name(p) for p in domain.platforms]
        breaker = CircuitBreaker(failure_threshold=cfg.outage_failures,
                                 cooldown_s=cfg.breaker_cooldown,
                                 tracer=tracer if obs_on else None)
        alive = {pn: True for pn in names}
        done: dict[int, float] = {}
        done_pair: dict[tuple[str, int], float] = {}
        windows: dict[tuple[str, int], deque] = {
            key: deque(recs, maxlen=cfg.refit_window)
            for key, recs in sched.characterise_records.items()}
        detector = DriftDetector(cfg.drift_window, cfg.drift_threshold,
                                 cfg.min_drift_records)
        fault_events: list[FaultEvent] = []
        degradations: list[DegradationEvent] = []
        recovered: set[str] = set()
        rung, n_probes = 0, 0

        # -- overload-control state (all round-barrier, mode-parity safe)
        admission = (AdmissionController(cfg.admission,
                                         tracer=tracer if obs_on else None)
                     if cfg.admission is not None else None)
        slo_tracker = SLOTracker(cfg.slo) if cfg.slo is not None else None
        tail = (TailDriftDetector(cfg.tail_window, cfg.tail_threshold,
                                  cfg.min_tail_records, cfg.tail_quantile)
                if cfg.tail_threshold is not None else None)
        shed_events: list = []
        brownout_transitions: list[BrownoutTransition] = []
        brown_rung = 0
        brown_occupancy: dict[int, int] = {}
        # per-task latency accounting for TTFT/TPOT/e2e: arrival time,
        # first-output time, last-output time, served units, completion
        arr_t: dict[int, float] = {}
        task_first: dict[int, float] = {}
        task_last: dict[int, float] = {}
        task_units: dict[int, int] = {}
        completed_tasks: set[int] = set()
        task_metrics: dict[int, dict] = {}
        rates_version = -1
        unit_rates: dict[str, float] = {}

        solve_t0 = time.perf_counter()
        with tracer.span("solve[initial]", track="online", cat="solve",
                         method=method):
            alloc, A_full, quotas, rung = self._solve_degraded(
                quality, rung, method, solver_kw, alive, done,
                incumbent_A=None, done_pair=done_pair,
                degradations=degradations)
        solve_wall = time.perf_counter() - solve_t0
        if obs_on and alloc is not None:
            lift_solver_phases(tracer, alloc.meta, tracer.now(),
                               label=f"{alloc.solver or method}[initial]")
        resolve_wall = 0.0
        if alloc is None:
            raise ValueError("workload has no remaining work to execute")
        predicted0 = alloc.makespan
        solve_models = dict(sched.models)
        n_solves, n_resolves, n_skipped, n_refits, n_arrivals = 1, 0, 0, 0, 0
        n_patched = 0
        solve_metas: list[dict] = [dict(alloc.meta)]

        all_records: list[RunRecordLike] = []
        plat_lat = {pn: 0.0 for pn in alive}
        plat_wall = {pn: 0.0 for pn in alive}
        rounds: list[RoundLog] = []

        for round_idx in range(cfg.max_rounds):
            round_wall_t0 = tracer.now() if obs_on else 0.0
            elapsed = max(plat_lat.values(), default=0.0)
            if cfg.open_loop:
                # rounds are *time barriers* on a shared fleet clock: a
                # platform that finished its tranche early idled until the
                # barrier, so its timeline (and virtual clock) resumes at
                # the round start, not at its own busy-time sum — this is
                # what makes per-task e2e latencies real waiting times
                for p in domain.platforms:
                    pname = domain.platform_name(p)
                    if alive[pname]:
                        plat_lat[pname] = max(plat_lat[pname], elapsed)
                        domain.advance_platform(p, elapsed)
            round_t0 = elapsed
            round_busy = 0.0
            # breaker recovery at the round barrier: OPEN platforms whose
            # cooldown (in workload elapsed virtual time) has passed go
            # HALF_OPEN and take a cheap probe; a clean probe re-admits
            # them to the allocation (the one-way dead set, undone)
            revived: list[str] = []
            for p in domain.platforms:
                pname = domain.platform_name(p)
                if breaker.poll(pname, elapsed, round_idx) != HALF_OPEN:
                    continue
                with tracer.span("probe", track=pname, cat="dispatch",
                                 round=round_idx):
                    outcome = self._probe(p, round_idx, seed, elapsed,
                                          quotas)
                if outcome is None:
                    continue
                ok, recs, event = outcome
                n_probes += 1
                fault_events.append(event)
                probe_lat = 0.0
                for rec in recs:
                    all_records.append(rec)
                    probe_lat += rec.latency
                    units = domain.record_units(rec)
                    done[rec.task_id] = done.get(rec.task_id, 0.0) + units
                    key = (pname, rec.task_id)
                    done_pair[key] = done_pair.get(key, 0.0) + units
                    quotas[key] = max(quotas.get(key, 0.0) - units, 0.0)
                    windows.setdefault(
                        key, deque(maxlen=cfg.refit_window)).append(rec)
                    end_t = elapsed + probe_lat
                    first_t = domain.record_ttft(rec, end_t)
                    prev = task_first.get(rec.task_id)
                    task_first[rec.task_id] = (
                        first_t if prev is None else min(prev, first_t))
                    task_last[rec.task_id] = max(
                        task_last.get(rec.task_id, 0.0), end_t)
                    task_units[rec.task_id] = (
                        task_units.get(rec.task_id, 0) + units)
                if ok:
                    breaker.record_success(pname, elapsed, round_idx)
                    # the platform idled while down: its timeline resumes
                    # at the fleet's elapsed time, not at its stale sum
                    plat_lat[pname] = max(plat_lat[pname],
                                          elapsed + probe_lat)
                    alive[pname] = True
                    revived.append(pname)
                    recovered.add(pname)
                else:
                    breaker.record_failure(pname, elapsed, round_idx)

            if not any(q > 0 for q in quotas.values()):
                late: list[tuple[float, Any]] = []
                if scenario is not None and scenario.pending_arrivals:
                    if cfg.open_loop:
                        # idle fleet, trace still running: fast-forward the
                        # barrier clock to the next arrival instant — open
                        # loop means requests come on their own schedule,
                        # not when the fleet is ready for them
                        target = max(elapsed, scenario.next_arrival_time)
                        for p in domain.platforms:
                            pname = domain.platform_name(p)
                            if alive[pname]:
                                plat_lat[pname] = max(plat_lat[pname], target)
                                domain.advance_platform(p, target)
                        elapsed = round_t0 = target
                    else:
                        # drain the arrival queue: no more work means
                        # virtual time cannot advance to reach stragglers,
                        # so they join now
                        late = scenario.take_arrivals_timed(0.0, force=True)
                elif admission is not None and admission.pending:
                    pass  # queued arrivals still waiting for admission
                else:
                    break
            else:
                late = []

            plan = self._plan_round(quotas, alive, round_idx, solve_models)
            results, _round_wall = ([], 0.0) if not plan else sched.dispatch_plan(
                plan,
                seed=lambda pn, key, _r=round_idx: seed_for(seed, pn, key, _r),
                mode=mode,
                # with the retry layer armed, retry-exhausted transients
                # and corrupt dispatches degrade to per-platform errors the
                # breaker counts; unarmed, only outages are survivable —
                # the legacy (and deliberately brittle) behaviour
                catch=(DispatchFault,) if cfg.retry is not None
                else (PlatformOutage,),
                retry=cfg.retry, round_idx=round_idx)

            dispatched: dict[str, int] = {}
            failed: list[str] = []
            for (p, _groups), res in zip(plan, results):
                pname = domain.platform_name(p)
                plat_wall[pname] += res.wall_s
                for rec in res.records:
                    all_records.append(rec)
                    plat_lat[pname] += rec.latency
                    round_busy += abs(rec.latency)
                    units = domain.record_units(rec)
                    dispatched[pname] = dispatched.get(pname, 0) + units
                    done[rec.task_id] = done.get(rec.task_id, 0.0) + units
                    key = (pname, rec.task_id)
                    done_pair[key] = done_pair.get(key, 0.0) + units
                    quotas[key] = max(quotas.get(key, 0.0) - units, 0.0)
                    windows.setdefault(
                        key, deque(maxlen=cfg.refit_window)).append(rec)
                    predicted = domain.predicted_latency(
                        solve_models[key], units)
                    detector.observe(pname, predicted, rec.latency)
                    if obs_on:
                        ledger.observe("latency", pname,
                                       task_family.get(rec.task_id, "?"),
                                       round_idx, predicted, rec.latency)
                    if tail is not None:
                        tail.observe(pname, predicted, rec.latency)
                    end_t = plat_lat[pname]
                    first_t = domain.record_ttft(rec, end_t)
                    prev = task_first.get(rec.task_id)
                    task_first[rec.task_id] = (
                        first_t if prev is None else min(prev, first_t))
                    task_last[rec.task_id] = max(
                        task_last.get(rec.task_id, 0.0), end_t)
                    task_units[rec.task_id] = (
                        task_units.get(rec.task_id, 0) + units)
                for ev in res.faults:
                    fault_events.append(ev)
                    # retries burn real virtual time on the platform's
                    # timeline — a storm honestly inflates its makespan
                    plat_lat[pname] += ev.latency
                if res.error is not None:
                    failed.append(pname)

            # feed round outcomes to the breaker: a failed round advances
            # a platform's streak, a clean dispatching round breaks it, an
            # idle round breaks it too — the death gate counts
            # *consecutive* failed rounds, so two isolated hiccups
            # separated by quiet rounds must not accumulate
            elapsed = max(plat_lat.values(), default=0.0)
            planned = {domain.platform_name(p) for p, _ in plan}
            was_dead = {pn: not breaker.available(pn) for pn in names}
            for pn in names:
                if pn in failed:
                    breaker.record_failure(pn, elapsed, round_idx)
                elif pn in planned:
                    breaker.record_success(pn, elapsed, round_idx)
                else:
                    breaker.reset_streak(pn)
            newly_dead = [pn for pn in failed
                          if not was_dead[pn] and not breaker.available(pn)]
            for pn in names:
                alive[pn] = breaker.available(pn)
            # -- completion barrier: tasks whose quotas fully drained this
            # round yield their TTFT/TPOT/e2e observations (streaming into
            # the SLO tracker) before any re-solve rebuilds the quotas
            completions = 0
            out_by_tid: dict[int, float] = {}
            for (_pn, tid), q in quotas.items():
                if q > 0:
                    out_by_tid[tid] = out_by_tid.get(tid, 0.0) + q
            for tid in sorted(task_first):
                if tid in completed_tasks or out_by_tid.get(tid, 0.0) > 0:
                    continue
                arr = arr_t.get(tid, 0.0)
                first = task_first[tid]
                last = max(task_last.get(tid, first), first)
                ttft = max(first - arr, 0.0)
                e2e = max(last - arr, ttft)
                units = task_units.get(tid, 1)
                tpot = (e2e - ttft) / max(units - 1, 1)
                if slo_tracker is not None:
                    slo_tracker.observe(ttft, tpot, e2e)
                task_metrics[tid] = {"ttft": ttft, "tpot": tpot,
                                     "e2e": e2e, "units": units}
                completed_tasks.add(tid)
                completions += 1

            offered_timed = list(late)
            if scenario is not None:
                offered_timed += scenario.take_arrivals_timed(elapsed)
            # idempotent admission: a task already in the workload (e.g. a
            # replayed scenario whose arrival joined permanently in an
            # earlier run on this scheduler) is simply part of it
            known = {t.task_id for t in domain.tasks}
            offered_timed = [(at, t) for at, t in offered_timed
                             if t.task_id not in known]
            round_shed = 0
            round_kv_headroom = math.inf
            if admission is None:
                joined = offered_timed
            else:
                # refresh the fleet signals the queue bound derives from
                # (service rates memoed on the model generation; remaining
                # capacity from pages held by tasks still in flight)
                alive_set = {pn for pn in names if alive[pn]}
                if rates_version != sched.models_version:
                    unit_rates = predicted_unit_rates(sched.models, alive_set)
                    rates_version = sched.models_version
                cap_rem: dict[str, float] = {}
                active_now = {tid for (_pn, tid), q in quotas.items() if q > 0}
                for p in domain.platforms:
                    pname = domain.platform_name(p)
                    if pname not in alive_set:
                        continue
                    held = sum(domain.resource_per_unit(p, t)
                               * done_pair.get((pname, t.task_id), 0.0)
                               for t in domain.tasks
                               if t.task_id in active_now)
                    cap_rem[pname] = domain.platform_capacity(p) - held
                round_kv_headroom = min(cap_rem.values(), default=math.inf)
                pool = [t for _at, t in offered_timed] + \
                       [t for _at, t, _c in admission.pending]
                mean_q = (sum(domain.task_quality(t) for t in pool)
                          / len(pool)) if pool else 1.0
                alive_plats = [p for p in domain.platforms
                               if domain.platform_name(p) in alive_set]
                mean_res = (max(domain.resource_per_unit(p, pool[0])
                                for p in alive_plats) * mean_q
                            if pool and alive_plats else 0.0)
                admission.update_fleet(unit_rates, cap_rem, mean_q, mean_res)
                span = elapsed - round_t0
                admission.observe_utilisation(round_busy, span,
                                              len(alive_set))
                for at, t in offered_timed:
                    tq = domain.task_quality(t)
                    fits = any(
                        domain.resource_per_unit(p, t) * tq
                        <= domain.platform_capacity(p) for p in alive_plats)
                    rej = admission.offer(t, at, round_idx,
                                          cost_s=admission.cost_s(tq),
                                          fits=fits)
                    if rej is not None:
                        shed_events.append(rej.event)
                        round_shed += 1
                backlog_s = admission.cost_s(
                    sum(q for q in quotas.values() if q > 0))
                joined, timed_out = admission.admit(elapsed, round_idx,
                                                    backlog_s)
                for rej in timed_out:
                    shed_events.append(rej.event)
                    round_shed += 1
            arrived = [t for _at, t in joined]
            for at, t in joined:
                arr_t[t.task_id] = min(at, elapsed)
            if arrived:
                n_arrivals += len(arrived)
                domain.tasks.extend(arrived)
                if obs_on:
                    task_family.update(
                        {t.task_id: str(domain.launch_key(t))
                         for t in arrived})
                # benchmark newcomers on the survivors only; any pair left
                # unfitted (dead platform, or an outage firing mid-ladder
                # on a not-yet-dead one) gets an unreachable placeholder so
                # the model matrices stay total — those rows never reach a
                # solver
                survivors = [p for p in domain.platforms
                             if alive[domain.platform_name(p)]]
                need_char = arrived
                if cfg.adopt_family_models:
                    # trace-scale arrival counts cannot afford a benchmark
                    # ladder per arrival: same-family newcomers inherit a
                    # donor's fitted models; only true orphans benchmark
                    need_char = sched.adopt_models(arrived,
                                                   platforms=survivors)
                if need_char:
                    sched.characterise_tasks(need_char, mode=mode,
                                             platforms=survivors,
                                             **(characterise_kw or {}))
                for t in arrived:
                    for p in domain.platforms:
                        key = (domain.platform_name(p), t.task_id)
                        if key not in sched.models:
                            sched.models[key] = _UnreachableModel()
                # the model table is total again — rebuild the matrices now
                # (characterise_tasks deferred it); the patch path has no
                # refit to do this later
                sched._delta, sched._gamma = sched.model_matrices()
                for key, recs in sched.characterise_records.items():
                    windows.setdefault(key, deque(recs, maxlen=cfg.refit_window))
                # incumbent gains zero columns for the newcomers; the
                # restricted warm start falls back to uniform shares there
                A_full = np.pad(A_full,
                                ((0, 0), (0, len(domain.tasks) - A_full.shape[1])))

            # -- brownout guardrail: walk the degradation ladder when the
            # recent guardrail quantile breaches the SLO, restore a rung
            # when pressure clears (hysteresis via enter/exit ratios).
            # Deepening waits for fresh completions so one bad window does
            # not ratchet straight to the bottom rung.
            brown_changed = False
            if (slo_tracker is not None and cfg.degrade_steps
                    and cfg.slo is not None):
                recent = slo_tracker.recent_quantile()
                if recent is not None:
                    tgt = cfg.slo.target_s
                    if (recent > tgt * cfg.slo.enter_ratio
                            and brown_rung < len(cfg.degrade_steps)
                            and completions > 0):
                        brownout_transitions.append(BrownoutTransition(
                            round=round_idx, at=elapsed,
                            rung_from=brown_rung, rung_to=brown_rung + 1,
                            direction="deepen", observed=recent,
                            target_s=tgt))
                        brown_rung += 1
                        brown_changed = True
                        tracer.instant("brownout:deepen", track="online",
                                       cat="brownout", rung=brown_rung,
                                       round=round_idx)
                    elif recent < tgt * cfg.slo.exit_ratio and brown_rung > 0:
                        brownout_transitions.append(BrownoutTransition(
                            round=round_idx, at=elapsed,
                            rung_from=brown_rung, rung_to=brown_rung - 1,
                            direction="restore", observed=recent,
                            target_s=tgt))
                        brown_rung -= 1
                        brown_changed = True
                        tracer.instant("brownout:restore", track="online",
                                       cat="brownout", rung=brown_rung,
                                       round=round_idx)

            drifted = detector.drifted(alive)
            tail_drifted = tail.drifted(alive) if tail is not None else ()
            outcome = None
            resolved = False
            if (drifted or tail_drifted or newly_dead or arrived or revived
                    or brown_changed):
                # arrivals-only rounds take the O(k) incremental path: no
                # drift means the old tasks' models are still right, so
                # the re-fit is skipped and only the k new columns solve —
                # the committed shares are the patch's fixed base
                patch_tids = None
                if (cfg.patch_arrivals and arrived
                        and not (drifted or tail_drifted or newly_dead
                                 or revived or brown_changed)):
                    patch_tids = {t.task_id for t in arrived}
                else:
                    self._heal_unreachable(alive, mode, characterise_kw)
                    # only the median detector's verdict re-projects stale
                    # windows — a blown tail with a quiet median means the
                    # *spread* changed, not the level
                    with tracer.span("refit", track="online", cat="refit",
                                     round=round_idx,
                                     drifted=sorted(drifted)):
                        self._refit(windows, detector, drifted, alive,
                                    solve_models)
                    n_refits += 1
                active_tids = ({tid for (_pn, tid), q in quotas.items()
                                if q > 0}
                               | {t.task_id for t in arrived})
                solve_t0 = time.perf_counter()
                # a revived platform has zero share in the incumbent by
                # construction, so the warm-start shortcut would wave the
                # old allocation through and the re-admitted platform
                # would never see work again — force a real solve.
                # The effective rung is the deeper of the monotone
                # (capacity/deadline) rung and the reversible brownout rung.
                eff_rung = max(rung, brown_rung)
                with tracer.span("resolve", track="online", cat="solve",
                                 round=round_idx, rung=eff_rung,
                                 patch=patch_tids is not None):
                    alloc2, A2, quotas2, solved_rung = self._solve_degraded(
                        quality, eff_rung, method, solver_kw, alive, done,
                        incumbent_A=None if revived else A_full,
                        elapsed=plat_lat,
                        done_pair=done_pair, active_tids=active_tids,
                        round_idx=round_idx, degradations=degradations,
                        patch_tids=patch_tids)
                if obs_on and alloc2 is not None:
                    lift_solver_phases(
                        tracer, alloc2.meta, tracer.now(),
                        label=f"{alloc2.solver or method}[r{round_idx}]")
                if solved_rung > eff_rung:
                    # forced (capacity/deadline) degradation stays monotone
                    rung = solved_rung
                dt = time.perf_counter() - solve_t0
                resolve_wall += dt
                solve_wall += dt
                if alloc2 is not None:
                    alloc, A_full, quotas = alloc2, A2, quotas2
                    incr = alloc.meta.get("incremental")
                    if incr == "patched":
                        outcome = "patched"
                        n_patched += 1
                    elif incr == "full_fallback":
                        outcome = "patch-fallback"
                    else:
                        outcome = alloc.meta.get("warm_start", "solved")
                    resolved = True
                    n_solves += 1
                    solve_metas.append(dict(alloc.meta))
                    if outcome == "skipped":
                        n_skipped += 1
                    else:
                        n_resolves += 1
                else:
                    # the re-fitted models say every task is already served
                    quotas = {}
                solve_models = dict(sched.models)
                detector.reset()
                if tail is not None:
                    tail.reset()

            brown_occupancy[brown_rung] = brown_occupancy.get(brown_rung, 0) + 1
            rounds.append(RoundLog(
                round=round_idx, dispatched_units=dispatched,
                drifted=drifted, failed=tuple(failed), arrivals=len(arrived),
                resolved=resolved, solve_outcome=outcome,
                revived=tuple(revived),
                tail_drifted=tail_drifted,
                offered=len(offered_timed),
                shed=round_shed,
                queue_depth=admission.queue_depth if admission else 0,
                backlog_units=float(sum(q for q in quotas.values() if q > 0)),
                brownout_rung=brown_rung,
                completions=completions,
                t=max(plat_lat.values(), default=0.0),
                kv_headroom=round_kv_headroom))
            if obs_on:
                # the round span is added retroactively: everything inside
                # it (dispatch, probes, re-solves) already traced itself,
                # so only the enclosing interval is recorded here
                tracer.add_span(
                    f"round[{round_idx}]", "online", round_wall_t0,
                    tracer.now(), cat="online",
                    args={"resolved": resolved, "arrivals": len(arrived),
                          "shed": round_shed, "completions": completions,
                          "brownout_rung": brown_rung,
                          "drifted": sorted(drifted)})
                obs_metrics.gauge("online.brownout_rung").set(brown_rung)
                obs_metrics.counter("admission.shed").inc(round_shed)

        else:
            if any(q > 0 for q in quotas.values()) and not cfg.open_loop:
                # open-loop runs are horizon-truncated, not drained: hitting
                # the round cap with work in flight just ends the trace
                raise RuntimeError(
                    f"online run exceeded max_rounds={cfg.max_rounds} with "
                    f"work remaining — no progress on "
                    f"{sorted(k for k, q in quotas.items() if q > 0)}")

        # summarise against the final (possibly degraded) quality targets —
        # predicted CI / requested tokens must reflect what the run was
        # actually asked to deliver after the ladder stepped down
        problem = sched.problem(
            self._effective_quality(quality, max(rung, brown_rung)))
        summary = domain.summarise(all_records, problem)
        measured = max(plat_lat.values(), default=0.0)
        if obs_on:
            # whole-run accountability: the *initial* predicted makespan vs
            # what the adaptive run actually measured (same inf-on-zero
            # convention as OnlineReport.makespan_error), plus delivered
            # accuracy when the domain reports it
            ledger.observe("makespan", "*", "-", -1, predicted0, measured)
            measured_ci = summary.get("measured_ci") \
                if isinstance(summary, dict) else None
            if isinstance(measured_ci, dict):
                for j, t in enumerate(domain.tasks):
                    m = measured_ci.get(t.task_id)
                    if m is not None:
                        ledger.observe("accuracy", "*",
                                       task_family.get(t.task_id, "?"), -1,
                                       float(problem.c[j]), float(m))
            obs_metrics.counter("online.rounds").inc(len(rounds))
            obs_metrics.counter("online.resolves").inc(n_resolves)
            obs_metrics.counter("online.refits").inc(n_refits)
            obs_metrics.counter("runtime.records").inc(len(all_records))
            obs_metrics.counter("runtime.faults").inc(len(fault_events))
            obs_metrics.counter("runtime.retries").inc(
                count_retries(fault_events))
        return OnlineReport(
            allocation=alloc,
            predicted_makespan=predicted0,
            measured_makespan=measured,
            platform_latencies=plat_lat,
            records=all_records,
            summary=summary,
            rounds=rounds,
            n_solves=n_solves,
            n_resolves=n_resolves,
            n_skipped=n_skipped,
            n_refits=n_refits,
            solve_wall_s=solve_wall,
            resolve_wall_s=resolve_wall,
            dead_platforms=tuple(sorted(pn for pn, ok in alive.items() if not ok)),
            arrivals=n_arrivals,
            platform_wall_s=plat_wall,
            wall_s=time.perf_counter() - t_run,
            mode=sched._executor(mode).mode,
            fault_events=fault_events,
            degradations=degradations,
            breaker_transitions=list(breaker.transitions),
            n_retries=count_retries(fault_events),
            n_probes=n_probes,
            recovered_platforms=tuple(sorted(recovered)),
            n_patched=n_patched,
            solve_metas=solve_metas,
            shed_events=shed_events,
            brownout_transitions=brownout_transitions,
            n_offered=admission.n_offered if admission else n_arrivals,
            n_shed=admission.n_shed if admission else 0,
            brownout_rung=brown_rung,
            brownout_occupancy=brown_occupancy,
            slo=slo_tracker.snapshot() if slo_tracker else None,
            task_metrics=task_metrics,
        )
