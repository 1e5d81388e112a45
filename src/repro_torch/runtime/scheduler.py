"""The domain-agnostic scheduler: one back-end for every metric-modelled
domain (paper Fig. 1; companion work arXiv:1408.4965).

    domain = PricingDomain(tasks, platforms)        # or LMServingDomain(...)
    sched = Scheduler(domain)
    sched.characterise()                            # online benchmarking, (2)
    alloc = sched.allocate(quality, method="milp")  # trade-off selection, (3-4)
    report = sched.execute(alloc, quality)          # evaluation, (5)

The scheduler owns everything that is *not* domain knowledge: building the
(delta, gamma) model matrices, the :class:`AllocationProblem`, solver
dispatch (heuristic / ML / MILP from :mod:`repro_torch.core`, reused unchanged),
converting allocation shares back into per-platform work via the domain's
quality->work inversion, batched dispatch per launch group — overlapped
across platforms by the :class:`repro_torch.runtime.Executor` so the measured
makespan is the max over concurrently running platforms, not a serial
sum — and the predicted-vs-measured makespan report (the paper's
Figs 8 & 10 quantities).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Hashable, Sequence

import numpy as np

from repro_torch.core import (
    Allocation,
    AllocationProblem,
    SUPPORT_ATOL,
    clustered_allocation,
    makespan,
    milp_allocation,
    ml_allocation,
    proportional_allocation,
)
from repro_torch.obs import (
    PredictionLedger,
    lift_solver_phases,
    metrics as obs_metrics,
    resolve_tracer,
)
from .domain import Domain, RunRecordLike
from .executor import Executor
from .faults import (
    DispatchFault,
    FaultEvent,
    JobCancelled,
    RetryPolicy,
    check_records,
    fault_kind,
)

__all__ = ["Scheduler", "RuntimeReport", "DispatchResult", "SOLVERS"]

#: The three allocation approaches of §4.3, shared by every domain.
SOLVERS: dict[str, Callable[..., Allocation]] = {
    "heuristic": lambda p, **kw: proportional_allocation(p),
    "ml": lambda p, **kw: ml_allocation(p, **kw),
    "milp": lambda p, **kw: milp_allocation(p, **kw),
}


@dataclasses.dataclass(frozen=True)
class DispatchResult:
    """One platform's slice of a dispatch plan: the records it produced,
    its own wall clock, and — when the caller opted into partial dispatch
    via ``catch`` — the exception that cut it short (records up to the
    failure are kept, so remaining-work accounting stays exact)."""

    records: list
    wall_s: float
    error: BaseException | None = None
    #: fault-layer audit trail: one event per fault the retry loop handled
    faults: tuple[FaultEvent, ...] = ()


@dataclasses.dataclass
class RuntimeReport:
    """Outcome of one execute pass: makespans + domain summary.

    ``platform_latencies`` sums each platform's per-record latencies (real
    wall clock for local platforms, replayed latency for simulated ones);
    ``platform_wall_s`` is each platform's own host wall clock around its
    dispatches, and ``wall_s`` the whole pass — under concurrent dispatch
    ``wall_s`` tracks ``max`` of the per-platform clocks rather than their
    sum, which is the paper's makespan semantics.
    """

    allocation: Allocation
    predicted_makespan: float
    measured_makespan: float
    platform_latencies: dict[str, float]
    records: list[RunRecordLike]
    summary: dict = dataclasses.field(default_factory=dict)
    platform_wall_s: dict[str, float] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    mode: str = "sequential"
    #: fault-layer audit trails (see repro_torch.runtime.faults): every fault the
    #: retry loop handled, and every quality-target relaxation the online
    #: loop's graceful degradation applied.
    fault_events: list = dataclasses.field(default_factory=list)
    degradations: list = dataclasses.field(default_factory=list)

    @property
    def solver_meta(self) -> dict:
        """Per-phase solver telemetry: build_s / solve_s (/ polish_s),
        n_vars / n_constraints, and — for clustered solves — how many
        super-tasks the solver actually saw (clustered_from / n_clusters)."""
        return dict(self.allocation.meta)

    @property
    def makespan_error(self) -> float:
        if self.measured_makespan == 0:
            # an allocation that dispatched no work has no measurable
            # makespan; inf (not ZeroDivisionError) marks the model as
            # unassessable
            return math.inf
        return abs(self.predicted_makespan - self.measured_makespan) / self.measured_makespan


class Scheduler:
    """Runs one domain's workload through the shared allocation back-end.

    ``mode`` selects the dispatch strategy for characterise *and* execute:
    ``"concurrent"`` (default) overlaps platforms on an :class:`Executor`
    thread pool so measured makespan reflects true concurrency;
    ``"sequential"`` replays the legacy serial loop for A/B comparisons.
    Both produce identical records for deterministic platforms. Every
    entry point also takes a per-call ``mode`` override.
    """

    def __init__(self, domain: Domain, mode: str = "concurrent",
                 max_workers: int | None = None, trace=None):
        self.domain = domain
        #: span tracer (repro_torch.obs): ``trace`` may be a Tracer, True/False,
        #: or None to follow the process default (``REPRO_TRACE=1``). A
        #: disabled tracer makes every instrumentation site a no-op, which
        #: is what keeps instrumented overhead off the hot path by default.
        self.tracer = resolve_tracer(trace)
        #: prediction-accountability ledger (repro_torch.obs): populated when
        #: tracing is enabled — each execute pairs predicted vs measured
        #: latency/makespan/accuracy per (platform, task family, round).
        self.ledger = PredictionLedger()
        self.executor = Executor(mode=mode, max_workers=max_workers,
                                 tracer=self.tracer)
        self.models: dict[tuple[str, int], Any] | None = None
        #: raw benchmark records per (platform, task_id) from the last
        #: characterise pass — the online loop's re-fit windows start from
        #: these, and runtime.records can persist them to JSONL.
        self.characterise_records: dict[tuple[str, int], list[RunRecordLike]] = {}
        #: bumped whenever the fitted models (and hence the matrices)
        #: change — characterise, incremental characterise, refit. Lets
        #: callers cache anything derived from the models (the online
        #: loop's per-pair work totals) and invalidate exactly on change.
        self.models_version: int = 0
        self._delta: np.ndarray | None = None
        self._gamma: np.ndarray | None = None

    @property
    def mode(self) -> str:
        return self.executor.mode

    def _executor(self, mode: str | None) -> Executor:
        if mode is None:
            return self.executor
        return Executor(mode=mode, max_workers=self.executor.max_workers,
                        tracer=self.tracer)

    @property
    def tasks(self) -> list:
        return self.domain.tasks

    @property
    def platforms(self) -> list:
        return self.domain.platforms

    # -- step 2: characterisation ------------------------------------------

    def characterise(self, seed: int = 1, mode: str | None = None, **kw) -> None:
        sink: dict[tuple[str, int], list[RunRecordLike]] = {}
        with self.tracer.span("characterise", track="scheduler",
                              cat="characterise",
                              n_platforms=len(self.platforms),
                              n_tasks=len(self.tasks)):
            self.models = self.domain.characterise(
                seed=seed, executor=self._executor(mode), record_sink=sink,
                **kw)
        self.characterise_records = sink
        self.models_version += 1
        self._delta, self._gamma = self.model_matrices()

    def characterise_tasks(self, tasks: Sequence[Any], seed: int = 1,
                           mode: str | None = None,
                           platforms: Sequence[Any] | None = None,
                           **kw) -> None:
        """Incrementally characterise tasks that joined mid-workload.

        The tasks must already be in ``domain.tasks``; only the new
        (platform, task) pairs are benchmarked — restricted to
        ``platforms`` when given (the online loop skips platforms it has
        declared dead) — their models and records merged into the existing
        ones, and the matrices rebuilt. The caller is responsible for
        filling models of any skipped (platform, task) pairs before the
        matrices are consumed."""
        assert self.models is not None, "characterise() first"
        sink: dict[tuple[str, int], list[RunRecordLike]] = {}
        fitted = self.domain.characterise(
            seed=seed, executor=self._executor(mode), tasks=tasks,
            platforms=platforms, record_sink=sink, skip_unavailable=True,
            **kw)
        self.models.update(fitted)
        self.characterise_records.update(sink)
        self.models_version += 1
        if platforms is None:
            self._delta, self._gamma = self.model_matrices()

    def adopt_models(self, tasks: Sequence[Any],
                     platforms: Sequence[Any] | None = None) -> list:
        """Adopt fitted models for arrivals from same-family incumbents.

        Open-loop traces deliver hundreds of arrivals from a handful of
        request families; benchmarking every one from scratch
        (``characterise_tasks``) would cost more than serving it.  A task
        whose launch key matches an already-characterised *donor* task
        shares the donor's per-platform metric models (the launch key is
        the compile unit — same family, same eq. 7 coefficients) and gets
        the donor's characterise records re-tagged under its own id so
        offline replay still fits the same models.  Returns the orphans —
        tasks with no same-family donor — which the caller must
        characterise for real.  Matrices are *not* rebuilt here; callers
        batch that with their placeholder fill (same contract as
        ``characterise_tasks(platforms=...)``).
        """
        assert self.models is not None, "characterise() first"
        sweep = self.platforms if platforms is None else list(platforms)
        donors: dict[Hashable, int] = {}
        new_ids = {t.task_id for t in tasks}
        for t in self.tasks:
            if t.task_id not in new_ids:
                donors.setdefault(self.domain.launch_key(t), t.task_id)
        orphans: list = []
        adopted = False
        for t in tasks:
            donor_id = donors.get(self.domain.launch_key(t))
            if donor_id is None:
                orphans.append(t)
                continue
            for p in sweep:
                pname = self.domain.platform_name(p)
                model = self.models.get((pname, donor_id))
                if model is None:
                    continue
                self.models[(pname, t.task_id)] = model
                recs = self.characterise_records.get((pname, donor_id), [])
                self.characterise_records[(pname, t.task_id)] = [
                    dataclasses.replace(r, task_id=t.task_id) for r in recs]
            adopted = True
        if adopted:
            self.models_version += 1
        return orphans

    def refit(self, windows: dict[tuple[str, int], Sequence[RunRecordLike]]) -> None:
        """Fold execute-time records back into the metric models.

        Execute records are the same shape characterisation consumes (the
        paper's premise, §2 Fig. 1), so re-fitting is just
        ``Domain.fit_models`` over each pair's accumulated window; the
        (delta, gamma) matrices are rebuilt so the next ``problem()`` sees
        the drifted coefficients."""
        assert self.models is not None, "characterise() first"
        for key, recs in windows.items():
            if recs:
                self.models[key] = self.domain.fit_models(list(recs))
        self.models_version += 1
        self._delta, self._gamma = self.model_matrices()

    def model_matrices(self) -> tuple[np.ndarray, np.ndarray]:
        """(delta, gamma) matrices ordered [platform, task]."""
        assert self.models is not None, "characterise() first"
        mu, tau = len(self.platforms), len(self.tasks)
        delta = np.zeros((mu, tau))
        gamma = np.zeros((mu, tau))
        for i, p in enumerate(self.platforms):
            pname = self.domain.platform_name(p)
            for j, t in enumerate(self.tasks):
                d, g = self.domain.model_coefficients(self.models[(pname, t.task_id)])
                delta[i, j] = d
                gamma[i, j] = g
        return delta, gamma

    # -- steps 3-4: allocation ---------------------------------------------

    def quality_vector(self, quality=None) -> np.ndarray:
        if quality is None:
            quality = self.domain.default_quality()
            if quality is None:
                raise ValueError(
                    f"domain {self.domain.name!r} has no default quality; "
                    "pass one explicitly")
        return np.broadcast_to(np.asarray(quality, dtype=np.float64),
                               (len(self.tasks),)).copy()

    def capacity_matrices(self, quality=None) -> tuple[np.ndarray, np.ndarray] | None:
        """(resource, capacity) for the domain's second constraint
        dimension, or None when the domain declares none.

        ``resource[i, j]`` is what platform i holds while serving *all* of
        task j at the requested quality: the domain's per-work-unit
        resource times its quality->work inversion under platform i's own
        fitted model (KV bytes/token x tokens, bytes/path x paths, ...).
        """
        assert self.models is not None, "characterise() first"
        c = self.quality_vector(quality)
        mu, tau = len(self.platforms), len(self.tasks)
        resource = np.zeros((mu, tau))
        capacity = np.zeros(mu)
        for i, p in enumerate(self.platforms):
            pname = self.domain.platform_name(p)
            capacity[i] = self.domain.platform_capacity(p)
            for j, t in enumerate(self.tasks):
                per_unit = self.domain.resource_per_unit(p, t)
                if per_unit:
                    model = self.models[(pname, t.task_id)]
                    resource[i, j] = per_unit * self.domain.work_units(
                        model, float(c[j]))
        if not resource.any() or not np.isfinite(capacity).any():
            return None  # dimension inert: keep the problem capacity-free
        return resource, capacity

    def problem(self, quality=None) -> AllocationProblem:
        if self._delta is None:
            raise RuntimeError("characterise() first")
        cap = self.capacity_matrices(quality)
        return AllocationProblem(delta=self._delta, gamma=self._gamma,
                                 c=self.quality_vector(quality),
                                 reduction=self.domain.reduction,
                                 resource=None if cap is None else cap[0],
                                 capacity=None if cap is None else cap[1])

    def allocate(self, quality=None, method: str = "milp", *,
                 cluster: bool = False, cluster_rtol: float = 0.0,
                 **solver_kw) -> Allocation:
        """Solve the allocation; ``cluster=True`` routes through task-family
        clustering (:func:`repro_torch.core.clustered_allocation`) so fleets with
        many structurally identical tasks solve at family count, not task
        count. ``cluster_rtol`` merges near-identical families at bounded
        relative error."""
        problem = self.problem(quality)
        with self.tracer.span("allocate", track="scheduler", cat="solve",
                              method=method, cluster=cluster) as sp:
            if cluster:
                alloc = clustered_allocation(problem, method,
                                             rtol=cluster_rtol, **solver_kw)
            else:
                alloc = SOLVERS[method](problem, **solver_kw)
        if self.tracer.enabled:
            # lift the solver's per-phase meta timings into real
            # spans on the solver track, ending where allocate ended
            lift_solver_phases(self.tracer, alloc.meta, sp.t1,
                               label=f"{alloc.solver or method}")
            solve_s = alloc.meta.get("solve_s")
            if solve_s:
                obs_metrics.histogram("solver.solve_s").observe(solve_s)
        return alloc

    # -- step 5: execution --------------------------------------------------

    def shards(self, allocation: Allocation,
               problem: AllocationProblem) -> list[tuple[Any, list[tuple[Any, int]]]]:
        """Turn allocation shares into per-platform (task, units) launch
        groups via the domain's quality->work inversion."""
        assert self.models is not None
        A = allocation.A
        out = []
        for i, p in enumerate(self.platforms):
            pname = self.domain.platform_name(p)
            groups: dict = {}
            for j, t in enumerate(self.tasks):
                share = A[i, j]
                if share <= SUPPORT_ATOL:
                    continue
                model = self.models[(pname, t.task_id)]
                total = self.domain.work_units(model, float(problem.c[j]))
                units = max(int(np.ceil(share * total)), self.domain.min_chunk)
                groups.setdefault(self.domain.launch_key(t), []).append((t, units))
            out.append((p, list(groups.values())))
        return out

    def dispatch_plan(
        self,
        plan: Sequence[tuple[Any, list[list[tuple[Any, int]]]]],
        seed: int | Callable[[str, Hashable], int] = 3,
        mode: str | None = None,
        catch: tuple[type[BaseException], ...] = (),
        retry: RetryPolicy | None = None,
        round_idx: int = 0,
        cancel: threading.Event | None = None,
    ) -> tuple[list[DispatchResult], float]:
        """Dispatch an explicit per-platform plan; the partial-dispatch hook.

        ``plan`` is a list of (platform, launch groups) where each group is
        a list of (task, units) — the shape :meth:`shards` produces, but
        callers (the online loop) may hand any tranche of the workload.
        One job per platform: its groups run back-to-back on one thread
        (they contend for the same device anyway) while distinct platforms
        overlap, each timed by its own wall clock.

        ``seed`` is either one int for every launch (the execute path) or a
        callable ``(platform_name, launch_key) -> int`` so round-based
        callers can derive per-(platform, group, round) seeds via
        :func:`repro_torch.runtime.domain.seed_for` — what keeps concurrent and
        sequential online runs bitwise-identical.

        ``retry`` arms the fault layer: retryable faults (transient blips,
        corrupt results — see :class:`~repro_torch.runtime.faults.RetryPolicy`)
        re-dispatch the unsalvaged remainder of the failing group with
        deterministic backoff, bounded per dispatch by ``max_attempts`` and
        per (platform, round) by ``budget``; returned records are
        sanity-checked (:func:`~repro_torch.runtime.faults.check_records`, bad
        records discarded and their tasks re-dispatched); every handled
        fault is logged into :attr:`DispatchResult.faults` with the virtual
        time it burned (platform clock delta minus salvaged record
        latencies) so makespan accounting charges storms honestly.

        Exception types in ``catch`` (e.g. ``PlatformOutage``) — and
        retry-exhausted retryable faults when they match — are captured per
        platform into :attr:`DispatchResult.error` with the records
        produced before the failure kept; anything else propagates.
        ``cancel``, when set mid-round, skips the platform's not-yet-started
        launch groups (:class:`~repro_torch.runtime.faults.JobCancelled`).
        """
        executor = self._executor(mode)
        catchable = (DispatchFault,) + tuple(catch)
        tracer = self.tracer

        def run_platform(shard) -> DispatchResult:
            p, groups = shard
            pname = self.domain.platform_name(p)
            # the executor opened this platform's "dispatch" span on the
            # current thread (span_of below); annotate it with the round,
            # the parity-safe virtual clock endpoints, and the counts
            dsp = tracer.current()
            dsp.args["round"] = round_idx
            v_start = getattr(p, "clock", None)
            recs: list[RunRecordLike] = []
            faults: list[FaultEvent] = []
            error: BaseException | None = None
            budget = retry.budget if retry is not None else 0
            for group in groups:
                if cancel is not None and cancel.is_set():
                    error = JobCancelled(
                        f"{pname}: remaining launch groups cancelled")
                    break
                gtasks = [t for t, _ in group]
                group_seed = (seed(pname, self.domain.launch_key(gtasks[0]))
                              if callable(seed) else seed)
                with tracer.span("launch", track=pname, cat="dispatch",
                                 tasks=len(group),
                                 units=sum(u for _, u in group)) as lsp:
                    gv0 = getattr(p, "clock", None)
                    pending = list(group)
                    attempt = 1
                    while pending:
                        clock0 = getattr(p, "clock", None)
                        try:
                            new = self.domain.dispatch_batch(
                                p, [t for t, _ in pending],
                                [u for _, u in pending], seed=group_seed)
                            if retry is not None:
                                check_records(new)
                            recs.extend(new)
                            break
                        except catchable as exc:
                            # a batch failing mid-way may carry the records
                            # it completed first (DispatchFault.records) —
                            # that work already ran, so keep it in the
                            # accounting
                            salvaged = list(getattr(exc, "records", []))
                            recs.extend(salvaged)
                            burned = 0.0
                            if clock0 is not None:
                                burned = max(
                                    getattr(p, "clock", clock0) - clock0
                                    - sum(r.latency for r in salvaged), 0.0)
                            kind = fault_kind(exc)
                            if (retry is not None and retry.retryable(exc)
                                    and attempt < retry.max_attempts
                                    and budget > 0):
                                budget -= 1
                                faults.append(FaultEvent(
                                    pname, -1, round_idx, kind, "retried",
                                    attempt, burned))
                                tracer.instant(
                                    f"fault:{kind}", track=pname,
                                    cat="fault", action="retried",
                                    attempt=attempt, round=round_idx,
                                    burned=burned)
                                done = {r.task_id for r in salvaged}
                                pending = [(t, u) for t, u in pending
                                           if t.task_id not in done]
                                pause = retry.delay(
                                    0 if callable(seed) else seed,
                                    pname, round_idx, attempt)
                                if pause > 0.0:
                                    time.sleep(pause)
                                attempt += 1
                                continue
                            faults.append(FaultEvent(
                                pname, -1, round_idx, kind, "exhausted",
                                attempt, burned))
                            tracer.instant(
                                f"fault:{kind}", track=pname, cat="fault",
                                action="exhausted", attempt=attempt,
                                round=round_idx, burned=burned)
                            if isinstance(exc, catch):
                                error = exc
                                break
                            raise
                    if gv0 is not None:
                        lsp.set_virtual(gv0, getattr(p, "clock", gv0))
                if error is not None:
                    break
            if v_start is not None:
                dsp.set_virtual(v_start, getattr(p, "clock", v_start))
            dsp.args["n_records"] = len(recs)
            dsp.args["n_faults"] = len(faults)
            return DispatchResult(records=recs, wall_s=0.0, error=error,
                                  faults=tuple(faults))

        t0 = time.perf_counter()
        timed = executor.map_timed(
            run_platform, plan,
            span_of=lambda shard: ("dispatch",
                                   self.domain.platform_name(shard[0])))
        wall_s = time.perf_counter() - t0
        results = [dataclasses.replace(t.value, wall_s=t.wall_s) for t in timed]
        return results, wall_s

    def execute(self, allocation: Allocation, quality=None, seed: int = 3,
                mode: str | None = None,
                retry: RetryPolicy | None = None) -> RuntimeReport:
        """Dispatch each platform's launch groups; concurrent by default.

        Records are collected in platform-major order — identical to the
        sequential loop's (see :meth:`dispatch_plan`). ``retry`` arms the
        fault layer: handled faults land in ``report.fault_events`` and
        their burned virtual time inflates the faulty platform's latency
        (a storm honestly costs makespan)."""
        problem = self.problem(quality)
        shards = self.shards(allocation, problem)
        with self.tracer.span("execute", track="scheduler", cat="execute",
                              n_platforms=len(shards)):
            results, wall_s = self.dispatch_plan(shards, seed=seed,
                                                 mode=mode, retry=retry)

        records: list[RunRecordLike] = []
        fault_events: list[FaultEvent] = []
        plat_lat = {self.domain.platform_name(p): 0.0 for p in self.platforms}
        plat_wall: dict[str, float] = {}
        for (p, _groups), result in zip(shards, results):
            pname = self.domain.platform_name(p)
            plat_wall[pname] = result.wall_s
            for rec in result.records:
                records.append(rec)
                plat_lat[pname] += rec.latency
            for ev in result.faults:
                fault_events.append(ev)
                plat_lat[pname] += ev.latency
        report = RuntimeReport(
            allocation=allocation,
            predicted_makespan=makespan(allocation.A, problem),
            measured_makespan=max(plat_lat.values(), default=0.0),
            platform_latencies=plat_lat,
            records=records,
            summary=self.domain.summarise(records, problem),
            platform_wall_s=plat_wall,
            wall_s=wall_s,
            mode=self._executor(mode).mode,
            fault_events=fault_events,
        )
        if self.tracer.enabled:
            self._account(report, problem)
        return report

    def _account(self, report: RuntimeReport,
                 problem: AllocationProblem) -> None:
        """Pair this execute's predictions with their measurements in the
        ledger (and bump the process metrics) — only on instrumented runs,
        so the uninstrumented hot path never pays for it."""
        family = {t.task_id: str(self.domain.launch_key(t))
                  for t in self.tasks}
        # the ledger's makespan entry uses the same zero-measured -> inf
        # convention as RuntimeReport.makespan_error
        self.ledger.observe("makespan", "*", "-", -1,
                            report.predicted_makespan,
                            report.measured_makespan)
        lat_hist = obs_metrics.histogram("runtime.record_latency_s")
        for rec in report.records:
            model = self.models.get((rec.platform, rec.task_id))
            if model is not None:
                predicted = self.domain.predicted_latency(
                    model, self.domain.record_units(rec))
                self.ledger.observe("latency", rec.platform,
                                    family.get(rec.task_id, "?"), -1,
                                    predicted, rec.latency)
            lat_hist.observe(rec.latency)
        measured_ci = (report.summary or {}).get("measured_ci")
        if isinstance(measured_ci, dict):
            for j, t in enumerate(self.tasks):
                m = measured_ci.get(t.task_id)
                if m is not None:
                    self.ledger.observe("accuracy", "*",
                                        family.get(t.task_id, "?"), -1,
                                        float(problem.c[j]), float(m))
        obs_metrics.counter("runtime.records").inc(len(report.records))
        obs_metrics.counter("runtime.faults").inc(len(report.fault_events))

    # -- convenience: the whole Fig. 1 flow --------------------------------

    def run(self, quality=None, method: str = "milp", seed: int = 3,
            characterise_kw: dict | None = None, mode: str | None = None,
            **solver_kw) -> RuntimeReport:
        """characterise (if needed) -> allocate -> execute in one call."""
        if self.models is None:
            self.characterise(mode=mode, **(characterise_kw or {}))
        alloc = self.allocate(quality, method=method, **solver_kw)
        return self.execute(alloc, quality, seed=seed, mode=mode)
