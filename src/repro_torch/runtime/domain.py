"""The ``Domain`` protocol — what a workload must provide to be allocated.

The paper's workflow (characterise -> allocate -> execute, Fig. 1) is not
specific to derivatives pricing: any domain whose tasks are *divisible*
(eq. 5) and whose run-time behaviour on a platform follows small parametric
metric models (§3.1) can ride the same back-end. The companion work
(arXiv:1408.4965) frames exactly this split: domain front-ends supply
metric models and an execution hook; a shared runtime owns benchmarking,
the allocation program and the evaluation loop.

A concrete domain subclasses :class:`Domain` and provides

* a task container (anything with a ``task_id``) and a platform list
  (anything with a ``spec.name``),
* ``characterise_batch`` — online benchmarking of a launch group on one
  platform, returning one record list ("rung") per benchmark point,
* ``fit_models`` — the per-metric model fitters, turning one task's rung
  records into a model object exposing ``.combined`` (delta, gamma),
* ``work_units`` — the quality -> work inversion (paths for a CI, tokens
  for a generation length) used when shares are turned into launches,
* ``dispatch_batch`` — the execution hook, and
* ``reduction`` — the quality -> work-matrix map consumed by the solvers
  (inverse-square for MC estimators, linear for throughput domains).

Everything else — grouping, model matrices, the allocation program, solver
selection, the execute/report loop — lives in :class:`repro_torch.runtime.Scheduler`
and is shared verbatim by every domain.
"""
from __future__ import annotations

import abc
import dataclasses
import math
import zlib
from typing import Any, Hashable, Protocol, Sequence

import numpy as np

from repro_torch.core.allocation import mc_work_reduction
from .executor import Executor
from .faults import DispatchFault

__all__ = ["Domain", "MeshPlatformSpec", "PlatformSpec", "RunRecordLike",
           "seed_for"]


def seed_for(base_seed: int, platform_name: str, launch_key: Hashable,
             rung: int) -> int:
    """Deterministic benchmark seed for one (platform, launch group, rung).

    A stable hash (CRC32 — unlike ``hash()``, not randomised per process
    by PYTHONHASHSEED) of the identifying coordinates, so every record of
    a characterisation run is a pure function of *what* is being measured,
    never of dispatch order. This is what makes concurrent and sequential
    ladder climbs bitwise-identical regardless of thread interleaving —
    and replaces positional ``seed + i`` derivations, under which records
    depended on where in the loop a rung happened to sit.
    """
    key = f"{base_seed}|{platform_name}|{launch_key!r}|{rung}"
    return zlib.crc32(key.encode()) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """Static description of one execution platform (paper Table 2 row).

    ``gflops``/``rtt_ms`` are the two published characteristics the paper
    says determine beta and gamma respectively (§5.1.2); simulated
    platforms of any domain replay their latency model from them.
    ``mem_bytes`` is the device-memory budget backing the optional
    resource-capacity dimension (KV-cache bytes for LM serving); the
    default inf keeps platforms of capacity-free domains unconstrained.
    """

    name: str
    category: str        # CPU | GPU | FPGA
    device: str
    location: str
    gflops: float        # application performance (per device)
    rtt_ms: float        # network round-trip time
    mem_bytes: float = math.inf

    # Mesh-trivial view: a bare spec is a 1x1 mesh, so every consumer of
    # the effective characteristics (simulators, capacity hooks, latency
    # fitters) reads these uniformly and never branches on the subclass.

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """(data, model) mesh axes; a single device is (1, 1)."""
        return (1, 1)

    @property
    def n_devices(self) -> int:
        return self.mesh_shape[0] * self.mesh_shape[1]

    @property
    def model_parallel(self) -> int:
        return self.mesh_shape[1]

    @property
    def effective_gflops(self) -> float:
        """Aggregate throughput feeding eq. 7's beta (1/gflops slope)."""
        return self.gflops

    @property
    def effective_rtt_ms(self) -> float:
        """Per-dispatch constant feeding eq. 7's gamma."""
        return self.rtt_ms

    @property
    def total_mem_bytes(self) -> float:
        """Resource budget pooled across the whole platform."""
        return self.mem_bytes


@dataclasses.dataclass(frozen=True)
class MeshPlatformSpec(PlatformSpec):
    """A platform that is a *mesh* of identical devices, not one device.

    The allocator sees one row per (device kind x mesh shape): eq. 7's
    beta falls with tensor-parallel width — discounted by
    ``tp_efficiency``, since collectives and unshardable residue keep the
    speedup sublinear — while gamma picks up a per-hop collective cost on
    top of the network RTT. Memory (the KV capacity dimension) pools
    across every device in the mesh. ``gflops``/``rtt_ms``/``mem_bytes``
    stay *per-device* numbers so the same device kind can be quoted at
    several shapes from one datasheet row.
    """

    #: (data, model) axis sizes; model = tensor-parallel width.
    mesh_shape: tuple[int, int] = (1, 1)
    #: fraction of linear speedup each added model-parallel device yields.
    tp_efficiency: float = 0.85
    #: per-decode-step collective cost per model-parallel hop (ms).
    collective_ms: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "mesh_shape",
                           tuple(int(v) for v in self.mesh_shape))
        d, m = self.mesh_shape
        if d < 1 or m < 1:
            raise ValueError(f"mesh_shape must be >= (1, 1), got {self.mesh_shape}")
        if not 0.0 <= self.tp_efficiency <= 1.0:
            raise ValueError(f"tp_efficiency must be in [0, 1], got "
                             f"{self.tp_efficiency}")

    @property
    def tp_speedup(self) -> float:
        """Sublinear tensor-parallel throughput multiplier."""
        return 1.0 + self.tp_efficiency * (self.model_parallel - 1)

    @property
    def effective_gflops(self) -> float:
        return self.gflops * self.tp_speedup

    @property
    def effective_rtt_ms(self) -> float:
        return self.rtt_ms + self.collective_ms * (self.model_parallel - 1)

    @property
    def total_mem_bytes(self) -> float:
        return self.mem_bytes * self.n_devices


class RunRecordLike(Protocol):
    """What the scheduler needs from an execution record.

    Domains may carry extra fields (price, CI, token counts, ...) for
    their own ``fit_models``/``summarise`` hooks.
    """

    platform: str
    task_id: int
    latency: float


class Domain(abc.ABC):
    """Base class for metric-modelled domains; see module docstring."""

    #: registry name; subclasses override.
    name: str = "domain"
    #: quality -> work-matrix map handed to AllocationProblem.
    reduction = staticmethod(mc_work_reduction)
    #: smallest dispatchable work amount (paths, tokens, ...).
    min_chunk: int = 1

    def __init__(self, tasks: Sequence[Any], platforms: Sequence[Any]):
        self.tasks = list(tasks)
        self.platforms = list(platforms)

    # -- identity ----------------------------------------------------------

    def platform_name(self, platform) -> str:
        return platform.spec.name

    def launch_key(self, task) -> Hashable:
        """Compilation/launch grouping key; one group = one batched launch.

        Default: every task in its own group (no batching)."""
        return task.task_id

    def group_tasks(self, tasks: Sequence[Any]) -> list[tuple[Hashable, list[Any]]]:
        groups: dict[Hashable, list[Any]] = {}
        for t in tasks:
            groups.setdefault(self.launch_key(t), []).append(t)
        return list(groups.items())

    def default_quality(self) -> np.ndarray | None:
        """Per-task quality vector when the caller passes none.

        Domains whose tasks carry an intrinsic quality target (e.g. an LM
        request's generation length) override this; returning None makes
        the quality argument mandatory."""
        return None

    # -- characterisation (paper §3.1.4) -----------------------------------

    @abc.abstractmethod
    def characterise_batch(self, platform, tasks: Sequence[Any],
                           seed: int = 1, **kw) -> list[list[RunRecordLike]]:
        """Benchmark one launch group on one platform.

        Returns one record list per benchmark rung, each aligned with
        ``tasks``."""

    @abc.abstractmethod
    def fit_models(self, records: Sequence[RunRecordLike]):
        """Fit this domain's metric models from one task's rung records."""

    def characterise(self, seed: int = 1, executor: Executor | None = None,
                     tasks: Sequence[Any] | None = None,
                     platforms: Sequence[Any] | None = None,
                     record_sink: dict | None = None,
                     skip_unavailable: bool = False,
                     **kw) -> dict[tuple[str, int], Any]:
        """Benchmark every (platform, task) pair and fit its models.

        The generic pipeline: group tasks by launch key, then climb the
        ladders as one job *per platform* — concurrently when the executor
        says so, since ladders on distinct platforms share no state. A
        platform's launch groups climb serially inside their job (they
        contend for the same device; overlapping them would corrupt the
        wall-clock latencies the models are fitted from — the same
        granularity execute uses). Seeds must derive from each rung's
        coordinates (see :func:`seed_for`), never from loop position, so
        both modes produce identical records.

        ``tasks`` / ``platforms`` restrict the sweep to subsets (incremental
        characterisation of tasks arriving mid-workload, skipping platforms
        known to be down); ``record_sink`` collects the raw benchmark
        records per (platform, task_id) — the online loop seeds its re-fit
        windows from them, and they are the characterise half of the JSONL
        record persistence. Concurrent platform jobs write disjoint keys,
        so a plain dict is safe.

        ``skip_unavailable`` makes a platform raising a
        :class:`~repro_torch.runtime.faults.DispatchFault` (outage or transient
        blip) mid-benchmark contribute only the pairs it completed instead
        of failing the whole sweep — mid-run incremental characterisation
        is inherently fault-exposed; the caller fills the gaps."""
        groups = self.group_tasks(self.tasks if tasks is None else list(tasks))
        sweep = self.platforms if platforms is None else list(platforms)

        def climb(p) -> dict[tuple[str, int], Any]:
            fitted: dict[tuple[str, int], Any] = {}
            try:
                for _key, gtasks in groups:
                    rungs = self.characterise_batch(p, gtasks, seed=seed, **kw)
                    for k, t in enumerate(gtasks):
                        key = (self.platform_name(p), t.task_id)
                        recs = [rung[k] for rung in rungs]
                        fitted[key] = self.fit_models(recs)
                        if record_sink is not None:
                            record_sink[key] = recs
            except DispatchFault:
                if not skip_unavailable:
                    raise
            return fitted

        out: dict[tuple[str, int], Any] = {}
        for fitted in (executor or Executor(mode="sequential")).map(
                climb, sweep):
            out.update(fitted)  # job order == legacy platform-major order
        return out

    def model_coefficients(self, model) -> tuple[float, float]:
        """(delta, gamma) entries for the allocation matrices."""
        combined = model.combined
        return float(combined.delta), float(combined.gamma)

    def predicted_latency(self, model, units: float) -> float:
        """The latency the fitted model predicts for a shard of ``units``
        work — the reference the online drift detector compares measured
        latencies against. Default: the eq. 7 latency model every shipped
        domain carries as ``model.latency``."""
        return float(model.latency(units))

    def latency_params(self, model) -> tuple[float, float]:
        """(beta, gamma) of the model's latency component — the online
        tranche planner uses them to floor shard sizes so per-dispatch
        constants do not swamp high-RTT platforms under round-based
        dispatch."""
        return float(model.latency.beta), float(model.latency.gamma)

    # -- fault tolerance ----------------------------------------------------

    def degrade_quality(self, quality: float, step: float) -> float:
        """Relax one task's quality target by ``step`` along this domain's
        accuracy-for-latency trade-off (the paper's central asset): a CI
        domain loosens the target, a throughput domain shortens it. The
        online loop's graceful degradation walks its rung ladder through
        this hook when the surviving fleet cannot meet the original
        targets. ``step`` is cumulative from the *base* quality (rung 2 of
        ladder (0.25, 0.5) passes 0.5, not 0.25 twice). Default: no
        trade-off to exploit — the quality stands."""
        return quality

    def advance_platform(self, platform, elapsed: float) -> None:
        """Sync an *idle* platform's virtual clock to the workload's
        elapsed time. A platform sitting out rounds behind an open circuit
        breaker does not execute, but wall time still passes for it — on
        simulated platforms the virtual clock only advances with work, so
        without this sync a finite outage window would never end for a
        platform receiving only cheap probes. No-op for platforms with no
        virtual clock (real hardware lives on the host clock)."""
        clock = getattr(platform, "clock", None)
        if clock is not None:
            platform.clock = max(clock, elapsed)

    # -- SLO / overload control (optional) ---------------------------------

    def record_ttft(self, record: RunRecordLike, end_t: float) -> float:
        """Virtual time at which a record's *first output* became visible,
        given the virtual time ``end_t`` at which the record finished.

        Tail-latency accounting (TTFT percentiles) asks when a task first
        produced output, which for atomic records is simply when they
        finished. Domains whose records distinguish an in-record first
        response (LM serving's prefill + queueing delay inside a
        continuous batch) override this."""
        return end_t

    def task_quality(self, task) -> float:
        """Admission-time work proxy for one task — its intrinsic quality
        target in work units (tokens for LM serving), used to price a
        not-yet-characterised arrival against the admission queue budget.
        Default 1.0: every task costs one unit until characterised."""
        return 1.0

    # -- capacity (optional second constraint dimension) -------------------

    def resource_per_unit(self, platform, task) -> float:
        """Resource units one unit of this task's work holds on the
        platform while the task is being served (e.g. KV-cache bytes per
        decoded token for LM serving). The scheduler multiplies this by
        the task's total work units to build ``AllocationProblem.resource``;
        the default 0 keeps the capacity dimension inert."""
        return 0.0

    def platform_capacity(self, platform) -> float:
        """The platform's resource budget (e.g. HBM bytes); paired with
        :meth:`resource_per_unit`. inf means unconstrained."""
        return math.inf

    def record_units(self, record: RunRecordLike) -> int:
        """Work units one execution record accounts for (remaining-work
        accounting in the online loop). Default scans the common unit
        field names; domains with other record shapes override."""
        for attr in ("n_paths", "n_tokens", "units"):
            value = getattr(record, attr, None)
            if value is not None:
                return int(value)
        raise AttributeError(
            f"{type(record).__name__} carries no recognised work-unit field; "
            f"override {type(self).__name__}.record_units")

    # -- execution ---------------------------------------------------------

    @abc.abstractmethod
    def work_units(self, model, quality: float) -> float:
        """Total work units task needs at ``quality`` (eq. 8 inverted for
        MC; identity for domains measuring quality in work units)."""

    @abc.abstractmethod
    def dispatch_batch(self, platform, tasks: Sequence[Any],
                       units: Sequence[int], seed: int = 0) -> list[RunRecordLike]:
        """Execute a (task, units) shard list on a platform."""

    def summarise(self, records: Sequence[RunRecordLike], problem) -> dict:
        """Domain-specific result pooling (estimates, achieved quality...)."""
        return {}
