"""F3-style solver: characterise -> allocate -> execute (paper Fig 1 flow).

This is the orchestration layer a domain user ("Julia") touches:

    solver = PricingSolver(tasks, platforms)
    solver.characterise()                       # online benchmarking, (2)
    alloc = solver.allocate(accuracy=0.05,      # trade-off selection, (3-4)
                            method="milp")
    report = solver.execute(alloc)              # evaluation, (5)

Since the runtime refactor this class is a thin compatibility wrapper: the
loop itself lives in the domain-agnostic :class:`repro_torch.runtime.Scheduler`
driving :class:`repro_torch.domains.pricing.PricingDomain` — the same code path
that serves every other domain (e.g. LM token serving). ``execute`` still
returns the pricing-shaped :class:`ExecutionReport` (pooled prices,
predicted vs measured CI and makespan — the paper's Figs 8 & 10
quantities), unpacked from the scheduler's generic report.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core import Allocation, AllocationProblem
from repro_torch.runtime import Scheduler
from repro_torch.runtime.scheduler import SOLVERS  # noqa: F401  (re-export, stable API)
from .contracts import PricingTask
from .platforms import Platform, RunRecord, TaskPlatformModel

__all__ = ["PricingSolver", "ExecutionReport", "SOLVERS"]


@dataclasses.dataclass
class ExecutionReport:
    allocation: Allocation
    predicted_makespan: float
    measured_makespan: float
    platform_latencies: dict[str, float]
    prices: dict[int, float]
    predicted_ci: dict[int, float]
    measured_ci: dict[int, float]
    records: list[RunRecord]

    @property
    def makespan_error(self) -> float:
        if self.measured_makespan == 0:
            return math.inf  # nothing dispatched: model unassessable
        return abs(self.predicted_makespan - self.measured_makespan) / self.measured_makespan


class PricingSolver:
    def __init__(self, tasks: Sequence[PricingTask], platforms: Sequence[Platform],
                 mode: str = "concurrent"):
        # Imported here: repro_torch.pricing.__init__ imports this module before
        # the package is fully initialised, and the domain adapter imports
        # back into repro_torch.pricing.
        from repro_torch.domains.pricing import PricingDomain

        self.domain = PricingDomain(tasks, platforms)
        self.scheduler = Scheduler(self.domain, mode=mode)

    @property
    def tasks(self) -> list[PricingTask]:
        return self.domain.tasks

    @property
    def platforms(self) -> list[Platform]:
        return self.domain.platforms

    @property
    def models(self) -> dict[tuple[str, int], TaskPlatformModel] | None:
        return self.scheduler.models

    @property
    def _delta(self) -> np.ndarray | None:
        return self.scheduler._delta

    @property
    def _gamma(self) -> np.ndarray | None:
        return self.scheduler._gamma

    # -- step 2: characterisation ------------------------------------------
    def characterise(self, path_ladder: Sequence[int] | None = None,
                     seed: int = 1, batched: bool = True) -> None:
        self.scheduler.characterise(seed=seed, path_ladder=path_ladder,
                                    batched=batched)

    def problem(self, accuracy: float | np.ndarray) -> AllocationProblem:
        return self.scheduler.problem(accuracy)

    # -- steps 3-4: allocation ---------------------------------------------
    def allocate(self, accuracy: float | np.ndarray, method: str = "milp",
                 **solver_kw) -> Allocation:
        return self.scheduler.allocate(accuracy, method=method, **solver_kw)

    # -- step 5: execution ---------------------------------------------------
    def execute(self, allocation: Allocation, accuracy: float | np.ndarray,
                seed: int = 3) -> ExecutionReport:
        rep = self.scheduler.execute(allocation, accuracy, seed=seed)
        return ExecutionReport(
            allocation=rep.allocation,
            predicted_makespan=rep.predicted_makespan,
            measured_makespan=rep.measured_makespan,
            platform_latencies=rep.platform_latencies,
            prices=rep.summary["prices"],
            predicted_ci=rep.summary["predicted_ci"],
            measured_ci=rep.summary["measured_ci"],
            records=rep.records,
        )
