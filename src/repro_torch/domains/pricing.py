"""Derivatives pricing as a runtime :class:`Domain` (paper §4).

The original front-end of the paper, re-expressed against the shared
runtime: Monte Carlo paths are the work unit, the 95% CI is the quality
metric, and the quality->work reduction is the inverse-square law of
eq. 9 (W = delta / c^2). All heavy lifting — the batched MC engine,
Table 2 platforms, online benchmarking ladders, model fitting — stays in
:mod:`repro_torch.pricing`; this module is the thin one-file adapter
that every domain is.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.allocation import mc_work_reduction
from repro_torch.pricing.contracts import PricingTask, launch_key
from repro_torch.pricing import platforms as _platforms
from repro_torch.pricing.platforms import (
    RunRecord,
    TaskPlatformModel,
    benchmark_adaptive_batch,
    benchmark_batch,
    dispatch_batch,
    fit_models,
)
from repro_torch.runtime.domain import Domain

__all__ = ["PricingDomain"]


class PricingDomain(Domain):
    """Monte Carlo option pricing: paths for CI accuracy."""

    name = "pricing"
    reduction = staticmethod(mc_work_reduction)
    #: smallest shard worth a launch — matches the historical solver floor.
    min_chunk = 64

    # -- identity ----------------------------------------------------------

    def launch_key(self, task: PricingTask):
        return launch_key(task)  # (model kind, n_steps): the compile unit

    # -- characterisation ---------------------------------------------------

    def characterise_batch(self, platform, tasks: Sequence[PricingTask],
                           seed: int = 1, path_ladder=None) -> list[list[RunRecord]]:
        if path_ladder is not None:
            return benchmark_batch(platform, tasks, path_ladder, seed)
        return benchmark_adaptive_batch(platform, tasks, seed=seed)

    def characterise(self, seed: int = 1, path_ladder=None, batched: bool = True,
                     executor=None, tasks=None, platforms=None,
                     record_sink=None,
                     skip_unavailable: bool = False,
                     ) -> dict[tuple[str, int], TaskPlatformModel]:
        if not batched:
            # legacy per-task loop, kept for A/B comparisons. It honours
            # task/platform subsets (incremental arrivals) but cannot fill
            # a record_sink — the legacy pipeline returns fitted models
            # only, so online re-fit windows start empty under
            # batched=False.
            return _platforms.characterise(
                self.platforms if platforms is None else list(platforms),
                self.tasks if tasks is None else list(tasks),
                path_ladder, seed, batched=False)
        return super().characterise(seed=seed, executor=executor, tasks=tasks,
                                    platforms=platforms,
                                    record_sink=record_sink,
                                    skip_unavailable=skip_unavailable,
                                    path_ladder=path_ladder)

    def fit_models(self, records: Sequence[RunRecord]) -> TaskPlatformModel:
        return fit_models(records)

    # -- execution ----------------------------------------------------------

    def work_units(self, model: TaskPlatformModel, quality: float) -> float:
        return model.accuracy.paths_for_accuracy(quality)  # eq. 8 inverted

    def degrade_quality(self, quality: float, step: float) -> float:
        """Loosen the CI target by ``step`` — via eq. 9's inverse-square
        law, a 25% looser CI needs ~36% fewer paths."""
        return quality * (1.0 + step)

    def record_units(self, record: RunRecord) -> int:
        return int(record.n_paths)

    def dispatch_batch(self, platform, tasks: Sequence[PricingTask],
                       units: Sequence[int], seed: int = 0) -> list[RunRecord]:
        return dispatch_batch(platform, tasks, units, seed=seed)

    def summarise(self, records: Sequence[RunRecord], problem) -> dict:
        """Pool per-shard estimates inverse-variance style.

        A task split across platforms yields several (price, ci, n) shards
        drawn from the same payoff distribution; the pooled estimate is the
        path-weighted mean and the pooled CI obeys

            ci^2 = sum_i (n_i * ci_i)^2 / (sum_i n_i)^2
        """
        num = {t.task_id: 0.0 for t in self.tasks}
        den = {t.task_id: 0.0 for t in self.tasks}
        var = {t.task_id: 0.0 for t in self.tasks}
        for rec in records:
            num[rec.task_id] += rec.n_paths * rec.price
            den[rec.task_id] += rec.n_paths
            var[rec.task_id] += (rec.n_paths * rec.ci95) ** 2
        prices = {tid: num[tid] / den[tid] for tid in num}
        measured_ci = {tid: float(np.sqrt(var[tid])) / den[tid] for tid in num}
        predicted_ci = {t.task_id: float(problem.c[j])
                        for j, t in enumerate(self.tasks)}
        return {"prices": prices, "measured_ci": measured_ci,
                "predicted_ci": predicted_ci}
