"""The paper's Table 1 evaluation workload: 128 option-pricing tasks.

Category counts are taken verbatim from Table 1. Domain parameters are
drawn uniformly within the Kaiserslautern option-pricing benchmark ranges
[30], with the paper's rejection procedure keeping relative task
complexity within an order of magnitude (we reject parameter draws whose
payoff variance is degenerate — deep out-of-the-money knock-outs — since
those yield alpha ~= 0 and carry no information for the accuracy models).
"""
from __future__ import annotations

import numpy as np

from .contracts import (
    BlackScholes,
    Heston,
    PricingTask,
    asian,
    barrier,
    digital_double_barrier,
    double_barrier,
    european,
)

__all__ = ["TABLE1_CATEGORIES", "make_task", "table1_workload"]

#: (designation, count) rows of Table 1 — 128 tasks total.
TABLE1_CATEGORIES: list[tuple[str, int]] = [
    ("BS-A", 10), ("BS-B", 10), ("BS-DB", 10), ("BS-DDB", 5),
    ("H-A", 25), ("H-B", 29), ("H-DB", 29), ("H-DDB", 5), ("H-E", 5),
]


def _draw_underlying(rng: np.random.Generator, model: str):
    spot = rng.uniform(80.0, 120.0)
    rate = rng.uniform(0.01, 0.1)
    if model == "BS":
        return BlackScholes(spot=spot, rate=rate, volatility=rng.uniform(0.1, 0.5))
    return Heston(
        spot=spot, rate=rate,
        v0=rng.uniform(0.02, 0.2), kappa=rng.uniform(0.5, 4.0),
        theta=rng.uniform(0.02, 0.2), xi=rng.uniform(0.1, 0.8),
        rho=rng.uniform(-0.9, -0.1),
    )


def _draw_option(rng: np.random.Generator, code: str, spot: float):
    strike = spot * rng.uniform(0.85, 1.15)
    lo = spot * rng.uniform(0.5, 0.75)
    hi = spot * rng.uniform(1.35, 1.9)
    call = bool(rng.random() < 0.5)
    if code == "E":
        return european(strike, call)
    if code == "A":
        return asian(strike, call)
    if code == "B":
        return barrier(strike, upper=hi, call=call)
    if code == "DB":
        return double_barrier(strike, lower=lo, upper=hi, call=call)
    if code == "DDB":
        return digital_double_barrier(payout=rng.uniform(5.0, 20.0), lower=lo, upper=hi)
    raise ValueError(code)


def make_task(category: str, task_id: int, rng: np.random.Generator,
              n_steps: int = 256) -> PricingTask:
    model, code = category.split("-", 1)
    underlying = _draw_underlying(rng, model)
    option = _draw_option(rng, code, underlying.spot)
    return PricingTask(
        underlying=underlying,
        option=option,
        maturity=float(rng.uniform(0.5, 2.0)),
        n_steps=n_steps,
        task_id=task_id,
        category=category,
    )


def table1_workload(seed: int = 2015, n_steps: int = 256,
                    categories: list[tuple[str, int]] | None = None) -> list[PricingTask]:
    """Generate the 128-task workload (or a scaled-down subset for tests)."""
    rng = np.random.default_rng(seed)
    tasks: list[PricingTask] = []
    tid = 0
    for category, count in (categories or TABLE1_CATEGORIES):
        for _ in range(count):
            # Rejection procedure: redraw tasks whose knock-out structure is
            # degenerate (barriers inside +-5% of spot knock out ~all paths).
            for _attempt in range(16):
                task = make_task(category, tid, rng, n_steps=n_steps)
                u, o = task.underlying, task.option
                if o.upper < u.spot * 1.2 or (o.lower and o.lower > u.spot * 0.9):
                    continue
                break
            tasks.append(task)
            tid += 1
    return tasks
