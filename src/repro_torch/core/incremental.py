"""Incremental re-solve: patch an executing allocation for k new tasks.

The PR 4 online controller re-solves the whole remaining problem on every
arrival. At fleet scale that is wasteful: k tasks arriving into a
1000-task allocation change k columns, and the committed shares of the
other tasks are not going anywhere mid-round anyway. :func:`patch_allocation`
solves only the delta sub-problem — the k new columns against the fleet's
*current* finish times (per-platform latencies of the executing allocation
as offsets) and *remaining* capacities — and merges the result into the
incumbent. Cost is O(k·mu) construction plus a k-column solve instead of a
full O(tau·mu) rebuild.

The patch is greedy with respect to the old tasks: their shares stay
fixed, so a patched solution can be worse than a from-scratch solve when
the arrivals are large relative to the executing work. The guard is a
bound test against the fresh full-problem heuristic: when the patched
makespan exceeds ``(1 + patch_tol)`` times that bound, the patch is
discarded and a full solve runs instead (``meta["incremental"]`` says
which path was taken, with both makespans recorded).
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from .allocation import (
    Allocation,
    AllocationProblem,
    CapacityError,
    SUPPORT_ATOL,
    makespan,
    platform_latencies,
    platform_usage,
    restrict_problem,
)
from .heuristic import proportional_allocation

__all__ = ["patch_allocation"]


def _solver_table():
    from .annealing import ml_allocation
    from .milp import milp_allocation

    return {
        "heuristic": lambda p, **kw: proportional_allocation(p),
        "ml": ml_allocation,
        "milp": milp_allocation,
    }


def patch_allocation(
    problem: AllocationProblem,
    A_base: np.ndarray,
    new_tasks: Sequence[int],
    method: str = "milp",
    *,
    patch_tol: float = 0.25,
    **solver_kw,
) -> Allocation:
    """Allocate only ``new_tasks``, holding the rest of ``A_base`` fixed.

    ``problem`` is the full frame including the new columns; ``A_base``
    must be (mu, tau) with zero mass in the ``new_tasks`` columns (they
    have not been dispatched yet) and valid columns elsewhere. The delta
    sub-problem sees each platform's current finish time as its offset and
    its remaining capacity as its budget, so the k-column solve minimises
    the *fleet* finish time, not just the newcomers' own.

    Gamma accounting is exact for the newcomers (no column is charged
    twice: the new columns had no support in ``A_base``); platforms'
    existing gamma charges ride along inside the offsets.
    """
    t0 = time.perf_counter()
    solvers = _solver_table()
    if method not in solvers:
        raise ValueError(f"unknown method {method!r}; pick from {sorted(solvers)}")
    solve = solvers[method]
    new_cols = np.asarray(new_tasks, dtype=int)
    if new_cols.size == 0:
        raise ValueError("patch needs >= 1 new task")
    A_base = np.asarray(A_base, dtype=np.float64)
    if A_base.shape != (problem.mu, problem.tau):
        raise ValueError(f"A_base is {A_base.shape}, problem frame is "
                         f"({problem.mu}, {problem.tau})")
    if (np.abs(A_base[:, new_cols]) > SUPPORT_ATOL).any():
        raise ValueError("new task columns must carry no mass in A_base")

    offsets = platform_latencies(A_base, problem)
    cap_rem = None
    if problem.capacity is not None:
        cap_rem = np.maximum(problem.capacity - platform_usage(A_base, problem),
                             0.0)
    sub = restrict_problem(problem, tasks=new_cols, offsets=offsets,
                           capacity=cap_rem)

    patched_A = patched_m = None
    patch_err = None
    try:
        sub_alloc = solve(sub, **solver_kw)
        patched_A = A_base.copy()
        patched_A[:, new_cols] = sub_alloc.A
        patched_m = makespan(patched_A, problem)
    except CapacityError as err:
        # newcomers alone cannot fit the *remaining* budgets; a full solve
        # may still fit by rebalancing the old shares
        patch_err = str(err)

    patch_s = time.perf_counter() - t0
    # bound test: the fresh full-problem heuristic is an upper bound any
    # from-scratch solver would beat; a patch that can't stay within
    # patch_tol of it is holding the old shares in the wrong place
    ref = proportional_allocation(problem)
    if patched_m is not None and patched_m <= ref.makespan * (1.0 + patch_tol):
        # top level keeps the inner solver's normalised phase keys
        # (flattened, as before) *and* the full inner meta under "inner"
        # so telemetry consumers see the k-column solve's own breakdown
        inner = dict(getattr(sub_alloc, "meta", {}) or {})
        meta = dict(inner)
        meta.update(incremental="patched", patch_tasks=int(new_cols.size),
                    patch_s=patch_s, patched_makespan=float(patched_m),
                    heuristic_bound=float(ref.makespan), patch_tol=patch_tol,
                    inner=inner)
        return Allocation(A=patched_A, makespan=float(patched_m),
                          solver=sub_alloc.solver,
                          solve_time=time.perf_counter() - t0,
                          optimal=False, meta=meta)

    full = solve(problem, **solver_kw)
    inner = dict(full.meta)
    meta = dict(inner)
    meta.update(incremental="full_fallback", patch_tasks=int(new_cols.size),
                patch_s=patch_s,
                patched_makespan=None if patched_m is None else float(patched_m),
                heuristic_bound=float(ref.makespan), patch_tol=patch_tol,
                inner=inner)
    if patch_err is not None:
        meta["patch_error"] = patch_err
    return Allocation(A=full.A, makespan=full.makespan, solver=full.solver,
                      solve_time=time.perf_counter() - t0,
                      optimal=full.optimal, bound=full.bound, meta=meta)
