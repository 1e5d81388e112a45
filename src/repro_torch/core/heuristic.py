"""Proportional allocation heuristic (paper §4.3.2, eq. 11).

Every task is split across all platforms with the *same* per-platform share,
inversely proportional to the makespan each platform would see if it ran the
entire workload alone:

    A[i, j] = ( L_i * sum_o 1/L_o )**-1,   L = H_L(1, c)

The heuristic is optimal when the gamma constants vanish and the work matrix
is rank-1 (platform speed independent of task); when constants dominate it
degrades badly because it charges *every* platform *every* task's constant —
exactly the regime where the ML/MILP solvers win (paper §6.3).

With a resource dimension the proportional shares are followed by a
*water-filling clamp* (:func:`clamp_to_capacity`): overloaded platforms
shed task shares onto the platforms with the most remaining capacity until
every row fits, so the heuristic stays a feasible upper bound the other
solvers are measured against.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .allocation import (
    CAPACITY_RTOL,
    Allocation,
    AllocationProblem,
    SUPPORT_ATOL,
    assert_capacity_feasible,
    capacity_ok,
    makespan,
    platform_latencies,
)

__all__ = ["proportional_allocation", "incumbent_shortcut", "clamp_to_capacity"]


def clamp_to_capacity(A: np.ndarray, problem: AllocationProblem,
                      max_sweeps: int = 64) -> np.ndarray:
    """Water-fill an allocation into the capacity rows.

    Greedy repair: the most-overloaded platform pours its largest resource
    contributions into the platforms with the most slack (cheapest work
    first among equals) until every row fits. The instance must have
    passed :func:`assert_capacity_feasible`; if the greedy pass stalls
    (pathological resource geometry), the caller is expected to fall back
    to an exact LP (see :func:`repro_torch.core.annealing.lp_polish`, which
    carries the capacity rows).

    Returns a new matrix; the input is not modified.
    """
    if problem.capacity is None:
        return np.asarray(A, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64).copy()
    R, cap, W = problem.resource, problem.capacity, problem.work
    mu = problem.mu
    slack_tol = np.where(np.isfinite(cap), cap * CAPACITY_RTOL, np.inf) + 1e-30
    for _ in range(max_sweeps):
        usage = (R * A).sum(axis=1)
        over = usage - cap
        i = int(np.argmax(over))
        if over[i] <= slack_tol[i]:
            return A
        progressed = False
        # shed this row's biggest contributions first
        for j in np.argsort(-(R[i] * A[i])):
            if over[i] <= 0 or R[i, j] <= 0 or A[i, j] <= SUPPORT_ATOL:
                continue
            need = min(A[i, j], over[i] / R[i, j])  # share to move off i
            # receivers: slack per share of task j, cheapest work first.
            # Prefix-sum fill: each receiver takes min(its room, what is
            # still needed after everyone ranked ahead of it) — one
            # vectorised pass instead of a per-receiver Python loop.
            recv = np.nonzero(cap - usage > slack_tol)[0]
            recv = recv[recv != i]
            if recv.size == 0:
                continue
            recv = recv[np.lexsort((R[recv, j], W[recv, j]))]
            with np.errstate(divide="ignore"):
                room = np.where(R[recv, j] <= 0, np.inf,
                                (cap[recv] - usage[recv]) / R[recv, j])
            ahead = np.concatenate(([0.0], np.cumsum(room)[:-1]))
            take = np.minimum(room, np.maximum(need - ahead, 0.0))
            moved = take.sum()
            if moved <= 0:
                continue
            A[recv, j] += take
            A[i, j] -= moved
            usage[recv] += take * R[recv, j]
            usage[i] -= moved * R[i, j]
            over[i] = usage[i] - cap[i]
            progressed = True
        if not progressed:
            break
    return A


def incumbent_shortcut(
    problem: AllocationProblem,
    incumbent,
    solver: str,
    warm_tol: float,
    t0: float,
) -> tuple[np.ndarray, Allocation | None, dict]:
    """Warm-start early exit shared by the optimising solvers.

    Online re-solves usually start from an incumbent allocation (the one
    currently executing). If the incumbent's predicted makespan on the
    re-fitted problem is already within ``warm_tol`` of the fresh
    proportional-heuristic bound, a full solve cannot buy enough to matter —
    e.g. a *uniform* drift that slows every platform equally leaves the
    incumbent optimal — so the solve is skipped and the incumbent returned
    with ``meta["warm_start"] == "skipped"``. Otherwise the caller proceeds
    (``meta["warm_start"] == "solved"``) with the incumbent matrix available
    as a start point.

    An incumbent that violates the problem's *capacity* rows (the re-solve
    carries remaining capacities the executing plan was never solved
    against) is never waved through, however good its makespan looks: the
    returned meta says ``warm_start == "rejected"`` so callers both solve
    for real and repair the matrix before seeding anything with it.

    With per-platform offsets (mid-run re-solves) the incumbent must clear
    the bar in *both* frames to be waved through:

    * on the offset-stripped problem — is its share of the remaining work
      well balanced on its own terms? Late in a run the committed time
      dominates finish times, and an offset-carrying ratio test alone
      would wave anything through;
    * on the offset-carrying problem (tolerance scaled by the remaining
      work, not the finish time) — does it respect who is already busy? A
      remaining-schedule that is flat-optimal can still pile work onto the
      platform with the largest committed backlog.

    With zero offsets both collapse to the plain
    ``m_inc <= heuristic * (1 + warm_tol)``.

    Returns ``(A_incumbent, shortcut, warm_meta)`` where ``shortcut`` is
    the ready Allocation when the solve should be skipped (else None) and
    ``warm_meta`` is the ``warm_start`` metadata the caller folds into its
    own result when it does solve.
    """
    A_inc = np.asarray(incumbent.A if hasattr(incumbent, "A") else incumbent,
                       dtype=np.float64)
    if A_inc.shape != (problem.mu, problem.tau):
        raise ValueError(
            f"incumbent shape {A_inc.shape} does not match problem "
            f"({problem.mu}, {problem.tau}); restrict it first")
    if not capacity_ok(A_inc, problem):
        # the executing plan no longer fits the (remaining) capacities —
        # it must not short-circuit the solve, and callers must repair it
        # before using it as a seed
        return A_inc, None, {"warm_start": "rejected"}
    flat = (dataclasses.replace(problem, offsets=None)
            if problem.offsets.any() else problem)
    heur_flat = proportional_allocation(flat)
    skip = makespan(A_inc, flat) <= heur_flat.makespan * (1.0 + warm_tol)
    if skip and problem.offsets.any():
        heur_off = proportional_allocation(problem)
        skip = (makespan(A_inc, problem)
                <= heur_off.makespan + warm_tol * heur_flat.makespan)
    if skip:
        return A_inc, Allocation(
            A=A_inc.copy(), makespan=makespan(A_inc, problem), solver=solver,
            solve_time=time.perf_counter() - t0, optimal=False,
            meta={"warm_start": "skipped", "warm_tol": warm_tol,
                  "heuristic_bound": heur_flat.makespan,
                  # phase keys are part of every Allocation.meta contract;
                  # a skipped solve ran none of them
                  "build_s": 0.0, "solve_s": 0.0, "polish_s": 0.0},
        ), {"warm_start": "skipped"}
    return A_inc, None, {"warm_start": "solved"}


def proportional_allocation(problem: AllocationProblem) -> Allocation:
    t0 = time.perf_counter()
    assert_capacity_feasible(problem)
    t_build = time.perf_counter() - t0
    ones = np.ones((problem.mu, problem.tau))
    L = platform_latencies(ones, problem)  # L = H_L(1, c)
    free = L <= 0.0
    if free.any():
        # Degenerate platform: an all-zero (delta, gamma) row means zero
        # standalone latency and 1/L blows up. Such platforms are free, so
        # snap to a uniform share across them (makespan 0 — optimal).
        shares = free / free.sum()
    else:
        inv = 1.0 / L
        shares = inv / inv.sum()  # shares[i] = (L_i * sum_o 1/L_o)^-1
    A = np.repeat(shares[:, None], problem.tau, axis=1)
    meta = {}
    if not capacity_ok(A, problem):
        A = clamp_to_capacity(A, problem)
        meta["capacity"] = "clamped"
        if not capacity_ok(A, problem):
            # greedy repair stalled: fall back to the exact LP over the
            # full support (it carries the capacity rows); feasibility is
            # guaranteed by the pre-check above
            from .annealing import lp_polish

            out = lp_polish(problem, np.ones_like(A, dtype=bool))
            if out is None:  # numerically degenerate edge — report honestly
                raise AssertionError(
                    "capacity clamp failed on a feasible instance")
            A, _ = out
            meta["capacity"] = "lp"
    total = time.perf_counter() - t0
    meta.update(build_s=t_build, solve_s=total - t_build, polish_s=0.0,
                n_vars=problem.mu * problem.tau,
                n_constraints=problem.tau + (problem.mu if problem.has_capacity else 0))
    return Allocation(
        A=A,
        makespan=makespan(A, problem),
        solver="heuristic",
        solve_time=total,
        meta=meta,
    )
