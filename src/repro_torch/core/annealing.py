"""The LP polish of the ML allocator (paper §4.3.3): its SciPy half.

The reference module pairs a simulated annealer, vectorised with JAX, with
an exact "polishing" LP (Dantzig's simplex, here HiGHS through
``scipy.optimize.linprog``): fix the binary support B = ceil(A) and solve
the then-*linear* restriction of eq. 10 exactly, iterating as entries the
LP zeroes shrink the support. The heuristic's capacity repair and the
clustered solver's refinement use the polish, so it is carried over here
unchanged. The annealer (``anneal``, ``ml_allocation``) is not part of this
package yet, so the "ml" solver is not offered.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

from .allocation import (
    SUPPORT_ATOL,
    AllocationProblem,
    capacity_ok,
    makespan,
)

__all__ = ["lp_polish"]


# --------------------------------------------------------------------------
# LP polish (the "simplex" step)
# --------------------------------------------------------------------------

def lp_polish(problem: AllocationProblem, support: np.ndarray) -> tuple[np.ndarray, float] | None:
    """Solve eq. 10 restricted to a fixed support exactly (it is an LP).

    Variables: one share per support entry plus the makespan t; the
    problem's capacity rows (when present) ride along as plain
    inequalities, so a polished allocation stays capacity-feasible.
    Returns (A, makespan) or None if the LP is infeasible/failed.
    """
    support = np.asarray(support, dtype=bool)
    mu, tau = support.shape
    if not support.any(axis=0).all():
        return None  # some task has no platform
    rows, cols = np.nonzero(support)
    nnz = rows.size
    W = problem.work
    gamma_const = (problem.gamma * support).sum(axis=1)  # charged regardless of split

    # objective: minimise t (last variable)
    c = np.zeros(nnz + 1)
    c[-1] = 1.0

    # equality: each task's shares sum to 1
    A_eq = sp.csr_matrix(
        (np.ones(nnz), (cols, np.arange(nnz))), shape=(tau, nnz + 1)
    )
    b_eq = np.ones(tau)

    # inequality: sum_j W_ij A_ij - t <= -gamma_const_i
    data = W[rows, cols]
    A_ub = sp.csr_matrix(
        (np.concatenate([data, -np.ones(mu)]),
         (np.concatenate([rows, np.arange(mu)]),
          np.concatenate([np.arange(nnz), np.full(mu, nnz)]))),
        shape=(mu, nnz + 1),
    )
    b_ub = -gamma_const - problem.offsets
    if problem.has_capacity:
        # capacity rows: sum_j R_ij A_ij <= capacity_i over the support
        # (finite budgets only — linprog rejects inf right-hand sides)
        finite = np.isfinite(problem.capacity)
        row_map = np.cumsum(finite) - 1
        keep = finite[rows]
        res_rows = sp.csr_matrix(
            (problem.resource[rows, cols][keep],
             (row_map[rows[keep]], np.nonzero(keep)[0])),
            shape=(int(finite.sum()), nnz + 1),
        )
        A_ub = sp.vstack([A_ub, res_rows], format="csr")
        b_ub = np.concatenate([b_ub, problem.capacity[finite]])

    bounds = [(0, 1)] * nnz + [(0, None)]
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=bounds, method="highs")
    if not res.success:
        return None
    A = np.zeros((mu, tau))
    A[rows, cols] = res.x[:nnz]
    A[A < SUPPORT_ATOL] = 0.0
    A /= A.sum(axis=0, keepdims=True)
    return A, makespan(A, problem)


def _iterated_polish(problem: AllocationProblem, A: np.ndarray, max_iters: int = 4):
    """Polish, prune entries the LP zeroed, and re-polish to a fixed point.

    A capacity-violating input only counts once the LP (which carries the
    capacity rows) has projected it into the feasible region; returns
    (None, inf) when that never happens."""
    if capacity_ok(A, problem):
        best_A, best_m = A, makespan(A, problem)
    else:
        best_A, best_m = None, np.inf
    support = A > SUPPORT_ATOL
    for _ in range(max_iters):
        out = lp_polish(problem, support)
        if out is None:
            break
        A2, m2 = out
        new_support = A2 > SUPPORT_ATOL
        if m2 < best_m:
            best_A, best_m = A2, m2
        if new_support.sum() == support.sum():
            break
        support = new_support
    return best_A, best_m
