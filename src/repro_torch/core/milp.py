"""MILP allocation (paper §4.3.4, eq. 12).

The non-linear ``gamma ∘ ceil(A)`` term is linearised with indicator
binaries B >= A, giving the mixed-integer linear program

    minimise_{G_L, A, B}  G_L
    s.t.   sum_i A[i,j] == 1                          (every task placed)
           (W ∘ A)·1 + (gamma ∘ B)·1 <= G_L           (per-platform latency)
           (R ∘ A)·1 <= capacity                      (per-platform resource)
           A[i,j] <= B[i,j],  A real in [0,1], B binary

(the resource rows appear only when the problem carries the optional
capacity dimension — e.g. KV-cache bytes vs HBM for LM serving.)

The paper fed this (via ZIMPL) to SCIP; we use HiGHS branch-and-bound via
``scipy.optimize.milp`` — the same problem class with a 2020s solver, which
is precisely the "progress in MILP" the paper banks on [22]. The dual bound
HiGHS reports gives the external measure of solution quality the paper
calls for (§2.2.4): a solution can be certified near-optimal without being
proven optimal.

``atomic=True`` solves the unrelaxed eq. 3 instead (A binary, no split),
used for the NP-complete baseline comparisons.
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
from scipy.optimize import LinearConstraint, Bounds, milp

from .allocation import (
    SUPPORT_ATOL,
    Allocation,
    AllocationProblem,
    assert_capacity_feasible,
    makespan,
    platform_usage,
)
from .heuristic import incumbent_shortcut, proportional_allocation

__all__ = ["milp_allocation"]


def _build_relaxed(problem: AllocationProblem):
    """Variables x = [A (mu*tau), B (mu*tau), G_L]; A row-major (i, j)."""
    mu, tau = problem.mu, problem.tau
    n = mu * tau
    W, G = problem.work, problem.gamma

    c = np.zeros(2 * n + 1)
    c[-1] = 1.0

    # sum_i A[i, j] == 1   (tau rows)
    jj = np.arange(n)  # A index for (i, j) = i * tau + j -> column j = idx % tau
    eq = sp.csr_matrix((np.ones(n), (jj % tau, jj)), shape=(tau, 2 * n + 1))
    eq_con = LinearConstraint(eq, lb=np.ones(tau), ub=np.ones(tau))

    # per-platform latency: W_i·A_i + G_i·B_i - G_L <= 0   (mu rows)
    rows = np.repeat(np.arange(mu), tau)
    a_cols = np.arange(n)
    b_cols = n + np.arange(n)
    lat = sp.csr_matrix(
        (
            np.concatenate([W.ravel(), G.ravel(), -np.ones(mu)]),
            (
                np.concatenate([rows, rows, np.arange(mu)]),
                np.concatenate([a_cols, b_cols, np.full(mu, 2 * n)]),
            ),
        ),
        shape=(mu, 2 * n + 1),
    )
    # committed per-platform offsets shift each latency row's budget
    lat_con = LinearConstraint(lat, lb=-np.inf, ub=-problem.offsets)

    # A[i,j] - B[i,j] <= 0   (n rows)
    link = sp.csr_matrix(
        (
            np.concatenate([np.ones(n), -np.ones(n)]),
            (np.concatenate([np.arange(n), np.arange(n)]),
             np.concatenate([a_cols, b_cols])),
        ),
        shape=(n, 2 * n + 1),
    )
    link_con = LinearConstraint(link, lb=-np.inf, ub=np.zeros(n))

    cons = [eq_con, lat_con, link_con]
    if problem.has_capacity:
        # per-platform resource rows: R_i·A_i <= capacity_i   (mu rows)
        res = sp.csr_matrix(
            (problem.resource.ravel(), (rows, a_cols)), shape=(mu, 2 * n + 1))
        cons.append(LinearConstraint(res, lb=-np.inf, ub=problem.capacity))

    integrality = np.concatenate([np.zeros(n), np.ones(n), np.zeros(1)])
    bounds = Bounds(
        lb=np.concatenate([np.zeros(2 * n), [0.0]]),
        ub=np.concatenate([np.ones(2 * n), [np.inf]]),
    )
    return c, cons, integrality, bounds


def _build_atomic(problem: AllocationProblem):
    """eq. 3: A binary, L = W + gamma, no B needed."""
    mu, tau = problem.mu, problem.tau
    n = mu * tau
    L = problem.full_latency

    c = np.zeros(n + 1)
    c[-1] = 1.0
    jj = np.arange(n)
    eq = sp.csr_matrix((np.ones(n), (jj % tau, jj)), shape=(tau, n + 1))
    eq_con = LinearConstraint(eq, lb=np.ones(tau), ub=np.ones(tau))
    rows = np.repeat(np.arange(mu), tau)
    lat = sp.csr_matrix(
        (
            np.concatenate([L.ravel(), -np.ones(mu)]),
            (np.concatenate([rows, np.arange(mu)]),
             np.concatenate([jj, np.full(mu, n)])),
        ),
        shape=(mu, n + 1),
    )
    lat_con = LinearConstraint(lat, lb=-np.inf, ub=-problem.offsets)
    cons = [eq_con, lat_con]
    if problem.has_capacity:
        res = sp.csr_matrix(
            (problem.resource.ravel(), (rows, jj)), shape=(mu, n + 1))
        cons.append(LinearConstraint(res, lb=-np.inf, ub=problem.capacity))
    integrality = np.concatenate([np.ones(n), np.zeros(1)])
    bounds = Bounds(
        lb=np.zeros(n + 1),
        ub=np.concatenate([np.ones(n), [np.inf]]),
    )
    return c, cons, integrality, bounds


def milp_allocation(
    problem: AllocationProblem,
    *,
    time_limit: float = 600.0,
    mip_rel_gap: float = 1e-4,
    atomic: bool = False,
    incumbent: Allocation | None = None,
    warm_tol: float = 0.05,
) -> Allocation:
    """Solve eq. 12; ``incumbent`` enables the online warm-start early exit.

    HiGHS via scipy takes no MIP start, so the incumbent's value here is
    the skip test (:func:`incumbent_shortcut`): when the executing
    allocation is already within ``warm_tol`` of the fresh heuristic bound
    on the re-fitted problem, return it without solving.
    """
    t0 = time.perf_counter()
    assert_capacity_feasible(problem)
    warm_meta = {}
    if incumbent is not None:
        _, shortcut, warm_meta = incumbent_shortcut(
            problem, incumbent, "milp", warm_tol, t0)
        if shortcut is not None:
            return shortcut
    mu, tau = problem.mu, problem.tau
    n = mu * tau
    t_build0 = time.perf_counter()
    if atomic:
        c, cons, integrality, bounds = _build_atomic(problem)
    else:
        c, cons, integrality, bounds = _build_relaxed(problem)
    build_s = time.perf_counter() - t_build0
    n_vars = c.size
    n_constraints = sum(con.A.shape[0] for con in cons)

    t_solve0 = time.perf_counter()
    res = milp(
        c,
        constraints=cons,
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit, "mip_rel_gap": mip_rel_gap},
    )
    phase_meta = {"build_s": build_s,
                  "solve_s": time.perf_counter() - t_solve0,
                  "polish_s": 0.0,  # MILP has no polish phase
                  "n_vars": int(n_vars), "n_constraints": int(n_constraints)}
    solve_time = time.perf_counter() - t0

    if res.x is None:
        # solver produced nothing within the budget — fall back to heuristic
        heur = proportional_allocation(problem)
        return Allocation(
            A=heur.A, makespan=heur.makespan, solver="milp",
            solve_time=solve_time, optimal=False,
            meta={"status": int(res.status), "fallback": "heuristic",
                  **phase_meta, **warm_meta},
        )

    A = np.asarray(res.x[:n], dtype=np.float64).reshape(mu, tau)
    A[A < SUPPORT_ATOL] = 0.0
    colsum = A.sum(axis=0)
    if (colsum <= 0).any():  # numerically degenerate column: put on best platform
        for j in np.nonzero(colsum <= 0)[0]:
            order = np.argsort(problem.full_latency[:, j])
            if problem.capacity is not None:
                # prefer the fastest platform whose capacity row still fits
                usage = platform_usage(A, problem)
                fits = [i for i in order
                        if usage[i] + problem.resource[i, j] <= problem.capacity[i]]
                order = fits or list(order)
            A[order[0], j] = 1.0
        colsum = A.sum(axis=0)
    A /= colsum

    gap = getattr(res, "mip_gap", None)
    bound = getattr(res, "mip_dual_bound", None)
    return Allocation(
        A=A,
        makespan=makespan(A, problem),
        solver="milp-atomic" if atomic else "milp",
        solve_time=solve_time,
        optimal=bool(res.status == 0),
        bound=None if bound is None else float(bound),
        meta={"status": int(res.status), "mip_gap": None if gap is None else float(gap),
              "node_count": int(getattr(res, "mip_node_count", -1) or -1),
              **phase_meta, **warm_meta},
    )
