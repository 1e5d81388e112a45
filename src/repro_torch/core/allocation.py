"""The allocation problem (paper §3.2, §4.3.1).

Allocating tau divisible tasks across mu platforms to minimise makespan:

    minimise_{A in R+^{mu x tau}}  G_L(A, c)
    subject to                     sum_i A[i, j] == 1  for every task j

    G_L(A, c)  = max_i H_L(A, c)[i]                               (eq. 10)
    H_L(A, c)  = (delta : c^2  o  A  +  gamma o ceil(A)) . 1

where ``delta : c^2`` is the element-wise division of the delta coefficient
matrix by the squared task accuracies (the *work* matrix W), and the
``gamma o ceil(A)`` term charges each platform the per-task constant
whenever any non-zero fraction of the task is allocated to it — the source
of the problem's non-linearity.

This module holds the problem container plus the reduction functions; the
three solvers live in :mod:`repro_torch.core.heuristic`, :mod:`repro_torch.core.annealing`
and :mod:`repro_torch.core.milp`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "AllocationProblem",
    "Allocation",
    "CapacityError",
    "platform_latencies",
    "platform_usage",
    "capacity_ok",
    "makespan",
    "check_allocation",
    "assert_capacity_feasible",
    "mc_work_reduction",
    "linear_work_reduction",
    "restrict_problem",
    "restrict_allocation",
    "expand_allocation",
    "SUPPORT_ATOL",
]

# An allocation entry below this is treated as "not allocated" for the
# purposes of the ceil() indicator. Solvers snap-to-zero below it.
SUPPORT_ATOL = 1e-9

# Relative slack granted when checking capacity rows: resource units can be
# bytes (1e6-scale), so tolerances must be multiplicative, not absolute.
CAPACITY_RTOL = 1e-6


class CapacityError(ValueError):
    """The instance cannot be allocated within the platform capacities.

    Raised by *every* solver (heuristic, ML, MILP) through the shared
    :func:`assert_capacity_feasible` pre-check, so callers can catch one
    typed error regardless of the method in play.
    """


# -- quality -> work reductions ---------------------------------------------
#
# The allocation program only sees a work matrix W[i, j]: the latency of
# running *all* of task j on platform i, excluding constants. How a task's
# quality requirement c[j] maps onto W is a *domain* property: Monte Carlo
# estimators obey the inverse-square law of eq. 9, while throughput domains
# (e.g. LM token serving) measure quality directly in work units. Solvers
# are agnostic — they only consume ``problem.work``.

def mc_work_reduction(delta: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Monte Carlo domains (eq. 9): W = delta : c^2 (accuracy ~ n^-1/2)."""
    return delta / (c * c)[None, :]


def linear_work_reduction(delta: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Throughput domains: W = delta o c — c counts work units directly
    (e.g. tokens to generate) and delta is seconds per unit."""
    return delta * c[None, :]


@dataclasses.dataclass(frozen=True)
class AllocationProblem:
    """Work/constant matrices for one allocation instance.

    delta : (mu, tau)  combined-model coefficients (eq. 9) per (platform, task)
    gamma : (mu, tau)  per-(platform, task) constants
    c     : (tau,)     required qualities (accuracies, token counts, ...)
    reduction : (delta, c) -> W, the domain's quality->work map.
                Defaults to the Monte Carlo inverse-square law W = delta/c^2.
    offsets : (mu,)    per-platform latency already committed before this
                solve — zero for the one-shot flow; mid-workload re-solves
                (online re-allocation) set each platform's elapsed busy
                time here so the makespan being minimised is the *finish*
                time, completed shares included, not just the remaining
                load. All three solvers honour it.
    resource : (mu, tau)  optional second constraint dimension: resource
                units platform i holds while serving the *whole* of task j
                (e.g. KV-cache bytes for an LM request) — consumption is
                linear in the allocated share, so a platform serving
                ``A[i, j]`` of the task holds ``resource[i, j] * A[i, j]``.
    capacity : (mu,)   per-platform resource budget paired with
                ``resource``; every solver keeps
                ``(resource * A).sum(axis=1) <= capacity`` as a hard row
                constraint, and raises :class:`CapacityError` when no
                allocation can satisfy it.
    """

    delta: np.ndarray
    gamma: np.ndarray
    c: np.ndarray
    reduction: Callable[[np.ndarray, np.ndarray], np.ndarray] = mc_work_reduction
    offsets: np.ndarray | None = None
    resource: np.ndarray | None = None
    capacity: np.ndarray | None = None

    def __post_init__(self):
        delta = np.asarray(self.delta, dtype=np.float64)
        gamma = np.asarray(self.gamma, dtype=np.float64)
        c = np.asarray(self.c, dtype=np.float64)
        if delta.ndim != 2 or gamma.shape != delta.shape:
            raise ValueError(f"delta/gamma must be matching 2-D: {delta.shape} vs {gamma.shape}")
        if c.shape != (delta.shape[1],):
            raise ValueError(f"c must be (tau,): {c.shape} vs tau={delta.shape[1]}")
        if (delta < 0).any() or (gamma < 0).any() or (c <= 0).any():
            raise ValueError("delta, gamma must be >= 0 and c > 0")
        offsets = (np.zeros(delta.shape[0]) if self.offsets is None
                   else np.asarray(self.offsets, dtype=np.float64))
        if offsets.shape != (delta.shape[0],):
            raise ValueError(f"offsets must be (mu,): {offsets.shape} vs mu={delta.shape[0]}")
        if (offsets < 0).any():
            raise ValueError("offsets must be >= 0")
        if (self.resource is None) != (self.capacity is None):
            raise ValueError("resource and capacity must be given together")
        resource = capacity = None
        if self.resource is not None:
            resource = np.asarray(self.resource, dtype=np.float64)
            capacity = np.asarray(self.capacity, dtype=np.float64)
            if resource.shape != delta.shape:
                raise ValueError(
                    f"resource must match delta: {resource.shape} vs {delta.shape}")
            if capacity.shape != (delta.shape[0],):
                raise ValueError(
                    f"capacity must be (mu,): {capacity.shape} vs mu={delta.shape[0]}")
            if (resource < 0).any() or (capacity < 0).any():
                raise ValueError("resource and capacity must be >= 0")
        object.__setattr__(self, "delta", delta)
        object.__setattr__(self, "gamma", gamma)
        object.__setattr__(self, "c", c)
        object.__setattr__(self, "offsets", offsets)
        object.__setattr__(self, "resource", resource)
        object.__setattr__(self, "capacity", capacity)
        # capacity-feasibility verdict cache: None = not yet established.
        # Instances are frozen, so a verdict can never go stale; every solver
        # calls assert_capacity_feasible and only the first should pay the LP.
        object.__setattr__(self, "_cap_feasible", None)

    @property
    def has_capacity(self) -> bool:
        """True when the resource/capacity constraint dimension is active."""
        return self.resource is not None and np.isfinite(self.capacity).any()

    @property
    def mu(self) -> int:
        return self.delta.shape[0]

    @property
    def tau(self) -> int:
        return self.delta.shape[1]

    @property
    def work(self) -> np.ndarray:
        """W = reduction(delta, c) — latency of the *whole* task j on
        platform i, excluding constants."""
        return self.reduction(self.delta, self.c)

    @property
    def full_latency(self) -> np.ndarray:
        """L = W + gamma — eq. 3's relative latency matrix (atomic view)."""
        return self.work + self.gamma

    @classmethod
    def from_work(cls, work: np.ndarray, gamma: np.ndarray) -> "AllocationProblem":
        """Build a problem directly from a work matrix (c folded in, c=1)."""
        work = np.asarray(work, dtype=np.float64)
        return cls(delta=work, gamma=gamma, c=np.ones(work.shape[1]))


@dataclasses.dataclass(frozen=True)
class Allocation:
    """A solver result: the allocation matrix plus solve metadata."""

    A: np.ndarray
    makespan: float
    solver: str
    solve_time: float = 0.0
    optimal: bool = False
    bound: float | None = None  # solver-reported lower bound (MILP dual)
    meta: dict = dataclasses.field(default_factory=dict)


def platform_latencies(A: np.ndarray, problem: AllocationProblem) -> np.ndarray:
    """H_L(A, c): per-platform latency vector (eq. 10's inner reduction),
    plus any already-committed per-platform offsets."""
    A = np.asarray(A, dtype=np.float64)
    support = A > SUPPORT_ATOL
    return ((problem.work * A).sum(axis=1)
            + (problem.gamma * support).sum(axis=1) + problem.offsets)


def makespan(A: np.ndarray, problem: AllocationProblem) -> float:
    """G_L(A, c) = max_i H_L(A, c)[i] (eq. 10's outer reduction)."""
    return float(platform_latencies(A, problem).max())


def platform_usage(A: np.ndarray, problem: AllocationProblem) -> np.ndarray:
    """Per-platform resource consumption of an allocation: (R o A) . 1.

    Zero everywhere when the problem carries no resource dimension."""
    if problem.resource is None:
        return np.zeros(problem.mu)
    return (problem.resource * np.asarray(A, dtype=np.float64)).sum(axis=1)


def capacity_ok(A: np.ndarray, problem: AllocationProblem,
                rtol: float = CAPACITY_RTOL) -> bool:
    """Does the allocation respect every platform's capacity row?"""
    if problem.capacity is None:
        return True
    usage = platform_usage(A, problem)
    return bool((usage <= problem.capacity * (1 + rtol) + rtol).all())


def assert_capacity_feasible(problem: AllocationProblem) -> None:
    """Raise :class:`CapacityError` when no allocation fits the capacities.

    Shared pre-check of all three solvers (heuristic, ML, MILP) so an
    infeasible instance produces the *same* typed error from every one of
    them. Feasibility of {A >= 0, columns sum to 1, (R o A).1 <= capacity}
    is a small transportation LP, but most instances never need it: the
    verdict is cached on the (frozen) problem, an unbounded platform or a
    greedy cheapest-placement that fits proves feasibility outright, and a
    cheap necessary condition (even each task's cheapest placement exceeds
    the summed capacity) short-circuits the aggregate-infeasible case with
    a precise message. The LP runs only when every cheap test is
    inconclusive.
    """
    if not problem.has_capacity:
        return
    verdict = getattr(problem, "_cap_feasible", None)
    if verdict is True:
        return
    if isinstance(verdict, CapacityError):
        raise verdict
    R, cap = problem.resource, problem.capacity
    best_case = R.min(axis=0).sum()  # every task on its cheapest platform
    total_cap = cap.sum()
    if best_case > total_cap * (1 + CAPACITY_RTOL):
        err = CapacityError(
            f"workload needs >= {best_case:.6g} resource units even on each "
            f"task's cheapest platform, but the fleet holds {total_cap:.6g}")
        object.__setattr__(problem, "_cap_feasible", err)
        raise err
    # sufficient checks, cheapest first: any unbounded platform can absorb
    # the whole workload; otherwise try placing each task wholly on its
    # cheapest platform and see whether that already fits the budgets.
    if np.isinf(cap).any():
        object.__setattr__(problem, "_cap_feasible", True)
        return
    cheapest = R.argmin(axis=0)
    usage = np.bincount(cheapest, weights=R[cheapest, np.arange(problem.tau)],
                        minlength=problem.mu)
    if (usage <= cap * (1 + CAPACITY_RTOL)).all():
        object.__setattr__(problem, "_cap_feasible", True)
        return
    # exact check: feasibility LP over the shares (HiGHS, mu*tau variables;
    # only the finite capacity rows can ever bind)
    from scipy.optimize import linprog
    import scipy.sparse as sp

    mu, tau = problem.mu, problem.tau
    n = mu * tau
    jj = np.arange(n)
    A_eq = sp.csr_matrix((np.ones(n), (jj % tau, jj)), shape=(tau, n))
    finite = np.nonzero(np.isfinite(cap))[0]
    rows = np.repeat(np.arange(finite.size), tau)
    cols = (finite[:, None] * tau + np.arange(tau)[None, :]).ravel()
    A_ub = sp.csr_matrix((R[finite].ravel(), (rows, cols)),
                         shape=(finite.size, n))
    res = linprog(np.zeros(n), A_ub=A_ub, b_ub=cap[finite], A_eq=A_eq,
                  b_eq=np.ones(tau), bounds=(0, 1), method="highs")
    if not res.success:
        err = CapacityError(
            "no allocation satisfies the per-platform capacities "
            f"(capacity={np.array2string(cap, precision=4)}; LP status "
            f"{res.status}: {res.message})")
        object.__setattr__(problem, "_cap_feasible", err)
        raise err
    object.__setattr__(problem, "_cap_feasible", True)


# -- sub-problems over remaining work (online re-allocation) -----------------
#
# Mid-workload, part of every task is already executed and some platforms may
# be gone (outage). The re-solve therefore runs on a *restricted* problem:
# surviving platform rows, still-active task columns, and each kept task's
# work scaled by its remaining fraction. Completed shares stay fixed — they
# are simply absent from the sub-problem — and the solution is expanded back
# into the full (mu, tau) frame for dispatch accounting.

def restrict_problem(
    problem: AllocationProblem,
    platforms: Sequence[int] | None = None,
    tasks: Sequence[int] | None = None,
    remaining: Sequence[float] | None = None,
    offsets: Sequence[float] | None = None,
    capacity: Sequence[float] | None = None,
) -> AllocationProblem:
    """Sub-problem over platform rows / task columns with remaining work.

    ``remaining`` (aligned with the kept ``tasks``) scales each kept task's
    delta column by its outstanding work fraction; both shipped reductions
    (inverse-square and linear) are linear in delta, so this scales the work
    matrix W by exactly that fraction while gamma — charged per dispatch,
    however little work remains — is kept whole. ``offsets`` (full-frame,
    one per original platform) carries each platform's already-elapsed
    busy time into the sub-problem, so the re-solve minimises finish time
    rather than piling remaining work onto a platform that is merely idle
    *in the sub-problem's frame*.

    The resource dimension restricts the same way: kept resource columns
    scale by ``remaining`` (consumption is linear in the outstanding
    share), and ``capacity`` (full-frame, one per original platform)
    overrides each platform's budget with whatever it has *left* — held
    shards of still-active tasks are committed history a mid-run re-solve
    must fit around, exactly as ``offsets`` carries elapsed time.
    """
    rows = np.arange(problem.mu) if platforms is None else np.asarray(platforms, dtype=int)
    cols = np.arange(problem.tau) if tasks is None else np.asarray(tasks, dtype=int)
    if rows.size == 0 or cols.size == 0:
        raise ValueError("restricted problem needs >= 1 platform and >= 1 task")
    # Avoid np.ix_ fancy-indexing copies where a cheaper path exists: a
    # full-frame restriction (rows and cols both identity) reuses the parent
    # arrays outright, and restricting only one axis copies O(kept) rather
    # than materialising the index product. Matters for the O(k) incremental
    # re-solve path, where cols is k << tau.
    rows_all = platforms is None or (
        rows.size == problem.mu and rows[0] == 0 and rows[-1] == problem.mu - 1
        and np.array_equal(rows, np.arange(problem.mu)))
    cols_all = tasks is None or (
        cols.size == problem.tau and cols[0] == 0 and cols[-1] == problem.tau - 1
        and np.array_equal(cols, np.arange(problem.tau)))

    def _take(M):
        if M is None:
            return None
        if rows_all and cols_all:
            return M
        if cols_all:
            return M[rows]
        if rows_all:
            return M[:, cols]
        return M[np.ix_(rows, cols)]

    delta = _take(problem.delta)
    resource = _take(problem.resource)
    if remaining is not None:
        r = np.asarray(remaining, dtype=np.float64)
        if r.shape != (cols.size,):
            raise ValueError(f"remaining must align with kept tasks: {r.shape} vs {cols.size}")
        if (r <= 0).any() or (r > 1 + 1e-9).any():
            raise ValueError("remaining fractions must be in (0, 1]")
        delta = delta * r[None, :]
        if resource is not None:
            resource = resource * r[None, :]
    off = problem.offsets if offsets is None else np.asarray(offsets, dtype=np.float64)
    if capacity is not None and problem.resource is None:
        raise ValueError("capacity override needs a problem with a resource matrix")
    cap = problem.capacity if capacity is None else np.asarray(capacity, dtype=np.float64)
    return AllocationProblem(delta=delta, gamma=_take(problem.gamma),
                             c=problem.c if cols_all else problem.c[cols],
                             reduction=problem.reduction,
                             offsets=off if rows_all else off[rows],
                             resource=resource,
                             capacity=cap if cap is None or rows_all else cap[rows])


def restrict_allocation(A: np.ndarray, platforms: Sequence[int],
                        tasks: Sequence[int]) -> np.ndarray:
    """Project an allocation into a sub-problem frame (warm-start incumbent).

    Columns that lose all their mass (every supporting platform dropped)
    fall back to a uniform share over the kept platforms; all columns are
    renormalised to sum to 1.
    """
    rows = np.asarray(platforms, dtype=int)
    cols = np.asarray(tasks, dtype=int)
    sub = np.asarray(A, dtype=np.float64)[np.ix_(rows, cols)].copy()
    colsum = sub.sum(axis=0)
    orphan = colsum <= SUPPORT_ATOL
    if orphan.any():
        sub[:, orphan] = 1.0 / rows.size
        colsum = sub.sum(axis=0)
    return sub / colsum


def expand_allocation(A_sub: np.ndarray, mu: int, tau: int,
                      platforms: Sequence[int], tasks: Sequence[int]) -> np.ndarray:
    """Embed a sub-problem allocation back into the full (mu, tau) frame.

    Dropped rows/columns are zero — completed tasks need no allocation and
    dead platforms must receive none — so the result is *not* a valid full
    allocation (done columns do not sum to 1); it is the dispatch plan for
    the remaining work only.
    """
    full = np.zeros((mu, tau))
    full[np.ix_(np.asarray(platforms, dtype=int), np.asarray(tasks, dtype=int))] = A_sub
    return full


def check_allocation(A: np.ndarray, problem: AllocationProblem, atol: float = 1e-6) -> None:
    """Validate the eq. 10 constraints (and, when the problem carries a
    resource dimension, the capacity rows); raises AssertionError on
    violation."""
    A = np.asarray(A)
    assert A.shape == (problem.mu, problem.tau), (A.shape, problem.mu, problem.tau)
    assert (A >= -atol).all(), "negative allocation"
    col = A.sum(axis=0)
    assert np.allclose(col, 1.0, atol=atol), f"column sums != 1 (max err {np.abs(col - 1).max():.2e})"
    if problem.capacity is not None:
        usage = platform_usage(A, problem)
        over = usage - problem.capacity
        assert capacity_ok(A, problem, rtol=max(atol, CAPACITY_RTOL)), \
            f"capacity exceeded (max over {over.max():.6g} units)"
