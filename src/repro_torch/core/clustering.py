"""Task-family clustering: solve the allocation on super-tasks.

Production workloads are dominated by *families* of structurally identical
tasks: requests of the same (model, n_steps) pair, LM calls from the same
request family. Two tasks with the same work column, the same gamma column,
the same resource column and the same quality target are interchangeable to
eq. 10 — the objective only sees their *summed* shares per platform. This
module exploits that: group tasks by their (delta, gamma, resource, c)
signature, solve the reduced problem over one super-task per family, and
split the super-task's shares back over the members.

The work/resource dimensions reduce exactly (both are linear in the
shares), so the reduction's only modelling freedom is gamma — the constant
each platform pays *per member it touches*, which a single aggregated
column cannot express. Three models are shipped (see
:meth:`ClusterPlan.reduce`), and :func:`clustered_allocation` solves the
small reduced problem under more than one, expands each candidate, then
refines at *member* granularity: a greedy descent that moves whole member
shares off the bottleneck platform, alternated with the exact fixed-support
LP polish. The exactness anchor is the ``sum`` model with the proportional
expansion, whose reduced objective equals the expanded full-frame makespan
identically; the default (model ensemble + contiguous expansion + descent +
polish) trades that identity for near-optimal quality at a solve cost
driven by the number of *families*, not the number of tasks.

Near-identical families (``rtol > 0``) quantise the signature on a
relative grid, cluster by grid cell, and represent each family by its
summed columns — the bounded-error fallback: any member's column differs
from the family representative by at most O(rtol), so expanded latencies
differ by the same relative order. Capacity rows are re-checked after
expansion and repaired via the water-filling clamp.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .allocation import (
    Allocation,
    AllocationProblem,
    SUPPORT_ATOL,
    capacity_ok,
    makespan,
    platform_latencies,
    platform_usage,
)
from .heuristic import clamp_to_capacity, proportional_allocation

__all__ = ["ClusterPlan", "cluster_tasks", "clustered_allocation"]


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Mapping between a full problem's tasks and its super-tasks.

    groups : member column indices per super-task, in order of first
             appearance — ``groups[k]`` are the full-frame columns fused
             into reduced column k.
    tau    : number of tasks in the full frame.
    rtol   : the relative quantisation used to form the groups (0 = exact
             byte-identical signatures).
    """

    groups: tuple[tuple[int, ...], ...]
    tau: int
    rtol: float = 0.0

    @property
    def n_clusters(self) -> int:
        return len(self.groups)

    @property
    def member_of(self) -> np.ndarray:
        """(tau,) array mapping each full-frame column to its group index."""
        out = np.empty(self.tau, dtype=int)
        for k, members in enumerate(self.groups):
            out[list(members)] = k
        return out

    def reduce(self, problem: AllocationProblem,
               gamma_model: str = "indicator") -> AllocationProblem:
        """The super-task problem over member-summed columns.

        Work columns sum exactly: both shipped reductions are linear in
        delta, so a super-task share ``f`` on platform i costs exactly the
        work of ``f`` of every member. The reduced problem is expressed
        directly in work units (c = 1): its columns already carry the
        parent's quality reduction.

        Gamma needs a model — the true constant cost is *per member
        touched* (under the contiguous split, a platform holding share
        ``f`` of an m-member family touches ~``m*f (+1)`` members), which
        a single aggregated column cannot express:

        ``indicator`` (default): all-but-one member's gamma folds into the
        work column (linear in f) and the indicator charges one member's
        gamma — exact at ``f = 1/m`` and ``f = 1``, overcharges mid-range
        by less than one member constant per (platform, family).

        ``fold``: the whole summed gamma folds into the work column and
        the indicator vanishes — the reduced problem becomes (nearly) an
        LP, exact at every integer member count, but *under*charges tiny
        slivers, so solvers over-spread; best at high multiplicity.

        ``sum``: a platform touching the super-task pays every member's
        gamma — the conservative model, and the one under which the
        reduced objective equals the proportional expansion's true
        makespan identically (the exactness anchor). Over-prices
        spreading, so solvers over-concentrate.
        """
        if problem.tau != self.tau:
            raise ValueError(f"plan built for tau={self.tau}, problem has {problem.tau}")
        if gamma_model not in ("indicator", "fold", "sum"):
            raise ValueError(f"unknown gamma_model {gamma_model!r}")
        K = self.n_clusters
        W = problem.work
        work = np.empty((problem.mu, K))
        gamma = np.empty((problem.mu, K))
        resource = None if problem.resource is None else np.empty((problem.mu, K))
        for k, members in enumerate(self.groups):
            idx = list(members)
            g_sum = problem.gamma[:, idx].sum(axis=1)
            work[:, k] = W[:, idx].sum(axis=1)
            if gamma_model == "sum":
                gamma[:, k] = g_sum
            elif gamma_model == "fold":
                work[:, k] += g_sum
                gamma[:, k] = 0.0
            else:
                g_rep = g_sum / len(idx)
                work[:, k] += g_sum - g_rep
                gamma[:, k] = g_rep
            if resource is not None:
                resource[:, k] = problem.resource[:, idx].sum(axis=1)
        reduced = AllocationProblem.from_work(work, gamma)
        return dataclasses.replace(reduced, offsets=problem.offsets,
                                   resource=resource, capacity=problem.capacity)

    def expand(self, A_reduced: np.ndarray, mode: str = "contiguous") -> np.ndarray:
        """Split super-task shares back over the members.

        ``proportional``: every member gets the super-task's share vector —
        per-platform work/gamma-sum/usage equal the reduced solution's
        exactly, but every supporting platform touches every member.

        ``contiguous``: the members are laid out consecutively on [0, m)
        and each platform's share of the super-task becomes a contiguous
        segment; a member's share on a platform is the overlap of its unit
        interval with the platform's segment. Per-platform *mass* (work,
        usage) is unchanged, while each platform now touches only the
        members inside its segment — it sheds gamma constants relative to
        the proportional split, so its true latency is never worse for
        identical families.
        """
        A_reduced = np.asarray(A_reduced, dtype=np.float64)
        mu = A_reduced.shape[0]
        if A_reduced.shape != (mu, self.n_clusters):
            raise ValueError(f"reduced allocation is {A_reduced.shape}, "
                             f"plan has {self.n_clusters} clusters")
        A = np.zeros((mu, self.tau))
        for k, members in enumerate(self.groups):
            idx = list(members)
            m = len(idx)
            f = A_reduced[:, k]
            if m == 1 or mode == "proportional":
                A[:, idx] = f[:, None]
                continue
            bounds = m * np.concatenate(([0.0], np.cumsum(f)))
            starts = np.arange(m, dtype=np.float64)
            lo = np.maximum(bounds[:-1, None], starts[None, :])
            hi = np.minimum(bounds[1:, None], (starts + 1.0)[None, :])
            S = np.clip(hi - lo, 0.0, None)  # (mu, m) member shares
            S[S < SUPPORT_ATOL] = 0.0
            colsum = S.sum(axis=0)
            short = colsum <= SUPPORT_ATOL  # float-drift stranded a member
            if short.any():
                S[:, short] = f[:, None]
                colsum = S.sum(axis=0)
            A[:, idx] = S / colsum
        return A


def cluster_tasks(problem: AllocationProblem, rtol: float = 0.0) -> ClusterPlan:
    """Group tasks whose (delta, gamma, resource, c) columns coincide.

    ``rtol == 0`` clusters byte-identical signatures (exact). ``rtol > 0``
    quantises each positive entry onto a log grid of ratio ``1 + rtol`` and
    clusters by grid cell, merging near-identical families at bounded
    relative error.
    """
    feats = [problem.delta, problem.gamma]
    if problem.resource is not None:
        feats.append(problem.resource)
    F = np.vstack(feats + [problem.c[None, :]])
    if rtol > 0.0:
        with np.errstate(divide="ignore"):
            L = np.where(F > 0, np.log(np.maximum(F, 1e-300)), -np.inf)
        F = np.where(np.isfinite(L), np.round(L / np.log1p(rtol)), -np.inf)
    order: dict[bytes, int] = {}
    groups: list[list[int]] = []
    cols = np.ascontiguousarray(F.T)
    for j in range(problem.tau):
        key = cols[j].tobytes()
        k = order.get(key)
        if k is None:
            order[key] = len(groups)
            groups.append([j])
        else:
            groups[k].append(j)
    return ClusterPlan(groups=tuple(tuple(g) for g in groups),
                       tau=problem.tau, rtol=rtol)


def _member_descent(problem: AllocationProblem, A: np.ndarray,
                    max_moves: int = 400) -> np.ndarray:
    """Greedy member-granular descent on the true objective.

    Repeatedly move the *whole* of one (bottleneck-platform, task) share to
    the platform that minimises the resulting makespan, until no single
    move improves. This is the refinement the reduced frame cannot do —
    its gamma models misprice member placement by up to one constant per
    (platform, family), and exactly such whole-member moves repair it.
    Capacity rows veto any receiving platform the move would oversubscribe.
    """
    A = np.asarray(A, dtype=np.float64).copy()
    W, G = problem.work, problem.gamma
    R, cap = problem.resource, problem.capacity
    for _ in range(max_moves):
        H = platform_latencies(A, problem)
        order = np.argsort(H)
        b = int(order[-1])
        m_cur = H[b]
        runner = H[order[-2]] if H.size > 1 else 0.0
        js = np.nonzero(A[b] > SUPPORT_ATOL)[0]
        if js.size == 0:
            break
        shares = A[b, js]
        Hb_new = H[b] - W[b, js] * shares - G[b, js]
        supp = A[:, js] > SUPPORT_ATOL
        Hi_new = H[:, None] + W[:, js] * shares[None, :] + G[:, js] * (~supp)
        Hi_new[b] = np.inf
        cand = np.maximum(np.maximum(Hb_new[None, :], Hi_new), runner)
        if cap is not None:
            usage = platform_usage(A, problem)
            over = (usage[:, None] + R[:, js] * shares[None, :]
                    > cap[:, None] * (1 + 1e-9) + 1e-12)
            cand = np.where(over, np.inf, cand)
        i_best, j_best = np.unravel_index(np.argmin(cand), cand.shape)
        if cand[i_best, j_best] >= m_cur * (1 - 1e-12):
            break
        j = js[j_best]
        A[i_best, j] += A[b, j]
        A[b, j] = 0.0
    return A


def _refine(problem: AllocationProblem, A: np.ndarray,
            max_rounds: int = 3) -> tuple[np.ndarray, float]:
    """Alternate member descent with the exact fixed-support LP polish."""
    from .annealing import _iterated_polish

    best_A, best_m = A, makespan(A, problem)
    for _ in range(max_rounds):
        A1 = _member_descent(problem, best_A)
        A2, m2 = _iterated_polish(problem, A1)
        if A2 is None:
            A2, m2 = A1, makespan(A1, problem)
        if m2 < best_m * (1 - 1e-9):
            best_A, best_m = A2, m2
        else:
            break
    return best_A, best_m


def _solver_table():
    # local import: milp/annealing import heuristic, which this module uses
    from .annealing import ml_allocation
    from .milp import milp_allocation

    return {
        "heuristic": lambda p, **kw: proportional_allocation(p),
        "ml": ml_allocation,
        "milp": milp_allocation,
    }


def clustered_allocation(
    problem: AllocationProblem,
    method: str = "milp",
    *,
    rtol: float = 0.0,
    expand: str = "contiguous",
    plan: ClusterPlan | None = None,
    refine: bool = True,
    **solver_kw,
) -> Allocation:
    """Cluster task families, solve reduced, expand, refine at member level.

    Falls through to a plain solve when nothing clusters. With the default
    ``expand="contiguous"`` the reduced problem is solved under both the
    ``indicator`` and ``fold`` gamma models (it is small — that is the
    point), each candidate is expanded and refined (member descent + exact
    LP polish on the realised support), and the best true makespan wins.
    ``expand="proportional"`` is the exactness path: single ``sum``-model
    solve whose reduced objective equals the expanded makespan identically.

    The expanded allocation is capacity-checked (quantised clustering can
    overshoot by O(rtol)) and clamped back into the rows when needed; the
    proportional expansion — which preserves the reduced solution's usage —
    is the fallback when the clamp cannot repair it.

    The returned meta carries ``clustered_from`` / ``n_clusters`` /
    ``cluster_s`` so telemetry shows what the solver actually saw. A
    reduced MILP's dual bound certifies only the family-symmetric
    restriction of the full problem, so ``optimal``/``bound`` are not
    propagated.
    """
    t0 = time.perf_counter()
    solvers = _solver_table()
    if method not in solvers:
        raise ValueError(f"unknown method {method!r}; pick from {sorted(solvers)}")
    if plan is None:
        plan = cluster_tasks(problem, rtol)
    cluster_s = time.perf_counter() - t0
    if plan.n_clusters == problem.tau:
        alloc = solvers[method](problem, **solver_kw)
        alloc.meta.update(clustered_from=problem.tau, n_clusters=problem.tau,
                          cluster_rtol=rtol, cluster_s=cluster_s)
        return alloc

    models = ("sum",) if expand == "proportional" else ("indicator", "fold")
    best_A = None
    best_m = np.inf
    sub_meta: dict = {}
    sub_solver = method
    # every gamma-model sub-solve's meta is kept (meta["inner"], one per
    # model, tagged with which model it solved) — the flattened top level
    # still mirrors the first for backward compatibility, with phase
    # timings aggregated across all sub-solves
    inner_metas: list[dict] = []
    for gamma_model in models:
        reduced_problem = plan.reduce(problem, gamma_model=gamma_model)
        sub = solvers[method](reduced_problem, **solver_kw)
        inner_metas.append({"gamma_model": gamma_model, **sub.meta})
        if not sub_meta:
            sub_meta, sub_solver = dict(sub.meta), sub.solver
        if expand == "proportional":
            A = plan.expand(sub.A, mode="proportional")
        else:
            A = plan.expand(sub.A, mode="contiguous")
            A_prop = plan.expand(sub.A, mode="proportional")
            if makespan(A_prop, problem) < makespan(A, problem):
                # the true objective decides; either split is valid
                A = A_prop
            if problem.capacity is not None and not capacity_ok(A, problem):
                A = clamp_to_capacity(A, problem)
                if not capacity_ok(A, problem):
                    A = A_prop
        if refine and expand != "proportional":
            A, m = _refine(problem, A)
        else:
            m = makespan(A, problem)
        if m < best_m:
            best_A, best_m = A, m
    return Allocation(
        A=best_A,
        makespan=best_m,
        solver=sub_solver,
        solve_time=time.perf_counter() - t0,
        optimal=False,
        bound=None,
        meta={**sub_meta,
              # aggregate phase timings over every gamma-model sub-solve,
              # so the lifted spans account the whole clustered solve
              **{k: sum(float(m.get(k) or 0.0) for m in inner_metas)
                 for k in ("build_s", "solve_s", "polish_s")},
              "clustered_from": problem.tau,
              "n_clusters": plan.n_clusters, "cluster_rtol": rtol,
              "cluster_s": cluster_s, "expand_mode": expand,
              "gamma_models": list(models), "inner": inner_metas},
    )
