"""Machine-learning allocation (paper §4.3.3).

The paper's ML approach starts from the proportional heuristic and improves
it with simulated annealing followed by a "polishing" convex step
(Dantzig's simplex). SciPy removed ``anneal`` upstream, so this module
implements the same scheme natively: the annealer runs many independent
chains as one batch of PyTorch tensors, on the card unless the caller asks
for the CPU.

Moves operate on one task column at a time: move a fraction (or all) of a
task's share from a source platform (sampled ∝ current share) to a random
destination. "Move all" moves are essential — they are the only way to
*clear* a platform's gamma constant, i.e. to cross the non-linear part of
the objective that the LP polish cannot see.

The polish fixes the binary support B = ceil(A) found by the SA and solves
the then-*linear* restriction of eq. 10 exactly with HiGHS
(``scipy.optimize.linprog``): minimise t s.t. W∘A·1 + (gamma∘B)·1 <= t,
columns of A sum to 1, supp(A) ⊆ B. Entries the LP drives to zero shrink
the support, so the polish is iterated to a fixed point.

Problems carrying the optional resource/capacity dimension anneal a
*penalised* objective (relative capacity overflow, makespan-scaled) with
repair-biased moves (overloaded platforms are preferred sources and
avoided destinations), start every chain from a capacity-clamped seed, and
polish with the capacity rows in the LP — so the returned allocation is
always feasible.

The chains draw from a ``torch.Generator``, not JAX's key splits, so an
annealed allocation is not the reference's bit for bit; the heuristic
start, the chain seeds, the warm start, the capacity clamp and the polish
are the reference's host code unchanged.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

from repro_torch.device import resolve_device
from .allocation import (
    SUPPORT_ATOL,
    Allocation,
    AllocationProblem,
    assert_capacity_feasible,
    capacity_ok,
    makespan,
)
from .heuristic import clamp_to_capacity, incumbent_shortcut, proportional_allocation

__all__ = ["ml_allocation", "lp_polish", "anneal"]


# --------------------------------------------------------------------------
# Batched annealing chains
# --------------------------------------------------------------------------

def _objective(A, W, G, off, R, cap_safe, rho):
    """Penalised makespan of every chain, from scratch: eq. 10 plus a
    relative capacity-overflow term. ``A`` is (chains, tau, mu).

    ``cap_safe`` is the capacity vector with non-finite/zero entries
    replaced by a sentinel that makes the relative overflow 0/negative, so
    capacity-free problems pay nothing. ``rho`` carries the makespan scale
    (resource units can be bytes — the penalty must be scale-free)."""
    Wt, Gt, Rt = W.t(), G.t(), R.t()
    H = ((Wt * A).sum(dim=1)
         + torch.where(A > SUPPORT_ATOL, Gt, 0.0).sum(dim=1) + off)
    over = ((Rt * A).sum(dim=1) / cap_safe - 1.0).clamp_min(0.0)
    return H.amax(dim=1) + rho * over.sum(dim=1)


def _anneal_chains(A, W, G, off, R, cap_safe, rho, temps, draws):
    """Run every chain through the whole schedule; returns (A, objective).

    ``A`` is (chains, tau, mu): a task's column is a contiguous row. The
    move kernel is *incremental*: a move touches one task column, so
    instead of recomputing the full O(mu*tau) objective per step each chain
    carries the per-platform aggregates the objective is made of —
    ``workH = (W∘A)·1``, ``gamH = (gamma∘ceil A)·1``, ``usage = (R∘A)·1`` —
    and updates them with the O(mu) column delta.

    ``draws`` holds every random number of the schedule, (steps, chains,
    2 mu + 4) uniforms drawn in one call, so the loop draws nothing: task
    index, Gumbel noise for the source and the destination, move-all,
    fraction, accept. Each chain returns its *final* state, with the
    objective recomputed once from scratch so the reported value carries
    no accumulated float drift.
    """
    chains, tau, mu = A.shape
    atol = SUPPORT_ATOL
    Wt, Gt, Rt = W.t().contiguous(), G.t().contiguous(), R.t().contiguous()
    rows = torch.arange(chains, device=A.device)
    workH = (Wt * A).sum(dim=1)
    gamH = torch.where(A > atol, Gt, 0.0).sum(dim=1)
    usage = (Rt * A).sum(dim=1)
    m_cur = ((workH + gamH + off).amax(dim=1)
             + rho * (usage / cap_safe - 1.0).clamp_min(0.0).sum(dim=1))

    task = (draws[..., 0] * tau).long().clamp_max(tau - 1)
    gumbel = -torch.log(-torch.log(draws[..., 1:1 + 2 * mu]))
    g_src, g_dst = gumbel[..., :mu], gumbel[..., mu:]
    frac = torch.where(draws[..., 2 * mu + 1] < 0.5, 1.0,
                       draws[..., 2 * mu + 2])  # move all w.p. 1/2
    u_accept = draws[..., 2 * mu + 3]

    for k in range(temps.shape[0]):
        j = task[k]
        col = A[rows, j]
        # repair bias: overloaded platforms are preferred sources and
        # avoided destinations (zero bias when no capacity row binds)
        bias = torch.where(usage / cap_safe - 1.0 > 0, 4.0, 0.0)
        # source ∝ current share, destination uniform, both by Gumbel-max
        src = (torch.log(col + 1e-12) + bias + g_src[k]).argmax(dim=1, keepdim=True)
        dst = (g_dst[k] - bias).argmax(dim=1, keepdim=True)
        amount = col.gather(1, src) * frac[k, :, None]
        col_new = col.scatter_add(1, src, -amount).scatter_add(1, dst, amount)
        d = col_new - col
        dsupp = (col_new > atol).float() - (col > atol).float()
        workH_new = workH + Wt[j] * d
        gamH_new = gamH + Gt[j] * dsupp
        usage_new = usage + Rt[j] * d
        m_new = ((workH_new + gamH_new + off).amax(dim=1)
                 + rho * (usage_new / cap_safe - 1.0).clamp_min(0.0).sum(dim=1))
        accept = (m_new < m_cur) | (
            u_accept[k] < torch.exp(-(m_new - m_cur) / temps[k].clamp_min(1e-30)))
        keep = accept[:, None]
        A[rows, j] = torch.where(keep, col_new, col)
        workH = torch.where(keep, workH_new, workH)
        gamH = torch.where(keep, gamH_new, gamH)
        usage = torch.where(keep, usage_new, usage)
        m_cur = torch.where(accept, m_new, m_cur)
    # exact objective of the final state (no incremental float drift)
    return A, _objective(A, W, G, off, R, cap_safe, rho)


def anneal(
    problem: AllocationProblem,
    A_starts: np.ndarray,
    *,
    steps: int = 4000,
    seed: int = 0,
    T0_frac: float = 0.05,
    Tf_frac: float = 1e-5,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Run one SA round over a batch of start allocations on ``device``.

    Returns (annealed allocations [chains, mu, tau], their exact penalised
    objectives [chains] — equal to the makespan for capacity-feasible
    results). Each chain returns its final state: by the end of the
    geometric schedule the walk is effectively greedy, and carrying a
    running argmin would cost an O(mu*tau) copy per step — exactly the
    scaling the incremental kernel exists to avoid.
    """
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    W = torch.as_tensor(problem.work, **f32)
    G = torch.as_tensor(problem.gamma, **f32)
    off = torch.as_tensor(problem.offsets, **f32)
    A = torch.as_tensor(np.asarray(A_starts).transpose(0, 2, 1), **f32).contiguous()
    chains, mu = A.shape[0], problem.mu
    # temperature scale from the offset-STRIPPED makespan: on a late online
    # re-solve the committed offsets dominate the objective's absolute value
    # while moves only shift the remaining-work part, and an offsets-scaled
    # T0 would accept everything (random walk) through most of the schedule
    m_start = makespan(A_starts[0],
                       dataclasses.replace(problem, offsets=None))
    if problem.capacity is not None:
        R = torch.as_tensor(problem.resource, **f32)
        cap_safe = torch.as_tensor(
            np.where(problem.capacity > 0, problem.capacity, 1e-30), **f32)
        # a row 10% over its budget costs ~40% of a makespan — steep enough
        # that the schedule anneals into the feasible region, shallow enough
        # that chains can tunnel through it early on
        rho = 4.0 * max(m_start, 1e-30)
    else:
        R = torch.zeros_like(W)
        cap_safe = torch.full((mu,), float("inf"), **f32)
        rho = 0.0
    # geometric temperature schedule
    T0, Tf = m_start * T0_frac, m_start * Tf_frac
    with np.errstate(divide="ignore", invalid="ignore"):
        temps = T0 * (Tf / T0) ** (np.arange(steps) / steps)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draws = torch.rand((steps, chains, 2 * mu + 4), generator=gen, **f32)
    A, m = _anneal_chains(A, W, G, off, R, cap_safe, rho,
                          torch.as_tensor(temps, **f32), draws)
    return (A.transpose(1, 2).cpu().numpy().astype(np.float64),
            m.cpu().numpy().astype(np.float64))


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


# --------------------------------------------------------------------------
# Full ML allocation
# --------------------------------------------------------------------------

def ml_allocation(
    problem: AllocationProblem,
    *,
    chains: int = 32,
    steps: int = 4000,
    rounds: int = 2,
    seed: int = 0,
    time_limit: float = 600.0,
    polish_top_k: int = 4,
    incumbent: Allocation | None = None,
    warm_tol: float = 0.05,
    device: str | torch.device = "cuda",
) -> Allocation:
    """Heuristic start → multi-chain SA → iterated LP polish (paper §4.3.3).

    ``incumbent`` (online re-solves) first tries the warm-start early exit
    (:func:`incumbent_shortcut`); when the solve does proceed, the incumbent
    seeds one SA chain so the annealer explores from the executing
    allocation as well as from scratch. The chains run on ``device``; the
    heuristic, the seeds and the polish run on the host.
    """
    t_start = time.perf_counter()
    assert_capacity_feasible(problem)
    device = resolve_device(device)
    warm_meta = {}
    A_inc = None
    if incumbent is not None:
        A_inc, shortcut, warm_meta = incumbent_shortcut(
            problem, incumbent, "ml", warm_tol, t_start)
        if shortcut is not None:
            return shortcut
        if warm_meta.get("warm_start") == "rejected":
            # the executing plan violates the (remaining) capacities —
            # repair it before it seeds anything
            A_inc = clamp_to_capacity(A_inc, problem)
    rng = np.random.default_rng(seed)
    heur = proportional_allocation(problem)
    mu, tau = problem.mu, problem.tau

    # Chain starts: the heuristic, plus atomic random assignments (sparse
    # supports let the SA explore the low-gamma region immediately); every
    # seed is clamped into the capacity rows so chains start feasible.
    A_starts = np.zeros((chains, mu, tau))
    if chains > 1:
        choice = rng.integers(0, mu, size=(chains - 1, tau))
        A_starts[np.repeat(np.arange(1, chains), tau),
                 choice.ravel(),
                 np.tile(np.arange(tau), chains - 1)] = 1.0
        if problem.has_capacity:
            for idx in range(1, chains):
                A_starts[idx] = clamp_to_capacity(A_starts[idx], problem)
    A_starts[0] = heur.A  # keep the heuristic verbatim in chain 0
    if A_inc is not None and chains > 1:
        A_starts[1] = A_inc  # warm start: one chain anneals the incumbent
    build_s = time.perf_counter() - t_start

    best_A, best_m = heur.A, heur.makespan
    if A_inc is not None and capacity_ok(A_inc, problem):
        m_inc = makespan(A_inc, problem)
        if m_inc < best_m:
            best_A, best_m = A_inc, m_inc
    round_idx = 0
    anneal_s = polish_s = 0.0
    while round_idx < rounds and (time.perf_counter() - t_start) < time_limit:
        t_a = time.perf_counter()
        cand_A, cand_m = anneal(problem, A_starts, steps=steps,
                                seed=seed + round_idx, device=device)
        anneal_s += time.perf_counter() - t_a
        order = np.argsort(cand_m)
        t_p = time.perf_counter()
        for idx in order[:polish_top_k]:
            if (time.perf_counter() - t_start) >= time_limit:
                break
            A2, m2 = _iterated_polish(problem, cand_A[idx])
            if A2 is not None and m2 < best_m:
                best_A, best_m = A2, m2
        polish_s += time.perf_counter() - t_p
        # re-seed the next round from the winners (exploitation)
        A_starts = cand_A[order][np.arange(chains) % max(len(order), 1)]
        round_idx += 1

    return Allocation(
        A=best_A,
        makespan=best_m,
        solver="ml",
        solve_time=time.perf_counter() - t_start,
        meta={"chains": chains, "steps": steps, "rounds": round_idx,
              "heuristic_makespan": heur.makespan,
              "build_s": build_s, "solve_s": anneal_s, "polish_s": polish_s,
              "n_vars": mu * tau,
              "n_constraints": tau + mu + (mu if problem.has_capacity else 0),
              **warm_meta},
    )
