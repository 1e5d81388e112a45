"""Derivatives-pricing domain types (paper §4.1.2), in PyTorch.

The domain has two data types — *underlyings* (the stochastic model of the
asset) and *derivatives* (the contract payoff) — and one function,
``price``. This module defines both types plus the payoff algebra. The
dataclasses, the option constructors, the 14-column parameter layout and the
family keys are the reference's (``repro.pricing.contracts``) unchanged;
the step functions and payoffs are the same float32 expressions, in the
same operation order, on torch tensors.

All five option classes of the paper's Table 1 workload are expressible
from four per-path statistics (terminal price, running arithmetic mean,
running min, running max), which is what lets a single Monte Carlo kernel
serve every contract:

    European              max(±(S_T - K), 0)
    Asian (arithmetic)    max(±(avg - K), 0)
    Barrier (up-and-out)  1[max < B_up] * European
    Double barrier (KO)   1[B_lo < min and max < B_up] * European
    Digital double (no-touch)  Q * 1[B_lo < min and max < B_up]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "BlackScholes", "Heston", "bs_step_fn", "heston_step_fn",
    "EUROPEAN", "ASIAN", "BARRIER", "DOUBLE_BARRIER", "DIGITAL_DOUBLE_BARRIER",
    "Option", "european", "asian", "barrier", "double_barrier",
    "digital_double_barrier", "payoff_from_stats", "payoff_from_stats_coded",
    "PricingTask", "TaskBatch", "PARAM_COLS", "COL", "N_PARAMS",
    "family_key", "group_by_family", "launch_key", "group_by_launch",
    "resolve_device",
]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------
# Underlyings
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlackScholes:
    """Geometric Brownian motion: dS = r S dt + sigma S dW."""

    spot: float
    rate: float
    volatility: float

    kind: str = dataclasses.field(default="black-scholes", init=False, repr=False)


@dataclasses.dataclass(frozen=True)
class Heston:
    """Heston stochastic volatility:

        dS = r S dt + sqrt(v) S dW_S
        dv = kappa (theta - v) dt + xi sqrt(v) dW_v,  corr(dW_S, dW_v) = rho

    Simulated with the full-truncation Euler scheme (v clamped at 0 inside
    drift and diffusion), the standard bias/robustness trade-off.
    """

    spot: float
    rate: float
    v0: float
    kappa: float
    theta: float
    xi: float
    rho: float

    kind: str = dataclasses.field(default="heston", init=False, repr=False)


# --------------------------------------------------------------------------
# Underlying dynamics — the single definition of each Euler step
# --------------------------------------------------------------------------
#
# Scalar-parameterised step constructors shared by the path statistics
# (0-d parameters) and the kernel's plain version (per-task (T, 1) columns).
# ``csrc/mc_paths.cu`` writes the same expressions in the same order.

def bs_step_fn(rate, vol, dt):
    """GBM log-Euler step: ``step(s, (z, _)) -> s'``. float32 tensors."""
    drift = (rate - 0.5 * vol * vol) * dt
    vol_dt = vol * torch.sqrt(dt)

    def step(s, z):
        z_s, _ = z
        return s * torch.exp(drift + vol_dt * z_s)

    return step


def heston_step_fn(rate, kappa, theta, xi, rho, dt):
    """Full-truncation Euler Heston step: ``step((s, v), (z_s, z2))``.

    v is clamped at 0 inside drift and diffusion (the standard
    bias/robustness trade-off); z2 is mixed into the vol shock via rho.
    """
    rho_c = torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0))
    sqrt_dt = torch.sqrt(dt)

    def step(carry, z):
        s, v = carry
        z_s, z2 = z
        z_v = rho * z_s + rho_c * z2
        v_plus = torch.clamp_min(v, 0.0)
        sqrt_v = torch.sqrt(v_plus)
        s_new = s * torch.exp((rate - 0.5 * v_plus) * dt
                              + sqrt_v * sqrt_dt * z_s)
        v_new = v + kappa * (theta - v_plus) * dt + xi * sqrt_v * sqrt_dt * z_v
        return (s_new, v_new)

    return step


# --------------------------------------------------------------------------
# Derivatives
# --------------------------------------------------------------------------

EUROPEAN, ASIAN, BARRIER, DOUBLE_BARRIER, DIGITAL_DOUBLE_BARRIER = range(5)

_PAYOFF_NAMES = {
    EUROPEAN: "E", ASIAN: "A", BARRIER: "B",
    DOUBLE_BARRIER: "DB", DIGITAL_DOUBLE_BARRIER: "DDB",
}


@dataclasses.dataclass(frozen=True)
class Option:
    payoff: int
    strike: float = 0.0
    lower: float = 0.0
    upper: float = math.inf
    payout: float = 1.0  # digital options
    call: bool = True

    @property
    def code(self) -> str:
        return _PAYOFF_NAMES[self.payoff]


def european(strike: float, call: bool = True) -> Option:
    return Option(EUROPEAN, strike=strike, call=call)


def asian(strike: float, call: bool = True) -> Option:
    return Option(ASIAN, strike=strike, call=call)


def barrier(strike: float, upper: float, call: bool = True) -> Option:
    """Up-and-out knock-out barrier option (discretely monitored)."""
    return Option(BARRIER, strike=strike, upper=upper, call=call)


def double_barrier(strike: float, lower: float, upper: float, call: bool = True) -> Option:
    return Option(DOUBLE_BARRIER, strike=strike, lower=lower, upper=upper, call=call)


def digital_double_barrier(payout: float, lower: float, upper: float) -> Option:
    """No-touch digital: pays ``payout`` iff the path stays inside (lo, up)."""
    return Option(DIGITAL_DOUBLE_BARRIER, payout=payout, lower=lower, upper=upper)


def payoff_from_stats(s_t, avg, mn, mx, option: Option):
    """Undiscounted float32 payoff from per-path statistics."""
    sign = _f32(1.0 if option.call else -1.0, s_t)
    strike = _f32(option.strike, s_t)
    zero = _f32(0.0, s_t)
    vanilla = torch.maximum(sign * (s_t - strike), zero)
    asian_p = torch.maximum(sign * (avg - strike), zero)
    alive_up = mx < _f32(option.upper, s_t)
    alive = alive_up & (mn > _f32(option.lower, s_t))
    if option.payoff == EUROPEAN:
        return vanilla
    if option.payoff == ASIAN:
        return asian_p
    if option.payoff == BARRIER:
        return torch.where(alive_up, vanilla, zero)
    if option.payoff == DOUBLE_BARRIER:
        return torch.where(alive, vanilla, zero)
    if option.payoff == DIGITAL_DOUBLE_BARRIER:
        return torch.where(alive, _f32(option.payout, s_t), zero)
    raise ValueError(f"unknown payoff {option.payoff}")


def payoff_from_stats_coded(s_t, avg, mn, mx, strike, lower, upper, payout,
                            call_sign, kind):
    """Runtime-parameterised payoff: every contract field is a tensor.

    The batched engine's counterpart of :func:`payoff_from_stats`: the
    payoff *kind* is an int32 code selected by masking, so one launch serves
    any mix of Table 1 contracts. Operands broadcast (per-task (T, 1)
    columns against (T, paths) statistics). The upper barrier may be
    float32 ``inf``; comparisons against it stay exact.
    """
    zero = _f32(0.0, s_t)
    vanilla = torch.maximum(call_sign * (s_t - strike), zero)
    asian_p = torch.maximum(call_sign * (avg - strike), zero)
    alive_up = mx < upper
    alive = alive_up & (mn > lower)
    return torch.where(
        kind == EUROPEAN, vanilla,
        torch.where(
            kind == ASIAN, asian_p,
            torch.where(
                kind == BARRIER, torch.where(alive_up, vanilla, zero),
                torch.where(
                    kind == DOUBLE_BARRIER, torch.where(alive, vanilla, zero),
                    torch.where(alive, payout, zero)))))


# --------------------------------------------------------------------------
# Task = underlying + derivative + simulation spec
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PricingTask:
    """One atomic (but divisible-by-paths) pricing task.

    ``task_id`` seeds the RNG stream so every task draws from a disjoint,
    decomposition-independent random stream.
    """

    underlying: BlackScholes | Heston
    option: Option
    maturity: float
    n_steps: int
    task_id: int = 0
    category: str = ""

    @property
    def discount(self) -> float:
        return math.exp(-self.underlying.rate * self.maturity)

    @property
    def normals_per_step(self) -> int:
        return 2 if isinstance(self.underlying, Heston) else 1


# --------------------------------------------------------------------------
# Task families and struct-of-arrays batching
# --------------------------------------------------------------------------
#
# The unit of a launch is (underlying model, n_steps), not the individual
# task. All per-task numbers (spot, rate, vol/Heston params,
# maturity-derived dt, strike, barriers, payout, call sign) are packed into
# one (T, N_PARAMS) f32 array that the kernel reads at run time, so one
# launch prices any mix of tasks with the same model and step count.

#: Column layout of ``TaskBatch.params`` — shared by the plain version and
#: the CUDA kernel (whose ``Col`` enum must list the same order).
PARAM_COLS: tuple[str, ...] = (
    "spot", "rate", "dt",                        # simulation
    "vol",                                       # Black-Scholes
    "v0", "kappa", "theta", "xi", "rho",         # Heston
    "strike", "lower", "upper", "payout",        # contract
    "call_sign",
)
COL: dict[str, int] = {name: i for i, name in enumerate(PARAM_COLS)}
N_PARAMS = len(PARAM_COLS)


def family_key(task: PricingTask) -> tuple[str, int, int]:
    """(model kind, payoff family, n_steps) — the Table 1 family key."""
    return (task.underlying.kind, task.option.payoff, task.n_steps)


def launch_key(task: PricingTask) -> tuple[str, int]:
    """(model kind, n_steps) — the *compilation* grouping key.

    Strictly coarser than :func:`family_key`: payoff kind is a runtime code
    (see :func:`payoff_from_stats_coded`), so families differing only in
    contract type share one compiled executable.  Only the step function
    (BS vs Heston) and the loop bound are structural.
    """
    return (task.underlying.kind, task.n_steps)


def _group_by(tasks: Sequence[PricingTask], key):
    groups: dict[tuple, list[tuple[int, PricingTask]]] = {}
    for i, t in enumerate(tasks):
        groups.setdefault(key(t), []).append((i, t))
    return list(groups.items())


def group_by_family(tasks: Sequence[PricingTask]):
    """Group task *indices* by Table 1 family, preserving first-seen order.

    Returns ``[(family_key, [(index, task), ...]), ...]``.
    """
    return _group_by(tasks, family_key)


def group_by_launch(tasks: Sequence[PricingTask]):
    """Group task *indices* by compilation unit (model kind, n_steps)."""
    return _group_by(tasks, launch_key)


def _task_param_row(task: PricingTask) -> list[float]:
    u = task.underlying
    o = task.option
    dt = task.maturity / task.n_steps
    if isinstance(u, BlackScholes):
        model = [u.volatility, 0.0, 0.0, 0.0, 0.0, 0.0]
    else:
        model = [0.0, u.v0, u.kappa, u.theta, u.xi, u.rho]
    # float32(inf) upper barriers survive the cast; comparisons stay exact.
    return [u.spot, u.rate, dt, *model,
            o.strike, o.lower, o.upper, o.payout,
            1.0 if o.call else -1.0]


@dataclasses.dataclass(frozen=True)
class TaskBatch:
    """Struct-of-arrays packing of a task family for one batched launch.

    ``params``/``task_ids``/``payoff_kinds`` are tensors on one device;
    only ``model_kind`` and ``n_steps`` are structural — they select the
    step function and the loop bound, which is why a batch must be uniform
    in those two. Payoff kinds may mix within a batch (they are runtime
    codes).
    """

    params: torch.Tensor        # (T, N_PARAMS) float32
    task_ids: torch.Tensor      # (T,) uint32 — RNG key half
    payoff_kinds: torch.Tensor  # (T,) int32
    model_kind: str             # "black-scholes" | "heston"
    n_steps: int                # loop bound

    @property
    def n_tasks(self) -> int:
        return self.params.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.device

    @classmethod
    def from_tasks(cls, tasks: Sequence[PricingTask],
                   device: str | torch.device = "cuda") -> "TaskBatch":
        if not tasks:
            raise ValueError("empty task batch")
        device = resolve_device(device)
        kinds = {t.underlying.kind for t in tasks}
        steps = {t.n_steps for t in tasks}
        if len(kinds) > 1 or len(steps) > 1:
            raise ValueError(
                f"TaskBatch must be family-uniform in (model, n_steps); "
                f"got models={sorted(kinds)} n_steps={sorted(steps)}")
        # An unknown code would silently price as the final branch of the
        # coded payoff, so it is rejected here while it is a Python int.
        bad = {t.option.payoff for t in tasks} - set(_PAYOFF_NAMES)
        if bad:
            raise ValueError(f"unknown payoff kinds {sorted(bad)}")
        params = np.asarray([_task_param_row(t) for t in tasks], np.float32)
        task_ids = np.asarray([t.task_id for t in tasks], np.uint32)
        payoff_kinds = np.asarray([t.option.payoff for t in tasks], np.int32)
        return cls(
            params=torch.from_numpy(params).to(device),
            task_ids=torch.from_numpy(task_ids).to(device),
            payoff_kinds=torch.from_numpy(payoff_kinds).to(device),
            model_kind=next(iter(kinds)),
            n_steps=next(iter(steps)),
        )
