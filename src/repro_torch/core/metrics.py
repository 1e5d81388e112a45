"""Domain metric models (paper §3.1, §4.2).

The paper's first contribution: for a restricted application domain, the
observable run-time characteristics ("domain metrics") of a task upon a
platform are captured by small parametric models whose structure is known
in advance and whose coefficients are populated at run time by online
benchmarking (weighted least squares, §3.1.4).

For the derivatives-pricing domain the three models are

    latency   f_L(n) = beta * n + gamma                     (eq. 7)
    accuracy  f_C(n) = alpha * n**-0.5                      (eq. 8)
    combined  f_L(c) = delta * c**-2 + gamma, delta=beta*alpha**2   (eq. 9)

where ``n`` is the number of Monte Carlo paths (the domain *variable*) and
``c`` the 95% confidence-interval size in pricing currency.

All fitting is plain numpy; the models are deliberately tiny — the paper's
point is that simple models extrapolate well (§5.3).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "LatencyModel",
    "AccuracyModel",
    "CombinedModel",
    "fit_latency_model",
    "fit_accuracy_model",
    "relative_error",
    "wls",
]


def wls(X: np.ndarray, y: np.ndarray, w: np.ndarray | None = None) -> np.ndarray:
    """Weighted least squares:  argmin_b || W^(1/2) (X b - y) ||.

    Solved via the normal equations with an SVD-backed lstsq for rank
    robustness (benchmarking matrices are tall and thin, b x p with p<=2).
    """
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if w is None:
        w = np.ones_like(y)
    sw = np.sqrt(np.asarray(w, dtype=np.float64))
    coef, *_ = np.linalg.lstsq(X * sw[:, None], y * sw, rcond=None)
    return coef


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """f_L(n) = beta * n + gamma  (eq. 7).

    ``beta``  — seconds per Monte Carlo path (compute capability).
    ``gamma`` — constant: setup + task communication (network RTT dominates
                for remote platforms, §5.3).
    """

    beta: float
    gamma: float

    def __call__(self, n) -> np.ndarray:
        return self.beta * np.asarray(n, dtype=np.float64) + self.gamma

    def paths_for_latency(self, t: float) -> float:
        """Invert the model: how many paths fit in a latency budget ``t``."""
        return max((t - self.gamma) / self.beta, 0.0)


@dataclasses.dataclass(frozen=True)
class AccuracyModel:
    """f_C(n) = alpha * n**-1/2  (eq. 8) — MC estimator 95% CI size.

    ``alpha`` = 1.96 * sigma-hat of the payoff distribution (per unit path).
    """

    alpha: float

    def __call__(self, n) -> np.ndarray:
        n = np.asarray(n, dtype=np.float64)
        return self.alpha / np.sqrt(n)

    def paths_for_accuracy(self, c: float) -> float:
        """Paths required to achieve a CI of size ``c``."""
        return (self.alpha / c) ** 2


@dataclasses.dataclass(frozen=True)
class CombinedModel:
    """f_L(c) = delta * c**-2 + gamma with delta = beta * alpha**2 (eq. 9).

    Latency needed on this platform to price this task to accuracy ``c`` —
    the unified model that drives the allocation program (eq. 10).
    """

    delta: float
    gamma: float

    @classmethod
    def from_models(cls, lat: LatencyModel, acc: AccuracyModel) -> "CombinedModel":
        return cls(delta=lat.beta * acc.alpha**2, gamma=lat.gamma)

    def __call__(self, c) -> np.ndarray:
        c = np.asarray(c, dtype=np.float64)
        return self.delta / (c * c) + self.gamma


def fit_latency_model(
    paths: Sequence[float],
    latencies: Sequence[float],
    weights: Sequence[float] | None = None,
) -> LatencyModel:
    """Fit eq. 7 by WLS on benchmarking observations (n_i, t_i).

    By default observations are weighted by 1/t_i (relative-error weighting):
    the paper's error metric (eq. 13) is relative, and benchmarking sweeps
    span orders of magnitude in n, so unweighted LS would let the largest
    run dominate the fit.
    """
    n = np.asarray(paths, dtype=np.float64)
    t = np.asarray(latencies, dtype=np.float64)
    w = 1.0 / np.maximum(t, 1e-12) if weights is None else np.asarray(weights)
    X = np.stack([n, np.ones_like(n)], axis=1)
    beta, gamma = wls(X, t, w)
    # Degenerate benchmarks (e.g. RTT-dominated remote platforms, §5.3) can
    # produce a slightly negative slope or intercept; clamp to the model's
    # domain R+ rather than returning an invalid program input.
    return LatencyModel(beta=float(max(beta, 1e-12)), gamma=float(max(gamma, 0.0)))


def fit_accuracy_model(
    paths: Sequence[float],
    cis: Sequence[float],
    weights: Sequence[float] | None = None,
) -> AccuracyModel:
    """Fit eq. 8 by WLS on (n_i, ci_i): linear in the basis n**-1/2."""
    n = np.asarray(paths, dtype=np.float64)
    c = np.asarray(cis, dtype=np.float64)
    w = 1.0 / np.maximum(c, 1e-300) if weights is None else np.asarray(weights)
    X = (1.0 / np.sqrt(n))[:, None]
    (alpha,) = wls(X, c, w)
    return AccuracyModel(alpha=float(max(alpha, 1e-300)))


def relative_error(predicted, observed) -> np.ndarray:
    """E_k = |f_k(n) - f̂_k,n| / f̂_k,n  (eq. 13)."""
    predicted = np.asarray(predicted, dtype=np.float64)
    observed = np.asarray(observed, dtype=np.float64)
    return np.abs(predicted - observed) / np.abs(observed)
