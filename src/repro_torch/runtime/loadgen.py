"""Deterministic open-loop load generation for trace-driven serving.

The scenario layer (PR 4) takes hand-scheduled arrivals; the north-star
regime is *open-loop* traffic — requests arrive on their own schedule
regardless of whether the fleet keeps up, which is exactly when offered
load can exceed capacity and the admission layer
(:mod:`repro_torch.runtime.admission`) earns its keep.

A :class:`LoadGenerator` samples a non-homogeneous Poisson process by
Lewis–Shedler thinning from a :class:`RateProcess` (constant, diurnal
sinusoid, or square-wave bursts), draws each request from a task factory
(the reference's LM request factory waits for the port's LM-serving
slice), and emits the result as timestamped :meth:`Scenario.arrive` entries.
Everything downstream is the *existing* admission path, so a trace
replays bit-for-bit: one seeded generator, one sequential RNG, no wall
clocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np

from repro_torch.runtime.scenario import Scenario

__all__ = ["ConstantRate", "DiurnalRate", "BurstyRate", "LoadGenerator"]


# --------------------------------------------------------------------------
# Rate processes
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConstantRate:
    """Homogeneous Poisson arrivals at ``rate_per_s``."""

    rate_per_s: float

    def rate(self, t: float) -> float:
        return self.rate_per_s

    @property
    def peak(self) -> float:
        return self.rate_per_s


@dataclasses.dataclass(frozen=True)
class DiurnalRate:
    """Sinusoidal day/night load curve around ``base_per_s``.

    ``rate(t) = base * (1 + amplitude * sin(2*pi*(t + phase)/period))``;
    amplitude in [0, 1) keeps the intensity positive.
    """

    base_per_s: float
    amplitude: float = 0.5
    period_s: float = 60.0
    phase: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")

    def rate(self, t: float) -> float:
        return self.base_per_s * (
            1.0 + self.amplitude
            * math.sin(2.0 * math.pi * (t + self.phase) / self.period_s))

    @property
    def peak(self) -> float:
        return self.base_per_s * (1.0 + self.amplitude)


@dataclasses.dataclass(frozen=True)
class BurstyRate:
    """Square-wave bursts: ``burst_per_s`` for the first ``duty`` fraction
    of every period, ``base_per_s`` otherwise."""

    base_per_s: float
    burst_per_s: float
    period_s: float = 30.0
    duty: float = 0.2

    def __post_init__(self):
        if not 0.0 < self.duty < 1.0:
            raise ValueError("duty must be in (0, 1)")

    def rate(self, t: float) -> float:
        frac = (t % self.period_s) / self.period_s
        return self.burst_per_s if frac < self.duty else self.base_per_s

    @property
    def peak(self) -> float:
        return max(self.base_per_s, self.burst_per_s)


# --------------------------------------------------------------------------
# The generator
# --------------------------------------------------------------------------

class LoadGenerator:
    """Seeded open-loop arrival trace over a rate process.

    Lewis–Shedler thinning: candidate inter-arrivals are exponential at
    the process's peak rate; each candidate survives with probability
    ``rate(t) / peak``. One sequential RNG drives both the thinning and
    the task factory, so the trace is a pure function of (seed, rate
    process, factory) — replays are bit-for-bit, and two generators with
    different seeds are independent.
    """

    def __init__(self, rate: Any, make_task: Callable[[np.random.Generator, int], Any],
                 seed: int = 0, start_id: int = 1000):
        if rate.peak <= 0:
            raise ValueError("rate process must have a positive peak rate")
        self.rate_process = rate
        self.make_task = make_task
        self.seed = seed
        self.start_id = start_id

    def arrivals(self, horizon_s: float) -> list[tuple[float, Any]]:
        """Sample the timestamped trace over ``[0, horizon_s)``."""
        rng = np.random.default_rng(self.seed)
        peak = self.rate_process.peak
        out: list[tuple[float, Any]] = []
        t = 0.0
        tid = self.start_id
        while True:
            t += float(rng.exponential(1.0 / peak))
            if t >= horizon_s:
                break
            if float(rng.random()) * peak <= self.rate_process.rate(t):
                out.append((t, self.make_task(rng, tid)))
                tid += 1
        return out

    def scenario(self, horizon_s: float,
                 base: Scenario | None = None) -> Scenario:
        """Emit the trace into a :class:`Scenario` (a fresh one by
        default) through the existing ``arrive`` admission path."""
        sc = base if base is not None else Scenario()
        for t, task in self.arrivals(horizon_s):
            sc.arrive(t, task)
        return sc
