"""Deterministic perturbation scenarios for simulated platforms.

The online re-allocation loop (:mod:`repro_torch.runtime.online`) only earns its
keep when system behaviour *shifts* mid-workload — the measurement-driven
re-optimisation regime of Memeti & Pllana (arXiv:1606.05134). Real drift
needs real hardware misbehaving on cue; a :class:`Scenario` replays it on
the simulated platforms instead, as a seed-stable schedule keyed on each
platform's own **virtual clock** (the cumulative latency of everything it
has executed so far):

    sc = (Scenario()
          .slowdown("Local GPU 1", t=1.6, factor=4.0)   # degrade from t on
          .outage("AWS Server EC1", t=2.0)              # dispatches fail
          .flaky("Desktop", p=0.2, t=0.5, end=2.0)      # transient blips
          .corrupt("Local FPGA 1", t=1.0, end=1.2)      # bad records back
          .arrive(t=0.8, task=extra_task))              # joins mid-workload

Keying on virtual (not host) time makes a scenario a pure function of what
was dispatched: concurrent and sequential runs see identical perturbations,
so the online loop's bitwise mode parity survives drift injection. An
outage makes ``run`` raise :class:`PlatformOutage`, a flaky window makes it
raise :class:`TransientFault` with seeded probability — in both cases the
simulator advances the platform's clock by a retry cost per failed attempt
so finite fault windows end after finitely many retries. A corrupt window
poisons the run instead of failing it: the dispatch *returns*, the clock
advances by the true latency (the work was done — and wasted), but the
reported latency comes back negated, which the dispatcher's record sanity
checks (:func:`repro_torch.runtime.faults.check_records`) flag as a
:class:`CorruptResult`.

Slowdowns, outages, flaky and corrupt windows are consumed by the
platforms (:class:`repro_torch.pricing.platforms.SimulatedPlatform`,
:class:`repro_torch.domains.lm_serving.SimulatedLMPlatform` — see their
``attach_scenario``); arrivals are consumed by the
:class:`~repro_torch.runtime.online.OnlineScheduler`, which admits queued tasks
once the workload's elapsed virtual makespan passes their arrival time.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any

from repro_torch.runtime.faults import DispatchFault, PlatformOutage, TransientFault

__all__ = ["Scenario", "PlatformOutage", "TransientFault", "apply_scenario",
           "salvage_runs"]


def _retry_cost(platform) -> float:
    """Virtual time a failed attempt burns (one round trip, floored)."""
    return max(platform.spec.rtt_ms * 1e-3, 1e-3)


def apply_scenario(platform, latency: float) -> float:
    """One simulated run's scenario bookkeeping, shared by every simulator.

    Consults ``platform.scenario`` at ``platform.clock``: inside an outage
    window the attempt raises :class:`PlatformOutage` after advancing the
    clock by a retry cost (a failed attempt still costs a round trip, so
    finite windows end after finitely many retries); a flaky window rolls a
    seeded coin keyed on the clock and raises :class:`TransientFault` the
    same way. Otherwise the clean ``latency`` is stretched through the
    piecewise slowdown schedule and the clock advanced by the result —
    negated on return if the run started inside a corrupt window (the work
    happened and cost its true time, but the record it produces is bad).
    With no scenario attached the latency passes through untouched and no
    clock is tracked.
    """
    scenario = platform.scenario
    if scenario is None:
        return latency
    name = platform.spec.name
    start = platform.clock
    if scenario.in_outage(name, start):
        platform.clock += _retry_cost(platform)
        raise PlatformOutage(f"{name} is down at t={platform.clock:.3f}s")
    if scenario.flaky_failure(name, start):
        platform.clock += _retry_cost(platform)
        raise TransientFault(
            f"{name} dropped a dispatch at t={platform.clock:.3f}s")
    latency = scenario.stretch(name, start, latency)
    platform.clock += latency
    if scenario.in_corrupt(name, start):
        return -latency
    return latency


def salvage_runs(run_one, items) -> list:
    """Map ``run_one`` over ``items``, salvaging partial output on faults.

    When a :class:`~repro_torch.runtime.faults.DispatchFault` (outage *or*
    transient blip) interrupts the sweep the results completed so far are
    attached to the exception (``.records``) before it propagates — the
    platform's virtual clock already ran that work, so dispatchers keep it
    in the accounting instead of re-executing it. The batched ``run_batch``
    loops of both simulators share this one copy.
    """
    out = []
    for item in items:
        try:
            out.append(run_one(item))
        except DispatchFault as exc:
            exc.records = out + exc.records
            raise
    return out


@dataclasses.dataclass(frozen=True)
class _Window:
    platform: str
    start: float
    end: float
    factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class _FlakyWindow:
    platform: str
    start: float
    end: float
    p: float
    seed: int


@dataclasses.dataclass(frozen=True)
class _Arrival:
    time: float
    task: Any


class Scenario:
    """A deterministic schedule of platform perturbations and task arrivals.

    Builder methods chain and return ``self``; the object is then shared by
    every platform of a run (each queries only its own name) and by the
    online scheduler (arrivals). ``reset()`` rewinds the arrival cursor so
    the same scenario can drive an A/B pair of runs.
    """

    def __init__(self):
        self._slowdowns: list[_Window] = []
        self._outages: list[_Window] = []
        self._flaky: list[_FlakyWindow] = []
        self._corrupt: list[_Window] = []
        self._arrivals: list[_Arrival] = []
        self._admitted = 0

    # -- construction ------------------------------------------------------

    def slowdown(self, platform: str, t: float, factor: float,
                 end: float = math.inf) -> "Scenario":
        """From virtual time ``t`` (to ``end``), scale the platform's
        latencies by ``factor`` (> 1 degrades, < 1 speeds up)."""
        if factor <= 0:
            raise ValueError(f"slowdown factor must be > 0, got {factor}")
        self._slowdowns.append(_Window(platform, t, end, factor))
        return self

    def outage(self, platform: str, t: float, end: float = math.inf) -> "Scenario":
        """From virtual time ``t`` (to ``end``), dispatches to the platform
        raise :class:`PlatformOutage` instead of running."""
        self._outages.append(_Window(platform, t, end))
        return self

    def flaky(self, platform: str, p: float, seed: int = 0, t: float = 0.0,
              end: float = math.inf) -> "Scenario":
        """From virtual time ``t`` (to ``end``), each dispatch attempt on
        the platform fails with probability ``p`` as a retryable
        :class:`TransientFault`.

        The coin is a pure function of (seed, platform, virtual clock) —
        no mutable RNG state — so concurrent and sequential runs see the
        same blips, and because each failed attempt advances the clock by
        a retry cost, consecutive retries draw fresh coins and a finite
        window's storm always ends."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"flaky probability must be in [0, 1], got {p}")
        self._flaky.append(_FlakyWindow(platform, t, end, p, seed))
        return self

    def corrupt(self, platform: str, t: float, end: float = math.inf) -> "Scenario":
        """From virtual time ``t`` (to ``end``), dispatches on the platform
        *return* but their records are poisoned (negated latency) — caught
        downstream by record sanity checks as a
        :class:`~repro_torch.runtime.faults.CorruptResult`. The work still costs
        its true virtual time: corruption wastes the run, unlike an outage
        which prevents it."""
        self._corrupt.append(_Window(platform, t, end))
        return self

    def arrive(self, t: float, task: Any) -> "Scenario":
        """Queue a task to join the workload once its elapsed virtual
        makespan reaches ``t``."""
        self._arrivals.append(_Arrival(t, task))
        self._arrivals.sort(key=lambda a: a.time)
        return self

    # -- platform-side queries ---------------------------------------------

    def factor(self, platform: str, t: float) -> float:
        """Combined slowdown factor for a platform at virtual time ``t``."""
        f = 1.0
        for w in self._slowdowns:
            if w.platform == platform and w.start <= t < w.end:
                f *= w.factor
        return f

    def in_outage(self, platform: str, t: float) -> bool:
        return any(w.platform == platform and w.start <= t < w.end
                   for w in self._outages)

    def flaky_failure(self, platform: str, t: float) -> bool:
        """Seeded coin flip: does a dispatch starting at virtual time ``t``
        hit a transient fault? Pure in (seed, platform, t) — ``repr(t)``
        round-trips the float exactly, so the draw is bit-stable across
        modes and replays."""
        for w in self._flaky:
            if w.platform == platform and w.start <= t < w.end:
                key = f"flaky|{w.seed}|{platform}|{t!r}"
                u = (zlib.crc32(key.encode()) & 0xFFFFFFFF) / 2**32
                if u < w.p:
                    return True
        return False

    def in_corrupt(self, platform: str, t: float) -> bool:
        return any(w.platform == platform and w.start <= t < w.end
                   for w in self._corrupt)

    def stretch(self, platform: str, t0: float, clean: float) -> float:
        """Wall-clock duration of ``clean`` seconds of unit-factor work
        started at virtual time ``t0``.

        The slowdown factor is piecewise-constant in virtual time, and a
        run may straddle a boundary — a record half-executed when a 4x
        slowdown lands costs half its clean time plus 4x the other half.
        Integrating instead of sampling the factor at dispatch start keeps
        coarse-grained runs (a one-shot execute's big shards) and
        fine-grained ones (online tranches) on the same physics.
        """
        t, w = float(t0), float(clean)
        while w > 1e-15:
            f = self.factor(platform, t)
            boundary = min(
                (edge for win in self._slowdowns if win.platform == platform
                 for edge in (win.start, win.end)
                 if t < edge < math.inf),
                default=None)
            if boundary is None or t + w * f <= boundary:
                t += w * f
                break
            w -= (boundary - t) / f  # clean work absorbed up to the edge
            t = boundary
        return t - t0

    # -- scheduler-side queries --------------------------------------------

    def take_arrivals(self, t: float, force: bool = False) -> list[Any]:
        """Pop every queued task whose arrival time has passed.

        ``force=True`` pops the whole queue regardless of ``t`` — used when
        the workload drains before the clock reaches the stragglers (there
        is no more work to advance virtual time, so they join immediately).
        """
        return [task for _, task in self.take_arrivals_timed(t, force)]

    def take_arrivals_timed(self, t: float,
                            force: bool = False) -> list[tuple[float, Any]]:
        """Like :meth:`take_arrivals`, keeping each task's nominal arrival
        time — admission control and SLO accounting (TTFT, queueing delay)
        need when the request *arrived*, not when the loop noticed it."""
        out = []
        while self._admitted < len(self._arrivals):
            nxt = self._arrivals[self._admitted]
            if not force and nxt.time > t:
                break
            out.append((nxt.time, nxt.task))
            self._admitted += 1
        return out

    @property
    def next_arrival_time(self) -> float | None:
        """Arrival time of the next still-queued task (None when drained).

        Open-loop runs idle-advance their clock floor to this instant when
        all admitted work is done but the trace has more to offer.
        """
        if self._admitted < len(self._arrivals):
            return self._arrivals[self._admitted].time
        return None

    @property
    def pending_arrivals(self) -> int:
        return len(self._arrivals) - self._admitted

    def reset(self) -> "Scenario":
        """Rewind the arrival cursor (for replaying the scenario)."""
        self._admitted = 0
        return self
