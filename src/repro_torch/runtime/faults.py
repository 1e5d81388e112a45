"""Fault taxonomy, retry policy and per-platform circuit breakers.

The paper's allocation story assumes every platform that starts the
workload finishes it; its companion work (arXiv:1408.4965) frames the
runtime as a *continuously accessible service*, and Memeti & Pllana
(arXiv:1606.05134) show re-optimising mid-run pays off exactly when system
behaviour shifts — which includes platforms failing and coming back. This
module is the vocabulary and state the rest of the runtime threads
through:

**Taxonomy.** Every dispatch failure is a :class:`DispatchFault` carrying
the records the batch completed before failing (the platform's virtual
clock already ran that work, so dispatchers salvage it instead of
re-executing). Three concrete kinds, by what the right reaction is:

* :class:`TransientFault` — a retryable blip (network hiccup, scheduler
  preemption); injected deterministically by ``Scenario.flaky``. Retrying
  the *unsalvaged remainder* usually succeeds, and each failed attempt
  advances the platform's virtual clock by a retry cost, so finite fault
  storms end.
* :class:`PlatformOutage` — the platform is down for a window; retrying
  within the round is pointless. The circuit breaker takes over: repeated
  failures open it, a cooldown later cheap probes test recovery.
* :class:`CorruptResult` — the dispatch *returned*, but its records fail
  sanity checks (:func:`check_records`): non-finite fields or non-positive
  latency. The work is wasted (the clock advanced); the bad records are
  discarded and the affected tasks re-dispatched.

:class:`DispatchTimeout` (a transient) marks a dispatch whose executor
wall clock blew the policy's ``timeout_s``; :class:`JobCancelled` marks a
job skipped because its batch was cancelled before it started.

**RetryPolicy** is deterministic by construction: the backoff for attempt
``k`` of (platform, round) is ``min(base * 2^(k-1), cap)`` scaled by a
seeded jitter (CRC32 of the coordinates — the same PYTHONHASHSEED-proof
scheme as :func:`repro_torch.runtime.domain.seed_for`), so concurrent and
sequential runs retry identically and a replay reproduces the schedule
bit-for-bit. The per-(platform, round) ``budget`` bounds total retries so
a fault storm cannot spin a round forever.

**CircuitBreaker** holds one three-state machine per platform::

    CLOSED --(failure_threshold consecutive failed rounds)--> OPEN
    OPEN   --(cooldown_s of workload elapsed time)----------> HALF_OPEN
    HALF_OPEN --(cheap seeded probe dispatch succeeds)------> CLOSED
    HALF_OPEN --(probe fails)-------------------------------> OPEN

replacing the online loop's one-way dead set: a platform that comes back
(scenario outage windows are finite) re-enters the allocation instead of
staying dead forever. Time is the workload's *elapsed virtual makespan* —
a round-barrier quantity identical across executor modes — so transitions
are deterministic. Every transition is logged as a
:class:`BreakerTransition` for the run report.

All event dataclasses round-trip through :mod:`repro_torch.runtime.records`
JSONL (they are registered builtins), so a run's fault history persists
next to its execution records.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Iterable, Sequence

__all__ = [
    "DispatchFault", "PlatformOutage", "TransientFault", "CorruptResult",
    "DispatchTimeout", "JobCancelled",
    "RetryPolicy", "CircuitBreaker",
    "CLOSED", "OPEN", "HALF_OPEN",
    "FaultEvent", "DegradationEvent", "BreakerTransition",
    "check_records",
]


# --------------------------------------------------------------------------
# Taxonomy
# --------------------------------------------------------------------------

class DispatchFault(RuntimeError):
    """Base of every dispatch failure.

    ``records`` carries whatever the failing batch completed before the
    fault struck — the platform's virtual clock already advanced for that
    work, so dispatchers salvage it instead of re-executing it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.records: list[Any] = []


class PlatformOutage(DispatchFault):
    """A dispatch hit a platform inside one of its scenario outage windows.

    Not retryable within the round — the circuit breaker owns recovery."""


class TransientFault(DispatchFault):
    """A retryable blip: the same dispatch usually succeeds on retry."""


class CorruptResult(DispatchFault):
    """The dispatch returned records that fail sanity checks.

    ``bad`` holds the rejected records (for diagnosis); ``records`` holds
    the batch's sane siblings, salvaged as usual."""

    def __init__(self, *args):
        super().__init__(*args)
        self.bad: list[Any] = []


class DispatchTimeout(TransientFault):
    """A dispatch blew its executor wall-clock timeout."""


class JobCancelled(RuntimeError):
    """An executor job skipped because its batch was cancelled before it
    started (e.g. the platform's breaker tripped mid-round)."""


def check_records(records: Sequence[Any]) -> None:
    """Sanity-check a dispatch's records; raise :class:`CorruptResult`.

    A sane record has finite, strictly positive latency and no non-finite
    float field (a NaN price or an infinite CI is corruption, a negative
    deep-out-of-the-money price estimate is not). The raised fault carries
    the sane records in ``.records`` (salvage) and the rejected ones in
    ``.bad`` so the caller re-dispatches only the affected tasks.
    """
    good, bad = [], []
    for rec in records:
        lat = getattr(rec, "latency", None)
        sane = lat is not None and math.isfinite(lat) and lat > 0.0
        if sane and dataclasses.is_dataclass(rec):
            for f in dataclasses.fields(rec):
                v = getattr(rec, f.name)
                if isinstance(v, float) and not math.isfinite(v):
                    sane = False
                    break
        (good if sane else bad).append(rec)
    if bad:
        exc = CorruptResult(
            f"{len(bad)}/{len(records)} records failed sanity checks "
            f"(first: {bad[0]!r})")
        exc.records = good
        exc.bad = bad
        raise exc


# --------------------------------------------------------------------------
# Retry policy
# --------------------------------------------------------------------------

def _unit_jitter(*coords) -> float:
    """Deterministic uniform in [-1, 1) from a stable hash of coords —
    CRC32, like :func:`repro_torch.runtime.domain.seed_for` (not imported to
    keep this module dependency-free)."""
    key = "|".join(repr(c) for c in coords)
    return (zlib.crc32(key.encode()) & 0xFFFFFFFF) / 2**31 - 1.0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Deterministic capped-exponential-backoff retry schedule.

    ``max_attempts`` bounds attempts per dispatch (1 = never retry);
    ``budget`` bounds total retries per (platform, round) across all of
    that platform's launch groups, so a storm cannot spin a round forever.
    ``timeout_s`` (optional) bounds a dispatch's *executor wall clock*:
    blown dispatches surface as :class:`DispatchTimeout` — a health signal
    the breaker counts (completed work stays in the accounting; host
    threads cannot be preempted mid-dispatch).
    """

    max_attempts: int = 3
    budget: int = 8
    backoff_base_s: float = 0.0
    backoff_cap_s: float = 1.0
    jitter: float = 0.1
    timeout_s: float | None = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.budget < 0:
            raise ValueError(f"budget must be >= 0, got {self.budget}")

    def retryable(self, exc: BaseException) -> bool:
        """Transient blips and corrupt results are retryable; an outage is
        the breaker's business, anything else the caller's."""
        return isinstance(exc, (TransientFault, CorruptResult))

    def delay(self, seed: int, platform: str, round_idx: int,
              attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based) of (platform, round).

        ``min(base * 2^(attempt-1), cap)`` scaled by a seeded jitter in
        ``[1 - jitter, 1 + jitter)`` — a pure function of its coordinates,
        so every executor mode (and every replay) backs off identically.
        """
        if self.backoff_base_s <= 0.0:
            return 0.0
        base = min(self.backoff_base_s * 2.0 ** (attempt - 1),
                   self.backoff_cap_s)
        u = _unit_jitter("retry", seed, platform, round_idx, attempt)
        return max(base * (1.0 + self.jitter * u), 0.0)


# --------------------------------------------------------------------------
# Circuit breaker
# --------------------------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


@dataclasses.dataclass(frozen=True)
class BreakerTransition:
    """One platform health-state change (the report's audit trail)."""

    platform: str
    frm: str
    to: str
    at: float          # workload elapsed virtual time
    round: int = -1


class CircuitBreaker:
    """Per-platform CLOSED/OPEN/HALF_OPEN health state with recovery.

    ``record_failure``/``record_success`` feed round outcomes in;
    ``poll`` applies the time-based OPEN -> HALF_OPEN transition and
    returns the current state. Time is whatever monotone scalar the
    caller supplies — the online loop uses the workload's elapsed virtual
    makespan, a round-barrier quantity identical across executor modes.
    """

    def __init__(self, failure_threshold: int = 2, cooldown_s: float = 0.0,
                 tracer=None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        #: optional repro_torch.obs.Tracer; state transitions become instant
        #: events on the platform's trace track
        self.tracer = tracer
        self._state: dict[str, str] = {}
        self._fails: dict[str, int] = {}
        self._opened_at: dict[str, float] = {}
        self.transitions: list[BreakerTransition] = []

    def _move(self, platform: str, to: str, now: float, round_idx: int) -> None:
        frm = self.state(platform)
        if frm == to:
            return
        self._state[platform] = to
        self.transitions.append(
            BreakerTransition(platform, frm, to, at=now, round=round_idx))
        if self.tracer is not None:
            self.tracer.instant(f"breaker:{to}", track=platform,
                                cat="breaker", frm=frm, at=now,
                                round=round_idx)
        if to == OPEN:
            self._opened_at[platform] = now

    # -- queries -----------------------------------------------------------

    def state(self, platform: str) -> str:
        return self._state.get(platform, CLOSED)

    def available(self, platform: str) -> bool:
        """CLOSED only: HALF_OPEN platforms take probes, not allocation."""
        return self.state(platform) == CLOSED

    def failures(self, platform: str) -> int:
        return self._fails.get(platform, 0)

    def poll(self, platform: str, now: float, round_idx: int = -1) -> str:
        """Apply the cooldown transition (OPEN -> HALF_OPEN) and return the
        state; call once per platform per round, at the round barrier."""
        if (self.state(platform) == OPEN
                and now >= self._opened_at.get(platform, 0.0) + self.cooldown_s):
            self._move(platform, HALF_OPEN, now, round_idx)
        return self.state(platform)

    # -- outcome feeds -----------------------------------------------------

    def record_failure(self, platform: str, now: float,
                       round_idx: int = -1) -> str:
        """One failed round (or failed probe): HALF_OPEN re-opens at once,
        CLOSED opens after ``failure_threshold`` consecutive failures."""
        state = self.state(platform)
        if state == HALF_OPEN:
            self._move(platform, OPEN, now, round_idx)
        else:
            self._fails[platform] = self._fails.get(platform, 0) + 1
            if state == CLOSED and self._fails[platform] >= self.failure_threshold:
                self._move(platform, OPEN, now, round_idx)
        return self.state(platform)

    def record_success(self, platform: str, now: float,
                       round_idx: int = -1) -> str:
        """A clean dispatch (or successful probe) resets the streak and
        promotes HALF_OPEN back to CLOSED — the platform re-enters the
        allocation on the next re-solve."""
        self._fails[platform] = 0
        if self.state(platform) == HALF_OPEN:
            self._move(platform, CLOSED, now, round_idx)
        return self.state(platform)

    def reset_streak(self, platform: str) -> None:
        """An idle round breaks a CLOSED platform's failure streak: the
        threshold counts *consecutive* failed rounds."""
        if self.state(platform) == CLOSED:
            self._fails[platform] = 0

    def open_platforms(self) -> tuple[str, ...]:
        """Platforms currently not CLOSED (the report's ``dead`` set)."""
        return tuple(sorted(pn for pn, st in self._state.items()
                            if st != CLOSED))


# --------------------------------------------------------------------------
# Event records (JSONL-persistable; see repro_torch.runtime.records)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault occurrence and what the runtime did about it.

    ``task_id`` is -1 for platform-level events (probes, timeouts spanning
    a whole group); ``latency`` is the virtual time the failure itself
    burned (clock advance minus salvaged record latencies) so makespan
    accounting can charge storms honestly. The taxonomy bucket is named
    ``fault`` rather than ``kind`` because the JSONL record envelope
    (:mod:`repro_torch.runtime.records`) reserves ``kind`` for the class name.
    """

    platform: str
    task_id: int
    round: int
    fault: str         # "transient" | "outage" | "corrupt" | "timeout" | "probe"
    action: str        # "retried" | "exhausted" | "probe-failed" | "probe-ok"
    attempt: int = 0
    latency: float = 0.0


@dataclasses.dataclass(frozen=True)
class DegradationEvent:
    """One task's quality target relaxed one rung (accuracy-for-latency)."""

    task_id: int
    round: int
    quality_from: float
    quality_to: float
    rung: int          # 1-based index into the degradation ladder
    reason: str        # "capacity" | "deadline"


def fault_kind(exc: BaseException) -> str:
    """Taxonomy bucket of a fault exception, for event records."""
    if isinstance(exc, DispatchTimeout):
        return "timeout"
    if isinstance(exc, CorruptResult):
        return "corrupt"
    if isinstance(exc, PlatformOutage):
        return "outage"
    if isinstance(exc, TransientFault):
        return "transient"
    return type(exc).__name__


def count_retries(events: Iterable[FaultEvent]) -> int:
    """Total retried attempts in a fault-event log."""
    return sum(1 for e in events if e.action == "retried")
