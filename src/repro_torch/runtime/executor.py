"""Concurrent cross-platform dispatch (the paper's implicit execution model).

The paper's makespan (§3, Figs 8 & 10) is the wall-clock time until the
*last* platform finishes its share — platforms run their shards
simultaneously and the system is judged by the slowest one (same model as
the companion work, arXiv:1408.4965, and Memeti & Pllana's distributed
measurements, arXiv:1606.05134). A sequential per-platform loop therefore
measures the wrong thing: its wall clock is the *sum* of per-platform
latencies, not the max of concurrent ones.

:class:`Executor` is the one primitive the runtime needs to close that
gap: fan a function out over independent per-platform jobs on a thread
pool and time each job with its own wall clock. Host threads are the
right tool here — JAX dispatch is asynchronous (a host thread issuing
work to one platform sleeps in ``block_until_ready`` while another
platform's thread runs), and simulated platforms overlap trivially. A
``mode="sequential"`` escape hatch preserves the legacy serial order for
A/B comparisons; results must be identical in both modes, which is why
characterisation seeds are derived per (platform, launch group, rung)
(:func:`repro_torch.runtime.domain.seed_for`) rather than from dispatch order.

Failure isolation: one job blowing up must not discard its siblings'
results and wall clocks — the fault-tolerant scheduler needs *every*
per-platform outcome to account a round (a platform that failed mid-round
still ran real work its virtual clock charged for). ``map_timed`` with
``raise_errors=False`` therefore returns a :class:`TimedResult` per job,
carrying either the value or the typed exception; the default
``raise_errors=True`` still raises (after every job has run to
completion) so legacy callers keep their semantics without losing
siblings silently. An optional ``timeout_s`` bounds each job's wall clock
(:class:`~repro_torch.runtime.faults.DispatchTimeout` — a health signal for the
circuit breaker, not a preemption: host threads cannot be killed, so a
blown job's thread is abandoned and its eventual value dropped), and an
optional ``cancel`` event skips jobs that have not started yet
(:class:`~repro_torch.runtime.faults.JobCancelled`) — mid-round cancellation
for a platform whose breaker tripped.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Iterable, TypeVar

from repro_torch.runtime.faults import DispatchTimeout, JobCancelled

__all__ = ["Executor", "TimedResult", "MODES"]

T = TypeVar("T")

#: The two dispatch modes; "concurrent" is the default everywhere.
MODES: tuple[str, ...] = ("concurrent", "sequential")


@dataclasses.dataclass(frozen=True)
class TimedResult:
    """One job's outcome: its return value (or typed error) plus its own
    wall-clock time. Exactly one of ``value`` / ``error`` is meaningful."""

    value: Any
    wall_s: float
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


class Executor:
    """Maps a function over independent jobs, concurrently or serially.

    Results are always returned in input order, so swapping modes never
    changes semantics — only wall-clock overlap. Exceptions propagate by
    default (``raise_errors=True``, after all jobs have run) or come back
    as per-job :class:`TimedResult` errors (``raise_errors=False``).
    """

    def __init__(self, mode: str = "concurrent", max_workers: int | None = None,
                 tracer=None):
        if mode not in MODES:
            raise ValueError(f"unknown executor mode {mode!r}; expected one of {MODES}")
        self.mode = mode
        self.max_workers = max_workers
        #: optional :class:`repro_torch.obs.Tracer`; when enabled, ``map_timed``
        #: callers may open one span per job via ``span_of``. Spans live on
        #: per-thread stacks, so nested spans opened inside the job body
        #: land under the job span even on pool threads.
        self.tracer = tracer

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"Executor(mode={self.mode!r}, max_workers={self.max_workers})"

    def map_timed(self, fn: Callable[[T], Any], items: Iterable[T], *,
                  raise_errors: bool = True,
                  timeout_s: float | None = None,
                  cancel: threading.Event | None = None,
                  span_of: Callable[[T], tuple[str, str]] | None = None
                  ) -> list[TimedResult]:
        """``[fn(item) for item in items]`` with a per-item wall clock.

        Concurrent mode runs every item on its own pool thread; each
        item's ``wall_s`` spans only that item's call, so per-platform
        wall times remain meaningful under overlap.

        Every job runs to an outcome — a failed job never discards its
        siblings' results. With ``raise_errors=True`` (default) the first
        failing job's exception (in *input* order, for mode parity) is
        re-raised once all jobs have finished; with ``raise_errors=False``
        failures come back in-band as ``TimedResult.error``.

        ``timeout_s`` bounds each job's wall clock: a blown job yields a
        :class:`DispatchTimeout` error (concurrent mode abandons the
        still-running thread; sequential mode marks the overrun post hoc —
        a single host thread cannot be preempted). ``cancel``, when set,
        makes jobs that have not started yet yield :class:`JobCancelled`
        instead of running.

        ``span_of`` maps an item to a ``(span name, track)`` pair; when the
        executor carries an enabled tracer, each job's run is wrapped in
        that span on its executing thread, so per-platform work shows up
        as overlapping tracks in the exported trace.
        """
        jobs = list(items)
        tracer = self.tracer
        if tracer is not None and span_of is not None \
                and getattr(tracer, "enabled", False):
            inner = fn

            def fn(item: T) -> Any:  # noqa: F811 - traced wrapper
                name, track = span_of(item)
                with tracer.span(name, track=track, cat="executor"):
                    return inner(item)

        def timed(item: T) -> TimedResult:
            if cancel is not None and cancel.is_set():
                return TimedResult(value=None, wall_s=0.0,
                                   error=JobCancelled("batch cancelled"))
            t0 = time.perf_counter()
            try:
                value = fn(item)
            except BaseException as exc:
                return TimedResult(value=None,
                                   wall_s=time.perf_counter() - t0, error=exc)
            wall = time.perf_counter() - t0
            if timeout_s is not None and wall > timeout_s:
                return TimedResult(
                    value=None, wall_s=wall,
                    error=DispatchTimeout(
                        f"job exceeded {timeout_s:.3f}s (took {wall:.3f}s)"))
            return TimedResult(value=value, wall_s=wall)

        if self.mode == "sequential" or len(jobs) <= 1:
            out = [timed(item) for item in jobs]
        else:
            out = self._map_concurrent(timed, jobs, timeout_s)
        if raise_errors:
            for r in out:
                if r.error is not None:
                    raise r.error
        return out

    def _map_concurrent(self, timed: Callable[[T], TimedResult],
                        jobs: list[T],
                        timeout_s: float | None) -> list[TimedResult]:
        workers = min(len(jobs),
                      self.max_workers or max(4, (os.cpu_count() or 4) * 2))
        pool = ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="repro-exec")
        try:
            futures: list[Future] = [pool.submit(timed, item) for item in jobs]
            if timeout_s is None:
                return [f.result() for f in futures]
            # Shared deadline: jobs run concurrently, so each is granted the
            # full timeout from submission; stragglers past it are abandoned
            # (their threads finish in the background, results dropped).
            deadline = time.monotonic() + timeout_s + 0.25
            pending = set(futures)
            while pending and time.monotonic() < deadline:
                done, pending = wait(pending, timeout=deadline - time.monotonic(),
                                     return_when=FIRST_COMPLETED)
            out = []
            for f in futures:
                if f in pending:
                    out.append(TimedResult(
                        value=None, wall_s=timeout_s,
                        error=DispatchTimeout(
                            f"job still running after {timeout_s:.3f}s")))
                else:
                    out.append(f.result())
            return out
        finally:
            # cancel_futures drops queued-but-unstarted jobs when a timeout
            # abandoned the batch; harmless when everything completed.
            pool.shutdown(wait=timeout_s is None, cancel_futures=True)

    def map(self, fn: Callable[[T], Any], items: Iterable[T]) -> list[Any]:
        """Like :meth:`map_timed` but returning bare values."""
        return [r.value for r in self.map_timed(fn, items)]
