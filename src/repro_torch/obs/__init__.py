"""Observability layer: span tracing, metrics, prediction ledger, logging.

Zero-dependency and off by default. Enable tracing per scheduler with
``Scheduler(trace=True)`` (or pass a :class:`Tracer`), or process-wide
with ``REPRO_TRACE=1`` — the default tracer then writes a Perfetto-ready
Chrome trace JSON (``REPRO_TRACE_PATH``, default ``repro_trace.json``)
at exit. The :class:`PredictionLedger` rides the same switch and streams
the paper's within-10% prediction claim live.
"""
from .ledger import LedgerEntry, PredictionLedger, relative_error
from .log import get_logger
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricSnapshot,
                      MetricsRegistry, counter, gauge, histogram)
from .trace import (Span, Tracer, default_tracer, env_enabled,
                    lift_solver_phases, render_span_tree, resolve_tracer,
                    set_default_tracer, validate_chrome_trace)

__all__ = [
    "Span", "Tracer", "default_tracer", "env_enabled", "resolve_tracer",
    "set_default_tracer", "lift_solver_phases", "validate_chrome_trace",
    "render_span_tree",
    "Counter", "Gauge", "Histogram", "MetricSnapshot", "MetricsRegistry",
    "REGISTRY", "counter", "gauge", "histogram",
    "LedgerEntry", "PredictionLedger", "relative_error",
    "get_logger",
]
