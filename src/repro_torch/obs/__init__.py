"""Serving observability: tracing spans, metrics and the phase profiler.

Zero-dependency by design: ``span()``/``trace_point()``/``phase()`` pay
one module-global ``None`` check when disarmed, and registry-backed
counters are plain attribute adds.
"""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    DEFAULT_LATENCY_BUCKETS,
)
from .profile import (
    PhaseStat,
    Profiler,
    phase,
    profiler_armed,
    set_profiler,
)
from .trace import (
    Span,
    Tracer,
    set_tracer,
    span,
    trace_point,
    tracer_armed,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "DEFAULT_LATENCY_BUCKETS",
    "PhaseStat",
    "Profiler",
    "phase",
    "profiler_armed",
    "set_profiler",
    "Span",
    "Tracer",
    "set_tracer",
    "span",
    "trace_point",
    "tracer_armed",
]
