"""Serving observability: tracing, metrics, profiling, events, SLOs.

Spans + metric registry are DESIGN.md §12; the cost-attribution
profiler, sampled event log, and SLO/burn-rate tracking are §13.

Zero-dependency by design -- the serve stack imports this package
unconditionally, so it must cost nothing when disarmed: ``span()``/
``trace_point()``/``phase()`` pay one module-global ``None`` check (the
``fault_point`` contract), and registry-backed counters are plain
attribute adds.
"""

from .events import EventLog
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
from .slo import SLObjective, SLOTracker, slo_status
from .stats import RegistryBackedStats
from .trace import (
    Span,
    Tracer,
    set_tracer,
    span,
    trace_point,
    tracer_armed,
)

__all__ = [
    "RegistryBackedStats",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "DEFAULT_LATENCY_BUCKETS",
    "EventLog",
    "PhaseStat",
    "Profiler",
    "phase",
    "profiler_armed",
    "set_profiler",
    "SLObjective",
    "SLOTracker",
    "slo_status",
    "Span",
    "Tracer",
    "set_tracer",
    "span",
    "trace_point",
    "tracer_armed",
]
