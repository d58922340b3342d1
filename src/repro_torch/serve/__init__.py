"""Serving: request admission (Blaze), prefill/decode engine, KV caching,
and the streaming micro-batch scheduler (DESIGN.md §14)."""

from .engine import ServeConfig, ServeEngine, SubmitResult
from .faults import FaultInjector
from .scheduler import (
    CostModel,
    DrainReport,
    SchedulerConfig,
    StreamScheduler,
    Ticket,
)

__all__ = [
    "ServeConfig",
    "ServeEngine",
    "SubmitResult",
    "FaultInjector",
    "SchedulerConfig",
    "StreamScheduler",
    "CostModel",
    "DrainReport",
    "Ticket",
]
