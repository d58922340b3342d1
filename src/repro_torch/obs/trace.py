"""Zero-dependency tracing core (DESIGN.md §12).

Span/Tracer with monotonic-clock nesting and a ring buffer of recent
spans, plus module-level ``span()``/``trace_point()`` seams that mirror
the ``fault_point`` pattern of ``core/outcomes.py``: the clean path pays
exactly one global ``None`` check when no tracer is armed.

Instrumentation rule of thumb: trace per *batch* or per *stage*, never
per document -- a span costs two ``time.monotonic_ns()`` calls and one
ring-buffer append, which is noise at batch granularity and a disaster
at document granularity.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Span",
    "Tracer",
    "set_tracer",
    "tracer_armed",
    "span",
    "trace_point",
]


@dataclass
class Span:
    """One completed (or point-in-time) trace record.

    ``dur_ns`` is -1 for point events; ``depth`` is the nesting level at
    entry so renderers can indent without replaying the stack.
    """

    name: str
    t0_ns: int
    dur_ns: int = -1
    depth: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur_us(self) -> float:
        return self.dur_ns / 1e3 if self.dur_ns >= 0 else -1.0


class _SpanCtx:
    """Context manager for one live span (returned by ``Tracer.span``)."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_SpanCtx":
        self._depth = self._tracer._depth
        self._tracer._depth += 1
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        dur = time.monotonic_ns() - self._t0
        self._tracer._depth -= 1
        self._tracer._record(
            Span(self._name, self._t0, dur, self._depth, self._attrs)
        )


class _NoopCtx:
    """Shared do-nothing context manager for the disarmed path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopCtx":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NOOP = _NoopCtx()


class Tracer:
    """Ring buffer of recent spans with explicit nesting depth.

    Appends overwrite the oldest entry once ``capacity`` is reached
    (single-threaded "lock-free-ish": one index increment per record,
    no allocation beyond the Span itself).  Arm with::

        with Tracer(capacity=512) as tr:
            ...  # instrumented code calls obs.trace.span(...)
        spans = tr.recent()
    """

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._ring: List[Optional[Span]] = [None] * capacity
        self._next = 0  # total spans ever recorded
        self._depth = 0
        self._prev: Optional["Tracer"] = None

    # -- recording ---------------------------------------------------------

    def _record(self, s: Span) -> None:
        self._ring[self._next % self.capacity] = s
        self._next += 1

    def span(self, name: str, **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, name, attrs)

    def point(self, name: str, **attrs: Any) -> None:
        self._record(
            Span(name, time.monotonic_ns(), -1, self._depth, attrs)
        )

    # -- views -------------------------------------------------------------

    @property
    def recorded(self) -> int:
        """Total spans recorded since construction (including evicted)."""
        return self._next

    def recent(self) -> List[Span]:
        """Spans still in the ring, oldest first."""
        n = self._next
        if n <= self.capacity:
            return [s for s in self._ring[:n] if s is not None]
        start = n % self.capacity
        out = self._ring[start:] + self._ring[:start]
        return [s for s in out if s is not None]

    def clear(self) -> None:
        self._ring = [None] * self.capacity
        self._next = 0
        self._depth = 0

    # -- arming ------------------------------------------------------------

    def __enter__(self) -> "Tracer":
        self._prev = set_tracer(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        set_tracer(self._prev)
        self._prev = None


# ---------------------------------------------------------------------------
# Module-level seams (one None check when disarmed, like fault_point)
# ---------------------------------------------------------------------------


_TRACER: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or clear) the process-wide tracer; returns the prior one."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def tracer_armed() -> bool:
    """True when a tracer is armed -- lets hot paths skip building
    expensive span attributes."""
    return _TRACER is not None


def span(name: str, **attrs: Any) -> Any:
    """Context manager for a named span; shared no-op when disarmed."""
    if _TRACER is None:
        return _NOOP
    return _TRACER.span(name, **attrs)


def trace_point(name: str, **attrs: Any) -> None:
    """Point-in-time trace event; no-op unless a tracer is armed."""
    if _TRACER is not None:
        _TRACER.point(name, **attrs)
