"""Pipeline cost-attribution profiler (DESIGN.md §13).

Phase-level wall-time attribution for the serving/admission pipeline:
*where* does an end-to-end request spend its time -- tokenizer walk vs
key hashing vs column packing, launch compile vs execute, sequential
fallback vs guard checks?  The closed-loop µs/doc aggregates in the
``BENCH_*`` files say *how fast*; this module says *why*.

The seam contract mirrors ``obs/trace.py``'s ``span()`` (and §11's
``fault_point``): module-level :func:`phase` costs exactly one global
``None`` check when no :class:`Profiler` is armed, returning a shared
no-op context manager.  Armed, each phase records two
``perf_counter_ns`` reads and a dict update -- phases are placed at
*batch/stage* granularity (one per launch, one per encode sub-stage),
never per token, so armed overhead stays in the low single-digit
percents.

Attribution semantics: phases nest.  Each :class:`PhaseStat` tracks
``total_ns`` (inclusive) and ``self_ns`` (exclusive -- child phase time
subtracted), so ``sum(self_ns)`` over all phases never double-counts
and can be compared directly against an end-to-end wall-clock window:
``Profiler.coverage(window_ns)`` is the fraction of the window the
instrumented phases explain (the acceptance bar is >=90% at B=4096).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "PhaseStat",
    "Profiler",
    "set_profiler",
    "profiler_armed",
    "phase",
]


class PhaseStat:
    """Accumulated timing for one named phase."""

    __slots__ = ("name", "calls", "total_ns", "self_ns")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.total_ns = 0
        self.self_ns = 0

    @property
    def total_us(self) -> float:
        return self.total_ns / 1e3

    @property
    def self_us(self) -> float:
        return self.self_ns / 1e3

    def as_dict(self) -> Dict[str, Any]:
        return {
            "calls": self.calls,
            "total_ns": self.total_ns,
            "self_ns": self.self_ns,
        }


class _PhaseCtx:
    """Context manager for one live phase (returned by ``Profiler.phase``)."""

    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof: "Profiler", name: str):
        self._prof = prof
        self._name = name

    def __enter__(self) -> "_PhaseCtx":
        self._prof._stack.append([self._name, 0])
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        dt = time.perf_counter_ns() - self._t0
        prof = self._prof
        _, child_ns = prof._stack.pop()
        stat = prof._stats.get(self._name)
        if stat is None:
            stat = prof._stats[self._name] = PhaseStat(self._name)
        stat.calls += 1
        stat.total_ns += dt
        stat.self_ns += dt - child_ns
        if prof._stack:
            prof._stack[-1][1] += dt  # bill inclusive time to the parent


class _NoopCtx:
    """Shared do-nothing context manager for the disarmed path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopCtx":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NOOP = _NoopCtx()


class Profiler:
    """Accumulates per-phase wall time with nesting-aware attribution.

    Arm with::

        with Profiler() as prof:
            ...  # instrumented code calls obs.profile.phase(...)
        print(prof.report())

    ``self_ns`` is exclusive time (children subtracted), so summing it
    across phases is double-count-free; ``coverage(window_ns)`` divides
    that sum by an externally measured end-to-end window.
    """

    def __init__(self) -> None:
        self._stats: Dict[str, PhaseStat] = {}
        # live stack of [name, accumulated_child_ns]
        self._stack: List[List[Any]] = []
        self._prev: Optional["Profiler"] = None

    # -- recording ---------------------------------------------------------

    def phase(self, name: str) -> _PhaseCtx:
        return _PhaseCtx(self, name)

    # -- views -------------------------------------------------------------

    def stats(self) -> Dict[str, PhaseStat]:
        return dict(self._stats)

    def attributed_ns(self) -> int:
        """Total exclusive nanoseconds across all phases (no double count)."""
        return sum(s.self_ns for s in self._stats.values())

    def coverage(self, window_ns: int) -> float:
        """Fraction of ``window_ns`` explained by recorded phases."""
        if window_ns <= 0:
            return 0.0
        return self.attributed_ns() / window_ns

    def report(self, window_ns: Optional[int] = None) -> Dict[str, Any]:
        """JSON-ready attribution report, phases sorted by exclusive time.

        With ``window_ns`` (an externally measured end-to-end window) the
        report carries per-phase window fractions plus the aggregate
        coverage and the unattributed remainder.
        """
        ordered = sorted(
            self._stats.values(), key=lambda s: s.self_ns, reverse=True
        )
        phases: Dict[str, Any] = {}
        for s in ordered:
            entry = s.as_dict()
            if window_ns:
                entry["window_frac"] = s.self_ns / window_ns
            phases[s.name] = entry
        out: Dict[str, Any] = {
            "phases": phases,
            "attributed_ns": self.attributed_ns(),
        }
        if window_ns:
            out["window_ns"] = window_ns
            out["coverage"] = self.coverage(window_ns)
            out["unattributed_ns"] = max(0, window_ns - self.attributed_ns())
        return out

    def clear(self) -> None:
        self._stats = {}
        self._stack = []

    # -- arming ------------------------------------------------------------

    def __enter__(self) -> "Profiler":
        self._prev = set_profiler(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        set_profiler(self._prev)
        self._prev = None


# ---------------------------------------------------------------------------
# Module-level seam (one None check when disarmed, like span/fault_point)
# ---------------------------------------------------------------------------


_PROFILER: Optional[Profiler] = None


def set_profiler(prof: Optional[Profiler]) -> Optional[Profiler]:
    """Install (or clear) the process-wide profiler; returns the prior one."""
    global _PROFILER
    prev = _PROFILER
    _PROFILER = prof
    return prev


def profiler_armed() -> bool:
    """True when a profiler is armed -- lets instrumented code pick a
    (more expensive) timed variant only when someone is measuring."""
    return _PROFILER is not None


def phase(name: str) -> Any:
    """Context manager attributing wall time to ``name``; shared no-op
    when disarmed."""
    if _PROFILER is None:
        return _NOOP
    return _PROFILER.phase(name)
