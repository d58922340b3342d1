"""Per-endpoint latency SLOs and error-budget burn rates (DESIGN.md §13).

An SLO here is "fraction ``target`` of requests complete within
``objective_s`` seconds", evaluated directly against the
``serve_request_seconds{endpoint}`` histograms that the engine already
maintains -- no second measurement path, no extra hot-path cost.

Formulas (standard SRE error-budget arithmetic):

- ``good_ratio = good / count`` where ``good`` is the (interpolated)
  cumulative histogram count at ``objective_s``;
- ``error_budget = 1 - target`` (the tolerated bad fraction);
- ``burn_rate = (1 - good_ratio) / error_budget`` -- 1.0 means the
  endpoint is consuming its budget exactly as provisioned, >1 means it
  will exhaust the budget early (2.0 = twice as fast), <1 means margin.

Because the histogram buckets are fixed log-spaced edges, an objective
that is not exactly a bucket edge is resolved by *linear interpolation
within its bucket* -- documented imprecision bounded by one bucket's
width (base-4 edges: at most the span between adjacent powers of four).
Choose objectives on bucket edges when exactness matters.

:class:`SLOTracker` adds windowed burn rates: each :meth:`update` diffs
the histogram against the previous call's totals, so the ``window_*``
fields reflect only traffic since the last refresh (the control plane
polls this at its own cadence; two successive polls bound the window).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

from .metrics import Histogram

__all__ = ["SLObjective", "good_count", "slo_status", "SLOTracker"]


@dataclass(frozen=True)
class SLObjective:
    """A latency objective: ``target`` fraction within ``objective_s``."""

    objective_s: float = 0.1
    target: float = 0.99

    def __post_init__(self) -> None:
        if self.objective_s <= 0:
            raise ValueError("objective_s must be positive")
        if not (0.0 < self.target < 1.0):
            raise ValueError("target must be in (0, 1)")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target


def good_count(hist: Histogram, objective_s: float) -> float:
    """Cumulative observation count at ``objective_s``.

    Exact when the objective is a bucket edge; linearly interpolated
    within the containing bucket otherwise.  Past the last finite edge
    the count is clamped to the last finite cumulative value (the +Inf
    bucket cannot be interpolated, so out-of-range observations are
    conservatively counted as bad).
    """
    prev_edge = 0.0
    prev_cum = 0
    running = 0
    for edge, n in zip(hist.edges, hist.buckets):
        running += n
        if objective_s >= edge:
            prev_edge, prev_cum = edge, running
            continue
        span = edge - prev_edge
        frac = (objective_s - prev_edge) / span if span > 0 else 0.0
        return prev_cum + frac * (running - prev_cum)
    return float(prev_cum)


def slo_status(hist: Histogram, slo: SLObjective) -> Dict[str, Any]:
    """Cumulative SLO view of one latency histogram."""
    count = hist.count
    good = good_count(hist, slo.objective_s)
    good_ratio = (good / count) if count else 1.0
    return {
        "objective_s": slo.objective_s,
        "target": slo.target,
        "count": count,
        "good": good,
        "good_ratio": good_ratio,
        "error_budget": slo.error_budget,
        "burn_rate": (1.0 - good_ratio) / slo.error_budget,
    }


class SLOTracker:
    """Windowed burn-rate tracking over a live histogram.

    Stateful companion to :func:`slo_status`: remembers the (count,
    good) totals of the previous :meth:`update`, so each call also
    reports the burn rate of just the traffic observed since then.
    """

    __slots__ = ("slo", "_last")

    def __init__(self, slo: SLObjective):
        self.slo = slo
        self._last: Tuple[int, float] = (0, 0.0)

    def update(self, hist: Histogram) -> Dict[str, Any]:
        out = slo_status(hist, self.slo)
        prev_count, prev_good = self._last
        d_count = out["count"] - prev_count
        d_good = out["good"] - prev_good
        if d_count > 0:
            window_ratio = min(1.0, max(0.0, d_good / d_count))
        else:
            window_ratio = 1.0
        out["window_count"] = d_count
        out["window_good_ratio"] = window_ratio
        out["window_burn_rate"] = (1.0 - window_ratio) / self.slo.error_budget
        self._last = (out["count"], out["good"])
        return out
