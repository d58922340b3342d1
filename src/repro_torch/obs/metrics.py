"""Zero-dependency metric registry (DESIGN.md §12).

Counters, gauges, and fixed-log-bucket histograms with Prometheus-style
text exposition and a JSON snapshot.  The registry replaces the ad-hoc
``ServeStats``/``PipelineStats`` integer fields: each stats object keeps
its attribute API as a *compatibility view* over registry children, so
``engine.stats.received`` and ``registry.render_prometheus()`` are two
projections of the same storage.

Design constraints (mirroring the ``fault_point`` contract of
``core/outcomes.py``):

- The hot path touches plain Python attributes -- ``Counter.inc`` is an
  integer add, ``Histogram.observe`` is one ``bisect`` call.  No locks,
  no string formatting, no label-dict hashing per observation: callers
  cache child objects once (``registry.counter(...)`` is the slow,
  idempotent lookup) and hit ``.inc()``/``.observe()`` thereafter.
- ``reset()`` zeroes children *in place* so cached references held by
  instrumented code stay valid across benchmark runs.
- Histogram buckets are fixed at construction (default: log-spaced
  base-4 edges from 1µs), so exposition is allocation-free and bucket
  math is a binary search, never a resize.
"""

from __future__ import annotations

import json
from bisect import bisect_right
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "DEFAULT_LATENCY_BUCKETS",
]

Number = Union[int, float]

#: Default histogram edges for latency-in-seconds metrics: log-spaced
#: base-4 from 1µs to ~67s (1e-6 * 4**k).  Twelve finite edges keep the
#: exposition small while spanning sub-µs guard checks to multi-second
#: fallback timeouts; +Inf is implicit.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    1e-6 * 4**k for k in range(13)
)


def _fmt(v: Number) -> str:
    """Prometheus-friendly number rendering (ints stay integral)."""
    if isinstance(v, float):
        if v == float("inf"):
            return "+Inf"
        if v.is_integer() and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


class Counter:
    """Monotonic (by convention) numeric counter.

    Float-capable so aggregate-seconds counters (``validation_seconds``)
    ride the same machinery.  ``set`` exists for the compatibility view
    (``stats.received += 1`` reads then writes the property).
    """

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def set(self, v: Number) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time numeric value (breaker state, queue depth)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Histogram:
    """Fixed-bucket histogram (cumulative-at-exposition, like Prometheus).

    ``buckets`` holds per-bucket (non-cumulative) counts for the finite
    edges plus one overflow slot; exposition accumulates.  ``observe``
    is one ``bisect_right`` + two adds.  ``observe_many`` amortizes a
    batch of identical observations in O(1) -- the serve engine uses it
    to bill a batched launch to per-endpoint request counts without a
    per-document Python loop.
    """

    __slots__ = ("edges", "buckets", "count", "sum")

    def __init__(self, edges: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.edges: Tuple[float, ...] = tuple(sorted(edges))
        self.buckets: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum: float = 0.0

    def observe(self, v: float) -> None:
        self.buckets[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.sum += v

    def observe_many(self, v: float, n: int) -> None:
        if n <= 0:
            return
        self.buckets[bisect_right(self.edges, v)] += n
        self.count += n
        self.sum += v * n

    def reset(self) -> None:
        for i in range(len(self.buckets)):
            self.buckets[i] = 0
        self.count = 0
        self.sum = 0.0

    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper_edge, cumulative_count) pairs including +Inf."""
        out: List[Tuple[float, int]] = []
        running = 0
        for edge, n in zip(self.edges, self.buckets):
            running += n
            out.append((edge, running))
        out.append((float("inf"), self.count))
        return out


LabelKey = Tuple[Tuple[str, str], ...]


class _Family:
    """One metric name: type, help text, and children keyed by labels."""

    __slots__ = ("name", "kind", "help", "children", "buckets")

    def __init__(
        self,
        name: str,
        kind: str,
        help_text: str,
        buckets: Optional[Sequence[float]] = None,
    ):
        self.name = name
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.help = help_text
        self.children: Dict[LabelKey, Any] = {}
        self.buckets = tuple(buckets) if buckets is not None else None

    def child(self, labels: Dict[str, str]) -> Any:
        key: LabelKey = tuple(sorted((k, str(v)) for k, v in labels.items()))
        got = self.children.get(key)
        if got is None:
            if self.kind == "counter":
                got = Counter()
            elif self.kind == "gauge":
                got = Gauge()
            else:
                got = Histogram(self.buckets or DEFAULT_LATENCY_BUCKETS)
            self.children[key] = got
        return got


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class MetricRegistry:
    """Namespace of counter/gauge/histogram families.

    ``counter``/``gauge``/``histogram`` are idempotent child lookups --
    call once at wiring time, cache the returned object, mutate it on
    the hot path.  ``render_prometheus()`` emits the text exposition
    format; ``snapshot()`` returns a JSON-serializable dict;
    ``reset()`` zeroes every child in place.
    """

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}

    # -- child accessors ---------------------------------------------------

    def _family(
        self,
        name: str,
        kind: str,
        help_text: str,
        buckets: Optional[Sequence[float]] = None,
    ) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, help_text, buckets)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, not {kind}"
            )
        return fam

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._family(name, "counter", help).child(labels)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._family(name, "gauge", help).child(labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
        **labels: str,
    ) -> Histogram:
        return self._family(name, "histogram", help, buckets).child(labels)

    # -- views -------------------------------------------------------------

    def family_children(self, name: str) -> Dict[LabelKey, Any]:
        fam = self._families.get(name)
        return fam.children if fam is not None else {}

    def render_prometheus(self) -> str:
        """Prometheus text exposition (HELP/TYPE + one line per child)."""
        lines: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.children):
                child = fam.children[key]
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{name}{_label_str(key)} {_fmt(child.value)}")
                else:
                    for edge, cum in child.cumulative():
                        le = (("le", _fmt(edge)),)
                        lines.append(
                            f"{name}_bucket{_label_str(key + le)} {cum}"
                        )
                    lines.append(
                        f"{name}_sum{_label_str(key)} {_fmt(child.sum)}"
                    )
                    lines.append(
                        f"{name}_count{_label_str(key)} {child.count}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable dump of every family and child."""
        out: Dict[str, Any] = {}
        for name in sorted(self._families):
            fam = self._families[name]
            children = []
            for key in sorted(fam.children):
                child = fam.children[key]
                entry: Dict[str, Any] = {"labels": dict(key)}
                if fam.kind in ("counter", "gauge"):
                    entry["value"] = child.value
                else:
                    entry["count"] = child.count
                    entry["sum"] = child.sum
                    entry["buckets"] = [
                        [e if e != float("inf") else "+Inf", c]
                        for e, c in child.cumulative()
                    ]
                children.append(entry)
            out[name] = {"type": fam.kind, "help": fam.help, "children": children}
        return out

    def snapshot_json(self, **kwargs: Any) -> str:
        return json.dumps(self.snapshot(), **kwargs)

    def reset(self) -> None:
        """Zero every child in place (cached references stay valid)."""
        for fam in self._families.values():
            for child in fam.children.values():
                child.reset()
