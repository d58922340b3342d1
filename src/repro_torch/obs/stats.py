"""Registry-backed stats objects (DESIGN.md §12).

``ServeStats``/``PipelineStats`` historically were plain dataclasses of
ad-hoc integer fields; exporting them meant hand-rolling a formatter per
consumer.  :class:`RegistryBackedStats` keeps the *attribute API* intact
(``stats.received += 1`` still works, tests and examples unchanged)
while every field is now a live :class:`~repro.obs.metrics.Counter`
child of a shared :class:`~repro.obs.metrics.MetricRegistry` -- so one
``render_prometheus()`` exports serving counters, executor launch
timings, and control-plane swaps from the same registry.

Subclasses declare ``PREFIX`` + ``INT_FIELDS``/``FLOAT_FIELDS``;
attribute access is routed through ``__getattr__``/``__setattr__`` to
the backing counters.  ``snapshot()`` returns a plain-dict view and
``reset()`` zeroes only the counters *this stats object owns* (a shared
registry's other families are untouched).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .metrics import Counter, MetricRegistry

__all__ = ["RegistryBackedStats"]


class RegistryBackedStats:
    """Attribute-compatible stats facade over registry counters."""

    PREFIX: str = ""
    INT_FIELDS: Tuple[str, ...] = ()
    FLOAT_FIELDS: Tuple[str, ...] = ()
    HELP: Dict[str, str] = {}

    def __init__(self, metrics: Optional[MetricRegistry] = None):
        # _stat_children must exist before any routed attribute access
        object.__setattr__(self, "_stat_children", {})
        object.__setattr__(self, "_own", [])
        self.metrics = metrics if metrics is not None else MetricRegistry()
        for name in (*self.INT_FIELDS, *self.FLOAT_FIELDS):
            self._stat_children[name] = self._track(
                self.metrics.counter(
                    f"{self.PREFIX}{name}_total", self.HELP.get(name, "")
                )
            )

    def _track(self, counter: Counter) -> Counter:
        """Register a counter as owned (zeroed by :meth:`reset`)."""
        self._own.append(counter)
        return counter

    def __getattr__(self, name: str) -> Any:
        # only reached when normal lookup fails: stat fields live in the
        # registry, everything else is a genuine AttributeError
        children = object.__getattribute__(self, "_stat_children")
        if name in children:
            return children[name].value
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}"
        )

    def __setattr__(self, name: str, value: Any) -> None:
        children = self.__dict__.get("_stat_children")
        if children is not None and name in children:
            children[name].set(value)
        else:
            object.__setattr__(self, name, value)

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time plain-dict view of every scalar field."""
        return {name: c.value for name, c in self._stat_children.items()}

    def reset(self) -> None:
        """Zero every owned counter (other registry families untouched)."""
        own: List[Counter] = self._own
        for c in own:
            c.reset()

    def __repr__(self) -> str:  # debugging/test-failure friendliness
        fields = ", ".join(f"{k}={v!r}" for k, v in self.snapshot().items())
        return f"{type(self).__name__}({fields})"
