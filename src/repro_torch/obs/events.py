"""Sampled structured request-event log (DESIGN.md §13).

Aggregate metrics (``obs/metrics.py``) answer "how many / how fast on
average"; the event log answers "what did *this* request's life look
like" -- one structured record per sampled request carrying endpoint,
outcome, per-stage timings, and batch id, kept in a bounded ring and
flushable as JSONL.

Design constraints:

- **Bounded**: a fixed-capacity ring of plain dicts; the oldest record
  is overwritten once full.  No allocation beyond the record itself.
- **Sampled deterministically**: ``sample`` is the long-run fraction of
  candidate events recorded.  The schedule is counter-based (record the
  n-th candidate iff ``floor(n * sample)`` advances), so a given rate
  records the *same* subsequence on every run -- reproducible across
  processes, no RNG state to carry, and exact in the long run (never
  "unlucky" bursts of zero samples).
- **Cheap when attached**: the serving hot path asks :meth:`want` (two
  integer ops) before building the record dict, so unsampled requests
  pay almost nothing and a detached engine (``events=None``) pays one
  ``None`` check.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, IO, List, Optional, Union

__all__ = ["EventLog"]


class EventLog:
    """Fixed-capacity ring of sampled request events, JSONL-flushable."""

    def __init__(self, capacity: int = 4096, sample: float = 1.0):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if not (0.0 <= sample <= 1.0):
            raise ValueError("sample must be in [0, 1]")
        self.capacity = capacity
        self.sample = sample
        self._ring: List[Optional[Dict[str, Any]]] = [None] * capacity
        self._next = 0  # total records ever written
        self._seen = 0  # candidate events offered (want() calls)
        self._quota = 0  # samples granted so far by the schedule

    # -- sampling ----------------------------------------------------------

    def want(self) -> bool:
        """Deterministic sampling decision for the next candidate event.

        Call exactly once per candidate; build + :meth:`emit` the record
        only when it returns True.
        """
        self._seen += 1
        due = int(self._seen * self.sample)
        if due > self._quota:
            self._quota = due
            return True
        return False

    # -- recording ---------------------------------------------------------

    def emit(self, **fields: Any) -> Dict[str, Any]:
        """Record one event (adds a wall-clock ``ts`` unless provided)."""
        record = dict(fields)
        record.setdefault("ts", time.time())
        self._ring[self._next % self.capacity] = record
        self._next += 1
        return record

    # -- views -------------------------------------------------------------

    @property
    def seen(self) -> int:
        """Candidate events offered to the sampler."""
        return self._seen

    @property
    def recorded(self) -> int:
        """Events actually recorded (including ring-evicted ones)."""
        return self._next

    def recent(self) -> List[Dict[str, Any]]:
        """Records still in the ring, oldest first."""
        n = self._next
        if n <= self.capacity:
            return [r for r in self._ring[:n] if r is not None]
        start = n % self.capacity
        out = self._ring[start:] + self._ring[:start]
        return [r for r in out if r is not None]

    def clear(self) -> None:
        self._ring = [None] * self.capacity
        self._next = 0

    def flush(self, dest: Union[str, IO[str]]) -> int:
        """Append the ring's records to ``dest`` as JSONL and clear it.

        ``dest`` is a path (opened in append mode) or a writable text
        file object.  Returns the number of records written.
        """
        records = self.recent()
        if isinstance(dest, str):
            with open(dest, "a", encoding="utf-8") as fp:
                for r in records:
                    fp.write(json.dumps(r, sort_keys=True) + "\n")
        else:
            for r in records:
                dest.write(json.dumps(r, sort_keys=True) + "\n")
        self.clear()
        return len(records)
