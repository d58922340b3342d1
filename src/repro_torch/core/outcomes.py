"""Fault-containment contract shared by every serving layer (DESIGN.md §11).

The gateway's degradation ladder -- batched launch -> bounded sequential
fallback -> guard-only reject -- is an engineered, observable contract,
not an accident of exception propagation.  This module owns the pieces
every layer agrees on:

- :class:`ValidationOutcome`: the terminal disposition of one request.
  Exactly one outcome per received document, so stats always reconcile
  (``received == sum(outcome counts)``).
- :class:`Verdict`: outcome + verdict + human-readable reason, the
  structured replacement for the old ``(request_id, error-string)``
  contract.
- :class:`GuardLimits` / :func:`resource_guard`: admission resource caps
  (payload bytes, nesting depth, node count) checked *before* any encode
  or parse work, with precise reject reasons.
- :class:`ValidationBudget`: per-document node/step budget + wall-clock
  deadline for the sequential fallback oracle (depth bombs and
  ReDoS-prone patterns return TIMED_OUT instead of stalling the engine).
- :class:`CircuitBreaker`: repeated fallback timeouts on an endpoint
  trip it into a degraded guard-only mode that recovers after cool-down
  (closed -> open -> half-open probe -> closed).
- :func:`fault_point` / :func:`set_fault_hook`: the seams the
  fault-injection harness (``serve/faults.py``) hooks into.  One global
  ``None`` check on the clean path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, Optional

__all__ = [
    "ValidationOutcome",
    "Verdict",
    "GuardLimits",
    "resource_guard",
    "ValidationBudget",
    "ValidationTimeout",
    "DocumentDepthError",
    "BreakerConfig",
    "CircuitBreaker",
    "InjectedFault",
    "fault_point",
    "fault_hook_armed",
    "set_fault_hook",
]


class ValidationOutcome(str, Enum):
    """Terminal disposition of one received document (exactly one each).

    ``ADMITTED``/``INVALID`` are definite schema verdicts (from either
    engine); the other four are the containment classes: rejected by a
    pre-validation guard, undecidable because the fallback rung is
    suspended, isolated after a per-document error, or over the fallback
    deadline/step budget.
    """

    ADMITTED = "admitted"
    INVALID = "invalid"
    REJECTED_GUARD = "rejected_guard"
    UNDECIDED_FALLBACK = "undecided_fallback"
    ERROR_ISOLATED = "error_isolated"
    TIMED_OUT = "timed_out"


@dataclass(frozen=True)
class Verdict:
    """Structured per-document admission result.

    ``site`` is populated only on INVALID verdicts from an
    ``explain=True`` admission: a ``core.explain.FailureSite`` naming
    the violated schema location, keyword, and instance JSON pointer
    (first failure under the tie-break contract of DESIGN.md §12).
    """

    outcome: ValidationOutcome
    valid: bool
    reason: str = ""
    engine: str = ""  # "batched" | "sequential" | "" (no engine ran)
    site: Any = None  # FailureSite | None (explain=True INVALID only)

    @property
    def admitted(self) -> bool:
        return self.outcome is ValidationOutcome.ADMITTED


# ---------------------------------------------------------------------------
# Admission resource guards (pre-encode, pre-parse)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GuardLimits:
    """Hard resource ceilings checked before any per-document work.

    Deliberately far above the *encode* budgets (``max_nodes``/
    ``max_depth`` of the token table): documents between the encode
    budget and these caps still take the sequential fallback; documents
    beyond them are rejected outright with a precise reason -- a depth
    bomb never reaches the tokenizer, the parser, or the oracle.
    """

    max_bytes: int = 4 << 20  # serialized payload (checked where raw bytes exist)
    max_depth: int = 128
    max_nodes: int = 65536


def resource_guard(doc: Any, limits: GuardLimits) -> str:
    """Return a precise reject reason, or ``""`` when within limits.

    One iterative traversal (explicit stack, no hashing, no recursion)
    with early exit the moment a cap is crossed -- strictly cheaper than
    the encode it protects.
    """
    nodes = 0
    stack = [(doc, 0)]
    max_depth = limits.max_depth
    max_nodes = limits.max_nodes
    while stack:
        value, depth = stack.pop()
        if depth > max_depth:
            return f"payload depth {depth} > guard cap {max_depth}"
        nodes += 1
        if nodes > max_nodes:
            return f"payload nodes > guard cap {max_nodes}"
        if type(value) is list:
            d = depth + 1
            for item in value:
                stack.append((item, d))
        elif type(value) is dict:
            d = depth + 1
            for item in value.values():
                stack.append((item, d))
        elif hasattr(value, "entries"):  # HashedObject
            d = depth + 1
            for _, _, item in value.entries:
                stack.append((item, d))
    return ""


# ---------------------------------------------------------------------------
# Bounded sequential fallback
# ---------------------------------------------------------------------------


class ValidationTimeout(Exception):
    """The bounded fallback ran out of steps, depth, or wall clock."""


class DocumentDepthError(ValueError):
    """A structured replacement for ``RecursionError`` on deep documents."""


class ValidationBudget:
    """Per-document step/depth budget + wall-clock deadline.

    ``tick()`` is called once per executed instruction; the wall clock is
    consulted every 128 steps (a ``time.monotonic`` call per instruction
    would dominate the work it meters).  ``enter_group``/``exit_group``
    bound the evaluation recursion explicitly, so depth bombs raise a
    structured :class:`ValidationTimeout` long before the interpreter
    stack overflows.
    """

    __slots__ = (
        "max_steps",
        "steps",
        "deadline",
        "clock",
        "max_eval_depth",
        "depth",
        "_next_check",
        "max_regex_chars",
    )

    _CHECK_EVERY = 128

    def __init__(
        self,
        *,
        max_steps: int = 500_000,
        deadline_s: Optional[float] = 0.25,
        max_eval_depth: int = 200,
        max_regex_chars: int = 1 << 16,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_steps = max_steps
        self.steps = 0
        self.clock = clock
        self.deadline = None if deadline_s is None else clock() + deadline_s
        self.max_eval_depth = max_eval_depth
        self.depth = 0
        self._next_check = self._CHECK_EVERY
        self.max_regex_chars = max_regex_chars

    def tick(self) -> None:
        self.steps += 1
        if self.steps >= self.max_steps:
            raise ValidationTimeout(
                f"step budget exhausted ({self.max_steps} instructions)"
            )
        if self.steps >= self._next_check:
            self._next_check = self.steps + self._CHECK_EVERY
            self.check_deadline()

    def check_deadline(self) -> None:
        if self.deadline is not None and self.clock() > self.deadline:
            raise ValidationTimeout("wall-clock deadline exceeded")

    def enter_group(self) -> None:
        self.depth += 1
        if self.depth > self.max_eval_depth:
            raise ValidationTimeout(
                f"evaluation depth {self.depth} > budget {self.max_eval_depth}"
            )

    def exit_group(self) -> None:
        self.depth -= 1

    def regex_gate(self, plan: Any, subject_len: int) -> None:
        """Engine regexes are not preemptible mid-match, so containment is
        decided *before* the call: patterns statically flagged as
        backtracking-prone (``regex_opt.analyze_pattern``) and oversized
        subjects are refused under a budget (DESIGN.md §11)."""
        if getattr(plan, "risky", False):
            raise ValidationTimeout(
                f"pattern {plan.source!r} is flagged backtracking-prone; "
                "refused under a fallback deadline"
            )
        if subject_len > self.max_regex_chars:
            raise ValidationTimeout(
                f"regex subject of {subject_len} chars > budget "
                f"{self.max_regex_chars}"
            )


# ---------------------------------------------------------------------------
# Circuit breaker (per-endpoint fallback health)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BreakerConfig:
    threshold: int = 3  # consecutive fallback timeouts that trip the breaker
    cooldown_s: float = 30.0


class CircuitBreaker:
    """Closed -> open (after N consecutive timeouts) -> half-open -> closed.

    While open, the endpoint's sequential-fallback rung is suspended
    (guard-only degraded mode); after ``cooldown_s`` one probe request is
    allowed through (half-open) -- success closes the breaker, another
    timeout re-opens it for a fresh cool-down.  Only *timeouts* count:
    schema-invalid documents and isolated errors are normal traffic.
    """

    __slots__ = ("cfg", "clock", "consecutive", "state", "open_until", "trips")

    def __init__(
        self,
        cfg: BreakerConfig = BreakerConfig(),
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg
        self.clock = clock
        self.consecutive = 0
        self.state = "closed"  # closed | open | half_open
        self.open_until = 0.0
        self.trips = 0

    def allow(self) -> bool:
        """May a fallback validation run now?  (May transition to half-open.)"""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.clock() >= self.open_until:
                self.state = "half_open"
                return True  # one probe
            return False
        return False  # half_open: probe already in flight this window

    def record_timeout(self) -> None:
        self.consecutive += 1
        if self.state == "half_open" or self.consecutive >= self.cfg.threshold:
            self.state = "open"
            self.open_until = self.clock() + self.cfg.cooldown_s
            self.trips += 1
            self.consecutive = 0

    def record_success(self) -> None:
        self.consecutive = 0
        self.state = "closed"


# ---------------------------------------------------------------------------
# Fault-injection seams
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Raised by the fault-injection harness at an armed fault point."""


_FAULT_HOOK: Optional[Callable[[str, Any], None]] = None


def set_fault_hook(
    hook: Optional[Callable[[str, Any], None]]
) -> Optional[Callable[[str, Any], None]]:
    """Install (or clear) the process-wide fault hook; returns the prior one."""
    global _FAULT_HOOK
    prev = _FAULT_HOOK
    _FAULT_HOOK = hook
    return prev


def fault_hook_armed() -> bool:
    """True when a fault harness is armed -- lets hot paths skip building
    expensive fault-point keys (e.g. the per-launch key tuple)."""
    return _FAULT_HOOK is not None


def fault_point(point: str, key: Any = None) -> None:
    """Injectable failure seam: no-op unless a harness armed a hook.

    Points wired through the serve stack: ``"encode"`` (per document,
    inside DocTable tokenization), ``"launch"`` (per batched launch,
    ``key`` = tuple of document keys in the launch), ``"fallback"`` (per
    document, before the sequential oracle), ``"link"`` (per
    registration, before the trial tape link).
    """
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(point, key)
