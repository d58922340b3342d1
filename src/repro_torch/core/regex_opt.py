"""Regular-expression specialization (Blaze §4.3).

JSON Schema ``pattern`` / ``patternProperties`` use *search* (unanchored)
semantics.  Many real-world patterns are trivial and never need a regex
engine; we statically classify them into cheap forms:

* ``.*`` / ``^.*$`` / ``""``      -> ALL            (elide the check entirely)
* ``.+`` / ``^.+$``               -> NON_EMPTY      (length >= 1)
* ``^.{n,m}$`` / ``^.{n,}$`` ...  -> LENGTH_RANGE   (length bounds only)
* ``^lit``                        -> PREFIX         (paper's ``^x-`` case)
* ``lit$``                        -> SUFFIX         (beyond-paper, same spirit)
* ``^lit$``                       -> EXACT          (beyond-paper)
* ``lit``                         -> CONTAINS       (beyond-paper)
* anything else                   -> GENERIC        (engine fallback)

The paper chose ``.`` to match any character including newlines (the spec
leaves this open); we mirror that with ``re.DOTALL``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum
from typing import Optional


class RegexKind(Enum):
    ALL = "all"
    NON_EMPTY = "non_empty"
    LENGTH_RANGE = "length_range"
    PREFIX = "prefix"
    SUFFIX = "suffix"
    EXACT = "exact"
    CONTAINS = "contains"
    GENERIC = "generic"


# Characters that make a pattern fragment non-literal.
_META = set(".^$*+?()[]{}|\\")

_LENGTH_RANGE = re.compile(r"^\^\.\{(\d+)(,(\d*))?\}\$$")


@dataclass(frozen=True)
class RegexPlan:
    """Statically analysed pattern with a fast-path classification.

    ``risky`` marks GENERIC patterns whose shape can backtrack
    superlinearly (nested/adjacent quantified groups, quantified
    alternation) -- classified once at compile time, in the paper's
    spirit.  The bounded fallback executor refuses to run risky engine
    patterns under a deadline (``ValidationBudget.regex_gate``), because
    ``re`` cannot be preempted mid-match.
    """

    source: str
    kind: RegexKind
    literal: str = ""
    min_len: int = 0
    max_len: Optional[int] = None
    risky: bool = False

    def matches(self, value: str) -> bool:
        """Evaluate the plan against a string (search semantics)."""
        kind = self.kind
        if kind is RegexKind.ALL:
            return True
        if kind is RegexKind.NON_EMPTY:
            return len(value) >= 1
        if kind is RegexKind.LENGTH_RANGE:
            n = len(value)
            return n >= self.min_len and (self.max_len is None or n <= self.max_len)
        if kind is RegexKind.PREFIX:
            return value.startswith(self.literal)
        if kind is RegexKind.SUFFIX:
            return value.endswith(self.literal)
        if kind is RegexKind.EXACT:
            return value == self.literal
        if kind is RegexKind.CONTAINS:
            return self.literal in value
        return _engine(self.source).search(value) is not None

    @property
    def uses_engine(self) -> bool:
        return self.kind is RegexKind.GENERIC


_ENGINE_CACHE: dict = {}


def _engine(source: str) -> "re.Pattern[str]":
    """Compile-once regex engine fallback ('precompilation', §4.3)."""
    compiled = _ENGINE_CACHE.get(source)
    if compiled is None:
        compiled = re.compile(source, re.DOTALL)
        _ENGINE_CACHE[source] = compiled
    return compiled


def _is_literal(fragment: str) -> bool:
    return not any(ch in _META for ch in fragment)


# A quantified group whose body itself contains a quantifier or an
# alternation -- the classic exponential-backtracking shapes ((a+)+,
# (a|aa)*, (\d*)+...).  Conservative by construction: flagging a safe
# pattern only forces it onto the unbounded (non-deadline) path.
_NESTED_QUANT = re.compile(r"\((?:[^()\\]|\\.)*[*+|](?:[^()\\]|\\.)*\)\s*[*+{]")


def _backtracking_prone(source: str) -> bool:
    return _NESTED_QUANT.search(source) is not None


def analyze_pattern(source: str, *, enabled: bool = True) -> RegexPlan:
    """Classify ``source`` into a :class:`RegexPlan`.

    ``enabled=False`` forces the GENERIC engine path -- used by the §6.2.3
    ablation benchmark to disable this optimization wholesale.
    """
    if not enabled:
        plan = RegexPlan(source, RegexKind.GENERIC, risky=_backtracking_prone(source))
        _engine(source)  # precompile eagerly either way
        return plan

    if source in ("", ".*", "^.*$", ".*$", "^.*"):
        return RegexPlan(source, RegexKind.ALL)
    if source in (".+", "^.+$", ".+$", "^.+", "^.{1,}$"):
        return RegexPlan(source, RegexKind.NON_EMPTY)

    m = _LENGTH_RANGE.match(source)
    if m is not None:
        lo = int(m.group(1))
        if m.group(2) is None:  # ^.{n}$ -- exact length
            return RegexPlan(source, RegexKind.LENGTH_RANGE, min_len=lo, max_len=lo)
        hi = m.group(3)
        return RegexPlan(
            source,
            RegexKind.LENGTH_RANGE,
            min_len=lo,
            max_len=int(hi) if hi else None,
        )

    if len(source) >= 2 and source.startswith("^") and source.endswith("$"):
        body = source[1:-1]
        if _is_literal(body):
            return RegexPlan(source, RegexKind.EXACT, literal=body)
    if source.startswith("^") and _is_literal(source[1:]) and len(source) > 1:
        return RegexPlan(source, RegexKind.PREFIX, literal=source[1:])
    if source.endswith("$") and _is_literal(source[:-1]) and len(source) > 1:
        return RegexPlan(source, RegexKind.SUFFIX, literal=source[:-1])
    if source and _is_literal(source):
        return RegexPlan(source, RegexKind.CONTAINS, literal=source)

    _engine(source)  # precompile eagerly (Boost.Regex 'optimize' analogue)
    return RegexPlan(source, RegexKind.GENERIC, risky=_backtracking_prone(source))
