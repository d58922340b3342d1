"""Conservative satisfiability summaries for prune proofs.

A :class:`Summary` is an *over-approximation* of a schema's set of
valid instances built from the keywords the analyzer understands
(type sets, numeric/length intervals, required keys, closed-object
vocabularies, enum/const candidates).  Keywords the analyzer does not
model are simply ignored, which keeps the over-approximation sound:
the true valid set is always a subset of what the summary admits.

Because the summary over-approximates, **emptiness of the summary is
a proof of unsatisfiability of the schema** -- that is the only
direction the pruner ever uses.  The converse (a non-empty summary)
proves nothing, and callers must treat it as "unknown => keep".
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, FrozenSet, List, Optional, Tuple

from ..core.doc_model import json_equal

__all__ = ["Summary", "summarize", "conjoin", "is_empty", "is_top", "ALL_TYPES"]

ALL_TYPES = frozenset({"null", "boolean", "number", "integer", "string", "object", "array"})

# Keys that never constrain validation (annotations / identifiers).
ANNOTATION_KEYS = frozenset(
    {
        "title",
        "description",
        "default",
        "examples",
        "example",
        "$comment",
        "deprecated",
        "readOnly",
        "writeOnly",
        "$schema",
        "$id",
        "id",
        "$anchor",
        "$defs",
        "definitions",
        "format",  # annotation-only in every dialect this repo compiles
        "contentMediaType",
        "contentEncoding",
    }
)

_INF = math.inf


@dataclass(frozen=True)
class Summary:
    """Abstract domain element: conjunction of interval / set facts."""

    types: FrozenSet[str] = ALL_TYPES
    num_lo: float = -_INF
    num_lo_excl: bool = False
    num_hi: float = _INF
    num_hi_excl: bool = False
    str_min: int = 0
    str_max: float = _INF
    arr_min: int = 0
    arr_max: float = _INF
    obj_min: int = 0
    obj_max: float = _INF
    required: FrozenSet[str] = frozenset()
    closed: bool = False
    # property vocabulary when closed (only meaningful without
    # patternProperties, which the summarizer checks before setting it)
    closed_props: Optional[FrozenSet[str]] = None
    # property names whose subschema is literally unsatisfiable
    false_props: FrozenSet[str] = frozenset()
    # enum/const candidates (None = unconstrained)
    values: Optional[Tuple[Any, ...]] = None


TOP = Summary()


def _as_num(v: Any) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def summarize(schema: Any) -> Summary:
    """Build the over-approximating summary for one schema node.

    Only conjunctive keywords at this node (plus ``allOf`` members,
    recursively) are folded in; disjunctions (``anyOf``/``oneOf``),
    negation, conditionals and references are ignored -- ignoring a
    constraint only enlarges the summary, never shrinks it.
    """
    if schema is True:
        return TOP
    if schema is False:
        return replace(TOP, types=frozenset())
    if not isinstance(schema, dict):
        return TOP

    s = TOP

    t = schema.get("type")
    if isinstance(t, str):
        s = replace(s, types=_expand_types(frozenset({t})))
    elif isinstance(t, list) and all(isinstance(x, str) for x in t):
        s = replace(s, types=_expand_types(frozenset(t)))

    lo = _as_num(schema.get("minimum"))
    hi = _as_num(schema.get("maximum"))
    xlo = schema.get("exclusiveMinimum")
    xhi = schema.get("exclusiveMaximum")
    if lo is not None:
        # draft-04 boolean form: exclusiveMinimum: true modifies minimum
        excl = xlo is True
        s = _meet_lo(s, lo, excl)
    if isinstance(xlo, (int, float)) and not isinstance(xlo, bool):
        s = _meet_lo(s, float(xlo), True)
    if hi is not None:
        excl = xhi is True
        s = _meet_hi(s, hi, excl)
    if isinstance(xhi, (int, float)) and not isinstance(xhi, bool):
        s = _meet_hi(s, float(xhi), True)

    def _nat(key: str) -> Optional[int]:
        v = schema.get(key)
        if isinstance(v, bool) or not isinstance(v, int):
            return None
        return v

    if (v := _nat("minLength")) is not None:
        s = replace(s, str_min=max(s.str_min, v))
    if (v := _nat("maxLength")) is not None:
        s = replace(s, str_max=min(s.str_max, v))
    if (v := _nat("minItems")) is not None:
        s = replace(s, arr_min=max(s.arr_min, v))
    if (v := _nat("maxItems")) is not None:
        s = replace(s, arr_max=min(s.arr_max, v))
    if (v := _nat("minProperties")) is not None:
        s = replace(s, obj_min=max(s.obj_min, v))
    if (v := _nat("maxProperties")) is not None:
        s = replace(s, obj_max=min(s.obj_max, v))

    req = schema.get("required")
    if isinstance(req, list) and all(isinstance(k, str) for k in req):
        s = replace(s, required=s.required | frozenset(req))

    props = schema.get("properties")
    if isinstance(props, dict):
        falsy = frozenset(k for k, sub in props.items() if sub is False)
        if falsy:
            s = replace(s, false_props=s.false_props | falsy)
    if schema.get("additionalProperties") is False and "patternProperties" not in schema:
        vocab = frozenset(props.keys()) if isinstance(props, dict) else frozenset()
        s = replace(s, closed=True, closed_props=vocab)

    if "enum" in schema and isinstance(schema["enum"], list):
        s = _meet_values(s, tuple(schema["enum"]))
    if "const" in schema:
        s = _meet_values(s, (schema["const"],))

    subs = schema.get("allOf")
    if isinstance(subs, list):
        for sub in subs:
            s = conjoin(s, summarize(sub))

    return s


def _expand_types(types: FrozenSet[str]) -> FrozenSet[str]:
    # "number" admits integers too; keep "integer" alongside so
    # intersections with {"integer"} stay non-trivial.
    if "number" in types:
        return types | {"integer"}
    return types


def _meet_lo(s: Summary, lo: float, excl: bool) -> Summary:
    if lo > s.num_lo or (lo == s.num_lo and excl):
        return replace(s, num_lo=lo, num_lo_excl=excl)
    return s


def _meet_hi(s: Summary, hi: float, excl: bool) -> Summary:
    if hi < s.num_hi or (hi == s.num_hi and excl):
        return replace(s, num_hi=hi, num_hi_excl=excl)
    return s


def _meet_values(s: Summary, vals: Tuple[Any, ...]) -> Summary:
    if s.values is None:
        return replace(s, values=vals)
    kept = tuple(v for v in s.values if any(json_equal(v, w) for w in vals))
    return replace(s, values=kept)


def conjoin(a: Summary, b: Summary) -> Summary:
    """Meet of two summaries: over-approximates the intersection."""
    types = frozenset(a.types & b.types)
    s = Summary(
        types=types,
        num_lo=max(a.num_lo, b.num_lo),
        num_lo_excl=(a.num_lo_excl if a.num_lo >= b.num_lo else False)
        or (b.num_lo_excl if b.num_lo >= a.num_lo else False),
        num_hi=min(a.num_hi, b.num_hi),
        num_hi_excl=(a.num_hi_excl if a.num_hi <= b.num_hi else False)
        or (b.num_hi_excl if b.num_hi <= a.num_hi else False),
        str_min=max(a.str_min, b.str_min),
        str_max=min(a.str_max, b.str_max),
        arr_min=max(a.arr_min, b.arr_min),
        arr_max=min(a.arr_max, b.arr_max),
        obj_min=max(a.obj_min, b.obj_min),
        obj_max=min(a.obj_max, b.obj_max),
        required=a.required | b.required,
        closed=a.closed or b.closed,
        false_props=a.false_props | b.false_props,
    )
    if a.closed_props is not None and b.closed_props is not None:
        s = replace(s, closed_props=a.closed_props & b.closed_props)
    elif a.closed_props is not None or b.closed_props is not None:
        s = replace(s, closed_props=a.closed_props if a.closed_props is not None else b.closed_props)
    if a.values is not None:
        s = _meet_values(s, a.values)
    if b.values is not None:
        s = _meet_values(s, b.values)
    return s


def _int_interval_empty(s: Summary) -> bool:
    lo, hi = s.num_lo, s.num_hi
    if math.isfinite(lo):
        if s.num_lo_excl and float(lo).is_integer():
            lo += 1
        lo = math.ceil(lo)
    if math.isfinite(hi):
        if s.num_hi_excl and float(hi).is_integer():
            hi -= 1
        hi = math.floor(hi)
    return lo > hi


def _type_satisfiable(s: Summary, t: str) -> bool:
    if t in ("null", "boolean"):
        return True
    if t == "number":
        if s.num_lo > s.num_hi:
            return False
        if s.num_lo == s.num_hi and (s.num_lo_excl or s.num_hi_excl):
            return False
        return True
    if t == "integer":
        return _type_satisfiable(s, "number") and not _int_interval_empty(s)
    if t == "string":
        return s.str_min <= s.str_max
    if t == "array":
        return s.arr_min <= s.arr_max
    if t == "object":
        if s.obj_min > s.obj_max:
            return False
        if len(s.required) > s.obj_max:
            return False
        if s.required & s.false_props:
            return False
        if s.closed and s.closed_props is not None:
            if not s.required <= s.closed_props:
                return False
            usable = s.closed_props - s.false_props
            if len(usable) < s.obj_min:
                return False
        return True
    return True


def _value_type(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, int):
        return "integer"
    if isinstance(v, float):
        return "integer" if v.is_integer() else "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    return "object"


def _value_ok(s: Summary, v: Any) -> bool:
    """Does candidate value ``v`` pass every fact the summary tracks?"""
    t = _value_type(v)
    if t == "integer":
        if "integer" not in s.types and "number" not in s.types:
            return False
    elif t not in s.types:
        return False
    if t in ("integer", "number"):
        x = float(v)
        if x < s.num_lo or (x == s.num_lo and s.num_lo_excl):
            return False
        if x > s.num_hi or (x == s.num_hi and s.num_hi_excl):
            return False
    elif t == "string":
        if not (s.str_min <= len(v) <= s.str_max):
            return False
    elif t == "array":
        if not (s.arr_min <= len(v) <= s.arr_max):
            return False
    elif t == "object":
        if not (s.obj_min <= len(v) <= s.obj_max):
            return False
        if not s.required <= frozenset(v.keys()):
            return False
        if s.closed and s.closed_props is not None and not frozenset(v.keys()) <= s.closed_props:
            return False
        if frozenset(v.keys()) & s.false_props:
            return False
    return True


def is_empty(s: Summary) -> Optional[str]:
    """Return a human-readable proof tag when the summary admits no
    instance, else None.  Emptiness of the over-approximation proves
    the schema unsatisfiable."""
    if s.values is not None:
        if not s.values:
            return "empty enum/const intersection"
        if not any(_value_ok(s, v) for v in s.values):
            return "no enum/const candidate satisfies conjoined constraints"
        return None
    if not s.types:
        return "empty type intersection"
    for t in sorted(s.types):
        if _type_satisfiable(s, t):
            return None
    return "every admitted type has contradictory bounds"


def is_top(schema: Any) -> bool:
    """Syntactic proof that a schema accepts every instance."""
    if schema is True:
        return True
    if isinstance(schema, dict):
        return all(k in ANNOTATION_KEYS for k in schema)
    return False
