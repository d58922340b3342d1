"""Subsumption proofs between endpoint schema versions.

``compare(old, new)`` classifies a hot-swap candidate against the
serving version on the verdict lattice:

    equivalent   old and new accept exactly the same instances
    widened      every old-valid instance stays valid; new accepts more
    narrowed     every new-valid instance was old-valid; new accepts less
    incomparable each accepts instances the other rejects
    unknown      no proof either way

Proof machinery (refutational, after *JSON Schema Inclusion through
Refutational Normalization*): a structural prover (:func:`includes`)
establishes inclusions over the :mod:`.sat` summary domain, and a
witness probe sweep through :class:`NaiveValidator` *refutes*
inclusions.  A positive verdict (equivalent / widened / narrowed)
requires a structural proof in the claimed direction plus a
refutation of the opposite direction (or a canonical-hash match,
which proves equivalence outright).  Anything unproven stays
``unknown`` -- the registry treats unknown like an ordinary swap.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core.doc_model import json_equal
from ..core.interpreter import NaiveValidator
from .sat import Summary, is_top, summarize
from .structhash import structural_hash

__all__ = ["SubsumptionResult", "compare", "includes", "schema_probes"]

EQUIVALENT = "equivalent"
WIDENED = "widened"
NARROWED = "narrowed"
INCOMPARABLE = "incomparable"
UNKNOWN = "unknown"

_MAX_PROBES = 96
_STOCK_PROBES: Tuple[Any, ...] = (
    None,
    True,
    False,
    0,
    1,
    -1,
    3.5,
    "",
    "a",
    "payload",
    [],
    [1],
    ["a", "b"],
    {},
    {"a": 1},
)


@dataclass(frozen=True)
class SubsumptionResult:
    verdict: str
    # witness instances refuting an inclusion direction, for diagnostics
    witnesses: Tuple[Any, ...] = ()
    notes: Tuple[str, ...] = ()


def schema_probes(schema: Any, *, budget: int = _MAX_PROBES) -> List[Any]:
    """Deterministic witness candidates targeted at ``schema``'s
    decision boundaries: enum/const values, numeric bounds +/- 1,
    boundary-length strings/arrays, minimal required objects with and
    without each key, plus stock probes."""
    probes: List[Any] = []

    def add(p: Any) -> None:
        if len(probes) < budget and not any(json_equal(p, q) for q in probes):
            probes.append(p)

    def visit(node: Any, depth: int) -> None:
        if depth > 6 or not isinstance(node, dict) or len(probes) >= budget:
            return
        if "const" in node:
            add(node["const"])
        for v in node.get("enum", []) if isinstance(node.get("enum"), list) else []:
            add(v)
        if "default" in node:
            add(node["default"])
        for key in ("minimum", "maximum", "exclusiveMinimum", "exclusiveMaximum"):
            v = node.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v):
                add(v)
                add(v + 1)
                add(v - 1)
        for key in ("minLength", "maxLength"):
            v = node.get(key)
            if isinstance(v, int) and not isinstance(v, bool) and 0 <= v < 64:
                add("x" * v)
                add("x" * (v + 1))
                if v > 0:
                    add("x" * (v - 1))
        for key in ("minItems", "maxItems"):
            v = node.get(key)
            if isinstance(v, int) and not isinstance(v, bool) and 0 <= v < 16:
                add([0] * v)
                add([0] * (v + 1))
        req = node.get("required")
        props = node.get("properties") if isinstance(node.get("properties"), dict) else {}
        base: Dict[str, Any] = {}
        if isinstance(req, list) and all(isinstance(k, str) for k in req):
            for k in req:
                base[k] = _example_for(props.get(k, True))
            add(dict(base))
            add({**base, "__extra__": 1})
            for k in req:
                trimmed = {kk: vv for kk, vv in base.items() if kk != k}
                add(trimmed)
        if props:
            add({k: _example_for(sub) for k, sub in list(props.items())[:8]})
            # per-property boundary variants over the required base, so
            # widening/narrowing of a single property's bounds produces
            # a distinguishing object witness
            for k, sub in list(props.items())[:8]:
                for v in _boundary_values(sub):
                    add({**base, k: v})
        for sub in _child_schemas(node):
            visit(sub, depth + 1)

    visit(schema, 0)
    for p in _STOCK_PROBES:
        add(p)
    return probes


def _boundary_values(sub: Any) -> List[Any]:
    """Scalar candidates at ``sub``'s decision boundaries."""
    out: List[Any] = []
    if not isinstance(sub, dict):
        return out
    if "const" in sub:
        out.append(sub["const"])
    enum = sub.get("enum")
    if isinstance(enum, list):
        out.extend(enum[:6])
    for key in ("minimum", "maximum", "exclusiveMinimum", "exclusiveMaximum"):
        v = sub.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v):
            out.extend((v, v + 1, v - 1))
    for key in ("minLength", "maxLength"):
        v = sub.get(key)
        if isinstance(v, int) and not isinstance(v, bool) and 0 <= v < 64:
            out.extend(("x" * v, "x" * (v + 1)))
            if v > 0:
                out.append("x" * (v - 1))
    for member in sub.get("allOf", []) if isinstance(sub.get("allOf"), list) else []:
        out.extend(_boundary_values(member))
    return out[:24]


def _example_for(sub: Any) -> Any:
    """A cheap instance likely (not guaranteed) to satisfy ``sub``."""
    if not isinstance(sub, dict):
        return 1
    if "const" in sub:
        return sub["const"]
    enum = sub.get("enum")
    if isinstance(enum, list) and enum:
        return enum[0]
    if "default" in sub:
        return sub["default"]
    t = sub.get("type")
    if isinstance(t, list) and t:
        t = t[0]
    lo = sub.get("minimum", sub.get("exclusiveMinimum"))
    if t in ("number", "integer"):
        if isinstance(lo, (int, float)) and not isinstance(lo, bool):
            return int(lo) + 1
        return 1
    if t == "string":
        n = sub.get("minLength")
        return "x" * n if isinstance(n, int) and not isinstance(n, bool) else "x"
    if t == "array":
        return []
    if t == "object":
        req = sub.get("required")
        props = sub.get("properties") if isinstance(sub.get("properties"), dict) else {}
        if isinstance(req, list):
            return {k: _example_for(props.get(k, True)) for k in req if isinstance(k, str)}
        return {}
    if t == "boolean":
        return True
    if t == "null":
        return None
    return 1


def _child_schemas(node: Dict[str, Any]) -> List[Any]:
    out: List[Any] = []
    for kw in ("allOf", "anyOf", "oneOf", "prefixItems"):
        subs = node.get(kw)
        if isinstance(subs, list):
            out.extend(subs)
    for kw in ("items", "not", "if", "then", "else", "contains", "additionalProperties"):
        if isinstance(node.get(kw), (dict, bool)):
            out.append(node[kw])
    for kw in ("properties", "patternProperties", "dependentSchemas", "$defs", "definitions"):
        subs = node.get(kw)
        if isinstance(subs, dict):
            out.extend(subs.values())
    return out


# ---------------------------------------------------------------------------
# Structural inclusion prover
# ---------------------------------------------------------------------------

# Keywords the structural prover models; a schema using anything else
# is opaque and the prover answers None (unknown) unless the opaque
# side is the *sub* side of a TOP super-schema.
_MODELED = frozenset(
    {
        "type",
        "enum",
        "const",
        "minimum",
        "maximum",
        "exclusiveMinimum",
        "exclusiveMaximum",
        "minLength",
        "maxLength",
        "minItems",
        "maxItems",
        "minProperties",
        "maxProperties",
        "required",
        "properties",
        "additionalProperties",
        "allOf",
    }
)

from .sat import ANNOTATION_KEYS  # noqa: E402  (shared annotation key set)


def _fully_modeled(schema: Any, depth: int = 0) -> bool:
    """True when the structural prover models every constraining
    keyword in ``schema`` (so summarize() + per-key recursion capture
    its semantics *exactly*)."""
    if isinstance(schema, bool):
        return True
    if not isinstance(schema, dict) or depth > 8:
        return False
    for k, v in schema.items():
        if k in ANNOTATION_KEYS:
            continue
        if k not in _MODELED:
            return False
        if k == "properties":
            if not isinstance(v, dict) or not all(_fully_modeled(sub, depth + 1) for sub in v.values()):
                return False
        elif k == "additionalProperties":
            # schema-valued AP is not captured by the summary domain
            if not isinstance(v, bool):
                return False
        elif k == "allOf":
            if not isinstance(v, list) or not all(_fully_modeled(sub, depth + 1) for sub in v):
                return False
    return True


def includes(sup: Any, sub: Any, depth: int = 0) -> Optional[bool]:
    """Structural proof that every ``sub``-valid instance is
    ``sup``-valid.  True = proven, False = refuted by the decidable
    enum-enumeration case, None = unknown.

    Soundness: ``summarize(sub)`` *over*-approximates sub, so showing
    the summary's instance set sits inside sup's exact semantics
    (available because sup is ``_fully_modeled``) proves inclusion.
    """
    if depth > 8:
        return None
    if is_top(sup):
        return True
    if sub is False:
        return True
    if sup is False:
        return None  # sub could itself be empty; leave to witnesses
    if not _fully_modeled(sup):
        return None

    a = summarize(sub)  # over-approximation of sub's valid set
    b = summarize(sup)

    # Decidable finite case: sub is an enum/const -- enumerate.
    if a.values is not None:
        try:
            nv_sub = NaiveValidator(sub)
            nv_sup = NaiveValidator(sup)
            live = [v for v in a.values if nv_sub.is_valid(v)]
            return all(nv_sup.is_valid(v) for v in live)
        except Exception:
            return None

    # sup constrains to a finite value set but sub is not finite:
    # no containment proof possible from the summary domain.
    if b.values is not None:
        return None

    if not a.types <= b.types:
        return None
    if _types_touch(a, ("number", "integer")):
        if a.num_lo < b.num_lo or (a.num_lo == b.num_lo and b.num_lo_excl and not a.num_lo_excl):
            return None
        if a.num_hi > b.num_hi or (a.num_hi == b.num_hi and b.num_hi_excl and not a.num_hi_excl):
            return None
    if _types_touch(a, ("string",)) and (a.str_min < b.str_min or a.str_max > b.str_max):
        return None
    if _types_touch(a, ("array",)) and (a.arr_min < b.arr_min or a.arr_max > b.arr_max):
        return None
    if _types_touch(a, ("object",)):
        if a.obj_min < b.obj_min or a.obj_max > b.obj_max:
            return None
        if not b.required <= a.required:
            return None
        if b.closed:
            if not a.closed or a.closed_props is None or b.closed_props is None:
                return None
            if not a.closed_props <= b.closed_props:
                return None
        # per-key: sup's property schemas must admit whatever sub can
        # put at each key sup constrains
        sup_props = _props_of(sup)
        sub_props = _props_of(sub)
        for key, sup_sub in sup_props.items():
            if is_top(sup_sub):
                continue
            if a.closed and a.closed_props is not None and key not in a.closed_props:
                continue  # sub never materializes `key`
            if key in sub_props:
                if includes(sup_sub, sub_props[key], depth + 1) is not True:
                    return None
            else:
                # sub leaves the value unconstrained; sup_sub is not TOP
                return None
    return True


def _types_touch(s: Summary, kinds: Tuple[str, ...]) -> bool:
    return any(k in s.types for k in kinds)


def _props_of(schema: Any) -> Dict[str, Any]:
    """Effective per-key property schemas, folding nested allOf."""
    if not isinstance(schema, dict):
        return {}
    out: Dict[str, Any] = {}

    def fold(node: Any) -> None:
        if not isinstance(node, dict):
            return
        props = node.get("properties")
        if isinstance(props, dict):
            for k, v in props.items():
                out[k] = {"allOf": [out[k], v]} if k in out else v
        members = node.get("allOf")
        if isinstance(members, list):
            for m in members:
                fold(m)

    fold(schema)
    return out


# ---------------------------------------------------------------------------
# Verdict assembly
# ---------------------------------------------------------------------------


def compare(
    old: Any,
    new: Any,
    *,
    old_hash: Optional[str] = None,
    new_hash: Optional[str] = None,
) -> SubsumptionResult:
    """Classify ``new`` against serving ``old`` on the verdict lattice."""
    oh = old_hash or structural_hash(old)
    nh = new_hash or structural_hash(new)
    if oh == nh:
        return SubsumptionResult(EQUIVALENT, notes=("canonical-hash match",))

    try:
        nv_old = NaiveValidator(old)
        nv_new = NaiveValidator(new)
    except Exception as exc:  # pragma: no cover - defensive
        return SubsumptionResult(UNKNOWN, notes=(f"oracle construction failed: {exc}",))

    # Witness sweep: probe both oracles on boundary instances of both
    # schemas; disagreements refute one inclusion direction each.
    new_not_old: List[Any] = []  # refutes new <= old (widening witnesses)
    old_not_new: List[Any] = []  # refutes old <= new (narrowing witnesses)
    for probe in schema_probes(old) + schema_probes(new):
        try:
            vo = nv_old.is_valid(probe)
            vn = nv_new.is_valid(probe)
        except Exception:
            continue
        if vn and not vo and len(new_not_old) < 4:
            new_not_old.append(probe)
        if vo and not vn and len(old_not_new) < 4:
            old_not_new.append(probe)

    if new_not_old and old_not_new:
        return SubsumptionResult(
            INCOMPARABLE,
            witnesses=tuple(new_not_old[:2] + old_not_new[:2]),
            notes=("witnesses refute both inclusion directions",),
        )

    old_in_new = includes(new, old)  # old <= new
    new_in_old = includes(old, new)  # new <= old
    if new_not_old:
        new_in_old = False
    if old_not_new:
        old_in_new = False

    if old_in_new is True and new_in_old is True:
        return SubsumptionResult(EQUIVALENT, notes=("structural inclusion both directions",))
    if old_in_new is True and new_in_old is False:
        return SubsumptionResult(
            WIDENED,
            witnesses=tuple(new_not_old[:4]),
            notes=("old included in new; reverse refuted",),
        )
    if new_in_old is True and old_in_new is False:
        return SubsumptionResult(
            NARROWED,
            witnesses=tuple(old_not_new[:4]),
            notes=("new included in old; reverse refuted",),
        )
    return SubsumptionResult(UNKNOWN)
