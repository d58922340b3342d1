"""Canonicalizer / normalizer / pruner pass pipeline (DESIGN.md §15).

``analyze_schema`` rewrites a schema toward a canonical form:

1.  **Constant folding** -- enum/const/type intersections, dedup and
    sorting of ``enum``/``required``/``type`` lists, singleton-enum ->
    ``const``, no-op removal (``minLength: 0`` etc.);
2.  **Bound tightening** -- redundant ``minimum`` vs numeric
    ``exclusiveMinimum`` (and the max side) collapse to the tighter;
3.  **allOf flattening + hoisting** -- nested allOf splice, and
    conjunctive keys hoisted/merged into the parent when their
    semantics are provably local (no interaction partner present);
4.  **Satisfiability pruning** -- subschemas proven unsatisfiable by
    the :mod:`.sat` over-approximation become ``false``; false
    branches drop out of ``anyOf``/``oneOf``; constant conditionals
    fold; ``not: false`` disappears.

Soundness contract: every rewrite fires only on a *proof* (the
keyword-local legality conditions in this file); anything unproven is
left alone.  Annotation-affecting removals (dropping an applicator
that could contribute evaluated-property/item annotations) are
additionally gated on the schema containing no ``unevaluated*``
keyword anywhere.  As a belt over the braces, the rewritten schema is
differentially probed against :class:`NaiveValidator` on boundary
instances; any disagreement reverts the whole rewrite and reports the
failure instead of serving it.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core.doc_model import json_equal
from ..core.interpreter import NaiveValidator
from .sat import ANNOTATION_KEYS, _value_ok, conjoin, is_empty, is_top, summarize
from .structhash import canonical_json, structural_hash, subschema_hashes
from .subsume import schema_probes

__all__ = ["AnalysisReport", "analyze_schema"]

_MAX_REASONS = 32

# Keywords whose presence anywhere makes rewriting unsafe: resolution
# is dynamic-scope dependent, so structural rewrites could change
# which schema a reference lands on.
_DYNAMIC_KEYS = ("$dynamicRef", "$dynamicAnchor", "$recursiveRef", "$recursiveAnchor")

# Conjunctive keys safe to hoist from an allOf member into the parent
# when the parent does not already carry them: their semantics never
# depend on sibling keywords.
_HOISTABLE = frozenset(
    {
        "type",
        "enum",
        "const",
        "minimum",
        "maximum",
        "exclusiveMinimum",
        "exclusiveMaximum",
        "multipleOf",
        "minLength",
        "maxLength",
        "pattern",
        "minItems",
        "maxItems",
        "uniqueItems",
        "minProperties",
        "maxProperties",
        "required",
    }
)

# Keys that make an allOf member opaque to hoisting/merging entirely.
_OPAQUE_MEMBER_KEYS = frozenset(
    {"$ref", "$id", "id", "$anchor", "$defs", "definitions"} | set(_DYNAMIC_KEYS)
)

# `properties` interacts with these at the same node; hoisting
# properties across nodes is only legal when neither side has any.
_PROPERTIES_PARTNERS = frozenset(
    {"additionalProperties", "patternProperties", "unevaluatedProperties", "propertyNames"}
)


# Sentinels for _merge_conjunct: keep both copies / proven contradiction.
_KEEP = object()
_CONTRADICTION = object()

_MIN_LIKE = ("minimum", "minLength", "minItems", "minProperties")
_MAX_LIKE = ("maximum", "maxLength", "maxItems", "maxProperties")


def _num(v: Any) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return v


def _intersect_types(a: Any, b: Any) -> Any:
    def expand(t: Any) -> Optional[frozenset]:
        items = [t] if isinstance(t, str) else t
        if not isinstance(items, list) or not all(isinstance(x, str) for x in items):
            return None
        s = frozenset(items)
        return s | {"integer"} if "number" in s else s

    ea, eb = expand(a), expand(b)
    if ea is None or eb is None:
        return _KEEP
    inter = ea & eb
    if not inter:
        return _CONTRADICTION
    if "number" in inter:
        inter = inter - {"integer"}
    out = sorted(inter)
    return out[0] if len(out) == 1 else out


def _merge_conjunct(key: str, a: Any, b: Any) -> Any:
    """Merge two copies of a conjunctive keyword.  Returns the merged
    value, ``_KEEP`` (cannot merge; keep both), or ``_CONTRADICTION``
    (provably empty intersection)."""
    if json_equal(a, b):
        return a
    if key == "type":
        return _intersect_types(a, b)
    if key == "required":
        if isinstance(a, list) and isinstance(b, list):
            return sorted(set(a) | set(b))
        return _KEEP
    if key == "enum":
        if isinstance(a, list) and isinstance(b, list):
            inter = [v for v in a if any(json_equal(v, w) for w in b)]
            return inter if inter else _CONTRADICTION
        return _KEEP
    if key == "const":
        return a if json_equal(a, b) else _CONTRADICTION
    if key in _MIN_LIKE:
        na, nb = _num(a), _num(b)
        return max(na, nb) if na is not None and nb is not None else _KEEP
    if key in _MAX_LIKE:
        na, nb = _num(a), _num(b)
        return min(na, nb) if na is not None and nb is not None else _KEEP
    if key == "exclusiveMinimum":
        na, nb = _num(a), _num(b)
        return max(na, nb) if na is not None and nb is not None else _KEEP
    if key == "exclusiveMaximum":
        na, nb = _num(a), _num(b)
        return min(na, nb) if na is not None and nb is not None else _KEEP
    if key == "uniqueItems":
        if isinstance(a, bool) and isinstance(b, bool):
            return a or b
    return _KEEP


@dataclass
class AnalysisReport:
    """Outcome of the register()-time analysis pipeline for one schema."""

    normalized: Any
    canonical_hash: str
    pruned_branches: int = 0
    folded_assertions: int = 0
    flattened_allof: int = 0
    removed_noops: int = 0
    tightened_bounds: int = 0
    dedup_subgraphs: int = 0  # filled in by the registry across members
    changed: bool = False
    verified: bool = False
    failure: Optional[str] = None
    seconds: float = 0.0
    reasons: List[str] = field(default_factory=list)
    subgraph_hashes: Dict[str, List[str]] = field(default_factory=dict)

    def note(self, reason: str) -> None:
        if len(self.reasons) < _MAX_REASONS:
            self.reasons.append(reason)

    def counters(self) -> Dict[str, int]:
        return {
            "pruned_branches": self.pruned_branches,
            "folded_assertions": self.folded_assertions,
            "flattened_allof": self.flattened_allof,
            "removed_noops": self.removed_noops,
            "tightened_bounds": self.tightened_bounds,
            "dedup_subgraphs": self.dedup_subgraphs,
        }


def _contains_key(schema: Any, keys: Tuple[str, ...]) -> bool:
    if isinstance(schema, dict):
        if any(k in schema for k in keys):
            return True
        return any(_contains_key(v, keys) for v in schema.values())
    if isinstance(schema, list):
        return any(_contains_key(v, keys) for v in schema)
    return False


def _pointer_refs_fragile(schema: Any) -> bool:
    """True when any ``$ref`` uses a JSON pointer deeper than
    ``#/$defs/<name>`` -- structural rewrites could break the path."""

    def visit(node: Any) -> bool:
        if isinstance(node, dict):
            ref = node.get("$ref")
            if isinstance(ref, str) and "#/" in ref:
                frag = ref.split("#", 1)[1]
                parts = [p for p in frag.split("/") if p]
                if len(parts) > 2 or (parts and parts[0] not in ("$defs", "definitions")):
                    return True
            return any(visit(v) for v in node.values())
        if isinstance(node, list):
            return any(visit(v) for v in node)
        return False

    return visit(schema)


def analyze_schema(schema: Any, *, verify: bool = True) -> AnalysisReport:
    """Run the full pass pipeline; never raises on malformed input --
    any internal failure reverts to the original schema."""
    t0 = time.perf_counter()
    rpt = AnalysisReport(normalized=schema, canonical_hash=structural_hash(schema))
    if isinstance(schema, bool):
        rpt.verified = True
        rpt.seconds = time.perf_counter() - t0
        return rpt
    if not isinstance(schema, dict):
        rpt.failure = "not a schema object"
        rpt.seconds = time.perf_counter() - t0
        return rpt
    if _contains_key(schema, _DYNAMIC_KEYS):
        rpt.note("skipped: dynamic-scope references present")
        rpt.verified = True
        rpt.seconds = time.perf_counter() - t0
        rpt.subgraph_hashes = subschema_hashes(schema)
        return rpt
    if _pointer_refs_fragile(schema):
        rpt.note("skipped: JSON-pointer $ref into schema structure")
        rpt.verified = True
        rpt.seconds = time.perf_counter() - t0
        rpt.subgraph_hashes = subschema_hashes(schema)
        return rpt

    # Annotation guard: `unevaluated*` observes which in-place
    # applicators *ran*, so removing always-true applicators is only
    # legal when no unevaluated keyword exists anywhere in the root.
    annotation_safe = not _contains_key(schema, ("unevaluatedProperties", "unevaluatedItems"))

    try:
        work = copy.deepcopy(schema)
        rewritten = _Rewriter(rpt, annotation_safe).rewrite(work)
    except Exception as exc:  # proof engine bug: keep the original
        rpt.failure = f"rewrite error: {type(exc).__name__}: {exc}"
        _revert(rpt)
        rpt.seconds = time.perf_counter() - t0
        rpt.subgraph_hashes = subschema_hashes(schema)
        return rpt

    changed = canonical_json(rewritten) != canonical_json(schema)
    if changed and verify:
        mismatch = _differential_check(schema, rewritten)
        if mismatch is not None:
            rpt.failure = f"differential mismatch on probe {mismatch!r}; rewrite reverted"
            _revert(rpt)
            rpt.seconds = time.perf_counter() - t0
            rpt.subgraph_hashes = subschema_hashes(schema)
            return rpt
    rpt.normalized = rewritten
    rpt.changed = changed
    rpt.verified = True
    rpt.canonical_hash = structural_hash(rewritten)
    rpt.subgraph_hashes = subschema_hashes(rewritten)
    rpt.seconds = time.perf_counter() - t0
    return rpt


def _revert(rpt: AnalysisReport) -> None:
    """Zero the rewrite counters after a revert: the served schema is
    the original, so no rewrite actually took effect."""
    rpt.pruned_branches = 0
    rpt.folded_assertions = 0
    rpt.flattened_allof = 0
    rpt.removed_noops = 0
    rpt.tightened_bounds = 0


def _differential_check(original: Any, rewritten: Any) -> Optional[Any]:
    """Probe both schemas; return the first disagreeing instance."""
    try:
        nv_a = NaiveValidator(original)
        nv_b = NaiveValidator(rewritten)
    except Exception:
        return "<oracle construction failed>"
    for probe in schema_probes(original):
        try:
            va = nv_a.is_valid(probe)
        except Exception:
            continue
        try:
            vb = nv_b.is_valid(probe)
        except Exception:
            return probe
        if va != vb:
            return probe
    return None


class _Rewriter:
    def __init__(self, rpt: AnalysisReport, annotation_safe: bool):
        self.rpt = rpt
        self.annotation_safe = annotation_safe

    # -- recursion over schema positions --------------------------------

    _SINGLE = (
        "additionalProperties",
        "unevaluatedProperties",
        "unevaluatedItems",
        "additionalItems",
        "contains",
        "propertyNames",
        "not",
        "if",
        "then",
        "else",
    )
    _LISTS = ("allOf", "anyOf", "oneOf", "prefixItems")
    _MAPS = ("properties", "patternProperties", "dependentSchemas", "$defs", "definitions")

    def rewrite(self, node: Any, depth: int = 0) -> Any:
        if not isinstance(node, dict) or depth > 32:
            return node

        for kw in self._SINGLE:
            if kw in node:
                node[kw] = self.rewrite(node[kw], depth + 1)
        items = node.get("items")
        if isinstance(items, list):
            node["items"] = [self.rewrite(s, depth + 1) for s in items]
        elif "items" in node:
            node["items"] = self.rewrite(items, depth + 1)
        for kw in self._LISTS:
            subs = node.get(kw)
            if isinstance(subs, list):
                node[kw] = [self.rewrite(s, depth + 1) for s in subs]
        for kw in self._MAPS:
            subs = node.get(kw)
            if isinstance(subs, dict):
                node[kw] = {k: self.rewrite(s, depth + 1) for k, s in subs.items()}

        node = self._fold_allof(node)
        if not isinstance(node, dict):
            return node
        node = self._fold_constants(node)
        if not isinstance(node, dict):
            return node
        node = self._tighten_bounds(node)
        node = self._drop_noops(node)
        node = self._fold_branches(node)
        if not isinstance(node, dict):
            return node
        node = self._prove_empty(node)
        if isinstance(node, dict):
            node = {k: node[k] for k in sorted(node)}
        return node

    # -- allOf flatten / hoist ------------------------------------------

    def _fold_allof(self, node: Dict[str, Any]) -> Any:
        members = node.get("allOf")
        if not isinstance(members, list):
            return node

        # splice nested pure-allOf members
        flat: List[Any] = []
        for m in members:
            if isinstance(m, dict) and set(m) == {"allOf"} and isinstance(m["allOf"], list):
                flat.extend(m["allOf"])
                self.rpt.flattened_allof += 1
                self.rpt.note("allOf: spliced nested allOf")
            else:
                flat.append(m)

        kept: List[Any] = []
        for m in flat:
            if m is False:
                self.rpt.note("allOf: false member collapses node")
                return False
            if is_top(m):
                # a TOP member asserts nothing and (being empty of
                # applicators) contributes no annotations
                self.rpt.removed_noops += 1
                self.rpt.note("allOf: dropped always-true member")
                continue
            if isinstance(m, dict) and not (set(m) & _OPAQUE_MEMBER_KEYS):
                m = self._hoist_member(node, m)
                if m is False:
                    return False
                if m is None:
                    continue
            kept.append(m)

        if kept:
            node["allOf"] = kept
        else:
            node.pop("allOf", None)
            self.rpt.note("allOf: emptied after folding")
        return node

    def _hoist_member(self, parent: Dict[str, Any], member: Dict[str, Any]) -> Any:
        """Move provably-local conjunctive keys from an allOf member
        into the parent.  Returns the reduced member, None when fully
        absorbed, or False when a contradiction is proven."""
        residue: Dict[str, Any] = {}
        for key, val in member.items():
            if key in ANNOTATION_KEYS:
                continue  # annotations on an allOf member are inert
            if key in _HOISTABLE:
                if key not in parent:
                    parent[key] = val
                    self.rpt.folded_assertions += 1
                    continue
                merged = _merge_conjunct(key, parent[key], val)
                if merged is _CONTRADICTION:
                    self.rpt.note(f"allOf: contradictory `{key}` intersection")
                    return False
                if merged is not _KEEP:
                    parent[key] = merged
                    self.rpt.folded_assertions += 1
                    continue
                residue[key] = val
            elif key == "properties" and isinstance(val, dict):
                if (set(parent) | set(member)) & _PROPERTIES_PARTNERS:
                    residue[key] = val
                    continue
                target = parent.setdefault("properties", {})
                if not isinstance(target, dict):
                    residue[key] = val
                    continue
                for pk, pv in val.items():
                    if pk in target:
                        if json_equal(target[pk], pv):
                            self.rpt.folded_assertions += 1
                        else:
                            target[pk] = self.rewrite({"allOf": [target[pk], pv]})
                    else:
                        target[pk] = pv
                        self.rpt.folded_assertions += 1
            else:
                residue[key] = val
        if residue:
            return residue
        self.rpt.note("allOf: member fully hoisted into parent")
        return None

    # -- constant folding ------------------------------------------------

    def _fold_constants(self, node: Dict[str, Any]) -> Any:
        t = node.get("type")
        if isinstance(t, list):
            seen: List[str] = []
            for x in t:
                if isinstance(x, str) and x not in seen:
                    seen.append(x)
            if "number" in seen and "integer" in seen:
                seen.remove("integer")
                self.rpt.folded_assertions += 1
                self.rpt.note("type: integer subsumed by number")
            if len(seen) != len(t):
                self.rpt.folded_assertions += 1
            seen.sort()
            node["type"] = seen[0] if len(seen) == 1 else seen
            if not seen:
                self.rpt.note("type: empty type list")
                return False

        enum = node.get("enum")
        if isinstance(enum, list):
            sibling = summarize({k: v for k, v in node.items() if k not in ("enum", "const")})
            kept: List[Any] = []
            for v in enum:
                if any(json_equal(v, w) for w in kept):
                    self.rpt.folded_assertions += 1
                    continue
                if not _value_ok(sibling, v):
                    self.rpt.folded_assertions += 1
                    self.rpt.note("enum: dropped candidate violating sibling constraints")
                    continue
                kept.append(v)
            if not kept:
                self.rpt.note("enum: no satisfiable candidate")
                return False
            kept.sort(key=canonical_json)
            if "const" not in node and len(kept) == 1:
                node.pop("enum")
                node["const"] = kept[0]
                self.rpt.folded_assertions += 1
                self.rpt.note("enum: singleton folded to const")
            else:
                node["enum"] = kept

        if "const" in node:
            sibling = summarize({k: v for k, v in node.items() if k not in ("enum", "const")})
            if not _value_ok(sibling, node["const"]):
                self.rpt.note("const: violates sibling constraints")
                return False
            enum = node.get("enum")
            if isinstance(enum, list):
                if any(json_equal(node["const"], v) for v in enum):
                    node.pop("enum")
                    self.rpt.folded_assertions += 1
                else:
                    self.rpt.note("const: not a member of sibling enum")
                    return False

        req = node.get("required")
        if isinstance(req, list) and all(isinstance(k, str) for k in req):
            uniq = sorted(set(req))
            if uniq != req:
                node["required"] = uniq
                self.rpt.folded_assertions += 1
        return node

    # -- bound tightening ------------------------------------------------

    def _tighten_bounds(self, node: Dict[str, Any]) -> Dict[str, Any]:
        for lo_key, xlo_key, pick_hi in (
            ("minimum", "exclusiveMinimum", True),
            ("maximum", "exclusiveMaximum", False),
        ):
            lo, xlo = node.get(lo_key), node.get(xlo_key)
            if isinstance(xlo, bool):
                continue  # draft-04 boolean form modifies minimum/maximum
            if not isinstance(lo, (int, float)) or isinstance(lo, bool):
                continue
            if not isinstance(xlo, (int, float)):
                continue
            if pick_hi:
                # x > xlo implies x >= lo when xlo >= lo
                drop = lo_key if xlo >= lo else xlo_key
            else:
                drop = lo_key if xlo <= lo else xlo_key
            node.pop(drop)
            self.rpt.tightened_bounds += 1
            self.rpt.note(f"bounds: `{drop}` subsumed by sibling bound")
        return node

    # -- no-op removal ---------------------------------------------------

    def _drop_noops(self, node: Dict[str, Any]) -> Dict[str, Any]:
        for key, noop in (
            ("minLength", 0),
            ("minItems", 0),
            ("minProperties", 0),
            ("uniqueItems", False),
            ("required", []),
        ):
            if key in node and node[key] == noop and isinstance(node[key], type(noop)):
                node.pop(key)
                self.rpt.removed_noops += 1
                self.rpt.note(f"noop: removed `{key}: {noop!r}`")
        for key in ("dependentRequired", "dependentSchemas", "patternProperties"):
            if key in node and node[key] == {}:
                node.pop(key)
                self.rpt.removed_noops += 1
        if node.get("additionalProperties") is True and self.annotation_safe:
            # AP:true evaluates every property (annotation-relevant);
            # removable only with no unevaluated* observer anywhere
            node.pop("additionalProperties")
            self.rpt.removed_noops += 1
        # `then`/`else` are inert without `if`
        if "if" not in node:
            for key in ("then", "else"):
                if key in node:
                    node.pop(key)
                    self.rpt.removed_noops += 1
                    self.rpt.note(f"noop: `{key}` without `if`")
        return node

    # -- branch pruning / conditional folding ----------------------------

    def _fold_branches(self, node: Dict[str, Any]) -> Any:
        parent_summary = summarize({k: v for k, v in node.items() if k not in ("anyOf", "oneOf")})

        for kw in ("anyOf", "oneOf"):
            branches = node.get(kw)
            if not isinstance(branches, list) or not branches:
                continue
            kept: List[Any] = []
            for br in branches:
                if br is False:
                    # a false branch never validates and contributes no
                    # annotations: dropping it is unconditionally sound
                    self.rpt.pruned_branches += 1
                    self.rpt.note(f"{kw}: dropped false branch")
                    continue
                if isinstance(br, dict):
                    reason = is_empty(summarize(br))
                    if reason is None:
                        # context-sensitive: branch conjoined with the
                        # node's own assertions
                        reason = is_empty(conjoin(parent_summary, summarize(br)))
                        if reason is not None:
                            reason = f"under node constraints: {reason}"
                    if reason is not None:
                        self.rpt.pruned_branches += 1
                        self.rpt.note(f"{kw}: pruned branch ({reason})")
                        continue
                kept.append(br)
            if not kept:
                self.rpt.note(f"{kw}: all branches unsatisfiable")
                return False
            if len(kept) == 1:
                # anyOf/oneOf of one branch == the branch applied
                # in-place (annotations identical: the branch still
                # runs as an in-place applicator)
                node.pop(kw)
                node.setdefault("allOf", []).append(kept[0])
                self.rpt.folded_assertions += 1
                self.rpt.note(f"{kw}: singleton folded into allOf")
                node = self._fold_allof(node)
                if not isinstance(node, dict):
                    return node
            else:
                if self.annotation_safe and kw == "anyOf" and any(is_top(br) for br in kept):
                    # always-satisfied anyOf; removable only when no
                    # unevaluated* keyword can observe the other
                    # branches' annotations
                    node.pop(kw)
                    self.rpt.removed_noops += 1
                    self.rpt.note("anyOf: always-true branch, applicator removed")
                else:
                    node[kw] = kept

        # not
        inner = node.get("not")
        if "not" in node:
            if inner is False or (isinstance(inner, dict) and is_empty(summarize(inner)) is not None):
                # `not <empty>` always passes; `not` contributes no annotations
                node.pop("not")
                self.rpt.removed_noops += 1
                self.rpt.note("not: inner schema unsatisfiable, keyword removed")
            elif is_top(inner):
                self.rpt.note("not: inner schema always true")
                return False

        # if/then/else constant folding
        cond = node.get("if")
        if "if" in node:
            if cond is False:
                # `if` fails: its annotations drop, `else` applies
                els = node.pop("else", None)
                node.pop("if")
                node.pop("then", None)
                if els is not None and not is_top(els):
                    if els is False:
                        self.rpt.note("if: false condition with false else")
                        return False
                    node.setdefault("allOf", []).append(els)
                self.rpt.folded_assertions += 1
                self.rpt.note("if: constant-false condition folded to else")
                node = self._fold_allof(node)
                if not isinstance(node, dict):
                    return node
            elif is_top(cond):
                # `if` passes vacuously (TOP carries no applicators,
                # so no annotations are lost); `then` applies
                then = node.pop("then", None)
                node.pop("if")
                node.pop("else", None)
                if then is not None and not is_top(then):
                    if then is False:
                        self.rpt.note("if: true condition with false then")
                        return False
                    node.setdefault("allOf", []).append(then)
                self.rpt.folded_assertions += 1
                self.rpt.note("if: constant-true condition folded to then")
                node = self._fold_allof(node)
                if not isinstance(node, dict):
                    return node
        return node

    # -- whole-node emptiness -------------------------------------------

    def _prove_empty(self, node: Dict[str, Any]) -> Any:
        reason = is_empty(summarize(node))
        if reason is not None:
            self.rpt.pruned_branches += 1
            self.rpt.note(f"node proven unsatisfiable: {reason}")
            return False
        return node
