"""JSON Schema -> validation-DSL compiler (Blaze §3, optimizations §4).

The compiler walks a schema once per reachable subschema and emits
instruction sequences.  Keywords are handled by tier:

* **independent** keywords (assertions + independent applicators, §3.1)
  compile in isolation and are then *reordered* cheapest-first (§4.4 -- the
  fail-fast ordering);
* **first-level dependent** keywords (``additionalProperties``, ``items``)
  have their dependencies on adjacent keywords resolved *statically* so the
  emitted instructions are again order-free (§3.2.1);
* **second-level dependent** keywords (``unevaluatedProperties`` /
  ``unevaluatedItems``) get a static coverage analysis that eliminates the
  annotation machinery whenever the evaluated set is statically determined
  (§3.2.2); only genuinely branch-dependent schemas keep a dynamic residue
  instruction, and those are pinned to the end of the sequence.

Optimizations implemented with the paper's exact heuristics:

* unrolling: properties unroll when <=5 properties or >=1/4 required, and
  always directly under ``oneOf``/``anyOf`` (§4.2);
* reference inlining: non-recursive ``$ref`` destinations used <=5 times are
  inlined, others get ControlLabel/ControlJump (§3.3/§4.2);
* regex specialization (§4.3, see regex_opt.py);
* instruction reordering by static cost (§4.4);
* CISC fusion: StringBounds/NumberBounds/ArrayBounds, singleton
  Equals/Type/Defines, ``When*`` condition variants (§2.5, Table 2);
* static elision of assertions made redundant by ``type`` (§3.1.1) and of
  no-op applicators (``contains`` with ``minContains: 0``, boolean
  ``additionalProperties: true``, ...).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .hashing import shash
from .instructions import (
    ArrayPrefix,
    AssertionArrayBounds,
    AssertionArraySizeGreater,
    AssertionArraySizeLess,
    AssertionDefines,
    AssertionDefinesAll,
    AssertionDivisible,
    AssertionEqual,
    AssertionEqualsAny,
    AssertionFail,
    AssertionGreater,
    AssertionGreaterEqual,
    AssertionLess,
    AssertionLessEqual,
    AssertionNumberBounds,
    AssertionObjectSizeGreater,
    AssertionObjectSizeLess,
    AssertionPropertyDependencies,
    AssertionPropertyType,
    AssertionRegex,
    AssertionStringBounds,
    AssertionStringSizeGreater,
    AssertionStringSizeLess,
    AssertionStringType,
    AssertionType,
    AssertionTypeAny,
    AssertionUnique,
    ControlJump,
    ControlLabel,
    Instruction,
    Instructions,
    LogicalAnd,
    LogicalCondition,
    LogicalNot,
    LogicalOr,
    LogicalXor,
    LoopContains,
    LoopItems,
    LoopItemsFrom,
    LoopKeys,
    LoopProperties,
    LoopPropertiesExcept,
    LoopPropertiesMatch,
    LoopPropertiesMatchClosed,
    LoopPropertiesRegex,
    LoopUnevaluatedItems,
    LoopUnevaluatedProperties,
    WhenArraySizeEqual,
    WhenArraySizeGreater,
    WhenDefines,
    WhenType,
)
from .json_pointer import InstancePath, escape
from .regex_opt import RegexKind, RegexPlan, analyze_pattern
from .schema_resolver import Dialect, SchemaResolver

__all__ = ["CompilerOptions", "CompiledSchema", "compile_schema", "SchemaCompileError"]


class SchemaCompileError(ValueError):
    pass


@dataclass(frozen=True)
class CompilerOptions:
    """Optimization switches (all on by default; the ablation benchmark of
    §6.2.3 turns them off one at a time)."""

    unroll: bool = True
    regex_specialize: bool = True
    reorder: bool = True
    cisc: bool = True
    elide: bool = True
    inline_ref_limit: int = 5
    unroll_property_limit: int = 5
    unroll_required_fraction: float = 0.25
    format_assertion: bool = False


@dataclass
class CompiledSchema:
    """The compilation artifact: a flat instruction sequence + label table."""

    instructions: Instructions
    labels: Dict[int, Instructions]
    options: CompilerOptions
    dialect: Dialect
    source: Any = None
    # label id -> resolved $ref key, for diagnostics (tape unrolling
    # reports and fallback reasons name the offending definition)
    label_names: Dict[int, str] = field(default_factory=dict)

    def instruction_count(self) -> int:
        from .instructions import walk

        seen = list(walk(self.instructions))
        for group in self.labels.values():
            seen.extend(walk(group))
        return len(seen)


# JSON types asserted by each keyword, for §3.1.1 static elision.
_NUMERIC = frozenset(("number", "integer"))
_TYPES_ALL = frozenset(("null", "boolean", "object", "array", "number", "integer", "string"))


def _json_types_of_const(value: Any) -> FrozenSet[str]:
    if value is None:
        return frozenset(("null",))
    if isinstance(value, bool):
        return frozenset(("boolean",))
    if isinstance(value, int):
        return frozenset(("integer", "number"))
    if isinstance(value, float):
        return frozenset(("number", "integer")) if value.is_integer() else frozenset(("number",))
    if isinstance(value, str):
        return frozenset(("string",))
    if isinstance(value, list):
        return frozenset(("array",))
    return frozenset(("object",))


@dataclass
class _Coverage:
    """Static property-coverage analysis result for unevaluatedProperties."""

    names: Set[str] = field(default_factory=set)
    patterns: List[RegexPlan] = field(default_factory=list)
    sees_all: bool = False
    # (guard schema chain, names, patterns, sees_all)
    branches: List[Tuple[Tuple[Any, ...], Set[str], List[RegexPlan], bool]] = field(
        default_factory=list
    )


@dataclass
class _ItemCoverage:
    """Static item-coverage analysis for unevaluatedItems."""

    prefix: int = 0
    sees_all: bool = False
    branches: List[Tuple[Tuple[Any, ...], int, bool]] = field(default_factory=list)
    # (guard schema chain, contains schema): annotations from a ``contains``
    # nested in a branch apply only when that branch validates
    contains_schemas: List[Tuple[Tuple[Any, ...], Any]] = field(default_factory=list)


class _Compiler:
    def __init__(self, resolver: SchemaResolver, options: CompilerOptions):
        self.resolver = resolver
        self.options = options
        self.dialect = resolver.dialect
        self.labels: Dict[int, Instructions] = {}
        self._label_ids: Dict[str, int] = {}
        self._label_done: Set[str] = set()
        self._ref_stack: List[str] = []
        self._ref_uses: Dict[str, int] = {}
        self._recursive_refs: Set[str] = set()
        self._analyze_refs()

    # ------------------------------------------------------------------
    # Reference analysis (§3.3): count uses, find cycles.
    # ------------------------------------------------------------------

    def _analyze_refs(self) -> None:
        stack: List[str] = []
        visited: Set[int] = set()

        def visit(schema: Any, base: str) -> None:
            if not isinstance(schema, (dict, list)):
                return
            if isinstance(schema, list):
                for item in schema:
                    visit(item, base)
                return
            sid = schema.get("$id")
            if isinstance(sid, str) and sid:
                from urllib.parse import urljoin

                base = urljoin(base, sid)
            for kw in ("$ref", "$dynamicRef", "$recursiveRef"):
                ref = schema.get(kw)
                if not isinstance(ref, str):
                    continue
                try:
                    if kw == "$ref":
                        resolved = self.resolver.resolve(ref, base)
                    elif kw == "$dynamicRef":
                        resolved = self.resolver.resolve_dynamic(ref, base)
                    else:
                        resolved = self.resolver.resolve_recursive(base)
                except KeyError:
                    continue
                self._ref_uses[resolved.key] = self._ref_uses.get(resolved.key, 0) + 1
                if resolved.key in stack:
                    # every destination on the current chain participates in
                    # the cycle and needs a label
                    for k in stack[stack.index(resolved.key):]:
                        self._recursive_refs.add(k)
                    self._recursive_refs.add(resolved.key)
                    continue
                marker = id(resolved.schema)
                stack.append(resolved.key)
                if (marker, resolved.key) not in self._seen_pairs:
                    self._seen_pairs.add((marker, resolved.key))
                    visit(resolved.schema, resolved.base_uri)
                stack.pop()
            for key, value in schema.items():
                if key in ("enum", "const", "default", "examples"):
                    continue
                visit(value, base)

        self._seen_pairs: Set[Tuple[int, str]] = set()
        visit(self.resolver.root, self.resolver.root_base)

    def _needs_label(self, key: str) -> bool:
        if key in self._recursive_refs:
            return True
        limit = self.options.inline_ref_limit if self.options.unroll else 0
        return self._ref_uses.get(key, 0) > limit

    def _label_id(self, key: str) -> int:
        if key not in self._label_ids:
            self._label_ids[key] = len(self._label_ids) + 1
        return self._label_ids[key]

    # ------------------------------------------------------------------
    # Entry point
    # ------------------------------------------------------------------

    def compile_root(self) -> Instructions:
        return tuple(
            self.compile(self.resolver.root, self.resolver.root_base, "", in_disjunction=False)
        )

    # ------------------------------------------------------------------
    # Subschema compilation
    # ------------------------------------------------------------------

    def compile(
        self,
        schema: Any,
        base: str,
        schema_path: str,
        *,
        in_disjunction: bool = False,
    ) -> List[Instruction]:
        """Compile one subschema into an instruction list (rel_path = ())."""
        if schema is True or schema == {}:
            return []
        if schema is False:
            return [AssertionFail(schema_path=schema_path)]
        if not isinstance(schema, dict):
            raise SchemaCompileError(f"schema must be bool or object at {schema_path!r}")

        from urllib.parse import urljoin

        sid = schema.get("$id")
        if isinstance(sid, str) and sid:
            base = urljoin(base, sid)

        opts = self.options
        out: List[Instruction] = []
        pinned_last: List[Instruction] = []  # second-level dependents

        allowed = self._allowed_types(schema)

        # --- references -------------------------------------------------
        for kw in ("$ref", "$dynamicRef", "$recursiveRef"):
            ref = schema.get(kw)
            if not isinstance(ref, str):
                continue
            out.extend(self._compile_ref(kw, ref, base, f"{schema_path}/{kw}"))

        # --- type / const / enum ----------------------------------------
        out.extend(self._compile_type(schema, schema_path, allowed))
        if "const" in schema:
            out.append(AssertionEqual(value=schema["const"], schema_path=f"{schema_path}/const"))
        if "enum" in schema:
            values = schema["enum"]
            if opts.cisc and len(values) == 1:
                out.append(AssertionEqual(value=values[0], schema_path=f"{schema_path}/enum"))
            else:
                out.append(
                    AssertionEqualsAny(values=tuple(values), schema_path=f"{schema_path}/enum")
                )

        # --- independent assertions per type -----------------------------
        out.extend(self._compile_number(schema, schema_path, allowed))
        out.extend(self._compile_string(schema, schema_path, allowed))
        out.extend(self._compile_object_assertions(schema, schema_path, allowed))
        out.extend(self._compile_array_assertions(schema, schema_path, allowed))

        # --- applicators --------------------------------------------------
        out.extend(self._compile_object_applicators(schema, base, schema_path, allowed, in_disjunction))
        out.extend(self._compile_array_applicators(schema, base, schema_path, allowed))
        out.extend(self._compile_logical(schema, base, schema_path, in_disjunction))
        out.extend(self._compile_conditionals(schema, base, schema_path))

        # --- second-level dependents (always last, §3.2.2) ----------------
        pinned_last.extend(self._compile_unevaluated_properties(schema, base, schema_path))
        pinned_last.extend(self._compile_unevaluated_items(schema, base, schema_path))

        if opts.reorder:
            out.sort(key=lambda inst: inst.cost())
        return out + pinned_last

    # ------------------------------------------------------------------
    # References
    # ------------------------------------------------------------------

    def _compile_ref(self, kw: str, ref: str, base: str, schema_path: str) -> List[Instruction]:
        if kw == "$ref":
            resolved = self.resolver.resolve(ref, base)
        elif kw == "$dynamicRef":
            resolved = self.resolver.resolve_dynamic(ref, base)
        else:
            resolved = self.resolver.resolve_recursive(base)
        key = resolved.key
        if not self._needs_label(key):
            if key in self._ref_stack:  # safety net: inline recursion guard
                self._recursive_refs.add(key)
            else:
                self._ref_stack.append(key)
                try:
                    return self.compile(resolved.schema, resolved.base_uri, schema_path)
                finally:
                    self._ref_stack.pop()
        label = self._label_id(key)
        if key in self._label_done or key in self._ref_stack:
            return [ControlJump(label=label, schema_path=schema_path)]
        self._label_done.add(key)
        self._ref_stack.append(key)
        try:
            children = tuple(self.compile(resolved.schema, resolved.base_uri, schema_path))
        finally:
            self._ref_stack.pop()
        self.labels[label] = children
        return [ControlLabel(label=label, children=children, schema_path=schema_path)]

    # ------------------------------------------------------------------
    # type / allowed-type lattice
    # ------------------------------------------------------------------

    def _allowed_types(self, schema: Dict[str, Any]) -> FrozenSet[str]:
        """Types a value may have and still satisfy this schema level --
        used for §3.1.1 elision of redundant assertions."""
        if not self.options.elide:
            return _TYPES_ALL
        allowed: FrozenSet[str] = _TYPES_ALL
        t = schema.get("type")
        if isinstance(t, str):
            allowed = frozenset((t,))
        elif isinstance(t, list):
            allowed = frozenset(t)
        if "integer" in allowed and "number" not in allowed:
            pass  # integers only
        elif "number" in allowed:
            allowed = allowed | frozenset(("integer",))
        if "const" in schema:
            allowed = allowed & _json_types_of_const(schema["const"])
        elif "enum" in schema:
            enum_types: FrozenSet[str] = frozenset()
            for v in schema["enum"]:
                enum_types = enum_types | _json_types_of_const(v)
            allowed = allowed & enum_types
        return allowed

    def _compile_type(
        self, schema: Dict[str, Any], schema_path: str, allowed: FrozenSet[str]
    ) -> List[Instruction]:
        t = schema.get("type")
        path = f"{schema_path}/type"
        if isinstance(t, str):
            return [AssertionType(type=t, schema_path=path)]
        if isinstance(t, list):
            if self.options.cisc and len(t) == 1:
                return [AssertionType(type=t[0], schema_path=path)]
            if t:
                return [AssertionTypeAny(types=tuple(t), schema_path=path)]
        return []

    # ------------------------------------------------------------------
    # Numbers
    # ------------------------------------------------------------------

    def _compile_number(
        self, schema: Dict[str, Any], schema_path: str, allowed: FrozenSet[str]
    ) -> List[Instruction]:
        if self.options.elide and not (allowed & _NUMERIC):
            return []  # §3.1.1: numeric assertions are redundant
        out: List[Instruction] = []
        lo: Optional[float] = None
        lo_exc = False
        hi: Optional[float] = None
        hi_exc = False
        if self.dialect is Dialect.DRAFT4:
            if "minimum" in schema:
                lo = schema["minimum"]
                lo_exc = schema.get("exclusiveMinimum") is True
            if "maximum" in schema:
                hi = schema["maximum"]
                hi_exc = schema.get("exclusiveMaximum") is True
        else:
            if "minimum" in schema:
                lo, lo_exc = schema["minimum"], False
            if isinstance(schema.get("exclusiveMinimum"), (int, float)) and not isinstance(
                schema.get("exclusiveMinimum"), bool
            ):
                em = schema["exclusiveMinimum"]
                if lo is None or em >= lo:
                    lo, lo_exc = em, True
            if "maximum" in schema:
                hi, hi_exc = schema["maximum"], False
            if isinstance(schema.get("exclusiveMaximum"), (int, float)) and not isinstance(
                schema.get("exclusiveMaximum"), bool
            ):
                eM = schema["exclusiveMaximum"]
                if hi is None or eM <= hi:
                    hi, hi_exc = eM, True

        if lo is not None and hi is not None and self.options.cisc:
            out.append(
                AssertionNumberBounds(
                    lo=lo, lo_exclusive=lo_exc, hi=hi, hi_exclusive=hi_exc, schema_path=schema_path
                )
            )
        else:
            if lo is not None:
                cls = AssertionGreater if lo_exc else AssertionGreaterEqual
                out.append(cls(bound=lo, schema_path=f"{schema_path}/minimum"))
            if hi is not None:
                cls = AssertionLess if hi_exc else AssertionLessEqual
                out.append(cls(bound=hi, schema_path=f"{schema_path}/maximum"))
        if "multipleOf" in schema:
            out.append(
                AssertionDivisible(
                    divisor=schema["multipleOf"], schema_path=f"{schema_path}/multipleOf"
                )
            )
        return out

    # ------------------------------------------------------------------
    # Strings
    # ------------------------------------------------------------------

    def _compile_string(
        self, schema: Dict[str, Any], schema_path: str, allowed: FrozenSet[str]
    ) -> List[Instruction]:
        if self.options.elide and "string" not in allowed:
            return []
        out: List[Instruction] = []
        min_len = schema.get("minLength")
        max_len = schema.get("maxLength")
        only_string = allowed == frozenset(("string",))
        if (
            self.options.cisc
            and only_string
            and min_len is not None
            and max_len is not None
        ):
            # StringBounds fuses the type check (§2.5); the separate
            # AssertionType emitted for "type" stays (it is the actual type
            # assertion); the fusion here avoids two separate length ops.
            out.append(
                AssertionStringBounds(min_len=min_len, max_len=max_len, schema_path=schema_path)
            )
        else:
            if min_len is not None:
                out.append(
                    AssertionStringSizeGreater(bound=min_len, schema_path=f"{schema_path}/minLength")
                )
            if max_len is not None:
                out.append(
                    AssertionStringSizeLess(bound=max_len, schema_path=f"{schema_path}/maxLength")
                )
        if "pattern" in schema:
            plan = analyze_pattern(schema["pattern"], enabled=self.options.regex_specialize)
            inst = self._pattern_assertion(plan, f"{schema_path}/pattern")
            if inst is not None:
                out.append(inst)
        if self.options.format_assertion and isinstance(schema.get("format"), str):
            out.append(
                AssertionStringType(format=schema["format"], schema_path=f"{schema_path}/format")
            )
        return out

    def _pattern_assertion(self, plan: RegexPlan, schema_path: str) -> Optional[Instruction]:
        if plan.kind is RegexKind.ALL:
            return None  # §4.3: .* accepts everything -- drop the check
        if plan.kind is RegexKind.NON_EMPTY:
            return AssertionStringSizeGreater(bound=1, schema_path=schema_path)
        if plan.kind is RegexKind.LENGTH_RANGE:
            if plan.max_len is None:
                return AssertionStringSizeGreater(bound=plan.min_len, schema_path=schema_path)
            return AssertionStringBounds(
                min_len=plan.min_len, max_len=plan.max_len, schema_path=schema_path
            )
        return AssertionRegex(plan=plan, schema_path=schema_path)

    # ------------------------------------------------------------------
    # Object assertions
    # ------------------------------------------------------------------

    def _compile_object_assertions(
        self, schema: Dict[str, Any], schema_path: str, allowed: FrozenSet[str]
    ) -> List[Instruction]:
        if self.options.elide and "object" not in allowed:
            return []
        out: List[Instruction] = []
        required = schema.get("required")
        if isinstance(required, list) and required:
            if self.options.cisc and len(required) == 1:
                key = required[0]
                # PropertyType fusion: required + properties.<key>.type only
                child = schema.get("properties", {}).get(key) if isinstance(
                    schema.get("properties"), dict
                ) else None
                if (
                    isinstance(child, dict)
                    and set(child.keys()) == {"type"}
                    and isinstance(child["type"], str)
                ):
                    out.append(
                        AssertionPropertyType(
                            key=key,
                            key_hash=shash(key),
                            type=child["type"],
                            schema_path=f"{schema_path}/required",
                        )
                    )
                    # NOTE: marks the property as handled for 'properties'
                    self._fused_property_types.add((id(schema), key))
                else:
                    out.append(
                        AssertionDefines(
                            key=key, key_hash=shash(key), schema_path=f"{schema_path}/required"
                        )
                    )
            else:
                keys = tuple(dict.fromkeys(required))
                out.append(
                    AssertionDefinesAll(
                        keys=keys,
                        key_hashes=tuple(shash(k) for k in keys),
                        schema_path=f"{schema_path}/required",
                    )
                )
        if "minProperties" in schema:
            out.append(
                AssertionObjectSizeGreater(
                    bound=schema["minProperties"], schema_path=f"{schema_path}/minProperties"
                )
            )
        if "maxProperties" in schema:
            out.append(
                AssertionObjectSizeLess(
                    bound=schema["maxProperties"], schema_path=f"{schema_path}/maxProperties"
                )
            )
        deps = self._dependent_required(schema)
        if deps:
            out.append(
                AssertionPropertyDependencies(
                    dependencies=tuple(
                        (k, shash(k), tuple(v), tuple(shash(x) for x in v)) for k, v in deps
                    ),
                    schema_path=f"{schema_path}/dependentRequired",
                )
            )
        return out

    def _dependent_required(self, schema: Dict[str, Any]) -> List[Tuple[str, List[str]]]:
        out: List[Tuple[str, List[str]]] = []
        dr = schema.get("dependentRequired")
        if isinstance(dr, dict):
            out.extend((k, list(v)) for k, v in dr.items() if isinstance(v, list))
        legacy = schema.get("dependencies")
        if isinstance(legacy, dict):
            out.extend((k, list(v)) for k, v in legacy.items() if isinstance(v, list))
        return out

    def _dependent_schemas(self, schema: Dict[str, Any]) -> List[Tuple[str, Any]]:
        out: List[Tuple[str, Any]] = []
        ds = schema.get("dependentSchemas")
        if isinstance(ds, dict):
            out.extend(ds.items())
        legacy = schema.get("dependencies")
        if isinstance(legacy, dict):
            out.extend((k, v) for k, v in legacy.items() if not isinstance(v, list))
        return out

    # ------------------------------------------------------------------
    # Array assertions
    # ------------------------------------------------------------------

    def _compile_array_assertions(
        self, schema: Dict[str, Any], schema_path: str, allowed: FrozenSet[str]
    ) -> List[Instruction]:
        if self.options.elide and "array" not in allowed:
            return []
        out: List[Instruction] = []
        min_items = schema.get("minItems")
        max_items = schema.get("maxItems")
        if self.options.cisc and min_items is not None and max_items is not None:
            out.append(
                AssertionArrayBounds(min_len=min_items, max_len=max_items, schema_path=schema_path)
            )
        else:
            if min_items is not None:
                out.append(
                    AssertionArraySizeGreater(bound=min_items, schema_path=f"{schema_path}/minItems")
                )
            if max_items is not None:
                out.append(
                    AssertionArraySizeLess(bound=max_items, schema_path=f"{schema_path}/maxItems")
                )
        if schema.get("uniqueItems") is True:
            out.append(AssertionUnique(schema_path=f"{schema_path}/uniqueItems"))
        return out

    # ------------------------------------------------------------------
    # Object applicators (properties / patternProperties /
    # additionalProperties / propertyNames / dependentSchemas)
    # ------------------------------------------------------------------

    _fused_property_types: Set[Tuple[int, str]] = set()

    def _compile_object_applicators(
        self,
        schema: Dict[str, Any],
        base: str,
        schema_path: str,
        allowed: FrozenSet[str],
        in_disjunction: bool,
    ) -> List[Instruction]:
        if self.options.elide and "object" not in allowed:
            return []
        out: List[Instruction] = []
        opts = self.options

        props: Dict[str, Any] = schema.get("properties") or {}
        pat_props: Dict[str, Any] = schema.get("patternProperties") or {}
        addl = schema.get("additionalProperties")
        if self.dialect in (Dialect.DRAFT4, Dialect.DRAFT6, Dialect.DRAFT7):
            pass  # same keyword names apply

        pattern_plans = {
            pat: analyze_pattern(pat, enabled=opts.regex_specialize) for pat in pat_props
        }

        # patternProperties -> one loop per pattern
        for pat, subschema in pat_props.items():
            children = tuple(
                self.compile(subschema, base, f"{schema_path}/patternProperties/{escape(pat)}")
            )
            plan = pattern_plans[pat]
            if not children:
                continue
            if plan.kind is RegexKind.ALL:
                out.append(
                    LoopProperties(children=children, schema_path=f"{schema_path}/patternProperties")
                )
            else:
                out.append(
                    LoopPropertiesRegex(
                        plan=plan,
                        children=children,
                        schema_path=f"{schema_path}/patternProperties/{escape(pat)}",
                    )
                )

        required = set(schema.get("required") or ())
        prop_items: List[Tuple[str, Any]] = [
            (k, v)
            for k, v in props.items()
            if (id(schema), k) not in self._fused_property_types
        ]

        closed = addl is False

        if closed:
            # LoopPropertiesMatchClosed: every instance key must match.
            matches = tuple(
                (
                    k,
                    shash(k),
                    tuple(self.compile(v, base, f"{schema_path}/properties/{escape(k)}")),
                )
                for k, v in props.items()
            )
            out.append(
                LoopPropertiesMatchClosed(
                    matches=matches,
                    tolerate_patterns=tuple(pattern_plans.values()),
                    schema_path=f"{schema_path}/additionalProperties",
                )
            )
        elif prop_items:
            unrolled = opts.unroll and (
                in_disjunction
                or len(prop_items) <= opts.unroll_property_limit
                or (len(prop_items) > 0 and len(required & set(props)) / len(prop_items) >= opts.unroll_required_fraction)
            )
            if unrolled:
                for k, v in prop_items:
                    children = self.compile(v, base, f"{schema_path}/properties/{escape(k)}")
                    out.extend(_prefix(children, (k,)))
            else:
                matches = tuple(
                    (
                        k,
                        shash(k),
                        tuple(self.compile(v, base, f"{schema_path}/properties/{escape(k)}")),
                    )
                    for k, v in prop_items
                )
                out.append(
                    LoopPropertiesMatch(matches=matches, schema_path=f"{schema_path}/properties")
                )

        # additionalProperties as a schema (not boolean)
        if isinstance(addl, dict) or addl is True:
            if addl is not True:  # `true` -> no instructions (§3.2.1)
                children = tuple(
                    self.compile(addl, base, f"{schema_path}/additionalProperties")
                )
                if children:
                    if props or pat_props:
                        keys = tuple(props.keys())
                        out.append(
                            LoopPropertiesExcept(
                                exclude_keys=keys,
                                exclude_hashes=tuple(shash(k) for k in keys),
                                exclude_patterns=tuple(pattern_plans.values()),
                                children=children,
                                schema_path=f"{schema_path}/additionalProperties",
                            )
                        )
                    else:
                        out.append(
                            LoopProperties(
                                children=children,
                                schema_path=f"{schema_path}/additionalProperties",
                            )
                        )

        # propertyNames
        pn = schema.get("propertyNames")
        if pn is not None:
            children = tuple(self.compile(pn, base, f"{schema_path}/propertyNames"))
            if pn is False:
                out.append(
                    AssertionObjectSizeLess(bound=0, schema_path=f"{schema_path}/propertyNames")
                )
            elif children:
                out.append(LoopKeys(children=children, schema_path=f"{schema_path}/propertyNames"))

        # dependentSchemas (+ legacy schema-form dependencies) -> WhenDefines
        for key, subschema in self._dependent_schemas(schema):
            children = tuple(
                self.compile(subschema, base, f"{schema_path}/dependentSchemas/{escape(key)}")
            )
            if not children:
                continue
            if opts.cisc:
                out.append(
                    WhenDefines(
                        key=key,
                        key_hash=shash(key),
                        children=children,
                        schema_path=f"{schema_path}/dependentSchemas/{escape(key)}",
                    )
                )
            else:
                out.append(
                    LogicalCondition(
                        condition=(
                            AssertionType(type="object"),
                            AssertionDefines(key=key, key_hash=shash(key)),
                        ),
                        then_children=children,
                        schema_path=f"{schema_path}/dependentSchemas/{escape(key)}",
                    )
                )
        return out

    # ------------------------------------------------------------------
    # Array applicators (prefixItems / items / contains)
    # ------------------------------------------------------------------

    def _compile_array_applicators(
        self, schema: Dict[str, Any], base: str, schema_path: str, allowed: FrozenSet[str]
    ) -> List[Instruction]:
        if self.options.elide and "array" not in allowed:
            return []
        out: List[Instruction] = []
        prefix_schemas, items_schema = self._split_items(schema)

        n_prefix = len(prefix_schemas)
        if prefix_schemas:
            groups = tuple(
                tuple(self.compile(s, base, f"{schema_path}/prefixItems/{i}"))
                for i, s in enumerate(prefix_schemas)
            )
            if any(groups):
                out.append(ArrayPrefix(groups=groups, schema_path=f"{schema_path}/prefixItems"))

        if items_schema is not None and items_schema is not True:
            if items_schema is False:
                # only the prefix may exist -> pure length check (elision)
                out.append(
                    AssertionArraySizeLess(bound=n_prefix, schema_path=f"{schema_path}/items")
                )
            else:
                children = tuple(self.compile(items_schema, base, f"{schema_path}/items"))
                if children:
                    if n_prefix:
                        out.append(
                            LoopItemsFrom(
                                start=n_prefix,
                                children=children,
                                schema_path=f"{schema_path}/items",
                            )
                        )
                    else:
                        out.append(LoopItems(children=children, schema_path=f"{schema_path}/items"))

        out.extend(self._compile_contains(schema, base, schema_path))
        return out

    def _split_items(self, schema: Dict[str, Any]) -> Tuple[List[Any], Any]:
        """Normalize dialect differences: returns (prefix schemas, tail schema)."""
        if self.dialect in (Dialect.DRAFT2019, Dialect.DRAFT2020):
            prefix = schema.get("prefixItems") or []
            items = schema.get("items")
            if self.dialect is Dialect.DRAFT2019 and isinstance(items, list):
                # 2019-09 still used array-form items
                return items, schema.get("additionalItems")
            return list(prefix), items
        items = schema.get("items")
        if isinstance(items, list):
            return items, schema.get("additionalItems")
        return [], items

    def _compile_contains(
        self, schema: Dict[str, Any], base: str, schema_path: str
    ) -> List[Instruction]:
        if "contains" not in schema:
            return []
        if self.dialect in (Dialect.DRAFT4,):
            return []  # contains introduced in draft 6
        sub = schema["contains"]
        min_c = schema.get("minContains", 1)
        max_c = schema.get("maxContains")
        if self.dialect in (Dialect.DRAFT6, Dialect.DRAFT7):
            min_c, max_c = 1, None  # min/maxContains are 2019-09+
        out: List[Instruction] = []
        if self.options.elide and min_c == 0 and max_c is None:
            return []  # §3.1.2: nothing to validate
        if self.options.elide and (sub is True or sub == {}):
            # §3.1.2: contains:true degenerates to array size checks
            if min_c > 0:
                out.append(
                    AssertionArraySizeGreater(bound=min_c, schema_path=f"{schema_path}/minContains")
                )
            if max_c is not None:
                out.append(
                    AssertionArraySizeLess(bound=max_c, schema_path=f"{schema_path}/maxContains")
                )
            return out
        children = tuple(self.compile(sub, base, f"{schema_path}/contains"))
        out.append(
            LoopContains(
                children=children,
                min_count=min_c,
                max_count=max_c,
                schema_path=f"{schema_path}/contains",
            )
        )
        return out

    # ------------------------------------------------------------------
    # Logical applicators
    # ------------------------------------------------------------------

    def _compile_logical(
        self, schema: Dict[str, Any], base: str, schema_path: str, in_disjunction: bool
    ) -> List[Instruction]:
        out: List[Instruction] = []
        all_of = schema.get("allOf")
        if isinstance(all_of, list):
            # AND of subschemas == splice inline (short-circuit preserved;
            # gives §4.4 reordering a flat view across branch boundaries)
            if self.options.cisc:
                for i, sub in enumerate(all_of):
                    out.extend(self.compile(sub, base, f"{schema_path}/allOf/{i}"))
            else:
                groups = [
                    tuple(self.compile(sub, base, f"{schema_path}/allOf/{i}"))
                    for i, sub in enumerate(all_of)
                ]
                out.append(
                    LogicalAnd(
                        children=tuple(itertools.chain.from_iterable(groups)),
                        schema_path=f"{schema_path}/allOf",
                    )
                )
        any_of = schema.get("anyOf")
        if isinstance(any_of, list):
            groups = tuple(
                tuple(self.compile(sub, base, f"{schema_path}/anyOf/{i}", in_disjunction=True))
                for i, sub in enumerate(any_of)
            )
            if self.options.reorder:
                groups = tuple(sorted(groups, key=_group_cost))
            if any(len(g) == 0 for g in groups):
                pass  # a `true` branch makes anyOf vacuous (§3.1.1 elision)
            else:
                out.append(LogicalOr(groups=groups, schema_path=f"{schema_path}/anyOf"))
        one_of = schema.get("oneOf")
        if isinstance(one_of, list):
            groups = tuple(
                tuple(self.compile(sub, base, f"{schema_path}/oneOf/{i}", in_disjunction=True))
                for i, sub in enumerate(one_of)
            )
            out.append(LogicalXor(groups=groups, schema_path=f"{schema_path}/oneOf"))
        not_schema = schema.get("not")
        if not_schema is not None:
            children = tuple(self.compile(not_schema, base, f"{schema_path}/not"))
            if not children:  # not:true / not:{} -> always fails
                out.append(AssertionFail(schema_path=f"{schema_path}/not"))
            elif len(children) == 1 and isinstance(children[0], AssertionFail):
                pass  # not:false -> always passes
            else:
                out.append(LogicalNot(children=children, schema_path=f"{schema_path}/not"))
        return out

    # ------------------------------------------------------------------
    # if / then / else
    # ------------------------------------------------------------------

    def _compile_conditionals(
        self, schema: Dict[str, Any], base: str, schema_path: str
    ) -> List[Instruction]:
        if self.dialect in (Dialect.DRAFT4, Dialect.DRAFT6):
            return []
        if "if" not in schema:
            return []  # then/else are ignored without if
        if_schema = schema["if"]
        then_schema = schema.get("then")
        else_schema = schema.get("else")
        if then_schema is None and else_schema is None:
            return []  # no effect (§3.1.2 minor optimization)
        then_children = (
            tuple(self.compile(then_schema, base, f"{schema_path}/then"))
            if then_schema is not None
            else ()
        )
        else_children = (
            tuple(self.compile(else_schema, base, f"{schema_path}/else"))
            if else_schema is not None
            else ()
        )
        condition = tuple(self.compile(if_schema, base, f"{schema_path}/if"))
        if not condition:  # if:true -> then applies unconditionally
            return list(then_children)
        if not then_children and not else_children:
            return []

        # Table 2 CISC specializations of LogicalCondition
        if self.options.cisc and isinstance(if_schema, dict):
            keys = set(if_schema.keys())
            if keys == {"type"} and isinstance(if_schema["type"], str) and not else_children:
                return [
                    WhenType(
                        type=if_schema["type"],
                        children=then_children,
                        schema_path=f"{schema_path}/if",
                    )
                ]
            if (
                keys == {"required"}
                and isinstance(if_schema["required"], list)
                and len(if_schema["required"]) == 1
                and not else_children
            ):
                key = if_schema["required"][0]
                return [
                    WhenDefines(
                        key=key,
                        key_hash=shash(key),
                        children=then_children,
                        schema_path=f"{schema_path}/if",
                    )
                ]
            if keys == {"minItems"} and not else_children:
                return [
                    WhenArraySizeGreater(
                        bound=if_schema["minItems"] - 1,
                        children=then_children,
                        schema_path=f"{schema_path}/if",
                    )
                ]
            if (
                keys == {"minItems", "maxItems"}
                and if_schema["minItems"] == if_schema["maxItems"]
                and not else_children
            ):
                return [
                    WhenArraySizeEqual(
                        bound=if_schema["minItems"],
                        children=then_children,
                        schema_path=f"{schema_path}/if",
                    )
                ]
        return [
            LogicalCondition(
                condition=condition,
                then_children=then_children,
                else_children=else_children,
                schema_path=f"{schema_path}/if",
            )
        ]

    # ------------------------------------------------------------------
    # unevaluatedProperties (§3.2.2)
    # ------------------------------------------------------------------

    def _collect_coverage(
        self,
        schema: Any,
        base: str,
        cov: _Coverage,
        guards: Tuple[Any, ...],
        seen: Set[int],
    ) -> None:
        """Static pass: which properties does ``schema`` evaluate?

        ``guards`` is the conjunction of branch schemas controlling whether
        this schema's annotations apply; empty = guaranteed.
        """
        if schema is True or schema is False or not isinstance(schema, dict):
            return
        if id(schema) in seen:
            return
        seen.add(id(schema))
        from urllib.parse import urljoin

        sid = schema.get("$id")
        if isinstance(sid, str) and sid:
            base = urljoin(base, sid)

        names: Set[str] = set(schema.get("properties", {}) or {})
        patterns = [
            analyze_pattern(p, enabled=self.options.regex_specialize)
            for p in (schema.get("patternProperties") or {})
        ]
        sees_all = (
            "additionalProperties" in schema or "unevaluatedProperties" in schema
        )
        if guards:
            if names or patterns or sees_all:
                cov.branches.append((guards, names, patterns, sees_all))
        else:
            cov.names |= names
            cov.patterns.extend(patterns)
            cov.sees_all = cov.sees_all or sees_all

        for kw in ("$ref", "$dynamicRef", "$recursiveRef"):
            ref = schema.get(kw)
            if isinstance(ref, str):
                try:
                    if kw == "$ref":
                        r = self.resolver.resolve(ref, base)
                    elif kw == "$dynamicRef":
                        r = self.resolver.resolve_dynamic(ref, base)
                    else:
                        r = self.resolver.resolve_recursive(base)
                    self._collect_coverage(r.schema, r.base_uri, cov, guards, seen)
                except KeyError:
                    pass
        for sub in schema.get("allOf") or []:
            self._collect_coverage(sub, base, cov, guards, seen)
        for sub in (schema.get("anyOf") or []) + (schema.get("oneOf") or []):
            self._collect_coverage(sub, base, cov, guards + (sub,), set(seen))
        if "if" in schema:
            if_s = schema["if"]
            self._collect_coverage(if_s, base, cov, guards + (if_s,), set(seen))
            if "then" in schema:
                self._collect_coverage(
                    schema["then"], base, cov, guards + (if_s,), set(seen)
                )
            if "else" in schema:
                self._collect_coverage(
                    schema["else"], base, cov, guards + ({"not": if_s},), set(seen)
                )
        for key, sub in self._dependent_schemas(schema):
            self._collect_coverage(
                sub, base, cov, guards + ({"required": [key]},), set(seen)
            )

    def _compile_unevaluated_properties(
        self, schema: Dict[str, Any], base: str, schema_path: str
    ) -> List[Instruction]:
        if self.dialect in (Dialect.DRAFT4, Dialect.DRAFT6, Dialect.DRAFT7):
            return []
        if "unevaluatedProperties" not in schema:
            return []
        sub = schema["unevaluatedProperties"]
        if sub is True or sub == {}:
            return []  # everything allowed -> no instructions (§3.2.2)

        cov = _Coverage()
        probe = dict(schema)
        probe.pop("unevaluatedProperties")
        self._collect_coverage(probe, base, cov, (), set())
        if cov.sees_all:
            return []  # statically: every property is evaluated

        children = tuple(
            self.compile(sub, base, f"{schema_path}/unevaluatedProperties")
        )
        if not children:
            return []

        spath = f"{schema_path}/unevaluatedProperties"
        if not cov.branches:
            # Fully static: compiles exactly like additionalProperties
            # against the statically-known evaluated set (§3.2.2).
            keys = tuple(sorted(cov.names))
            if not keys and not cov.patterns:
                return [LoopProperties(children=children, schema_path=spath)]
            return [
                LoopPropertiesExcept(
                    exclude_keys=keys,
                    exclude_hashes=tuple(shash(k) for k in keys),
                    exclude_patterns=tuple(cov.patterns),
                    children=children,
                    schema_path=spath,
                )
            ]
        # Dynamic residue: guards decide the evaluated set at runtime.
        branches = []
        for guards, names, patterns, sees_all in cov.branches:
            guard_instructions: List[Instruction] = []
            for g in guards:
                guard_instructions.extend(self.compile(g, base, spath + "/guard"))
            keys = tuple(sorted(names))
            branches.append(
                (
                    tuple(guard_instructions),
                    keys,
                    tuple(shash(k) for k in keys),
                    tuple(patterns),
                    sees_all,
                )
            )
        static_keys = tuple(sorted(cov.names))
        return [
            LoopUnevaluatedProperties(
                static_keys=static_keys,
                static_hashes=tuple(shash(k) for k in static_keys),
                static_patterns=tuple(cov.patterns),
                branches=tuple(branches),
                children=children,
                schema_path=spath,
            )
        ]

    # ------------------------------------------------------------------
    # unevaluatedItems (§3.2.2)
    # ------------------------------------------------------------------

    def _collect_item_coverage(
        self,
        schema: Any,
        base: str,
        cov: _ItemCoverage,
        guards: Tuple[Any, ...],
        seen: Set[int],
    ) -> None:
        if schema is True or schema is False or not isinstance(schema, dict):
            return
        if id(schema) in seen:
            return
        seen.add(id(schema))
        prefix_schemas, items_schema = self._split_items(schema)
        prefix = len(prefix_schemas)
        sees_all = items_schema is not None or "unevaluatedItems" in schema
        if "contains" in schema:
            cov.contains_schemas.append((guards, schema["contains"]))
        if guards:
            if prefix or sees_all:
                cov.branches.append((guards, prefix, sees_all))
        else:
            cov.prefix = max(cov.prefix, prefix)
            cov.sees_all = cov.sees_all or sees_all
        for kw in ("$ref", "$dynamicRef", "$recursiveRef"):
            ref = schema.get(kw)
            if isinstance(ref, str):
                try:
                    if kw == "$ref":
                        r = self.resolver.resolve(ref, base)
                    elif kw == "$dynamicRef":
                        r = self.resolver.resolve_dynamic(ref, base)
                    else:
                        r = self.resolver.resolve_recursive(base)
                    self._collect_item_coverage(r.schema, r.base_uri, cov, guards, seen)
                except KeyError:
                    pass
        for sub in schema.get("allOf") or []:
            self._collect_item_coverage(sub, base, cov, guards, seen)
        for sub in (schema.get("anyOf") or []) + (schema.get("oneOf") or []):
            self._collect_item_coverage(sub, base, cov, guards + (sub,), set(seen))
        if "if" in schema:
            if_s = schema["if"]
            self._collect_item_coverage(if_s, base, cov, guards + (if_s,), set(seen))
            if "then" in schema:
                self._collect_item_coverage(
                    schema["then"], base, cov, guards + (if_s,), set(seen)
                )
            if "else" in schema:
                self._collect_item_coverage(
                    schema["else"], base, cov, guards + ({"not": if_s},), set(seen)
                )

    def _compile_unevaluated_items(
        self, schema: Dict[str, Any], base: str, schema_path: str
    ) -> List[Instruction]:
        if self.dialect in (Dialect.DRAFT4, Dialect.DRAFT6, Dialect.DRAFT7):
            return []
        if "unevaluatedItems" not in schema:
            return []
        sub = schema["unevaluatedItems"]
        if sub is True or sub == {}:
            return []

        cov = _ItemCoverage()
        probe = dict(schema)
        probe.pop("unevaluatedItems")
        self._collect_item_coverage(probe, base, cov, (), set())
        if cov.sees_all:
            return []

        children = tuple(self.compile(sub, base, f"{schema_path}/unevaluatedItems"))
        if not children:
            return []
        spath = f"{schema_path}/unevaluatedItems"
        contains_groups = []
        for guards, cs in cov.contains_schemas:
            guard_instructions: List[Instruction] = []
            for g in guards:
                guard_instructions.extend(self.compile(g, base, spath + "/guard"))
            contains_groups.append(
                (tuple(guard_instructions), tuple(self.compile(cs, base, spath + "/contains")))
            )
        contains_groups = tuple(contains_groups)
        if not cov.branches and not contains_groups:
            # static residue == LoopItemsFrom (first-level-equivalent form)
            if cov.prefix == 0:
                return [LoopItems(children=children, schema_path=spath)]
            return [LoopItemsFrom(start=cov.prefix, children=children, schema_path=spath)]
        branches = []
        for guards, prefix, sees_all in cov.branches:
            guard_instructions: List[Instruction] = []
            for g in guards:
                guard_instructions.extend(self.compile(g, base, spath + "/guard"))
            branches.append((tuple(guard_instructions), prefix, sees_all))
        return [
            LoopUnevaluatedItems(
                static_prefix=cov.prefix,
                static_all=False,
                branches=tuple(branches),
                contains_groups=contains_groups,
                children=children,
                schema_path=spath,
            )
        ]


def _prefix(instructions: Sequence[Instruction], rel: InstancePath) -> List[Instruction]:
    """Prepend ``rel`` to the rel_path of top-level instructions."""
    return [replace(inst, rel_path=rel + inst.rel_path) for inst in instructions]


def _group_cost(group: Instructions) -> int:
    return sum(inst.cost() for inst in group)


def compile_schema(
    schema: Any,
    resources: Optional[Dict[str, Any]] = None,
    options: Optional[CompilerOptions] = None,
) -> CompiledSchema:
    """Compile a JSON Schema into the Blaze validation DSL."""
    options = options or CompilerOptions()
    resolver = SchemaResolver(schema, resources)
    compiler = _Compiler(resolver, options)
    compiler._fused_property_types = set()
    instructions = compiler.compile_root()
    return CompiledSchema(
        instructions=instructions,
        labels=compiler.labels,
        options=options,
        dialect=resolver.dialect,
        source=schema,
        label_names={v: k for k, v in compiler._label_ids.items()},
    )
