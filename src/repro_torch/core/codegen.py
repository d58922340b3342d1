"""Closure compilation of the instruction DSL (beyond-paper optimization).

The paper's §8 names "precompiling the code necessary to validate each
schema" as future work; this module does it.  Each instruction compiles to
a specialized Python closure with every operand, hash, and type test
pre-bound -- eliminating opcode dispatch, dataclass attribute loads, and
precondition re-derivation from the per-document hot path.  Semantics are
identical to executor.py (differentially tested in tests/test_codegen.py).

Notes on specialization:
* exact ``type(x) is`` tests (the document model produces exact types;
  bool/int discrimination falls out for free);
* scalar const/enum tests split by type at compile time -- enum membership
  is one frozenset probe, no json_equal walk;
* property matching uses dicts keyed by the semi-perfect hash, built once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from .compiler import CompiledSchema
from .doc_model import HashedObject, canonical, json_equal
from .hashing import is_short_hash
from .instructions import Instruction, Instructions, OpCode
from .regex_opt import RegexKind

__all__ = ["compile_to_callable"]

Check = Callable[[Any], bool]

_MISS = object()


def _type_check(t: str) -> Check:
    if t == "string":
        return lambda v: type(v) is str
    if t == "integer":
        return lambda v: type(v) is int or (type(v) is float and v.is_integer())
    if t == "number":
        return lambda v: type(v) is int or type(v) is float
    if t == "object":
        return lambda v: type(v) is HashedObject
    if t == "array":
        return lambda v: type(v) is list
    if t == "boolean":
        return lambda v: type(v) is bool
    if t == "null":
        return lambda v: v is None
    return lambda v: False


def _const_check(value: Any) -> Check:
    if value is None:
        return lambda v: v is None
    if isinstance(value, bool):
        return lambda v: v is value
    if isinstance(value, str):
        return lambda v: type(v) is str and v == value
    if isinstance(value, (int, float)):
        f = float(value)
        return lambda v: (type(v) is int or type(v) is float) and v == f
    return lambda v: json_equal(v, value)


def _enum_check(values: Tuple[Any, ...]) -> Check:
    strs = frozenset(v for v in values if isinstance(v, str))
    nums = frozenset(
        float(v) for v in values if isinstance(v, (int, float)) and not isinstance(v, bool)
    )
    has_null = any(v is None for v in values)
    has_true = any(v is True for v in values)
    has_false = any(v is False for v in values)
    complex_vals = [v for v in values if isinstance(v, (list, dict))]

    def check(v):
        t = type(v)
        if t is str:
            return v in strs
        if t is bool:
            return has_true if v else has_false
        if t is int or t is float:
            return v in nums
        if v is None:
            return has_null
        return any(json_equal(v, c) for c in complex_vals)

    return check


class _Codegen:
    def __init__(self, compiled: CompiledSchema):
        self.compiled = compiled
        self.labels: Dict[int, Check] = {}

    # -- groups ---------------------------------------------------------------

    def group(self, instructions: Instructions) -> Check:
        fns = [self.one(i) for i in instructions]
        if not fns:
            return lambda v: True
        if len(fns) == 1:
            return fns[0]
        if len(fns) == 2:
            f0, f1 = fns
            return lambda v: f0(v) and f1(v)
        fns_t = tuple(fns)

        def check(v):
            for f in fns_t:
                if not f(v):
                    return False
            return True

        return check

    # -- per-instruction ---------------------------------------------------------

    def one(self, inst: Instruction) -> Check:
        inner = self.body(inst)
        if not inst.rel_path:
            return inner
        # fold relative resolution into the closure; hashes precomputed here
        from .hashing import shash

        path = tuple(
            (tok, shash(tok)) if isinstance(tok, str) else tok
            for tok in inst.rel_path
        )
        if len(path) == 1 and type(path[0]) is tuple:
            key, h = path[0]

            def resolved(v, _inner=inner, _k=key, _h=h):
                if type(v) is not HashedObject:
                    return True
                child = v.get_hashed(_h, _k, _MISS)
                if child is _MISS:
                    return True
                return _inner(child)

            return resolved

        def resolved_deep(v, _inner=inner, _path=path):
            node = v
            for tok in _path:
                if type(tok) is tuple:
                    if type(node) is not HashedObject:
                        return True
                    node = node.get_hashed(tok[1], tok[0], _MISS)
                    if node is _MISS:
                        return True
                else:
                    if type(node) is not list or not 0 <= tok < len(node):
                        return True
                    node = node[tok]
            return _inner(node)

        return resolved_deep

    def body(self, inst: Instruction) -> Check:  # noqa: C901 -- dispatch table
        op = inst.op
        if op is OpCode.FAIL:
            return lambda v: False
        if op is OpCode.TYPE:
            return _type_check(inst.type)
        if op is OpCode.TYPE_ANY:
            checks = tuple(_type_check(t) for t in inst.types)
            return lambda v: any(c(v) for c in checks)
        if op is OpCode.EQUAL:
            return _const_check(inst.value)
        if op is OpCode.EQUALS_ANY:
            return _enum_check(inst.values)

        if op is OpCode.DEFINES:
            k, h = inst.key, inst.key_hash
            return (
                lambda v: type(v) is not HashedObject
                or v.get_hashed(h, k, _MISS) is not _MISS
            )
        if op is OpCode.DEFINES_ALL:
            pairs = tuple(zip(inst.key_hashes, inst.keys))

            def defines_all(v):
                if type(v) is not HashedObject:
                    return True
                get = v.get_hashed
                for h, k in pairs:
                    if get(h, k, _MISS) is _MISS:
                        return False
                return True

            return defines_all
        if op is OpCode.PROPERTY_DEPENDENCIES:
            deps = tuple(
                (h, k, tuple(zip(dh, dk)))
                for k, h, dk, dh in inst.dependencies
            )

            def prop_deps(v):
                if type(v) is not HashedObject:
                    return True
                get = v.get_hashed
                for h, k, reqs in deps:
                    if get(h, k, _MISS) is not _MISS:
                        for dh, dk in reqs:
                            if get(dh, dk, _MISS) is _MISS:
                                return False
                return True

            return prop_deps
        if op is OpCode.OBJECT_SIZE_GREATER:
            b = inst.bound
            return lambda v: type(v) is not HashedObject or len(v.entries) >= b
        if op is OpCode.OBJECT_SIZE_LESS:
            b = inst.bound
            return lambda v: type(v) is not HashedObject or len(v.entries) <= b
        if op is OpCode.PROPERTY_TYPE:
            k, h = inst.key, inst.key_hash
            tcheck = _type_check(inst.type)

            def prop_type(v):
                if type(v) is not HashedObject:
                    return True
                child = v.get_hashed(h, k, _MISS)
                return child is not _MISS and tcheck(child)

            return prop_type

        if op is OpCode.REGEX:
            plan = inst.plan
            kind = plan.kind
            if kind is RegexKind.PREFIX:
                lit = plan.literal
                return lambda v: type(v) is not str or v.startswith(lit)
            if kind is RegexKind.SUFFIX:
                lit = plan.literal
                return lambda v: type(v) is not str or v.endswith(lit)
            if kind is RegexKind.EXACT:
                lit = plan.literal
                return lambda v: type(v) is not str or v == lit
            if kind is RegexKind.CONTAINS:
                lit = plan.literal
                return lambda v: type(v) is not str or lit in v
            if kind is RegexKind.NON_EMPTY:
                return lambda v: type(v) is not str or len(v) >= 1
            if kind is RegexKind.LENGTH_RANGE:
                lo, hi = plan.min_len, plan.max_len
                if hi is None:
                    return lambda v: type(v) is not str or len(v) >= lo
                return lambda v: type(v) is not str or lo <= len(v) <= hi
            if kind is RegexKind.ALL:
                return lambda v: True
            from .regex_opt import _engine

            rx = _engine(plan.source)
            return lambda v: type(v) is not str or rx.search(v) is not None
        if op is OpCode.STRING_SIZE_GREATER:
            b = inst.bound
            return lambda v: type(v) is not str or len(v) >= b
        if op is OpCode.STRING_SIZE_LESS:
            b = inst.bound
            return lambda v: type(v) is not str or len(v) <= b
        if op is OpCode.STRING_BOUNDS:
            lo, hi = inst.min_len, inst.max_len
            if hi is None:
                return lambda v: type(v) is not str or len(v) >= lo
            return lambda v: type(v) is not str or lo <= len(v) <= hi
        if op is OpCode.STRING_TYPE:
            from .executor import _check_format

            fmt = inst.format
            return lambda v: type(v) is not str or _check_format(fmt, v)

        if op is OpCode.UNIQUE:

            def unique(v):
                if type(v) is not list:
                    return True
                seen = set()
                for item in v:
                    c = canonical(item)
                    if c in seen:
                        return False
                    seen.add(c)
                return True

            return unique
        if op is OpCode.ARRAY_SIZE_GREATER:
            b = inst.bound
            return lambda v: type(v) is not list or len(v) >= b
        if op is OpCode.ARRAY_SIZE_LESS:
            b = inst.bound
            return lambda v: type(v) is not list or len(v) <= b
        if op is OpCode.ARRAY_BOUNDS:
            lo, hi = inst.min_len, inst.max_len
            if hi is None:
                return lambda v: type(v) is not list or len(v) >= lo
            return lambda v: type(v) is not list or lo <= len(v) <= hi

        if op is OpCode.GREATER:
            b = inst.bound
            return lambda v: (type(v) is not int and type(v) is not float) or v > b
        if op is OpCode.GREATER_EQUAL:
            b = inst.bound
            return lambda v: (type(v) is not int and type(v) is not float) or v >= b
        if op is OpCode.LESS:
            b = inst.bound
            return lambda v: (type(v) is not int and type(v) is not float) or v < b
        if op is OpCode.LESS_EQUAL:
            b = inst.bound
            return lambda v: (type(v) is not int and type(v) is not float) or v <= b
        if op is OpCode.NUMBER_BOUNDS:
            lo, lo_x, hi, hi_x = inst.lo, inst.lo_exclusive, inst.hi, inst.hi_exclusive

            def bounds(v):
                t = type(v)
                if t is not int and t is not float:
                    return True
                if lo is not None:
                    if lo_x:
                        if not v > lo:
                            return False
                    elif not v >= lo:
                        return False
                if hi is not None:
                    if hi_x:
                        if not v < hi:
                            return False
                    elif not v <= hi:
                        return False
                return True

            return bounds
        if op is OpCode.DIVISIBLE:
            d = inst.divisor
            from .executor import _divisible as _div

            def divisible(v):
                t = type(v)
                if t is not int and t is not float:
                    return True
                # shared spec-exact check (decimal re-check on inexact
                # float quotients) -- keeps codegen == interpreter
                return _div(v, d)

            return divisible

        # ---- loops -----------------------------------------------------------
        if op is OpCode.LOOP_KEYS:
            child = self.group(inst.children)

            def loop_keys(v):
                if type(v) is not HashedObject:
                    return True
                for _, key, _val in v.entries:
                    if not child(key):
                        return False
                return True

            return loop_keys
        if op is OpCode.LOOP_PROPERTIES:
            child = self.group(inst.children)

            def loop_props(v):
                if type(v) is not HashedObject:
                    return True
                for _, _, val in v.entries:
                    if not child(val):
                        return False
                return True

            return loop_props
        if op is OpCode.LOOP_PROPERTIES_EXCEPT:
            child = self.group(inst.children)
            excl: Dict[int, List[str]] = {}
            for k, h in zip(inst.exclude_keys, inst.exclude_hashes):
                excl.setdefault(h, []).append(k)
            plans = inst.exclude_patterns

            def loop_except(v):
                if type(v) is not HashedObject:
                    return True
                for h, key, val in v.entries:
                    cands = excl.get(h)
                    if cands is not None and (is_short_hash(h) or key in cands):
                        continue
                    if plans and any(p.matches(key) for p in plans):
                        continue
                    if not child(val):
                        return False
                return True

            return loop_except
        if op is OpCode.LOOP_PROPERTIES_REGEX:
            child = self.group(inst.children)
            plan = inst.plan

            def loop_regex(v):
                if type(v) is not HashedObject:
                    return True
                for _, key, val in v.entries:
                    if plan.matches(key) and not child(val):
                        return False
                return True

            return loop_regex
        if op in (OpCode.LOOP_PROPERTIES_MATCH, OpCode.LOOP_PROPERTIES_MATCH_CLOSED):
            table: Dict[int, List[Tuple[str, Check]]] = {}
            for key, h, grp in inst.matches:
                table.setdefault(h, []).append((key, self.group(grp)))
            closed = op is OpCode.LOOP_PROPERTIES_MATCH_CLOSED
            plans = getattr(inst, "tolerate_patterns", ())

            def loop_match(v):
                if type(v) is not HashedObject:
                    return True
                for h, key, val in v.entries:
                    cands = table.get(h)
                    fn = None
                    if cands is not None:
                        if is_short_hash(h):
                            fn = cands[0][1]
                        else:
                            for k2, f2 in cands:
                                if k2 == key:
                                    fn = f2
                                    break
                    if fn is None:
                        if closed:
                            if plans and any(p.matches(key) for p in plans):
                                continue
                            return False
                        continue
                    if not fn(val):
                        return False
                return True

            return loop_match
        if op is OpCode.LOOP_ITEMS:
            child = self.group(inst.children)

            def loop_items(v):
                if type(v) is not list:
                    return True
                for item in v:
                    if not child(item):
                        return False
                return True

            return loop_items
        if op is OpCode.LOOP_ITEMS_FROM:
            child = self.group(inst.children)
            start = inst.start

            def loop_items_from(v):
                if type(v) is not list:
                    return True
                for i in range(start, len(v)):
                    if not child(v[i]):
                        return False
                return True

            return loop_items_from
        if op is OpCode.LOOP_CONTAINS:
            child = self.group(inst.children)
            lo, hi = inst.min_count, inst.max_count

            def loop_contains(v):
                if type(v) is not list:
                    return True
                count = 0
                for item in v:
                    if child(item):
                        count += 1
                        if hi is not None and count > hi:
                            return False
                        if hi is None and count >= lo:
                            return True
                return count >= lo and (hi is None or count <= hi)

            return loop_contains
        if op is OpCode.ARRAY_PREFIX:
            groups = tuple(self.group(g) for g in inst.groups)

            def array_prefix(v):
                if type(v) is not list:
                    return True
                for i, fn in enumerate(groups):
                    if i >= len(v):
                        break
                    if not fn(v[i]):
                        return False
                return True

            return array_prefix
        if op is OpCode.LOOP_UNEVALUATED_PROPERTIES:
            child = self.group(inst.children)
            static_keys = frozenset(inst.static_keys)
            static_plans = inst.static_patterns
            branches = tuple(
                (self.group(guard), frozenset(keys), pats, sees_all)
                for guard, keys, _h, pats, sees_all in inst.branches
            )

            def uneval_props(v):
                if type(v) is not HashedObject:
                    return True
                names = set(static_keys)
                plans = list(static_plans)
                for guard, keys, pats, sees_all in branches:
                    if guard(v):
                        if sees_all:
                            return True
                        names |= keys
                        plans.extend(pats)
                for _, key, val in v.entries:
                    if key in names or any(p.matches(key) for p in plans):
                        continue
                    if not child(val):
                        return False
                return True

            return uneval_props
        if op is OpCode.LOOP_UNEVALUATED_ITEMS:
            child = self.group(inst.children)
            branches = tuple(
                (self.group(guard), prefix, sees_all)
                for guard, prefix, sees_all in inst.branches
            )
            contains = tuple(
                (self.group(guard) if guard else None, self.group(group))
                for guard, group in inst.contains_groups
            )
            static_prefix = inst.static_prefix

            def uneval_items(v):
                if type(v) is not list:
                    return True
                prefix = static_prefix
                for guard, bp, sees_all in branches:
                    if guard(v):
                        if sees_all:
                            return True
                        prefix = max(prefix, bp)
                # branch-gated contains annotations (guard None = unconditional)
                active = [g for guard, g in contains if guard is None or guard(v)]
                for i in range(prefix, len(v)):
                    item = v[i]
                    if active and any(g(item) for g in active):
                        continue
                    if not child(item):
                        return False
                return True

            return uneval_items

        # ---- logical -----------------------------------------------------------
        if op is OpCode.AND:
            return self.group(inst.children)
        if op is OpCode.OR:
            groups = tuple(self.group(g) for g in inst.groups)

            def logical_or(v):
                for fn in groups:
                    if fn(v):
                        return True
                return False

            return logical_or
        if op is OpCode.XOR:
            groups = tuple(self.group(g) for g in inst.groups)

            def logical_xor(v):
                passed = 0
                for fn in groups:
                    if fn(v):
                        passed += 1
                        if passed > 1:
                            return False
                return passed == 1

            return logical_xor
        if op is OpCode.NOT:
            child = self.group(inst.children)
            return lambda v: not child(v)
        if op is OpCode.CONDITION:
            cond = self.group(inst.condition)
            then_fn = self.group(inst.then_children)
            else_fn = self.group(inst.else_children)
            return lambda v: then_fn(v) if cond(v) else else_fn(v)
        if op is OpCode.WHEN_TYPE:
            tcheck = _type_check(inst.type)
            child = self.group(inst.children)
            return lambda v: child(v) if tcheck(v) else True
        if op is OpCode.WHEN_DEFINES:
            k, h = inst.key, inst.key_hash
            child = self.group(inst.children)
            return (
                lambda v: child(v)
                if type(v) is HashedObject and v.get_hashed(h, k, _MISS) is not _MISS
                else True
            )
        if op is OpCode.WHEN_ARRAY_SIZE_GREATER:
            b = inst.bound
            child = self.group(inst.children)
            return lambda v: child(v) if type(v) is list and len(v) > b else True
        if op is OpCode.WHEN_ARRAY_SIZE_EQUAL:
            b = inst.bound
            child = self.group(inst.children)
            return lambda v: child(v) if type(v) is list and len(v) == b else True

        # ---- control -------------------------------------------------------------
        if op is OpCode.CONTROL_LABEL:
            fn = self.group(inst.children)
            self.labels[inst.label] = fn
            return fn
        if op is OpCode.CONTROL_JUMP:
            labels = self.labels
            label = inst.label
            return lambda v: labels[label](v)

        raise AssertionError(f"codegen: unhandled opcode {op!r}")


def compile_to_callable(compiled: CompiledSchema) -> Check:
    """Compile a CompiledSchema into a single specialised closure."""
    gen = _Codegen(compiled)
    # labels referenced by jumps may be registered during group compilation;
    # compile label bodies first so forward jumps resolve
    for label, group in compiled.labels.items():
        if label not in gen.labels:
            gen.labels[label] = gen.group(group)
    return gen.group(compiled.instructions)
