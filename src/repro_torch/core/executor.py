"""The Blaze execution engine (paper §5) -- sequential, fail-fast.

The executor drives a loop over compiled instructions.  Per instruction it

1. resolves the target value via the instruction's *relative* instance
   location (absent target => the instruction is skipped, vacuously true);
2. checks the instruction's type *precondition* (wrong type => skipped --
   "validation does NOT fail if the precondition for an instruction is not
   met", §5.2);
3. evaluates the assertion / recurses into subinstructions, short-circuiting
   on the first failure (§2.3).

Evaluation state (label table, scratch) lives in a preallocated
:class:`EvalContext` reused across validations (§4.5 -- "we optimize for the
case of repeated evaluations of the same schema by preallocating a data
structure that can be reused for multiple validations").

``use_hashing=False`` switches property matching to raw string comparison
for the §6.2.3 hash ablation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .compiler import CompiledSchema
from .doc_model import (
    HashedObject,
    canonical,
    has_type,
    json_equal,
    parse_document,
)
from .instructions import Instruction, Instructions, OpCode
from .json_pointer import MISSING, get_instance
from .outcomes import DocumentDepthError, ValidationBudget, ValidationTimeout

__all__ = ["Validator", "EvalContext"]


class EvalContext:
    """Preallocated, reusable evaluation state (§4.5)."""

    __slots__ = (
        "labels",
        "use_hashing",
        "_match_cache",
        "_path_cache",
        "trace",
        "budget",
    )

    def __init__(self, labels: Dict[int, Instructions], use_hashing: bool = True):
        self.labels = labels
        self.use_hashing = use_hashing
        # per-instruction lazily built lookup tables (hash -> candidates);
        # lives for the lifetime of the validator, i.e. built once per
        # compiled schema, amortised across documents.
        self._match_cache: Dict[int, Dict] = {}
        # rel_path with schema-side key hashes precomputed: hashing happens
        # at compile/parse time, never during validation (§4.1)
        self._path_cache: Dict[int, tuple] = {}
        # failure trace (paper §8 "helpful error messages" option): None on
        # the hot path; a list during Validator.explain()
        self.trace = None
        # fallback deadline/step budget (DESIGN.md §11): None on the hot
        # path; a ValidationBudget during Validator.is_valid_bounded()
        self.budget = None


def _cached_path(inst: Instruction, ctx: "EvalContext") -> tuple:
    path = ctx._path_cache.get(id(inst))
    if path is None:
        from .hashing import shash

        path = tuple(
            (tok, shash(tok)) if isinstance(tok, str) else tok
            for tok in inst.rel_path
        )
        ctx._path_cache[id(inst)] = path
    return path


def _resolve(value: Any, path: tuple) -> Any:
    """Hash-accelerated relative instance resolution."""
    node = value
    for tok in path:
        if type(tok) is tuple:
            if not isinstance(node, HashedObject):
                return MISSING
            node = node.get_hashed(tok[1], tok[0], MISSING)
            if node is MISSING:
                return MISSING
        else:
            if not isinstance(node, list) or not 0 <= tok < len(node):
                return MISSING
            node = node[tok]
    return node


class Validator:
    """Executes a :class:`CompiledSchema` against parsed documents.

    ``engine="interpreter"`` is the paper-faithful instruction interpreter
    (§5); ``engine="codegen"`` is the beyond-paper closure compiler
    (core/codegen.py, the paper's §8 future work).
    """

    def __init__(
        self,
        compiled: CompiledSchema,
        *,
        use_hashing: bool = True,
        engine: str = "interpreter",
    ):
        self.compiled = compiled
        self.engine = engine
        self.ctx = EvalContext(compiled.labels, use_hashing=use_hashing)
        self._fn = None
        if engine == "codegen":
            from .codegen import compile_to_callable

            self._fn = compile_to_callable(compiled)

    # -- public API ----------------------------------------------------------

    def is_valid(self, document: Any, *, parsed: bool = False) -> bool:
        """Validate a document (a plain parsed-JSON value by default).

        Deeply nested documents raise a structured
        :class:`~repro.core.outcomes.DocumentDepthError` instead of an
        interpreter ``RecursionError`` (the same explicit bound the naive
        interpreter enforces at ``core/interpreter.py``) -- callers on
        the serving path convert it into a reject-with-reason.
        """
        try:
            doc = document if parsed else parse_document(document)
            if self._fn is not None:
                return self._fn(doc)
            return _eval_group(self.compiled.instructions, doc, self.ctx)
        except RecursionError:
            raise DocumentDepthError(
                "document nesting exceeds the evaluation stack"
            ) from None

    # paper terminology alias
    validate = is_valid

    def is_valid_bounded(
        self, document: Any, *, budget: ValidationBudget, parsed: bool = False
    ) -> bool:
        """Deadline/step-bounded validation for the fallback oracle.

        Raises :class:`~repro.core.outcomes.ValidationTimeout` when the
        document exhausts the budget's instruction steps, evaluation
        depth, or wall-clock deadline, and
        :class:`~repro.core.outcomes.DocumentDepthError` when parsing
        itself over-recurses -- depth bombs and pathological ``pattern``
        backtracking become structured rejects instead of a stalled
        engine.  Always runs the instruction interpreter: the codegen
        closures are the unmetered hot path, by design.
        """
        budget.check_deadline()
        try:
            doc = document if parsed else parse_document(document)
        except RecursionError:
            raise DocumentDepthError(
                "document nesting exceeds the parse stack"
            ) from None
        self.ctx.budget = budget
        try:
            return _eval_group(self.compiled.instructions, doc, self.ctx)
        except RecursionError:
            raise ValidationTimeout(
                "evaluation recursion exceeded the interpreter stack"
            ) from None
        finally:
            self.ctx.budget = None

    def explain(self, document: Any, *, parsed: bool = False):
        """Diagnostic validation (paper §8's error-message option).

        Returns (valid, trace) where ``trace`` is the failure chain of
        (schema keyword location, instruction name) pairs, innermost
        first.  Inside disjunctions the trace includes the failing
        candidates of every attempted branch -- exploratory entries are a
        feature for schema debugging, not an error.  Runs the interpreter
        engine regardless of the configured engine (the codegen closures
        do not carry locations, by design -- they are the hot path).
        """
        doc = document if parsed else parse_document(document)
        self.ctx.trace = []
        try:
            ok = _eval_group(self.compiled.instructions, doc, self.ctx)
            return ok, list(self.ctx.trace)
        finally:
            self.ctx.trace = None


# ---------------------------------------------------------------------------
# Core evaluation loop
# ---------------------------------------------------------------------------


def _eval_group(instructions: Instructions, value: Any, ctx: EvalContext) -> bool:
    """AND over a group; the loop terminates early on first failure (§5.1)."""
    budget = ctx.budget
    if budget is not None:
        # bounded fallback (DESIGN.md §11): meter instructions and bound
        # the evaluation recursion explicitly -- the clean path pays only
        # the None check above
        budget.enter_group()
        try:
            for inst in instructions:
                budget.tick()
                if not _eval_one(inst, value, ctx):
                    if ctx.trace is not None and inst.schema_path:
                        ctx.trace.append((inst.schema_path, type(inst).__name__))
                    return False
            return True
        finally:
            budget.exit_group()
    for inst in instructions:
        if not _eval_one(inst, value, ctx):
            if ctx.trace is not None and inst.schema_path:
                ctx.trace.append((inst.schema_path, type(inst).__name__))
            return False
    return True


def _eval_one(inst: Instruction, value: Any, ctx: EvalContext) -> bool:
    if inst.rel_path:
        target = _resolve(value, _cached_path(inst, ctx))
        if target is MISSING:
            return True  # absent location: skip (requiredness is Defines' job)
    else:
        target = value
    op = inst.op

    # ----- universal assertions ---------------------------------------------
    if op is OpCode.FAIL:
        return False
    if op is OpCode.TYPE:
        return has_type(target, inst.type)
    if op is OpCode.TYPE_ANY:
        return any(has_type(target, t) for t in inst.types)
    if op is OpCode.EQUAL:
        return json_equal(target, inst.value)
    if op is OpCode.EQUALS_ANY:
        return any(json_equal(target, v) for v in inst.values)

    # ----- object assertions (precondition: object) --------------------------
    if op is OpCode.DEFINES:
        if not isinstance(target, HashedObject):
            return True
        return _defines(target, inst.key_hash, inst.key, ctx)
    if op is OpCode.DEFINES_ALL:
        if not isinstance(target, HashedObject):
            return True
        for kh, k in zip(inst.key_hashes, inst.keys):
            if not _defines(target, kh, k, ctx):
                return False
        return True
    if op is OpCode.PROPERTY_DEPENDENCIES:
        if not isinstance(target, HashedObject):
            return True
        for key, kh, deps, dep_hashes in inst.dependencies:
            if _defines(target, kh, key, ctx):
                for dh, d in zip(dep_hashes, deps):
                    if not _defines(target, dh, d, ctx):
                        return False
        return True
    if op is OpCode.OBJECT_SIZE_GREATER:
        if not isinstance(target, HashedObject):
            return True
        return len(target) >= inst.bound
    if op is OpCode.OBJECT_SIZE_LESS:
        if not isinstance(target, HashedObject):
            return True
        return len(target) <= inst.bound
    if op is OpCode.PROPERTY_TYPE:
        if not isinstance(target, HashedObject):
            return True
        child = target.get_hashed(inst.key_hash, inst.key, MISSING)
        return child is not MISSING and has_type(child, inst.type)

    # ----- string assertions (precondition: string) ---------------------------
    if op is OpCode.REGEX:
        if not isinstance(target, str):
            return True
        if ctx.budget is not None and inst.plan.uses_engine:
            # engine regexes cannot be preempted mid-match: gate
            # backtracking-prone patterns / oversized subjects up front
            ctx.budget.regex_gate(inst.plan, len(target))
        return inst.plan.matches(target)
    if op is OpCode.STRING_SIZE_GREATER:
        if not isinstance(target, str):
            return True
        return len(target) >= inst.bound
    if op is OpCode.STRING_SIZE_LESS:
        if not isinstance(target, str):
            return True
        return len(target) <= inst.bound
    if op is OpCode.STRING_BOUNDS:
        if not isinstance(target, str):
            return True
        n = len(target)
        return n >= inst.min_len and (inst.max_len is None or n <= inst.max_len)
    if op is OpCode.STRING_TYPE:
        if not isinstance(target, str):
            return True
        return _check_format(inst.format, target)

    # ----- array assertions (precondition: array) ------------------------------
    if op is OpCode.UNIQUE:
        if not isinstance(target, list):
            return True
        seen = set()
        for item in target:
            c = canonical(item)
            if c in seen:
                return False
            seen.add(c)
        return True
    if op is OpCode.ARRAY_SIZE_GREATER:
        if not isinstance(target, list):
            return True
        return len(target) >= inst.bound
    if op is OpCode.ARRAY_SIZE_LESS:
        if not isinstance(target, list):
            return True
        return len(target) <= inst.bound
    if op is OpCode.ARRAY_BOUNDS:
        if not isinstance(target, list):
            return True
        n = len(target)
        return n >= inst.min_len and (inst.max_len is None or n <= inst.max_len)

    # ----- number assertions (precondition: number) ----------------------------
    if op is OpCode.GREATER:
        if isinstance(target, bool) or not isinstance(target, (int, float)):
            return True
        return target > inst.bound
    if op is OpCode.GREATER_EQUAL:
        if isinstance(target, bool) or not isinstance(target, (int, float)):
            return True
        return target >= inst.bound
    if op is OpCode.LESS:
        if isinstance(target, bool) or not isinstance(target, (int, float)):
            return True
        return target < inst.bound
    if op is OpCode.LESS_EQUAL:
        if isinstance(target, bool) or not isinstance(target, (int, float)):
            return True
        return target <= inst.bound
    if op is OpCode.NUMBER_BOUNDS:
        if isinstance(target, bool) or not isinstance(target, (int, float)):
            return True
        if inst.lo is not None:
            if inst.lo_exclusive:
                if not target > inst.lo:
                    return False
            elif not target >= inst.lo:
                return False
        if inst.hi is not None:
            if inst.hi_exclusive:
                if not target < inst.hi:
                    return False
            elif not target <= inst.hi:
                return False
        return True
    if op is OpCode.DIVISIBLE:
        if isinstance(target, bool) or not isinstance(target, (int, float)):
            return True
        return _divisible(target, inst.divisor)

    # ----- loops ------------------------------------------------------------
    if op is OpCode.LOOP_KEYS:
        if not isinstance(target, HashedObject):
            return True
        for _, key, _v in target.entries:
            if not _eval_group(inst.children, key, ctx):
                return False
        return True
    if op is OpCode.LOOP_PROPERTIES:
        if not isinstance(target, HashedObject):
            return True
        for _, _, v in target.entries:
            if not _eval_group(inst.children, v, ctx):
                return False
        return True
    if op is OpCode.LOOP_PROPERTIES_EXCEPT:
        if not isinstance(target, HashedObject):
            return True
        table = _except_table(inst, ctx)
        for h, key, v in target.entries:
            if _matches_static(table, h, key, ctx) or any(
                p.matches(key) for p in inst.exclude_patterns
            ):
                continue
            if not _eval_group(inst.children, v, ctx):
                return False
        return True
    if op is OpCode.LOOP_PROPERTIES_REGEX:
        if not isinstance(target, HashedObject):
            return True
        for _, key, v in target.entries:
            if inst.plan.matches(key) and not _eval_group(inst.children, v, ctx):
                return False
        return True
    if op is OpCode.LOOP_PROPERTIES_MATCH:
        if not isinstance(target, HashedObject):
            return True
        table = _match_table(inst, ctx)
        for h, key, v in target.entries:
            group = _lookup_match(table, h, key, ctx)
            if group is not None and not _eval_group(group, v, ctx):
                return False
        return True
    if op is OpCode.LOOP_PROPERTIES_MATCH_CLOSED:
        if not isinstance(target, HashedObject):
            return True
        table = _match_table(inst, ctx)
        for h, key, v in target.entries:
            group = _lookup_match(table, h, key, ctx)
            if group is None:
                # tolerated when a patternProperties pattern matches
                if any(p.matches(key) for p in inst.tolerate_patterns):
                    continue
                return False  # closed object: unknown property (§5.2)
            if not _eval_group(group, v, ctx):
                return False
        return True
    if op is OpCode.LOOP_ITEMS:
        if not isinstance(target, list):
            return True
        for item in target:
            if not _eval_group(inst.children, item, ctx):
                return False
        return True
    if op is OpCode.LOOP_ITEMS_FROM:
        if not isinstance(target, list):
            return True
        for i in range(inst.start, len(target)):
            if not _eval_group(inst.children, target[i], ctx):
                return False
        return True
    if op is OpCode.LOOP_CONTAINS:
        if not isinstance(target, list):
            return True
        count = 0
        max_c = inst.max_count
        for item in target:
            if _eval_group(inst.children, item, ctx):
                count += 1
                if max_c is not None and count > max_c:
                    return False  # early exit: already over the max
                if max_c is None and count >= inst.min_count:
                    return True  # early exit: satisfied, no upper bound
        return count >= inst.min_count and (max_c is None or count <= max_c)
    if op is OpCode.ARRAY_PREFIX:
        if not isinstance(target, list):
            return True
        for i, group in enumerate(inst.groups):
            if i >= len(target):
                break
            if not _eval_group(group, target[i], ctx):
                return False
        return True
    if op is OpCode.LOOP_UNEVALUATED_PROPERTIES:
        if not isinstance(target, HashedObject):
            return True
        return _eval_unevaluated_properties(inst, target, ctx)
    if op is OpCode.LOOP_UNEVALUATED_ITEMS:
        if not isinstance(target, list):
            return True
        return _eval_unevaluated_items(inst, target, ctx)

    # ----- logical ------------------------------------------------------------
    if op is OpCode.AND:
        return _eval_group(inst.children, target, ctx)
    if op is OpCode.OR:
        for group in inst.groups:
            if _eval_group(group, target, ctx):
                return True  # short-circuit on first success (§2.3)
        return False
    if op is OpCode.XOR:
        passed = 0
        for group in inst.groups:
            if _eval_group(group, target, ctx):
                passed += 1
                if passed > 1:
                    return False  # short-circuit: a second success decides
        return passed == 1
    if op is OpCode.NOT:
        return not _eval_group(inst.children, target, ctx)
    if op is OpCode.CONDITION:
        if _eval_group(inst.condition, target, ctx):
            return _eval_group(inst.then_children, target, ctx)
        return _eval_group(inst.else_children, target, ctx)
    if op is OpCode.WHEN_TYPE:
        if has_type(target, inst.type):
            return _eval_group(inst.children, target, ctx)
        return True
    if op is OpCode.WHEN_DEFINES:
        if isinstance(target, HashedObject) and _defines(target, inst.key_hash, inst.key, ctx):
            return _eval_group(inst.children, target, ctx)
        return True
    if op is OpCode.WHEN_ARRAY_SIZE_GREATER:
        if isinstance(target, list) and len(target) > inst.bound:
            return _eval_group(inst.children, target, ctx)
        return True
    if op is OpCode.WHEN_ARRAY_SIZE_EQUAL:
        if isinstance(target, list) and len(target) == inst.bound:
            return _eval_group(inst.children, target, ctx)
        return True

    # ----- control --------------------------------------------------------------
    if op is OpCode.CONTROL_LABEL:
        return _eval_group(inst.children, target, ctx)
    if op is OpCode.CONTROL_JUMP:
        return _eval_group(ctx.labels[inst.label], target, ctx)

    raise AssertionError(f"unhandled opcode {op!r}")


# ---------------------------------------------------------------------------
# Property matching helpers (hash fast path + string-compare ablation)
# ---------------------------------------------------------------------------


def _defines(obj: HashedObject, key_hash: int, key: str, ctx: EvalContext) -> bool:
    if ctx.use_hashing:
        return obj.defines_hashed(key_hash, key)
    return any(k == key for _, k, _ in obj.entries)


def _match_table(inst, ctx: EvalContext):
    """hash -> [(key, group)] built once per compiled instruction (§4.5)."""
    table = ctx._match_cache.get(id(inst))
    if table is None:
        if ctx.use_hashing:
            table = {}
            for key, h, group in inst.matches:
                table.setdefault(h, []).append((key, group))
        else:
            table = {key: group for key, _, group in inst.matches}
        ctx._match_cache[id(inst)] = table
    return table


def _lookup_match(table, h: int, key: str, ctx: EvalContext):
    from .hashing import is_short_hash

    if ctx.use_hashing:
        candidates = table.get(h)
        if not candidates:
            return None
        if is_short_hash(h):
            return candidates[0][1]  # perfect hash: no string compare (§4.1)
        for k, group in candidates:
            if k == key:
                return group
        return None
    return table.get(key)


def _except_table(inst, ctx: EvalContext):
    table = ctx._match_cache.get(id(inst))
    if table is None:
        if ctx.use_hashing:
            table = {}
            for key, h in zip(inst.exclude_keys, inst.exclude_hashes):
                table.setdefault(h, []).append(key)
        else:
            table = set(inst.exclude_keys)
        ctx._match_cache[id(inst)] = table
    return table


def _matches_static(table, h: int, key: str, ctx: EvalContext) -> bool:
    from .hashing import is_short_hash

    if ctx.use_hashing:
        candidates = table.get(h)
        if not candidates:
            return False
        if is_short_hash(h):
            return True
        return any(k == key for k in candidates)
    return key in table


# ---------------------------------------------------------------------------
# unevaluated* dynamic residues
# ---------------------------------------------------------------------------


def _eval_unevaluated_properties(inst, target: HashedObject, ctx: EvalContext) -> bool:
    names = set(inst.static_keys)
    patterns = list(inst.static_patterns)
    for guard, keys, _hashes, pats, sees_all in inst.branches:
        if _eval_group(guard, target, ctx):
            if sees_all:
                return True  # a validating branch evaluates everything
            names.update(keys)
            patterns.extend(pats)
    for _, key, v in target.entries:
        if key in names or any(p.matches(key) for p in patterns):
            continue
        if not _eval_group(inst.children, v, ctx):
            return False
    return True


def _eval_unevaluated_items(inst, target: list, ctx: EvalContext) -> bool:
    prefix = inst.static_prefix
    for guard, br_prefix, sees_all in inst.branches:
        if _eval_group(guard, target, ctx):
            if sees_all:
                return True
            prefix = max(prefix, br_prefix)
    # contains annotations apply only when their branch guard validates --
    # a contains inside a FAILED anyOf branch annotates nothing
    active_contains = [
        group
        for guard, group in inst.contains_groups
        if not guard or _eval_group(guard, target, ctx)
    ]
    for i in range(prefix, len(target)):
        item = target[i]
        if active_contains and any(
            _eval_group(g, item, ctx) for g in active_contains
        ):
            continue  # evaluated by contains (2020-12 annotation semantics)
        if not _eval_group(inst.children, item, ctx):
            return False
    return True


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def _divisible(value: float, divisor: float) -> bool:
    """Spec-exact ``multipleOf``.

    JSON numbers are decimal: ``19.99`` IS a multiple of ``0.01`` even
    though neither has an exact binary-float form and the float quotient
    comes out 1998.9999...  The float fast path decides the common case;
    inexact quotients are re-checked as exact rationals built from the
    shortest decimal representation (``repr`` round-trips floats, so
    this is the number the document actually wrote).
    """
    if divisor == 0:
        return False
    try:
        quotient = value / divisor
    except OverflowError:
        return False
    if quotient != quotient or quotient in (float("inf"), float("-inf")):
        return False
    # fast path only while floats still resolve integrality: at
    # |quotient| >= 2^53 every float is integral, so "looks integral"
    # proves nothing (1e30 is NOT a multiple of 7)
    if quotient == int(quotient) and abs(quotient) < 2.0**53:
        return True
    from fractions import Fraction

    try:
        return Fraction(repr(value)) % Fraction(repr(divisor)) == 0
    except (ValueError, ZeroDivisionError, OverflowError):
        return False


_FORMAT_CHECKS = {}


def _check_format(name: str, value: str) -> bool:
    """Light-weight `format` assertions (StringType, Table 1)."""
    import re as _re

    checks = _FORMAT_CHECKS
    if not checks:
        checks["uuid"] = _re.compile(
            r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$"
        )
        checks["date"] = _re.compile(r"^\d{4}-\d{2}-\d{2}$")
        checks["date-time"] = _re.compile(
            r"^\d{4}-\d{2}-\d{2}[Tt]\d{2}:\d{2}:\d{2}(\.\d+)?([Zz]|[+-]\d{2}:\d{2})$"
        )
        checks["email"] = _re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")
        checks["ipv4"] = _re.compile(
            r"^((25[0-5]|2[0-4]\d|1\d\d|[1-9]?\d)\.){3}(25[0-5]|2[0-4]\d|1\d\d|[1-9]?\d)$"
        )
        checks["uri"] = _re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*:")
    rx = checks.get(name)
    return True if rx is None else rx.match(value) is not None
