"""The Blaze schema-validation DSL (paper §2).

Instructions are the compilation target for JSON Schema keywords.  Each
instruction carries:

* ``rel_path`` -- the instance location it applies to, *relative to its
  parent instruction* (§5.1);
* ``schema_path`` -- the keyword location in the source schema (error
  reporting / debugging only, never consulted during validation);
* instruction-specific operands.

Type *preconditions* are intrinsic to the instruction class: e.g.
``AssertionGreaterEqual`` silently passes for non-numeric targets, matching
the semantics of ``minimum``.  By convention instruction names start
uppercase while JSON Schema keywords are lowercase (§2).

The set below covers §2.1-2.5: basic assertions (Table 1), the five
property-loop variants + two item-loop variants + key loop + contains,
short-circuiting logical combinators, ControlLabel/ControlJump, and the
CISC-style fused variants (StringBounds / singleton Equals / Table 2
``When*`` conditions).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum, auto
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .json_pointer import InstancePath
from .regex_opt import RegexPlan

Instructions = Tuple["Instruction", ...]


class OpCode(IntEnum):
    """Stable opcode numbering shared with the tensorised tape (tape.py)."""

    # -- assertions: universal ------------------------------------------------
    FAIL = 0
    TYPE = auto()
    TYPE_ANY = auto()
    EQUAL = auto()
    EQUALS_ANY = auto()
    # -- assertions: object ---------------------------------------------------
    DEFINES = auto()
    DEFINES_ALL = auto()
    PROPERTY_DEPENDENCIES = auto()
    OBJECT_SIZE_GREATER = auto()
    OBJECT_SIZE_LESS = auto()
    PROPERTY_TYPE = auto()
    # -- assertions: string ---------------------------------------------------
    REGEX = auto()
    STRING_SIZE_GREATER = auto()
    STRING_SIZE_LESS = auto()
    STRING_BOUNDS = auto()
    STRING_TYPE = auto()
    # -- assertions: array ----------------------------------------------------
    UNIQUE = auto()
    ARRAY_SIZE_GREATER = auto()
    ARRAY_SIZE_LESS = auto()
    ARRAY_BOUNDS = auto()
    # -- assertions: number ---------------------------------------------------
    GREATER = auto()
    GREATER_EQUAL = auto()
    LESS = auto()
    LESS_EQUAL = auto()
    NUMBER_BOUNDS = auto()
    DIVISIBLE = auto()
    # -- loops ----------------------------------------------------------------
    LOOP_KEYS = auto()
    LOOP_PROPERTIES = auto()
    LOOP_PROPERTIES_EXCEPT = auto()
    LOOP_PROPERTIES_REGEX = auto()
    LOOP_PROPERTIES_MATCH = auto()
    LOOP_PROPERTIES_MATCH_CLOSED = auto()
    LOOP_ITEMS = auto()
    LOOP_ITEMS_FROM = auto()
    LOOP_CONTAINS = auto()
    ARRAY_PREFIX = auto()
    LOOP_UNEVALUATED_PROPERTIES = auto()
    LOOP_UNEVALUATED_ITEMS = auto()
    # -- logical ----------------------------------------------------------------
    AND = auto()
    OR = auto()
    XOR = auto()
    NOT = auto()
    CONDITION = auto()
    WHEN_TYPE = auto()
    WHEN_DEFINES = auto()
    WHEN_ARRAY_SIZE_GREATER = auto()
    WHEN_ARRAY_SIZE_EQUAL = auto()
    # -- control ----------------------------------------------------------------
    CONTROL_LABEL = auto()
    CONTROL_JUMP = auto()


# JSON type lattice.  "integer" is a refinement of "number"; per 2020-12 a
# float with zero fraction *is* an integer.
JSON_TYPES = ("null", "boolean", "object", "array", "number", "string", "integer")


@dataclass(frozen=True, slots=True)
class Instruction:
    rel_path: InstancePath = ()
    schema_path: str = ""

    op: OpCode = field(default=OpCode.FAIL, init=False, repr=False)

    def children_groups(self) -> Sequence[Instructions]:
        """All nested instruction sequences (for traversal/serialization)."""
        return ()

    def cost(self) -> int:
        """Static cost estimate used by §4.4 instruction reordering."""
        return 1 + sum(c.cost() for grp in self.children_groups() for c in grp)


# ---------------------------------------------------------------------------
# Universal assertions
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class AssertionFail(Instruction):
    """Unconditional failure -- the ``false`` schema."""

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.FAIL)


@dataclass(frozen=True, slots=True)
class AssertionType(Instruction):
    """Value must have exactly this JSON type (singleton CISC variant)."""

    type: str = "null"

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.TYPE)


@dataclass(frozen=True, slots=True)
class AssertionTypeAny(Instruction):
    """Value must have one of the given JSON types."""

    types: Tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.TYPE_ANY)


@dataclass(frozen=True, slots=True)
class AssertionEqual(Instruction):
    """Value equals a single constant (CISC variant of EqualsAny, §2.5)."""

    value: Any = None

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.EQUAL)


@dataclass(frozen=True, slots=True)
class AssertionEqualsAny(Instruction):
    """Value is one of a list of constants (``enum``)."""

    values: Tuple[Any, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.EQUALS_ANY)

    def cost(self) -> int:
        return 1 + len(self.values) // 4


# ---------------------------------------------------------------------------
# Object assertions (precondition: target is an object)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class AssertionDefines(Instruction):
    """Object defines a specific property (singleton ``required``)."""

    key: str = ""
    key_hash: int = 0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.DEFINES)


@dataclass(frozen=True, slots=True)
class AssertionDefinesAll(Instruction):
    """Object defines all listed properties (``required``)."""

    keys: Tuple[str, ...] = ()
    key_hashes: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.DEFINES_ALL)

    def cost(self) -> int:
        return 1 + len(self.keys) // 2


@dataclass(frozen=True, slots=True)
class AssertionPropertyDependencies(Instruction):
    """If a property exists, other properties must exist too
    (``dependentRequired`` / array-form ``dependencies``)."""

    # key -> (required keys, their hashes)
    dependencies: Tuple[Tuple[str, int, Tuple[str, ...], Tuple[int, ...]], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.PROPERTY_DEPENDENCIES)


@dataclass(frozen=True, slots=True)
class AssertionObjectSizeGreater(Instruction):
    """Object has at least ``bound`` properties (``minProperties``)."""

    bound: int = 0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.OBJECT_SIZE_GREATER)


@dataclass(frozen=True, slots=True)
class AssertionObjectSizeLess(Instruction):
    """Object has at most ``bound`` properties (``maxProperties``)."""

    bound: int = 0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.OBJECT_SIZE_LESS)


@dataclass(frozen=True, slots=True)
class AssertionPropertyType(Instruction):
    """Fused Defines+child-Type: object property has a specific type
    (Table 1 ``PropertyType``).  Property absent => pass."""

    key: str = ""
    key_hash: int = 0
    type: str = "null"

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.PROPERTY_TYPE)


# ---------------------------------------------------------------------------
# String assertions (precondition: target is a string)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class AssertionRegex(Instruction):
    """String matches a pattern (specialized via RegexPlan, §4.3)."""

    plan: Optional[RegexPlan] = None

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.REGEX)

    def cost(self) -> int:
        return 10 if (self.plan is None or self.plan.uses_engine) else 2


@dataclass(frozen=True, slots=True)
class AssertionStringSizeGreater(Instruction):
    """len(string) >= bound (``minLength``)."""

    bound: int = 0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.STRING_SIZE_GREATER)


@dataclass(frozen=True, slots=True)
class AssertionStringSizeLess(Instruction):
    """len(string) <= bound (``maxLength``)."""

    bound: int = 0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.STRING_SIZE_LESS)


@dataclass(frozen=True, slots=True)
class AssertionStringBounds(Instruction):
    """Fused Type+minLength+maxLength (CISC, §2.5).  Unlike the plain string
    assertions this *requires* the value to be a string."""

    min_len: int = 0
    max_len: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.STRING_BOUNDS)


@dataclass(frozen=True, slots=True)
class AssertionStringType(Instruction):
    """Complex string format (``format`` assertion: uri, uuid, ...)."""

    format: str = ""

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.STRING_TYPE)

    def cost(self) -> int:
        return 8


# ---------------------------------------------------------------------------
# Array assertions (precondition: target is an array)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class AssertionUnique(Instruction):
    """All array elements distinct (``uniqueItems``)."""

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.UNIQUE)

    def cost(self) -> int:
        return 12


@dataclass(frozen=True, slots=True)
class AssertionArraySizeGreater(Instruction):
    bound: int = 0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.ARRAY_SIZE_GREATER)


@dataclass(frozen=True, slots=True)
class AssertionArraySizeLess(Instruction):
    bound: int = 0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.ARRAY_SIZE_LESS)


@dataclass(frozen=True, slots=True)
class AssertionArrayBounds(Instruction):
    """Fused minItems+maxItems."""

    min_len: int = 0
    max_len: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.ARRAY_BOUNDS)


# ---------------------------------------------------------------------------
# Number assertions (precondition: target is a number)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class AssertionGreater(Instruction):
    """value > bound (``exclusiveMinimum``)."""

    bound: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.GREATER)


@dataclass(frozen=True, slots=True)
class AssertionGreaterEqual(Instruction):
    """value >= bound (``minimum``)."""

    bound: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.GREATER_EQUAL)


@dataclass(frozen=True, slots=True)
class AssertionLess(Instruction):
    """value < bound (``exclusiveMaximum``)."""

    bound: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LESS)


@dataclass(frozen=True, slots=True)
class AssertionLessEqual(Instruction):
    """value <= bound (``maximum``)."""

    bound: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LESS_EQUAL)


@dataclass(frozen=True, slots=True)
class AssertionNumberBounds(Instruction):
    """Fused min/max with per-end exclusivity (CISC)."""

    lo: Optional[float] = None
    lo_exclusive: bool = False
    hi: Optional[float] = None
    hi_exclusive: bool = False

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.NUMBER_BOUNDS)


@dataclass(frozen=True, slots=True)
class AssertionDivisible(Instruction):
    """value % divisor == 0 (``multipleOf``)."""

    divisor: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.DIVISIBLE)

    def cost(self) -> int:
        return 3


# ---------------------------------------------------------------------------
# Loops (§2.2)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class LoopKeys(Instruction):
    """Validate every object *key* against child instructions
    (``propertyNames``)."""

    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_KEYS)

    def children_groups(self):
        return (self.children,)

    def cost(self):
        return 4 + sum(c.cost() for c in self.children)


@dataclass(frozen=True, slots=True)
class LoopProperties(Instruction):
    """Validate every property value against one child sequence."""

    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_PROPERTIES)

    def children_groups(self):
        return (self.children,)

    def cost(self):
        return 4 + sum(c.cost() for c in self.children)


@dataclass(frozen=True, slots=True)
class LoopPropertiesExcept(Instruction):
    """Validate property values whose keys match neither the static key set
    nor any exclusion pattern (``additionalProperties`` with adjacent
    ``properties``/``patternProperties``, resolved statically -- §3.2.1)."""

    exclude_keys: Tuple[str, ...] = ()
    exclude_hashes: Tuple[int, ...] = ()
    exclude_patterns: Tuple[RegexPlan, ...] = ()
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_PROPERTIES_EXCEPT)

    def children_groups(self):
        return (self.children,)

    def cost(self):
        return 6 + sum(c.cost() for c in self.children)


@dataclass(frozen=True, slots=True)
class LoopPropertiesRegex(Instruction):
    """Validate property values whose keys match a pattern
    (``patternProperties``)."""

    plan: Optional[RegexPlan] = None
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_PROPERTIES_REGEX)

    def children_groups(self):
        return (self.children,)

    def cost(self):
        return 6 + sum(c.cost() for c in self.children)


@dataclass(frozen=True, slots=True)
class LoopPropertiesMatch(Instruction):
    """Loop over the *instance* and look up per-key instruction groups
    (``properties`` when not unrolled)."""

    # key -> (hash, instruction group applying at the property's value)
    matches: Tuple[Tuple[str, int, Instructions], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_PROPERTIES_MATCH)

    def children_groups(self):
        return tuple(grp for _, _, grp in self.matches)

    def cost(self):
        return 4 + sum(c.cost() for grp in self.children_groups() for c in grp)


@dataclass(frozen=True, slots=True)
class LoopPropertiesMatchClosed(Instruction):
    """As LoopPropertiesMatch but *every* instance key must have a match
    (``additionalProperties: false``)."""

    matches: Tuple[Tuple[str, int, Instructions], ...] = ()
    # keys additionally tolerated via patternProperties (plans)
    tolerate_patterns: Tuple[RegexPlan, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_PROPERTIES_MATCH_CLOSED)

    def children_groups(self):
        return tuple(grp for _, _, grp in self.matches)

    def cost(self):
        return 4 + sum(c.cost() for grp in self.children_groups() for c in grp)


@dataclass(frozen=True, slots=True)
class LoopItems(Instruction):
    """Validate every array item (``items``)."""

    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_ITEMS)

    def children_groups(self):
        return (self.children,)

    def cost(self):
        return 4 + sum(c.cost() for c in self.children)


@dataclass(frozen=True, slots=True)
class LoopItemsFrom(Instruction):
    """Validate array items from index ``start`` (``items`` adjacent to
    ``prefixItems`` -- first-level dependency resolved statically)."""

    start: int = 0
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_ITEMS_FROM)

    def children_groups(self):
        return (self.children,)

    def cost(self):
        return 4 + sum(c.cost() for c in self.children)


@dataclass(frozen=True, slots=True)
class LoopContains(Instruction):
    """Count items matching child instructions; require count within
    [min_count, max_count] (``contains``/``minContains``/``maxContains``)."""

    children: Instructions = ()
    min_count: int = 1
    max_count: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_CONTAINS)

    def children_groups(self):
        return (self.children,)

    def cost(self):
        return 5 + sum(c.cost() for c in self.children)


@dataclass(frozen=True, slots=True)
class ArrayPrefix(Instruction):
    """Validate the i-th item against the i-th instruction group
    (``prefixItems`` / draft-4..7 array-form ``items``)."""

    groups: Tuple[Instructions, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.ARRAY_PREFIX)

    def children_groups(self):
        return self.groups


@dataclass(frozen=True, slots=True)
class LoopUnevaluatedProperties(Instruction):
    """Second-level dependent ``unevaluatedProperties`` (dynamic residue).

    Static analysis (§3.2.2) removes this instruction whenever the evaluated
    set is statically known; the instruction remains only for schemas where
    branch outcomes decide evaluation.  ``branches`` holds
    (guard instructions, names, hashes, patterns, sees_all) tuples: when a
    guard validates, its names/patterns join the evaluated set; sees_all
    marks branches that evaluate *every* property (additionalProperties).
    """

    static_keys: Tuple[str, ...] = ()
    static_hashes: Tuple[int, ...] = ()
    static_patterns: Tuple[RegexPlan, ...] = ()
    branches: Tuple[
        Tuple[Instructions, Tuple[str, ...], Tuple[int, ...], Tuple[RegexPlan, ...], bool],
        ...,
    ] = ()
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_UNEVALUATED_PROPERTIES)

    def children_groups(self):
        groups = [self.children]
        groups.extend(guard for guard, *_ in self.branches)
        return tuple(groups)

    def cost(self):
        return 20 + sum(c.cost() for grp in self.children_groups() for c in grp)


@dataclass(frozen=True, slots=True)
class LoopUnevaluatedItems(Instruction):
    """Second-level dependent ``unevaluatedItems`` (dynamic residue).

    ``branches``: (guard instructions, covered_prefix, covers_all).
    """

    static_prefix: int = 0
    static_all: bool = False
    branches: Tuple[Tuple[Instructions, int, bool], ...] = ()
    # ``contains`` annotations: (branch guard, contains group) pairs.  When
    # the guard validates the whole array (empty guard = unconditional),
    # items matching the group are evaluated.  The guard gating matters:
    # a ``contains`` inside a *failed* anyOf/oneOf branch contributes no
    # annotations (2020-12 annotation semantics).
    contains_groups: Tuple[Tuple[Instructions, Instructions], ...] = ()
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.LOOP_UNEVALUATED_ITEMS)

    def children_groups(self):
        groups = [self.children]
        groups.extend(guard for guard, _, _ in self.branches)
        for guard, group in self.contains_groups:
            groups.append(guard)
            groups.append(group)
        return tuple(groups)

    def cost(self):
        return 20 + sum(c.cost() for grp in self.children_groups() for c in grp)


# ---------------------------------------------------------------------------
# Logical combinators (§2.3) + CISC conditions (Table 2)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class LogicalAnd(Instruction):
    """All children must pass (``allOf``).  Short-circuits on failure."""

    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.AND)

    def children_groups(self):
        return (self.children,)

    def cost(self):
        return sum(c.cost() for c in self.children)


@dataclass(frozen=True, slots=True)
class LogicalOr(Instruction):
    """At least one child group must pass (``anyOf``).  Short-circuits on
    first success."""

    groups: Tuple[Instructions, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.OR)

    def children_groups(self):
        return self.groups


@dataclass(frozen=True, slots=True)
class LogicalXor(Instruction):
    """Exactly one child group must pass (``oneOf``).  Short-circuits once a
    second group passes."""

    groups: Tuple[Instructions, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.XOR)

    def children_groups(self):
        return self.groups


@dataclass(frozen=True, slots=True)
class LogicalNot(Instruction):
    """Children must NOT all pass (``not``)."""

    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.NOT)

    def children_groups(self):
        return (self.children,)


@dataclass(frozen=True, slots=True)
class LogicalCondition(Instruction):
    """``if``/``then``/``else``: evaluate condition, branch accordingly."""

    condition: Instructions = ()
    then_children: Instructions = ()
    else_children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.CONDITION)

    def children_groups(self):
        return (self.condition, self.then_children, self.else_children)


@dataclass(frozen=True, slots=True)
class WhenType(Instruction):
    """Execute children only when target has a type (Table 2 CISC)."""

    type: str = "object"
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.WHEN_TYPE)

    def children_groups(self):
        return (self.children,)


@dataclass(frozen=True, slots=True)
class WhenDefines(Instruction):
    """Execute children only when target object defines a key
    (``dependentSchemas`` -- Table 2 CISC)."""

    key: str = ""
    key_hash: int = 0
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.WHEN_DEFINES)

    def children_groups(self):
        return (self.children,)


@dataclass(frozen=True, slots=True)
class WhenArraySizeGreater(Instruction):
    """Execute children only when array length > bound (Table 2 CISC)."""

    bound: int = 0
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.WHEN_ARRAY_SIZE_GREATER)

    def children_groups(self):
        return (self.children,)


@dataclass(frozen=True, slots=True)
class WhenArraySizeEqual(Instruction):
    """Execute children only when array length == bound (Table 2 CISC)."""

    bound: int = 0
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.WHEN_ARRAY_SIZE_EQUAL)

    def children_groups(self):
        return (self.children,)


# ---------------------------------------------------------------------------
# Control flow (§2.4)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class ControlLabel(Instruction):
    """Register children under a label, then execute them (first ``$ref``
    encounter of a shared/recursive destination, §3.3)."""

    label: int = 0
    children: Instructions = ()

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.CONTROL_LABEL)

    def children_groups(self):
        return (self.children,)

    def cost(self):
        return 2 + sum(c.cost() for c in self.children)


@dataclass(frozen=True, slots=True)
class ControlJump(Instruction):
    """Execute the instruction group registered under ``label``."""

    label: int = 0

    def __post_init__(self):
        object.__setattr__(self, "op", OpCode.CONTROL_JUMP)

    def cost(self):
        return 6  # jumps hurt cache locality (§3.3) -- bias reordering


def walk(instructions: Sequence[Instruction]):
    """Yield every instruction in a tree, depth first."""
    for inst in instructions:
        yield inst
        for grp in inst.children_groups():
            yield from walk(grp)
        if isinstance(inst, LoopUnevaluatedProperties):
            pass  # guards already covered by children_groups
