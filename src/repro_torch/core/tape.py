"""Instruction DSL -> tensorised *location tape* (the TPU-native schema form).

The sequential executor walks instructions per document.  The batched
executor instead assigns every document node a **schema location id** by
propagating locations down the BFS-ordered token table (property matching =
the ``hash_match`` kernel), then evaluates a flat table of per-location
assertion rows over all nodes at once (the ``assertion_eval`` kernel).

The tape supports the *structural subset* of the DSL that dominates API
payload validation: types, numeric/string/array/object bounds, specialized
regexes, scalar const/enum, required, (closed) properties, nested
objects/arrays, prefixItems/items, and -- since the bounded-unrolling
change (DESIGN.md §9) -- shared and **recursive** ``$ref`` labels.
``ControlLabel``/``ControlJump`` cycles are unrolled into the flat
location tape up to a compile-time depth budget (``unroll_depth``); the
locations where the budget ran out are *frontier* locations, and every
transition edge into them carries the :data:`LOC_FRONTIER` sentinel so
the batched executor can flag any document that reaches one as
**undecided** (routed to the sequential oracle, never vacuously valid).
Instructions outside the subset still raise :class:`UnsupportedForBatch`,
and callers fall back to the sequential executor -- the classic
fast-path/slow-path split.  Coverage over the benchmark corpus is
reported in EXPERIMENTS.md.

Layout (DESIGN.md §4-§5): assertion rows are stored **owner-sorted** as
CSR windows (``loc_asrt_start``/``loc_asrt_len``, bounded by the static
``max_rows_per_loc`` = A-hat) so each node evaluates only its own
location's rows; the property table additionally carries a
**hash-sorted** view (``psort_*``, runs bounded by ``max_hash_run`` = K)
so location propagation needs only one owner-blind hash pass; and
``max_loc_depth`` records the location DAG's depth so the executor can
truncate its propagation loop at compile-time-known horizons.

Multi-tenancy (DESIGN.md §8): a single-schema tape is the one-member
degenerate case of a *linked* tape; ``registry/linker.py`` relocates
and concatenates N member tapes so one batch can mix schemas, with
per-document roots (``roots[schema_id]``) and per-member psort segments
(``member_prop_start/len``, ``psort_member``).

Assertion-row mini-ISA (column ``asrt_op``; operands: f0 float, i0/i1
int32, u0/u1 uint32, plus 8 uint32 hash lanes per row):

====  ==============  =======================================================
code  name            semantics (precondition in parentheses)
====  ==============  =======================================================
0     TYPE_MASK       node type bit (1 << type code) in mask i0;
                      i1=1 -> numbers must be integers
1     NUM_GE          (number)  num >= f0
2     NUM_GT          (number)  num >  f0
3     NUM_LE          (number)  num <= f0
4     NUM_LT          (number)  num <  f0
5     NUM_MULTIPLE    (number)  num divisible by f0 (f0 != 0); evaluated
                      with a relative tolerance on the quotient (decimal
                      ``multipleOf`` like 0.01 has no exact binary form,
                      so exact f32 remainders would reject 19.99 % 0.01)
6     STR_MINLEN      (string)  size >= i0
7     STR_MAXLEN      (string)  size <= i0
8     ARR_MINLEN      (array)   size >= i0
9     ARR_MAXLEN      (array)   size <= i0
10    OBJ_MINPROPS    (object)  size >= i0
11    OBJ_MAXPROPS    (object)  size <= i0
12    STR_PREFIX      (string)  first i0 (<=8) bytes equal u0,u1 (big-endian)
13    STR_EQ          exact string equality via hash lanes (non-strings fail)
14    CONST_NULL      value is null
15    CONST_BOOL      value is boolean f0
16    CONST_NUM       value is number f0
17    STR_EQ_PRE      (string)  equality via hash lanes (non-strings pass)
18    OBJ_HAS_SLOT    (object)  required-slot bit i0 is acquired, i.e. the
                      object defines the property wired to that slot
                      (conditional ``required`` inside logical applicators)
====  ==============  =======================================================

Rows sharing a nonzero ``asrt_group`` form an OR-group (``enum``); rows with
group 0 are ANDed individually with precondition semantics.  Within a CSR
window the AND rows come first and each OR-group is contiguous (the
executor's segmented-scan reduction relies on this).

Logical applicators (DESIGN.md §10): ``anyOf``/``oneOf``/``not``/``if``
(and the CISC ``When*`` conditions) over the scalar-assertion subset lower
into a per-tape **boolean group circuit**.  Each circuit node has a kind
(:data:`CK_AND`/:data:`CK_OR`/:data:`CK_XOR1`/:data:`CK_NOT`), an owner
location, and an optional parent node; assertion rows carry ``asrt_circ``
(-1 for plain rows) wiring them as leaves of their circuit node.  The
batched executor aggregates leaf rows per document (vacuously true when
the leaf's location has no node -- the tensor form of "absent target =>
instruction skipped"), reduces the circuit bottom-up with a bounded-depth
level sweep (``max_circ_depth`` levels, compile-time constant), gates
every node on its owner location's presence, and ANDs root-node values
into the document verdict.  Soundness requires each circuit-owning
location to be instantiated at most once per document, so circuits are
only lowered at *unique-path* locations (reached from the root purely via
property edges); applicators under ``items``/``additionalProperties``/
``prefixItems`` still raise :class:`UnsupportedForBatch`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from .compiler import CompiledSchema
from .instructions import Instruction, Instructions, OpCode
from .nodetypes import TYPE_BIT
from .regex_opt import RegexKind

__all__ = [
    "LocationTape",
    "UnsupportedForBatch",
    "build_tape",
    "try_build_tape",
    "AOP",
    "LOC_FRONTIER",
    "DEFAULT_UNROLL_DEPTH",
    "DEFAULT_UNROLL_NODE_BUDGET",
    "CK_AND",
    "CK_OR",
    "CK_XOR1",
    "CK_NOT",
]


class UnsupportedForBatch(ValueError):
    """Schema uses DSL features outside the tensorised subset."""


# assertion op codes (mini-ISA)
class AOP:
    TYPE_MASK = 0
    NUM_GE = 1
    NUM_GT = 2
    NUM_LE = 3
    NUM_LT = 4
    NUM_MULTIPLE = 5
    STR_MINLEN = 6
    STR_MAXLEN = 7
    ARR_MINLEN = 8
    ARR_MAXLEN = 9
    OBJ_MINPROPS = 10
    OBJ_MAXPROPS = 11
    STR_PREFIX = 12
    STR_EQ = 13
    CONST_NULL = 14
    CONST_BOOL = 15
    CONST_NUM = 16
    STR_EQ_PRE = 17
    OBJ_HAS_SLOT = 18


# circuit-node kinds (DESIGN.md §10)
CK_AND = 0  # all leaves and children true (a branch conjunction)
CK_OR = 1  # any child true (anyOf)
CK_XOR1 = 2  # exactly one child true (oneOf)
CK_NOT = 3  # negation of the conjunction of leaves and children (not)


# special location ids
LOC_UNTRACKED = -2  # no constraints below this point
LOC_INVALID = -3  # reaching this location fails the document
LOC_FRONTIER = -4  # the unroll budget ran out here: document undecided

# $ref-recursion unrolling budgets (DESIGN.md §9): levels of label
# re-expansion beyond the first, and a cap on total locations so
# branching recursion (trees with many recursive children) cannot blow
# the tape up exponentially -- the budget simply converts into earlier
# frontiers, i.e. more sequential-oracle routing, never wrong verdicts.
DEFAULT_UNROLL_DEPTH = 4
DEFAULT_UNROLL_NODE_BUDGET = 4096

# type code bits (shared canonical codes, see core.nodetypes)
_TYPE_BIT = TYPE_BIT


@dataclass
class _Loc:
    """Mutable per-location build state."""

    index: int
    props: Dict[str, int] = field(default_factory=dict)  # key -> prop row
    closed: bool = False
    addl_loc: int = -1  # location for unmatched properties (-1: none)
    item_loc: int = -1
    item_start: int = 0
    prefix_locs: List[int] = field(default_factory=list)
    # key -> acquired-bit slot.  A slot exists for every key whose presence
    # is *observed* (hard ``required`` or conditional requiredness inside a
    # circuit); only ``hard_keys`` enter ``loc_required_mask``.
    required_slots: Dict[str, int] = field(default_factory=dict)
    hard_keys: Set[str] = field(default_factory=set)
    frontier: bool = False  # a label expansion ran out of budget here
    # instantiated at most once per document (root, or reached purely via
    # property edges) -- the soundness precondition for circuit owners
    unique: bool = True
    # property-routing scopes, enforced at build() time (exempt keys keep
    # their route; other keys snap to LOC_INVALID under a closed object,
    # or must re-route to / raise against an additionalProperties scope)
    closed_exempt: Optional[Set[str]] = None
    addl_exempt: Optional[Set[str]] = None
    # provenance for first-failure attribution (DESIGN.md §12):
    # key -> source schema path of the requiring keyword, and the path of
    # the closing (additionalProperties: false) scope
    required_paths: Dict[str, str] = field(default_factory=dict)
    closed_path: str = ""


@dataclass
class LocationTape:
    """Flat tensor form of a compiled (structural-subset) schema.

    Assertion rows are stored **owner-sorted** (by ``(owner, group)``):
    each location's rows occupy the contiguous CSR window
    ``[loc_asrt_start[l], loc_asrt_start[l] + loc_asrt_len[l])``, with the
    AND rows (group 0) first and each enum OR-group contiguous after them.
    ``max_rows_per_loc`` (compile-time constant, "A-hat") bounds every
    window, so the batched executor can evaluate a dense (nodes x A-hat)
    gather instead of the full (nodes x A) matrix.

    The property-transition table additionally carries a **hash-sorted
    view** (``psort_*``): rows sorted lexicographically by their 8 hash
    lanes, so all rows sharing one key hash form a contiguous run.  One
    owner-blind ``hash_match`` per node finds the run start; the run is at
    most ``max_hash_run`` (K) rows, and per-depth location propagation
    reduces to an owner-equality check over those K candidates.
    """

    n_locations: int
    max_loc_depth: int  # longest root path in the location DAG
    # property transition rows (original emission order)
    prop_owner: np.ndarray  # int32 (M,)
    prop_hash: np.ndarray  # uint32 (M, 8)
    prop_child_loc: np.ndarray  # int32 (M,)
    prop_required_slot: np.ndarray  # int32 (M,)  -1 = not required
    # hash-sorted view of the property table (candidate-set hashing)
    psort_hash: np.ndarray  # uint32 (M, 8) lexicographically sorted lanes
    psort_owner: np.ndarray  # int32 (M,)
    psort_child_loc: np.ndarray  # int32 (M,)
    psort_required_slot: np.ndarray  # int32 (M,)
    psort_orig_row: np.ndarray  # int32 (M,) original row index (tie-break)
    psort_run_len: np.ndarray  # int32 (M,) length of the equal-hash run
    max_hash_run: int  # K: max rows sharing one key hash
    # per-location
    loc_closed: np.ndarray  # bool (L,)
    loc_addl: np.ndarray  # int32 (L,)  unmatched-property location / -1
    loc_item: np.ndarray  # int32 (L,)
    loc_item_start: np.ndarray  # int32 (L,)
    loc_prefix_start: np.ndarray  # int32 (L,)
    loc_prefix_len: np.ndarray  # int32 (L,)
    prefix_loc: np.ndarray  # int32 (P,)
    loc_required_mask: np.ndarray  # uint32 (L,)
    # assertion rows, owner-sorted CSR (see class docstring)
    loc_asrt_start: np.ndarray  # int32 (L,) window start per location
    loc_asrt_len: np.ndarray  # int32 (L,) window length per location
    max_rows_per_loc: int  # A-hat: max window length over locations
    asrt_owner: np.ndarray  # int32 (A,)
    asrt_op: np.ndarray  # int32 (A,)
    asrt_group: np.ndarray  # int32 (A,)  0 = AND row, else OR-group id
    asrt_f0: np.ndarray  # float64 (A,)
    asrt_i0: np.ndarray  # int32 (A,)
    asrt_i1: np.ndarray  # int32 (A,)
    asrt_u0: np.ndarray  # uint32 (A,)
    asrt_u1: np.ndarray  # uint32 (A,)
    asrt_hash: np.ndarray  # uint32 (A, 8)
    # -- multi-tenant linking (registry/linker.py) ----------------------
    # A single-schema tape is the one-member degenerate case: member 0,
    # root location 0.  A *linked* tape concatenates S relocated member
    # tapes; ``roots[s]`` seeds each document's root location from its
    # schema id, and the hash-sorted property view keeps per-member
    # segments (``member_prop_start/len``; rows tagged ``psort_member``
    # for introspection) so the executor's hash pass never matches
    # across members (runs never span members by construction).
    # ``member_horizons[s]`` keeps each member's own propagation horizon
    # (max_loc_depth + 1) so per-document ``decided`` stays bit-identical
    # to single-tape dispatch even when members disagree on depth.
    psort_member: Optional[np.ndarray] = None  # int32 (M,)
    roots: Optional[np.ndarray] = None  # int32 (S,)
    member_horizons: Optional[np.ndarray] = None  # int32 (S,)
    # per-member psort segment windows: member s's hash-sorted rows are
    # [member_prop_start[s], member_prop_start[s] + member_prop_len[s]).
    # ``max_member_props`` (M-hat) bounds them, so the linked executor's
    # hash pass scans the largest member, not the member *sum*.
    member_prop_start: Optional[np.ndarray] = None  # int32 (S,)
    member_prop_len: Optional[np.ndarray] = None  # int32 (S,)
    max_member_props: Optional[int] = None  # M-hat
    # -- $ref-recursion unrolling (DESIGN.md §9) ------------------------
    # ``loc_frontier[l]`` marks locations where the unroll budget ran
    # out; every transition edge into them already carries the
    # LOC_FRONTIER sentinel (so the executor needs no extra gather), the
    # bool array is kept for introspection, linking and static skips.
    loc_frontier: Optional[np.ndarray] = None  # bool (L,)
    unroll_depth: int = 0  # budget used at build time (0: no labels)
    # -- logical-applicator circuits (DESIGN.md §10) --------------------
    # ``asrt_circ[a]`` wires assertion row ``a`` to a circuit node as a
    # leaf (-1: plain row).  Circuit nodes are stored parents-first
    # (``circ_parent[c] < c`` for non-roots); ``circ_level`` is the
    # bottom-up evaluation level (leaf-only nodes at level 0), bounded by
    # the compile-time ``max_circ_depth``.
    asrt_circ: Optional[np.ndarray] = None  # int32 (A,)
    circ_kind: Optional[np.ndarray] = None  # int32 (C,)  CK_* codes
    circ_parent: Optional[np.ndarray] = None  # int32 (C,)  -1 = root
    circ_owner: Optional[np.ndarray] = None  # int32 (C,)  owner location
    circ_level: Optional[np.ndarray] = None  # int32 (C,)
    max_circ_depth: int = 0
    # -- provenance sidecars for first-failure attribution (DESIGN.md §12)
    # Host-side only (tuples, never shipped to the device): the source
    # schema path per assertion row (aligned with the owner-sorted order),
    # per-location required-slot provenance ((slot, key, path) triples),
    # the path of the closing scope per location, and the path of the
    # originating applicator per circuit node.
    asrt_path: Optional[Tuple[str, ...]] = None  # (A,)
    loc_required_info: Optional[Tuple[Tuple[Tuple[int, str, str], ...], ...]] = None  # (L,)
    loc_closed_path: Optional[Tuple[str, ...]] = None  # (L,)
    circ_path: Optional[Tuple[str, ...]] = None  # (C,)

    def __post_init__(self) -> None:
        if self.psort_member is None:
            self.psort_member = np.zeros(len(self.psort_owner), np.int32)
        if self.roots is None:
            self.roots = np.zeros(1, np.int32)
        if self.member_horizons is None:
            self.member_horizons = np.array([self.max_loc_depth + 1], np.int32)
        if self.member_prop_start is None:
            self.member_prop_start = np.zeros(len(self.roots), np.int32)
        if self.member_prop_len is None:
            n_real = int(np.count_nonzero(self.prop_owner >= 0))
            self.member_prop_len = np.full(len(self.roots), n_real, np.int32)
        if self.max_member_props is None:
            self.max_member_props = int(self.member_prop_len.max()) if len(self.member_prop_len) else 0
        if self.loc_frontier is None:
            self.loc_frontier = np.zeros(len(self.loc_closed), bool)
        if self.asrt_circ is None:
            self.asrt_circ = np.full(len(self.asrt_owner), -1, np.int32)
        if self.circ_kind is None:
            self.circ_kind = np.zeros(0, np.int32)
        if self.circ_parent is None:
            self.circ_parent = np.zeros(0, np.int32)
        if self.circ_owner is None:
            self.circ_owner = np.zeros(0, np.int32)
        if self.circ_level is None:
            self.circ_level = np.zeros(0, np.int32)
        if self.asrt_path is None:
            self.asrt_path = ("",) * len(self.asrt_owner)
        if self.loc_required_info is None:
            self.loc_required_info = ((),) * len(self.loc_closed)
        if self.loc_closed_path is None:
            self.loc_closed_path = ("",) * len(self.loc_closed)
        if self.circ_path is None:
            self.circ_path = ("",) * len(self.circ_kind)

    @property
    def n_props(self) -> int:
        return len(self.prop_owner)

    @property
    def n_assertions(self) -> int:
        return len(self.asrt_owner)

    @property
    def n_members(self) -> int:
        return len(self.roots)

    @property
    def n_frontier(self) -> int:
        return int(np.count_nonzero(self.loc_frontier))

    @property
    def n_circuits(self) -> int:
        return len(self.circ_kind)


class _TapeBuilder:
    def __init__(
        self,
        labels: Optional[Dict[int, Instructions]] = None,
        *,
        unroll_depth: int = DEFAULT_UNROLL_DEPTH,
        unroll_node_budget: int = DEFAULT_UNROLL_NODE_BUDGET,
    ) -> None:
        self.locs: List[_Loc] = []
        self.prop_rows: List[Tuple[int, np.ndarray, int, int]] = []
        self.asrt_rows: List[dict] = []
        self._group_counter = 0
        self.labels: Dict[int, Instructions] = dict(labels or {})
        self.unroll_depth = max(1, int(unroll_depth))
        self.unroll_node_budget = int(unroll_node_budget)
        # active expansions per label along the current lowering path --
        # the cycle detector.  A label already on the stack more than
        # ``unroll_depth`` times stops expanding and marks a frontier.
        self._label_stack: Dict[int, int] = {}
        # logical-applicator circuit nodes (DESIGN.md §10); rows emitted
        # while ``_circ_ctx >= 0`` become leaves of that circuit node
        self.circ_kind: List[int] = []
        self.circ_parent: List[int] = []
        self.circ_owner: List[int] = []
        self.circ_path: List[str] = []
        self._circ_ctx: int = -1
        # source schema path of the instruction currently lowering --
        # synthesized instructions (empty schema_path) inherit the
        # enclosing applicator's path (DESIGN.md §12)
        self._cur_path: str = ""

    # -- circuits (DESIGN.md §10) --------------------------------------

    def new_circ(self, kind: int, loc: _Loc, parent: Optional[int] = None) -> int:
        cid = len(self.circ_kind)
        self.circ_kind.append(kind)
        self.circ_parent.append(self._circ_ctx if parent is None else parent)
        self.circ_owner.append(loc.index)
        self.circ_path.append(self._cur_path)
        return cid

    def circuit_group(self, instructions: Instructions, loc: _Loc, node: int) -> None:
        """Lower ``instructions`` at ``loc`` as inputs of circuit ``node``."""
        prev = self._circ_ctx
        self._circ_ctx = node
        try:
            self.add_group(instructions, loc)
        finally:
            self._circ_ctx = prev

    def check_circuit_site(self, loc: _Loc, kw: str) -> None:
        if not loc.unique:
            raise UnsupportedForBatch(
                f"{kw} under items/prefixItems/additionalProperties not "
                "batchable (owner location is not a unique instance path)"
            )

    def lower_condition(
        self,
        loc: _Loc,
        condition: Instructions,
        then_children: Instructions,
        else_children: Instructions,
    ) -> None:
        """``if c then t else e`` == OR(AND(c, t), AND(NOT(c), e))."""
        node = self.new_circ(CK_OR, loc)
        then_branch = self.new_circ(CK_AND, loc, parent=node)
        self.circuit_group(condition, loc, then_branch)
        self.circuit_group(then_children, loc, then_branch)
        else_branch = self.new_circ(CK_AND, loc, parent=node)
        negated = self.new_circ(CK_NOT, loc, parent=else_branch)
        self.circuit_group(condition, loc, negated)
        self.circuit_group(else_children, loc, else_branch)

    # -- label unrolling (DESIGN.md §9) --------------------------------

    def expand_label(self, label: int, loc: _Loc) -> None:
        """Expand ``label``'s body at ``loc``, bounded by the budgets.

        Each re-expansion along one lowering path clones the label's
        location subgraph one level deeper (property-transition rows of
        level *d* wire to the level *d+1* clones because every
        ``child_for_key`` call allocates fresh locations).  When either
        budget runs out, ``loc`` becomes a *frontier* location instead:
        documents reaching it are undecided, never vacuously valid.
        """
        children = self.labels.get(label)
        if children is None:
            raise UnsupportedForBatch(f"jump to unknown label {label}")
        depth = self._label_stack.get(label, 0)
        if depth > self.unroll_depth or len(self.locs) >= self.unroll_node_budget:
            loc.frontier = True
            return
        self._label_stack[label] = depth + 1
        try:
            self.add_group(children, loc)
        finally:
            self._label_stack[label] = depth

    # -- locations -----------------------------------------------------

    def new_loc(self, *, unique: bool = True) -> _Loc:
        loc = _Loc(index=len(self.locs), unique=unique)
        self.locs.append(loc)
        return loc

    def child_for_key(self, loc: _Loc, key: str) -> _Loc:
        if key in loc.props:
            row = loc.props[key]
            child_idx = self.prop_rows[row][2]
            if child_idx >= 0:
                return self.locs[child_idx]
            # upgrade an untracked (required-only) row to a real location
            child = self.new_loc(unique=loc.unique)
            owner, lanes, _, slot = self.prop_rows[row]
            self.prop_rows[row] = (owner, lanes, child.index, slot)
            return child
        from ..data.doc_table import key_lanes

        child = self.new_loc(unique=loc.unique)
        row = len(self.prop_rows)
        self.prop_rows.append((loc.index, key_lanes(key), child.index, -1))
        loc.props[key] = row
        return child

    def require_key(self, loc: _Loc, key: str, *, hard: bool = True) -> int:
        """Allocate (or look up) the key's acquired-bit slot.

        ``hard`` marks the key unconditionally required (it enters
        ``loc_required_mask``); conditional requiredness inside circuits
        only needs the slot so :data:`AOP.OBJ_HAS_SLOT` can observe it.
        """
        if hard:
            loc.hard_keys.add(key)
        loc.required_paths.setdefault(key, self._cur_path)
        if key in loc.required_slots:
            return loc.required_slots[key]
        slot = len(loc.required_slots)
        if slot >= 32:
            raise UnsupportedForBatch(">32 required properties at one location")
        loc.required_slots[key] = slot
        if key in loc.props:
            row = loc.props[key]
            owner, lanes, child, _ = self.prop_rows[row]
            self.prop_rows[row] = (owner, lanes, child, slot)
        else:
            from ..data.doc_table import key_lanes

            row = len(self.prop_rows)
            self.prop_rows.append((loc.index, key_lanes(key), LOC_UNTRACKED, slot))
            loc.props[key] = row
        return slot

    # -- assertion rows ---------------------------------------------------

    def row(self, loc: _Loc, op: int, *, f0=0.0, i0=0, i1=0, u0=0, u1=0, lanes=None, group=0):
        self.asrt_rows.append(
            dict(
                owner=loc.index,
                op=op,
                group=group,
                circ=self._circ_ctx,
                f0=float(f0),
                i0=int(i0),
                i1=int(i1),
                u0=int(u0),
                u1=int(u1),
                lanes=np.zeros(8, np.uint32) if lanes is None else lanes,
                path=self._cur_path,
            )
        )

    def next_group(self) -> int:
        self._group_counter += 1
        return self._group_counter

    # -- instruction lowering -----------------------------------------------

    def add_group(self, instructions: Instructions, loc: _Loc) -> None:
        for inst in instructions:
            self.add(inst, loc)

    def descend(self, loc: _Loc, rel_path) -> _Loc:
        for tok in rel_path:
            if not isinstance(tok, str):
                raise UnsupportedForBatch("integer instance paths not batchable")
            loc = self.child_for_key(loc, tok)
        return loc

    def add(self, inst: Instruction, loc: _Loc) -> None:
        target = self.descend(loc, inst.rel_path)
        op = inst.op
        if self._circ_ctx >= 0 and op not in _CIRCUIT_OPS:
            raise UnsupportedForBatch(
                f"instruction {op.name} inside a logical applicator not batchable"
            )
        handler = _HANDLERS.get(op)
        if handler is None:
            raise UnsupportedForBatch(f"instruction {op.name} not batchable")
        prev_path = self._cur_path
        if inst.schema_path:
            self._cur_path = inst.schema_path
        try:
            handler(self, inst, target)
        finally:
            self._cur_path = prev_path

    # -- finalize ------------------------------------------------------------

    def _note_closed(self, loc: _Loc, keys) -> None:
        ks = set(keys)
        loc.closed_exempt = ks if loc.closed_exempt is None else (loc.closed_exempt & ks)
        loc.closed = True
        if not loc.closed_path:
            loc.closed_path = self._cur_path

    def _note_addl_exempt(self, loc: _Loc, keys) -> None:
        ks = set(keys)
        loc.addl_exempt = ks if loc.addl_exempt is None else (loc.addl_exempt & ks)

    def _enforce_property_scopes(self) -> None:
        """Reconcile per-key routes with closed/additionalProperties scopes.

        A property row routes its key *away* from the location's unmatched
        rule, which is only sound for the keys the enclosing scope exempts
        (the adjacent ``properties``).  Rows that merely *observe* a key
        (required-only, ``LOC_UNTRACKED`` child) re-route to the scope's
        own rule: ``LOC_INVALID`` under a closed object (the key's very
        presence fails), the additionalProperties location otherwise.
        Rows with real child constraints under an additionalProperties
        scope would need the key validated against BOTH locations --
        inexpressible on the tape, so they fall back.  Runs before the
        frontier snap / depth DP: it is pure route rewriting.
        """
        for loc in self.locs:
            if loc.closed:
                exempt = loc.closed_exempt or set()
                for key, row in loc.props.items():
                    if key in exempt:
                        # a coexisting additionalProperties SCHEMA (e.g.
                        # allOf of a closed object and an addl scope)
                        # must also validate this key unless it exempts
                        # it too -- dual routing, inexpressible
                        if loc.addl_exempt is not None and key not in loc.addl_exempt:
                            raise UnsupportedForBatch(
                                f"property {key!r} is tolerated by a closed object "
                                "but also falls under an additionalProperties "
                                "schema (dual routing not batchable)"
                            )
                        continue
                    owner, lanes, _child, slot = self.prop_rows[row]
                    self.prop_rows[row] = (owner, lanes, LOC_INVALID, slot)
            elif loc.addl_loc >= 0 and loc.addl_exempt is not None:
                for key, row in loc.props.items():
                    if key in loc.addl_exempt:
                        continue
                    owner, lanes, child, slot = self.prop_rows[row]
                    if child == LOC_UNTRACKED:
                        self.prop_rows[row] = (owner, lanes, loc.addl_loc, slot)
                    elif child != loc.addl_loc:
                        raise UnsupportedForBatch(
                            f"property {key!r} has its own constraints while an "
                            "additionalProperties scope also applies to it "
                            "(dual routing not batchable)"
                        )

    def build(self) -> LocationTape:
        L = len(self.locs)
        self._enforce_property_scopes()
        # frontier locations (unroll budget exhausted): every transition
        # edge INTO one is snapped to the LOC_FRONTIER sentinel, so the
        # executor's ordinary negative-location propagation carries the
        # "undecided" mark down the whole subtree for free and the
        # frontier location itself (with its partial constraints) is
        # never entered.  Frontier subtrees are likewise excluded from
        # the depth DP, keeping the horizon tight.
        frontier_mask = np.array([l.frontier for l in self.locs] or [False], bool)

        def _snap(child: int) -> int:
            if child >= 0 and frontier_mask[child]:
                return LOC_FRONTIER
            return child

        prefix_loc: List[int] = []
        loc_prefix_start = np.zeros(L, np.int32)
        loc_prefix_len = np.zeros(L, np.int32)
        for loc in self.locs:
            loc_prefix_start[loc.index] = len(prefix_loc)
            loc_prefix_len[loc.index] = len(loc.prefix_locs)
            prefix_loc.extend(_snap(p) for p in loc.prefix_locs)
        M = max(1, len(self.prop_rows))
        prop_owner = np.full(M, -1, np.int32)
        prop_hash = np.zeros((M, 8), np.uint32)
        prop_child = np.full(M, LOC_UNTRACKED, np.int32)
        prop_slot = np.full(M, -1, np.int32)
        for r, (owner, lanes, child, slot) in enumerate(self.prop_rows):
            prop_owner[r] = owner
            prop_hash[r] = lanes
            prop_child[r] = _snap(child)
            prop_slot[r] = slot

        # hash-sorted view: rows sorted lexicographically by lanes so equal
        # key hashes form contiguous runs (candidate sets for the single
        # owner-blind hash_match pass).  Lane 0 is the primary sort key.
        if self.prop_rows:
            order = np.lexsort(tuple(prop_hash[:, k] for k in range(7, -1, -1)))
            order = order.astype(np.int32)
            psort_hash = prop_hash[order]
            new_run = np.ones(M, bool)
            new_run[1:] = np.any(psort_hash[1:] != psort_hash[:-1], axis=1)
            run_id = np.cumsum(new_run) - 1
            run_sizes = np.bincount(run_id)
            psort_run_len = run_sizes[run_id].astype(np.int32)
            max_hash_run = int(run_sizes.max())
        else:
            order = np.zeros(1, np.int32)
            psort_hash = prop_hash
            psort_run_len = np.zeros(M, np.int32)
            max_hash_run = 0

        # longest root path in the location DAG: all transition edges point
        # to later-created locations, so one ascending DP pass suffices.
        # Nodes deeper than max_loc_depth + 1 can only be untracked or
        # under an already-invalid ancestor -- the executor truncates its
        # propagation loop there (compile-time depth knowledge).
        dist = np.zeros(max(1, L), np.int64)
        children: List[List[int]] = [[] for _ in range(L)]
        for owner, _lanes, child, _slot in self.prop_rows:
            if child >= 0 and not frontier_mask[child]:
                children[owner].append(child)
        for loc in self.locs:
            for v in (loc.addl_loc, loc.item_loc):
                if v >= 0 and not frontier_mask[v]:
                    children[loc.index].append(v)
            children[loc.index].extend(
                p for p in loc.prefix_locs if not frontier_mask[p]
            )
        for u in range(L):
            for v in children[u]:
                if v > u:
                    dist[v] = max(dist[v], dist[u] + 1)
        max_loc_depth = int(dist.max())

        # owner-sorted CSR assertion windows: stable sort by (owner, group)
        # keeps AND rows (group 0) first and every OR-group contiguous
        asrt_rows = self.asrt_rows
        if asrt_rows:
            a_owner = np.array([r["owner"] for r in asrt_rows], np.int32)
            a_group = np.array([r["group"] for r in asrt_rows], np.int32)
            a_order = np.lexsort((a_group, a_owner))
            asrt_rows = [asrt_rows[i] for i in a_order]
            sorted_owner = a_owner[a_order]
            loc_asrt_len = np.bincount(sorted_owner, minlength=L).astype(np.int32)
            loc_asrt_start = np.concatenate(
                [[0], np.cumsum(loc_asrt_len[:-1])]
            ).astype(np.int32)
            max_rows_per_loc = int(loc_asrt_len.max())
        else:
            loc_asrt_len = np.zeros(max(1, L), np.int32)
            loc_asrt_start = np.zeros(max(1, L), np.int32)
            max_rows_per_loc = 0

        # circuit-node levels, bottom-up (a child always has a larger id
        # than its parent, so one descending pass finalizes every level)
        C = len(self.circ_kind)
        circ_level = np.zeros(C, np.int32)
        for c in range(C - 1, -1, -1):
            p = self.circ_parent[c]
            if p >= 0 and circ_level[p] <= circ_level[c]:
                circ_level[p] = circ_level[c] + 1

        tape = LocationTape(
            n_locations=L,
            max_loc_depth=max_loc_depth,
            prop_owner=prop_owner,
            prop_hash=prop_hash,
            prop_child_loc=prop_child,
            prop_required_slot=prop_slot,
            psort_hash=psort_hash,
            psort_owner=prop_owner[order],
            psort_child_loc=prop_child[order],
            psort_required_slot=prop_slot[order],
            psort_orig_row=order,
            psort_run_len=psort_run_len,
            max_hash_run=max_hash_run,
            loc_asrt_start=loc_asrt_start,
            loc_asrt_len=loc_asrt_len,
            max_rows_per_loc=max_rows_per_loc,
            loc_closed=np.array([l.closed for l in self.locs] or [False], bool),
            loc_addl=np.array(
                [_snap(l.addl_loc) for l in self.locs] or [-1], np.int32
            ),
            loc_item=np.array(
                [_snap(l.item_loc) for l in self.locs] or [-1], np.int32
            ),
            loc_item_start=np.array([l.item_start for l in self.locs] or [0], np.int32),
            loc_prefix_start=loc_prefix_start if L else np.zeros(1, np.int32),
            loc_prefix_len=loc_prefix_len if L else np.zeros(1, np.int32),
            prefix_loc=np.array(prefix_loc or [-1], np.int32),
            loc_required_mask=np.array(
                [
                    sum(1 << l.required_slots[k] for k in l.hard_keys)
                    for l in self.locs
                ]
                or [0],
                np.uint32,
            ),
            asrt_owner=np.array([r["owner"] for r in asrt_rows] or [-1], np.int32),
            asrt_op=np.array([r["op"] for r in asrt_rows] or [0], np.int32),
            asrt_group=np.array([r["group"] for r in asrt_rows] or [0], np.int32),
            asrt_f0=np.array([r["f0"] for r in asrt_rows] or [0.0], np.float64),
            asrt_i0=np.array([r["i0"] for r in asrt_rows] or [0], np.int32),
            asrt_i1=np.array([r["i1"] for r in asrt_rows] or [0], np.int32),
            asrt_u0=np.array([r["u0"] for r in asrt_rows] or [0], np.uint32),
            asrt_u1=np.array([r["u1"] for r in asrt_rows] or [0], np.uint32),
            asrt_hash=np.stack([r["lanes"] for r in asrt_rows] or [np.zeros(8, np.uint32)]),
            asrt_circ=np.array([r["circ"] for r in asrt_rows] or [-1], np.int32),
            circ_kind=np.asarray(self.circ_kind, dtype=np.int32),
            circ_parent=np.asarray(self.circ_parent, dtype=np.int32),
            circ_owner=np.asarray(self.circ_owner, dtype=np.int32),
            circ_level=circ_level,
            max_circ_depth=int(circ_level.max()) if C else 0,
            loc_frontier=frontier_mask,
            unroll_depth=self.unroll_depth if self.labels else 0,
            # provenance sidecars (DESIGN.md §12); ``asrt_rows`` is already
            # in the owner-sorted order, so the path tuple aligns with the
            # CSR row arrays
            asrt_path=tuple(r.get("path", "") for r in asrt_rows) or ("",),
            loc_required_info=tuple(
                tuple(
                    sorted(
                        (slot, key, l.required_paths.get(key, ""))
                        for key, slot in l.required_slots.items()
                    )
                )
                for l in self.locs
            )
            or ((),),
            loc_closed_path=tuple(l.closed_path for l in self.locs) or ("",),
            circ_path=tuple(self.circ_path),
        )
        return tape


# ---------------------------------------------------------------------------
# Per-instruction lowering handlers
# ---------------------------------------------------------------------------


def _type_row(b: _TapeBuilder, loc: _Loc, types: Tuple[str, ...]) -> None:
    mask = 0
    for t in types:
        if t == "integer":
            mask |= _TYPE_BIT["number"]
        else:
            mask |= _TYPE_BIT[t]
    ints_only = "integer" in types and "number" not in types
    b.row(loc, AOP.TYPE_MASK, i0=mask, i1=1 if ints_only else 0)


def _h_type(b, inst, loc):
    _type_row(b, loc, (inst.type,))


def _h_type_any(b, inst, loc):
    _type_row(b, loc, inst.types)


def _scalar_const_row(b: _TapeBuilder, loc: _Loc, value: Any, group: int) -> None:
    from ..data.doc_table import key_lanes

    if value is None:
        b.row(loc, AOP.CONST_NULL, group=group)
    elif isinstance(value, bool):
        b.row(loc, AOP.CONST_BOOL, f0=1.0 if value else 0.0, group=group)
    elif isinstance(value, (int, float)):
        b.row(loc, AOP.CONST_NUM, f0=float(value), group=group)
    elif isinstance(value, str):
        b.row(loc, AOP.STR_EQ, lanes=key_lanes(value), group=group)
    else:
        raise UnsupportedForBatch("const/enum of arrays/objects not batchable")


def _h_equal(b, inst, loc):
    group = b.next_group()
    _scalar_const_row(b, loc, inst.value, group)


def _h_equals_any(b, inst, loc):
    group = b.next_group()
    for v in inst.values:
        _scalar_const_row(b, loc, v, group)


def _h_fail(b, inst, loc):
    # an impossible assertion: type in empty mask
    b.row(loc, AOP.TYPE_MASK, i0=0)


def _h_number(b, inst, loc):
    op = inst.op
    if op is OpCode.GREATER:
        b.row(loc, AOP.NUM_GT, f0=inst.bound)
    elif op is OpCode.GREATER_EQUAL:
        b.row(loc, AOP.NUM_GE, f0=inst.bound)
    elif op is OpCode.LESS:
        b.row(loc, AOP.NUM_LT, f0=inst.bound)
    elif op is OpCode.LESS_EQUAL:
        b.row(loc, AOP.NUM_LE, f0=inst.bound)
    elif op is OpCode.DIVISIBLE:
        b.row(loc, AOP.NUM_MULTIPLE, f0=inst.divisor)
    elif op is OpCode.NUMBER_BOUNDS:
        if inst.lo is not None:
            b.row(loc, AOP.NUM_GT if inst.lo_exclusive else AOP.NUM_GE, f0=inst.lo)
        if inst.hi is not None:
            b.row(loc, AOP.NUM_LT if inst.hi_exclusive else AOP.NUM_LE, f0=inst.hi)


def _h_string_size(b, inst, loc):
    if inst.op is OpCode.STRING_SIZE_GREATER:
        b.row(loc, AOP.STR_MINLEN, i0=inst.bound)
    else:
        b.row(loc, AOP.STR_MAXLEN, i0=inst.bound)


def _h_string_bounds(b, inst, loc):
    b.row(loc, AOP.STR_MINLEN, i0=inst.min_len)
    if inst.max_len is not None:
        b.row(loc, AOP.STR_MAXLEN, i0=inst.max_len)


def _h_regex(b, inst, loc):
    plan = inst.plan
    if plan.kind is RegexKind.ALL:
        return
    if plan.kind is RegexKind.NON_EMPTY:
        b.row(loc, AOP.STR_MINLEN, i0=1)
        return
    if plan.kind is RegexKind.LENGTH_RANGE:
        b.row(loc, AOP.STR_MINLEN, i0=plan.min_len)
        if plan.max_len is not None:
            b.row(loc, AOP.STR_MAXLEN, i0=plan.max_len)
        return
    if plan.kind is RegexKind.EXACT:
        from ..data.doc_table import key_lanes

        # preconditioned form: non-strings skip (pattern semantics)
        b.row(loc, AOP.STR_EQ_PRE, lanes=key_lanes(plan.literal))
        return
    if plan.kind is RegexKind.PREFIX:
        data = plan.literal.encode("utf-8")
        if len(data) > 8:
            raise UnsupportedForBatch("prefix >8 bytes not batchable")
        padded = data.ljust(8, b"\x00")
        b.row(
            loc,
            AOP.STR_PREFIX,
            i0=len(data),
            u0=int.from_bytes(padded[:4], "big"),
            u1=int.from_bytes(padded[4:], "big"),
        )
        return
    raise UnsupportedForBatch(f"regex kind {plan.kind} not batchable")


def _h_array_size(b, inst, loc):
    if inst.op is OpCode.ARRAY_SIZE_GREATER:
        b.row(loc, AOP.ARR_MINLEN, i0=inst.bound)
    else:
        b.row(loc, AOP.ARR_MAXLEN, i0=inst.bound)


def _h_array_bounds(b, inst, loc):
    b.row(loc, AOP.ARR_MINLEN, i0=inst.min_len)
    if inst.max_len is not None:
        b.row(loc, AOP.ARR_MAXLEN, i0=inst.max_len)


def _h_object_size(b, inst, loc):
    if inst.op is OpCode.OBJECT_SIZE_GREATER:
        b.row(loc, AOP.OBJ_MINPROPS, i0=inst.bound)
    else:
        b.row(loc, AOP.OBJ_MAXPROPS, i0=inst.bound)


def _require_row(b, loc, key):
    """Lower one requiredness fact: a hard required-slot bit outside
    circuits, an :data:`AOP.OBJ_HAS_SLOT` leaf row inside them."""
    if b._circ_ctx >= 0:
        slot = b.require_key(loc, key, hard=False)
        b.row(loc, AOP.OBJ_HAS_SLOT, i0=slot)
    else:
        b.require_key(loc, key)


def _h_defines(b, inst, loc):
    _require_row(b, loc, inst.key)


def _h_defines_all(b, inst, loc):
    for key in inst.keys:
        _require_row(b, loc, key)


def _h_property_type(b, inst, loc):
    _require_row(b, loc, inst.key)
    child = b.child_for_key(loc, inst.key)
    _type_row(b, child, (inst.type,))


def _h_loop_properties_match(b, inst, loc, closed=False):
    if closed and b._circ_ctx >= 0:
        raise UnsupportedForBatch(
            "additionalProperties: false inside a logical applicator not batchable"
        )
    if closed and getattr(inst, "tolerate_patterns", ()):  # patterns need key text
        for p in inst.tolerate_patterns:
            raise UnsupportedForBatch("patternProperties tolerance not batchable")
    for key, _h, group in inst.matches:
        child = b.child_for_key(loc, key)
        b.add_group(group, child)
    if closed:
        b._note_closed(loc, (key for key, _h, _grp in inst.matches))


def _h_loop_properties_match_closed(b, inst, loc):
    _h_loop_properties_match(b, inst, loc, closed=True)


def _h_loop_properties(b, inst, loc):
    # every property validates against children: model as the addl location
    if loc.addl_loc >= 0:
        addl = b.locs[loc.addl_loc]
    else:
        addl = b.new_loc(unique=False)
        loc.addl_loc = addl.index
    # no key is exempt from this scope: every property row at this
    # location must reconcile with it (enforced at build())
    b._note_addl_exempt(loc, ())
    b.add_group(inst.children, addl)


def _h_loop_properties_except(b, inst, loc):
    if inst.exclude_patterns:
        raise UnsupportedForBatch("patternProperties exclusion not batchable")
    # excluded keys must exist as prop rows so unmatched -> addl
    for key in inst.exclude_keys:
        b.child_for_key(loc, key)
    addl = b.new_loc(unique=False)
    if loc.addl_loc >= 0:
        raise UnsupportedForBatch("multiple additionalProperties scopes")
    loc.addl_loc = addl.index
    b._note_addl_exempt(loc, inst.exclude_keys)
    b.add_group(inst.children, addl)


def _h_loop_items(b, inst, loc):
    if loc.item_loc >= 0:
        item = b.locs[loc.item_loc]
    else:
        item = b.new_loc(unique=False)
        loc.item_loc = item.index
        loc.item_start = 0
    b.add_group(inst.children, item)


def _h_loop_items_from(b, inst, loc):
    if loc.item_loc >= 0:
        raise UnsupportedForBatch("conflicting items scopes")
    item = b.new_loc(unique=False)
    loc.item_loc = item.index
    loc.item_start = inst.start
    b.add_group(inst.children, item)


def _h_array_prefix(b, inst, loc):
    if loc.prefix_locs:
        raise UnsupportedForBatch("conflicting prefixItems scopes")
    for group in inst.groups:
        child = b.new_loc(unique=False)
        loc.prefix_locs.append(child.index)
        b.add_group(group, child)


def _h_control_label(b, inst, loc):
    # shared/recursive definitions: the body expands in place, and any
    # jumps back to this label re-expand through the bounded unroller
    b.labels.setdefault(inst.label, inst.children)
    b.expand_label(inst.label, loc)


def _h_control_jump(b, inst, loc):
    b.expand_label(inst.label, loc)


# -- logical applicators -> circuit nodes (DESIGN.md §10) -------------------


def _h_logical_and(b, inst, loc):
    # allOf == splice: same conjunction context, no new node needed
    b.add_group(inst.children, loc)


def _h_logical_or(b, inst, loc):
    b.check_circuit_site(loc, "anyOf")
    node = b.new_circ(CK_OR, loc)
    for group in inst.groups:
        branch = b.new_circ(CK_AND, loc, parent=node)
        b.circuit_group(group, loc, branch)


def _h_logical_xor(b, inst, loc):
    b.check_circuit_site(loc, "oneOf")
    node = b.new_circ(CK_XOR1, loc)
    for group in inst.groups:
        branch = b.new_circ(CK_AND, loc, parent=node)
        b.circuit_group(group, loc, branch)


def _h_logical_not(b, inst, loc):
    b.check_circuit_site(loc, "not")
    node = b.new_circ(CK_NOT, loc)
    b.circuit_group(inst.children, loc, node)


def _h_logical_condition(b, inst, loc):
    b.check_circuit_site(loc, "if")
    b.lower_condition(loc, inst.condition, inst.then_children, inst.else_children)


def _h_when_type(b, inst, loc):
    from .instructions import AssertionType

    b.check_circuit_site(loc, "if")
    b.lower_condition(loc, (AssertionType(type=inst.type),), inst.children, ())


def _h_when_defines(b, inst, loc):
    from .instructions import AssertionDefines, AssertionType

    b.check_circuit_site(loc, "dependentSchemas")
    condition = (
        AssertionType(type="object"),
        AssertionDefines(key=inst.key, key_hash=inst.key_hash),
    )
    b.lower_condition(loc, condition, inst.children, ())


def _h_when_array_size_greater(b, inst, loc):
    from .instructions import AssertionArraySizeGreater, AssertionType

    b.check_circuit_site(loc, "if")
    condition = (
        AssertionType(type="array"),
        AssertionArraySizeGreater(bound=inst.bound + 1),
    )
    b.lower_condition(loc, condition, inst.children, ())


def _h_when_array_size_equal(b, inst, loc):
    from .instructions import (
        AssertionArraySizeGreater,
        AssertionArraySizeLess,
        AssertionType,
    )

    b.check_circuit_site(loc, "if")
    condition = (
        AssertionType(type="array"),
        AssertionArraySizeGreater(bound=inst.bound),
        AssertionArraySizeLess(bound=inst.bound),
    )
    b.lower_condition(loc, condition, inst.children, ())


_HANDLERS = {
    OpCode.FAIL: _h_fail,
    OpCode.TYPE: _h_type,
    OpCode.TYPE_ANY: _h_type_any,
    OpCode.EQUAL: _h_equal,
    OpCode.EQUALS_ANY: _h_equals_any,
    OpCode.GREATER: _h_number,
    OpCode.GREATER_EQUAL: _h_number,
    OpCode.LESS: _h_number,
    OpCode.LESS_EQUAL: _h_number,
    OpCode.NUMBER_BOUNDS: _h_number,
    OpCode.DIVISIBLE: _h_number,
    OpCode.STRING_SIZE_GREATER: _h_string_size,
    OpCode.STRING_SIZE_LESS: _h_string_size,
    OpCode.STRING_BOUNDS: _h_string_bounds,
    OpCode.REGEX: _h_regex,
    OpCode.ARRAY_SIZE_GREATER: _h_array_size,
    OpCode.ARRAY_SIZE_LESS: _h_array_size,
    OpCode.ARRAY_BOUNDS: _h_array_bounds,
    OpCode.OBJECT_SIZE_GREATER: _h_object_size,
    OpCode.OBJECT_SIZE_LESS: _h_object_size,
    OpCode.DEFINES: _h_defines,
    OpCode.DEFINES_ALL: _h_defines_all,
    OpCode.PROPERTY_TYPE: _h_property_type,
    OpCode.LOOP_PROPERTIES_MATCH: _h_loop_properties_match,
    OpCode.LOOP_PROPERTIES_MATCH_CLOSED: _h_loop_properties_match_closed,
    OpCode.LOOP_PROPERTIES: _h_loop_properties,
    OpCode.LOOP_PROPERTIES_EXCEPT: _h_loop_properties_except,
    OpCode.LOOP_ITEMS: _h_loop_items,
    OpCode.LOOP_ITEMS_FROM: _h_loop_items_from,
    OpCode.ARRAY_PREFIX: _h_array_prefix,
    OpCode.CONTROL_LABEL: _h_control_label,
    OpCode.CONTROL_JUMP: _h_control_jump,
    OpCode.AND: _h_logical_and,
    OpCode.OR: _h_logical_or,
    OpCode.XOR: _h_logical_xor,
    OpCode.NOT: _h_logical_not,
    OpCode.CONDITION: _h_logical_condition,
    OpCode.WHEN_TYPE: _h_when_type,
    OpCode.WHEN_DEFINES: _h_when_defines,
    OpCode.WHEN_ARRAY_SIZE_GREATER: _h_when_array_size_greater,
    OpCode.WHEN_ARRAY_SIZE_EQUAL: _h_when_array_size_equal,
}

# instructions lowerable INSIDE a circuit branch: scalar assertion rows
# (possibly at property-descended child locations), conditional
# requiredness, per-key property groups, and nested logical applicators.
# Anything else (item loops, additionalProperties scopes, $ref labels,
# propertyNames, contains, uniqueItems, ...) raises with a precise reason
# so `fallback_reasons()` can name the offending construct.
_CIRCUIT_OPS = frozenset(
    {
        OpCode.FAIL,
        OpCode.TYPE,
        OpCode.TYPE_ANY,
        OpCode.EQUAL,
        OpCode.EQUALS_ANY,
        OpCode.GREATER,
        OpCode.GREATER_EQUAL,
        OpCode.LESS,
        OpCode.LESS_EQUAL,
        OpCode.NUMBER_BOUNDS,
        OpCode.DIVISIBLE,
        OpCode.STRING_SIZE_GREATER,
        OpCode.STRING_SIZE_LESS,
        OpCode.STRING_BOUNDS,
        OpCode.REGEX,
        OpCode.ARRAY_SIZE_GREATER,
        OpCode.ARRAY_SIZE_LESS,
        OpCode.ARRAY_BOUNDS,
        OpCode.OBJECT_SIZE_GREATER,
        OpCode.OBJECT_SIZE_LESS,
        OpCode.DEFINES,
        OpCode.DEFINES_ALL,
        OpCode.PROPERTY_TYPE,
        OpCode.LOOP_PROPERTIES_MATCH,
        # handler raises its own precise "additionalProperties: false
        # inside a logical applicator" reason
        OpCode.LOOP_PROPERTIES_MATCH_CLOSED,
        OpCode.AND,
        OpCode.OR,
        OpCode.XOR,
        OpCode.NOT,
        OpCode.CONDITION,
        OpCode.WHEN_TYPE,
        OpCode.WHEN_DEFINES,
        OpCode.WHEN_ARRAY_SIZE_GREATER,
        OpCode.WHEN_ARRAY_SIZE_EQUAL,
    }
)


def build_tape(
    compiled: CompiledSchema,
    *,
    unroll_depth: int = DEFAULT_UNROLL_DEPTH,
    unroll_node_budget: int = DEFAULT_UNROLL_NODE_BUDGET,
) -> LocationTape:
    """Lower a compiled schema to the tensor tape; raises
    :class:`UnsupportedForBatch` outside the structural subset.

    Shared and recursive ``$ref`` labels (``ControlLabel``/``ControlJump``)
    are unrolled into the flat tape up to ``unroll_depth`` re-expansions
    per label (and ``unroll_node_budget`` total locations); past the
    budget the lowering marks *frontier* locations whose documents the
    batched executor flags undecided (DESIGN.md §9).
    """
    b = _TapeBuilder(
        compiled.labels,
        unroll_depth=unroll_depth,
        unroll_node_budget=unroll_node_budget,
    )
    root = b.new_loc()
    b.add_group(compiled.instructions, root)
    tape = b.build()
    if os.environ.get("REPRO_LINT_TAPES"):
        # structural-invariant linter (DESIGN.md §15); lazy import --
        # analysis sits above core in the layering
        from ..analysis.lint_tape import assert_tape

        assert_tape(tape, label="build_tape")
    return tape


def try_build_tape(
    compiled: CompiledSchema,
    *,
    unroll_depth: int = DEFAULT_UNROLL_DEPTH,
    unroll_node_budget: int = DEFAULT_UNROLL_NODE_BUDGET,
) -> Tuple[Optional[LocationTape], str]:
    """Build the tape or report why the schema is not batchable."""
    try:
        return (
            build_tape(
                compiled,
                unroll_depth=unroll_depth,
                unroll_node_budget=unroll_node_budget,
            ),
            "",
        )
    except UnsupportedForBatch as exc:
        return None, str(exc)
