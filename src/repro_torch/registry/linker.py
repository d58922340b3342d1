"""Tape linker: relocate and concatenate member tapes into one linked tape.

A real gateway hosts many endpoint schemas, but the batched executor
wants exactly one :class:`~repro.core.tape.LocationTape` per kernel
launch.  The linker turns N compiled member tapes into a single
**linked** tape whose location-id space is the disjoint union of the
members': member ``s``'s location ``l`` becomes global location
``loc_offsets[s] + l``.  Per-document roots are seeded from
``roots[schema_id]`` (each member's root is its local location 0), so a
heterogeneous batch validates in one launch, bit-identically to
dispatching per-schema sub-batches.

Relocation scheme (DESIGN.md §8):

- **location-valued columns** (``prop_child_loc``, ``loc_addl``,
  ``loc_item``, ``prefix_loc``, owners) shift by ``loc_offsets[s]``;
  the negative sentinels (``LOC_UNTRACKED``, ``LOC_INVALID``,
  ``LOC_FRONTIER``, ``-1``) are preserved untouched -- a member's
  $ref-unroll frontier edges stay frontier edges after relocation.
- **assertion rows** concatenate in member order.  Rows are owner-sorted
  within each member and member ``s``'s locations all precede member
  ``s+1``'s, so the concatenation stays *globally* owner-sorted and the
  CSR windows stay contiguous: ``loc_asrt_start`` shifts by the member's
  row offset, ``loc_asrt_len`` is untouched.
- **enum OR-group ids** shift by the running maximum so they stay
  globally unique (the dense layout reduces groups globally).
- **circuit nodes** (logical applicators, DESIGN.md §10) concatenate in
  member order: ``circ_parent`` and ``asrt_circ`` shift by the member's
  circuit offset (-1 sentinels preserved), ``circ_owner`` by its
  location offset, ``circ_level`` is untouched and ``max_circ_depth``
  recomputes as the member maximum.  Presence gating makes members'
  circuits no-ops for documents of other members (their owner locations
  are never instantiated), so no per-member masking is needed.
- the **hash-sorted property view** (``psort_*``) concatenates per-member
  sorted segments (``member_prop_start``/``member_prop_len``, each row
  tagged ``psort_member`` for introspection).  The executor's hash pass
  scans only the querying document's member segment, so candidate runs
  *never span members* -- K stays the member maximum instead of
  inflating on shared key names (two endpoints both using ``"name"``
  must not see each other's transition rows).
- ``max_rows_per_loc`` (A-hat), ``max_hash_run`` (K) and
  ``max_loc_depth`` recompute as member maxima; ``member_horizons``
  additionally keeps every member's own horizon so per-document
  ``decided`` does not inflate when members disagree on depth.

Segmenting (placeholder-stripping + array grabs) touches only one
member's arrays, so :class:`TapeSegment` objects are cacheable per
compiled schema version -- re-linking after a hot-swap is pure
concatenation over mostly-cached segments (the registry's incremental
re-link path).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.tape import LocationTape

__all__ = [
    "LinkedTape",
    "TapeSegment",
    "segment_tape",
    "link_tapes",
    "pow2_class",
    "group_signature",
    "signature_label",
]


# ---------------------------------------------------------------------------
# Link-group signatures (DESIGN.md §14)
#
# Linking inflates every member to the group maxima: Â (assertion window
# per node), M̂ (the member-windowed hash pass scans the fattest member's
# property rows) and the horizon (depth-loop trip count) all recompute as
# maxima over the linked members (§8).  One fat member therefore taxes
# every other member's launches -- the `charge` tagged union raising the
# shared Â 3→6 / M̂ 4→8 is the motivating case.  The registry avoids
# this by partitioning members into **link groups** of compatible
# signatures and cutting one linked tape per group.
#
# Compatibility is an equivalence relation so the partition is
# deterministic and independent of registration order: each window
# dimension is bucketed into its power-of-two ceiling class, and members
# sharing the class triple `(Â-class, M̂-class, horizon-class)` link
# together.  Within a group every dimension's linked maximum is bounded
# by the class, and any member sits within 2x of the group maximum
# (members of one class c all lie in (c/2, c]) -- in practice far
# closer, because the group constant is the max over *actual* member
# values, not the class ceiling.
# ---------------------------------------------------------------------------


def pow2_class(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def group_signature(tape: LocationTape) -> Tuple[int, int, int]:
    """The tape's link-group compatibility class: power-of-two ceilings
    of (Â, M̂, horizon) -- the three launch-cost constants that linking
    inflates to member maxima (§8)."""
    return (
        pow2_class(tape.max_rows_per_loc),
        pow2_class(tape.n_props),
        pow2_class(tape.max_loc_depth + 1),
    )


def signature_label(key: Tuple[int, int, int]) -> str:
    """Stable human-readable label for a group key (metrics/label-safe)."""
    return f"a{key[0]}.m{key[1]}.h{key[2]}"


@dataclass
class LinkedTape(LocationTape):
    """A LocationTape linked from N relocated member tapes.

    Executes on the unmodified batched executor (it *is* a
    ``LocationTape``); the extra fields record the member layout for
    introspection, tests and incremental re-linking.
    """

    members: Tuple[str, ...] = ()  # member names (endpoint ids) in order
    loc_offsets: Optional[np.ndarray] = None  # int32 (S,) location-id offset
    prop_offsets: Optional[np.ndarray] = None  # int32 (S,) property-row offset
    asrt_offsets: Optional[np.ndarray] = None  # int32 (S,) assertion-row offset
    member_n_locations: Optional[np.ndarray] = None  # int32 (S,)
    # per-member $ref-unroll metadata: the depth budget each member tape
    # was built with and how many frontier locations it carries (0 for
    # non-recursive members)
    member_unroll_depths: Optional[np.ndarray] = None  # int32 (S,)
    member_n_frontier: Optional[np.ndarray] = None  # int32 (S,)
    # per-member circuit-node counts (logical applicators)
    member_n_circuits: Optional[np.ndarray] = None  # int32 (S,)

    def member_of_location(self, loc: int) -> int:
        """Member index owning global location id ``loc``."""
        if not (0 <= loc < self.n_locations):
            raise IndexError(f"location {loc} outside [0, {self.n_locations})")
        return int(np.searchsorted(self.loc_offsets, loc, side="right") - 1)


@dataclass(frozen=True)
class TapeSegment:
    """One member tape's relocatable arrays, placeholders stripped.

    All arrays are views/copies of the member's own tape only, so a
    segment can be prepared once per (schema, version) and cached; the
    linker consumes segments and never re-reads the member tapes.
    """

    n_locations: int
    max_loc_depth: int
    # real property-transition rows (emission order)
    prop_owner: np.ndarray
    prop_hash: np.ndarray
    prop_child_loc: np.ndarray
    prop_required_slot: np.ndarray
    # hash-sorted view (sorted within the member; runs intact)
    psort_hash: np.ndarray
    psort_owner: np.ndarray
    psort_child_loc: np.ndarray
    psort_required_slot: np.ndarray
    psort_orig_row: np.ndarray
    psort_run_len: np.ndarray
    max_hash_run: int
    # per-location structural facts
    loc_closed: np.ndarray
    loc_addl: np.ndarray
    loc_item: np.ndarray
    loc_item_start: np.ndarray
    loc_prefix_start: np.ndarray
    loc_prefix_len: np.ndarray
    prefix_loc: np.ndarray  # real rows only
    loc_required_mask: np.ndarray
    # owner-sorted CSR assertion rows (real rows only)
    loc_asrt_start: np.ndarray
    loc_asrt_len: np.ndarray
    max_rows_per_loc: int
    asrt_owner: np.ndarray
    asrt_op: np.ndarray
    asrt_group: np.ndarray
    asrt_f0: np.ndarray
    asrt_i0: np.ndarray
    asrt_i1: np.ndarray
    asrt_u0: np.ndarray
    asrt_u1: np.ndarray
    asrt_hash: np.ndarray
    max_group: int
    # $ref-unroll facts (frontier locations mark exhausted budgets)
    loc_frontier: np.ndarray
    unroll_depth: int
    # logical-applicator circuits (real rows carry relocatable ids)
    asrt_circ: np.ndarray
    circ_kind: np.ndarray
    circ_parent: np.ndarray
    circ_owner: np.ndarray
    circ_level: np.ndarray
    max_circ_depth: int
    # provenance sidecars for first-failure attribution (DESIGN.md §12);
    # host-side tuples, aligned with the real rows above
    asrt_path: Tuple[str, ...] = ()
    loc_required_info: Tuple[Tuple[Tuple[int, str, str], ...], ...] = ()
    loc_closed_path: Tuple[str, ...] = ()
    circ_path: Tuple[str, ...] = ()

    @property
    def n_circuits(self) -> int:
        return len(self.circ_kind)

    @property
    def n_props(self) -> int:
        return len(self.prop_owner)

    @property
    def n_assertions(self) -> int:
        return len(self.asrt_owner)

    @property
    def n_prefix(self) -> int:
        return len(self.prefix_loc)


def segment_tape(tape: LocationTape) -> TapeSegment:
    """Strip the empty-table placeholder rows and freeze a member's arrays."""
    if tape.n_locations < 1:
        raise ValueError("member tape has no locations")
    if tape.n_members != 1:
        raise ValueError("cannot segment an already-linked tape")
    real_p = tape.prop_owner >= 0  # placeholder row only when 0 real rows
    real_a = tape.asrt_owner >= 0
    n_pfx = int(tape.loc_prefix_len.sum())  # placeholder [-1] when 0 rows
    return TapeSegment(
        n_locations=tape.n_locations,
        max_loc_depth=tape.max_loc_depth,
        prop_owner=tape.prop_owner[real_p],
        prop_hash=tape.prop_hash[real_p],
        prop_child_loc=tape.prop_child_loc[real_p],
        prop_required_slot=tape.prop_required_slot[real_p],
        psort_hash=tape.psort_hash[real_p],
        psort_owner=tape.psort_owner[real_p],
        psort_child_loc=tape.psort_child_loc[real_p],
        psort_required_slot=tape.psort_required_slot[real_p],
        psort_orig_row=tape.psort_orig_row[real_p],
        psort_run_len=tape.psort_run_len[real_p],
        max_hash_run=tape.max_hash_run,
        loc_closed=tape.loc_closed,
        loc_addl=tape.loc_addl,
        loc_item=tape.loc_item,
        loc_item_start=tape.loc_item_start,
        loc_prefix_start=tape.loc_prefix_start,
        loc_prefix_len=tape.loc_prefix_len,
        prefix_loc=tape.prefix_loc[:n_pfx],
        loc_required_mask=tape.loc_required_mask,
        loc_asrt_start=tape.loc_asrt_start,
        loc_asrt_len=tape.loc_asrt_len,
        max_rows_per_loc=tape.max_rows_per_loc,
        asrt_owner=tape.asrt_owner[real_a],
        asrt_op=tape.asrt_op[real_a],
        asrt_group=tape.asrt_group[real_a],
        asrt_f0=tape.asrt_f0[real_a],
        asrt_i0=tape.asrt_i0[real_a],
        asrt_i1=tape.asrt_i1[real_a],
        asrt_u0=tape.asrt_u0[real_a],
        asrt_u1=tape.asrt_u1[real_a],
        asrt_hash=tape.asrt_hash[real_a],
        max_group=int(tape.asrt_group.max()) if len(tape.asrt_group) else 0,
        loc_frontier=tape.loc_frontier,
        unroll_depth=tape.unroll_depth,
        asrt_circ=tape.asrt_circ[real_a],
        circ_kind=tape.circ_kind,
        circ_parent=tape.circ_parent,
        circ_owner=tape.circ_owner,
        circ_level=tape.circ_level,
        max_circ_depth=tape.max_circ_depth,
        asrt_path=tuple(
            p for p, r in zip(tape.asrt_path, real_a) if r
        ),
        loc_required_info=tuple(tape.loc_required_info),
        loc_closed_path=tuple(tape.loc_closed_path),
        circ_path=tuple(tape.circ_path),
    )


def _reloc(a: np.ndarray, off: int) -> np.ndarray:
    """Shift location ids by ``off``, preserving negative sentinels."""
    return np.where(a >= 0, a + np.int32(off), a).astype(np.int32)


def _exclusive_cumsum(counts: List[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int32) if counts else np.zeros(0, np.int32)


def link_tapes(
    tapes: Optional[Sequence[LocationTape]] = None,
    *,
    names: Optional[Sequence[str]] = None,
    segments: Optional[Sequence[TapeSegment]] = None,
) -> LinkedTape:
    """Link member tapes (or pre-cut segments) into one LinkedTape.

    Pass ``tapes`` for the one-shot path or ``segments`` (from
    :func:`segment_tape`, cacheable) for the incremental path; ``names``
    labels the members (defaults to ``"member<i>"``).
    """
    if segments is None:
        if not tapes:
            raise ValueError("link_tapes needs at least one member tape")
        segments = [segment_tape(t) for t in tapes]
    segments = list(segments)
    if not segments:
        raise ValueError("link_tapes needs at least one member")
    if names is None:
        names = [f"member{i}" for i in range(len(segments))]
    if len(names) != len(segments):
        raise ValueError("names/segments length mismatch")

    loc_off = _exclusive_cumsum([s.n_locations for s in segments])
    prop_off = _exclusive_cumsum([s.n_props for s in segments])
    asrt_off = _exclusive_cumsum([s.n_assertions for s in segments])
    pfx_off = _exclusive_cumsum([s.n_prefix for s in segments])

    cat = np.concatenate

    def cat_loc(field: str) -> np.ndarray:  # plain per-location concat
        return cat([getattr(s, field) for s in segments])

    # property table + hash-sorted view: owners/children relocate by the
    # member's location offset, original-row tie-break indices by its
    # property-row offset, and every psort row is tagged with its member
    prop_owner = cat([s.prop_owner + lo for s, lo in zip(segments, loc_off)])
    prop_child = cat([_reloc(s.prop_child_loc, lo) for s, lo in zip(segments, loc_off)])
    psort_member = cat(
        [np.full(s.n_props, i, np.int32) for i, s in enumerate(segments)]
    ) if prop_owner.size else np.zeros(0, np.int32)

    # enum OR-group ids stay globally unique: shift nonzero groups by the
    # running per-member maximum
    grp_off = _exclusive_cumsum([s.max_group for s in segments])
    asrt_group = cat(
        [np.where(s.asrt_group > 0, s.asrt_group + go, 0) for s, go in zip(segments, grp_off)]
    ).astype(np.int32)

    # circuit nodes concatenate; leaf wiring and parent pointers shift by
    # the member's circuit offset, owners by its location offset
    circ_off = _exclusive_cumsum([s.n_circuits for s in segments])
    asrt_circ = cat(
        [_reloc(s.asrt_circ, co) for s, co in zip(segments, circ_off)]
    ).astype(np.int32)
    circ_kind = cat([s.circ_kind for s in segments]).astype(np.int32)
    circ_parent = cat(
        [_reloc(s.circ_parent, co) for s, co in zip(segments, circ_off)]
    ).astype(np.int32)
    circ_owner = cat(
        [s.circ_owner + lo for s, lo in zip(segments, loc_off)]
    ).astype(np.int32)
    circ_level = cat([s.circ_level for s in segments]).astype(np.int32)

    linked = dict(
        n_locations=int(loc_off[-1]) + segments[-1].n_locations,
        max_loc_depth=max(s.max_loc_depth for s in segments),
        prop_owner=prop_owner.astype(np.int32),
        prop_hash=cat([s.prop_hash for s in segments]) if prop_owner.size else np.zeros((0, 8), np.uint32),
        prop_child_loc=prop_child,
        prop_required_slot=cat([s.prop_required_slot for s in segments]).astype(np.int32) if prop_owner.size else np.zeros(0, np.int32),
        psort_hash=cat([s.psort_hash for s in segments]) if prop_owner.size else np.zeros((0, 8), np.uint32),
        psort_owner=cat([s.psort_owner + lo for s, lo in zip(segments, loc_off)]).astype(np.int32),
        psort_child_loc=cat([_reloc(s.psort_child_loc, lo) for s, lo in zip(segments, loc_off)]),
        psort_required_slot=cat([s.psort_required_slot for s in segments]).astype(np.int32) if prop_owner.size else np.zeros(0, np.int32),
        psort_orig_row=cat([s.psort_orig_row + po for s, po in zip(segments, prop_off)]).astype(np.int32),
        psort_run_len=cat([s.psort_run_len for s in segments]).astype(np.int32) if prop_owner.size else np.zeros(0, np.int32),
        max_hash_run=max(s.max_hash_run for s in segments),
        loc_closed=cat_loc("loc_closed"),
        loc_addl=cat([_reloc(s.loc_addl, lo) for s, lo in zip(segments, loc_off)]),
        loc_item=cat([_reloc(s.loc_item, lo) for s, lo in zip(segments, loc_off)]),
        loc_item_start=cat_loc("loc_item_start").astype(np.int32),
        loc_prefix_start=cat([s.loc_prefix_start + po for s, po in zip(segments, pfx_off)]).astype(np.int32),
        loc_prefix_len=cat_loc("loc_prefix_len").astype(np.int32),
        prefix_loc=cat([_reloc(s.prefix_loc, lo) for s, lo in zip(segments, loc_off)]),
        loc_required_mask=cat_loc("loc_required_mask").astype(np.uint32),
        loc_asrt_start=cat([s.loc_asrt_start + ao for s, ao in zip(segments, asrt_off)]).astype(np.int32),
        loc_asrt_len=cat_loc("loc_asrt_len").astype(np.int32),
        max_rows_per_loc=max(s.max_rows_per_loc for s in segments),
        asrt_owner=cat([s.asrt_owner + lo for s, lo in zip(segments, loc_off)]).astype(np.int32),
        asrt_op=cat([s.asrt_op for s in segments]).astype(np.int32),
        asrt_group=asrt_group,
        asrt_f0=cat([s.asrt_f0 for s in segments]).astype(np.float64),
        asrt_i0=cat([s.asrt_i0 for s in segments]).astype(np.int32),
        asrt_i1=cat([s.asrt_i1 for s in segments]).astype(np.int32),
        asrt_u0=cat([s.asrt_u0 for s in segments]).astype(np.uint32),
        asrt_u1=cat([s.asrt_u1 for s in segments]).astype(np.uint32),
        asrt_hash=cat([s.asrt_hash for s in segments]).astype(np.uint32),
        psort_member=psort_member,
        roots=loc_off.copy(),
        member_horizons=np.array([s.max_loc_depth + 1 for s in segments], np.int32),
        member_prop_start=prop_off.copy(),
        member_prop_len=np.array([s.n_props for s in segments], np.int32),
        max_member_props=max(s.n_props for s in segments),
        # per-location frontier flags concatenate in member order (no
        # relocation needed; LOC_FRONTIER sentinels in the location-
        # valued columns above pass through ``_reloc`` untouched)
        loc_frontier=cat([s.loc_frontier for s in segments]).astype(bool),
        unroll_depth=max(s.unroll_depth for s in segments),
        asrt_circ=asrt_circ,
        circ_kind=circ_kind,
        circ_parent=circ_parent,
        circ_owner=circ_owner,
        circ_level=circ_level,
        max_circ_depth=max(s.max_circ_depth for s in segments),
        # provenance sidecars concatenate alongside their row tables
        asrt_path=sum((s.asrt_path for s in segments), ()),
        loc_required_info=sum((s.loc_required_info for s in segments), ()),
        loc_closed_path=sum((s.loc_closed_path for s in segments), ()),
        circ_path=sum((s.circ_path for s in segments), ()),
    )

    # empty-table placeholders, mirroring _TapeBuilder.build(): the
    # executor's gathers need at least one row per table
    if linked["prop_owner"].size == 0:
        linked.update(
            prop_owner=np.full(1, -1, np.int32),
            prop_hash=np.zeros((1, 8), np.uint32),
            prop_child_loc=np.full(1, -2, np.int32),
            prop_required_slot=np.full(1, -1, np.int32),
            psort_hash=np.zeros((1, 8), np.uint32),
            psort_owner=np.full(1, -1, np.int32),
            psort_child_loc=np.full(1, -2, np.int32),
            psort_required_slot=np.full(1, -1, np.int32),
            psort_orig_row=np.zeros(1, np.int32),
            psort_run_len=np.zeros(1, np.int32),
            psort_member=np.zeros(1, np.int32),
        )
    if linked["asrt_owner"].size == 0:
        linked.update(
            asrt_owner=np.full(1, -1, np.int32),
            asrt_op=np.zeros(1, np.int32),
            asrt_group=np.zeros(1, np.int32),
            asrt_f0=np.zeros(1, np.float64),
            asrt_i0=np.zeros(1, np.int32),
            asrt_i1=np.zeros(1, np.int32),
            asrt_u0=np.zeros(1, np.uint32),
            asrt_u1=np.zeros(1, np.uint32),
            asrt_hash=np.zeros((1, 8), np.uint32),
            asrt_circ=np.full(1, -1, np.int32),
            asrt_path=("",),
        )
    if linked["prefix_loc"].size == 0:
        linked["prefix_loc"] = np.full(1, -1, np.int32)

    out = LinkedTape(
        members=tuple(names),
        loc_offsets=loc_off,
        prop_offsets=prop_off,
        asrt_offsets=asrt_off,
        member_n_locations=np.array([s.n_locations for s in segments], np.int32),
        member_unroll_depths=np.array([s.unroll_depth for s in segments], np.int32),
        member_n_frontier=np.array(
            [int(np.count_nonzero(s.loc_frontier)) for s in segments], np.int32
        ),
        member_n_circuits=np.array([s.n_circuits for s in segments], np.int32),
        **linked,
    )
    if os.environ.get("REPRO_LINT_TAPES"):
        # structural-invariant linter (DESIGN.md §15); lazy import --
        # analysis sits above the linker in the layering
        from ..analysis.lint_tape import assert_tape

        assert_tape(out, label="link_tapes")
    return out
