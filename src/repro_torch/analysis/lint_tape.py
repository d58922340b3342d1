"""Static invariant checker for LocationTape / LinkedTape.

Every tape transform in this repo (build, unroll, circuit wiring,
segment + relink) must preserve the layout contracts the batched
executor compiles against.  ``lint_tape`` re-derives each contract
from the raw arrays and reports violations as human-readable strings;
``assert_tape`` raises :class:`TapeLintError` on the first dirty tape.

Invariants checked (DESIGN.md §15):

- array shape consistency across the prop/psort/loc/asrt/circ tables
  and their provenance sidecars;
- owner-sorted CSR windows: per-location ``loc_asrt_start/len`` are
  contiguous, disjoint, cover exactly the real assertion rows, agree
  with ``asrt_owner``, keep AND rows (group 0) ahead of contiguous
  OR-groups, and ``max_rows_per_loc`` equals the widest window;
- psort segment integrity: the hash-sorted view is a permutation of
  the property table (via ``psort_orig_row``), lanes sort
  lexicographically *within* each member segment, equal-hash run
  lengths are correct and never span members, and ``max_hash_run``
  matches;
- location DAG: every transition edge (property child, addl, item,
  prefix) points strictly forward (acyclic by construction), depth DP
  reproduces ``max_loc_depth``, and sentinel domains hold;
- frontier consistency: no edge targets a ``loc_frontier`` location
  (all were snapped to the ``LOC_FRONTIER`` sentinel at build time);
- circuits: parents-first storage (``circ_parent[c] < c``), owners in
  range, recomputed bottom-up levels match ``circ_level`` and
  ``max_circ_depth``, leaf wiring ids in range;
- required-slot masks: every mask bit is backed by a property row
  carrying that slot, slots < 32;
- linked tapes: member offsets strictly monotonic and consistent with
  per-member counts, ``roots``/``member_prop_start`` mirror the
  offset tables, per-member horizons reproduce from the DAG, and
  per-member frontier/circuit counts add up.

CLI::

    python -m repro_torch.analysis.lint_tape --presets [--device cpu]   # registry presets + linked group tapes
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from ..core.tape import LOC_FRONTIER, LOC_INVALID, LOC_UNTRACKED, LocationTape

__all__ = ["TapeLintError", "lint_tape", "assert_tape", "main"]

_SENTINELS = (-1, LOC_UNTRACKED, LOC_INVALID, LOC_FRONTIER)


class TapeLintError(AssertionError):
    """A tape violates a layout invariant the executor relies on."""


def assert_tape(tape: LocationTape, *, label: str = "") -> None:
    problems = lint_tape(tape)
    if problems:
        prefix = f"[{label}] " if label else ""
        raise TapeLintError(prefix + "; ".join(problems))


def lint_tape(tape: LocationTape) -> List[str]:
    """Return every invariant violation found (empty list = clean)."""
    out: List[str] = []
    say = out.append

    L = tape.n_locations
    M = tape.n_props
    A = tape.n_assertions
    C = tape.n_circuits

    # ---- shapes --------------------------------------------------------
    for name, arr, want in (
        ("prop_owner", tape.prop_owner, M),
        ("prop_child_loc", tape.prop_child_loc, M),
        ("prop_required_slot", tape.prop_required_slot, M),
        ("psort_owner", tape.psort_owner, M),
        ("psort_child_loc", tape.psort_child_loc, M),
        ("psort_required_slot", tape.psort_required_slot, M),
        ("psort_orig_row", tape.psort_orig_row, M),
        ("psort_run_len", tape.psort_run_len, M),
        ("loc_closed", tape.loc_closed, L),
        ("loc_addl", tape.loc_addl, L),
        ("loc_item", tape.loc_item, L),
        ("loc_item_start", tape.loc_item_start, L),
        ("loc_prefix_start", tape.loc_prefix_start, L),
        ("loc_prefix_len", tape.loc_prefix_len, L),
        ("loc_required_mask", tape.loc_required_mask, L),
        ("loc_asrt_start", tape.loc_asrt_start, L),
        ("loc_asrt_len", tape.loc_asrt_len, L),
        ("asrt_op", tape.asrt_op, A),
        ("asrt_group", tape.asrt_group, A),
        ("asrt_f0", tape.asrt_f0, A),
        ("asrt_i0", tape.asrt_i0, A),
        ("asrt_i1", tape.asrt_i1, A),
        ("asrt_u0", tape.asrt_u0, A),
        ("asrt_u1", tape.asrt_u1, A),
        ("asrt_circ", tape.asrt_circ, A),
        ("loc_frontier", tape.loc_frontier, L),
        ("circ_kind", tape.circ_kind, C),
        ("circ_parent", tape.circ_parent, C),
        ("circ_owner", tape.circ_owner, C),
        ("circ_level", tape.circ_level, C),
    ):
        if arr is None or len(arr) != want:
            say(f"shape: {name} has {0 if arr is None else len(arr)} rows, want {want}")
    if tape.prop_hash.shape != (M, 8):
        say(f"shape: prop_hash {tape.prop_hash.shape} != ({M}, 8)")
    if tape.psort_hash.shape != (M, 8):
        say(f"shape: psort_hash {tape.psort_hash.shape} != ({M}, 8)")
    if tape.asrt_hash.shape != (A, 8):
        say(f"shape: asrt_hash {tape.asrt_hash.shape} != ({A}, 8)")
    if tape.asrt_path is not None and len(tape.asrt_path) != A:
        say(f"shape: asrt_path has {len(tape.asrt_path)} entries, want {A}")
    if tape.loc_closed_path is not None and len(tape.loc_closed_path) != L:
        say(f"shape: loc_closed_path has {len(tape.loc_closed_path)} entries, want {L}")
    if tape.loc_required_info is not None and len(tape.loc_required_info) != L:
        say(f"shape: loc_required_info has {len(tape.loc_required_info)} entries, want {L}")
    if tape.circ_path is not None and len(tape.circ_path) != C:
        say(f"shape: circ_path has {len(tape.circ_path)} entries, want {C}")
    if out:
        return out  # downstream checks index by these shapes

    linked = tape.roots is not None and len(tape.roots) > 1
    S = tape.n_members if tape.roots is not None else 1

    # member location ranges (single tape: one member spanning all)
    if tape.roots is not None:
        loc_off = np.asarray(tape.roots, np.int64)
    else:
        loc_off = np.zeros(1, np.int64)
    loc_end = np.concatenate([loc_off[1:], [L]])

    real_a = tape.asrt_owner >= 0
    nA = int(np.count_nonzero(real_a))
    real_p = tape.prop_owner >= 0
    nM = int(np.count_nonzero(real_p))

    # ---- owner-sorted CSR windows --------------------------------------
    pos = 0
    for l in range(L):
        start = int(tape.loc_asrt_start[l])
        ln = int(tape.loc_asrt_len[l])
        if ln < 0:
            say(f"csr: negative window length at loc {l}")
            break
        if ln and start != pos:
            say(f"csr: window at loc {l} starts at {start}, expected {pos} (gap/overlap)")
            break
        if ln:
            if start + ln > nA:
                say(f"csr: window at loc {l} overruns real rows ({start}+{ln} > {nA})")
                break
            owners = tape.asrt_owner[start : start + ln]
            if not np.all(owners == l):
                say(f"csr: rows in loc {l}'s window owned by {set(owners.tolist()) - {l}}")
            groups = tape.asrt_group[start : start + ln]
            if np.any(np.diff(groups) < 0):
                say(f"csr: OR-groups not contiguous/sorted in loc {l}'s window")
            pos = start + ln
    else:
        if pos != nA:
            say(f"csr: windows cover {pos} rows, tape has {nA} real rows")
    want_ahat = int(tape.loc_asrt_len.max()) if L else 0
    if tape.max_rows_per_loc != want_ahat:
        say(f"csr: max_rows_per_loc {tape.max_rows_per_loc} != widest window {want_ahat}")

    # ---- psort permutation + segment integrity -------------------------
    if linked or tape.member_prop_start is not None:
        seg_start = np.asarray(tape.member_prop_start, np.int64)
        seg_len = np.asarray(tape.member_prop_len, np.int64)
    else:
        seg_start = np.zeros(1, np.int64)
        seg_len = np.array([nM], np.int64)
    if int(seg_len.sum()) != nM:
        say(f"psort: member segments cover {int(seg_len.sum())} rows, tape has {nM}")
    if tape.max_member_props is not None and len(seg_len) and int(seg_len.max()) != int(tape.max_member_props):
        say(f"psort: max_member_props {tape.max_member_props} != widest segment {int(seg_len.max())}")
    orig = tape.psort_orig_row
    if nM:
        if sorted(orig[:nM].tolist()) != list(range(nM)):
            say("psort: psort_orig_row is not a permutation of the real property rows")
        else:
            if not np.array_equal(tape.psort_owner[:nM], tape.prop_owner[orig[:nM]]):
                say("psort: psort_owner disagrees with prop_owner[psort_orig_row]")
            if not np.array_equal(tape.psort_hash[:nM], tape.prop_hash[orig[:nM]]):
                say("psort: psort_hash disagrees with prop_hash[psort_orig_row]")
            if not np.array_equal(tape.psort_child_loc[:nM], tape.prop_child_loc[orig[:nM]]):
                say("psort: psort_child_loc disagrees with prop_child_loc[psort_orig_row]")
            if not np.array_equal(tape.psort_required_slot[:nM], tape.prop_required_slot[orig[:nM]]):
                say("psort: psort_required_slot disagrees with prop_required_slot[psort_orig_row]")
    max_run = 0
    for s in range(len(seg_start)):
        a, b = int(seg_start[s]), int(seg_start[s] + seg_len[s])
        if b > nM or a > b:
            say(f"psort: member {s} segment [{a}, {b}) outside real rows [0, {nM})")
            continue
        lanes = tape.psort_hash[a:b]
        if len(lanes) > 1:
            flat = [tuple(int(x) for x in row) for row in lanes]
            if flat != sorted(flat):
                say(f"psort: member {s} lanes not lexicographically sorted")
        if len(lanes):
            run_id = np.zeros(len(lanes), np.int64)
            for r in range(1, len(lanes)):
                run_id[r] = run_id[r - 1] + (0 if np.array_equal(lanes[r], lanes[r - 1]) else 1)
            sizes = np.bincount(run_id)
            want = sizes[run_id]
            got = tape.psort_run_len[a:b]
            if not np.array_equal(got, want):
                say(f"psort: member {s} run lengths wrong")
            max_run = max(max_run, int(sizes.max()))
        if tape.psort_member is not None:
            if not np.all(tape.psort_member[a:b] == s):
                say(f"psort: psort_member mislabels member {s}'s segment")
    if tape.max_hash_run != max_run:
        say(f"psort: max_hash_run {tape.max_hash_run} != observed {max_run}")

    # ---- location DAG / sentinels / frontier ---------------------------
    frontier = np.asarray(tape.loc_frontier, bool)

    def check_targets(name: str, owners: np.ndarray, targets: np.ndarray) -> None:
        for owner, tgt in zip(owners.tolist(), targets.tolist()):
            if tgt in _SENTINELS:
                continue
            if not (0 <= tgt < L):
                say(f"dag: {name} target {tgt} outside locations and sentinel domain")
            elif frontier[tgt]:
                say(f"dag: {name} edge {owner}->{tgt} targets a frontier location (unsnapped)")
            elif tgt <= owner:
                say(f"dag: {name} edge {owner}->{tgt} not strictly forward")

    check_targets("prop", tape.prop_owner[real_p], tape.prop_child_loc[real_p])
    loc_ids = np.arange(L)
    check_targets("addl", loc_ids, tape.loc_addl)
    check_targets("item", loc_ids, tape.loc_item)
    n_pfx_real = int(tape.loc_prefix_len.sum())
    ppos = 0
    for l in range(L):
        a = int(tape.loc_prefix_start[l])
        n = int(tape.loc_prefix_len[l])
        if n < 0 or (n and a != ppos):
            say(f"dag: prefix window at loc {l} not contiguous")
            break
        if n:
            if a + n > len(tape.prefix_loc):
                say(f"dag: prefix window at loc {l} overruns prefix_loc")
                break
            check_targets("prefix", np.full(n, l), tape.prefix_loc[a : a + n])
            ppos = a + n
    else:
        if ppos != n_pfx_real:
            say(f"dag: prefix windows cover {ppos} rows, table declares {n_pfx_real}")

    # depth DP reproduction: collect every real forward edge, then one
    # ascending pass (edges only point forward, so dist[u] is final
    # before any edge out of u is relaxed)
    all_edges = [
        (int(o), int(t))
        for o, t in zip(tape.prop_owner[real_p], tape.prop_child_loc[real_p])
        if 0 <= t < L and t > o and not frontier[t]
    ]
    for u in range(L):
        for v in (int(tape.loc_addl[u]), int(tape.loc_item[u])):
            if 0 <= v < L and v > u and not frontier[v]:
                all_edges.append((u, v))
        a, n = int(tape.loc_prefix_start[u]), int(tape.loc_prefix_len[u])
        for v in tape.prefix_loc[a : a + n].tolist():
            if 0 <= v < L and v > u and not frontier[v]:
                all_edges.append((u, v))
    dist = np.zeros(max(1, L), np.int64)
    for u, v in sorted(all_edges):
        dist[v] = max(dist[v], dist[u] + 1)
    want_depth = int(dist.max()) if L else 0
    if tape.max_loc_depth != want_depth:
        say(f"dag: max_loc_depth {tape.max_loc_depth} != recomputed {want_depth}")
    if tape.member_horizons is not None:
        for s in range(S):
            seg = slice(int(loc_off[s]), int(loc_end[s]))
            member_depth = int(dist[seg].max()) if loc_end[s] > loc_off[s] else 0
            if int(tape.member_horizons[s]) != member_depth + 1:
                say(
                    f"linked: member {s} horizon {int(tape.member_horizons[s])}"
                    f" != recomputed {member_depth + 1}"
                )
    if bool(frontier.any()) and tape.unroll_depth < 1:
        say("dag: frontier locations present but unroll_depth < 1")

    # ---- required-slot masks -------------------------------------------
    if np.any(tape.prop_required_slot[real_p] >= 32):
        say("required: property slot >= 32 overflows the uint32 mask")
    slot_index = {}
    for o, sl in zip(tape.prop_owner[real_p].tolist(), tape.prop_required_slot[real_p].tolist()):
        if sl >= 0:
            slot_index.setdefault(o, set()).add(sl)
    for l in range(L):
        mask = int(tape.loc_required_mask[l])
        bit = 0
        while mask:
            if mask & 1 and bit not in slot_index.get(l, ()):
                say(f"required: loc {l} mask bit {bit} has no backing property row")
            mask >>= 1
            bit += 1

    # ---- circuits ------------------------------------------------------
    if C:
        for c in range(C):
            p = int(tape.circ_parent[c])
            if p != -1 and not (0 <= p < c):
                say(f"circ: node {c} parent {p} violates parents-first storage")
            o = int(tape.circ_owner[c])
            if not (0 <= o < L):
                say(f"circ: node {c} owner {o} out of range")
        level = np.zeros(C, np.int64)
        for c in range(C - 1, -1, -1):
            p = int(tape.circ_parent[c])
            if 0 <= p < c and level[p] <= level[c]:
                level[p] = level[c] + 1
        if not np.array_equal(level, np.asarray(tape.circ_level, np.int64)):
            say("circ: circ_level disagrees with recomputed bottom-up levels")
        want_cd = int(level.max())
        if tape.max_circ_depth != want_cd:
            say(f"circ: max_circ_depth {tape.max_circ_depth} != recomputed {want_cd}")
    elif tape.max_circ_depth != 0:
        say("circ: max_circ_depth nonzero without circuit nodes")
    bad_circ = [
        int(x) for x in tape.asrt_circ[real_a].tolist() if x != -1 and not (0 <= x < C)
    ]
    if bad_circ:
        say(f"circ: asrt_circ leaf ids {bad_circ[:4]} out of range [0, {C})")

    # ---- linked-tape member bookkeeping --------------------------------
    if tape.roots is not None:
        if int(loc_off[0]) != 0 or (S > 1 and bool(np.any(np.diff(loc_off) <= 0))):
            say("linked: loc_offsets not strictly increasing from 0")
        mnl = getattr(tape, "member_n_locations", None)
        if mnl is not None and not np.array_equal(
            np.asarray(mnl, np.int64), loc_end - loc_off
        ):
            say("linked: member_n_locations disagrees with loc_offsets")
        lofs = getattr(tape, "loc_offsets", None)
        if lofs is not None and not np.array_equal(np.asarray(lofs, np.int64), loc_off):
            say("linked: roots disagree with loc_offsets")
        pofs = getattr(tape, "prop_offsets", None)
        if pofs is not None and tape.member_prop_start is not None and not np.array_equal(
            np.asarray(pofs, np.int64), np.asarray(tape.member_prop_start, np.int64)
        ):
            say("linked: member_prop_start disagrees with prop_offsets")
        aofs = getattr(tape, "asrt_offsets", None)
        if aofs is not None and S and len(aofs) == S:
            # each member's assertion rows sit in [aofs[s], aofs[s+1])
            a_end = np.concatenate([np.asarray(aofs, np.int64)[1:], [nA]])
            for s in range(S):
                seg = tape.asrt_owner[int(aofs[s]) : int(a_end[s])]
                if len(seg) and (
                    int(seg.min()) < int(loc_off[s]) or int(seg.max()) >= int(loc_end[s])
                ):
                    say(f"linked: member {s} assertion owners stray outside its locations")
        mnf = getattr(tape, "member_n_frontier", None)
        if mnf is not None and len(mnf) == S:
            for s in range(S):
                cnt = int(np.count_nonzero(frontier[int(loc_off[s]) : int(loc_end[s])]))
                if cnt != int(mnf[s]):
                    say(f"linked: member {s} frontier count {int(mnf[s])} != {cnt}")
        mnc = getattr(tape, "member_n_circuits", None)
        if mnc is not None and len(mnc) == S and int(np.sum(mnc)) != C:
            say(f"linked: member_n_circuits sums to {int(np.sum(mnc))}, tape has {C}")

    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _lint_presets(verbose: bool = True, device=None) -> int:
    """Build every registry preset tape plus the linked group tapes and
    lint each (the registry on ``device``: cuda unless told otherwise);
    returns a process exit code."""
    from ..registry.presets import GATEWAY_SCHEMAS
    from ..registry.registry import SchemaRegistry

    failures = 0
    reg = SchemaRegistry(device=device)
    for name, schema in GATEWAY_SCHEMAS.items():
        reg.register(name, schema)
    for name in GATEWAY_SCHEMAS:
        entry = reg.get(name)
        if entry.tape is None:
            if verbose:
                print(f"  - {name}: not batchable ({entry.stats.fallback_reason}); skipped")
            continue
        problems = lint_tape(entry.tape)
        status = "ok" if not problems else "FAIL"
        if verbose or problems:
            print(f"  - {name} (v{entry.version}): {status}")
        for p in problems:
            failures += 1
            print(f"      {p}")
    for group in sorted(reg.groups(), key=lambda g: g.label):
        problems = lint_tape(group.tape)
        status = "ok" if not problems else "FAIL"
        if verbose or problems:
            print(f"  - group {group.label} {list(group.members)}: {status}")
        for p in problems:
            failures += 1
            print(f"      {p}")
    legacy = reg.linked_tape()
    if legacy is not None:
        problems = lint_tape(legacy)
        if verbose or problems:
            print(f"  - legacy linked tape: {'ok' if not problems else 'FAIL'}")
        for p in problems:
            failures += 1
            print(f"      {p}")
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="repro_torch.analysis.lint_tape", description=__doc__)
    ap.add_argument("--presets", action="store_true", help="lint registry preset + linked group tapes")
    ap.add_argument("-q", "--quiet", action="store_true", help="only print failures")
    ap.add_argument("--device", default="cuda", help="the registry's device: cuda or cpu")
    args = ap.parse_args(argv)
    if not args.presets:
        ap.error("nothing to lint: pass --presets")
    print("tape lint: registry presets")
    rc = _lint_presets(verbose=not args.quiet, device=args.device)
    print("tape lint:", "clean" if rc == 0 else "violations found")
    return rc


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
