"""Batched schema validation over token tables, in PyTorch on the GPU.

The port of the JAX package's ``core/batch_executor.py`` (CSR layout): it
validates B documents against one compiled location tape, which may be a
multi-member *linked* tape (``registry/linker.py``) with per-document
``schema_ids``, and gives bit-identical ``(valid, decided, frontier)``.
The pipeline is the reference's:

1. **Location propagation** -- one owner-blind ``hash_match`` kernel pass
   over all B*N nodes finds each object member's candidate run in the
   hash-sorted property rows (owner = the document's member id, so a linked
   tape needs no member-windowed variant); the depth loop then resolves
   each node's location from its parent's over the K candidates.
2. **Required tracking** -- matched children add their required-slot bit
   into the parent's acquired mask (one ``index_add_``).
3. **Assertion evaluation** -- the ``assertion_eval_window`` kernel reads
   each node's location's CSR window (<= Â rows) from the tape and
   computes the (nodes x Â) pass matrix; enum OR-groups reduce with a
   segmented suffix OR over the window.
3b. **Circuit reduce** (DESIGN.md §10) -- circuit leaves are read at one
   anchor node per (document, location) and reduced bottom-up.
4. **Reduce** -- AND over nodes per document, plus the depth-budget and
   unroll-frontier ``decided`` flags.

``layout="dense"`` is the reference's full-matrix baseline: the depth loop
runs all ``max_depth`` iterations with one ``hash_match`` per iteration
over the unsorted property table (owner = the parent's location), and the
``assertion_eval`` kernel computes the (nodes x A) pass matrix of every
node against every row, reduced by row ownership and OR-group.  Both
layouts give bit-identical ``(valid, decided, frontier)``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where the kernels' plain PyTorch versions run instead.  ``explain_batch``
is not ported yet and raises.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..obs.profile import phase as _phase
from ..obs.trace import span as _span, trace_point as _trace_point
from .nodetypes import T_ARR as _T_ARR, T_OBJ as _T_OBJ
from .outcomes import fault_hook_armed, fault_point
from .tape import (
    CK_AND,
    CK_NOT,
    CK_OR,
    LOC_FRONTIER,
    LOC_INVALID,
    LOC_UNTRACKED,
    LocationTape,
)

__all__ = ["BatchValidator", "resolve_device"]

_BIG = 2**30
_CIRC_FLAG = 1 << 20  # packed circuit-membership bit in asrt_gcode


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    A missing GPU raises; it never falls back to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def _circuit_leaf_units(tape: LocationTape):
    """Static circuit-leaf wiring: which row/group feeds which node.

    Returns ``(and_units, group_units)``: AND units are
    ``(circ, owner_loc, row, window_slot)`` for plain circuit rows, group
    units ``(circ, owner_loc, group_id, window_slot_of_start)`` for
    circuit enum groups (rows are (owner, group)-sorted, so the first row
    of a group is its window start).
    """
    owner = np.asarray(tape.asrt_owner)
    grp = np.asarray(tape.asrt_group)
    circ = np.asarray(tape.asrt_circ)
    start = np.asarray(tape.loc_asrt_start)
    and_units, group_units = [], []
    seen_groups = set()
    for r in range(len(owner)):
        c = int(circ[r])
        if c < 0:
            continue
        o = int(owner[r])
        g = int(grp[r])
        s = r - int(start[o])
        if g == 0:
            and_units.append((c, o, r, s))
        elif g not in seen_groups:
            seen_groups.add(g)
            group_units.append((c, o, g, s))
    return tuple(and_units), tuple(group_units)


def _circuit_static_wiring(tape: LocationTape, device: torch.device):
    """All compile-time circuit metadata for the executor.

    Every location a circuit touches gets a compact *anchor rank*, so the
    executor resolves per document the single node at each such location
    (unique-path precondition) and evaluates leaves and presence as
    (B, U)/(B, C) gathers.  Each leaf unit reads one column of a pass
    matrix at its anchor node: a window slot in the CSR layout, an
    assertion row (AND units) or OR-group verdict (group units) in the
    dense layout.  Index columns are shipped to ``device`` once.
    """
    and_units, group_units = _circuit_leaf_units(tape)
    # OR-groups outside every circuit, by group id - 1 (all rows of a group
    # share its circuit: a group comes from one enum lowering)
    grp = np.asarray(tape.asrt_group)
    plain_groups = np.ones(int(grp.max(initial=0)), bool)
    plain_groups[grp[(grp > 0) & (np.asarray(tape.asrt_circ) >= 0)] - 1] = False
    circ_owner = np.asarray(tape.circ_owner, np.int32)
    unit_owners = [u[1] for u in and_units] + [u[1] for u in group_units]
    owner_locs = np.unique(
        np.concatenate([circ_owner, np.asarray(unit_owners, np.int32)])
    ) if (len(circ_owner) or unit_owners) else np.zeros(0, np.int32)
    rank_of = {l: r for r, l in enumerate(owner_locs.tolist())}

    def dev(values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64), device=device)

    return {
        "kind": np.asarray(tape.circ_kind, np.int32),
        "parent": np.asarray(tape.circ_parent, np.int32),
        "and_units": and_units,
        "group_units": group_units,
        "owner_locs": dev(owner_locs).to(torch.int32),
        "circ_ranks": dev([rank_of[int(l)] for l in circ_owner]),
        "and_ranks": dev([rank_of[u[1]] for u in and_units]),
        "group_ranks": dev([rank_of[u[1]] for u in group_units]),
        # CSR layout: the window slot each leaf unit reads at its anchor
        "and_slots": dev([u[3] for u in and_units]),
        "group_slots": dev([u[3] for u in group_units]),
        # dense layout: the assertion row / OR-group verdict column
        "and_rows": dev([u[2] for u in and_units]),
        "group_idx": dev([u[2] - 1 for u in group_units]),
        "plain_groups": torch.as_tensor(plain_groups, device=device),
    }


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _u32_view(a) -> np.ndarray:
    """uint32 words as an int32 view (torch has little uint32 support)."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


def _tape_consts(tape: LocationTape, device: torch.device) -> Dict[str, torch.Tensor]:
    # the packed gcode column reserves bit 20 for circuit membership: a
    # linked tape accumulating that many distinct OR-group ids must fail
    # loudly, never silently misdecode enum rows as circuit rows
    if int(np.asarray(tape.asrt_group).max(initial=0)) >= _CIRC_FLAG:
        raise ValueError("OR-group id space exceeds the gcode circuit-flag bit")
    psort_owner = _i32(tape.psort_owner)
    group = _i32(tape.asrt_group)
    host = {
        "psort_hash": _u32_view(tape.psort_hash),
        "psort_owner": psort_owner,
        # hash_match table owner: the row's member id; the empty-table
        # placeholder gets the padding owner -9 so all-zero key lanes
        # cannot hit it
        "psort_match_owner": _i32(
            np.where(psort_owner >= 0, np.asarray(tape.psort_member), -9)
        ),
        "psort_child_loc": _i32(tape.psort_child_loc),
        "psort_required_slot": _i32(tape.psort_required_slot),
        "psort_orig_row": _i32(tape.psort_orig_row),
        "psort_run_len": _i32(tape.psort_run_len),
        # the dense layout's unsorted property table; the empty-table
        # placeholder row (owner -1, zero lanes) gets the padding owner -9
        # so no query can hit it.  The reference's jnp match does hit it
        # for owner -1 queries with zero lanes, but those are never object
        # members under a tracked parent, and the row's child is
        # LOC_UNTRACKED with slot -1, so verdicts are unchanged
        "prop_hash": _u32_view(tape.prop_hash),
        "prop_match_owner": _i32(np.where(tape.prop_owner >= 0, tape.prop_owner, -9)),
        "prop_child_loc": _i32(tape.prop_child_loc),
        "prop_required_slot": _i32(tape.prop_required_slot),
        "prefix_loc": _i32(tape.prefix_loc),
        # packed per-location structural row: one gather per depth
        # iteration instead of six (addl, closed, item, item_start,
        # prefix_start, prefix_len)
        "loc_struct": _i32(
            np.stack(
                [
                    tape.loc_addl,
                    tape.loc_closed.astype(np.int32),
                    tape.loc_item,
                    tape.loc_item_start,
                    tape.loc_prefix_start,
                    tape.loc_prefix_len,
                ],
                axis=1,
            )
        ),
        "loc_required_mask": _i32(tape.loc_required_mask.astype(np.int32)),
        "loc_asrt_start": _i32(tape.loc_asrt_start),
        "loc_asrt_len": _i32(tape.loc_asrt_len),
        "asrt_owner": _i32(tape.asrt_owner),
        "asrt_group": group,
        "asrt_circ": _i32(tape.asrt_circ),
        # dense layout: the rows of some OR-group and their group id - 1
        "group_rows": np.nonzero(group > 0)[0],
        "group_idx": group[group > 0].astype(np.int64) - 1,
        "asrt_op": _i32(tape.asrt_op),
        # the reference compares in float32 (DESIGN.md §7)
        "asrt_f0": np.ascontiguousarray(tape.asrt_f0, dtype=np.float32),
        "asrt_i0": _i32(tape.asrt_i0),
        "asrt_i1": _i32(tape.asrt_i1),
        "asrt_u0": _u32_view(tape.asrt_u0),
        "asrt_u1": _u32_view(tape.asrt_u1),
        "asrt_hash": _u32_view(tape.asrt_hash),
        # group id + circuit-membership flag packed into one column so
        # the windowed path pays ONE gather for both
        "asrt_gcode": _i32(
            np.asarray(tape.asrt_group)
            + np.where(np.asarray(tape.asrt_circ) >= 0, _CIRC_FLAG, 0)
        ),
        # a frontier root (degenerate: the unroll budget died at the
        # root) must seed documents with the sentinel, not location 0
        "roots": _i32(np.where(tape.loc_frontier[tape.roots], LOC_FRONTIER, tape.roots)),
        "member_horizons": _i32(tape.member_horizons),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def _table_columns(table, device: torch.device) -> Dict[str, torch.Tensor]:
    """The token-table columns the executor reads, as tensors on ``device``.

    int8/bool columns widen to int32, ``num`` rounds to float32 as the
    reference does before any compare, and the uint32 hash and prefix
    words travel as int32 views.
    """
    host = {
        "node_type": _i32(table.node_type),
        "is_int": _i32(table.is_int),
        "num": np.ascontiguousarray(table.num, dtype=np.float32),
        "size": _i32(table.size),
        "parent": _i32(table.parent),
        "depth": _i32(table.depth),
        "idx_in_parent": _i32(table.idx_in_parent),
        "key_hash": _u32_view(table.key_hash),
        "str_hash": _u32_view(table.str_hash),
        "str_prefix": _u32_view(table.str_prefix),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


class BatchValidator:
    """Validates encoded token-table batches against one schema tape."""

    def __init__(
        self,
        tape: LocationTape,
        *,
        max_depth: int = 16,
        layout: str = "csr",
        metrics=None,
        device=None,
    ):
        if layout not in ("csr", "dense"):
            raise ValueError(f"unknown layout {layout!r}")
        self.device = resolve_device(device)
        self.tape = tape
        self.max_depth = max_depth
        self.layout = layout
        # optional MetricRegistry (obs/metrics.py): children are cached
        # here once so the per-launch hot path is attribute adds gated on
        # one ``is not None`` check (DESIGN.md §12)
        self.metrics = metrics
        if metrics is not None:
            self._m_launches = metrics.counter(
                "executor_launches_total", "batched kernel launches"
            )
            self._m_launch_seconds = metrics.counter(
                "executor_launch_seconds_total",
                "wall seconds inside batched launches (device sync included)",
            )
            self._m_recompiles = metrics.counter(
                "executor_recompiles_total",
                "distinct batch shapes seen (each pays first-launch set-up)",
            )
            self._m_bisect_depth = metrics.histogram(
                "executor_bisect_depth",
                "poison-isolation bisection depth per isolated validate",
                buckets=tuple(float(d) for d in range(13)),
            )
        self._seen_shapes: set = set()
        # compile-time window bounds (clamped: the kernels need >= 1 slot)
        self.n_window = max(1, tape.max_rows_per_loc)
        self.k_cand = max(1, tape.max_hash_run)
        # static: tapes without frontier locations skip the detection scan
        self.has_frontier = tape.n_frontier > 0
        self.n_circuits = tape.n_circuits
        # dense layout: OR-group ids 1..n_groups-1, known from the tape on
        # the host so the launch never syncs to size its reduction
        self.n_groups = int(np.asarray(tape.asrt_group).max(initial=0)) + 1
        self._circuits = _circuit_static_wiring(tape, self.device)
        self._consts = _tape_consts(tape, self.device)

    def _launch(self, cols, schema_ids):
        return _validate_batch(
            cols,
            schema_ids,
            consts=self._consts,
            layout=self.layout,
            max_depth=self.max_depth,
            max_loc_depth=self.tape.max_loc_depth,
            n_window=self.n_window,
            k_cand=self.k_cand,
            n_groups=self.n_groups,
            has_frontier=self.has_frontier,
            circuits=self._circuits,
            n_circuits=self.n_circuits,
        )

    def validate(self, table, schema_ids=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (valid, decided) boolean arrays of shape (B,).

        ``schema_ids`` selects each document's member of a linked tape.
        ``decided=False`` rows exceeded the encoder budget, contain nodes
        deeper than ``max_depth``, or reached a ``LOC_FRONTIER`` sentinel;
        they must be routed to the sequential executor.
        """
        valid, decided, _ = self.validate_ex(table, schema_ids)
        return valid, decided

    def validate_ex(
        self, table, schema_ids=None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Like :meth:`validate` plus the per-doc ``frontier`` flag."""
        B = table.batch
        ids = self._normalize_ids(B, schema_ids)
        # shape churn is tracked as in the reference: the profiler's
        # first-call-versus-steady split keys on it (here the first call
        # under a shape pays allocator growth and, once, the kernel build)
        shape = (B, table.max_nodes)
        new_shape = shape not in self._seen_shapes
        if new_shape:
            self._seen_shapes.add(shape)
        m = self.metrics
        if m is not None:
            if new_shape:
                self._m_recompiles.inc()
                _trace_point("executor.recompile", shape=shape)
            t0 = time.perf_counter()
        with _phase("executor.compile" if new_shape else "executor.execute"):
            with _span("executor.launch"):
                # host-time sub-phases: eager torch enqueues device work
                # asynchronously, so each phase is the host's dispatch
                # cost; "executor.sync" waits for the device to finish
                with _phase("executor.columns"):
                    cols = _table_columns(table, self.device)
                    dev_ids = torch.from_numpy(ids).to(self.device)
                out = self._launch(cols, dev_ids)
                with _phase("executor.sync"):
                    valid, in_depth, frontier = (t.cpu().numpy() for t in out)
        if m is not None:
            self._m_launches.inc()
            self._m_launch_seconds.inc(time.perf_counter() - t0)
        ok = np.asarray(table.ok)
        decided = in_depth & ~frontier & ok
        return valid, decided, frontier & ok

    def explain_batch(self, table, schema_ids=None, *, docs=None):
        """Batched first-failure attribution: not ported yet.

        Raises rather than returning nothing, so a caller that expects
        ``FailureSite``s cannot mistake the gap for valid documents.
        """
        raise NotImplementedError("explain_batch is not ported yet")

    def seen_shapes(self) -> set:
        """Snapshot of the (B, max_nodes) launch shapes already run."""
        return set(self._seen_shapes)

    def warm(self, table, schema_ids=None) -> bool:
        """Run the launch for ``table``'s shape off the request path;
        returns True when the shape was new."""
        if (table.batch, table.max_nodes) in self._seen_shapes:
            return False
        self.validate_ex(table, schema_ids)
        return True

    def _normalize_ids(self, B: int, schema_ids) -> np.ndarray:
        if schema_ids is None:
            if self.tape.n_members > 1:
                raise ValueError(
                    "linked tape: per-document schema_ids are required "
                    "(member 0 would otherwise be guessed silently)"
                )
            return np.zeros(B, np.int32)
        ids = np.asarray(schema_ids, np.int32)
        if ids.shape != (B,):
            raise ValueError(f"schema_ids shape {ids.shape} != ({B},)")
        if ids.size and (ids.min() < 0 or ids.max() >= self.tape.n_members):
            raise ValueError("schema_ids outside the tape's member range")
        return ids

    def validate_isolated(
        self, table, schema_ids=None, *, keys: Optional[Sequence[Any]] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[int, str]]:
        """:meth:`validate_ex` with per-document launch-fault containment.

        A launch that raises (device error, injected ``"launch"`` fault)
        is bisected until the poison is cornered in a single-row launch,
        whose error is recorded in ``errors[row]``; every other row's
        verdict is bit-identical to a fault-free run.  Rows already
        error-isolated at encode time keep their encode error.

        Returns ``(valid, decided, frontier, errors)``; ``errors`` rows
        are ERROR_ISOLATED -- callers must not route them to fallback.
        """
        B = table.batch
        ids = self._normalize_ids(B, schema_ids)
        row_keys = list(keys) if keys is not None else list(range(B))
        if len(row_keys) != B:
            raise ValueError(f"{len(row_keys)} keys for batch of {B}")
        valid = np.zeros(B, bool)
        decided = np.zeros(B, bool)
        frontier = np.zeros(B, bool)
        errors: Dict[int, str] = dict(table.errors)
        stack: List[Tuple[List[int], int]] = [(list(range(B)), 0)]
        max_bisect = 0  # deepest split reached while cornering poison
        while stack:
            rows, bdepth = stack.pop()
            full = len(rows) == B
            sub = table if full else table.take(rows)
            sub_ids = ids if full else ids[rows]
            try:
                if fault_hook_armed():  # skip the key tuple on the clean path
                    fault_point("launch", tuple(row_keys[i] for i in rows))
                v, d, f = self.validate_ex(sub, sub_ids)
            except Exception as exc:
                if len(rows) == 1:
                    errors[rows[0]] = f"launch: {type(exc).__name__}: {exc}"
                    continue
                mid = len(rows) // 2
                stack.append((rows[mid:], bdepth + 1))
                stack.append((rows[:mid], bdepth + 1))
                if bdepth + 1 > max_bisect:
                    max_bisect = bdepth + 1
                    _trace_point("executor.bisect", depth=max_bisect)
                continue
            valid[rows] = v
            decided[rows] = d
            frontier[rows] = f
        if self.metrics is not None:
            self._m_bisect_depth.observe(float(max_bisect))
        for r in errors:
            decided[r] = False
            frontier[r] = False
        return valid, decided, frontier, errors


def _propagate_locations(
    cols, member, consts, *, layout: str, loop_depth: int, k_cand: int
):
    """Assign every node a schema location; returns (loc, acquired).

    ``member`` is the (B*N,) int32 member id of each node's document.
    Values stay int32 as in the reference (the acquired mask uses bit 31);
    gather indices are int64 and every one is clamped or masked first.
    """
    B, N = cols["node_type"].shape
    BN = B * N
    dev = cols["node_type"].device
    node_type = cols["node_type"].reshape(BN)
    parent = cols["parent"].reshape(BN)  # -1 root
    depth = cols["depth"].reshape(BN)
    idx_in_parent = cols["idx_in_parent"].reshape(BN)
    key_hash = cols["key_hash"].reshape(BN, 8)

    node_ids = torch.arange(BN, dtype=torch.int64, device=dev)
    doc_base = node_ids - node_ids % N
    parent_flat = torch.where(parent >= 0, doc_base + parent, 0)

    is_pad = node_type == 0

    # each document's root is its schema member's root location
    loc = torch.where(node_ids % N == 0, consts["roots"][member.long()], -1)

    # loop-invariant node classification, shared by the hoisted hash pass
    # and the depth loop
    is_real = ~is_pad & (parent >= 0)
    parent_type = node_type[parent_flat]
    is_member_node = is_real & (parent_type == _T_OBJ)
    is_item_node = is_real & (parent_type == _T_ARR)

    if layout == "csr":
        # -- hoisted single hash pass: each object member's candidate-run
        # start among its own member's hash-sorted property rows
        M = consts["psort_owner"].shape[0]
        q_owner = torch.where(is_member_node, member, -1)
        first = kops.hash_match(
            key_hash, q_owner, consts["psort_hash"], consts["psort_match_owner"]
        )
        has_cand = first >= 0
        safe_first = torch.where(has_cand, first, 0).long()
        run_len = torch.where(has_cand, consts["psort_run_len"][safe_first], 0)
        k_arange = torch.arange(k_cand, dtype=torch.int64, device=dev)[None, :]  # (1, K)
        cand_rows = torch.clamp(safe_first[:, None] + k_arange, 0, M - 1)  # (BN, K)
        cand_valid = k_arange < run_len[:, None]
        cand_owner = torch.where(cand_valid, consts["psort_owner"][cand_rows], -1)
        cand_child = consts["psort_child_loc"][cand_rows]
        cand_slot = consts["psort_required_slot"][cand_rows]
        cand_orig = consts["psort_orig_row"][cand_rows]

    # required-bit contributions, recorded at each node's own depth and
    # scattered once after the loop
    contrib_vec = torch.zeros(BN, dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    n_prefix = consts["prefix_loc"].shape[0]

    for d in range(1, loop_depth + 1):
        at_depth = depth == d
        parent_loc = loc[parent_flat]

        is_member = at_depth & is_member_node
        if layout == "csr":
            # -- object members: owner equality over the K candidates;
            # ties break to the minimal original row
            m = cand_valid & (cand_owner == parent_loc[:, None])
            orig_masked = torch.where(m, cand_orig, _BIG)
            best_k = torch.argmin(orig_masked, dim=1, keepdim=True)  # first minimum
            matched = torch.gather(orig_masked, 1, best_k)[:, 0] < _BIG
            child_loc_m = torch.gather(cand_child, 1, best_k)[:, 0]
            slot_m = torch.gather(cand_slot, 1, best_k)[:, 0]
        else:
            # -- object members: a full hash_match over the unsorted
            # property table, owner = the parent's location
            q_owner = torch.where(is_member & (parent_loc >= 0), parent_loc, -1)
            row = kops.hash_match(
                key_hash, q_owner, consts["prop_hash"], consts["prop_match_owner"]
            )
            matched = row >= 0
            safe_row = torch.where(matched, row, 0).long()
            child_loc_m = consts["prop_child_loc"][safe_row]
            slot_m = consts["prop_required_slot"][safe_row]
        child_loc = torch.where(matched, child_loc_m, LOC_UNTRACKED)
        # one packed row gather for the parent's structural facts
        p_loc_safe = torch.where(parent_loc >= 0, parent_loc, 0).long()
        ls = consts["loc_struct"][p_loc_safe]  # (BN, 6)
        addl, closed = ls[:, 0], ls[:, 1]
        item_loc, item_start = ls[:, 2], ls[:, 3]
        pfx_start, pfx_len = ls[:, 4], ls[:, 5]
        # unmatched at a tracked object location: addl / closed / untracked
        # (an addl slot may carry the LOC_FRONTIER sentinel)
        unmatched_loc = torch.where(
            closed != 0,
            LOC_INVALID,
            torch.where((addl >= 0) | (addl == LOC_FRONTIER), addl, LOC_UNTRACKED),
        )
        member_loc = torch.where(matched, child_loc, unmatched_loc)
        member_loc = torch.where(parent_loc >= 0, member_loc, parent_loc)

        # required bit: record the contribution at the node's own depth
        slot = torch.where(matched, slot_m, -1)
        contrib = torch.where(
            is_member & (slot >= 0),
            torch.bitwise_left_shift(one, torch.clamp(slot, min=0)),
            0,
        )
        contrib_vec = torch.where(is_member, contrib, contrib_vec)

        # -- array items: prefix / tail-items rules
        is_item = at_depth & is_item_node
        in_prefix = idx_in_parent < pfx_len
        pfx_idx = torch.clamp(pfx_start + idx_in_parent, 0, n_prefix - 1).long()
        prefix_loc = consts["prefix_loc"][pfx_idx]
        tail_loc = torch.where(
            ((item_loc >= 0) | (item_loc == LOC_FRONTIER))
            & (idx_in_parent >= item_start),
            item_loc,
            LOC_UNTRACKED,
        )
        arr_loc = torch.where(in_prefix, prefix_loc, tail_loc)
        arr_loc = torch.where(parent_loc >= 0, arr_loc, parent_loc)

        loc = torch.where(is_member, member_loc, torch.where(is_item, arr_loc, loc))

    # the reference's single ``.at[parent_flat].add``: add, not OR
    acquired = torch.zeros(BN, dtype=torch.int32, device=dev)
    acquired.index_add_(0, parent_flat, contrib_vec)
    return loc, acquired


def _segment_or_suffix(vals: torch.Tensor, grp: torch.Tensor) -> torch.Tensor:
    """Segmented suffix-OR along axis 1.

    ``out[:, j] = OR(vals[:, k] for k >= j while grp stays equal)`` --
    groups are contiguous within a CSR window, so each segment start holds
    the whole group's OR.  W <= Â is small, so a static right-to-left loop
    replaces the reference's associative scan.
    """
    W = vals.shape[1]
    out = [None] * W
    out[W - 1] = vals[:, W - 1]
    for j in range(W - 2, -1, -1):
        out[j] = vals[:, j] | ((grp[:, j] == grp[:, j + 1]) & out[j + 1])
    return torch.stack(out, dim=1)


def _assertions_csr(loc, node_cols, consts, *, n_window: int, n_circuits: int):
    """Windowed assertion evaluation + segmented OR-group reduction.

    Returns ``(asrt_ok, passes, seg_any)``: the per-node verdict over
    *plain* rows, plus the raw window pass matrix and per-window segmented
    group OR for the circuit-leaf gathers (None without circuits).
    """
    A = consts["asrt_op"].shape[0]
    dev = loc.device
    tracked = loc >= 0
    loc_safe = torch.where(tracked, loc, 0).long()
    w_start = consts["loc_asrt_start"][loc_safe]
    w_len = torch.where(tracked, consts["loc_asrt_len"][loc_safe], 0)
    slots = torch.arange(n_window, dtype=torch.int64, device=dev)[None, :]  # (1, W)
    w_rows = torch.clamp(w_start[:, None] + slots, 0, A - 1)  # (BN, W)
    w_valid = slots < w_len[:, None]  # (BN, W) == "applies"
    # the kernel reads each node's window from the tape itself, so the
    # reference's (BN, W[, 8]) operand gathers have no counterpart here
    window_tape = {
        "start": consts["loc_asrt_start"],
        "len": consts["loc_asrt_len"],
        **{k: consts[f"asrt_{k}"] for k in ("op", "f0", "i0", "i1", "u0", "u1", "hash")},
    }
    passes = kops.assertion_eval_window_tape(loc, node_cols, window_tape, n_window) != 0

    gcode = torch.where(w_valid, consts["asrt_gcode"][w_rows], 0)
    grp = gcode & (_CIRC_FLAG - 1)
    in_circ = gcode >= _CIRC_FLAG
    is_and = w_valid & (grp == 0) & ~in_circ
    and_ok = torch.where(is_and, passes, True).all(dim=1)

    # enum OR-groups: group passes iff any of its (contiguous) rows passes
    pass_or = passes & w_valid & (grp > 0)
    seg_any = _segment_or_suffix(pass_or, grp)
    first_col = torch.ones_like(grp[:, :1], dtype=torch.bool)
    is_start = (grp > 0) & torch.cat([first_col, grp[:, 1:] != grp[:, :-1]], dim=1)
    or_ok = torch.where(is_start & ~in_circ, seg_any, True).all(dim=1)
    asrt_ok = and_ok & or_ok
    if not n_circuits:
        return asrt_ok, None, None
    return asrt_ok, passes, seg_any


def _assertions_dense(loc, node_cols, consts, *, n_groups: int, circuits, n_circuits: int):
    """Dense assertion evaluation + ownership and OR-group reduction.

    Returns ``(asrt_ok, passes, gval)``: the per-node verdict over plain
    rows, the (BN, A) pass matrix and the (BN, G-1) per-node OR-group
    verdicts (the circuit leaves' sources).  The reference reduces groups
    through a rank-3 (BN, A, G-1) one-hot; here two ``index_add_`` counts
    over the group rows give the same verdicts in O(BN * A) memory.
    """
    asrt_cols = {k: consts[f"asrt_{k}"] for k in ("op", "f0", "i0", "i1", "u0", "u1", "hash")}
    passes = kops.assertion_eval(node_cols, asrt_cols) != 0  # (BN, A)
    applies = loc[:, None] == consts["asrt_owner"][None, :]  # (BN, A)

    groups = consts["asrt_group"]
    is_and_row = (groups == 0) & (consts["asrt_circ"] < 0)
    and_ok = torch.where(applies & is_and_row[None, :], passes, True).all(dim=1)

    # enum OR-groups: a group passes iff it does not apply or a row matches
    BN = loc.shape[0]
    if n_groups > 1:
        g_rows = consts["group_rows"]  # (R,) rows of some group
        g_app = applies[:, g_rows]
        g_hit = g_app & passes[:, g_rows]

        def count(hits):
            out = torch.zeros((BN, n_groups - 1), dtype=torch.int32, device=loc.device)
            return out.index_add_(1, consts["group_idx"], hits.to(torch.int32))

        gval = (count(g_app) == 0) | (count(g_hit) > 0)  # (BN, G-1)
        if n_circuits:
            or_ok = (gval | ~circuits["plain_groups"][None, :]).all(dim=1)
        else:
            or_ok = gval.all(dim=1)
    else:
        gval = torch.ones((BN, 1), dtype=torch.bool, device=loc.device)
        or_ok = torch.ones(BN, dtype=torch.bool, device=loc.device)
    return and_ok & or_ok, passes, gval


def _circuit_anchors(loc, circuits, B: int, N: int):
    """(B, O) in-document node index at each circuit-relevant location.

    -1 where the document does not instantiate the location; the
    unique-path precondition leaves at most one node per (document,
    location), so one masked max-reduction resolves every anchor.
    """
    owner_locs = circuits["owner_locs"]  # (O,) int32
    loc_r = loc.reshape(B, N, 1)
    n_idx = torch.arange(N, dtype=torch.int32, device=loc.device)[None, :, None]
    hit = loc_r == owner_locs[None, None, :]  # (B, N, O)
    return torch.where(hit, n_idx, -1).amax(dim=1)


def _anchor_gather(node_at, mat, ranks, cols, B: int, N: int):
    """(B, U) values of static columns of ``mat`` at anchored nodes,
    vacuous-true where the anchor is absent."""
    rows = node_at[:, ranks]  # (B, U)
    safe = torch.clamp(rows, min=0).long()
    flat = torch.arange(B, dtype=torch.int64, device=mat.device)[:, None] * N + safe
    vals = mat[flat, cols[None, :]]
    return torch.where(rows >= 0, vals, True)


def _leaf_values(node_at, circuits, mats, cols, B: int, N: int):
    """{circuit id: [(B,) bool, ...]} leaf values via anchored gathers.

    ``mats`` are the (BN, ·) AND-leaf and group-leaf value matrices and
    ``cols`` the static column each unit reads (per layout: window slots
    of the window pass matrix and segmented group OR, or assertion rows of
    the dense pass matrix and OR-group verdict columns).
    """
    out: Dict[int, list] = {}
    for units, mat, ranks, col in (
        (circuits["and_units"], mats[0], circuits["and_ranks"], cols[0]),
        (circuits["group_units"], mats[1], circuits["group_ranks"], cols[1]),
    ):
        if units:
            v = _anchor_gather(node_at, mat, ranks, col, B, N)
            for u, unit in enumerate(units):
                out.setdefault(unit[0], []).append(v[:, u])
    return out


def _reduce_circuits(leaf_vals, present, circuits, *, n_circuits: int):
    """Bottom-up circuit reduce -> (B,) root conjunction.

    Children always have larger ids than their parent, so one descending
    pass evaluates the DAG in topological order.  The wiring is host numpy
    and the loop re-runs on every launch (the reference unrolls it once at
    trace time).
    """
    kind = circuits["kind"]
    parent = circuits["parent"]
    B = present.shape[0]
    dev = present.device
    children: List[List[int]] = [[] for _ in range(n_circuits)]
    roots = []
    for c in range(n_circuits):
        p = int(parent[c])
        if p >= 0:
            children[p].append(c)
        else:
            roots.append(c)
    vals: List[Any] = [None] * n_circuits
    for c in range(n_circuits - 1, -1, -1):
        k = int(kind[c])
        ch = children[c]
        if k == CK_OR:
            v = torch.zeros(B, dtype=torch.bool, device=dev)
            for d in ch:
                v = v | vals[d]
        elif k == CK_AND or k == CK_NOT:
            v = torch.ones(B, dtype=torch.bool, device=dev)
            for lv in leaf_vals.get(c, ()):
                v = v & lv
            for d in ch:
                v = v & vals[d]
            if k == CK_NOT:
                v = ~v
        else:  # CK_XOR1: exactly one child true
            cnt = torch.zeros(B, dtype=torch.int32, device=dev)
            for d in ch:
                cnt = cnt + vals[d].to(torch.int32)
            v = cnt == 1
        # presence gate: a circuit whose owner location has no node is
        # vacuously true (also makes other members' circuits no-ops)
        vals[c] = v | ~present[:, c]
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    for r in roots:
        ok = ok & vals[r]
    return ok


def _validate_batch(
    cols,
    schema_ids,
    *,
    consts,
    layout: str,
    max_depth: int,
    max_loc_depth: int,
    n_window: int,
    k_cand: int,
    n_groups: int,
    has_frontier: bool,
    circuits,
    n_circuits: int,
):
    """One launch: (valid, in_depth, frontier) boolean (B,) tensors."""
    # the tape caps trackable depth at compile time: below
    # max_loc_depth + 1 every location is untracked or under an invalid
    # ancestor, so the CSR loop stops there.  The dense layout keeps the
    # reference's full-depth loop (verdicts are identical either way)
    tape_horizon = max_loc_depth + 1
    loop_depth = min(max_depth, tape_horizon) if layout == "csr" else max_depth
    B, N = cols["node_type"].shape
    BN = B * N
    dev = cols["node_type"].device
    member = schema_ids.to(torch.int32).repeat_interleave(N)  # (BN,)
    with _phase("executor.locations"):
        loc, acquired = _propagate_locations(
            cols, member, consts, layout=layout, loop_depth=loop_depth, k_cand=k_cand
        )
    node_type = cols["node_type"].reshape(BN)
    is_pad = node_type == 0
    tracked = loc >= 0

    # ---- 2. required properties --------------------------------------------
    loc_safe = torch.where(tracked, loc, 0).long()
    required_mask = torch.where(
        tracked & (node_type == _T_OBJ), consts["loc_required_mask"][loc_safe], 0
    )
    required_ok = (acquired & required_mask) == required_mask

    # ---- 3. assertion rows -------------------------------------------------
    node_cols = {
        "type": node_type,
        "is_int": cols["is_int"].reshape(BN),
        "num": cols["num"].reshape(BN),
        "size": cols["size"].reshape(BN),
        "acquired": acquired,
        "str_hash": cols["str_hash"].reshape(BN, 8),
        "str_prefix": cols["str_prefix"].reshape(BN, 2),
    }
    with _phase("executor.assertions"):
        if layout == "csr":
            asrt_ok, and_mat, group_mat = _assertions_csr(
                loc, node_cols, consts, n_window=n_window, n_circuits=n_circuits
            )
            leaf_cols = (circuits["and_slots"], circuits["group_slots"])
        else:
            asrt_ok, and_mat, group_mat = _assertions_dense(
                loc, node_cols, consts, n_groups=n_groups, circuits=circuits,
                n_circuits=n_circuits,
            )
            leaf_cols = (circuits["and_rows"], circuits["group_idx"])

    # ---- 4. reduce -----------------------------------------------------------
    node_valid = ((loc != LOC_INVALID) & asrt_ok & required_ok) | is_pad
    valid = node_valid.reshape(B, N).all(dim=1)

    # logical-applicator circuits (DESIGN.md §10): per-document leaves ->
    # bounded-depth reduce -> AND of gated root values into the verdict
    if n_circuits:
        with _phase("executor.circuits"):
            node_at = _circuit_anchors(loc, circuits, B, N)
            leaf_vals = _leaf_values(node_at, circuits, (and_mat, group_mat), leaf_cols, B, N)
            present = node_at[:, circuits["circ_ranks"]] >= 0  # (B, C)
            valid = valid & _reduce_circuits(
                leaf_vals, present, circuits, n_circuits=n_circuits
            )

    # depth-budget coverage: a non-root, non-pad node that never received a
    # location sits below the max_depth horizon -- its document is
    # undecided.  Documents whose own member horizon fits the budget are
    # statically decided (bit-identical to single-member dispatch).
    if tape_horizon <= max_depth:
        in_depth = torch.ones(B, dtype=torch.bool, device=dev)
    else:
        is_root = torch.arange(BN, device=dev) % N == 0
        unreached = ~is_pad & ~is_root & (loc == -1)
        member_ok = consts["member_horizons"][schema_ids.long()] <= max_depth  # (B,)
        in_depth = member_ok | ~unreached.reshape(B, N).any(dim=1)

    # $ref-unroll frontiers (DESIGN.md §9): documents whose recursion
    # outran the tape carry LOC_FRONTIER nodes and are undecided
    if has_frontier:
        frontier = (loc == LOC_FRONTIER).reshape(B, N).any(dim=1)
    else:
        frontier = torch.zeros(B, dtype=torch.bool, device=dev)
    return valid, in_depth, frontier
