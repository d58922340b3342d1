"""Trip-count-aware analysis of post-SPMD scheduled HLO.

XLA's ``cost_analysis()`` counts a while-loop body exactly once, which
makes it useless for scan-over-layers models (the body runs n_periods
times) -- verified empirically (see EXPERIMENTS.md §Dry-run notes).  This
module re-derives roofline inputs directly from ``compiled.as_text()``:

* builds the computation call graph (entry, while bodies/conditions,
  fusions via ``calls=``/``to_apply=``/``body=``/``condition=``);
* extracts ``known_trip_count`` from each while's backend_config and
  assigns every computation an execution **multiplier** (product of trip
  counts on the call path; conservative max over multiple call sites);
* accumulates, weighted by multiplier:
  - dot FLOPs (2 x out_elems x contracted_elems)  -> compute term
  - per-instruction HBM traffic (operands + outputs of top-level
    instructions in scheduled post-fusion HLO)    -> memory term
  - collective bytes by kind with ring factors    -> collective term

This is static analysis of the compiled artifact, not simulation: exactly
what the dry-run can honestly provide without hardware.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_COLLECTIVE_FACTOR = {
    "all-reduce": 2.0,  # ring: reduce-scatter + all-gather phases
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# header params may contain nested tuple types -- only anchor on name + '(';
# non-entry headers are indented by one space in scheduled dumps
_COMP_HEADER = re.compile(r"^\s*(?:ENTRY )?%?([\w.\-]+)\s*\(")
_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*((?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^\s]*))\s+([\w\-]+)\(",
    re.M,
)
_SHAPE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALL_ATTR = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")
_OPERAND_NAME = re.compile(r"%([\w.\-]+)")


def _operand_names(argstr: str) -> List[str]:
    """Instruction-operand names from the parenthesized argument list.

    Scheduled dumps write operands WITH their types -- ``dot(f32[64,128]{1,0}
    %lhs, ...)`` -- so a naive comma-split yields ``f32[64`` (the commas
    inside shape brackets), silently losing every operand-shape lookup:
    dot FLOPs dropped their contracted-dim factor and HBM traffic dropped
    all operand bytes.  Anchor on the ``%`` sigil instead; untyped,
    sigil-free lists fall back to the comma split.
    """
    names = _OPERAND_NAME.findall(argstr)
    if names:
        return names
    return [p.strip() for p in argstr.split(",") if p.strip()]


def _shape_elems_bytes(type_str: str) -> Tuple[int, int]:
    elems = 0
    nbytes = 0
    for dt, dims in _SHAPE.findall(type_str):
        b = _DTYPE_BYTES.get(dt)
        if b is None:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        elems += n
        nbytes += n * b
    return elems, nbytes


@dataclass
class _Instr:
    name: str
    type_str: str
    op: str
    line: str


@dataclass
class _Computation:
    name: str
    instrs: List[_Instr] = field(default_factory=list)
    calls: List[Tuple[str, Optional[int]]] = field(default_factory=list)  # (callee, trip)


def _parse_computations(text: str) -> Dict[str, _Computation]:
    comps: Dict[str, _Computation] = {}
    current: Optional[_Computation] = None
    # computations are blocks `<header> { ... }` separated by blank lines;
    # a header is the first non-blank line at (or after) module start / a
    # closing `}`.  Headers can contain `=` inside /*index=N*/ comments and
    # layout braces, so structural detection beats content filters.
    expecting_header = True
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped:
            continue
        if stripped == "}":
            expecting_header = True
            current = None
            continue
        if expecting_header:
            m = _COMP_HEADER.match(line)
            if m and stripped.endswith("{") and not m.group(1).startswith("HloModule"):
                current = _Computation(m.group(1))
                comps[current.name] = current
                expecting_header = False
                continue
            # module prologue (HloModule line, metadata tables): skip
            if "(" not in stripped or "->" not in stripped:
                continue
        if current is None:
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name, type_str, op = m.group(1), m.group(2), m.group(3)
        instr = _Instr(name, type_str, op, line)
        current.instrs.append(instr)
        if op == "while":
            trip = None
            tm = _TRIP.search(line)
            if tm:
                trip = int(tm.group(1))
            for cm in _CALL_ATTR.finditer(line):
                # body and condition both scale by trip count
                current.calls.append((cm.group(1), trip))
        else:
            for cm in _CALL_ATTR.finditer(line):
                current.calls.append((cm.group(1), 1))
    return comps


def _entry_name(text: str) -> Optional[str]:
    m = re.search(r"^ENTRY %?([\w.\-]+)", text, re.M)
    return m.group(1) if m else None


def _multipliers(comps: Dict[str, _Computation], entry: str) -> Dict[str, float]:
    mult: Dict[str, float] = defaultdict(float)
    mult[entry] = 1.0
    # propagate through the call DAG (computations are acyclic in HLO)
    order = [entry]
    seen = {entry}
    i = 0
    while i < len(order):
        comp = comps.get(order[i])
        i += 1
        if comp is None:
            continue
        m = mult[comp.name]
        for callee, trip in comp.calls:
            t = trip if trip is not None else 1
            mult[callee] = max(mult[callee], m * t)
            if callee not in seen:
                seen.add(callee)
                order.append(callee)
    return dict(mult)


def _dot_flops(instr: _Instr, shapes: Dict[str, str]) -> float:
    """2 x output elems x contracted elems for dot/dot_general."""
    out_elems, _ = _shape_elems_bytes(instr.type_str)
    # contracted size = prod of lhs contracting dims, from operand shape
    ops = re.search(r"(?:dot|convolution)\(([^)]*)\)", instr.line)
    lhs_name = None
    if ops:
        parts = _operand_names(ops.group(1))
        if parts:
            lhs_name = parts[0]
    cdims = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", instr.line)
    contracted = 1
    if lhs_name and cdims and lhs_name in shapes:
        dims_m = _SHAPE.search(shapes[lhs_name])
        if dims_m:
            dims = [int(d) for d in dims_m.group(2).split(",") if d]
            for ci in cdims.group(1).split(","):
                if ci and int(ci) < len(dims):
                    contracted *= dims[int(ci)]
    return 2.0 * out_elems * contracted


@dataclass
class HloAnalysis:
    dot_flops: float = 0.0
    hbm_traffic_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    total_collective_bytes: float = 0.0
    while_trip_counts: List[int] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "hbm_traffic_bytes": self.hbm_traffic_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_counts": self.collective_counts,
            "total_collective_bytes": self.total_collective_bytes,
            "while_trip_counts": self.while_trip_counts,
        }


# ops that do not touch HBM as standalone kernels (control/meta)
_NO_TRAFFIC_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "while", "conditional", "call", "after-all", "partition-id",
    "replica-id", "copy-start", "copy-done",
}


def analyze_hlo(text: str) -> HloAnalysis:
    comps = _parse_computations(text)
    entry = _entry_name(text)
    if entry is None or entry not in comps:
        # fall back: treat the largest computation as entry
        entry = max(comps, key=lambda k: len(comps[k].instrs)) if comps else ""
    mult = _multipliers(comps, entry) if comps else {}

    # fusions' *internal* computations produce no extra HBM traffic; count
    # traffic only for instructions of "top-level" computations: entry +
    # while bodies/conditions (a scheduled module runs those as kernels).
    fusion_comps = set()
    for comp in comps.values():
        for instr in comp.instrs:
            if instr.op == "fusion":
                for cm in _CALL_ATTR.finditer(instr.line):
                    fusion_comps.add(cm.group(1))
    # reductions etc. applied via to_apply are also internal
    for comp in comps.values():
        for instr in comp.instrs:
            if instr.op in ("reduce", "all-reduce", "reduce-scatter", "scatter", "sort", "map", "reduce-window"):
                for cm in _CALL_ATTR.finditer(instr.line):
                    fusion_comps.add(cm.group(1))

    out = HloAnalysis()
    shapes_global: Dict[str, str] = {}
    for comp in comps.values():
        for instr in comp.instrs:
            shapes_global[instr.name] = instr.type_str

    for comp in comps.values():
        m = mult.get(comp.name, 0.0)
        if m == 0.0:
            continue
        top_level = comp.name not in fusion_comps
        for instr in comp.instrs:
            if instr.op in ("dot", "convolution"):
                out.dot_flops += m * _dot_flops(instr, shapes_global)
            kind = instr.op.replace("-start", "").replace("-done", "")
            if kind in _COLLECTIVE_FACTOR and not instr.op.endswith("-done"):
                _, nbytes = _shape_elems_bytes(instr.type_str)
                w = nbytes * _COLLECTIVE_FACTOR[kind] * m
                out.collective_bytes[kind] = out.collective_bytes.get(kind, 0.0) + w
                out.collective_counts[kind] = out.collective_counts.get(kind, 0) + 1
                out.total_collective_bytes += w
            if top_level and instr.op not in _NO_TRAFFIC_OPS:
                _, out_b = _shape_elems_bytes(instr.type_str)
                in_b = 0
                args = re.search(r"\(([^)]*)\)", instr.line.split("=", 1)[1])
                if args:
                    for a in _operand_names(args.group(1)):
                        if a in shapes_global:
                            _, b = _shape_elems_bytes(shapes_global[a])
                            in_b += b
                out.hbm_traffic_bytes += m * (out_b + in_b)
        for callee, trip in comp.calls:
            if trip is not None and trip > 1:
                out.while_trip_counts.append(trip)
    return out
