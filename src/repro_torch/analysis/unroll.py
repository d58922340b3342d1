"""Per-schema ``unroll_depth`` sizing from the compiled label graph.

The tape builder unrolls recursive ``$ref`` labels ``unroll_depth``
times under a node budget (core/tape.py).  A single global default
wastes budget on linear recursion (one self-jump per level: depth 4
costs 4x the body) and blows the budget on branching recursion (a
binary tree schema at depth 4 costs 2^4 bodies).  The analyzer walks
the compiled instruction tree, measures each label's body size and
jump fan-out, and recommends the deepest uniform unroll whose
worst-case clone count stays inside the node budget.

The recommendation only ever *shrinks* below the caller's default --
deep unrolling of branching recursion is the failure mode; linear
recursion keeps the default and still fits.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..core.compiler import CompiledSchema
from ..core.instructions import ControlJump, walk
from ..core.tape import DEFAULT_UNROLL_DEPTH, DEFAULT_UNROLL_NODE_BUDGET

__all__ = ["recommend_unroll_depth"]


def recommend_unroll_depth(
    compiled: CompiledSchema,
    *,
    default: int = DEFAULT_UNROLL_DEPTH,
    node_budget: int = DEFAULT_UNROLL_NODE_BUDGET,
) -> int:
    """Recommend an unroll depth for ``compiled`` given the budget.

    Returns ``default`` for non-recursive schemas and for linear
    recursion; returns a smaller depth (>= 1) when the label graph's
    branching factor would exhaust ``node_budget`` before ``default``
    levels.
    """
    if not compiled.labels:
        return default

    # Per-label body size and outgoing-jump fan-out (jumps anywhere in
    # the body count: each one clones a whole target body per level).
    body_size: Dict[int, int] = {}
    fan_out: Dict[int, int] = {}
    for label, body in compiled.labels.items():
        n = 0
        jumps = 0
        for inst in walk(body):
            n += 1
            if isinstance(inst, ControlJump):
                jumps += 1
        body_size[label] = max(1, n)
        fan_out[label] = jumps

    root_jumps = sum(1 for inst in walk(compiled.instructions) if isinstance(inst, ControlJump))
    branching = max(fan_out.values(), default=0)
    if branching <= 1:
        # linear (or no) recursion: each extra level adds one body
        # copy per jump site -- the builder's own budget guard handles
        # pathological body sizes, keep the global default
        return default

    # Worst-case clone growth: every level multiplies live jump sites
    # by the max fan-out, each cloning the largest body.
    biggest = max(body_size.values())
    live = max(1, root_jumps)
    total = sum(body_size.values()) + len(list(compiled.instructions))
    depth = 0
    while depth < default:
        grown = total + live * biggest
        if grown > node_budget:
            break
        total = grown
        live *= branching
        depth += 1
    return max(1, depth)
