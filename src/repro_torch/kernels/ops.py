"""Public kernel entry points: dispatch by the tensors' device.

A CPU tensor goes to the plain PyTorch version (``ref.py``), a CUDA tensor
to the hand-written CUDA kernel; anything else raises.  There is no
fallback from one to the other.

The JAX package's wrappers pad their inputs to block multiples; here
nothing is padded and the results are the same: the CUDA kernels mask
their ragged edges themselves, ``hash_match`` matches equal owners
whatever their value (-1 included; the reference's padded table rows carry
owner -9 and are never seen here), and an assertion row or window slot
with op -1 evaluates to 0.
"""

from __future__ import annotations

import torch

from . import ref as _ref
from .assertion_eval import assertion_eval_cuda
from .assertion_eval_window import assertion_eval_window_cuda, assertion_eval_window_tape_cuda
from .hash_match import hash_match_cuda

__all__ = [
    "hash_match",
    "assertion_eval",
    "assertion_eval_window_tape",
    "assertion_eval_window",
]


def _device_type(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    (kind,) = kinds
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind


def _with_acquired(node_cols: dict) -> dict:
    """Default the acquired-slot bitmask to zeros for callers without one
    (OBJ_HAS_SLOT rows appear only on tapes with circuits)."""
    if "acquired" in node_cols:
        return node_cols
    out = dict(node_cols)
    out["acquired"] = torch.zeros_like(node_cols["size"])
    return out


def hash_match(
    q_lanes: torch.Tensor,
    q_owner: torch.Tensor,
    t_lanes: torch.Tensor,
    t_owner: torch.Tensor,
) -> torch.Tensor:
    """(N,) int32 least matching table row or -1 (see hash_match.py)."""
    if _device_type(q_lanes, q_owner, t_lanes, t_owner) == "cpu":
        return _ref.hash_match_ref(q_lanes, q_owner, t_lanes, t_owner)
    return hash_match_cuda(q_lanes, q_owner, t_lanes, t_owner)


def assertion_eval(node_cols: dict, asrt_cols: dict) -> torch.Tensor:
    """(N, A) int8 pass matrix of every node against every assertion row.

    ``asrt_cols`` holds op/f0/i0/i1/u0/u1 of shape (A,) and hash of shape
    (A, 8); rows with op -1 evaluate to 0.
    """
    node_cols = _with_acquired(node_cols)
    if _device_type(*node_cols.values(), *asrt_cols.values()) == "cpu":
        return _ref.assertion_eval_ref(node_cols, asrt_cols)
    return assertion_eval_cuda(node_cols, asrt_cols)


def assertion_eval_window_tape(
    loc: torch.Tensor, node_cols: dict, tape_cols: dict, n_window: int
) -> torch.Tensor:
    """(N, W) int8 pass matrix of each node against its CSR window, read
    from the tape (the executor's CSR path).

    ``loc`` (N,) int32 is each node's location (< 0: no window);
    ``tape_cols`` holds start/len of shape (L,), the location's first row
    and row count, and op/f0/i0/i1/u0/u1 of shape (A,) and hash of shape
    (A, 8).  Slot j of node i is its verdict on row start + j for j < len,
    else 0.
    """
    node_cols = _with_acquired(node_cols)
    if _device_type(loc, *node_cols.values(), *tape_cols.values()) == "cpu":
        return _ref.assertion_eval_window_tape_ref(loc, node_cols, tape_cols, n_window)
    return assertion_eval_window_tape_cuda(loc, node_cols, tape_cols, n_window)


def assertion_eval_window(node_cols: dict, w_cols: dict) -> torch.Tensor:
    """(N, W) int8 pass matrix over pre-gathered CSR windows (the JAX op's
    form).

    ``w_cols`` holds op/f0/i0/i1/u0/u1 of shape (N, W) and hash of shape
    (N, W, 8); masked slots must carry op -1.  On CUDA the windows go to the
    tape kernel as a tape of N*W rows.
    """
    node_cols = _with_acquired(node_cols)
    if _device_type(*node_cols.values(), *w_cols.values()) == "cpu":
        return _ref.assertion_eval_window_ref(node_cols, w_cols)
    return assertion_eval_window_cuda(node_cols, w_cols)
