"""Public kernel entry points: dispatch by the tensors' device.

A CPU tensor goes to the plain PyTorch version (``ref.py``), a CUDA tensor
to the hand-written CUDA kernel; anything else raises.  There is no
fallback from one to the other.

The padding contract of the JAX package's wrappers holds without padding:
the CUDA kernels mask their ragged edges themselves, a query owner of -1
never matches (the reference's padded queries), table rows carry owners
>= 0 or the padding owner -9, and a window slot with op -1 evaluates to 0.
"""

from __future__ import annotations

import torch

from . import ref as _ref
from .assertion_eval import assertion_eval_window_cuda
from .hash_match import hash_match_cuda

__all__ = ["hash_match", "assertion_eval_window"]


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


def assertion_eval_window(node_cols: dict, w_cols: dict) -> torch.Tensor:
    """(N, W) int8 pass matrix over pre-gathered CSR windows.

    ``w_cols`` holds op/f0/i0/i1/u0/u1 of shape (N, W) and hash of shape
    (N, W, 8); masked slots must carry op -1.
    """
    node_cols = _with_acquired(node_cols)
    if _device_type(*node_cols.values(), *w_cols.values()) == "cpu":
        return _ref.assertion_eval_window_ref(node_cols, w_cols)
    return assertion_eval_window_cuda(node_cols, w_cols)
