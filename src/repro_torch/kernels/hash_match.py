"""CUDA kernel: semi-perfect-hash property matching (Blaze §4.1 on Hopper).

For every document node, find the least property-table row whose (key hash,
owner) pair equals the node's.  Replaces the Pallas TPU kernel
``hash_match_pallas`` (``repro/kernels/hash_match.py``).

What bounds it on the H100, and the design: the work is memory-bound
(36 bytes read and 4 written per query; the table is tens to a few hundred
rows).  One thread owns one query; each block stages the table in shared
memory in chunks and scans it in ascending row order, so the first full
match is the least row and the TPU's revisited output block (a running
minimum across sequential grid steps) has no counterpart.  A query with the
padding owner -1 returns -1 without scanning.  Source:
``csrc/hash_match.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

__all__ = ["hash_match_cuda"]

# kernel launches since import; chip_smoke.py zeroes it before the main path
launches = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def hash_match_cuda(
    q_lanes: torch.Tensor,  # (N, 8) int32 view of uint32 lanes
    q_owner: torch.Tensor,  # (N,)   int32
    t_lanes: torch.Tensor,  # (M, 8) int32 view of uint32 lanes
    t_owner: torch.Tensor,  # (M,)   int32
) -> torch.Tensor:
    """(N,) int32 least matching table row or -1, on PyTorch's current stream."""
    global launches
    n, m = q_lanes.shape[0], t_lanes.shape[0]
    _check("q_lanes", q_lanes, torch.int32, (n, 8))
    _check("q_owner", q_owner, torch.int32, (n,))
    _check("t_lanes", t_lanes, torch.int32, (m, 8))
    _check("t_owner", t_owner, torch.int32, (m,))
    if len({t.device for t in (q_lanes, q_owner, t_lanes, t_owner)}) != 1:
        raise ValueError("hash_match: all tensors must be on one device")
    out = torch.empty(n, dtype=torch.int32, device=q_lanes.device)
    lib = load("hash_match")
    fn = lib.hash_match
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q_lanes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            q_lanes.data_ptr(), q_owner.data_ptr(), t_lanes.data_ptr(),
            t_owner.data_ptr(), out.data_ptr(), n, m, stream,
        )
    if rc != 0:
        raise RuntimeError(f"hash_match launch failed: cudaError {rc}")
    launches += 1
    return out
