"""CUDA kernel: windowed assertion-tape evaluation (the CSR fast path).

Computes the (N, W) int8 pass matrix of every node against the <= Â rows
of its own location's owner-sorted CSR window, with the branch-free 19-op
mini-ISA and the paper's precondition semantics (wrong type => pass for AND
rows).  Replaces the Pallas TPU kernel ``assertion_eval_window_pallas``
(``repro/kernels/assertion_eval.py``).  The dense kernel of that module
(``assertion_eval_pallas``, ``layout="dense"`` only) is not ported yet.

What bounds it on the H100, and the design: the work is memory-bound
(56 bytes of window operands read and 1 byte written per slot, plus 60
bytes per node).  One thread owns one (node, slot) pair and reads the
(N, W, 8) window hashes directly; the TPU's lane-major relayout, which kept
every VMEM slice rank-2, is not needed.  Masked slots carry op -1 and give
0, so no padding is added.  Source: ``csrc/assertion_eval_window.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .hash_match import _check

__all__ = ["assertion_eval_window_cuda"]

# kernel launches since import; chip_smoke.py zeroes it before the main path
launches = 0

_NODE_COLS = (
    ("type", torch.int32, ()),
    ("is_int", torch.int32, ()),
    ("num", torch.float32, ()),
    ("size", torch.int32, ()),
    ("acquired", torch.int32, ()),
    ("str_hash", torch.int32, (8,)),
    ("str_prefix", torch.int32, (2,)),
)
_WINDOW_COLS = (
    ("op", torch.int32, ()),
    ("f0", torch.float32, ()),
    ("i0", torch.int32, ()),
    ("i1", torch.int32, ()),
    ("u0", torch.int32, ()),
    ("u1", torch.int32, ()),
    ("hash", torch.int32, (8,)),
)


def assertion_eval_window_cuda(node_cols: dict, w_cols: dict) -> torch.Tensor:
    """(N, W) int8 pass matrix, on PyTorch's current stream.

    Column dtypes and shapes as in ``ref.assertion_eval_window_ref``.
    """
    global launches
    n, w = w_cols["op"].shape
    args = []
    for key, dtype, tail in _NODE_COLS:
        _check(key, node_cols[key], dtype, (n,) + tail)
        args.append(node_cols[key])
    for key, dtype, tail in _WINDOW_COLS:
        _check(key, w_cols[key], dtype, (n, w) + tail)
        args.append(w_cols[key])
    device = args[0].device
    if any(t.device != device for t in args):
        raise ValueError("assertion_eval_window: all tensors must be on one device")
    out = torch.empty((n, w), dtype=torch.int8, device=device)
    lib = load("assertion_eval_window")
    fn = lib.assertion_eval_window
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), n, w, stream)
    if rc != 0:
        raise RuntimeError(f"assertion_eval_window launch failed: cudaError {rc}")
    launches += 1
    return out
