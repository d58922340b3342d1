"""CUDA kernel: windowed assertion-tape evaluation (the CSR fast path).

Computes the (N, W) int8 pass matrix of every node against the <= Â rows
of its own location's owner-sorted CSR window, with the 19-op mini-ISA and
the paper's precondition semantics (wrong type => pass for AND rows).
Replaces the Pallas TPU kernel ``assertion_eval_window_pallas``
(``repro/kernels/assertion_eval.py``) and the window gather the JAX
executor runs in front of it; the dense kernel of that module is
``assertion_eval.py`` here.

What bounds it on the H100, and the design: few bytes move (a node's 4-byte
location and W output bytes, the node columns its window's ops read, the
tape once), so latency and the per-slot op dispatch bound it.  The kernel
takes each node's location and the tape itself, not pre-gathered windows:
one thread per node finds its window (``start``/``len`` of its location),
loads only the node columns the window's ops read, once, and walks its
slots.  Tapes of up to 512 rows are staged in shared memory once per block
of a persistent grid; larger ones are read in place.  Each tile's bytes go
out as 16-byte stores.  Source: ``csrc/assertion_eval_window.cu``, with the
per-element evaluator in ``csrc/eval_row.cuh``.

``assertion_eval_window_cuda`` keeps the pre-gathered form of the JAX op:
it passes its (N, W) windows to the same kernel as a tape of N*W rows in
which node i's window is rows i*W .. i*W + W - 1.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .hash_match import _check

__all__ = ["assertion_eval_window_tape_cuda", "assertion_eval_window_cuda"]

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
_ROW_COLS = (
    ("op", torch.int32, ()),
    ("f0", torch.float32, ()),
    ("i0", torch.int32, ()),
    ("i1", torch.int32, ()),
    ("u0", torch.int32, ()),
    ("u1", torch.int32, ()),
    ("hash", torch.int32, (8,)),
)


def assertion_eval_window_tape_cuda(
    loc: torch.Tensor, node_cols: dict, tape_cols: dict, n_window: int
) -> torch.Tensor:
    """(N, W) int8 pass matrix read from the tape, on PyTorch's current stream.

    Arguments as in ``ref.assertion_eval_window_tape_ref``.  A tracked
    location must be below L (the plain version raises on one that is not;
    the kernel gives its node no window).
    """
    global launches
    n, w = loc.shape[0], int(n_window)
    n_loc, a = tape_cols["start"].shape[0], tape_cols["op"].shape[0]
    _check("loc", loc, torch.int32, (n,))
    args = [loc]
    for key, dtype, tail in _NODE_COLS:
        _check(key, node_cols[key], dtype, (n,) + tail)
        args.append(node_cols[key])
    for key in ("start", "len"):
        _check(key, tape_cols[key], torch.int32, (n_loc,))
        args.append(tape_cols[key])
    for key, dtype, tail in _ROW_COLS:
        _check(key, tape_cols[key], dtype, (a,) + tail)
        args.append(tape_cols[key])
    device = loc.device
    if any(t.device != device for t in args):
        raise ValueError("assertion_eval_window: all tensors must be on one device")
    if max(n, a, n_loc, w) >= 2**31 or w < 0:
        raise ValueError(f"assertion_eval_window: N={n}, A={a}, L={n_loc} and W={w} "
                         "must fit in int32")
    out = torch.empty((n, w), dtype=torch.int8, device=device)
    if out.data_ptr() % 16:  # the kernel stores 16-byte chunks
        raise RuntimeError("assertion_eval_window: output buffer is not 16-byte aligned")
    lib = load("assertion_eval_window")
    fn = lib.assertion_eval_window
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptr = [t.data_ptr() for t in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptr[:10], n_loc, *ptr[10:], a, out.data_ptr(), n, w, stream)
    if rc != 0:
        raise RuntimeError(f"assertion_eval_window launch failed: cudaError {rc}")
    launches += 1
    return out


def assertion_eval_window_cuda(node_cols: dict, w_cols: dict) -> torch.Tensor:
    """(N, W) int8 pass matrix over pre-gathered windows, on PyTorch's
    current stream: the windows go to the tape kernel as a tape of N*W rows.

    Column dtypes and shapes as in ``ref.assertion_eval_window_ref``.
    """
    n, w = w_cols["op"].shape
    for key, dtype, tail in _ROW_COLS:
        _check(key, w_cols[key], dtype, (n, w) + tail)
    if n * w >= 2**31:
        raise ValueError(f"assertion_eval_window: N*W={n * w} must fit in int32")
    tape = {key: w_cols[key].reshape((n * w,) + tail) for key, _, tail in _ROW_COLS}
    loc = torch.arange(n, dtype=torch.int32, device=w_cols["op"].device)
    tape["start"] = loc * w
    tape["len"] = torch.full_like(loc, w)
    return assertion_eval_window_tape_cuda(loc, node_cols, tape, w)
