"""CUDA kernel: dense assertion-tape evaluation (the dense layout).

Computes the (N, A) int8 pass matrix of every node against every assertion
row of the tape, with the 19-op mini-ISA and the paper's precondition
semantics (wrong type => pass for AND rows).  Replaces the Pallas TPU kernel
``assertion_eval_pallas`` (``repro/kernels/assertion_eval.py``).

What bounds it on the H100, and the design: memory (one output byte per
element, plus the node columns the rows' ops read and 56 bytes per row,
each once), with the per-element op dispatch close behind.  Rows are
staged once per block in shared memory, sorted by op code, so the
evaluator is dispatched once per run of equal ops and the warp never
diverges; each thread evaluates two nodes per row step, and a node's hash
lanes, prefix and other columns are loaded only when a staged op reads
them.  A persistent grid walks 256-node tiles, collects each tile's bytes
in shared memory and writes them as coalesced 16-byte stores.  The kernel
masks the ragged edges of N and A itself, so unlike the JAX wrapper
nothing is padded with op -1 rows.  Source: ``csrc/assertion_eval.cu``,
with the evaluator shared with the windowed kernel in
``csrc/eval_row.cuh``.
"""

from __future__ import annotations

import ctypes

import torch

from .assertion_eval_window import _NODE_COLS, _ROW_COLS
from .build import load
from .hash_match import _check

__all__ = ["assertion_eval_cuda"]

# kernel launches since import; chip_smoke.py zeroes it before the main path
launches = 0


def assertion_eval_cuda(node_cols: dict, asrt_cols: dict) -> torch.Tensor:
    """(N, A) int8 pass matrix, on PyTorch's current stream.

    Column dtypes and shapes as in ``ref.assertion_eval_ref``.
    """
    global launches
    n, a = node_cols["type"].shape[0], asrt_cols["op"].shape[0]
    args = []
    for key, dtype, tail in _NODE_COLS:
        _check(key, node_cols[key], dtype, (n,) + tail)
        args.append(node_cols[key])
    for key, dtype, tail in _ROW_COLS:
        _check(key, asrt_cols[key], dtype, (a,) + tail)
        args.append(asrt_cols[key])
    device = args[0].device
    if any(t.device != device for t in args):
        raise ValueError("assertion_eval: all tensors must be on one device")
    if n >= 2**31 or a >= 2**31:
        raise ValueError(f"assertion_eval: N={n} and A={a} must fit in int32")
    out = torch.empty((n, a), dtype=torch.int8, device=device)
    if out.data_ptr() % 16:  # the kernel stores 16-byte chunks
        raise RuntimeError("assertion_eval: output buffer is not 16-byte aligned")
    lib = load("assertion_eval")
    fn = lib.assertion_eval
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), n, a, stream)
    if rc != 0:
        raise RuntimeError(f"assertion_eval launch failed: cudaError {rc}")
    launches += 1
    return out
