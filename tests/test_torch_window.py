"""The port's tape-form window entry against the JAX package's window op.

``repro_torch.kernels.ops.assertion_eval_window_tape`` takes each node's
location and the tape itself (the CUDA kernel reads each node's CSR window
from the tape); on CPU tensors it runs its plain version.  The JAX op takes
pre-gathered windows, so the JAX side gathers them from the same tape with
numpy, as the JAX executor's ``_assertions_csr`` does (clip the row to
0..A-1, op -1 past the window's length and for a node with loc < 0), and
calls ``repro.kernels.ops.assertion_eval_window`` through the Pallas kernel
in interpret mode and through its jnp reference.  Tolerance: exact (an int8
pass matrix).
"""

import random

import numpy as np
import pytest
import torch

from repro.core.tape import AOP
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.assertion_eval_window import assertion_eval_window_tape_cuda

from test_torch_batch_executor import _load_chip_smoke
from test_torch_dense import _numpy_cols
from test_torch_kernels import _POOL, _jax, _node_cols, _torch

_MODES = [pytest.param(False, id="jnp"), pytest.param(True, id="pallas-interpret")]
_ROW_KEYS = ("op", "f0", "i0", "i1", "u0", "u1", "hash")
_NO_WINDOW = (-1, -2, -3, -4)  # padding, LOC_UNTRACKED, LOC_INVALID, LOC_FRONTIER


def _tape(rng, nodes, n_loc, a, w_hat, ops, *, masked=0.1, i0=None):
    """A tape of A rows and L windows of up to ``w_hat`` rows each: a
    quarter of them end at row A-1, the last one overruns it (clamped), some
    are empty.  Half the rows copy some node's prefix word and string hash,
    so the equality paths fire."""
    n = len(nodes["type"])
    op = rng.choice(np.asarray(ops, np.int32), a)
    op[rng.random(a) < masked] = -1
    src = rng.integers(0, n, a)
    same = rng.random(a) < 0.5
    tape = {
        "op": op.astype(np.int32),
        "f0": rng.choice([0.0, 0.01, 0.5, 2.0, -3.0, 7.5], a).astype(np.float32),
        "i0": (i0 if i0 is not None else rng.integers(-3, 40, a)).astype(np.int32),
        "i1": rng.integers(0, 2, a).astype(np.int32),
        "u0": np.where(same, nodes["str_prefix"][src, 0], rng.integers(
            0, 2**32, a, dtype=np.uint64).astype(np.uint32)).astype(np.uint32),
        "u1": rng.integers(0, 2**32, a, dtype=np.uint64).astype(np.uint32),
        "hash": np.where(same[:, None], nodes["str_hash"][src],
                         _POOL[rng.integers(0, len(_POOL), a)]),
    }
    length = np.minimum(rng.integers(0, w_hat + 1, n_loc), a)
    start = rng.integers(0, a - length + 1)
    start[: n_loc // 4] = a - length[: n_loc // 4]
    start[-1], length[-1] = a - 1, min(w_hat, 3)
    tape["start"], tape["len"] = start.astype(np.int32), length.astype(np.int32)
    loc = rng.choice(np.r_[_NO_WINDOW, np.arange(n_loc)], n).astype(np.int32)
    return loc, tape


def _np_windows(loc, tape, w):
    """The JAX executor's window gather, in numpy."""
    a = len(tape["op"])
    tracked = loc >= 0
    safe = np.where(tracked, loc, 0)
    start = tape["start"][safe].astype(np.int64)
    length = np.where(tracked, tape["len"][safe], 0)
    slots = np.arange(w)[None, :]
    rows = np.clip(start[:, None] + slots, 0, a - 1)
    win = {k: tape[k][rows] for k in _ROW_KEYS}
    win["op"] = np.where(slots < length[:, None], win["op"], -1).astype(np.int32)
    return win


def _check(loc, nodes, tape, w, use_pallas):
    want = jops.assertion_eval_window(_jax(nodes), _jax(_np_windows(loc, tape, w)),
                                      use_pallas=use_pallas)
    got = tops.assertion_eval_window_tape(torch.from_numpy(loc), _torch(nodes), _torch(tape), w)
    assert got.dtype == torch.int8 and got.shape == (len(loc), w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


_ALL_OPS = list(range(19))


# (N, L, A, Â, W): W = Â as the executor sets it, W below Â (windows cut
# short), W past Â, A past the CUDA kernel's 512 staged rows
@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("n,n_loc,a,w_hat,w", [
    (1, 1, 1, 1, 1), (37, 5, 12, 3, 3), (200, 27, 68, 6, 6), (64, 9, 50, 6, 1),
    (64, 9, 50, 6, 2), (257, 40, 300, 6, 9), (130, 20, 600, 8, 8), (100, 12, 90, 33, 33),
])
def test_window_tape_equals_jax(n, n_loc, a, w_hat, w, use_pallas):
    rng = np.random.default_rng(n * 131 + a * 7 + w)
    nodes = _node_cols(rng, n)
    loc, tape = _tape(rng, nodes, n_loc, a, w_hat, [-1] + _ALL_OPS)
    _check(loc, nodes, tape, w, use_pallas)


@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("op", _ALL_OPS)
def test_window_tape_each_op(op, use_pallas):
    rng = np.random.default_rng(900 + op)
    nodes = _node_cols(rng, 96)
    loc, tape = _tape(rng, nodes, 12, 40, 4, [op], masked=0.0, i0=rng.integers(-3, 40, 40))
    _check(loc, nodes, tape, 4, use_pallas)


@pytest.mark.parametrize("use_pallas", _MODES)
def test_window_tape_no_window_and_edges(use_pallas):
    """Nodes at locations -1..-4 and at an empty window get all zeros;
    a window ending at row A-1 evaluates that row; slots past a window's
    length are 0."""
    rng = np.random.default_rng(5)
    n, a, w = 9, 5, 3
    nodes = _node_cols(rng, n, ntype=np.full(n, 1))  # null nodes: CONST_NULL passes
    _, tape = _tape(rng, nodes, 3, a, w, [AOP.CONST_NULL], masked=0.0)
    tape["start"] = np.asarray([0, 3, 2], np.int32)
    tape["len"] = np.asarray([2, 2, 0], np.int32)  # rows 0-1; rows 3-4 (A-1); empty
    loc = np.asarray([-1, -2, -3, -4, 0, 1, 2, 1, 0], np.int32)
    got = _check(loc, nodes, tape, w, use_pallas)
    np.testing.assert_array_equal(got[:4], 0)
    np.testing.assert_array_equal(got[[4, 5, 7, 8]], [[1, 1, 0]] * 4)
    np.testing.assert_array_equal(got[6], 0)


def test_window_tape_default_acquired_column():
    rng = np.random.default_rng(8)
    nodes = _node_cols(rng, 16, ntype=np.full(16, 6))
    loc, tape = _tape(rng, nodes, 4, 10, 3, [AOP.OBJ_HAS_SLOT], masked=0.0)
    del nodes["acquired"]
    got = _check(loc, nodes, tape, 3, use_pallas=False)
    assert not got.any()  # no acquired bits: every object fails OBJ_HAS_SLOT


@pytest.mark.parametrize("use_pallas", _MODES)
def test_csr_admission_window_calls_equal_jax(use_pallas):
    """Every window call of one csr registry admission of the gateway mix
    (one per link group: the calls chip_smoke.py holds against the plain
    version on the card) against the JAX op on windows gathered from the
    same tape."""
    smoke = _load_chip_smoke()
    docs, endpoints = smoke.mixed_stream(64, random.Random(6))
    ctrl = smoke.admission_controller("csr", device="cpu")
    calls = smoke.capture_kernel_inputs(lambda: ctrl.admit_ex(docs, endpoints))
    n_groups = len({ctrl.registry.group_of(e).label for e in set(endpoints)})
    assert len(calls["assertion_eval_window"]) == n_groups
    for loc, node_cols, tape_cols, w in calls["assertion_eval_window"]:
        assert (loc.numpy() < 0).any() and (loc.numpy() >= 0).any()
        _check(loc.numpy(), _numpy_cols(node_cols), _numpy_cols(tape_cols), w, use_pallas)


def test_window_tape_cuda_wrapper_rejects_cpu_tensors():
    rng = np.random.default_rng(0)
    nodes = _node_cols(rng, 4)
    loc, tape = _tape(rng, nodes, 2, 6, 2, _ALL_OPS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        assertion_eval_window_tape_cuda(torch.from_numpy(loc), _torch(nodes), _torch(tape), 2)
