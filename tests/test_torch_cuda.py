"""The port's CUDA kernels and executor on the card (marker ``cuda``).

Skipped without a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held bit-equal to its plain PyTorch version on the same CUDA
tensors, and the executor's CUDA run to its CPU run.  The pre-gathered
window wrapper runs the tape-form window kernel on a tape of N*W rows.
"""

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import compile_schema
from repro_torch.core.batch_executor import BatchValidator
from repro_torch.core.tape import try_build_tape
from repro_torch.data.doc_table import encode_batch, key_lanes
from repro_torch.data.pipeline import AdmissionController
from repro_torch.kernels import assertion_eval as ae_mod
from repro_torch.kernels import assertion_eval_window as aw_mod
from repro_torch.kernels import hash_match as hm_mod
from repro_torch.kernels import ref
from repro_torch.registry import SchemaRegistry, link_tapes
from repro_torch.registry.presets import GATEWAY_SCHEMAS

pytestmark = pytest.mark.cuda

_POOL = np.stack([key_lanes(k) for k in ["a", "b", "name", "kind", "x" * 40, ""]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _load_chip_smoke():
    """chip_smoke.py as a module (its tape-window case generator); the
    machine with the card has no JAX, so nothing here imports it."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_cuda_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _i32(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# N around a block's 256 queries (one a thread), M around the 1024 rows
# the kernel holds in shared memory
@pytest.mark.parametrize("n,m", [(1, 1), (1000, 300), (70_000, 600), (1023, 1024),
                                 (1025, 1025), (4097, 3000)])
def test_hash_match_equals_plain(cuda, n, m):
    rng = np.random.default_rng(n + m)
    q = _i32(_POOL[rng.integers(0, len(_POOL), n)], cuda)
    t = _i32(_POOL[rng.integers(0, len(_POOL), m)], cuda)
    qo = _i32(rng.integers(-1, 4, n).astype(np.int32), cuda)
    # table owners -1 (matched by -1 queries), -9 and 0..3
    to = _i32(rng.choice([-1, -9, 0, 1, 2, 3], m).astype(np.int32), cuda)
    before = hm_mod.launches
    got = hm_mod.hash_match_cuda(q, qo, t, to)
    assert hm_mod.launches == before + 1
    assert torch.equal(got, ref.hash_match_ref(q, qo, t, to))


@pytest.mark.parametrize("m", [3, 20, 1030, 2100])
def test_hash_match_duplicate_rows_give_least_row(cuda, m):
    """Copies of each query's lanes at several rows, under owners that
    differ between copies, some beyond a 1024-row staging chunk: the answer
    is the least row whose lanes and owner both match."""
    rng = np.random.default_rng(m)
    q = _POOL[rng.integers(0, len(_POOL), 8)]
    t = _POOL[rng.integers(0, len(_POOL), m)]
    qo = np.array([-1, 0, 1, 2, -1, 0, 1, 3], dtype=np.int32)
    to = rng.choice([-1, -9, 0, 1], m).astype(np.int32)
    for j in range(3 * len(q)):
        t[rng.integers(0, m)] = q[j % len(q)]
    t[m - 1], to[m - 1] = q[7], 3  # a match only in the last row
    args = [_i32(a, cuda) for a in (q, qo, t, to)]
    got = hm_mod.hash_match_cuda(*args)
    assert torch.equal(got, ref.hash_match_ref(*args))
    assert int(got[7]) == m - 1


@pytest.mark.parametrize("n,w", [(1, 1), (5000, 6), (70_000, 8)])
def test_assertion_eval_window_equals_plain(cuda, n, w):
    rng = np.random.default_rng(n * 7 + w)
    nodes = {
        "type": rng.integers(0, 7, n).astype(np.int32),
        "is_int": rng.integers(0, 2, n).astype(np.int32),
        "num": rng.normal(0, 10, n).astype(np.float32),
        "size": rng.integers(0, 20, n).astype(np.int32),
        "acquired": rng.integers(-(2**31), 2**31, n).astype(np.int32),
        "str_hash": _POOL[rng.integers(0, len(_POOL), n)],
        "str_prefix": rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32),
    }
    win = {
        "op": rng.integers(-1, 19, (n, w)).astype(np.int32),
        "f0": rng.choice([0.0, 0.01, 0.5, 2.0, 3.0], (n, w)).astype(np.float32),
        "i0": rng.integers(-3, 40, (n, w)).astype(np.int32),
        "i1": rng.integers(0, 2, (n, w)).astype(np.int32),
        "u0": rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32),
        "u1": rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32),
        "hash": _POOL[rng.integers(0, len(_POOL), (n, w))],
    }
    nd = {k: _i32(v, cuda) for k, v in nodes.items()}
    wd = {k: _i32(v, cuda) for k, v in win.items()}
    before = aw_mod.launches
    got = aw_mod.assertion_eval_window_cuda(nd, wd)
    assert aw_mod.launches == before + 1
    assert torch.equal(got, ref.assertion_eval_window_ref(nd, wd))


# the tape-form window kernel (the executor's): A around the 512 rows it
# stages in shared memory and far above them, W up to two passes of 64
# slots, N not a multiple of a block's 256 nodes; locations -1..-4, empty
# windows, windows ending at row A-1 and one overrunning it
@pytest.mark.parametrize("n,n_loc,a,w", [(1, 1, 1, 1), (4099, 27, 68, 6), (1000, 60, 511, 8),
                                         (1001, 60, 512, 8), (999, 60, 513, 33),
                                         (255, 9, 100, 70), (300, 40, 3000, 70),
                                         (70_000, 200, 50_000, 6)])
def test_assertion_eval_window_tape_equals_plain(cuda, n, n_loc, a, w):
    smoke = _load_chip_smoke()
    rng = np.random.default_rng(n * 13 + a + w)
    nd, loc, tape = smoke.window_tape_case(rng, smoke._key_pool(), n, n_loc, a, w)
    before = aw_mod.launches
    got = aw_mod.assertion_eval_window_tape_cuda(loc, nd, tape, w)
    assert aw_mod.launches == before + 1
    assert torch.equal(got, ref.assertion_eval_window_tape_ref(loc, nd, tape, w))


@pytest.mark.parametrize("a", [1, 68, 511, 512])
def test_assertion_eval_window_staged_equals_in_place(cuda, a):
    """The same windows with the tape's rows staged in shared memory and
    read in place (the tape padded with op -1 rows past 512 rows): no
    window overruns the tape, so both give the same matrix."""
    smoke = _load_chip_smoke()
    rng = np.random.default_rng(a)
    nd, loc, tape = smoke.window_tape_case(rng, smoke._key_pool(), 5000, 30, a, 6)
    tape["len"][-1] = 0  # the overrunning window
    staged = aw_mod.assertion_eval_window_tape_cuda(loc, nd, tape, 6)
    in_place = aw_mod.assertion_eval_window_tape_cuda(loc, nd, smoke.pad_tape(tape, 600), 6)
    assert torch.equal(staged, in_place)
    assert torch.equal(staged, ref.assertion_eval_window_tape_ref(loc, nd, tape, 6))


# A around the kernel's 128 staged rows and N * A with unaligned 16-byte ends
@pytest.mark.parametrize("n,a", [(1, 1), (5000, 29), (70_000, 68), (257, 15), (1001, 16),
                                 (3, 17), (4099, 26), (513, 129), (33, 4099)])
def test_assertion_eval_equals_plain(cuda, n, a):
    rng = np.random.default_rng(n * 11 + a)
    nodes = {
        "type": rng.integers(-1, 8, n).astype(np.int32),
        "is_int": rng.integers(0, 2, n).astype(np.int32),
        "num": rng.normal(0, 10, n).astype(np.float32),
        "size": rng.integers(0, 20, n).astype(np.int32),
        "acquired": rng.integers(-(2**31), 2**31, n).astype(np.int32),
        "str_hash": _POOL[rng.integers(0, len(_POOL), n)],
        "str_prefix": rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32),
    }
    rows = {
        "op": rng.integers(-1, 19, a).astype(np.int32),
        "f0": rng.choice([0.0, 0.01, 0.5, 2.0, 3.0], a).astype(np.float32),
        "i0": rng.integers(-3, 40, a).astype(np.int32),
        "i1": rng.integers(0, 2, a).astype(np.int32),
        "u0": nodes["str_prefix"][rng.integers(0, n, a), 0],
        "u1": rng.integers(0, 2**32, a, dtype=np.uint64).astype(np.uint32),
        "hash": nodes["str_hash"][rng.integers(0, n, a)],
    }
    nd = {k: _i32(v, cuda) for k, v in nodes.items()}
    rd = {k: _i32(v, cuda) for k, v in rows.items()}
    before = ae_mod.launches
    got = ae_mod.assertion_eval_cuda(nd, rd)
    assert ae_mod.launches == before + 1
    assert torch.equal(got, ref.assertion_eval_ref(nd, rd))


def _gateway_batch(batch: int):
    names = list(GATEWAY_SCHEMAS)
    tape = link_tapes(
        [try_build_tape(compile_schema(GATEWAY_SCHEMAS[n]))[0] for n in names], names=names
    )
    rng = random.Random(3)
    docs, ids = [], []
    for i in range(batch):
        s = rng.randrange(len(names))
        ids.append(s)
        docs.append(rng.choice([{"prompt": "hi", "max_tokens": i}, {"input": "x" * (i % 3)},
                                {"messages": [{"role": "user", "content": "c"}]}, {}]))
    return tape, docs, ids, [names[s] for s in ids]


def test_gateway_mix_cuda_equals_cpu(cuda):
    tape, docs, ids, _ = _gateway_batch(256)
    table = encode_batch(docs, max_nodes=32)
    before = (hm_mod.launches, aw_mod.launches)
    got = BatchValidator(tape).validate_ex(table, ids)
    assert (hm_mod.launches, aw_mod.launches) == (before[0] + 1, before[1] + 1)
    want = BatchValidator(tape, device="cpu").validate_ex(table, ids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dense_gateway_launch_cuda_equals_cpu(cuda):
    tape, docs, ids, _ = _gateway_batch(256)
    table = encode_batch(docs, max_nodes=32)
    before = (hm_mod.launches, ae_mod.launches)
    bv = BatchValidator(tape, layout="dense")
    got = bv.validate_ex(table, ids)
    # the dense loop matches once per depth iteration
    assert (hm_mod.launches, ae_mod.launches) == (before[0] + bv.max_depth, before[1] + 1)
    want = BatchValidator(tape, device="cpu", layout="dense").validate_ex(table, ids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout", ["csr", "dense"])
def test_registry_admission_cuda_equals_cpu(cuda, layout):
    _, docs, _, endpoints = _gateway_batch(300)
    verdicts = []
    for device in ("cuda", "cpu"):
        reg = SchemaRegistry(device=device, layout=layout)
        for name, schema in GATEWAY_SCHEMAS.items():
            reg.register(name, schema)
        ctrl = AdmissionController(registry=reg, endpoint="complete", batch_max_nodes=64)
        verdicts.append([(v.outcome, v.valid, v.engine) for v in ctrl.admit_ex(docs, endpoints)])
    assert verdicts[0] == verdicts[1]
    assert any(engine == "batched" for _, _, engine in verdicts[0])
