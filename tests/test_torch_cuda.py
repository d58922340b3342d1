"""The port's CUDA kernels and executor on the card (marker ``cuda``).

Skipped without a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held bit-equal to its plain PyTorch version on the same CUDA
tensors, and the executor's CUDA run to its CPU run.
"""

import random

import numpy as np
import pytest
import torch

from repro_torch.core import compile_schema
from repro_torch.core.batch_executor import BatchValidator
from repro_torch.core.tape import try_build_tape
from repro_torch.data.doc_table import encode_batch, key_lanes
from repro_torch.kernels import assertion_eval as ae_mod
from repro_torch.kernels import hash_match as hm_mod
from repro_torch.kernels import ref
from repro_torch.registry import link_tapes
from repro_torch.registry.presets import GATEWAY_SCHEMAS

pytestmark = pytest.mark.cuda

_POOL = np.stack([key_lanes(k) for k in ["a", "b", "name", "kind", "x" * 40, ""]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _i32(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@pytest.mark.parametrize("n,m", [(1, 1), (1000, 300), (70_000, 600)])
def test_hash_match_equals_plain(cuda, n, m):
    rng = np.random.default_rng(n + m)
    q = _i32(_POOL[rng.integers(0, len(_POOL), n)], cuda)
    t = _i32(_POOL[rng.integers(0, len(_POOL), m)], cuda)
    qo = _i32(rng.integers(-1, 4, n).astype(np.int32), cuda)
    to = _i32(np.where(rng.random(m) < 0.1, -9, rng.integers(0, 4, m)).astype(np.int32), cuda)
    before = hm_mod.launches
    got = hm_mod.hash_match_cuda(q, qo, t, to)
    assert hm_mod.launches == before + 1
    assert torch.equal(got, ref.hash_match_ref(q, qo, t, to))


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
    before = ae_mod.launches
    got = ae_mod.assertion_eval_window_cuda(nd, wd)
    assert ae_mod.launches == before + 1
    assert torch.equal(got, ref.assertion_eval_window_ref(nd, wd))


def test_gateway_mix_cuda_equals_cpu(cuda):
    names = list(GATEWAY_SCHEMAS)
    tape = link_tapes(
        [try_build_tape(compile_schema(GATEWAY_SCHEMAS[n]))[0] for n in names], names=names
    )
    rng = random.Random(3)
    docs, ids = [], []
    for i in range(256):
        s = rng.randrange(len(names))
        ids.append(s)
        docs.append(rng.choice([{"prompt": "hi", "max_tokens": i}, {"input": "x" * (i % 3)},
                                {"messages": [{"role": "user", "content": "c"}]}, {}]))
    table = encode_batch(docs, max_nodes=32)
    before = (hm_mod.launches, ae_mod.launches)
    got = BatchValidator(tape).validate_ex(table, ids)
    assert (hm_mod.launches, ae_mod.launches) == (before[0] + 1, before[1] + 1)
    want = BatchValidator(tape, device="cpu").validate_ex(table, ids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
