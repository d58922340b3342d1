"""The port's plain PyTorch kernels against the JAX package's kernel ops.

Seeded numpy inputs go through ``repro.kernels.ops`` (both the pure-jnp
reference, ``use_pallas=False``, and the Pallas kernel in interpret mode)
and through ``repro_torch.kernels.ops`` on CPU tensors, which run the plain
versions that the CUDA kernels are held against on the card.  Tolerance:
exact -- the outputs are an int32 row index and an int8 pass matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tape import AOP
from repro.data.doc_table import _str_prefix8, key_lanes
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.assertion_eval_window import assertion_eval_window_cuda
from repro_torch.kernels.hash_match import hash_match_cuda

_KEYS = ["a", "b", "name", "kind", "value", "x" * 40, "y" * 40, "nested", "tags", ""]
_POOL = np.stack([key_lanes(k) for k in _KEYS])
_MODES = [pytest.param(False, id="jnp"), pytest.param(True, id="pallas-interpret")]


def _torch(cols: dict) -> dict:
    """numpy columns -> CPU tensors; uint32 words travel as int32 views."""
    out = {}
    for k, v in cols.items():
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def _jax(cols: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in cols.items()}


# ---------------------------------------------------------------------------
# hash_match
# ---------------------------------------------------------------------------


def _hash_inputs(rng, n, m, q_owners=(0, 4), t_owners=(0, 4), pad_frac=0.0):
    q = _POOL[rng.integers(0, len(_POOL), n)]
    t = _POOL[rng.integers(0, len(_POOL), m)]
    q_owner = rng.integers(*q_owners, n).astype(np.int32)
    t_owner = rng.integers(*t_owners, m).astype(np.int32)
    # padding owners: -1 on queries, -9 on table rows (never match)
    q_owner[rng.random(n) < pad_frac] = -1
    t_owner[rng.random(m) < pad_frac] = -9
    return q, q_owner, t, t_owner


def _check_hash(q, q_owner, t, t_owner, use_pallas, **blocks):
    want = jops.hash_match(
        jnp.asarray(q), jnp.asarray(q_owner), jnp.asarray(t), jnp.asarray(t_owner),
        use_pallas=use_pallas, **blocks,
    )
    c = _torch({"q": q, "qo": q_owner, "t": t, "to": t_owner})
    got = tops.hash_match(c["q"], c["qo"], c["t"], c["to"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("n,m", [(1, 1), (7, 5), (128, 64), (300, 130), (513, 257)])
def test_hash_match_shapes(n, m, use_pallas):
    rng = np.random.default_rng(n * 1000 + m)
    _check_hash(*_hash_inputs(rng, n, m), use_pallas, block_n=128, block_m=128)


@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("seed", range(6))
def test_hash_match_sweep_with_padding_owners(seed, use_pallas):
    rng = np.random.default_rng(seed)
    n, m = rng.integers(1, 41, 2)
    inputs = _hash_inputs(rng, n, m, q_owners=(-1, 3), t_owners=(0, 3), pad_frac=0.2)
    _check_hash(*inputs, use_pallas, block_n=8, block_m=8)


def test_hash_match_padding_owner_never_matches():
    lanes = torch.from_numpy(_POOL[:1].view(np.int32).copy())
    minus1 = torch.tensor([-1], dtype=torch.int32)
    assert tops.hash_match(lanes, minus1, lanes, torch.tensor([-9], dtype=torch.int32)) == -1
    # owner -1 is an owner like any other: a -1 query hits a -1 row, as in
    # the JAX op (only the wrapper's -9 table padding never matches)
    assert tops.hash_match(lanes, minus1, lanes, minus1) == 0


def test_hash_match_first_match_wins():
    lanes = torch.from_numpy(np.repeat(_POOL[2:3], 3, axis=0).view(np.int32).copy())
    got = tops.hash_match(
        lanes[:1], torch.zeros(1, dtype=torch.int32), lanes, torch.zeros(3, dtype=torch.int32)
    )
    assert int(got[0]) == 0


@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("n,m", [(1, 1), (9, 5), (300, 130), (257, 1100)])
def test_hash_match_owner_minus_one_rows(n, m, use_pallas):
    """Tables holding owner -1 rows beside -9 rows, queried by -1 owners
    whose lanes hit them; m = 1100 exceeds both the Pallas tile (128 rows)
    and the CUDA kernel's in-shared capacity (1024 rows)."""
    rng = np.random.default_rng(n * 7 + m)
    q, q_owner, t, t_owner = _hash_inputs(rng, n, m, q_owners=(-1, 3), t_owners=(-1, 3))
    t_owner[rng.random(m) < 0.2] = -9
    q_owner[0] = -1
    # plant queries (query 0, owner -1, among them) at distinct rows that
    # carry their owner, some late in the table
    planted = rng.permutation(m)[: max(1, min(n, m) // 2)]
    t[planted] = q[: len(planted)]
    t_owner[planted] = q_owner[: len(planted)]
    _check_hash(q, q_owner, t, t_owner, use_pallas, block_n=128, block_m=128)
    got = tops.hash_match(*_torch({"q": q, "qo": q_owner, "t": t, "to": t_owner}).values())
    assert 0 <= int(got[0]) <= int(planted[0])


# ---------------------------------------------------------------------------
# assertion_eval_window
# ---------------------------------------------------------------------------


def _node_cols(rng, n, ntype=None, num=None):
    return {
        "type": (ntype if ntype is not None else rng.integers(0, 7, n)).astype(np.int32),
        "is_int": rng.integers(0, 2, n).astype(np.int32),
        "num": (num if num is not None else rng.normal(0, 10, n)).astype(np.float32),
        "size": rng.integers(0, 20, n).astype(np.int32),
        "acquired": rng.integers(-(2**31), 2**31, n).astype(np.int32),
        "str_hash": _POOL[rng.integers(0, len(_POOL), n)],
        "str_prefix": rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32),
    }


def _window_cols(rng, nodes, w, ops, *, f0=None, i0=None, masked=0.2):
    n = len(nodes["type"])
    op = rng.choice(np.asarray(ops, np.int32), (n, w))
    op[rng.random((n, w)) < masked] = -1  # masked slots evaluate to 0
    cols = {
        "op": op.astype(np.int32),
        "f0": (f0 if f0 is not None else rng.normal(0, 5, (n, w))).astype(np.float32),
        "i0": (i0 if i0 is not None else rng.integers(0, 0xFF, (n, w))).astype(np.int32),
        "i1": rng.integers(0, 2, (n, w)).astype(np.int32),
        "u0": rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32),
        "u1": rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32),
        "hash": _POOL[rng.integers(0, len(_POOL), (n, w))],
    }
    # half the slots copy the node's prefix word / string hash, so the
    # equality paths of STR_PREFIX, STR_EQ and STR_EQ_PRE fire
    same = rng.random((n, w)) < 0.5
    cols["u0"] = np.where(same, nodes["str_prefix"][:, :1], cols["u0"]).astype(np.uint32)
    cols["hash"] = np.where(same[..., None], nodes["str_hash"][:, None, :], cols["hash"])
    return cols


def _check_window(nodes, win, use_pallas):
    want = jops.assertion_eval_window(_jax(nodes), _jax(win), use_pallas=use_pallas)
    got = tops.assertion_eval_window(_torch(nodes), _torch(win))
    assert got.dtype == torch.int8 and got.shape == win["op"].shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_ALL_OPS = list(range(19))


@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("n,w", [(1, 1), (5, 3), (128, 8), (200, 6), (257, 7)])
def test_window_all_ops_shapes(n, w, use_pallas):
    rng = np.random.default_rng(n * 31 + w)
    nodes = _node_cols(rng, n)
    _check_window(nodes, _window_cols(rng, nodes, w, _ALL_OPS), use_pallas)


@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("seed", range(4))
def test_window_sweep(seed, use_pallas):
    rng = np.random.default_rng(100 + seed)
    n, w = int(rng.integers(1, 31)), int(rng.integers(1, 9))
    nodes = _node_cols(rng, n)
    _check_window(nodes, _window_cols(rng, nodes, w, _ALL_OPS), use_pallas)


@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("op", _ALL_OPS)
def test_window_each_op(op, use_pallas):
    rng = np.random.default_rng(500 + op)
    nodes = _node_cols(rng, 64)
    _check_window(nodes, _window_cols(rng, nodes, 4, [op], i0=rng.integers(-3, 40, (64, 4))),
                  use_pallas)


@pytest.mark.parametrize("use_pallas", _MODES)
def test_num_multiple_tolerance_edge(use_pallas):
    """Quotients k + eps with eps at and around the 1e-6 relative / 0.25
    absolute tolerance, for decimal divisors with no exact binary form."""
    rng = np.random.default_rng(7)
    n, w = 512, 4
    f0 = rng.choice([0.01, 0.1, 0.5, 1.0, 2.0, 3.0, 0.0, 1e-3, 7.5, -0.25], (n, w))
    k = rng.integers(-600_000, 600_000, n).astype(np.float64)
    eps = rng.choice([0.0, 1e-7, 5e-7, 1e-6, 2e-6, 0.2499, 0.25, 0.2501, 0.5], n)
    num = (k + eps) * f0[:, 0]
    nodes = _node_cols(rng, n, ntype=np.full(n, 3), num=num)
    _check_window(nodes, _window_cols(rng, nodes, w, [AOP.NUM_MULTIPLE], f0=f0, masked=0.0),
                  use_pallas)


@pytest.mark.parametrize("use_pallas", _MODES)
def test_str_prefix_lengths_zero_to_eight(use_pallas):
    rng = np.random.default_rng(11)
    words = [b"", b"x", b"x-", b"x-hello", b"x-hellow", b"x-hello-world", b"abcdefgh", b"ab"]
    n, w = 9 * len(words), 3
    data = [words[i % len(words)] for i in range(n)]
    nodes = _node_cols(rng, n, ntype=np.full(n, 4))
    nodes["str_prefix"] = np.asarray([_str_prefix8(d) for d in data], np.uint32)
    nodes["size"] = np.asarray([len(d) for d in data], np.int32)
    i0 = np.repeat(np.arange(n) // len(words), w).reshape(n, w)  # 0..8
    win = _window_cols(rng, nodes, w, [AOP.STR_PREFIX], i0=i0, masked=0.0)
    # the window holds the node's own first i0 bytes (odd rows) or those
    # bytes with the last one flipped (even rows)
    def near_miss(b: bytes) -> bytes:
        return b[:-1] + bytes([b[-1] ^ 1]) if b else b

    pfx = [_str_prefix8(d[:i] if j % 2 else near_miss(d[:i]))
           for j, (d, i) in enumerate(zip(data, i0[:, 0].tolist()))]
    win["u0"] = np.repeat(np.asarray([p[0] for p in pfx], np.uint32)[:, None], w, 1)
    win["u1"] = np.repeat(np.asarray([p[1] for p in pfx], np.uint32)[:, None], w, 1)
    _check_window(nodes, win, use_pallas)
    passes = tops.assertion_eval_window(_torch(nodes), _torch(win)).numpy()
    assert passes[1::2].any() and not passes.all()


def test_window_default_acquired_column():
    rng = np.random.default_rng(3)
    nodes = _node_cols(rng, 16, ntype=np.full(16, 6))
    win = _window_cols(rng, nodes, 2, [AOP.OBJ_HAS_SLOT], masked=0.0)
    del nodes["acquired"]
    got = tops.assertion_eval_window(_torch(nodes), _torch(win)).numpy()
    want = jops.assertion_eval_window(_jax(nodes), _jax(win), use_pallas=False)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got.any()  # no acquired bits: every object fails OBJ_HAS_SLOT


# ---------------------------------------------------------------------------
# dispatch: no fallback between device and plain version
# ---------------------------------------------------------------------------


def test_cuda_wrappers_reject_cpu_tensors():
    rng = np.random.default_rng(0)
    c = _torch(dict(zip(("q", "qo", "t", "to"), _hash_inputs(rng, 4, 3))))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hash_match_cuda(c["q"], c["qo"], c["t"], c["to"])
    nodes = _node_cols(rng, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        assertion_eval_window_cuda(_torch(nodes), _torch(_window_cols(rng, nodes, 2, _ALL_OPS)))


def test_dispatch_rejects_other_devices():
    q = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    o = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.hash_match(q, o, q, o)
    with pytest.raises(ValueError, match="mixed devices"):
        tops.hash_match(q, torch.zeros(2, dtype=torch.int32), q, o)


# ---------------------------------------------------------------------------
# build cache key
# ---------------------------------------------------------------------------


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("hash_match", "assertion_eval_window", "assertion_eval")
    assert [p.name for p in build._sources("assertion_eval")] == ["assertion_eval.cu",
                                                                  "eval_row.cuh"]
    before = {name: build._target(name) for name in names}
    header = csrc / "eval_row.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build._target(name) for name in names}
    # an edit of the shared header rebuilds both assertion kernels, and only them
    assert after["hash_match"] == before["hash_match"]
    assert after["assertion_eval"] != before["assertion_eval"]
    assert after["assertion_eval_window"] != before["assertion_eval_window"]
