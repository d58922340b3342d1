"""The port's dense layout against the JAX package's.

- the dense assertion kernel's plain version (``ops.assertion_eval`` on CPU
  tensors) is bit-equal to the JAX ``assertion_eval``, through the Pallas
  kernel in interpret mode and through its jnp reference, for random
  columns, every op code and the rounding and shift edges;
- ``BatchValidator(layout="dense", device="cpu")`` gives ``(valid, decided,
  frontier)`` bit-equal to the JAX dense ``BatchValidator`` and to the
  port's own CSR layout, on the gateway linked tape, circuits, a recursive
  ``$ref`` schema with a frontier, a depth budget and a property-less tape.

Inputs come from numpy seeds; sizes stay small (the interpret-mode Pallas
kernel pads to 256 x 256 blocks).
"""

import random

import numpy as np
import pytest
import torch

from repro.core import Validator, compile_schema
from repro.core.batch_executor import BatchValidator as JaxBatchValidator
from repro.core.tape import AOP, build_tape, try_build_tape
from repro.data.doc_table import _str_prefix8, encode_batch
from repro.kernels import ops as jops
from repro.registry.linker import link_tapes
from repro.registry.presets import GATEWAY_SCHEMAS
from repro_torch.kernels import ops as tops
from repro_torch.kernels.assertion_eval import assertion_eval_cuda

from test_batch_csr import _rand_doc, _rand_schema
from test_logical_circuit import UNION, UNION_DOCS, _rand_logical
from test_recursive_unroll import LIST_SCHEMA, chain
from test_torch_batch_executor import _load_chip_smoke, _port
from test_torch_kernels import _POOL, _jax, _node_cols, _torch

_MODES = [pytest.param(False, id="jnp"), pytest.param(True, id="pallas-interpret")]
_ALL_OPS = list(range(19))


# ---------------------------------------------------------------------------
# the dense kernel's plain version
# ---------------------------------------------------------------------------


def _row_cols(rng, nodes, a, ops, *, f0=None, i0=None, masked=0.2):
    """(A,) assertion-row columns; half the rows copy some node's prefix
    word and string hash, so the equality paths fire."""
    n = len(nodes["type"])
    op = rng.choice(np.asarray(ops, np.int32), a)
    op[rng.random(a) < masked] = -1  # padding rows evaluate to 0
    cols = {
        "op": op.astype(np.int32),
        "f0": (f0 if f0 is not None else rng.normal(0, 5, a)).astype(np.float32),
        "i0": (i0 if i0 is not None else rng.integers(0, 0xFF, a)).astype(np.int32),
        "i1": rng.integers(0, 2, a).astype(np.int32),
        "u0": rng.integers(0, 2**32, a, dtype=np.uint64).astype(np.uint32),
        "u1": rng.integers(0, 2**32, a, dtype=np.uint64).astype(np.uint32),
        "hash": _POOL[rng.integers(0, len(_POOL), a)],
    }
    same = rng.random(a) < 0.5
    src = rng.integers(0, n, a)
    cols["u0"] = np.where(same, nodes["str_prefix"][src, 0], cols["u0"]).astype(np.uint32)
    cols["hash"] = np.where(same[:, None], nodes["str_hash"][src], cols["hash"])
    return cols


def _check_dense(nodes, rows, use_pallas):
    want = jops.assertion_eval(_jax(nodes), _jax(rows), use_pallas=use_pallas)
    got = tops.assertion_eval(_torch(nodes), _torch(rows))
    assert got.dtype == torch.int8
    assert got.shape == (len(nodes["type"]), len(rows["op"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("n,a", [(1, 1), (5, 3), (37, 19), (257, 20)])
def test_dense_all_ops_shapes(n, a, use_pallas):
    rng = np.random.default_rng(n * 53 + a)
    nodes = _node_cols(rng, n)
    _check_dense(nodes, _row_cols(rng, nodes, a, _ALL_OPS), use_pallas)


@pytest.mark.parametrize("use_pallas", _MODES)
@pytest.mark.parametrize("op", _ALL_OPS)
def test_dense_each_op(op, use_pallas):
    rng = np.random.default_rng(900 + op)
    nodes = _node_cols(rng, 48)
    rows = _row_cols(rng, nodes, 24, [op], i0=rng.integers(-3, 40, 24))
    passes = _check_dense(nodes, rows, use_pallas)
    assert not passes[:, rows["op"] == -1].any()


@pytest.mark.parametrize("use_pallas", _MODES)
def test_dense_num_multiple_edges_and_zero_divisor(use_pallas):
    """Quotients k + eps at and around the tolerance, divisors without an
    exact binary form, and f0 = 0 (never a multiple)."""
    rng = np.random.default_rng(17)
    n = 96
    f0 = np.asarray([0.01, 0.1, 0.5, 1.0, 2.0, 3.0, 0.0, 1e-3, 7.5, -0.25, 0.0, 0.3])
    k = rng.integers(-600_000, 600_000, n).astype(np.float64)
    eps = rng.choice([0.0, 1e-7, 5e-7, 1e-6, 2e-6, 0.2499, 0.25, 0.2501, 0.5], n)
    num = (k + eps) * rng.choice(f0[f0 != 0], n)
    nodes = _node_cols(rng, n, ntype=np.full(n, 3), num=num)
    rows = _row_cols(rng, nodes, len(f0), [AOP.NUM_MULTIPLE], f0=f0, masked=0.0)
    passes = _check_dense(nodes, rows, use_pallas)
    assert not passes[:, f0 == 0].any() and passes.any()


@pytest.mark.parametrize("use_pallas", _MODES)
def test_dense_str_prefix_lengths(use_pallas):
    rng = np.random.default_rng(23)
    words = [b"", b"x", b"x-", b"x-hello", b"x-hellow", b"x-hello-world", b"abcdefgh"]
    nodes = _node_cols(rng, len(words), ntype=np.full(len(words), 4))
    nodes["str_prefix"] = np.asarray([_str_prefix8(w) for w in words], np.uint32)
    nodes["size"] = np.asarray([len(w) for w in words], np.int32)
    # rows: the prefixes of "x-hello-world" with i0 from -2 to 12
    i0 = np.arange(-2, 13)
    pfx = np.asarray([_str_prefix8(b"x-hello-world"[: max(0, i)]) for i in i0], np.uint32)
    rows = _row_cols(rng, nodes, len(i0), [AOP.STR_PREFIX], i0=i0, masked=0.0)
    rows["u0"], rows["u1"] = pfx[:, 0], pfx[:, 1]
    passes = _check_dense(nodes, rows, use_pallas)
    assert passes.any() and not passes.all()


@pytest.mark.parametrize("use_pallas", _MODES)
def test_dense_shifts_outside_the_word(use_pallas):
    """OBJ_HAS_SLOT and TYPE_MASK with shift amounts below 0 and >= 32."""
    rng = np.random.default_rng(29)
    nodes = _node_cols(rng, 64, ntype=rng.integers(-2, 40, 64))
    rows = _row_cols(rng, nodes, 40, [AOP.OBJ_HAS_SLOT, AOP.TYPE_MASK],
                     i0=rng.integers(-40, 80, 40), masked=0.1)
    _check_dense(nodes, rows, use_pallas)


def test_dense_default_acquired_column():
    rng = np.random.default_rng(31)
    nodes = _node_cols(rng, 16, ntype=np.full(16, 6))
    rows = _row_cols(rng, nodes, 5, [AOP.OBJ_HAS_SLOT], masked=0.0)
    del nodes["acquired"]
    got = tops.assertion_eval(_torch(nodes), _torch(rows)).numpy()
    want = jops.assertion_eval(_jax(nodes), _jax(rows), use_pallas=False)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got.any()  # no acquired bits: every object fails OBJ_HAS_SLOT


def test_dense_cuda_wrapper_rejects_cpu_tensors():
    rng = np.random.default_rng(0)
    nodes = _node_cols(rng, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        assertion_eval_cuda(_torch(nodes), _torch(_row_cols(rng, nodes, 3, _ALL_OPS)))


# ---------------------------------------------------------------------------
# the dense executor
# ---------------------------------------------------------------------------


def _assert_dense_same(tape, docs, *, use_pallas=False, ids=None, max_depth=16,
                       max_nodes=64, enc_depth=16):
    """Port dense == JAX dense == port CSR on one table; returns the port's."""
    table = encode_batch(docs, max_nodes=max_nodes, max_depth=enc_depth)
    want = JaxBatchValidator(
        tape, max_depth=max_depth, use_pallas=use_pallas, layout="dense"
    ).validate_ex(table, ids)
    dense, port_table = _port(tape, table, max_depth=max_depth, layout="dense")
    csr, _ = _port(tape, table, max_depth=max_depth)
    got = dense.validate_ex(port_table, ids)
    via_csr = csr.validate_ex(port_table, ids)
    for name, g, w, c in zip(("valid", "decided", "frontier"), got, want, via_csr):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{name} vs JAX dense")
        np.testing.assert_array_equal(g, c, err_msg=f"{name} vs the port's CSR")
    return got


@pytest.mark.parametrize("use_pallas", _MODES)
def test_dense_gateway_linked_tape(use_pallas):
    smoke = _load_chip_smoke()
    names = list(GATEWAY_SCHEMAS)
    tape = link_tapes(
        [try_build_tape(compile_schema(GATEWAY_SCHEMAS[n]))[0] for n in names], names=names
    )
    assert tape.n_circuits > 0 and int(tape.asrt_group.max()) > 1
    docs, endpoints = smoke.mixed_stream(128, random.Random(2))
    ids = np.asarray([names.index(e) for e in endpoints], np.int32)
    valid, decided, _ = _assert_dense_same(tape, docs, use_pallas=use_pallas, ids=ids)
    oracle = [Validator(compile_schema(GATEWAY_SCHEMAS[n])) for n in names]
    for i in np.flatnonzero(decided):
        assert bool(valid[i]) == oracle[ids[i]].is_valid(docs[i]), docs[i]
    assert decided.all() and 0 < valid.sum() < len(docs)


def test_dense_union_circuit():
    tape, why = try_build_tape(compile_schema(UNION))
    assert tape is not None and tape.n_circuits > 0, why
    valid, decided, _ = _assert_dense_same(tape, UNION_DOCS)
    assert decided.all() and 0 < valid.sum() < len(UNION_DOCS)


def test_dense_circuit_over_enum_groups():
    # anyOf branches that are enums: the circuit leaves are OR-group
    # verdicts, read from the dense group columns
    schema = {
        "type": "object",
        "properties": {"a": {"anyOf": [{"enum": [1, 2, "x"]}, {"enum": ["y", None]}]},
                       "b": {"enum": [True, 3]}},
    }
    tape, why = try_build_tape(compile_schema(schema))
    assert tape is not None and tape.n_circuits > 0, why
    docs = [{"a": 1}, {"a": "y"}, {"a": "z"}, {"a": None, "b": 3}, {"b": 4}, {}, []]
    valid, _, _ = _assert_dense_same(tape, docs)
    assert valid.tolist() == [True, True, False, True, False, True, False]


def test_dense_recursive_tape_reaches_frontier():
    tape, why = try_build_tape(compile_schema(LIST_SCHEMA))
    assert tape is not None and tape.n_frontier > 0, why
    docs = [chain(d, bad_at=(d // 2 if d % 3 == 0 else None)) for d in range(8)]
    _, decided, frontier = _assert_dense_same(tape, docs)
    assert frontier.any() and decided.any()


def test_dense_depth_budget_comes_back_undecided():
    tape, _ = try_build_tape(compile_schema(
        {"properties": {"a": {"properties": {"b": {"properties": {"c": {
            "properties": {"d": {"type": "integer"}}}}}}}}}
    ))
    docs = [{"a": 1}, {"a": {"b": {"c": {"d": 1}}}}, {"a": {"b": {"c": {"d": "x"}}}}, {}]
    _, decided, _ = _assert_dense_same(tape, docs, max_depth=3)
    assert decided.tolist() == [True, False, False, True]


def test_dense_property_less_tape_placeholder_row():
    # no properties: the table holds one placeholder row (owner -1, zero
    # lanes), which the port's match never hits
    tape = build_tape(compile_schema({"type": "integer"}))
    assert tape.prop_owner.tolist() == [-1]
    docs = [1, "x", 2.5, None, {"a": 1}, [1, 2], {"": 0}]
    valid, decided, _ = _assert_dense_same(tape, docs)
    assert valid.tolist() == [True, False, False, False, False, False, False]
    assert decided.all()


@pytest.mark.parametrize("seed", range(2))
def test_dense_random_schemas(seed):
    rng = random.Random(0xDE45 + seed)
    checked = 0
    while checked < 6:
        schema = _rand_logical(rng, 2) if checked % 2 else _rand_schema(rng, 3)
        tape, _ = try_build_tape(compile_schema(schema))
        if tape is None:
            continue
        checked += 1
        docs = [_rand_doc(rng, 3) for _ in range(rng.randint(1, 8))]
        _assert_dense_same(tape, docs, max_depth=8, enc_depth=8)


_U32_COLS = ("str_hash", "str_prefix", "u0", "u1", "hash")


def _numpy_cols(cols: dict) -> dict:
    """CPU tensors -> numpy columns; int32 views of uint32 words go back
    to uint32."""
    out = {}
    for k, v in cols.items():
        a = v.numpy()
        out[k] = a.view(np.uint32) if k in _U32_COLS else a
    return out


@pytest.mark.parametrize("use_pallas", _MODES)
def test_dense_admission_kernel_calls_equal_jax(use_pallas):
    """Every kernel call of one dense registry admission of the gateway mix
    (one hash_match per depth iteration and link group, one assertion_eval
    per group: the calls chip_smoke.py holds against the plain versions on
    the card) against the JAX op on the same inputs.  All but the current
    depth's nodes query with owner -1."""
    smoke = _load_chip_smoke()
    docs, endpoints = smoke.mixed_stream(64, random.Random(4))
    ctrl = smoke.admission_controller("dense", device="cpu")
    calls = smoke.capture_kernel_inputs(lambda: ctrl.admit_ex(docs, endpoints))
    n_groups = len({ctrl.registry.group_of(e).label for e in set(endpoints)})
    assert len(calls["hash_match"]) == n_groups * ctrl.registry.max_depth
    assert len(calls["assertion_eval"]) == n_groups
    for q_lanes, q_owner, t_lanes, t_owner in calls["hash_match"]:
        assert (q_owner.numpy() == -1).any()
        want = jops.hash_match(
            q_lanes.numpy().view(np.uint32), q_owner.numpy(),
            t_lanes.numpy().view(np.uint32), t_owner.numpy(),
            use_pallas=use_pallas, block_n=1024, block_m=128,
        )
        got = tops.hash_match(q_lanes, q_owner, t_lanes, t_owner)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for node_cols, asrt_cols in calls["assertion_eval"]:
        want = jops.assertion_eval(_jax(_numpy_cols(node_cols)), _jax(_numpy_cols(asrt_cols)),
                                   use_pallas=use_pallas)
        got = tops.assertion_eval(node_cols, asrt_cols)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
