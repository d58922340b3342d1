"""The port's batched executor against the JAX package's ``BatchValidator``.

One tape and one token table, built by the JAX package and carried across
with ``repro_torch.convert``, go through the JAX executor (pure jnp,
``use_pallas=False``, and the Pallas kernels in interpret mode) and through
the port on ``device="cpu"``.  ``(valid, decided, frontier)`` must be
bit-identical per row.  Batches stay at B <= 256.
"""

import dataclasses
import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest

from repro.core import Validator, compile_schema
from repro.core.batch_executor import BatchValidator as JaxBatchValidator
from repro.core.outcomes import InjectedFault, set_fault_hook
from repro.core.tape import build_tape, try_build_tape
from repro.data.doc_table import encode_batch
from repro.registry.linker import link_tapes
from repro.registry.presets import GATEWAY_SCHEMAS
from repro_torch.convert import table_from_reference, tape_from_reference
from repro_torch.core.batch_executor import BatchValidator
from repro_torch.core.outcomes import set_fault_hook as port_set_fault_hook

from test_batch_csr import _rand_doc, _rand_schema
from test_logical_circuit import UNION, _rand_logical
from test_recursive_unroll import LIST_SCHEMA, chain

_MODES = [pytest.param(False, id="jnp"), pytest.param(True, id="pallas-interpret")]


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _port(tape, table, **kw):
    """The port's executor and table for a reference tape and table."""
    bv = BatchValidator(tape_from_reference(_fields(tape)), device="cpu", **kw)
    return bv, table_from_reference(_fields(table))


def _assert_same(tape, docs, *, use_pallas, ids=None, max_depth=16, max_nodes=64,
                 enc_depth=16):
    table = encode_batch(docs, max_nodes=max_nodes, max_depth=enc_depth)
    want = JaxBatchValidator(tape, max_depth=max_depth, use_pallas=use_pallas).validate_ex(
        table, ids
    )
    bv, port_table = _port(tape, table, max_depth=max_depth)
    got = bv.validate_ex(port_table, ids)
    for name, g, w in zip(("valid", "decided", "frontier"), got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    return got


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SINGLE = {
    "type": "object",
    "required": ["name", "kind"],
    "properties": {
        "name": {"type": "string", "minLength": 2, "maxLength": 12, "pattern": "^x-"},
        "kind": {"enum": ["alpha", "beta", 3, None, True, 2.5]},
        "price": {"type": "number", "minimum": 0, "exclusiveMaximum": 100,
                  "multipleOf": 0.01},
        "count": {"type": "integer", "minimum": 1},
        "tags": {"type": "array", "items": {"type": "string", "const": "t"}, "maxItems": 3},
        "pair": {"prefixItems": [{"type": "integer"}, {"type": "string"}], "items": False},
        "meta": {"type": "object", "maxProperties": 2,
                 "additionalProperties": {"type": "boolean"}},
    },
    "additionalProperties": False,
}


def _single_docs(rng: random.Random, n: int) -> list:
    docs = []
    for _ in range(n):
        doc = {
            "name": rng.choice(["x-ab", "x-", "y-abc", "x-" + "z" * 12, "x-hello"]),
            "kind": rng.choice(["alpha", "beta", "gamma", 3, 4, None, True, False, 2.5]),
        }
        if rng.random() < 0.7:
            doc["price"] = rng.choice([19.99, 0.07, 100, 99.995, -1, 12.345, 3])
        if rng.random() < 0.5:
            doc["count"] = rng.choice([1, 0, 7, 2.0, 2.5])
        if rng.random() < 0.5:
            doc["tags"] = ["t"] * rng.randint(0, 4) + rng.choice([[], ["u"]])
        if rng.random() < 0.4:
            doc["pair"] = rng.choice([[1, "a"], [1, 2], [1, "a", 3], ["a"]])
        if rng.random() < 0.4:
            doc["meta"] = {k: rng.choice([True, 1]) for k in rng.sample("abc", rng.randint(0, 3))}
        if rng.random() < 0.1:
            doc["extra"] = 1
        if rng.random() < 0.1:
            del doc["name"]
        docs.append(doc)
    return docs


@pytest.mark.parametrize("use_pallas", _MODES)
def test_single_tape(use_pallas):
    tape, why = try_build_tape(compile_schema(SINGLE))
    assert tape is not None, why
    docs = _single_docs(random.Random(1), 200)
    valid, decided, _ = _assert_same(tape, docs, use_pallas=use_pallas)
    assert decided.all() and 0 < valid.sum() < len(docs)


@pytest.mark.parametrize("use_pallas", _MODES)
def test_gateway_linked_tape_with_circuits(use_pallas):
    smoke = _load_chip_smoke()
    names = list(GATEWAY_SCHEMAS)
    tape = link_tapes(
        [try_build_tape(compile_schema(GATEWAY_SCHEMAS[n]))[0] for n in names], names=names
    )
    assert tape.n_members == 5 and tape.n_circuits > 0
    docs, endpoints = smoke.mixed_stream(256, random.Random(0))
    ids = np.asarray([names.index(e) for e in endpoints], np.int32)
    valid, decided, _ = _assert_same(tape, docs, use_pallas=use_pallas, ids=ids)
    # every decided verdict also equals the sequential oracle
    oracle = [Validator(compile_schema(GATEWAY_SCHEMAS[n])) for n in names]
    for i in np.flatnonzero(decided):
        assert bool(valid[i]) == oracle[ids[i]].is_valid(docs[i]), docs[i]
    assert 0.8 < decided.mean() and 0 < valid.sum() < len(docs)


@pytest.mark.parametrize("use_pallas", _MODES)
def test_recursive_tape_reaches_frontier(use_pallas):
    tape, why = try_build_tape(compile_schema(LIST_SCHEMA))
    assert tape is not None and tape.n_frontier > 0, why
    docs = [chain(d, bad_at=(d // 2 if d % 3 == 0 else None)) for d in range(8)]
    _, decided, frontier = _assert_same(tape, docs, use_pallas=use_pallas)
    assert frontier.any() and decided.any()


def test_frontier_root_seeds_the_sentinel():
    # a node budget of one location: the unroll budget dies at the root
    tape = build_tape(compile_schema(LIST_SCHEMA), unroll_depth=1, unroll_node_budget=1)
    assert tape.loc_frontier[tape.roots].all()
    _, decided, frontier = _assert_same(tape, [chain(0), chain(2), 5], use_pallas=False)
    assert frontier.all() and not decided.any()


@pytest.mark.parametrize("use_pallas", _MODES)
def test_depth_budget_comes_back_undecided(use_pallas):
    tape, _ = try_build_tape(compile_schema(
        {"properties": {"a": {"properties": {"b": {"properties": {"c": {
            "properties": {"d": {"type": "integer"}}}}}}}}}
    ))
    deep_ok = {"a": {"b": {"c": {"d": 1}}}}
    deep_bad = {"a": {"b": {"c": {"d": "x"}}}}
    docs = [{"a": 1}, deep_ok, deep_bad, {}]
    _, decided, _ = _assert_same(tape, docs, use_pallas=use_pallas, max_depth=3)
    assert decided.tolist() == [True, False, False, True]


@pytest.mark.parametrize("seed", range(3))
def test_random_schemas(seed):
    rng = random.Random(0x70C4 + seed)
    checked = 0
    while checked < 6:
        schema = _rand_logical(rng, 2) if checked % 2 else _rand_schema(rng, 3)
        tape, _ = try_build_tape(compile_schema(schema))
        if tape is None:
            continue
        checked += 1
        docs = [_rand_doc(rng, 3) for _ in range(rng.randint(1, 8))]
        _assert_same(tape, docs, use_pallas=False, max_depth=8, enc_depth=8)


def test_union_circuit_tape():
    tape, why = try_build_tape(compile_schema(UNION))
    assert tape is not None and tape.n_circuits > 0, why
    docs = [
        {"kind": "card", "number": "4111111111111111", "cvv": "123"},
        {"kind": "card", "iban": "DE89370400440532013000"},
        {"kind": "bank", "iban": "DE89370400440532013000"},
        {"kind": "wallet"},
        {"kind": "bank", "iban": "short"},
        {},
        "not an object",
    ]
    _assert_same(tape, docs, use_pallas=False)


def test_validate_isolated_with_injected_fault():
    tape, _ = try_build_tape(compile_schema(SINGLE))
    docs = _single_docs(random.Random(5), 64)
    table = encode_batch(docs, max_nodes=64)
    poison = 37

    def hook(point, key):
        if point == "launch" and poison in key:
            raise InjectedFault(f"poisoned row {poison}")

    prev = set_fault_hook(hook)
    try:
        want = JaxBatchValidator(tape, use_pallas=False).validate_isolated(table)
    finally:
        set_fault_hook(prev)
    bv, port_table = _port(tape, table)
    prev = port_set_fault_hook(hook)
    try:
        got = bv.validate_isolated(port_table)
    finally:
        port_set_fault_hook(prev)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert set(got[3]) == set(want[3]) == {poison}
    clean = bv.validate_ex(port_table)
    keep = np.arange(len(docs)) != poison
    for g, c in zip(got[:3], clean):
        np.testing.assert_array_equal(g[keep], c[keep])


def test_launch_phases_attribute_host_time():
    from repro_torch.obs.profile import Profiler

    smoke = _load_chip_smoke()
    names = list(GATEWAY_SCHEMAS)
    tape = link_tapes(
        [try_build_tape(compile_schema(GATEWAY_SCHEMAS[n]))[0] for n in names], names=names
    )
    docs, endpoints = smoke.mixed_stream(32, random.Random(1))
    ids = np.asarray([names.index(e) for e in endpoints], np.int32)
    bv, table = _port(tape, encode_batch(docs, max_nodes=64))
    bv.validate_ex(table, ids)  # first launch under the shape: executor.compile
    with Profiler() as prof:
        bv.validate_ex(table, ids)
    stats = prof.stats()
    for phase in ("execute", "columns", "locations", "assertions", "circuits", "sync"):
        assert stats[f"executor.{phase}"].calls == 1, phase
    assert "executor.compile" not in stats
