"""The port's batched explain against the JAX package's.

One tape and one token table, built by the JAX package and carried across
with ``repro_torch.convert``, go through the JAX ``explain_batch`` (the
Pallas kernels in interpret mode, as the package's own tests run them, and
its jnp path) and the port's on ``device="cpu"``: every ``FailureSite`` must
be equal field for field.  Then the same through the registry, the
admission controller and the serving engine.

Finding (a) of ROADMAP.md section 3.6 is pinned: for the boolean ``false``
schema the batched site is one that the sequential trace does not blame,
and the port gives the JAX package's site.
"""

import dataclasses
import json
import random

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import Validator, compile_schema
from repro.core.batch_executor import BatchValidator as JaxBatchValidator
from repro.core.tape import try_build_tape
from repro.data.doc_table import encode_batch
from repro.data.pipeline import AdmissionController as RefController
from repro.registry import SchemaRegistry as RefRegistry
from repro.registry.linker import link_tapes
from repro.registry.presets import GATEWAY_SCHEMAS
from repro_torch.data.pipeline import AdmissionController
from repro_torch.registry import SchemaRegistry

from test_differential import json_docs, schemas
from test_logical_circuit import UNION
from test_torch_batch_executor import _MODES, _load_chip_smoke, _port
from test_torch_registry import _verdicts

_EXPLAIN_SCHEMA = {  # tests/test_batched_explain.py's record schema
    "type": "object",
    "required": ["id", "name"],
    "additionalProperties": False,
    "properties": {
        "id": {"type": "integer", "minimum": 0, "maximum": 1_000_000},
        "name": {"type": "string", "minLength": 2, "maxLength": 32},
        "kind": {"enum": ["basic", "pro", "trial"]},
        "score": {"type": "number", "minimum": 0, "maximum": 1},
        "tags": {"type": "array", "items": {"type": "string"}, "maxItems": 4},
    },
}
_CIRCUITS = {  # anyOf, not and oneOf over scalars
    "type": "object",
    "properties": {
        "n": {"anyOf": [{"type": "integer", "minimum": 10}, {"type": "string"}]},
        "m": {"not": {"type": "null"}},
        "o": {"oneOf": [{"type": "integer"}, {"type": "number", "minimum": 2}]},
        "v": {"type": "integer", "minimum": 5,
              "anyOf": [{"minimum": 100}, {"maximum": -100}]},
    },
}


def _sites(sites):
    return [None if s is None else dataclasses.astuple(s) for s in sites]


def _explain_both(tape, docs, ids=None, *, use_pallas=True, max_depth=8, with_docs=True):
    """(port's sites, JAX package's sites) on the same tape and table."""
    table = encode_batch(docs, max_nodes=64, max_depth=8)
    given_docs = docs if with_docs else None
    want = JaxBatchValidator(tape, max_depth=max_depth, use_pallas=use_pallas).explain_batch(
        table, ids, docs=given_docs)
    bv, port_table = _port(tape, table, max_depth=max_depth)
    got = bv.explain_batch(port_table, ids, docs=given_docs)
    assert all(s is None or type(s).__module__.startswith("repro_torch.") for s in got)
    return _sites(got), _sites(want)


def _tape(schema):
    tape, why = try_build_tape(compile_schema(schema))
    assert tape is not None, why
    return tape


def _gateway(n, seed):
    names = list(GATEWAY_SCHEMAS)
    docs, endpoints = _load_chip_smoke().mixed_stream(n, random.Random(seed))
    return names, docs, endpoints


@pytest.mark.parametrize("use_pallas", _MODES)
def test_gateway_linked_tape(use_pallas):
    names, docs, endpoints = _gateway(256, seed=0)
    linked = link_tapes([_tape(GATEWAY_SCHEMAS[n]) for n in names], names=names)
    ids = np.asarray([names.index(e) for e in endpoints], np.int32)
    got, want = _explain_both(linked, docs, ids, use_pallas=use_pallas, max_depth=16)
    assert got == want
    assert sum(s is not None for s in got) > 10  # ~11 % invalid, circuits included
    assert any(s is not None and s[1] == "oneOf" for s in got)


@pytest.mark.parametrize("name", list(GATEWAY_SCHEMAS))
def test_each_gateway_schema(name):
    _, docs, endpoints = _gateway(400, seed=1)
    mine = [d for d, e in zip(docs, endpoints) if e == name][:48]
    # documents of the other endpoints fail this schema in other ways
    others = [d for d, e in zip(docs, endpoints) if e != name][:16]
    got, want = _explain_both(_tape(GATEWAY_SCHEMAS[name]), mine + others + [{}, [], None])
    assert got == want
    assert any(s is not None for s in got)


def test_circuit_bearing_schemas():
    docs = [{"n": 3}, {"m": None}, {"n": "fine"}, {"o": 1.5}, {"o": 3}, {"o": 2.5},
            {"v": 2}, {"v": 50}, {"v": 200}, {"n": 12, "m": 1, "o": "x"}, {}]
    got, want = _explain_both(_tape(_CIRCUITS), docs)
    assert got == want
    assert {s[1] for s in got if s is not None} >= {"anyOf", "not", "oneOf", "minimum"}


def test_tagged_union():
    docs = [{"kind": "card", "number": "4111"}, {"kind": "bank", "iban": 3},
            {"kind": "wallet"}, {"kind": "other"}, {"kind": "card", "number": 5}, 7]
    got, want = _explain_both(_tape(UNION), docs)
    assert got == want
    assert any(s is not None for s in got)


def test_record_schema_single_and_multi_failures_and_pointers():
    docs = [{"id": "x", "name": "ok", "tags": [3]}, {"id": 1, "name": "ok", "tags": ["a", 3]},
            {"name": "q" * 50, "score": -3, "extra": 1}, {}, {"id": 7, "name": "ok"},
            {"id": -5, "name": "ok"}, {"id": 1, "name": "x", "kind": "zz"}]
    tape = _tape(_EXPLAIN_SCHEMA)
    got, want = _explain_both(tape, docs)
    assert got == want and got[4] is None
    got, want = _explain_both(tape, docs, with_docs=False)  # no instance pointers
    assert got == want and all(s is None or s[2] == "" for s in got)


@pytest.mark.parametrize("case", ["lowest_bfs_node", "assertion_beats_required",
                                  "structural_beats_circuit"])
def test_tie_breaks(case):
    """The three cases of tests/test_batched_explain.py::TestTieBreak."""
    schema, doc, check = {
        "lowest_bfs_node": (_EXPLAIN_SCHEMA, {"id": "x", "name": "ok", "tags": [3]},
                            lambda s: s[2] == "/id"),
        "assertion_beats_required": (
            {"type": "object", "required": ["a"], "properties": {"a": {"type": "integer"}},
             "minProperties": 2}, {}, lambda s: s[1] != "required"),
        "structural_beats_circuit": (
            {"type": "object", "properties": {"v": {
                "type": "integer", "minimum": 5,
                "anyOf": [{"minimum": 100}, {"maximum": -100}]}}},
            {"v": 2}, lambda s: s[1] == "minimum"),
    }[case]
    got, want = _explain_both(_tape(schema), [doc])
    assert got == want and check(got[0])


@settings(max_examples=30, deadline=None)
@given(schema=schemas, docs=st.lists(json_docs, min_size=1, max_size=4))
def test_sites_equal_the_references(schema, docs):
    """Over tests/test_differential.py's strategies: on every batchable
    schema the port's sites equal the JAX package's, row for row (the
    port is held to the JAX package, not to the sequential trace)."""
    tape, _ = try_build_tape(compile_schema(schema))
    if tape is None:
        return
    got, want = _explain_both(tape, docs)
    assert got == want, (schema, docs)


def test_false_schema_site_is_the_references():
    """Pinned reference behaviour (ROADMAP.md section 3.6): for the boolean
    ``false`` schema and ``null`` the batched site is the empty root path,
    which the sequential trace (empty) does not blame; the port gives the
    JAX package's site."""
    got, want = _explain_both(_tape(False), [None])
    assert got == want == [("", "", "", "")]
    ok, trace = Validator(compile_schema(False)).explain(None)
    assert not ok and trace == []


# ---------------------------------------------------------------------------
# the registry, the admission controller and the serving engine
# ---------------------------------------------------------------------------


def _registries():
    port, ref = SchemaRegistry(device="cpu"), RefRegistry(use_pallas=True)
    for reg in (port, ref):
        for name, schema in GATEWAY_SCHEMAS.items():
            reg.register(name, schema)
        reg.register("records", _EXPLAIN_SCHEMA)
    return port, ref


def test_registry_and_controller_sites_equal_the_references():
    port, ref = _registries()
    names, docs, endpoints = _gateway(160, seed=2)
    docs = docs + [{"id": -5, "name": "ok"}, {"id": 1}, {"name": "q" * 50, "extra": 1}]
    endpoints = endpoints + ["records"] * 3
    got, counts = port.admit_mixed_ex(docs, endpoints, max_nodes=64, explain=True)
    want, rcounts = ref.admit_mixed_ex(docs, endpoints, max_nodes=64, explain=True)
    assert _verdicts(got) == _verdicts(want)
    invalid = [i for i, v in enumerate(got) if v.outcome.name == "INVALID" and v.engine == "batched"]
    assert invalid
    for i in invalid:  # as chip_smoke.py's phase 9 holds the card's sites
        site = got[i].site
        assert site is not None and site.render() == got[i].reason
        ok, trace = port.get(endpoints[i]).validator.explain(docs[i])
        assert not ok and site.schema_path in {path for path, _ in trace}
    ctrl = AdmissionController(registry=port, endpoint="complete", batch_max_nodes=64)
    rctrl = RefController(registry=ref, endpoint="complete", batch_max_nodes=64)
    assert _verdicts(ctrl.admit_ex(docs, endpoints, explain=True)) == _verdicts(
        rctrl.admit_ex(docs, endpoints, explain=True))
    assert ctrl.stats.snapshot() == rctrl.stats.snapshot()


def test_serve_engine_carries_the_references_sites():
    from repro.configs import get_config as ref_get_config
    from repro.models import Model as RefModel
    from repro.serve.engine import ServeConfig as RefServeConfig
    from repro.serve.engine import ServeEngine as RefServeEngine
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    f32 = dict(param_dtype="float32", activation_dtype="float32")
    rcfg = ref_get_config("granite-3-8b").reduced(**f32)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    scfg = dict(batch_slots=2, max_len=64, default_max_tokens=2)
    port = ServeEngine(get_config("granite-3-8b").reduced(**f32),
                       params_from_jax(jax.device_get(rparams), device="cpu"),
                       ServeConfig(**scfg), endpoint_schemas=GATEWAY_SCHEMAS, device="cpu")
    ref = RefServeEngine(rcfg, rparams, RefServeConfig(**scfg), endpoint_schemas=GATEWAY_SCHEMAS)
    _, docs, endpoints = _gateway(96, seed=4)
    rows = [(e, json.dumps(d)) for d, e in zip(docs, endpoints)]
    got = port.submit_batch(rows, explain=True)
    want = ref.submit_batch(rows, explain=True)
    results = [(r.request_id, r.error, r.outcome.name) for r in got]
    assert results == [(r.request_id, r.error, r.outcome.name) for r in want]
    # the sites' rendering is the error of each INVALID result
    assert any(r[2] == "INVALID" and "failed at" in r[1] for r in results)
    singles = [port.submit(body, e, explain=True) for e, body in rows[:24]]
    rsingles = [ref.submit(body, e, explain=True) for e, body in rows[:24]]
    assert [(r.request_id, r.error) for r in singles] == [(r.request_id, r.error)
                                                          for r in rsingles]
