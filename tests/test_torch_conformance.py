"""The port's conformance check against the JAX package's, on the CPU.

- the tier-1 corpus gate (``test_conformance_corpus.py``'s text, adapted by
  ``torch_suites.adapted_suites("cpu")``) on the port's runner
  (``repro_torch.launch.conformance``) in both executor layouts;
- every batchable case of the corpus and of ``test_conformance.py``'s
  ``CASES``, the schemas of a source linked into one tape (one launch a
  layout; the linker suites hold linked dispatch to per-schema dispatch):
  the port's ``BatchValidator(device="cpu")`` gives the JAX
  ``BatchValidator(use_pallas=False)``'s ``(valid, decided)`` on the same
  ``encode_batch`` table, in both layouts;
- the corpus as a deployment (its 26 groups as the endpoints of one
  registry, requests drawn as ``chip_smoke.py`` phase 13 draws them, at
  B=256): the port's registry gives the JAX registry's ``Verdict``s and
  ``AdmitCounts``;
- the runner is the reference's ``scripts/conformance.py`` with the declared
  substitutions of ``ADAPTED["launch/conformance.py"]``, defaults to CUDA
  and writes its own summary file.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import compile_schema as ref_compile
from repro.core.batch_executor import BatchValidator as RefBatchValidator
from repro.core.tape import try_build_tape as ref_try_build
from repro.data.doc_table import encode_batch as ref_encode
from repro.registry import SchemaRegistry as RefRegistry
from repro.registry.linker import link_tapes as ref_link
from repro_torch.convert import table_from_reference
from repro_torch.core import compile_schema
from repro_torch.core.batch_executor import BatchValidator
from repro_torch.core.tape import try_build_tape
from repro_torch.launch import conformance as runner
from repro_torch.registry import SchemaRegistry, link_tapes

from test_conformance import CASES
from test_torch_batch_executor import _fields, _load_chip_smoke
from test_torch_registry import ROOT, _counts, _verdicts, adapted_source
from torch_suites import expose, load_adapted

# the adapted gate: test_corpus_all_engines_agree[csr|dense]
globals().update(expose(load_adapted("test_conformance_corpus.py", "cpu")))

_LAYOUTS = ["csr", "dense"]
_SMOKE = _load_chip_smoke()


def _corpus_cases():
    groups = _SMOKE.corpus_endpoints()
    return [(name, g["schema"], [t["data"] for t in g["tests"]]) for name, g in groups.items()]


_SOURCES = {
    "corpus": _corpus_cases(),
    "cases": [(name, schema, [doc for doc, _ in docs]) for name, schema, docs in CASES],
}


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("source", sorted(_SOURCES))
def test_batchable_cases_match_the_jax_executor(source, layout):
    """The batchable schemas' documents, encoded once by the JAX package's
    ``encode_batch`` at the runner's budgets, through both executors."""
    ref_tapes, tapes, docs, ids, names = [], [], [], [], []
    for name, schema, cases in _SOURCES[source]:
        ref_tape, ref_reason = ref_try_build(ref_compile(schema))
        tape, reason = try_build_tape(compile_schema(schema))
        assert (tape is None) == (ref_tape is None) and reason == ref_reason, name
        if tape is not None:
            docs += cases
            ids += [len(tapes)] * len(cases)
            names += [name] * len(cases)
            ref_tapes.append(ref_tape)
            tapes.append(tape)
    assert len(tapes) >= {"corpus": 10, "cases": 40}[source], len(tapes)
    table = ref_encode(docs, max_nodes=128, max_depth=16)
    ids = np.asarray(ids, np.int32)
    want = RefBatchValidator(ref_link(ref_tapes), use_pallas=False, layout=layout).validate(
        table, ids)
    got = BatchValidator(link_tapes(tapes), device="cpu", layout=layout).validate(
        table_from_reference(_fields(table)), ids)
    for what, g, w in zip(("valid", "decided"), got, want):
        w = np.asarray(w)
        bad = np.flatnonzero(g != w)
        assert not bad.size, f"{what} differs in {[names[i] for i in bad[:5]]}"
    assert got[1].any()


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_corpus_deployment_matches_the_jax_registry(layout):
    """The corpus's groups as 26 endpoints, B=256 requests: the port's CPU
    registry and the JAX registry admit them alike, with link groups,
    batched rows and sequential fallback rows all present."""
    groups = _SMOKE.corpus_endpoints()
    docs, endpoints, expected = _SMOKE.corpus_requests(groups, 256)
    port = SchemaRegistry(device="cpu", layout=layout)
    ref = RefRegistry(layout=layout)
    for reg in (port, ref):
        for name, group in groups.items():
            reg.register(name, group["schema"])
    got, counts = port.admit_mixed_ex(docs, endpoints, max_nodes=_SMOKE.MAX_NODES)
    want, rcounts = ref.admit_mixed_ex(docs, endpoints, max_nodes=_SMOKE.MAX_NODES)
    assert _verdicts(got) == _verdicts(want)
    assert _counts(counts) == _counts(rcounts)
    assert port.group_stats() == ref.group_stats()
    assert port.fallback_reasons() == ref.fallback_reasons()
    assert len(groups) == 26 and len(port.groups()) > 1
    assert counts.batch_validated > 0 and counts.fallback_validated > 0
    assert [v.valid for v in got] == expected


def test_runner_is_the_reference_with_declared_substitutions():
    assert (ROOT / "src" / "repro_torch" / "launch" / "conformance.py").read_text() == \
        adapted_source("launch/conformance.py")


def test_runner_defaults_to_cuda_and_writes_its_own_summary(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_corpus()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.main([])
    monkeypatch.setattr(runner, "RESULTS", tmp_path)
    assert runner.main(["--device", "cpu"]) == 0
    summary = json.loads((tmp_path / "conformance_summary_torch.json").read_text())
    assert summary["totals"]["batched"]["failed"] == 0 and not summary["failures"]
    assert [p.name for p in tmp_path.iterdir()] == ["conformance_summary_torch.json"]
    assert "batched      passed=" in capsys.readouterr().out
