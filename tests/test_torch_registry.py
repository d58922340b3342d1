"""The port's registry admission path against the JAX package's.

``SchemaRegistry`` and ``AdmissionController`` of the port (``device="cpu"``)
and of the reference give the same ``Verdict``s, ``AdmitCounts``,
``PipelineStats`` counters, group facts, fallback reasons, hot-swap
verdicts and launch-fault containment, in both executor layouts.  The two
adapted modules are pinned to the reference's source: the port's file must
equal the reference's text with exactly the declared substitutions.
"""

import random
import warnings
from pathlib import Path

import pytest
import torch

from repro.core import set_fault_hook as ref_set_fault_hook
from repro.core.outcomes import InjectedFault as RefInjectedFault
from repro.data.pipeline import AdmissionController as RefController
from repro.registry import SchemaRegistry as RefRegistry
from repro_torch.core import InjectedFault, set_fault_hook
from repro_torch.data.pipeline import AdmissionController
from repro_torch.registry import SchemaRegistry
from repro_torch.registry.presets import GATEWAY_SCHEMAS

from test_torch_batch_executor import _load_chip_smoke

ROOT = Path(__file__).resolve().parents[1]

_EXPLAIN_RAISES = (
    "        if explain:\n"
    "            # batched first-failure attribution is not ported yet: fail\n"
    "            # loudly instead of returning verdicts without their sites\n"
    '            raise NotImplementedError("explain_batch is not ported yet")\n'
)

# the only differences between the port's adapted modules and the
# reference's: ``use_pallas`` becomes ``device`` (cuda unless told
# otherwise), and batched explain raises instead of being dropped silently
ADAPTED = {
    "registry/registry.py": [
        ("from ..core.batch_executor import BatchValidator\n",
         "from ..core.batch_executor import BatchValidator, resolve_device\n"),
        ("        use_pallas: bool = False,\n", "        device=None,\n"),
        ("        self.use_pallas = use_pallas\n",
         "        # the batched executors' device: cuda unless told otherwise\n"
         "        self.device = resolve_device(device)\n"),
        ("                        use_pallas=self.use_pallas,\n",
         "                        device=self.device,\n"),
        ("                    use_pallas=self.use_pallas,\n",
         "                    device=self.device,\n"),
        ('        nothing -- the fast path is unchanged.\n        """\n',
         '        nothing -- the fast path is unchanged.\n        """\n' + _EXPLAIN_RAISES),
    ],
    "data/pipeline.py": [
        ("``use_pallas``/``layout``/``max_depth`` configure the",
         "``device``/``layout``/``max_depth`` configure the"),
        ("        use_pallas: bool = False,\n", "        device=None,\n"),
        ("                use_pallas=use_pallas, layout=layout, max_depth=max_depth\n",
         "                device=device, layout=layout, max_depth=max_depth\n"),
        ('        opts INVALID verdicts into first-failure attribution."""\n',
         '        opts INVALID verdicts into first-failure attribution."""\n'
         + _EXPLAIN_RAISES),
    ],
}


def adapt(text: str, subs) -> str:
    """The reference's ``text`` with each substitution applied exactly once."""
    for old, new in subs:
        assert text.count(old) == 1, f"substitution anchor not unique: {old!r}"
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("rel", sorted(ADAPTED))
def test_adapted_module_is_the_reference_with_declared_substitutions(rel):
    want = adapt((ROOT / "src" / "repro" / rel).read_text(), ADAPTED[rel])
    assert (ROOT / "src" / "repro_torch" / rel).read_text() == want


# ---------------------------------------------------------------------------
# the port's registry and admission controller against the reference's
# ---------------------------------------------------------------------------

_LAYOUTS = ["csr", "dense"]
# outside the batched subset: every request routes to the sequential engine
_LEGACY = {"type": "object", "patternProperties": {"^x": {"type": "integer"}}}


def _registries(layout: str, **kw):
    port = SchemaRegistry(device="cpu", layout=layout, **kw)
    ref = RefRegistry(layout=layout, **kw)
    for reg in (port, ref):
        for name, schema in GATEWAY_SCHEMAS.items():
            reg.register(name, schema)
        reg.register("legacy", _LEGACY)
    return port, ref


def _stream(n: int, seed: int):
    """The gateway mix plus legacy, oversize and guard-rejected requests."""
    docs, endpoints = _load_chip_smoke().mixed_stream(n, random.Random(seed))
    deep = []
    for _ in range(200):  # past the admission guard's depth limit
        deep = [deep]
    wide = {"prompt": "p", "stop": [f"s{i}" for i in range(40)]}  # past the node budget
    extra = [({"x1": 1}, "legacy"), ({"x1": "no"}, "legacy"), (wide, "complete"),
             (deep, "chat"), ({"input": "t", "dimensions": 64}, "embed")]
    for doc, endpoint in extra:
        docs.append(doc)
        endpoints.append(endpoint)
    return docs, endpoints


def _verdicts(vs):
    return [(v.outcome.name, v.valid, v.reason, v.engine, v.site) for v in vs]


def _counts(c):
    return {f: getattr(c, f) for f in c.__dataclass_fields__}


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_admission_controller_matches_the_reference(layout):
    port, ref = _registries(layout)
    docs, endpoints = _stream(96, seed=layout == "dense")
    ctrl = AdmissionController(registry=port, endpoint="complete", batch_max_nodes=32)
    rctrl = RefController(registry=ref, endpoint="complete", batch_max_nodes=32)
    got = ctrl.admit_ex(docs, endpoints)
    assert _verdicts(got) == _verdicts(rctrl.admit_ex(docs, endpoints))
    assert ctrl.stats.snapshot() == rctrl.stats.snapshot()
    snap = ctrl.stats.snapshot()
    for key in ("batch_validated", "fallback_validated", "oversize", "rejected_guard",
                "admitted", "rejected"):
        assert snap[key] > 0, key
    # the batched verdicts are the sequential engine's
    for doc, endpoint, v in zip(docs, endpoints, got):
        if v.engine == "batched":
            assert v.valid == port.get(endpoint).validator.is_valid(doc)
    assert ctrl.admit(docs[:8], endpoints[:8]) == rctrl.admit(docs[:8], endpoints[:8])


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_registry_state_and_hot_swap_match_the_reference(layout):
    port, ref = _registries(layout)
    docs, endpoints = _stream(48, seed=5)
    got, counts = port.admit_mixed_ex(docs, endpoints, max_nodes=64)
    want, rcounts = ref.admit_mixed_ex(docs, endpoints, max_nodes=64)
    assert _verdicts(got) == _verdicts(want)
    assert _counts(counts) == _counts(rcounts)
    assert port.group_stats() == ref.group_stats()
    assert port.fallback_reasons() == ref.fallback_reasons() and port.fallback_reasons()
    # hot-swaps: one proven to widen, one to narrow the accepted set
    embed = GATEWAY_SCHEMAS["embed"]
    wider = dict(embed, properties=dict(embed["properties"], dimensions={"type": "integer"}))
    narrower = dict(embed, required=sorted(set(embed.get("required", [])) | {"dimensions"}))
    for schema, warned in ((wider, ["WidenedSwapWarning"]), (narrower, [])):
        for reg in (port, ref):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                reg.register("embed", schema)
            assert [type(w.message).__name__ for w in caught] == warned
        assert port.swap_verdicts() == ref.swap_verdicts()
        got, counts = port.admit_mixed_ex(docs, endpoints, max_nodes=64)
        want, rcounts = ref.admit_mixed_ex(docs, endpoints, max_nodes=64)
        assert _verdicts(got) == _verdicts(want)
        assert _counts(counts) == _counts(rcounts)
        assert port.group_stats() == ref.group_stats()
    assert port.swap_verdicts() == {"embed": "narrowed"}


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_injected_launch_fault_matches_the_reference(layout):
    port, ref = _registries(layout)
    docs, endpoints = _stream(40, seed=9)
    victim = endpoints.index("charge")

    def hook(point, key):
        if point == "launch" and victim in key:
            raise RuntimeError(f"poisoned row {victim}")

    results = []
    for reg, set_hook in ((port, set_fault_hook), (ref, ref_set_fault_hook)):
        prev = set_hook(hook)
        try:
            results.append(reg.admit_mixed_ex(docs, endpoints, max_nodes=64))
        finally:
            set_hook(prev)
    (got, counts), (want, rcounts) = results
    assert _verdicts(got) == _verdicts(want)
    assert _counts(counts) == _counts(rcounts)
    assert got[victim].outcome.name == "ERROR_ISOLATED" and counts.error_isolated == 1
    assert port.group_fallbacks() == ref.group_fallbacks()
    assert port.group_stats() == ref.group_stats()


def test_explain_raises_before_any_work():
    port, _ = _registries("csr")
    ctrl = AdmissionController(registry=port, endpoint="complete")
    with pytest.raises(NotImplementedError, match="explain_batch is not ported yet"):
        port.admit_mixed_ex([{"prompt": "x"}], ["complete"], explain=True)
    with pytest.raises(NotImplementedError, match="explain_batch is not ported yet"):
        ctrl.admit_ex([{"prompt": "x"}], explain=True)
    assert ctrl.stats.snapshot()["seen"] == 0
    with pytest.raises(NotImplementedError, match="explain_batch is not ported yet"):
        port.groups()[0].validator.explain_batch(None)


def test_registry_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SchemaRegistry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdmissionController({"type": "integer"})
    ctrl = AdmissionController({"type": "integer"}, device="cpu", layout="dense")
    assert ctrl.batch_validator.device.type == "cpu" and ctrl.batch_validator.layout == "dense"
    assert ctrl.admit([1, "x"]) == [True, False]
