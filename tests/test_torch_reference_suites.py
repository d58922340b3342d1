"""The JAX package's own serve, scheduler, fault-containment, event/SLO,
batched-explain and observability suites, run against the port.

Each suite is the reference test file's text with declared substitutions:
imports from ``repro_torch`` instead of ``repro``, ``device="cpu"`` where
the reference builds a registry or an engine, and LM parameters from the
port's ``Model.init`` with a seeded ``torch.Generator`` instead of a JAX
key.  Everything else -- requests, fault plans, assertions -- is the
reference's, so the suites follow the reference when it changes.  The
selected classes, functions and fixtures are collected from here.
"""

import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent

_IMPORTS = ("from repro.", "from repro_torch.")
_GENERATOR = ("init(jax.random.PRNGKey(0))", "init(torch.Generator().manual_seed(0))")


def adapt_suite(text: str, subs) -> str:
    """``text`` with each ``(old, new, count)`` substitution applied, where
    ``old`` must occur exactly ``count`` times."""
    for old, new, count in subs:
        assert text.count(old) == count, f"{old!r}: {text.count(old)} occurrences, want {count}"
        text = text.replace(old, new)
    return text


def load_suite(name: str, subs) -> types.ModuleType:
    """The reference suite ``tests/<name>`` adapted to the port, as a module."""
    module_name = f"torch_suite_{Path(name).stem}"
    text = adapt_suite((TESTS / name).read_text(), subs)
    module = types.ModuleType(module_name)
    module.__file__ = str(TESTS / name)
    sys.modules[module_name] = module
    exec(compile(text, f"{name} (adapted to repro_torch)", "exec"), module.__dict__)
    return module


SUITES = {
    "test_pipeline_serve.py": [
        (*_IMPORTS, 4),
        ("import jax\n", "import jax\nimport torch\n", 1),
        (*_GENERATOR, 2),
        ("default_max_tokens=4))", 'default_max_tokens=4), device="cpu")', 2),
        ("AdmissionController(RECORD_SCHEMA)", 'AdmissionController(RECORD_SCHEMA, device="cpu")', 2),
        ("AdmissionController(schema)", 'AdmissionController(schema, device="cpu")', 1),
    ],
    "test_scheduler.py": [
        (*_IMPORTS, 8),
        ("import pytest\n", "import pytest\nimport torch\n", 1),
        (*_GENERATOR, 1),
        ("use_pallas=False", 'device="cpu"', 2),
        ("        registry=reg,\n    )\n", '        registry=reg,\n        device="cpu",\n    )\n', 1),
    ],
    "test_fault_containment.py": [
        (*_IMPORTS, 7),
        ("SchemaRegistry(", 'SchemaRegistry(device="cpu", ', 12),
        ("        import jax\n", "        import torch\n", 1),
        (*_GENERATOR, 1),
        ("default_max_tokens=4)\n", 'default_max_tokens=4), device="cpu"\n', 1),
    ],
    "test_profile.py": [
        (*_IMPORTS, 9),
        ("use_pallas=False", 'device="cpu"', 1),
        ("    import jax\n", "    import torch\n", 1),
        (*_GENERATOR, 1),
        ("        **kw,\n    )\n", '        device="cpu",\n        **kw,\n    )\n', 1),
    ],
    "test_batched_explain.py": [
        (*_IMPORTS, 7),
        ("use_pallas=False", 'device="cpu"', 7),
    ],
    "test_observability.py": [
        (*_IMPORTS, 9),
        ("    import jax\n", "    import torch\n", 1),
        (*_GENERATOR, 1),
        ("use_pallas=False", 'device="cpu"', 2),
        ("default_max_tokens=4)\n    )", 'default_max_tokens=4), device="cpu"\n    )', 1),
        ("AdmissionController(SCHEMA)", 'AdmissionController(SCHEMA, device="cpu")', 1),
    ],
}

_serve = load_suite("test_pipeline_serve.py", SUITES["test_pipeline_serve.py"])
_sched = load_suite("test_scheduler.py", SUITES["test_scheduler.py"])
_fault = load_suite("test_fault_containment.py", SUITES["test_fault_containment.py"])
_events = load_suite("test_profile.py", SUITES["test_profile.py"])
_explain = load_suite("test_batched_explain.py", SUITES["test_batched_explain.py"])
_obs = load_suite("test_observability.py", SUITES["test_observability.py"])

# test_pipeline_serve.py: admission and the serving engine
TestAdmission = _serve.TestAdmission
TestServeEngine = _serve.TestServeEngine
TestMultiEndpointServe = _serve.TestMultiEndpointServe

# test_scheduler.py: all five classes and their fixture
model_bundle = _sched.model_bundle
TestDrainTimingIndependence = _sched.TestDrainTimingIndependence
TestStreamVsBatchIdentity = _sched.TestStreamVsBatchIdentity
TestBreakerGroupIsolation = _sched.TestBreakerGroupIsolation
TestLatencyAccounting = _sched.TestLatencyAccounting
TestCostModel = _sched.TestCostModel

# test_fault_containment.py: registry containment, the engine's, the stress
registry = _fault.registry
TestPoisonIsolation = _fault.TestPoisonIsolation
TestGuardsAndReconciliation = _fault.TestGuardsAndReconciliation
TestBoundedFallback = _fault.TestBoundedFallback
TestCircuitBreaker = _fault.TestCircuitBreaker
TestHotSwap = _fault.TestHotSwap
TestServeEngineContainment = _fault.TestServeEngineContainment
test_randomized_poison_mix_stress = _fault.test_randomized_poison_mix_stress

# test_profile.py: the event log, the SLO math and the engine's surfaces of
# both (its profiler class tests the byte-identical obs/profile.py copy)
TestEventLog = _events.TestEventLog
TestSLO = _events.TestSLO
TestEngineIntegration = _events.TestEngineIntegration

# test_batched_explain.py: every class (differential attribution against the
# sequential Validator, the tie-breaks, instance pointers, the registry's
# explain plumbing)
TestDifferentialAttribution = _explain.TestDifferentialAttribution
TestTieBreak = _explain.TestTieBreak
TestNodePointer = _explain.TestNodePointer
TestRegistryExplainPlumbing = _explain.TestRegistryExplainPlumbing

# test_observability.py: the engine classes (stats reconciliation, explain=True
# included, and the serving metrics surface)
TestStatsReconciliation = _obs.TestStatsReconciliation
TestServingMetricsSurface = _obs.TestServingMetricsSurface


def test_suites_import_only_the_port():
    """No adapted suite reaches into the JAX package's code."""
    for module in (_serve, _sched, _fault, _events, _explain, _obs):
        for value in vars(module).values():
            owner = getattr(value, "__module__", "") or ""
            assert owner.split(".")[0] != "repro", (module.__name__, value)
