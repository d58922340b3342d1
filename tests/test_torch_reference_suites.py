"""The JAX package's own serve, scheduler, fault-containment, event/SLO,
batched-explain, observability, corpus and training fault-tolerance
suites, run against the port.

Each suite is the reference test file's text with declared substitutions:
imports from ``repro_torch`` instead of ``repro``, ``device="cpu"`` where
the reference builds a registry or an engine, and LM parameters from the
port's ``Model.init`` with a seeded ``torch.Generator`` instead of a JAX
key.  Everything else -- requests, fault plans, assertions -- is the
reference's, so the suites follow the reference when it changes.  The
selected classes, functions and fixtures are collected from here; the
helpers that adapt and load a suite are in ``torch_suites.py``.
"""

from torch_suites import GENERATOR as _GENERATOR
from torch_suites import IMPORTS as _IMPORTS
from torch_suites import load_suite

SUITES = {
    "test_pipeline_serve.py": [
        (*_IMPORTS, 4),
        ("import jax\n", "import jax\nimport torch\n", 1),
        (*_GENERATOR, 2),
        ("default_max_tokens=4))", 'default_max_tokens=4), device="cpu")', 2),
        ("AdmissionController(RECORD_SCHEMA)", 'AdmissionController(RECORD_SCHEMA, device="cpu")', 2),
        ("AdmissionController(schema)", 'AdmissionController(schema, device="cpu")', 1),
        # the four ShardedPipeline calls
        ("batch_size=2", 'batch_size=2, device="cpu"', 4),
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
    "test_corpus.py": [
        (*_IMPORTS, 2),
    ],
    # the drills: the port's mesh train step on a CPU host mesh in place of
    # value_and_grad + update, managers that restore onto the CPU, torch
    # tensors and leaves; the elastic restore onto the port's mesh, with the
    # port's NamedSharding
    "test_fault_tolerance.py": [
        (*_IMPORTS, 5),
        ("import jax\nimport jax.numpy as jnp\n",
         "import torch\n\nfrom repro_torch.launch.mesh import make_host_mesh, make_mesh\n"
         "from repro_torch.train import tree as tree_util\n"
         "from repro_torch.train.train_step import make_train_step\n", 1),
        (*_GENERATOR, 1),
        ("    def step_fn(p, s, batch):\n"
         "        def loss_fn(pp):\n"
         '            return model.loss(pp, batch["tokens"], batch["labels"], remat=False)\n'
         "\n"
         "        loss, grads = jax.value_and_grad(loss_fn)(p)\n"
         "        new_p, new_s, m = opt.update(ocfg, grads, s, p)\n"
         "        return new_p, new_s, dict(m, loss=loss)\n",
         '    step_fn, _, _ = make_train_step(model, ocfg, make_host_mesh("cpu"), batch=2,\n'
         "                                    donate=False, remat=False)\n", 1),
        ("jnp.asarray(t)", "torch.from_numpy(t)", 2),
        ("np.testing.assert_array_equal(np.asarray(a), np.asarray(b))",
         "assert torch.equal(a, b)", 1),
        ("CheckpointManager(tmp_path, ", 'CheckpointManager(tmp_path, device="cpu", ', 9),
        ('jnp.float32(float("nan"))', 'torch.tensor(float("nan"))', 1),
        ("from jax.sharding import NamedSharding, PartitionSpec as P\n",
         "from repro_torch.sharding.rules import NamedSharding, PartitionSpec as P\n", 1),
        ("jax.make_mesh((1, 1), (\"data\", \"model\"))",
         "make_mesh((1, 1), (\"data\", \"model\"), device=\"cpu\")", 1),
        ("jax.tree.map(", "tree_util.tree_map(", 1),
        ('        assert leaf.sharding.mesh.shape == {"data": 1, "model": 1}\n',
         '        assert leaf.device_mesh.shape == (1, 1)\n'
         '        assert leaf.device_mesh.mesh_dim_names == ("data", "model")\n', 1),
        ("jax.tree.leaves(", "tree_util.leaves(", 3),
    ],
}

_serve = load_suite("test_pipeline_serve.py", SUITES["test_pipeline_serve.py"])
_sched = load_suite("test_scheduler.py", SUITES["test_scheduler.py"])
_fault = load_suite("test_fault_containment.py", SUITES["test_fault_containment.py"])
_events = load_suite("test_profile.py", SUITES["test_profile.py"])
_explain = load_suite("test_batched_explain.py", SUITES["test_batched_explain.py"])
_obs = load_suite("test_observability.py", SUITES["test_observability.py"])
_corpus = load_suite("test_corpus.py", SUITES["test_corpus.py"])
_ft = load_suite("test_fault_tolerance.py", SUITES["test_fault_tolerance.py"])

# test_pipeline_serve.py: admission and the serving engine
TestAdmission = _serve.TestAdmission
TestServeEngine = _serve.TestServeEngine
TestMultiEndpointServe = _serve.TestMultiEndpointServe
TestShardedPipeline = _serve.TestShardedPipeline

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

# test_corpus.py: every test and its fixture (the corpus generator is a
# byte-identical copy; the validators are the port's)
small_corpus = _corpus.small_corpus
test_corpus_has_38_datasets = _corpus.test_corpus_has_38_datasets
test_documents_validate = _corpus.test_documents_validate
test_schema_sizes_track_table3 = _corpus.test_schema_sizes_track_table3
test_deterministic = _corpus.test_deterministic
test_dialects = _corpus.test_dialects
test_invalid_mutations_rejected = _corpus.test_invalid_mutations_rejected

# test_fault_tolerance.py: every class and their fixture (checkpoint/restart,
# NaN rollback, transient retry, stragglers, resume, loss going down)
setup = _ft.setup
TestCheckpoint = _ft.TestCheckpoint
TestSupervisor = _ft.TestSupervisor
TestTrainingProgress = _ft.TestTrainingProgress


def test_suites_import_only_the_port():
    """No adapted suite reaches into the JAX package's code."""
    for module in (_serve, _sched, _fault, _events, _explain, _obs, _corpus, _ft):
        for value in vars(module).values():
            owner = getattr(value, "__module__", "") or ""
            assert owner.split(".")[0] != "repro", (module.__name__, value)
