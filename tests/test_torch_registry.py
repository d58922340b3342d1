"""The port's registry admission path against the JAX package's.

``SchemaRegistry`` and ``AdmissionController`` of the port (``device="cpu"``)
and of the reference give the same ``Verdict``s, ``AdmitCounts``,
``PipelineStats`` counters, group facts, fallback reasons, hot-swap
verdicts and launch-fault containment, in both executor layouts.  Every
adapted module of the port (``ADAPTED``) is pinned to the reference's
source: the port's file must equal the reference's text with exactly the
declared substitutions.
"""

import dataclasses
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

# each adapted module's only differences from the reference's text.  The
# registry and the pipeline: ``use_pallas`` becomes ``device`` (cuda unless
# told otherwise)
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
    ],
    "data/pipeline.py": [
        ("``use_pallas``/``layout``/``max_depth`` configure the",
         "``device``/``layout``/``max_depth`` configure the"),
        ("        use_pallas: bool = False,\n", "        device=None,\n"),
        ("                use_pallas=use_pallas, layout=layout, max_depth=max_depth\n",
         "                device=device, layout=layout, max_depth=max_depth\n"),
        # the training pipeline's admission device
        ("    admission_batch: int = 64\n\n    def __post_init__(self):\n"
         "        self.admission = AdmissionController(self.schema)\n",
         "    admission_batch: int = 64\n"
         "    device: Any = None  # admission's device: cuda unless told otherwise\n\n"
         "    def __post_init__(self):\n"
         "        self.admission = AdmissionController(self.schema, device=self.device)\n"),
    ],
    # the two registry CLIs: the registry's device is an argument
    "analysis/lint_tape.py": [
        ("    python -m repro.analysis.lint_tape --presets   # registry presets + linked group tapes\n",
         "    python -m repro_torch.analysis.lint_tape --presets [--device cpu]"
         "   # registry presets + linked group tapes\n"),
        ("def _lint_presets(verbose: bool = True) -> int:\n",
         "def _lint_presets(verbose: bool = True, device=None) -> int:\n"),
        ('    lint each; returns a process exit code."""\n',
         "    lint each (the registry on ``device``: cuda unless told otherwise);\n"
         '    returns a process exit code."""\n'),
        ("    reg = SchemaRegistry()\n", "    reg = SchemaRegistry(device=device)\n"),
        ('prog="repro.analysis.lint_tape"', 'prog="repro_torch.analysis.lint_tape"'),
        ('    ap.add_argument("-q", "--quiet", action="store_true", help="only print failures")\n',
         '    ap.add_argument("-q", "--quiet", action="store_true", help="only print failures")\n'
         '    ap.add_argument("--device", default="cuda", help="the registry\'s device: cuda or cpu")\n'),
        ("    rc = _lint_presets(verbose=not args.quiet)\n",
         "    rc = _lint_presets(verbose=not args.quiet, device=args.device)\n"),
    ],
    # and the report writes its own file, never the JAX package's
    "analysis/report.py": [
        ("CI archives the output as ``results/analysis_report.json`` and\n"
         "``scripts/perf_report.py`` folds it into the trajectory report.\n",
         "By default it writes ``results/analysis_report_torch.json``, beside\n"
         "the JAX package's ``results/analysis_report.json``, which it never\n"
         "overwrites.\n"),
        ("    python -m repro.analysis.report [--out results/analysis_report.json]\n",
         "    python -m repro_torch.analysis.report [--out results/analysis_report_torch.json]"
         " [--device cpu]\n"),
        ('def build_report() -> Dict[str, Any]:\n'
         '    """Assemble the posture tree over the registry presets."""\n',
         'def build_report(device=None) -> Dict[str, Any]:\n'
         '    """Assemble the posture tree over the registry presets (the registry\n'
         '    on ``device``: cuda unless told otherwise)."""\n'),
        ("    reg = SchemaRegistry()\n", "    reg = SchemaRegistry(device=device)\n"),
        ('prog="repro.analysis.report"', 'prog="repro_torch.analysis.report"'),
        ('        default="results/analysis_report.json",\n'
         '        help="output path (default: results/analysis_report.json)",\n'
         "    )\n",
         '        default="results/analysis_report_torch.json",\n'
         '        help="output path (default: results/analysis_report_torch.json)",\n'
         "    )\n"
         '    ap.add_argument("--device", default="cuda", help="the registry\'s device: cuda or cpu")\n'),
        ("    report = build_report()\n", "    report = build_report(device=args.device)\n"),
    ],
    # dtypes are torch dtypes
    "models/config.py": [
        ("import jax.numpy as jnp\n", "import torch\n"),
        ("    def dtype(self) -> jnp.dtype:\n        return jnp.dtype(self.activation_dtype)\n",
         "    def dtype(self) -> torch.dtype:\n        return getattr(torch, self.activation_dtype)\n"),
        ("    def pdtype(self) -> jnp.dtype:\n        return jnp.dtype(self.param_dtype)\n",
         "    def pdtype(self) -> torch.dtype:\n        return getattr(torch, self.param_dtype)\n"),
    ],
    # the engine: a device (cuda unless told otherwise) for the registry and
    # every tensor, the eager decode step, torch in place of jnp; the
    # verdicts, results, stats and the decode position are the reference's
    "serve/engine.py": [
        ("import jax\nimport jax.numpy as jnp\nimport numpy as np\n",
         "import numpy as np\nimport torch\n"),
        ("from ..core.outcomes import ValidationOutcome\n",
         "from ..core.batch_executor import resolve_device\n"
         "from ..core.outcomes import ValidationOutcome\n"),
        ("        slo: Optional[SLObjective] = None,\n    ):\n        self.cfg = cfg\n",
         "        slo: Optional[SLObjective] = None,\n        device=None,\n    ):\n"
         "        self.cfg = cfg\n"
         "        # the LM's and the registry's device: cuda unless told otherwise\n"
         "        self.device = resolve_device(device)\n"),
        ("registry if registry is not None else SchemaRegistry()\n",
         "registry if registry is not None else SchemaRegistry(device=self.device)\n"),
        ("        self._decode = jax.jit(self.model.decode_step)\n",
         "        self._decode = self.model.decode_step  # eager: one launch per op\n"),
        ("                    jnp.asarray([slot.tokens], jnp.int32),\n",
         "                    torch.as_tensor([slot.tokens], dtype=torch.int32, device=self.device),\n"),
        ("                next_tok = int(jnp.argmax(logits[0, -1]))\n",
         "                next_tok = int(torch.argmax(logits[0, -1]))\n"),
        ("                        self.scfg.batch_slots, self.scfg.max_len\n",
         "                        self.scfg.batch_slots, self.scfg.max_len, device=self.device\n"),
        ("            self.params, jnp.asarray(tokens), self._cache, jnp.int32(max_len_now)\n",
         "            self.params, torch.as_tensor(tokens, device=self.device), self._cache,\n"
         "            max_len_now,\n"),
        ("            nxt = int(jnp.argmax(logits[i, 0]))\n",
         "            nxt = int(torch.argmax(logits[i, 0]))\n"),
        ('    """Copy a prefilled single-request cache into batch slot ``slot_idx``."""\n'
         "\n"
         "    def write(dst, src):\n"
         "        if dst.ndim >= 2 and src.shape[0] == dst.shape[0]:  # (periods, B, ...)\n"
         "            if src.shape[1] == 1 and dst.shape[1] > 1:\n"
         "                return dst.at[:, slot_idx].set(src[:, 0].astype(dst.dtype))\n"
         "        return dst\n"
         "\n"
         "    return jax.tree.map(write, batch_cache, slot_cache)\n",
         '    """Copy a prefilled single-request cache into batch slot ``slot_idx``\n'
         '    (in place)."""\n'
         "    for name, dst in batch_cache.items():\n"
         "        src = slot_cache[name]\n"
         "        if isinstance(dst, dict):\n"
         "            _write_slot_cache(dst, src, slot_idx)\n"
         "        elif dst.ndim >= 2 and src.shape[0] == dst.shape[0]:  # (periods, B, ...)\n"
         "            if src.shape[1] == 1 and dst.shape[1] > 1:\n"
         "                dst[:, slot_idx] = src[:, 0].to(dst.dtype)\n"
         "    return batch_cache\n"),
    ],
    # "auto" cost priors come from the port's own measurements (a file
    # nothing writes yet), never from the JAX package's
    "serve/scheduler.py": [
        ('    # "auto" = seed priors from results/BENCH_registry.json when present;\n',
         '    # "auto" = seed priors from results/BENCH_registry_torch.json (the\n'
         "    # port's own measurements, never the JAX package's) when present;\n"),
        ('                    / "BENCH_registry.json"\n',
         '                    / "BENCH_registry_torch.json"\n'),
    ],
    # the serve launcher: a --device (cuda unless told otherwise) and a seeded
    # torch.Generator on it
    "launch/serve.py": [
        ('"""Serving driver: ``python -m repro.launch.serve --arch <id>``.\n',
         '"""Serve launcher: ``python -m repro_torch.launch.serve --arch <id> [--device cpu]``.\n'),
        ('    ap.add_argument("--max-tokens", type=int, default=8)\n',
         '    ap.add_argument("--max-tokens", type=int, default=8)\n'
         '    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")\n'),
        ("    import jax\n\n    from ..configs import get_config\n",
         "    import torch\n\n    from ..configs import get_config\n"
         "    from ..core.batch_executor import resolve_device\n"),
        ("    params = model.init(jax.random.PRNGKey(0))\n",
         "    device = resolve_device(args.device)\n"
         "    params = model.init(torch.Generator(device).manual_seed(0))\n"),
        ("        ServeConfig(batch_slots=4, max_len=128, default_max_tokens=args.max_tokens),\n",
         "        ServeConfig(batch_slots=4, max_len=128, default_max_tokens=args.max_tokens),\n"
         "        device=device,\n"),
    ],
    # the training slice: the supervisor without its unused jax import; the
    # driver with a --device (cuda unless told otherwise) for its host mesh,
    # the port's device_put, a seeded torch.Generator, tensors on the device
    # and its own checkpoint directory, never the JAX package's
    "train/supervisor.py": [("import jax\n", "")],
    "launch/train.py": [
        ('"""Production training driver: ``python -m repro.launch.train --arch <id>``.\n',
         '"""Training driver: ``python -m repro_torch.launch.train --arch <id> [--device cpu]``.\n'),
        ('On this CPU container it runs reduced configs end-to-end; on a fleet the\n'
         'same driver runs the full configs (the mesh and step are identical to what\n'
         'the dry-run compiles).\n',
         'It trains on a mesh of one device (``make_host_mesh``), the card unless\n'
         '``--device cpu`` is given: reduced configs by default, the published\n'
         'widths with ``--full``.\n'),
        ('import json\n',
         'import json\n'
         'import tempfile\n'),
        ('import jax\n'
         'import jax.numpy as jnp\n'
         'import numpy as np\n',
         'import numpy as np\n'),
        ('def main() -> None:\n',
         'def main(argv=None) -> None:\n'),
        ('    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")\n',
         '    ap.add_argument("--ckpt-dir",\n'
         '                    default=str(Path(tempfile.gettempdir()) / "repro_torch_ckpt"))\n'),
        ('    args = ap.parse_args()\n',
         '    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")\n'
         '    args = ap.parse_args(argv)\n'),
        ('    from ..configs import get_config\n',
         '    import torch\n'
         '\n'
         '    from ..configs import get_config\n'
         '    from ..core.batch_executor import resolve_device\n'),
        ('    from ..models import Model\n',
         '    from ..models import Model\n'
         '    from ..sharding.rules import device_put\n'),
        ('    mesh = make_host_mesh()\n',
         '    device = resolve_device(args.device)\n'
         '    mesh = make_host_mesh(device)\n'),
        ('    params = jax.device_put(model.init(jax.random.PRNGKey(0)), psh)\n'
         '    opt_state = jax.device_put(opt.init(ocfg, params), osh)\n',
         '    params = device_put(model.init(torch.Generator(device).manual_seed(0)), psh)\n'
         '    opt_state = device_put(opt.init(ocfg, params), osh)\n'),
        ('    pipe = ShardedPipeline(schema, records, seq_len=args.seq_len, batch_size=args.batch)\n',
         '    pipe = ShardedPipeline(schema, records, seq_len=args.seq_len, batch_size=args.batch,\n'
         '                           device=device)\n'),
        ('            prefix = jnp.zeros((args.batch, cfg.prefix_len, cfg.d_model), cfg.dtype())\n',
         '            prefix = torch.zeros((args.batch, cfg.prefix_len, cfg.d_model),\n'
         '                                 dtype=cfg.dtype(), device=device)\n'),
        ('        data = {"tokens": jnp.asarray(b["tokens"] % cfg.vocab_size),\n'
         '                "labels": jnp.asarray(b["labels"] % cfg.vocab_size)}\n',
         '        data = {"tokens": torch.as_tensor(b["tokens"] % cfg.vocab_size, device=device),\n'
         '                "labels": torch.as_tensor(b["labels"] % cfg.vocab_size, device=device)}\n'),
        ('    mgr = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep=2)\n',
         '    mgr = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep=2, device=device)\n'),
        ('    params, opt_state, hist = sup.run(\n'
         '        params, opt_state, itertools.cycle(pipe.batches()),\n',
         '    # main keeps no reference to the first state: the call moves the popped\n'
         '    # trees into run\'s frame (CPython 3.11+), which rebinds them after the\n'
         '    # first step, so with donate=False they are freed then and not held for\n'
         '    # the whole run (30.6 GB at rwkv6-3b\'s full width)\n'
         '    first = {"params": params, "opt_state": opt_state}\n'
         '    del params, opt_state\n'
         '    params, opt_state, hist = sup.run(\n'
         '        first.pop("params"), first.pop("opt_state"), itertools.cycle(pipe.batches()),\n'),
    ],
    # the conformance runner (a copy of scripts/conformance.py): the
    # batched engine on a device (cuda unless told otherwise) and in a
    # layout, its own summary file, never the JAX package's
    "launch/conformance.py": [
        ("Writes a pass/fail summary to ``results/conformance_summary.json`` (the\n"
         "CI artifact) and exits non-zero if any engine disagrees with a corpus\n"
         "expectation.\n",
         "Writes a pass/fail summary to ``results/conformance_summary_torch.json``\n"
         "(never the JAX package's ``results/conformance_summary.json``) and exits\n"
         "non-zero if any engine disagrees with a corpus expectation.  The batched\n"
         "engine runs on ``--device`` (cuda unless told otherwise):\n"
         "\n"
         "    python -m repro_torch.launch.conformance --device cpu|cuda\n"),
        ("import json\nimport sys\n", "import argparse\nimport json\nimport sys\n"),
        ("ROOT = Path(__file__).resolve().parents[1]\n",
         "ROOT = Path(__file__).resolve().parents[3]  # src/repro_torch/launch/ -> the repo\n"),
        ("from repro.core.batch_executor import BatchValidator  # noqa: E402\n",
         "from repro_torch.core.batch_executor import BatchValidator, resolve_device  # noqa: E402\n"),
        ("from repro.", "from repro_torch.", 3),
        ("def run_corpus() -> dict:\n",
         'def run_corpus(device=None, layout="csr") -> dict:\n'
         '    """Every corpus case through the four engines, the batched one on\n'
         "    ``device`` (cuda unless told otherwise: without CUDA it raises) in\n"
         '    ``layout``."""\n'
         "    device = resolve_device(device)\n"),
        ("BatchValidator(tape, use_pallas=False) if tape is not None else None",
         "BatchValidator(tape, device=device, layout=layout) if tape is not None else None"),
        ("def main() -> int:\n    summary = run_corpus()\n",
         "def main(argv=None) -> int:\n"
         '    ap = argparse.ArgumentParser(prog="repro_torch.launch.conformance")\n'
         '    ap.add_argument("--device", default="cuda", help="the batched engine\'s device: cuda or cpu")\n'
         "    args = ap.parse_args(argv)\n"
         "    summary = run_corpus(device=args.device)\n"),
        ('out = RESULTS / "conformance_summary.json"', 'out = RESULTS / "conformance_summary_torch.json"'),
    ],
}


# an adapted module's reference where it is not the same path in src/repro
REFERENCE = {"launch/conformance.py": "scripts/conformance.py"}


def adapt(text: str, subs) -> str:
    """The reference's ``text`` with each ``(old, new[, count])`` substitution
    applied, where ``old`` occurs exactly ``count`` times (once by default)."""
    for old, new, *count in subs:
        want = count[0] if count else 1
        assert text.count(old) == want, f"substitution anchor {old!r}: {text.count(old)} times"
        text = text.replace(old, new)
    return text


def adapted_source(rel: str) -> str:
    """The reference's text of the port's module ``rel``, adapted."""
    return adapt((ROOT / REFERENCE.get(rel, f"src/repro/{rel}")).read_text(), ADAPTED[rel])


# the conformance runner's pin is tested in test_torch_conformance.py
@pytest.mark.parametrize("rel", sorted(set(ADAPTED) - set(REFERENCE)))
def test_adapted_module_is_the_reference_with_declared_substitutions(rel):
    assert (ROOT / "src" / "repro_torch" / rel).read_text() == adapted_source(rel)


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
    """Verdicts as plain tuples (the two packages' ``FailureSite`` classes
    differ, their fields must not)."""
    return [(v.outcome.name, v.valid, v.reason, v.engine,
             None if v.site is None else dataclasses.astuple(v.site)) for v in vs]


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


def test_dense_explain_raises_and_the_registry_gives_empty_sites():
    """As the reference: ``explain_batch`` needs the csr layout, and the
    registry's best-effort attribution turns that error into empty sites,
    so dense INVALID verdicts carry no site and are otherwise unchanged."""
    from repro.data.doc_table import encode_batch as ref_encode
    from repro_torch.data.doc_table import encode_batch

    port, ref = _registries("dense")
    group = port.groups()[0]
    ids = [0, 0]
    with pytest.raises(NotImplementedError, match="explain_batch requires the csr layout"):
        group.validator.explain_batch(encode_batch([{}, {}], max_nodes=8), ids)
    with pytest.raises(NotImplementedError, match="explain_batch requires the csr layout"):
        ref.groups()[0].validator.explain_batch(ref_encode([{}, {}], max_nodes=8), ids)
    docs, endpoints = _stream(48, seed=3)
    got, counts = port.admit_mixed_ex(docs, endpoints, max_nodes=64, explain=True)
    want, rcounts = ref.admit_mixed_ex(docs, endpoints, max_nodes=64, explain=True)
    assert _verdicts(got) == _verdicts(want)
    assert _counts(counts) == _counts(rcounts)
    plain, _ = port.admit_mixed_ex(docs, endpoints, max_nodes=64)
    batched_invalid = [v for v in got if v.engine == "batched" and v.outcome.name == "INVALID"]
    assert batched_invalid and all(v.site is None for v in batched_invalid)
    batched = [i for i, v in enumerate(got) if v.engine == "batched"]
    assert [_verdicts(got)[i] for i in batched] == [_verdicts(plain)[i] for i in batched]
    ctrl = AdmissionController(registry=port, endpoint="complete", batch_max_nodes=64)
    rctrl = RefController(registry=ref, endpoint="complete", batch_max_nodes=64)
    assert _verdicts(ctrl.admit_ex(docs, endpoints, explain=True)) == _verdicts(
        rctrl.admit_ex(docs, endpoints, explain=True))


def test_registry_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SchemaRegistry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdmissionController({"type": "integer"})
    ctrl = AdmissionController({"type": "integer"}, device="cpu", layout="dense")
    assert ctrl.batch_validator.device.type == "cpu" and ctrl.batch_validator.layout == "dense"
    assert ctrl.admit([1, "x"]) == [True, False]
