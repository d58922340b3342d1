"""The port's ``ServeEngine`` (``device="cpu"``) beside the JAX package's.

Both engines serve reduced granite-3-8b in float32 with the same
parameters (the JAX ``Model.init(PRNGKey(0))`` through
``convert.params_from_jax``) and the gateway's five endpoint schemas.
Results, outcomes, per-endpoint stats, SLO status, events and generated
token ids must be equal, including two behaviours of the reference that
the port reproduces on purpose (ROADMAP.md section 3):

- decode writes one position late: after prefill of L tokens the engine
  passes ``cache_len = L + len(generated)``, so the first decoded token
  sits at L+1 and cache row L stays zero, and the ids differ from teacher
  forcing;
- with ``batch_slots=1`` the prefill cache is never written into the batch
  cache (``_write_slot_cache`` writes only when the batch axis is > 1).

Also here: the CLIs and the serve launcher against the reference, the
CUDA default of every entry point, and the scheduler's ``"auto"`` cost
priors, which never read the JAX package's ``results/BENCH_registry.json``.
"""

import contextlib
import importlib
import io
import json
import random
from pathlib import Path

import jax
import pytest
import torch

from repro.analysis import report as ref_report
from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_launch
from repro.models import Model as RefModel
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.analysis import report
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch
from repro_torch.models import Model
from repro_torch.obs import EventLog, SLObjective
from repro_torch.registry.presets import GATEWAY_SCHEMAS
from repro_torch.serve import scheduler as port_scheduler
from repro_torch.serve.engine import ServeConfig, ServeEngine

from test_torch_batch_executor import _load_chip_smoke

# the analysis packages re-export a function named like this module
lint_tape = importlib.import_module("repro_torch.analysis.lint_tape")
ref_lint = importlib.import_module("repro.analysis.lint_tape")
ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", activation_dtype="float32")


@pytest.fixture(scope="module")
def bundle():
    cfg = get_config("granite-3-8b").reduced(**F32)
    rcfg = ref_get_config("granite-3-8b").reduced(**F32)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    return cfg, rcfg, params_from_jax(jax.device_get(rparams), device="cpu"), rparams


def _engines(bundle, **serve):
    cfg, rcfg, params, rparams = bundle
    serve = {"batch_slots": 2, "max_len": 64, "default_max_tokens": 4, **serve}
    port = ServeEngine(cfg, params, ServeConfig(**serve), endpoint_schemas=GATEWAY_SCHEMAS,
                       device="cpu")
    ref = RefServeEngine(rcfg, rparams, RefServeConfig(**serve),
                         endpoint_schemas=GATEWAY_SCHEMAS)
    return port, ref


def _burst(n=96, seed=0):
    """The gateway mix as (endpoint, request_json) pairs, plus guard rejects."""
    docs, endpoints = _load_chip_smoke().mixed_stream(n, random.Random(seed))
    rows = [(e, json.dumps(d)) for d, e in zip(docs, endpoints)]
    rows += [("complete", "{broken"), ("nosuch", "{}"), ("default", "[1, 2]"),
             ("complete", json.dumps({"prompt": "x" * (5 << 20)})),  # past the byte guard
             ("default", json.dumps({"prompt": "hi", "max_tokens": 2}))]
    return rows


def _results(results):
    return [(r.request_id, r.error, r.outcome.name) for r in results]


def _events(engine):
    return [{k: v for k, v in ev.items() if k not in ("ts", "latency_s", "stages")}
            for ev in engine.events.recent()]


def _snapshot(engine):
    snap = engine.stats.snapshot()
    snap.pop("validation_seconds")
    return snap


def test_submit_and_submit_batch_match_the_reference(bundle):
    port, ref = _engines(bundle)
    for engine in (port, ref):
        engine.attach_event_log(EventLog(capacity=512))
        for endpoint in engine.registry.endpoints():
            # far above any request's wall time, so both SLO views are exact
            engine.set_slo(endpoint, SLObjective(objective_s=10.0, target=0.99))
    rows = _burst()
    assert _results(port.submit_batch(rows)) == _results(ref.submit_batch(rows))
    singles = rows[:24] + rows[-5:] + [("default", json.dumps({"prompt": ""})),
                           ("default", json.dumps({"prompt": "ok", "extra": 1}))]
    got = [port.submit(body, endpoint) for endpoint, body in singles]
    want = [ref.submit(body, endpoint) for endpoint, body in singles]
    assert _results(got) == _results(want)
    outcomes = {r[2] for r in _results(got)}
    assert {"ADMITTED", "INVALID", "REJECTED_GUARD"} <= outcomes
    assert _snapshot(port) == _snapshot(ref)
    assert port.endpoint_stats() == ref.endpoint_stats()
    assert _events(port) == _events(ref) and len(_events(port)) == len(rows) + len(singles)
    assert [s.tokens for s in port.queue] == [s.tokens for s in ref.queue]


def _generated(engine, prompts, **submit):
    """Submit ``prompts``, drain, and return each admitted request's ids."""
    for prompt, max_tokens in prompts:
        rid, err = engine.submit(json.dumps({"prompt": prompt, "max_tokens": max_tokens}))
        assert rid is not None, err
    held = list(engine.queue)
    engine.run_until_drained(max_steps=256)
    return [s.generated for s in held]


PROMPTS = [("hello world", 6), ("a much longer prompt than the first one", 3),
           ("hi", 8), ("the quick brown fox jumps", 5), ("z", 1)]


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_run_until_drained_gives_the_reference_ids(bundle, slots):
    port, ref = _engines(bundle, batch_slots=slots)
    got = _generated(port, PROMPTS)
    assert got == _generated(ref, PROMPTS)
    # prefill gives the first token and the first decode step the second,
    # before the engine compares with max_tokens
    assert [len(g) for g in got] == [max(n, 2) for _, n in PROMPTS]
    assert port.results == ref.results
    assert port.stats.decode_steps == ref.stats.decode_steps


def _teacher_forced(model, params, tokens, n):
    seq = list(tokens)
    for _ in range(n):
        logits = model.logits_train(params, torch.tensor([seq], dtype=torch.int32))
        seq.append(int(torch.argmax(logits[0, -1])))
    return seq[len(tokens):]


def test_decode_position_one_late_is_the_references(bundle):
    """Pinned reference behaviour: the engine's ids differ from teacher
    forcing, exactly as the JAX engine's do; decoding at the right index
    gives the teacher-forced ids."""
    cfg, rcfg, params, rparams = bundle
    port, ref = _engines(bundle, batch_slots=2)
    (got,) = _generated(port, [("hello world", 4)])
    (want,) = _generated(ref, [("hello world", 4)])
    assert got == want == [375, 408, 239, 299]
    prompt = [256] + list(b"hello world")
    teacher = _teacher_forced(Model(cfg), params, prompt, 4)
    assert teacher == [375, 103, 408, 92] != got
    # decode_step at index L + len(generated) - 1 reproduces teacher forcing
    model = Model(cfg)
    logits, cache = model.prefill(params, torch.tensor([prompt], dtype=torch.int32), max_len=64)
    ids = [int(torch.argmax(logits[0, -1]))]
    for _ in range(3):
        tok = torch.tensor([[ids[-1]]], dtype=torch.int32)
        logits, cache = model.decode_step(params, tok, cache, len(prompt) + len(ids) - 1)
        ids.append(int(torch.argmax(logits[0, -1])))
    assert ids == teacher


def test_one_slot_drops_the_prefill_cache_as_the_reference(bundle):
    """Pinned reference behaviour: with ``batch_slots=1`` the batch cache
    stays zero after prefill, so the ids differ from two slots'."""
    port, ref = _engines(bundle, batch_slots=1)
    (got,) = _generated(port, [("hello world", 4)])
    (want,) = _generated(ref, [("hello world", 4)])
    assert got == want == [375, 455, 24, 363]
    # the cache holds only what decode wrote: row L (= 12) and everything
    # before it are zero
    k = port._cache["layer0"]["k"]
    assert not k[:, :, :13].any() and k[:, :, 13:17].any()


def test_entry_points_default_to_cuda_and_raise_without_it(bundle, monkeypatch):
    cfg, _, params, _ = bundle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)
    monkeypatch.setattr("sys.argv", ["serve"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lint_tape.main(["--presets"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        report.main(["--out", "unused.json"])


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue()


def test_serve_launcher_matches_the_reference(monkeypatch):
    lines = []
    for main, argv in ((launch.main, ["--device", "cpu"]), (ref_launch.main, [])):
        monkeypatch.setattr("sys.argv", ["serve", "--requests", "6", "--max-tokens", "3", *argv])
        _, out = _stdout(main)
        lines.append([ln for ln in out.splitlines() if "submit" in ln])
    assert lines[0] == lines[1] and len(lines[0]) == 6
    assert sum("REJECTED" in ln for ln in lines[0]) == 1


def test_lint_cli_matches_the_reference():
    rc, out = _stdout(lint_tape.main, ["--presets", "--device", "cpu"])
    rrc, rout = _stdout(ref_lint.main, ["--presets"])
    assert rc == rrc == 0 and out == rout and "clean" in out


def test_report_cli_matches_the_reference(tmp_path):
    got, want = report.build_report(device="cpu"), ref_report.build_report()

    def timeless(tree):
        tree = json.loads(json.dumps(tree))
        for per in tree["endpoints"].values():
            per.pop("analysis_seconds")
        tree["totals"].pop("analysis_seconds")
        return tree

    assert timeless(got) == timeless(want) and not got["lint_failures"]
    out = tmp_path / "report.json"
    rc, text = _stdout(report.main, ["--out", str(out), "--device", "cpu"])
    assert rc == 0 and "5 endpoints" in text
    assert timeless(json.loads(out.read_text())) == timeless(want)


def test_auto_priors_never_read_the_jax_results(bundle, monkeypatch):
    cfg, _, params, _ = bundle
    read, original = [], port_scheduler.seed_priors_from_bench

    def seed(path):
        read.append(Path(path))
        return original(path)

    monkeypatch.setattr(port_scheduler, "seed_priors_from_bench", seed)
    engine = ServeEngine(cfg, params, device="cpu")
    sched = engine.scheduler(profile_every=0)  # bench_priors="auto"
    assert read == [ROOT / "results" / "BENCH_registry_torch.json"]
    assert not read[0].exists() and (ROOT / "results" / "BENCH_registry.json").exists()
    defaults = port_scheduler.SchedulerConfig()
    assert sched.cost.batched_us("g", 4) == defaults.launch_fixed_us + 4 * defaults.launch_us_per_doc
    assert sched.cost.sequential_us("g", 4) == 4 * defaults.seq_us_per_doc
