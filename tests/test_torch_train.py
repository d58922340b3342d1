"""The port's training path (``repro_torch.train``, ``Model.loss``'s
gradients, ``launch/train.py``) against the JAX package's.

Parameters come from the JAX initialisers through
``convert.params_from_jax`` (and Adam moments through
``convert.opt_state_from_jax``); tokens, gradients and moments from a numpy
seed.  Tolerances:

- gradients of the ten reduced architectures in float32: each leaf within
  1e-4 of that leaf's max |g| (the two packages sum in different orders);
- the optimizer in float32: 1e-6 relative to each leaf's max |value| (the
  same float32 formula; only a few roundings may differ); a bfloat16 leaf
  within one bfloat16 ulp of its max |value| (2^-7 of it), since a float32
  difference of an ulp can round the other way;
- three train steps: losses within 1e-5 relative.

Remat and donation change no arithmetic, so the port holds remat on against
remat off, and ``donate=True`` against ``donate=False``, bit for bit.  Those
comparisons run on one CPU thread: a parallel reduction's order follows the
number of threads that the OpenMP runtime hands out.
"""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import ShardedPipeline as RefPipeline
from repro.models import Model as RefModel
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.corpus import make_dataset
from repro_torch.data.pipeline import ShardedPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import Model
from repro_torch.train import optimizer as opt
from repro_torch.train import tree as tree_util
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.train_step import _make_device_step, make_train_step

from test_torch_model import _np

GRAD_REL = 1e-4
OPT_REL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
LOSS_REL = 1e-5
B, S = 2, 64
OCFG = dict(warmup_steps=2, total_steps=10)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _rel_close(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} * max |want| {scale}"


def _trees_close(got, want, rel):
    got_flat = tree_util.flatten_with_path(got)
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_flat) == len(want_flat)
    for (path, g), (_, w) in zip(got_flat, want_flat):
        _rel_close(g, w, rel, "/".join(map(str, path)))


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32", seed=0):
    """A reduced config of both packages, the JAX initialiser's parameters
    (also as torch tensors) and a batch from ``seed``; cached for the
    module, so no test may change what it returns in place."""
    kw = dict(param_dtype=dtype, activation_dtype=dtype)
    cfg, rcfg = get_config(arch).reduced(**kw), ref_get_config(arch).reduced(**kw)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(rparams), device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    prefix = (rng.normal(0, 1, (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
              if cfg.prefix_len else None)
    return cfg, rcfg, params, rparams, tokens, labels, prefix


def _torch_batch(tokens, labels, prefix):
    data = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    if prefix is not None:
        data["prefix"] = torch.from_numpy(prefix)
    return data


def _grads(model, params, data, remat):
    leaves = [t.detach().requires_grad_(True) for t in tree_util.leaves(params)]
    loss = model.loss(tree_util.unflatten(params, leaves), data["tokens"], data["labels"],
                      data.get("prefix"), remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_the_reference():
    for cfg in (opt.OptimizerConfig(), opt.OptimizerConfig(warmup_steps=3, total_steps=12),
                opt.OptimizerConfig(warmup_steps=0, total_steps=0)):
        rcfg = ref_opt.OptimizerConfig(**vars(cfg))
        # every step from 0 to total + 5 at once: the schedule is elementwise
        got = opt.schedule(cfg, torch.arange(cfg.total_steps + 6, dtype=torch.int32))
        want = ref_opt.schedule(rcfg, jnp.arange(cfg.total_steps + 6, dtype=jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert float(opt.schedule(cfg, 3)) == float(got[3])  # a plain int step


@pytest.mark.parametrize("name,decays", [
    ("w_up", True), ("embedding", True), ("scale", False), ("decay_bias", False),
    ("dt_bias", False), ("conv_b", False), ("bonus", False), ("shift_mix", False),
])
def test_decay_mask_matches_the_reference(name, decays):
    path = ("stack", "layer0", name)
    ref_path = tuple(jax.tree_util.DictKey(k) for k in path)
    assert opt._decay_mask(path) == ref_opt._decay_mask(ref_path) == decays
    # a sequence index or a NamedTuple field carries no key: it decays
    assert opt._decay_mask(("m", 0)) == ref_opt._decay_mask((jax.tree_util.SequenceKey(0),))


def _opt_inputs(dtype, state_dtype):
    """Reduced rwkv6 (every no-decay leaf name but Mamba's) and jamba
    (Mamba's) parameters, with gradients and moments from a numpy seed."""
    rng = np.random.default_rng(1)
    out = []
    for arch in ("rwkv6-3b", "jamba-1.5-large-398b"):
        cfg, rcfg, params, rparams, *_ = _setup(arch, dtype)
        host = jax.device_get(rparams)
        # a wide range of gradient scales, so that clipping engages
        grads = jax.tree.map(
            lambda p: (rng.normal(0, 1, p.shape) * 10.0 ** rng.integers(-4, 2)).astype(
                np.float32), host)
        m = jax.tree.map(lambda p: rng.normal(0, 0.1, p.shape).astype(np.float32), host)
        v = jax.tree.map(lambda p: rng.uniform(0, 0.1, p.shape).astype(np.float32), host)
        state = ref_opt.OptState(jnp.int32(2),
                                 jax.tree.map(lambda x: jnp.asarray(x, state_dtype), m),
                                 jax.tree.map(lambda x: jnp.asarray(x, state_dtype), v))
        out.append((params, rparams, grads, state))
    return out


@pytest.fixture(scope="module", params=[("float32", "float32"), ("bfloat16", "float32"),
                                        ("bfloat16", "bfloat16")], ids="-".join)
def update_case(request):
    """(dtype, state dtype, [(inputs, the reference's update of them)])."""
    dtype, state_dtype = request.param
    rcfg = ref_opt.OptimizerConfig(state_dtype=state_dtype, **OCFG)
    ref_update = jax.jit(ref_opt.update, static_argnums=0)
    cases = []
    for params, rparams, grads, rstate in _opt_inputs(dtype, state_dtype):
        rgrads = jax.tree.map(lambda g, p: jnp.asarray(g, p.dtype), grads, rparams)
        want = jax.device_get(ref_update(rcfg, rgrads, rstate, rparams))
        cases.append((params, jax.device_get(rgrads), jax.device_get(rstate), want))
    return dtype, state_dtype, cases


@pytest.mark.parametrize("inplace", [False, True])
def test_update_matches_the_reference(update_case, inplace):
    dtype, state_dtype, cases = update_case
    cfg = opt.OptimizerConfig(state_dtype=state_dtype, **OCFG)
    for params, rgrads, rstate, (want_p, want_s, want_m) in cases:
        params = tree_util.tree_map(torch.clone, params)
        state = opt_state_from_jax(rstate, device="cpu")
        got_p, got_s, got_m = opt.update(cfg, params_from_jax(rgrads, device="cpu"), state,
                                         params, inplace=inplace)
        assert int(got_s.step) == int(want_s.step) == 3
        assert got_s.step.dtype == torch.int32 and got_s.step.shape == ()
        # in place: the same tensors come back; else the given ones stay
        same = [a is b for a, b in zip(tree_util.leaves((got_p, got_s)),
                                       tree_util.leaves((params, state)))]
        assert all(same) if inplace else not any(same)
        _trees_close(got_p, want_p, OPT_REL[dtype])
        _trees_close(got_s.m, want_s.m, OPT_REL[state_dtype])
        _trees_close(got_s.v, want_s.v, OPT_REL[state_dtype])
        for leaf in tree_util.leaves((got_s.m, got_s.v)):
            assert leaf.dtype == getattr(torch, state_dtype)
        np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]), rtol=1e-6)
        # a float32 sum over every gradient element, in another order
        np.testing.assert_allclose(float(got_m["grad_norm"]), float(want_m["grad_norm"]),
                                   rtol=1e-5)
        assert float(want_m["grad_norm"]) > cfg.clip_norm  # clipping engaged


def test_global_norm_and_init_match_the_reference():
    _, _, params, rparams, *_ = _setup("rwkv6-3b")
    np.testing.assert_allclose(float(opt.global_norm(params)),
                               float(ref_opt.global_norm(rparams)), rtol=1e-6)
    for state_dtype in ("float32", "bfloat16"):
        state = opt.init(opt.OptimizerConfig(state_dtype=state_dtype), params)
        want = ref_opt.init(ref_opt.OptimizerConfig(state_dtype=state_dtype), rparams)
        assert state.step.dtype == torch.int32 and int(state.step) == int(want.step) == 0
        for got, ref in zip(tree_util.leaves(state.m), jax.tree.leaves(want.m)):
            assert tuple(got.shape) == ref.shape and str(got.dtype) == f"torch.{ref.dtype}"
            assert not got.any()


def test_update_works_through_large_leaves_a_slice_at_a_time(monkeypatch):
    cfg = opt.OptimizerConfig(**OCFG)
    _, _, params, _, *_ = _setup("granite-3-8b")
    grads = tree_util.tree_map(lambda p: torch.full_like(p, 0.01), params)
    state = opt.init(cfg, params)
    whole = opt.update(cfg, grads, state, params)
    monkeypatch.setattr(opt, "_SLICE", 1000)  # slices that end inside rows
    sliced = opt.update(cfg, grads, state, params)
    for a, b in zip(tree_util.leaves(whole[:2]), tree_util.leaves(sliced[:2])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the gradients of Model.loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    cfg, rcfg, params, rparams, tokens, labels, prefix = _setup(arch)
    rmodel = RefModel(rcfg)
    rprefix = None if prefix is None else jnp.asarray(prefix)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: rmodel.loss(p, jnp.asarray(tokens), jnp.asarray(labels), rprefix,
                              remat=False))(rparams)
    loss, grads = _grads(Model(cfg), params, _torch_batch(tokens, labels, prefix), remat=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_REL)
    _trees_close(tree_util.unflatten(params, list(grads)), want_grads, GRAD_REL)


@pytest.mark.parametrize("arch", ["granite-3-8b", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b", "rwkv6-3b", "musicgen-large"])
def test_remat_changes_no_bit(arch, one_thread):
    cfg, _, params, _, tokens, labels, prefix = _setup(arch)
    data = _torch_batch(tokens, labels, prefix)
    on_loss, on = _grads(Model(cfg), params, data, remat=True)
    off_loss, off = _grads(Model(cfg), params, data, remat=False)
    assert torch.equal(on_loss, off_loss)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _ref_step(rmodel, rcfg_opt):
    @jax.jit
    def step(p, s, tokens, labels):
        loss, grads = jax.value_and_grad(
            lambda pp: rmodel.loss(pp, tokens, labels, remat=False))(p)
        new_p, new_s, m = ref_opt.update(rcfg_opt, grads, s, p)
        return new_p, new_s, dict(m, loss=loss)

    return step


@pytest.mark.parametrize("arch", ["granite-3-8b", "rwkv6-3b", "moonshot-v1-16b-a3b"])
def test_three_train_steps_match_the_reference(arch):
    cfg, rcfg, params, rparams, *_ = _setup(arch)
    ocfg = opt.OptimizerConfig(state_dtype=cfg.optimizer_state_dtype, **OCFG)
    rocfg = ref_opt.OptimizerConfig(state_dtype=rcfg.optimizer_state_dtype, **OCFG)
    rstep = _ref_step(RefModel(rcfg), rocfg)
    step = _make_device_step(Model(cfg), ocfg, batch=B, device="cpu", donate=False)
    rstate = ref_opt.init(rocfg, rparams)
    state = opt.init(ocfg, params)
    for i in range(3):
        tokens = np.random.default_rng(10 + i).integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        rparams, rstate, want = rstep(rparams, rstate, jnp.asarray(tokens), jnp.asarray(tokens))
        params, state, got = step(params, state, {"tokens": tokens, "labels": tokens})
        for key in ("loss", "grad_norm", "lr"):
            assert got[key].shape == () and got[key].dtype == torch.float32
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_REL,
                                       err_msg=f"step {i} {key}")
    # and one more step from the reference's own parameters and moments
    tokens = np.random.default_rng(13).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    params = params_from_jax(jax.device_get(rparams), device="cpu")
    state = opt_state_from_jax(jax.device_get(rstate), device="cpu")
    assert int(state.step) == 3
    new_rparams, _, want = rstep(rparams, rstate, jnp.asarray(tokens), jnp.asarray(tokens))
    new_params, _, got = step(params, state, {"tokens": tokens, "labels": tokens})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_REL)
    _trees_close(new_params, new_rparams, 1e-5)


def test_donate_equals_no_donate(one_thread):
    cfg, _, params, _, tokens, labels, _ = _setup("rwkv6-3b")
    ocfg = opt.OptimizerConfig(**OCFG)
    copy = lambda tree: tree_util.tree_map(torch.clone, tree)
    data = {"tokens": tokens, "labels": labels}
    kept = _make_device_step(Model(cfg), ocfg, batch=B, device="cpu", donate=False)
    donated = _make_device_step(Model(cfg), ocfg, batch=B, device="cpu", donate=True)
    a_params, a_state = copy(params), opt.init(ocfg, params)
    b_params, b_state = copy(params), opt.init(ocfg, params)
    given = tree_util.leaves((b_params, b_state))
    kept_inputs, before = tree_util.leaves((a_params, a_state)), copy((a_params, a_state))
    for _ in range(3):
        a_params, a_state, a_m = kept(a_params, a_state, data)
        b_params, b_state, b_m = donated(b_params, b_state, data)
        assert all(torch.equal(a_m[k], b_m[k]) for k in a_m)
    # the donated step wrote into the tensors it was given
    assert all(x is y for x, y in zip(tree_util.leaves((b_params, b_state)), given))
    for x, y in zip(tree_util.leaves((a_params, a_state)), given):
        assert torch.equal(x, y)
    # the kept step left the tensors it was given as they were
    for x, y in zip(kept_inputs, tree_util.leaves(before)):
        assert torch.equal(x, y)


def test_train_step_checks_its_batch_and_device():
    cfg, _, params, _, tokens, labels, _ = _setup("granite-3-8b")
    ocfg = opt.OptimizerConfig(**OCFG)
    step = _make_device_step(Model(cfg), ocfg, batch=B + 1, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        step(params, opt.init(ocfg, params), {"tokens": tokens, "labels": labels})


def test_pipeline_yields_the_references_batches():
    """The driver's corpus and schema (``launch/train.py``) through both
    pipelines at the full-width run's batch 4 x seq 512: equal batches.
    Each 64-record admission packs its ~59 rows and keeps 4 (ROADMAP.md
    section 3.10), in both packages."""
    ds = make_dataset("driver-corpus", 2000, 6.0, 350, seed=11)
    records = [{"text": json.dumps(d)} for d in ds.documents[:256]]
    schema = {"type": "object", "required": ["text"],
              "properties": {"text": {"type": "string", "minLength": 4}}}
    got = list(ShardedPipeline(schema, records, seq_len=512, batch_size=4,
                               device="cpu").batches())
    want = list(RefPipeline(schema, records, seq_len=512, batch_size=4).batches())
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# entry points: cuda unless told otherwise; the driver on the CPU
# ---------------------------------------------------------------------------


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    cfg = get_config("granite-3-8b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: make_train_step(Model(cfg), opt.OptimizerConfig(), make_host_mesh(), batch=2),
        lambda: ShardedPipeline({"type": "object"}, [], batch_size=2),
        lambda: CheckpointManager(tmp_path),
        lambda: CheckpointManager(tmp_path, device="cpu").restore({}, device="cuda"),
        lambda: train_cli.main(["--arch", "granite-3-8b", "--steps", "1",
                                "--ckpt-dir", str(tmp_path)]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "internvl2-76b"])
def test_train_driver_runs_on_the_cpu(arch, tmp_path):
    argv = ["--arch", arch, "--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(argv)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f"[train] arch={arch} ")
    assert lines[-1].startswith("[train] steps=3 loss ") and "rejected" in lines[-1]
    assert CheckpointManager(tmp_path / arch, device="cpu").latest_step() == 2
    # a second run resumes from the checkpoint
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(argv)
    assert "[train] resumed from step 2" in out.getvalue()


def test_train_driver_frees_its_first_state(monkeypatch, tmp_path):
    """With ``donate=False`` every step makes fresh trees; the driver keeps
    no reference to the first ones, so they are freed once the first step
    has returned (at full width they are 30.6 GB: ROADMAP.md section 3.11)."""
    import gc
    import weakref

    from repro_torch.models.model import Model as PortModel
    from repro_torch.train.supervisor import TrainSupervisor

    first, alive = [], []
    init = PortModel.init
    one_step = TrainSupervisor._one_step

    def recording_init(self, *args, **kwargs):
        params = init(self, *args, **kwargs)
        first.append(weakref.ref(tree_util.leaves(params)[0]))
        return params

    def watching_step(self, step, params, opt_state, batch):
        if step == 0:  # the step's own trees: DTensors over the init's storage
            first.append(weakref.ref(tree_util.leaves(params)[0]))
            first.append(weakref.ref(tree_util.leaves(opt_state.m)[0]))
        else:
            gc.collect()
            alive.append([ref() is not None for ref in first])
        return one_step(self, step, params, opt_state, batch)

    monkeypatch.setattr(PortModel, "init", recording_init)
    monkeypatch.setattr(TrainSupervisor, "_one_step", watching_step)
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(["--arch", "rwkv6-3b", "--steps", "3", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path), "--checkpoint-every", "0"])
    # the init's leaf (its shapes are drawn once more, as fake tensors, by
    # the mesh step's sharding rules) and the step's own two trees
    assert len(first) == 4 and alive == [[False] * 4] * 2
