"""The port's sharding slice against the JAX package's, on metadata and on a
(1, 1) CPU mesh.

- ``param_pspecs``, ``activation_specs``, ``cache_pspec`` and
  ``cache_specs_tree`` equal the JAX package's, spec for spec, for all ten
  architectures (reduced and at full width) on (2, 4), (16, 16) and
  (2, 16, 16) meshes.  The reference's rules read only a mesh's axis names
  and sizes, so its side runs on a duck-typed mesh and ``jax.eval_shape``;
  the port's on ``make_abstract_mesh`` (no process group) and ``meta``
  tensors.
- The DTensor placements the port derives on a 256-rank ``DeviceMesh``
  over the fake process group give the local shapes of JAX's shards.
- On a (1, 1) mesh the train, prefill and decode steps are bit-equal to
  the one-device functions, starting from the JAX init
  (``convert.params_from_jax``), and the train step's loss is the JAX
  step's within ``test_torch_train.py``'s 1e-5.
- The activation constraints are no-ops outside ``activation_sharding``.
- The dry-run's per-rank parameter bytes equal the JAX specs' shard sizes,
  and its ``FlopCounterMode`` dot FLOPs of a reduced one-device train step
  are ``analyze_hlo``'s of the same step lowered by JAX on one CPU device:
  equal for granite, moonshot and jamba, 1.41 % below for rwkv6 (the
  tolerance is 2 %; PERF.md says where the gap lies).
- ``launch/specs.py``'s stand-ins have the JAX package's shapes and dtypes,
  and the copied ``hlo_analysis.py`` reads JAX-compiled HLO as the
  reference does.  Nothing in the port emits HLO text.
"""

import dataclasses
import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.launch.hlo_analysis import analyze_hlo as ref_analyze_hlo
from repro.launch.specs import abstract_params as ref_abstract_params
from repro.launch.specs import input_specs as ref_input_specs
from repro.models import Model as RefModel
from repro.sharding import activation_specs as ref_activation_specs
from repro.sharding import cache_pspec as ref_cache_pspec
from repro.sharding import cache_specs_tree as ref_cache_specs_tree
from repro.sharding import param_pspecs as ref_param_pspecs
from repro.train import optimizer as ref_opt
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import analyze_hlo
from repro_torch.launch.mesh import make_abstract_mesh, make_host_mesh
from repro_torch.launch.specs import abstract_params, input_specs
from repro_torch.models import Model
from repro_torch.sharding import activation_specs, cache_pspec, cache_specs_tree, param_pspecs
from repro_torch.sharding import constraints as C
from repro_torch.sharding.rules import (
    MODEL_OPS,
    NamedSharding,
    PartitionSpec as P,
    device_put,
    ensure_op_strategies,
    placements,
)
from repro_torch.train import optimizer as opt
from repro_torch.train import tree as tree_util
from repro_torch.train.train_step import (
    _abstract_cache,
    _abstract_params,
    _make_device_step,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["2x4", "16x16", "2x16x16"]
# the train step's loss against the JAX step's (test_torch_train.py's LOSS_REL)
LOSS_REL = 1e-5
# FlopCounterMode's dot FLOPs against analyze_hlo's; measured 0 for granite,
# moonshot and jamba, 1.41 % for rwkv6
FLOPS_REL = 0.02


@pytest.fixture
def host_mesh():
    """A (1, 1) CPU mesh on a single-rank gloo group of its own."""
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture
def fake_256():
    """A (16, 16) ``DeviceMesh`` over 256 ranks of the fake process group,
    seen from rank 0."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    yield init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _duck(shape, axes):
    """All that the reference's rules read of a mesh."""
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _configs(arch, full):
    if full:
        return ref_get_config(arch), get_config(arch)
    return ref_get_config(arch).reduced(), get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _abstract_pair(arch, full):
    rcfg, cfg = _configs(arch, full)
    rparams = jax.eval_shape(lambda k: RefModel(rcfg).init(k), jax.random.PRNGKey(0))
    return rparams, _abstract_params(Model(cfg))


def _port(spec):
    return P(*spec)


def _assert_trees_of_specs_equal(got, want):
    flat_got = tree_util.flatten_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, JaxP))
    assert len(flat_got) == len(flat_want)
    for (path, g), (rpath, w) in zip(flat_got, flat_want):
        assert isinstance(g, P), path
        assert g == _port(w) and tuple(g) == tuple(w), (path, g, w)


# ---------------------------------------------------------------------------
# the rules, spec for spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_the_references(arch, mesh, full):
    rparams, params = _abstract_pair(arch, full)
    _assert_trees_of_specs_equal(param_pspecs(params, make_abstract_mesh(*mesh)),
                                 ref_param_pspecs(rparams, _duck(*mesh)))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_activation_specs_equal_the_references(mesh):
    port, ref = make_abstract_mesh(*mesh), _duck(*mesh)
    for batch in (1, 2, 4, 8, 16, 24, 32, 128, 256, 512):
        for seq_sharded in (False, True):
            for vocab in (None, 512, 49155, 65536):
                got = activation_specs(port, batch=batch, seq_sharded=seq_sharded, vocab=vocab)
                want = ref_activation_specs(ref, batch=batch, seq_sharded=seq_sharded, vocab=vocab)
                assert got.keys() == want.keys()
                for key in want:
                    assert got[key] == _port(want[key]), (batch, seq_sharded, vocab, key)
            for key, spec in ref_cache_pspec(ref, batch=batch, seq_sharded=seq_sharded).items():
                assert cache_pspec(port, batch=batch, seq_sharded=seq_sharded)[key] == _port(spec)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_tree_equals_the_references(arch, mesh):
    rcfg, cfg = _configs(arch, True)
    port, ref = make_abstract_mesh(*mesh), _duck(*mesh)
    for batch, seq_sharded in ((1, True), (8, False), (128, False), (3, False)):
        rcache = jax.eval_shape(lambda: RefModel(rcfg).init_cache(batch, 256))
        cache = _abstract_cache(Model(cfg), batch, 256)
        _assert_trees_of_specs_equal(
            cache_specs_tree(cache, port, batch=batch, seq_sharded=seq_sharded),
            ref_cache_specs_tree(rcache, ref, batch=batch, seq_sharded=seq_sharded))


def test_partition_spec_has_jaxs_equality():
    pairs = [(("a", None), ("a",)), ((("a",),), ("a",)), (((),), (None,)), ((), ()),
             ((("a", "b"), None), (("a", "b"), None)), ((["a", "b"],), (("a", "b"),)),
             (("a",), ("b",)), ((None,), ())]
    for x, y in pairs:
        assert (P(*x) == P(*y)) == (JaxP(*x) == JaxP(*y)), (x, y)
        assert (P(*x) == tuple(y)) == (JaxP(*x) == tuple(y)), (x, y)
        assert (hash(P(*x)) == hash(P(*y))) == (P(*x) == P(*y)), (x, y)
        assert tuple(P(*x)) == tuple(JaxP(*x))
    assert P("a", None) != "a" and len(P("a", None)) == 2 and P("a", None)[0] == "a"


def test_placements_shard_major_to_minor_and_replicate_one_rank_axes():
    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="major-to-minor"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="shards two"):
        placements(P("model", "model"), mesh)
    # an axis of one rank holds every dimension whole
    one = make_abstract_mesh((1, 4), ("data", "model"))
    assert placements(P("data", "model"), one) == (Replicate(), Shard(1))


@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-1.5-large-398b", "arctic-480b",
                                  "rwkv6-3b"])
def test_placements_give_jaxs_shard_shapes_on_a_256_rank_mesh(arch, fake_256):
    rparams, params = _abstract_pair(arch, True)
    jmesh = AbstractMesh((16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rspecs = jax.tree.leaves(ref_param_pspecs(rparams, _duck((16, 16), ("data", "model"))),
                             is_leaf=lambda x: isinstance(x, JaxP))
    specs = tree_util.leaves(param_pspecs(params, fake_256))
    sharded = 0
    for leaf, spec, rleaf, rspec in zip(tree_util.leaves(params), specs,
                                        jax.tree.leaves(rparams), rspecs):
        pl = placements(spec, fake_256)
        local = distribute_tensor(torch.empty(leaf.shape, device="meta"), fake_256, pl,
                                  src_data_rank=None).to_local().shape
        assert tuple(local) == JaxNamedSharding(jmesh, rspec).shard_shape(rleaf.shape)
        sharded += tuple(local) != tuple(leaf.shape)
    assert sharded > 0


def test_mesh_builders(monkeypatch):
    from repro_torch.launch import mesh as M

    prod = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert prod.shape == (2, 16, 16) and M.batch_axes(prod) == ("pod", "data")
    assert M.fsdp_axes(make_abstract_mesh((16, 16), ("data", "model"))) == ("data",)
    if dist.is_initialized():
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="init_process_group"):
        M.make_production_mesh(device="cpu")  # 256 ranks need a group of 256
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_host_mesh()  # cuda unless told otherwise
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# DTensor support across releases
# ---------------------------------------------------------------------------


def test_model_ops_are_what_the_models_run():
    """``MODEL_OPS`` is every tensor op that the ten configs' train steps
    (remat on and off), prefill and decode dispatch."""
    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(str(func).removeprefix("aten."))
            return func(*args, **(kwargs or {}))

    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model, ocfg = Model(cfg), opt.OptimizerConfig()
        params = model.init(torch.Generator().manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator()).int()
        data = {"tokens": tokens, "labels": tokens}
        if cfg.prefix_len:
            data["prefix"] = torch.zeros(2, cfg.prefix_len, cfg.d_model, dtype=cfg.dtype())
        with Record():
            for remat in (True, False):
                step = _make_device_step(model, ocfg, batch=2, device="cpu", donate=remat,
                                         remat=remat)
                step(params, opt.init(ocfg, params), data)
            _, cache = model.prefill(params, tokens, 72 + cfg.prefix_len, data.get("prefix"))
            model.decode_step(params, tokens[:, :1], cache, 64 + cfg.prefix_len)
    factories = {"arange.default", "arange.start_step", "empty.memory_format", "full.default",
                 "ones.default", "scalar_tensor.default", "zeros.default"}
    assert seen - factories == set(MODEL_OPS)


def test_missing_op_strategies_are_registered_replicated(host_mesh, monkeypatch):
    prop = DTensor._op_dispatcher.sharding_propagator
    flip = torch.ops.aten.flip.default
    assert ensure_op_strategies() == ()  # this release has them all
    for table in ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"):
        monkeypatch.setattr(prop, table,
                            {k: v for k, v in getattr(prop, table).items() if k != flip})
    monkeypatch.setattr(prop, "op_to_schema_info", dict(prop.op_to_schema_info))
    assert ensure_op_strategies() == ("flip.default",)
    x = torch.arange(12.0).reshape(3, 4)
    got = NamedSharding(host_mesh, P()).place(x)
    out = torch.flip(got, [1])
    assert isinstance(out, DTensor) and torch.equal(out.to_local(), torch.flip(x, [1]))
    # constant_pad_nd always gets the port's strategy: one placement per mesh dim
    padded = torch.nn.functional.pad(got, (0, 2))
    assert len(padded.placements) == 2 and torch.equal(padded.to_local(),
                                                       torch.nn.functional.pad(x, (0, 2)))


# ---------------------------------------------------------------------------
# constraints: no-ops outside a context
# ---------------------------------------------------------------------------


def test_constraints_are_no_ops_outside_a_context(host_mesh):
    x = torch.randn(4, 8, 16)
    d = NamedSharding(host_mesh, P()).place(x)
    for t in (x, d):
        assert C.constrain_bsd(t) is t and C.constrain_bsd(t, seq_shard=True) is t
        assert C.constrain(t, "batch", "model", None) is t
        assert C.constrain_logits(t) is t and C.constrain_split(t, 2, 4) is t
    assert C.logits_pspec_ctx() is None and not C.model_axis_divides(16)
    with C.activation_sharding(host_mesh, batch=4, vocab=16):
        assert C.constrain_bsd(x) is x  # a plain tensor passes
        assert C.constrain_bsd(d, seq_shard=True).placements == (Replicate(), Replicate())
        assert C.logits_pspec_ctx() == P(("data",), None, "model")
        assert C.model_axis_divides(16)
    assert C.logits_pspec_ctx() is None


def test_constraints_follow_the_references_context():
    """Inside a context the specs are the reference's (the mesh sizes of a
    16 x 16 mesh, read without a process group)."""
    from repro.sharding import constraints as RC

    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    rmesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    for batch, vocab in ((32, 49155), (8, 65536), (48, 512)):
        with C.activation_sharding(mesh, batch=batch, vocab=vocab), \
                RC.activation_sharding(rmesh, batch=batch, vocab=vocab):
            assert C.logits_pspec_ctx() == _port(RC.logits_pspec_ctx())
            for dim in (8, 16, 40):
                assert C.model_axis_divides(dim) == RC.model_axis_divides(dim)


# ---------------------------------------------------------------------------
# the (1, 1) mesh steps against the one-device functions
# ---------------------------------------------------------------------------


def _jax_loss(rcfg, rparams, tokens):
    loss, _ = jax.value_and_grad(
        lambda p: RefModel(rcfg).loss(p, jnp.asarray(tokens), jnp.asarray(tokens), remat=False)
    )(rparams)
    return float(loss)


@pytest.mark.parametrize("arch", ["granite-3-8b", "rwkv6-3b", "moonshot-v1-16b-a3b"])
def test_host_mesh_steps_are_the_one_device_functions(arch, host_mesh):
    torch.set_num_threads(1)
    rcfg = ref_get_config(arch).reduced(param_dtype="float32", activation_dtype="float32")
    cfg = get_config(arch).reduced(param_dtype="float32", activation_dtype="float32")
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    model, ocfg, batch = Model(cfg), opt.OptimizerConfig(), 2
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, 64)).astype(np.int32)
    data = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens)}

    one = _make_device_step(model, ocfg, batch=batch, device="cpu", donate=False)
    params = params_from_jax(rparams, device="cpu")
    want_p, want_s, want_m = one(params, opt.init(ocfg, params), data)
    step, (psh, osh, bsh), (_, _, msh) = make_train_step(model, ocfg, host_mesh, batch=batch)
    given = device_put(params_from_jax(rparams, device="cpu"), psh)
    got_p, got_s, got_m = step(given, device_put(opt.init(ocfg, given), osh), data)
    assert got_p is not given  # a fresh tree of the donated leaves
    assert all(x is y for x, y in zip(tree_util.leaves(got_p), tree_util.leaves(given)))
    for key in want_m:
        assert isinstance(got_m[key], DTensor) and got_m[key].placements == msh[key].placements
        assert torch.equal(got_m[key].to_local(), want_m[key]), key
    for a, b in zip(tree_util.leaves((got_p, got_s)), tree_util.leaves((want_p, want_s))):
        assert torch.equal(a.to_local(), b)
    assert int(got_s.step) == 1
    np.testing.assert_allclose(float(got_m["loss"]), _jax_loss(rcfg, rparams, tokens),
                               rtol=LOSS_REL)

    max_len = 80
    prefill, _, (logits_sh, cache_sh) = make_prefill_step(model, host_mesh, batch=batch,
                                                          max_len=max_len)
    want_logits, want_cache = model.prefill(params, data["tokens"], max_len)
    got_logits, got_cache = prefill(device_put(params, psh), data["tokens"])
    assert got_logits.placements == logits_sh.placements
    assert torch.equal(got_logits.to_local(), want_logits)
    for a, b in zip(tree_util.leaves(got_cache), tree_util.leaves(want_cache)):
        assert torch.equal(a.to_local(), b)
    decode, _, _ = make_decode_step(model, host_mesh, batch=batch, max_len=max_len)
    want_logits, want_cache = model.decode_step(params, data["tokens"][:, :1], want_cache, 64)
    got_logits, got_cache = decode(device_put(params, psh), data["tokens"][:, :1], got_cache, 64)
    assert torch.equal(got_logits.to_local(), want_logits)
    for a, b in zip(tree_util.leaves(got_cache), tree_util.leaves(want_cache)):
        assert torch.equal(a.to_local(), b)


def test_mesh_step_checks_what_it_is_given(host_mesh):
    cfg = get_config("granite-3-8b").reduced()
    model, ocfg = Model(cfg), opt.OptimizerConfig()
    step, (psh, osh, _), _ = make_train_step(model, ocfg, host_mesh, batch=2)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="batch keys"):
        step(params, opt.init(ocfg, params), {"tokens": tokens})
    with pytest.raises(ValueError, match="leaves"):
        step({"final_norm": params["final_norm"]}, opt.init(ocfg, params),
             {"tokens": tokens, "labels": tokens})


# ---------------------------------------------------------------------------
# the dry-run and the specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES[:2], ids=MESH_IDS[:2])
@pytest.mark.parametrize("arch", ["granite-3-8b", "moonshot-v1-16b-a3b", "rwkv6-3b"])
def test_dryrun_param_bytes_are_the_jax_shards(arch, mesh):
    rparams, params = _abstract_pair(arch, False)
    rmesh = AbstractMesh(mesh[0], mesh[1], axis_types=(AxisType.Auto,) * len(mesh[0]))
    rspecs = jax.tree.leaves(ref_param_pspecs(rparams, _duck(*mesh)),
                             is_leaf=lambda x: isinstance(x, JaxP))
    elems = [int(np.prod(JaxNamedSharding(rmesh, s).shard_shape(x.shape)))
             for x, s in zip(jax.tree.leaves(rparams), rspecs)]
    want = sum(n * x.dtype.itemsize for n, x in zip(elems, jax.tree.leaves(rparams)))
    port_mesh = make_abstract_mesh(*mesh)
    got = dryrun.state_bytes(get_config(arch).reduced(), port_mesh, kind="train", batch=8,
                             seq=64)
    assert got["param_bytes"] == want
    assert got["moment_bytes"] == 2 * 4 * sum(elems)  # two float32 moments


@pytest.mark.parametrize("arch", ["granite-3-8b", "moonshot-v1-16b-a3b", "rwkv6-3b"])
def test_dryrun_dot_flops_match_analyze_hlo(arch):
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rocfg = ref_opt.OptimizerConfig()
    step, _, _ = ref_make_train_step(RefModel(rcfg), rocfg, mesh, batch=2)
    aparams = jax.eval_shape(lambda k: RefModel(rcfg).init(k), jax.random.PRNGKey(0))
    aopt = jax.eval_shape(lambda p: ref_opt.init(rocfg, p), aparams)
    batch = {k: jax.ShapeDtypeStruct((2, 64), jnp.int32) for k in ("tokens", "labels")}
    want = ref_analyze_hlo(step.lower(aparams, aopt, batch).compile().as_text()).dot_flops
    got = dryrun.step_dot_flops(cfg, kind="train", batch=2, seq=64)
    assert abs(got - want) <= FLOPS_REL * want, (got, want)
    if arch != "rwkv6-3b":
        assert got == want


def test_dryrun_cli_writes_its_own_results(tmp_path, monkeypatch):
    assert dryrun.RESULTS_DIR.name == "dryrun_torch"  # never the JAX package's results
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    dryrun.main(["--arch", "rwkv6-3b", "--shape", "long_500k", "--multi-pod-only"])
    dryrun.main(["--arch", "granite-3-8b", "--shape", "long_500k", "--single-pod-only"])
    cell = json.loads((tmp_path / "rwkv6-3b__long_500k__2x16x16.json").read_text())
    assert cell["status"] == "ok" and cell["ranks"] == 512
    assert cell["memory"]["cache_bytes"] > 0 and cell["cost"]["dot_flops_per_rank"] > 0
    assert cell["roofline"]["compute_s"] == cell["cost"]["dot_flops_per_rank"] / 989e12
    skipped = json.loads((tmp_path / "granite-3-8b__long_500k__16x16.json").read_text())
    assert skipped["status"] == "skipped"


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["internvl2-76b", "jamba-1.5-large-398b"])
def test_input_specs_have_the_references_shapes(arch, shape):
    rspecs, specs = ref_input_specs(ref_get_config(arch), shape), input_specs(get_config(arch),
                                                                              shape)
    rflat = jax.tree_util.tree_leaves_with_path(rspecs)
    flat = tree_util.flatten_with_path(specs)
    assert len(flat) == len(rflat)
    for (path, leaf), (_, rleaf) in zip(flat, rflat):
        assert leaf.device.type == "meta" and tuple(leaf.shape) == tuple(rleaf.shape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(rleaf.dtype), path


def test_abstract_params_have_the_references_shapes():
    for arch in ("musicgen-large", "arctic-480b"):
        got = tree_util.leaves(abstract_params(get_config(arch)))
        want = jax.tree.leaves(ref_abstract_params(ref_get_config(arch)))
        assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want]


def test_copied_hlo_analysis_reads_jax_hlo_as_the_reference():
    """Nothing in the port emits HLO; its copy of the analyser reads what
    JAX compiles here exactly as the reference's does."""
    w = jnp.ones((128, 128), jnp.float32)
    x = jnp.ones((64, 128), jnp.float32)

    def scanned(x, w):
        out, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=12)
        return out

    text = jax.jit(scanned).lower(x, w).compile().as_text()
    got, want = analyze_hlo(text), ref_analyze_hlo(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.dot_flops == 2 * 64 * 128 * 128 * 12 and 12 in got.while_trip_counts
