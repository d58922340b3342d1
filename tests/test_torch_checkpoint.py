"""Checkpoints between the two packages.

The port's ``CheckpointManager`` keeps the JAX package's on-disk format: a
checkpoint that either package writes restores bit for bit in the other,
for a reduced model's parameters and ``OptState`` in bfloat16 and in
float32, with and without zstd compression.  Both write the same bytes for
the same tree: the manifests and every leaf file are equal, and the port's
own msgpack encoder gives ``msgpack.packb``'s bytes.  A crc mismatch raises
in both.
"""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import zstandard

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.sharding.rules import NamedSharding, PartitionSpec as P, device_put
from repro_torch.train import tree as tree_util
from repro_torch.train.checkpoint import CheckpointManager
from torch.distributed.tensor import DTensor

from test_torch_sharding import host_mesh  # noqa: F401  (a fixture)

DTYPES = [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


def _bundles(dtype, state_dtype):
    """The same {"params", "opt_state"} bundle for both packages: reduced
    rwkv6 parameters from the JAX init, moments from a numpy seed, step 3."""
    rcfg = ref_get_config("rwkv6-3b").reduced(param_dtype=dtype, activation_dtype=dtype)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    moment = lambda p: jnp.asarray(rng.normal(0, 1, p.shape), state_dtype)
    rstate = ref_opt.OptState(jnp.int32(3), jax.tree.map(moment, rparams),
                              jax.tree.map(moment, rparams))
    ref = {"params": rparams, "opt_state": rstate}
    port = {"params": params_from_jax(jax.device_get(rparams), device="cpu"),
            "opt_state": opt_state_from_jax(jax.device_get(rstate), device="cpu")}
    return ref, port


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as numpy, whatever its package and dtype."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_bits(port_tree, ref_tree):
    port_flat = tree_util.flatten_with_path(port_tree)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert len(port_flat) == len(ref_flat)
    for (path, got), (_, want) in zip(port_flat, ref_flat):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert str(got.dtype) == f"torch.{np.asarray(want).dtype}", path
        a, b = _bits(got), _bits(want)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.fixture(params=[True, False], ids=["zstd", "raw"])
def compression(request, monkeypatch):
    """With zstd, as where zstandard is installed, and without it."""
    if not request.param:
        monkeypatch.setattr(ckpt, "zstandard", None)
        monkeypatch.setattr(ref_ckpt, "zstandard", None)
    return request.param


@pytest.mark.parametrize("dtype,state_dtype", DTYPES)
def test_jax_writes_the_port_restores(dtype, state_dtype, compression, tmp_path):
    ref, port = _bundles(dtype, state_dtype)
    ref_ckpt.CheckpointManager(tmp_path, async_save=False).save(5, ref)
    like = tree_util.tree_map(torch.zeros_like, port)
    step, restored = CheckpointManager(tmp_path, device="cpu").restore(like)
    assert step == 5
    _assert_same_bits(restored, ref)
    assert isinstance(restored["opt_state"], type(port["opt_state"]))
    assert restored["opt_state"].step.shape == () and int(restored["opt_state"].step) == 3


@pytest.mark.parametrize("dtype,state_dtype", DTYPES)
def test_the_port_writes_jax_restores(dtype, state_dtype, compression, tmp_path):
    ref, port = _bundles(dtype, state_dtype)
    CheckpointManager(tmp_path, async_save=False, device="cpu").save(7, port)
    step, restored = ref_ckpt.CheckpointManager(tmp_path).restore(ref)
    assert step == 7
    _assert_same_bits(port, restored)


@pytest.mark.parametrize("dtype,state_dtype", DTYPES)
def test_both_packages_write_the_same_files(dtype, state_dtype, compression, tmp_path):
    ref, port = _bundles(dtype, state_dtype)
    ref_ckpt.CheckpointManager(tmp_path / "jax", async_save=False).save(2, ref)
    CheckpointManager(tmp_path / "torch", async_save=False, device="cpu").save(2, port)
    want_dir, got_dir = (tmp_path / d / "step_0000000002" for d in ("jax", "torch"))
    names = sorted(p.name for p in want_dir.iterdir())
    assert names == sorted(p.name for p in got_dir.iterdir())
    assert all(n.endswith(".zst") == compression for n in names if n.startswith("leaf_"))
    for name in names:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name
    manifest = (got_dir / "manifest.msgpack").read_bytes()
    assert msgpack.packb(msgpack.unpackb(manifest)) == manifest
    assert ckpt.unpackb(manifest) == msgpack.unpackb(manifest)
    keys = [leaf["key"] for leaf in ckpt.unpackb(manifest)["leaves"]]
    assert keys[:3] == ["opt_state\x1f.step", "opt_state\x1f.m\x1fembedding\x1fhead",
                        "opt_state\x1f.m\x1fembedding\x1ftokens"]
    assert keys[-1] == "params\x1fstack\x1flayer0\x1frwkv\x1fw_v"


_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
         -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
_VALUES = [
    None, True, False, *_INTS,
    *("k" * n for n in (0, 31, 32, 255, 256, 65535, 65536)),
    "opt_state\x1f.m\x1fembedding", "héllo ✓",
    *([i for i in range(n)] for n in (0, 15, 16, 65535, 65536)),
    *({f"k{i}": i for i in range(n)} for n in (0, 15, 16, 70000)),
    {"step": 3, "leaves": [{"key": "a", "file": "leaf_00000.bin", "dtype": "bfloat16",
                            "shape": [], "crc32": 4294967295}]},
]


@pytest.mark.parametrize("value", _VALUES, ids=lambda v: repr(v)[:40])
def test_packb_is_msgpacks(value):
    assert ckpt.packb(value) == msgpack.packb(value)
    assert ckpt.unpackb(msgpack.packb(value)) == value


def test_packb_refuses_what_the_manifest_never_holds():
    for value in (1.5, b"raw", 2**64, -2**63 - 1):
        with pytest.raises((TypeError, OverflowError)):
            ckpt.packb(value)
    with pytest.raises(ValueError, match="outside the manifest's subset"):
        ckpt.unpackb(msgpack.packb(1.5))


def _corrupt_one_leaf(directory):
    """Rewrite a leaf with one bit flipped, still validly compressed, so
    that only its crc can tell."""
    step_dir = directory / "step_0000000001"
    victim = next(step_dir.glob("leaf_*.bin.zst"))
    raw = bytearray(zstandard.ZstdDecompressor().decompress(victim.read_bytes()))
    raw[0] ^= 0x01
    victim.write_bytes(zstandard.ZstdCompressor(level=3).compress(bytes(raw)))


def test_crc_mismatch_raises_in_both_packages(tmp_path):
    ref, port = _bundles("bfloat16", "float32")
    CheckpointManager(tmp_path, async_save=False, device="cpu").save(1, port)
    _corrupt_one_leaf(tmp_path)
    with pytest.raises(IOError, match="crc mismatch"):
        CheckpointManager(tmp_path, device="cpu").restore(port)
    with pytest.raises(IOError, match="crc mismatch"):
        ref_ckpt.CheckpointManager(tmp_path).restore(ref)
    # without the integrity check both read the same (corrupted) bits
    _, got = CheckpointManager(tmp_path, device="cpu").restore(port, strict_integrity=False)
    _, want = ref_ckpt.CheckpointManager(tmp_path).restore(ref, strict_integrity=False)
    _assert_same_bits(got, want)


def test_async_save_copies_the_leaves_before_it_returns(tmp_path):
    _, port = _bundles("float32", "float32")
    want = tree_util.tree_map(torch.clone, port)
    mgr = CheckpointManager(tmp_path, device="cpu")  # async by default
    mgr.save(4, port)
    for leaf in tree_util.leaves(port):
        leaf.add_(1)  # the donated step's in-place update, right after the save
    mgr.wait()
    _, restored = mgr.restore(port)
    for a, b in zip(tree_util.leaves(restored), tree_util.leaves(want)):
        assert torch.equal(a, b)


def test_restore_onto_a_mesh_places_every_leaf(tmp_path, host_mesh):
    """``restore(shardings=...)``: every leaf bit-equal and a DTensor laid
    out by its sharding on the mesh; a DTensor tree saves as its values."""
    tree = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(0)),
            "b": torch.arange(6, dtype=torch.int32).to(torch.bfloat16)}
    specs = {"w": P("data", "model"), "b": P()}
    shardings = tree_util.tree_map(lambda s: NamedSharding(host_mesh, s), specs)
    mgr = CheckpointManager(tmp_path, async_save=False, device="cpu")
    mgr.save(1, device_put(tree, shardings))
    step, restored = mgr.restore(tree, shardings=shardings)
    assert step == 1
    for name, leaf in restored.items():
        assert isinstance(leaf, DTensor) and leaf.device_mesh == host_mesh
        assert leaf.placements == shardings[name].placements
        assert torch.equal(leaf.full_tensor(), tree[name])
