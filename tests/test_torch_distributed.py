"""The port's multi-rank sharding on real ranks: eight CPU processes joined
by ``gloo``, spawned once for the file (``torch_dist_worker.py``), each rank
running every check.

The checks are the JAX package's ``tests/test_distributed.py:65-139`` at
its bounds and tighter.  Its two 8-device tests fail in the JAX package
itself (ROADMAP.md section 3.3), so the port is held to the reference's
single-device results, from the same JAX-initialised parameters
(``convert.params_from_jax``) and tokens:

- a (2, 4) ("data", "model") mesh step of reduced granite at batch 8 x seq
  32: ``step == 1``, the loss within the reference's 5 % of the JAX
  package's single-device loss in bfloat16; in float32 within 1e-4
  relative of it and of the port's one-device step, with the grad norm and
  every new parameter as close;
- ``compressed_psum`` over 8 ranks within the reference's 2e-2 of the sum;
- the int8 data-parallel step on 4 of the ranks: a finite loss and
  non-zero error-feedback buffers.

``int8_quantize`` is held to the JAX op bit for bit in-process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.train.train_step import int8_dequantize as ref_int8_dequantize
from repro.train.train_step import int8_quantize as ref_int8_quantize
from repro_torch.convert import params_from_jax
from repro_torch.train.train_step import int8_dequantize, int8_quantize

ROOT = Path(__file__).resolve().parents[1]
REF_BOUND = 0.05  # test_distributed.py's loss bound
F32_REL = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The eight ranks' numbers, and the JAX single-device losses."""
    work = tmp_path_factory.mktemp("ranks")
    tokens = np.random.default_rng(1).integers(0, 512, (8, 32)).astype(np.int32)
    torch.save(torch.from_numpy(tokens), work / "tokens.pt")
    ref_losses = {}
    for dtype in ("bfloat16", "float32"):
        rcfg = ref_get_config("granite-3-8b").reduced(param_dtype=dtype, activation_dtype=dtype)
        rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
        t = jnp.asarray(tokens)
        ref_losses[dtype] = float(RefModel(rcfg).loss(rparams, t, t, remat=False))
        torch.save(params_from_jax(rparams, device="cpu"), work / f"granite_{dtype}.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"), str(work)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads((work / "out.json").read_text()), ref_losses


def test_mesh_step_runs_one_step(ranks):
    out, _ = ranks
    assert out["mesh_bf16"]["step"] == 1 and out["mesh_f32"]["step"] == 1
    # tensor parallelism engaged: leaves sharded on the mesh
    assert out["mesh_bf16"]["sharded_leaves"] > 0


def test_mesh_step_loss_within_the_references_bound(ranks):
    out, ref = ranks
    got = out["mesh_bf16"]["loss"]
    assert abs(got - ref["bfloat16"]) / ref["bfloat16"] < REF_BOUND, (got, ref)


def test_mesh_step_float32_matches_one_device(ranks):
    out, ref = ranks
    f32 = out["mesh_f32"]
    for got, want in ((f32["loss"], ref["float32"]), (f32["loss"], f32["ref_loss"]),
                      (f32["grad_norm"], f32["ref_grad_norm"])):
        assert abs(got - want) <= F32_REL * abs(want), (got, want)
    assert f32["param_err"] <= F32_REL * 3e-4  # of a first step of at most lr = 3e-4


def test_compressed_psum_over_eight_ranks(ranks):
    out, _ = ranks
    assert out["psum"]["err"] < 0.02


def test_dp_compressed_step_on_four_ranks(ranks):
    out, _ = ranks
    dp = out["dp"]
    assert np.isfinite(dp["loss"]) and dp["step"] == 1
    assert dp["total_err"] > 0  # error feedback buffers are populated


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantize_is_the_jax_op(dtype):
    x = np.random.default_rng(0).standard_normal((64, 33)).astype(np.float32) * 3.0
    rq, rscale = ref_int8_quantize(jnp.asarray(x, dtype))
    q, scale = int8_quantize(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)
    np.testing.assert_array_equal(int8_dequantize(q, scale).float().numpy(),
                                  np.asarray(ref_int8_dequantize(rq, rscale), np.float32))
