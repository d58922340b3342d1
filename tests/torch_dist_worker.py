"""Ranks of the port's multi-process checks (``test_torch_distributed.py``).

``python tests/torch_dist_worker.py <dir>`` spawns ``WORLD`` processes on
the CPU, joined by ``gloo`` through a ``FileStore`` (no network address).
Every rank runs every check; rank 0 writes the numbers that the tests read
to ``<dir>/out.json``.  The checks follow the JAX package's
``tests/test_distributed.py``: a (2, 4) mesh train step of reduced granite
(the parameters in ``<dir>/granite_<dtype>.pt``, batch 8 x seq 32 from
``<dir>/tokens.pt``) against the one-device step, in bfloat16 and in
float32; ``compressed_psum`` over 8 ranks; the int8 data-parallel step on
4.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _mesh_step(cfg, mesh, params, tokens):
    """One (2, 4) mesh step of ``cfg`` against the one-device step on the
    same parameters and batch."""
    from repro_torch.models import Model
    from repro_torch.sharding.rules import device_put
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree as tree_util
    from repro_torch.train.train_step import _make_device_step, make_train_step

    model = Model(cfg)
    ocfg = opt.OptimizerConfig()
    one = _make_device_step(model, ocfg, batch=8, device="cpu", donate=False)
    p1, s1, m1 = one(params, opt.init(ocfg, params), {"tokens": tokens, "labels": tokens})

    step, (psh, osh, _), _ = make_train_step(model, ocfg, mesh, batch=8, donate=False)
    params_s = device_put(params, psh)
    opt_s = device_put(opt.init(ocfg, params_s), osh)
    t0 = time.perf_counter()
    new_p, new_o, metrics = step(params_s, opt_s, {"tokens": tokens, "labels": tokens})
    seconds = time.perf_counter() - t0
    gathered = [x.full_tensor() for x in tree_util.leaves(new_p)]
    param_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(gathered, tree_util.leaves(p1)))
    return {
        "loss": float(metrics["loss"]),
        "ref_loss": float(m1["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "ref_grad_norm": float(m1["grad_norm"]),
        "step": int(new_o.step.full_tensor()),
        "param_err": param_err,
        "sharded_leaves": sum(any(not p.is_replicate() for p in x.placements)
                              for x in tree_util.leaves(new_p)),
        "seconds": seconds,
    }


def _compressed_psum(mesh):
    from repro_torch.train.train_step import compressed_psum

    x = np.random.default_rng(0).standard_normal((WORLD, 64)).astype(np.float32)
    rank = dist.get_rank()
    got = compressed_psum({"g": torch.from_numpy(x[rank].copy())}, "pod", mesh)["g"]
    expected = x.sum(axis=0)
    return {"err": float(np.abs(got.numpy() - expected).max() / (np.abs(expected).max() + 1e-9))}


def _dp_compressed(mesh):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree as tree_util
    from repro_torch.train.train_step import make_dp_compressed_step

    cfg = get_config("phi4-mini-3.8b").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    ocfg = opt.OptimizerConfig()
    step = make_dp_compressed_step(model, ocfg, mesh)
    err = tree_util.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32), params)
    tokens = torch.from_numpy(_tokens(cfg, (8, 16), 1))
    _, state, err, metrics = step(params, opt.init(ocfg, params), err, tokens, tokens)
    return {
        "loss": float(metrics["loss"]),
        "total_err": sum(float(e.abs().sum()) for e in tree_util.leaves(err)),
        "step": int(state.step),
    }


def _rank(rank: int, store_path: str, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh

        granite = get_config("granite-3-8b").reduced()
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        tokens = torch.load(os.path.join(work, "tokens.pt"))
        load = lambda dtype: torch.load(os.path.join(work, f"granite_{dtype}.pt"))
        out = {
            "mesh_bf16": _mesh_step(granite, mesh, load("bfloat16"), tokens),
            "mesh_f32": _mesh_step(
                dataclasses.replace(granite, param_dtype="float32", activation_dtype="float32"),
                mesh, load("float32"), tokens),
            "psum": _compressed_psum(make_mesh((WORLD,), ("pod",), device="cpu")),
        }
        # four of the eight ranks: every rank builds the mesh's groups
        dp_mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("pod",))
        if rank < 4:
            out["dp"] = _dp_compressed(dp_mesh)
        dist.barrier()
        if rank == 0:
            with open(os.path.join(work, "out.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(work: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(os.path.join(tmp, "store"), work),
                           nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1])
