"""Multi-pod dry-run, the port's form: per-rank state and dot FLOPs of every
(arch x shape x mesh) cell, without hardware.

The JAX package lowers and compiles each cell's step on 256 and 512
placeholder devices and reads XLA's ``memory_analysis()``,
``cost_analysis()`` and the post-SPMD HLO.  PyTorch has no counterpart of
any of the three: the port's steps run eagerly on DTensors, with no
ahead-of-time program to analyse.  So, for the single-pod (16 data x 16
model = 256 ranks) and multi-pod (2 pod x 16 x 16 = 512 ranks) meshes,
built abstractly (``launch/mesh.py::make_abstract_mesh``, no process group)
over ``meta`` tensors, each cell records:

* per-rank bytes of parameters, optimizer moments and decode cache, from
  each leaf's local shape under the placements the sharding rules give it
  (activations and temporaries are not counted: nothing reports them);
* dot FLOPs of the cell's step from ``torch.utils.flop_counter``'s
  ``FlopCounterMode`` over a ``meta``-device trace at reduced depth (one and
  two periods), extrapolated linearly to ``n_periods`` as the reference's
  ``_scan_flops_correction`` scales its scanned body; per rank, the global
  count over the ranks (an even split);
* roofline terms with the H100 SXM's constants: the dot FLOPs at the bf16
  peak, the state read once at the HBM rate, and the parameters each rank
  must gather over its FSDP axes at NVLink's rate.

No collective bytes are recorded: there is no compiled program to read
them from.  Results are JSON under ``results/dryrun_torch/``, never the JAX
package's ``results/dryrun/``.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# H100 SXM hardware model (per card)
PEAK_FLOPS = 989e12  # bf16 dense
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s, one direction


def _mesh_for(multi_pod: bool):
    from .mesh import make_abstract_mesh

    if multi_pod:
        return make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_abstract_mesh((16, 16), ("data", "model"))


def local_shape(shape: Tuple[int, ...], spec, mesh) -> Tuple[int, ...]:
    """The shape of rank 0's shard of a ``shape`` tensor laid out by ``spec``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from ..sharding.rules import placements

    return tuple(compute_local_shape_and_global_offset(shape, mesh, placements(spec, mesh))[0])


def per_rank_bytes(tree: Any, specs: Any, mesh, dtype=None) -> int:
    """Bytes of rank 0's shards of every leaf of ``tree`` (``meta``
    tensors), each in its own dtype or in ``dtype``."""
    from ..train import tree as tree_util

    total = 0
    for leaf, spec in zip(tree_util.leaves(tree), tree_util.leaves(specs)):
        n = 1
        for d in local_shape(tuple(leaf.shape), spec, mesh):
            n *= d
        total += n * (dtype or leaf.dtype).itemsize
    return total


def _gather_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes each rank receives to hold its parameters whole over the FSDP
    axes (its tensor-parallel shard of each, the ``model`` axis kept)."""
    from ..sharding.rules import PartitionSpec as P
    from ..train import tree as tree_util

    fsdp = {"pod", "data"}

    def tp_only(spec):
        keep = []
        for entry in spec:
            axes = entry if isinstance(entry, tuple) else (entry,)
            kept = tuple(a for a in axes if a is not None and a not in fsdp)
            keep.append(kept or None)
        return P(*keep)

    tp_specs = tree_util.tree_map(tp_only, specs)
    return per_rank_bytes(tree, tp_specs, mesh) - per_rank_bytes(tree, specs, mesh)


def state_bytes(cfg, mesh, *, kind: str, batch: int, seq: int,
                seq_sharded: bool = False) -> Dict[str, int]:
    """Per-rank bytes of the cell's parameters, moments (train) and cache
    (decode)."""
    from ..models.model import Model
    from ..sharding import cache_specs_tree, param_pspecs
    from ..train.train_step import _abstract_cache, _abstract_params

    model = Model(cfg)
    aparams = _abstract_params(model)
    pspecs = param_pspecs(aparams, mesh)
    out = {
        "param_bytes": per_rank_bytes(aparams, pspecs, mesh),
        "param_gather_bytes": _gather_bytes(aparams, pspecs, mesh),
        "moment_bytes": 0,
        "cache_bytes": 0,
    }
    if kind == "train":
        out["moment_bytes"] = 2 * per_rank_bytes(
            aparams, pspecs, mesh, getattr(torch, cfg.optimizer_state_dtype))
    if kind == "decode":
        cache = _abstract_cache(model, batch, seq)
        specs = cache_specs_tree(cache, mesh, batch=batch, seq_sharded=seq_sharded)
        out["cache_bytes"] = per_rank_bytes(cache, specs, mesh)
    return out


def _traced_flops(cfg, kind: str, batch: int, seq: int, remat: bool) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.model import Model
    from ..train import tree as tree_util
    from ..train.train_step import _abstract_cache, _abstract_params

    model = Model(cfg)
    params = _abstract_params(model)
    meta = dict(device="meta")
    prefix = None
    if cfg.prefix_len and kind != "decode":
        prefix = torch.empty((batch, cfg.prefix_len, cfg.d_model), dtype=cfg.dtype(), **meta)
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            tokens = torch.zeros((batch, seq), dtype=torch.int32, **meta)
            leaves = [leaf.requires_grad_(True) for leaf in tree_util.leaves(params)]
            loss = model.loss(tree_util.unflatten(params, leaves), tokens, tokens, prefix,
                              remat=remat)
            torch.autograd.grad(loss, leaves)
        elif kind == "prefill":
            tokens = torch.zeros((batch, seq), dtype=torch.int32, **meta)
            model.prefill(params, tokens, seq + cfg.prefix_len, prefix)
        else:
            token = torch.zeros((batch, 1), dtype=torch.int32, **meta)
            model.decode_step(params, token, _abstract_cache(model, batch, seq), seq - 1)
    return float(counter.get_total_flops())


def step_dot_flops(cfg, *, kind: str, batch: int, seq: int, remat: bool = True) -> float:
    """Global dot FLOPs of one step of ``cfg`` at its full depth: traces at
    one and two periods, the difference taken as a period's."""
    one, two = (
        _traced_flops(dataclasses.replace(cfg, n_layers=len(cfg.period) * k), kind, batch, seq,
                      remat)
        for k in (1, 2)
    )
    return one + (cfg.n_periods - 1) * (two - one)


def run_cell(arch: str, shape: str, multi_pod: bool, *, verbose: bool = True) -> Dict[str, Any]:
    from ..configs import get_config
    from .specs import SHAPES, cell_applicable

    mesh_name = "2x16x16" if multi_pod else "16x16"
    cfg = get_config(arch)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "skipped",
                "reason": why}
    t0 = time.time()
    mesh = _mesh_for(multi_pod)
    seq, batch, kind = SHAPES[shape]
    ranks = 512 if multi_pod else 256
    mem = state_bytes(cfg, mesh, kind=kind, batch=batch, seq=seq,
                      seq_sharded=(shape == "long_500k"))
    flops = step_dot_flops(cfg, kind=kind, batch=batch, seq=seq)
    per_rank = flops / ranks
    state = mem["param_bytes"] + mem["moment_bytes"] + mem["cache_bytes"]
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "status": "ok",
        "ranks": ranks,
        "seconds": round(time.time() - t0, 2),
        "memory": dict(mem, state_bytes_per_rank=state),
        "cost": {
            "dot_flops_global": flops,
            "dot_flops_per_rank": per_rank,
            "scan_trip_count": cfg.n_periods,
        },
        "roofline": {
            "compute_s": per_rank / PEAK_FLOPS,
            "state_hbm_s": state / HBM_BW,
            "param_gather_nvlink_s": mem["param_gather_bytes"] / NVLINK_BW,
        },
        "model": {
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
        },
    }
    if verbose:
        print(
            f"[dryrun] {arch:24s} {shape:12s} {mesh_name:8s} "
            f"state/rank={state/2**30:6.2f}GiB dotflops/rank={per_rank:.3e}"
        )
    return result


def cell_path(arch: str, shape: str, multi_pod: bool) -> Path:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    return RESULTS_DIR / f"{arch}__{shape}__{mesh_name}.json"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--arch", type=str, default=None)
    parser.add_argument("--shape", type=str, default=None)
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--multi-pod-only", action="store_true")
    parser.add_argument("--single-pod-only", action="store_true")
    parser.add_argument("--force", action="store_true", help="recompute cached cells")
    args = parser.parse_args(argv)

    from ..configs import ARCHS
    from .specs import SHAPES

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]

    failures = []
    for arch in archs:
        for shape in shapes:
            for multi_pod in meshes:
                path = cell_path(arch, shape, multi_pod)
                if path.exists() and not args.force:
                    print(f"[dryrun] cached: {path.name}")
                    continue
                try:
                    result = run_cell(arch, shape, multi_pod)
                except Exception as exc:  # noqa: BLE001 -- record and continue
                    result = {
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if multi_pod else "16x16",
                        "status": "error", "error": f"{type(exc).__name__}: {exc}",
                    }
                    failures.append(result)
                    print(f"[dryrun] ERROR {arch} {shape}: {exc}")
                path.write_text(json.dumps(result, indent=2, default=str))
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed")
    print("[dryrun] all requested cells complete")


if __name__ == "__main__":
    main()
