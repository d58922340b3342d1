"""Production mesh construction on torch's ``DeviceMesh``.

A function, not a module-level constant: importing this module must never
touch device state or start a process group.

Mesh shapes:
  single-pod: (data=16, model=16)        -- 256 ranks
  multi-pod : (pod=2, data=16, model=16) -- 512 ranks across hosts

The ``pod`` axis composes with ``data`` for hierarchical data parallelism
(gradient reduce-scatter crosses the fast links first, then the slow ones)
and is the pipeline axis when pipeline parallelism is enabled.

Every builder takes ``device``: ``cuda`` (NCCL) unless the caller passes
``device="cpu"`` (gloo).  A mesh needs a process group of its size.  When
none exists, a mesh of one rank starts its own (a ``HashStore``, no
network address); a larger one raises: start the group first
(``torch.distributed.init_process_group`` with its address, world size and
rank).  :func:`make_abstract_mesh` is the shape alone, for rules and
dry-runs on any number of ranks without a group.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.batch_executor import resolve_device
from ..sharding.rules import ensure_op_strategies


def _device_type(device) -> str:
    return resolve_device(device).type


def _ensure_process_group(size: int, device_type: str) -> None:
    if dist.is_initialized():
        if dist.get_world_size() < size:
            raise ValueError(
                f"a mesh of {size} ranks in a process group of {dist.get_world_size()}"
            )
        return
    if size != 1:
        raise RuntimeError(
            f"a mesh of {size} ranks needs a process group of that size; "
            "call torch.distributed.init_process_group first"
        )
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *, device=None) -> DeviceMesh:
    """Arbitrary mesh (smoke tests use (1, 1) or (1, 2) meshes)."""
    device_type = _device_type(device)
    size = 1
    for n in shape:
        size *= n
    _ensure_process_group(size, device_type)
    ensure_op_strategies()
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(device=None) -> DeviceMesh:
    """Single-device mesh with the production axis names."""
    return make_mesh((1, 1), ("data", "model"), device=device)


def make_abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` seen from rank 0, with no process group behind
    it: enough for the sharding rules, placements and local shapes, not for
    collectives (the counterpart of ``jax.sharding.AbstractMesh``)."""
    ranks = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    return DeviceMesh("cpu", ranks, mesh_dim_names=tuple(axes), _init_backend=False, _rank=0)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch (pure-DP axes)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes used for parameter (FSDP/ZeRO) sharding."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
