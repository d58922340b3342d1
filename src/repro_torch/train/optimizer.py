"""AdamW with global-norm clipping and warmup+cosine schedule (PyTorch).

Function for function the JAX package's optimizer: the same config, state,
schedule and float32 update math, with leaves visited in JAX's order
(``tree.py``) so that the global norm sums them in the same order.  Moment
dtype is configurable: the >300B MoE architectures keep m/v in bf16
(DESIGN.md §5).

``update`` builds new trees by default, as the reference does; with
``inplace=True`` it writes the new parameters and moments into the given
tensors, which is the port's form of buffer donation.  Either way it works
through large leaves a slice at a time, so that its float32 temporaries
stay small beside the model's state.

On a mesh the leaves are DTensors.  The update is element-wise, so it runs
on each leaf's local shard: the parameter, its gradient (reduced onto the
parameter's placements first) and both moments share one placement, and on
a mesh of one device the local shard is the whole leaf.  The global norm is
a DTensor reduction: the shards' partial sums reduced to one replicated
scalar.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from . import tree as tree_util

Params = Any

_SLICE = 1 << 26  # elements of a leaf updated at a time (256 MB a float32 temporary)


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_fraction: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Params
    v: Params


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cosine = 0.5 * (1 + torch.cos(math.pi * progress))
    floor = cfg.min_lr_fraction
    return cfg.learning_rate * warm * (floor + (1 - floor) * cosine)


def init(cfg: OptimizerConfig, params: Params) -> OptState:
    dt = getattr(torch, cfg.state_dtype)
    leaves = tree_util.leaves(params)
    device = leaves[0].device if leaves else None
    # a DTensor parameter's moments take its placements
    zeros = lambda p: (torch.zeros_like(p, dtype=dt) if isinstance(p, DTensor)
                       else torch.zeros(p.shape, dtype=dt, device=p.device))
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_util.tree_map(zeros, params),
        v=tree_util.tree_map(zeros, params),
    )


def global_norm(tree: Params) -> torch.Tensor:
    leaves = tree_util.leaves(tree)
    total = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)
    if isinstance(total, DTensor):  # the shards' partial sums -> one replicated scalar
        total = total.redistribute(total.device_mesh, [Replicate()] * total.device_mesh.ndim)
    return torch.sqrt(total)


def _local(x):
    """A DTensor's local shard (its whole value when replicated), else ``x``."""
    return x.to_local() if isinstance(x, DTensor) else x


def _placed_like(g, p):
    """A DTensor gradient on its parameter's placements (a partial
    gradient is reduced here)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _decay_mask(path) -> bool:
    """Weight decay applies to matrices, not to norms/biases/scalars."""
    name = str(path[-1]) if path and isinstance(path[-1], str) else ""
    return name not in ("scale", "decay_bias", "dt_bias", "conv_b", "bonus", "shift_mix")


def update(
    cfg: OptimizerConfig,
    grads: Params,
    state: OptState,
    params: Params,
    *,
    inplace: bool = False,
) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``inplace`` overwrites ``params``, ``state.m``,
    ``state.v`` and ``state.step`` and returns them."""
    with torch.no_grad():
        grads = tree_util.tree_map(_placed_like, grads, params)
        step = state.step.add_(1) if inplace else state.step + 1
        lr = schedule(cfg, _local(step))

        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(_local(gnorm), min=1e-9), max=1.0)
        dt = getattr(torch, cfg.state_dtype)
        stepf = _local(step).to(torch.float32)
        bc1 = 1 - cfg.beta1 ** stepf
        bc2 = 1 - cfg.beta2 ** stepf

        def upd(p, g, m, v, decay):
            g32 = g.to(torch.float32) * scale
            m32 = cfg.beta1 * m.to(torch.float32) + (1 - cfg.beta1) * g32
            v32 = cfg.beta2 * v.to(torch.float32) + (1 - cfg.beta2) * torch.square(g32)
            m_hat = m32 / bc1
            v_hat = v32 / bc2
            delta = m_hat / (torch.sqrt(v_hat) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
            return new_p, m32.to(dt), v32.to(dt)

        def leaf(path, p, g, m, v):
            mesh = p.device_mesh if isinstance(p, DTensor) else None
            if mesh is not None and any(
                    not isinstance(t, DTensor) or t.placements != p.placements for t in (g, m, v)):
                raise ValueError(f"leaf {path}: gradient or moments off the parameter's layout")
            local = [_local(t) for t in (p, g, m, v)]
            n = local[0].numel()
            if inplace:
                out = (local[0], local[2], local[3])
                if not all(t.is_contiguous() for t in out):
                    raise ValueError(f"in-place update of a non-contiguous leaf {path}")
            else:
                shape, dev = local[0].shape, local[0].device
                out = (torch.empty(shape, dtype=p.dtype, device=dev),
                       torch.empty(shape, dtype=dt, device=dev),
                       torch.empty(shape, dtype=dt, device=dev))
            flat_in = [t.reshape(-1) for t in local]
            flat_out = [t.view(-1) for t in out]
            decay = _decay_mask(path)
            for lo in range(0, n, _SLICE):
                hi = min(lo + _SLICE, n)
                for dst, src in zip(flat_out, upd(*(t[lo:hi] for t in flat_in), decay)):
                    dst[lo:hi] = src
            if inplace:
                return p, m, v
            if mesh is not None:
                out = tuple(DTensor.from_local(t, mesh, p.placements, run_check=False,
                                               shape=p.shape, stride=p.stride()) for t in out)
            return out

        flat = tree_util.flatten_with_path(params)
        rest = [tree_util.leaves(t) for t in (grads, state.m, state.v)]
        if any(len(r) != len(flat) for r in rest):
            raise ValueError("params, grads and moments differ in structure")
        outs = [leaf(path, p, *others) for (path, p), *others in zip(flat, *rest)]
        new_params, new_m, new_v = (
            tree_util.unflatten(params, [o[i] for o in outs]) for i in range(3))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, OptState(step=step, m=new_m, v=new_v), metrics
