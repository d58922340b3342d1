"""The train step on one device.

``make_train_step`` returns the step that the JAX package's function of the
same name jits: the loss and its gradients with respect to every parameter
leaf (``torch.autograd.grad``), then one AdamW update.  The mesh, its
shardings and the reference file's other step factories (prefill, decode,
the int8-compressed data-parallel step) belong to the sharding slice and are
not here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..core.batch_executor import resolve_device
from ..models.model import Model
from . import optimizer as opt
from . import tree as tree_util

Params = Any


def make_train_step(
    model: Model,
    ocfg: opt.OptimizerConfig,
    *,
    batch: int,
    device=None,
    donate: bool = True,
    remat: bool = True,
) -> Callable[[Params, opt.OptState, Dict[str, Any]], Tuple[Params, opt.OptState, Dict]]:
    """``step(params, opt_state, batch_data) -> (params, opt_state, metrics)``
    on ``device`` (cuda unless told otherwise).

    ``batch_data`` holds ``tokens`` and ``labels`` of ``batch`` rows (and a
    ``prefix`` for a config with ``prefix_len``), as tensors or arrays;
    ``params`` and ``opt_state`` must already be on ``device``.  ``metrics``
    holds ``lr``, ``grad_norm`` and ``loss`` as 0-d tensors.

    ``donate=True`` is the port's form of the reference's buffer donation:
    the step writes the new parameters and moments into the tensors it was
    given, so the caller's ``params`` and ``opt_state`` trees are
    overwritten and returned.  ``donate=False`` leaves them as they were
    and returns fresh tensors.
    """
    device = resolve_device(device)

    def step(params: Params, opt_state: opt.OptState, batch_data: Dict[str, Any]):
        data = {k: torch.as_tensor(v, device=device) for k, v in batch_data.items()}
        if data["tokens"].shape[0] != batch:
            raise ValueError(f"a batch of {data['tokens'].shape[0]} rows; the step takes {batch}")
        flat = tree_util.leaves(params)
        for leaf in flat:
            if leaf.device.type != device.type:
                raise ValueError(f"a parameter on {leaf.device}; the step runs on {device}")
        with torch.enable_grad():
            leaves = [leaf.detach().requires_grad_(True) for leaf in flat]
            loss = model.loss(
                tree_util.unflatten(params, leaves),
                data["tokens"],
                data["labels"],
                data.get("prefix"),
                remat=remat,
            )
            grads = torch.autograd.grad(loss, leaves)
        del leaves
        new_params, new_state, metrics = opt.update(
            ocfg, tree_util.unflatten(params, list(grads)), opt_state, params, inplace=donate
        )
        return new_params, new_state, dict(metrics, loss=loss.detach())

    return step
