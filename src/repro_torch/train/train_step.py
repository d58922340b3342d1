"""Sharded train / prefill / decode step builders on a ``DeviceMesh``.

``make_train_step`` returns a step with explicit in/out shardings: the
parameters and moments as the sharding rules place them, the batch on the
data axes, the metrics replicated.  It runs eagerly on DTensors: their ops
carry the placements through the model and ``torch.autograd``, the
activation constraints pin them at layer boundaries, and the gradients
are reduced onto the parameters' placements before the AdamW update,
which works on each leaf's local shard.  On a mesh of one device every
shard is the whole leaf and the step is the one-device step
(:func:`_make_device_step`) on the same tensors.  ``donate=True`` is the
port's form of buffer donation: the new parameters and moments are written
into the given tensors.

``make_dp_compressed_step`` is the pure-data-parallel variant with
*explicit* collectives, enabling int8 gradient compression with error
feedback across the mesh axes -- the distributed-optimization trick for
deployments whose slowest links carry the gradients.  As ``shard_map``
does, each rank computes its gradients on plain local tensors; the
all-reduces run over ``mesh.get_group(axis)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..core.batch_executor import resolve_device
from ..models.model import Model
from ..sharding import activation_specs, cache_specs_tree, param_pspecs
from ..sharding.constraints import activation_sharding
from ..sharding.rules import Mesh, NamedSharding, PartitionSpec as P
from ..sharding.rules import axis_names, device_put
from . import optimizer as opt
from . import tree as tree_util

Params = Any


def _named(mesh: Mesh, tree_specs):
    return tree_util.tree_map(lambda s: NamedSharding(mesh, s), tree_specs)


def _abstract(build: Callable[[], Params]) -> Params:
    """The tree ``build`` makes, as ``meta`` tensors of its shapes and
    dtypes (no allocation: ``build`` runs on fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = build()
    return tree_util.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), fake
    )


def _abstract_params(model: Model) -> Params:
    """Shape-only params (no allocation) for sharding-rule resolution."""
    return _abstract(lambda: model.init(torch.Generator()))


def _abstract_cache(model: Model, batch: int, max_len: int) -> Params:
    return _abstract(lambda: model.init_cache(batch, max_len, device="cpu"))


def _placed(tree: Params, shardings: Params, what: str) -> Params:
    """``tree`` laid out by a step's ``in_shardings``, as ``jax.jit`` lays
    out its arguments: a plain tensor is placed (a tensor already on the
    mesh's device keeps its storage on a mesh of one device, so a donated
    step still writes into it); a DTensor must already be laid out so."""
    flat = tree_util.flatten_with_path(tree)
    shs = tree_util.leaves(shardings)
    if len(flat) != len(shs):
        raise ValueError(f"{what}: {len(flat)} leaves; the step takes {len(shs)}")
    out = []
    for (path, leaf), sh in zip(flat, shs):
        if isinstance(leaf, DTensor) and (
                leaf.device_mesh != sh.mesh or tuple(leaf.placements) != sh.placements):
            raise ValueError(
                f"{what} leaf {path} is laid out {leaf.placements}, not {sh.placements}")
        out.append(sh.place(leaf))
    return tree_util.unflatten(tree, out)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _make_device_step(
    model: Model,
    ocfg: opt.OptimizerConfig,
    *,
    batch: int,
    device=None,
    donate: bool = True,
    remat: bool = True,
) -> Callable[[Params, opt.OptState, Dict[str, Any]], Tuple[Params, opt.OptState, Dict]]:
    """The one-device step: ``step(params, opt_state, batch_data) ->
    (params, opt_state, metrics)`` on ``device`` (cuda unless told
    otherwise).

    ``batch_data`` holds ``tokens`` and ``labels`` of ``batch`` rows (and a
    ``prefix`` for a config with ``prefix_len``), as tensors or arrays;
    ``params`` and ``opt_state`` must already be on ``device``.  ``metrics``
    holds ``lr``, ``grad_norm`` and ``loss`` as 0-d tensors.  The loss and
    its gradients with respect to every parameter leaf
    (``torch.autograd.grad``), then one AdamW update.

    ``donate=True`` writes the new parameters and moments into the tensors
    it was given, so the caller's ``params`` and ``opt_state`` trees are
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


def make_train_step(
    model: Model,
    ocfg: opt.OptimizerConfig,
    mesh: Mesh,
    *,
    batch: int,
    donate: bool = True,
    remat: bool = True,
):
    """Returns (step_fn, in_shardings, out_shardings).

    ``step_fn(params, opt_state, batch_data)`` runs on the mesh's device
    and returns DTensors laid out by ``out_shardings``.  Its arguments are
    laid out by ``in_shardings`` (``sharding.rules.device_put`` does it
    ahead; plain tensors and arrays are placed by the step, every rank
    passing the whole tensor).
    """
    cfg = model.cfg
    pspecs = param_pspecs(_abstract_params(model), mesh)
    acts = activation_specs(mesh, batch=batch, vocab=cfg.padded_vocab)
    local = _make_device_step(
        model, ocfg, batch=batch, device=mesh.device_type, donate=donate, remat=remat
    )

    params_sh = _named(mesh, pspecs)
    opt_sh = opt.OptState(
        step=NamedSharding(mesh, P()), m=params_sh, v=params_sh
    )
    batch_sh = {
        "tokens": NamedSharding(mesh, acts["tokens"]),
        "labels": NamedSharding(mesh, acts["labels"]),
    }
    if cfg.prefix_len:
        batch_sh["prefix"] = NamedSharding(mesh, acts["prefix"])
    metrics_sh = {
        k: NamedSharding(mesh, P()) for k in ("lr", "grad_norm", "loss")
    }

    def step(params, opt_state, batch_data):
        params = _placed(params, params_sh, "parameter")
        opt_state = _placed(opt_state, opt_sh, "optimizer state")
        if set(batch_data) != set(batch_sh):
            raise ValueError(f"batch keys {sorted(batch_data)}; the step takes {sorted(batch_sh)}")
        data = {k: batch_sh[k].place(v) for k, v in batch_data.items()}
        with activation_sharding(mesh, batch=batch, vocab=cfg.padded_vocab), implicit_replication():
            new_params, new_state, metrics = local(params, opt_state, data)
            metrics = device_put(metrics, metrics_sh)
        return new_params, new_state, metrics

    return step, (params_sh, opt_sh, batch_sh), (params_sh, opt_sh, metrics_sh)


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def make_prefill_step(model: Model, mesh: Mesh, *, batch: int, max_len: int):
    """Returns (prefill_fn, in_shardings, out_shardings);
    ``prefill_fn(params, tokens[, prefix]) -> (logits, cache)``."""
    cfg = model.cfg
    pspecs = param_pspecs(_abstract_params(model), mesh)
    acts = activation_specs(mesh, batch=batch, vocab=cfg.padded_vocab)
    params_sh = _named(mesh, pspecs)

    abstract_cache = _abstract_cache(model, batch, max_len)
    cache_specs = cache_specs_tree(abstract_cache, mesh, batch=batch, seq_sharded=False)
    out_sh = (
        NamedSharding(mesh, acts["logits"]),
        _named(mesh, cache_specs),
    )
    in_sh = [params_sh, NamedSharding(mesh, acts["tokens"])]
    if cfg.prefix_len:
        in_sh.append(NamedSharding(mesh, acts["prefix"]))

    def prefill(params, tokens, prefix=None):
        params = _placed(params, params_sh, "parameter")
        if (prefix is not None) != bool(cfg.prefix_len):
            raise ValueError(f"a prefix is taken exactly when prefix_len is set ({cfg.prefix_len})")
        tokens = in_sh[1].place(tokens)
        if prefix is not None:
            prefix = in_sh[2].place(prefix)
        with activation_sharding(mesh, batch=batch, vocab=cfg.padded_vocab), implicit_replication():
            logits, cache = model.prefill(params, tokens, max_len, prefix)
            return out_sh[0].place(logits), device_put(cache, out_sh[1])

    return prefill, in_sh, out_sh


def make_decode_step(
    model: Model, mesh: Mesh, *, batch: int, max_len: int, seq_sharded: bool = False
):
    """One-token serve_step against a (possibly sequence-sharded) cache.

    Returns (decode_fn, in_shardings, cache_shardings);
    ``decode_fn(params, token, cache, cache_len) -> (logits, cache)``.
    The cache is donated: laid out by ``cache_shardings`` (as prefill
    returns it), it is updated in place and returned."""
    cfg = model.cfg
    pspecs = param_pspecs(_abstract_params(model), mesh)
    params_sh = _named(mesh, pspecs)
    acts = activation_specs(mesh, batch=batch, vocab=cfg.padded_vocab)
    abstract_cache = _abstract_cache(model, batch, max_len)
    cache_specs = cache_specs_tree(abstract_cache, mesh, batch=batch, seq_sharded=seq_sharded)
    cache_sh = _named(mesh, cache_specs)
    token_sh = NamedSharding(mesh, acts["tokens"])
    logits_sh = NamedSharding(mesh, acts["logits"])

    def decode(params, token, cache, cache_len):
        params = _placed(params, params_sh, "parameter")
        cache = _placed(cache, cache_sh, "cache")
        token = token_sh.place(token)
        with activation_sharding(mesh, batch=batch, vocab=cfg.padded_vocab), implicit_replication():
            logits, cache = model.decode_step(params, token, cache, cache_len)
            return logits_sh.place(logits), cache

    return decode, (params_sh, token_sh, cache_sh), cache_sh


# ---------------------------------------------------------------------------
# Pure-DP step with int8 gradient compression (explicit collectives)
# ---------------------------------------------------------------------------


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(tree: Params, axis: str, mesh: Mesh) -> Params:
    """int8-quantized all-reduce over ``mesh``'s ``axis``: quantize
    locally, sum int32, dequantize.

    Per-tensor scales are themselves max-reduced so every rank dequantizes
    identically; the quantization error stays bounded by the max-scale.
    """
    group = mesh.get_group(axis)

    def one(x):
        x32 = x.to(torch.float32)
        scale = torch.amax(torch.abs(x32)) / 127.0 + 1e-12
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int32)
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        return (q.to(torch.float32) * scale).to(x.dtype)

    return tree_util.tree_map(one, tree)


def _pmean(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    group = mesh.get_group(axis)
    total = x.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total / dist.get_world_size(group)


def make_dp_compressed_step(
    model: Model,
    ocfg: opt.OptimizerConfig,
    mesh: Mesh,
    *,
    compress: bool = True,
    error_feedback: bool = True,
):
    """Data-parallel train step with explicit (optionally compressed)
    gradient all-reduce over every mesh axis.  Params are replicated (plain
    tensors, the same on every rank); the batch is sharded over all the
    axes: every rank passes the whole batch and computes on its rows.

    ``step(params, opt_state, err, tokens, labels) -> (params, opt_state,
    err, metrics)``."""
    axes = axis_names(mesh)
    batch_sh = NamedSharding(mesh, P(axes))
    nd = mesh.size()

    def step(params, opt_state, err, tokens, labels):
        tokens = batch_sh.place(tokens).to_local()
        labels = batch_sh.place(labels).to_local()
        flat = tree_util.leaves(params)
        with torch.enable_grad():
            leaves = [leaf.detach().requires_grad_(True) for leaf in flat]
            loss = model.loss(tree_util.unflatten(params, leaves), tokens, labels, remat=False)
            grads = tree_util.unflatten(params, list(torch.autograd.grad(loss, leaves)))
        del leaves
        loss = loss.detach()
        if compress:
            if error_feedback:
                grads = tree_util.tree_map(lambda g, e: g + e.to(g.dtype), grads, err)
            summed = grads
            for a in axes:
                summed = compressed_psum(summed, a, mesh)
            mean = tree_util.tree_map(lambda g: g / nd, summed)
            # residual the compression error for the next step
            new_err = tree_util.tree_map(
                lambda g, s: (g - s / nd).to(torch.float32), grads, mean
            ) if error_feedback else err
            grads = mean
        else:
            for a in axes:
                grads = tree_util.tree_map(lambda g: _pmean(g, a, mesh), grads)
            new_err = err
        loss = _pmean(loss, axes[0], mesh) if axes else loss
        new_params, new_state, metrics = opt.update(ocfg, grads, opt_state, params)
        return new_params, new_state, new_err, dict(metrics, loss=loss)

    return step
