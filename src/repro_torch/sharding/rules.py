"""Logical-axis -> mesh-axis sharding rules (DP / TP / EP / SP / pod).

Megatron-style tensor parallelism on the ``model`` axis, FSDP/ZeRO-style
parameter+optimizer sharding on the (``pod``, ``data``) axes, expert
parallelism for MoE weights (experts on ``model``, expert-FFN input dim on
FSDP), sequence parallelism for long-context decode caches.

Rules are name-based over pytree paths and *divisibility-checked*: a rule
axis that does not divide the actual dimension is dropped (e.g. kv_heads=8
on a model axis of 16 -> kv projections fall back to FSDP-only sharding).
All stacked (scan) parameters have a leading period axis that is always
replicated.

The rules are the JAX package's, in its own form: each returns a
:class:`PartitionSpec`, one entry per tensor dimension, each ``None``, a
mesh axis name or a tuple of names, with JAX's equality.  A mesh is torch's
``DeviceMesh`` with the reference's axis names (``launch/mesh.py``).
:func:`placements` turns a spec into DTensor placements over that mesh:
mesh dimension ``a`` gets ``Shard(d)`` when entry ``d`` holds ``a``, else
``Replicate()``; a tuple entry shards one tensor dimension over several
mesh dimensions, major to minor in the mesh's order, as GSPMD does.  An
axis of one rank shards nothing (every rank holds the whole dimension, as
under GSPMD), so it gets ``Replicate()``: some DTensor versions refuse
views of a tensor sharded over a one-rank axis.
:class:`NamedSharding` pairs a mesh with a spec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..train import tree as tree_util

Mesh = DeviceMesh


# ---------------------------------------------------------------------------
# PartitionSpec, placements, NamedSharding
# ---------------------------------------------------------------------------


def _canonical(entry):
    """JAX's canonical form of one entry: a 1-tuple is its name, an empty
    tuple is ``None``, a list is a tuple."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec:
    """Per-dimension mesh axes of a tensor (``jax.sharding.PartitionSpec``).

    Not a tuple, so that tree walks (``train/tree.py``) take it as a leaf;
    equal to another spec or a tuple with the same canonical entries."""

    __slots__ = ("_partitions",)

    def __init__(self, *partitions):
        self._partitions = tuple(_canonical(p) for p in partitions)

    def __getitem__(self, i):
        return self._partitions[i]

    def __iter__(self):
        return iter(self._partitions)

    def __len__(self) -> int:
        return len(self._partitions)

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._partitions == other._partitions
        if isinstance(other, tuple):
            return self._partitions == tuple(_canonical(o) for o in other)
        return False

    def __hash__(self) -> int:
        return hash(self._partitions)

    def __repr__(self) -> str:
        return f"PartitionSpec({repr(self._partitions)[1:-1]})"


P = PartitionSpec


def axis_names(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh: Mesh) -> Dict[str, int]:
    """Axis name -> size, the reference's ``mesh.shape``."""
    return dict(zip(axis_names(mesh), mesh.shape))


def placements(spec: PartitionSpec, mesh: Mesh) -> Tuple[Any, ...]:
    """DTensor placements, one per mesh dimension, that carry out ``spec``."""
    names, sizes = axis_names(mesh), mesh.shape
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's major-to-minor order")
        for i in where:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dimensions")
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, self.mesh)

    def place(self, x) -> DTensor:
        """``x`` laid out by this sharding: a plain tensor is moved to the
        mesh's device and split (every rank passes the whole tensor); a
        DTensor on the mesh is redistributed."""
        if isinstance(x, DTensor):
            if x.device_mesh != self.mesh:
                raise ValueError(f"a DTensor on {x.device_mesh}, not on {self.mesh}")
            if tuple(x.placements) == self.placements:
                return x
            return x.redistribute(self.mesh, self.placements)
        x = torch.as_tensor(x)
        return distribute_tensor(x.to(self.mesh.device_type), self.mesh, self.placements)


# The ATen ops that take tensors in the port's models, losses and optimizer
# (train with and without remat, prefill and decode of the ten configs);
# ``tests/test_torch_sharding.py`` records them again and holds this list.
MODEL_OPS = (
    "_log_softmax.default", "_log_softmax_backward_data.default", "_softmax.default",
    "_softmax_backward_data.default", "_to_copy.default", "_unsafe_view.default",
    "abs.default", "add.Scalar", "add.Tensor", "add_.Tensor", "alias.default",
    "amax.default", "bmm.default", "cat.default", "clamp.default", "clone.default",
    "constant_pad_nd.default", "copy_.default", "cos.default", "cumsum.default",
    "detach.default", "div.Scalar", "div.Tensor", "eq.Tensor", "exp.default",
    "expand.default", "flip.default", "gather.default", "ge.Scalar", "gt.Scalar",
    "index.Tensor", "index_put.default", "isnan.default", "le.Tensor", "log.default",
    "log1p.default", "lt.Scalar", "mean.dim", "mm.default", "mul.Scalar", "mul.Tensor",
    "neg.default", "new_zeros.default", "ones_like.default", "permute.default",
    "pow.Scalar", "pow.Tensor_Scalar", "reciprocal.default", "relu.default",
    "round.default", "rsqrt.default", "rsub.Scalar", "scatter.src", "scatter_add.default",
    "select.int", "select_backward.default", "sgn.default", "silu.default",
    "silu_backward.default", "sin.default", "slice.Tensor", "slice_backward.default",
    "split.Tensor", "split_with_sizes.default", "sqrt.default", "squeeze.dim",
    "stack.default", "sub.Tensor", "sum.default", "sum.dim_IntList",
    "threshold_backward.default", "topk.default", "transpose.int", "tril.default",
    "unsqueeze.default", "view.default", "where.self",
)


def _op(name: str):
    packet, overload = name.split(".")
    return getattr(getattr(torch.ops.aten, packet), overload)


def _plain_tensor_op(op) -> bool:
    """Tensors in and out, no lists of them (what a replicated strategy
    can describe one argument at a time)."""
    schema = op._schema
    lists = [a.type for a in schema.arguments if isinstance(a.type, torch.ListType)]
    return (all(not isinstance(t.getElementType(), torch.TensorType) for t in lists)
            and all(isinstance(r.type, torch.TensorType) for r in schema.returns))


def _pad_strategy(x, pad, *rest):
    """``constant_pad_nd``: replicated, or sharded on a dimension it does
    not pad.  (Some DTensor releases give its output one placement on a
    mesh of two dimensions.)"""
    padded = {x.ndim - 1 - i // 2 for i, n in enumerate(pad) if n}
    tail = [None] * (1 + len(rest))
    out = [([Replicate()], [Replicate(), *tail])]
    out += [([Shard(d)], [Shard(d), *tail]) for d in range(x.ndim) if d not in padded]
    return out


def ensure_op_strategies() -> Tuple[str, ...]:
    """Give each op of :data:`MODEL_OPS` that the installed DTensor has no
    sharding strategy for the one strategy that is always right: every
    tensor replicated.  Returns the ops registered.

    DTensor's op coverage grows from release to release (``aten.flip``, the
    backward of ``cumsum``, has none in some); on a mesh of one device the
    replicated strategy is the only layout there is, and on a larger one it
    costs an all-gather where a release with a strategy would not.
    ``constant_pad_nd`` always gets :func:`_pad_strategy`.
    """
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.aten.constant_pad_nd.default)(_pad_strategy)
    prop = DTensor._op_dispatcher.sharding_propagator
    known = set()
    for table in ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"):
        known.update(getattr(prop, table, {}))
    added = []
    for name in MODEL_OPS:
        op = _op(name)
        if op in known or not _plain_tensor_op(op):
            continue
        n_out = len(op._schema.returns)

        def replicated(*args, _n=n_out, **kwargs):
            ins = [Replicate() if hasattr(a, "placements") else None for a in args]
            return [([Replicate()] * _n, ins)]

        register_sharding(op)(replicated)
        added.append(name)
    return tuple(added)


def device_put(tree: Any, shardings: Any) -> Any:
    """``jax.device_put(tree, shardings)``: every leaf placed by the
    :class:`NamedSharding` at the same place of ``shardings``."""
    return tree_util.tree_map(lambda x, s: s.place(x), tree, shardings)


# name -> per-dimension logical axes (after the leading scan axis)
# logical axes: "fsdp" (pod+data), "tensor" (model), None (replicated)
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings (not scanned: no leading period axis)
    "embedding.tokens": ("tensor", "fsdp"),
    "embedding.head": ("fsdp", "tensor"),
    # attention
    "attn.wq": ("fsdp", "tensor", None),
    "attn.wk": ("fsdp", "tensor", None),
    "attn.wv": ("fsdp", "tensor", None),
    "attn.wo": ("tensor", None, "fsdp"),
    "attn.bq": ("tensor", None),
    "attn.bk": ("tensor", None),
    "attn.bv": ("tensor", None),
    # dense FFN
    "ffn.w_gate": ("fsdp", "tensor"),
    "ffn.w_up": ("fsdp", "tensor"),
    "ffn.w_down": ("tensor", "fsdp"),
    # MoE: experts on tensor axis (EP), expert-FFN dims on fsdp
    "moe.router": ("fsdp", None),
    "moe.w_gate": ("tensor", "fsdp", None),
    "moe.w_up": ("tensor", "fsdp", None),
    "moe.w_down": ("tensor", None, "fsdp"),
    "moe.dense_residual.w_gate": ("fsdp", "tensor"),
    "moe.dense_residual.w_up": ("fsdp", "tensor"),
    "moe.dense_residual.w_down": ("tensor", "fsdp"),
    # Mamba (inner dim on tensor: conv + scan are channel-independent)
    "mamba.in_proj": ("fsdp", "tensor"),
    "mamba.conv_w": (None, "tensor"),
    "mamba.conv_b": ("tensor",),
    "mamba.x_proj": ("tensor", None),
    "mamba.dt_proj": (None, "tensor"),
    "mamba.dt_bias": ("tensor",),
    "mamba.A_log": ("tensor", None),
    "mamba.D": ("tensor",),
    "mamba.out_proj": ("tensor", "fsdp"),
    # RWKV-6
    "rwkv.w_r": ("fsdp", "tensor"),
    "rwkv.w_k": ("fsdp", "tensor"),
    "rwkv.w_v": ("fsdp", "tensor"),
    "rwkv.w_g": ("fsdp", "tensor"),
    "rwkv.w_decay": ("fsdp", "tensor"),
    "rwkv.w_o": ("tensor", "fsdp"),
    "rwkv.decay_bias": ("tensor",),
    "rwkv.bonus": (None, None),
    "rwkv.shift_mix": (None,),
    # RWKV channel mix
    "cmix.w_k": ("fsdp", "tensor"),
    "cmix.w_v": ("tensor", "fsdp"),
    "cmix.w_r": ("fsdp", "tensor"),
    "cmix.shift_mix": (None,),
}


def _logical_to_mesh(axis: Optional[str], mesh: Mesh):
    if axis is None:
        return None
    if axis == "tensor":
        return "model" if "model" in axis_names(mesh) else None
    if axis == "fsdp":
        axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
        return axes if axes else None
    raise ValueError(axis)


def _axis_size(mesh: Mesh, mesh_axis) -> int:
    if mesh_axis is None:
        return 1
    if isinstance(mesh_axis, tuple):
        out = 1
        for a in mesh_axis:
            out *= mesh_shape(mesh)[a]
        return out
    return mesh_shape(mesh)[mesh_axis]


def _path_str(path) -> str:
    """Dict keys and sequence indices joined by ``.`` (field names are
    left out, as ``jax.tree_util``'s ``GetAttrKey`` has no key or index)."""
    return ".".join(str.__str__(p) if isinstance(p, str) else str(p)
                    for p in path if not isinstance(p, tree_util.Attr))


def _spec_for(path_s: str, shape: Tuple[int, ...], mesh: Mesh) -> P:
    # match the longest rule suffix present in the path
    rule = None
    for name, axes in _PARAM_RULES.items():
        if path_s.endswith(name) or (name in path_s):
            rule = axes
            break
    if rule is None:
        return P()  # norms, scalars: replicated
    ndim = len(shape)
    # stacked (scan) params have one extra leading axis
    offset = ndim - len(rule)
    spec: list = [None] * ndim
    for i, logical in enumerate(rule):
        dim = offset + i
        if dim < 0:
            continue
        mesh_axis = _logical_to_mesh(logical, mesh)
        if mesh_axis is None:
            continue
        if shape[dim] % _axis_size(mesh, mesh_axis) != 0:
            continue  # divisibility fallback: replicate this dim
        spec[dim] = mesh_axis
    return P(*spec)


def param_pspecs(params: Any, mesh: Mesh) -> Any:
    """PartitionSpec pytree matching ``params``."""
    flat = tree_util.flatten_with_path(params)
    return tree_util.unflatten(
        params, [_spec_for(_path_str(path), tuple(leaf.shape), mesh) for path, leaf in flat]
    )


def shard_params(params: Any, mesh: Mesh) -> Any:
    """Device-put params with their production sharding."""
    specs = param_pspecs(params, mesh)
    return tree_util.tree_map(
        lambda x, s: NamedSharding(mesh, s).place(x), params, specs
    )


# ---------------------------------------------------------------------------
# Activations / inputs
# ---------------------------------------------------------------------------


def activation_specs(
    mesh: Mesh, *, batch: int, seq_sharded: bool = False, vocab: Optional[int] = None
) -> Dict[str, P]:
    """Input/activation PartitionSpecs.

    ``seq_sharded=True`` activates sequence parallelism: used for
    long-context decode where batch < data-axis size (long_500k, B=1).
    ``vocab`` enables the logits vocab-sharding divisibility check.
    """
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    b_axes = tuple(a for a in ("pod", "data") if a in names)
    total = 1
    for a in b_axes:
        total *= sizes[a]
    if batch % max(total, 1) != 0:
        # batch not divisible by the DP axes: drop pod first, then data
        b_axes = tuple(a for a in b_axes[1:]) if len(b_axes) > 1 else ()
        total = 1
        for a in b_axes:
            total *= sizes[a]
        if b_axes and batch % total != 0:
            b_axes = ()
    batch_spec = b_axes if b_axes else None
    seq_spec = ("data",) if (seq_sharded and "data" in names) else None
    vocab_axis = "model" if "model" in names else None
    if vocab is not None and vocab_axis is not None and vocab % sizes["model"] != 0:
        vocab_axis = None  # odd vocab (e.g. 49155): replicate logits dim
    return {
        "tokens": P(batch_spec, None),
        "labels": P(batch_spec, None),
        "prefix": P(batch_spec, None, None),
        "logits": P(batch_spec, None, vocab_axis),
        "batch": P(batch_spec),
        "seq": P(seq_spec),
    }


def cache_pspec(mesh: Mesh, *, batch: int, seq_sharded: bool) -> Dict[str, P]:
    """Decode-cache PartitionSpecs (stacked leading period axis).

    KV tensors are (periods, B, S, KVH, Dh): batch on data when divisible,
    else sequence-parallel over data (long_500k).
    """
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    b_axes = tuple(a for a in ("pod", "data") if a in names)
    total = 1
    for a in b_axes:
        total *= sizes[a]
    batch_ok = batch % max(total, 1) == 0 and not seq_sharded
    model_axis = "model" if "model" in names else None
    if batch_ok:
        # batch on DP axes; the model-axis dim of the KV tensor is chosen
        # per-shape in cache_specs_tree: kv heads when they divide (local
        # cache update, no collectives), else head_dim (local update,
        # cheap score all-reduce), else the sequence (SP; update reshards).
        return {
            "kv": P(None, b_axes, None, None, None),  # model dim set later
            "ssm_h": P(None, b_axes, model_axis, None),
            "ssm_conv": P(None, b_axes, None, model_axis),
            "rwkv_state": P(None, b_axes, None, None, None),
            "rwkv_x": P(None, b_axes, None),
        }
    # long-context, tiny batch: shard the sequence over data (SP); the
    # model-dim choice still applies on top
    return {
        "kv": P(None, None, ("data",) if "data" in names else None, None, None),
        "ssm_h": P(None, None, model_axis, None),
        "ssm_conv": P(None, None, None, model_axis),
        "rwkv_state": P(None, None, None, None, None),
        "rwkv_x": P(None, None, None),
    }


def cache_specs_tree(cache: Any, mesh: Mesh, *, batch: int, seq_sharded: bool) -> Any:
    table = cache_pspec(mesh, batch=batch, seq_sharded=seq_sharded)

    model_size = mesh_shape(mesh)["model"] if "model" in axis_names(mesh) else 1

    def pick(path, leaf):
        s = _path_str(path)
        nd = leaf.ndim
        if s.endswith(".k") or s.endswith(".v"):
            base = list(table["kv"])
            shape = tuple(leaf.shape)  # (periods, B, S, KVH, Dh)
            if model_size > 1 and base[2] != ("data",):
                kvh, dh = shape[3], shape[4]
                if kvh % model_size == 0:
                    base[3] = "model"  # best: fully local cache updates
                elif dh % model_size == 0:
                    base[4] = "model"  # local updates + score all-reduce
                elif shape[2] % model_size == 0:
                    base[2] = "model"  # SP fallback: update reshards
            elif model_size > 1 and base[2] == ("data",):
                # long-context: seq on data; add model on heads or head_dim
                kvh, dh = shape[3], shape[4]
                if kvh % model_size == 0:
                    base[3] = "model"
                elif dh % model_size == 0:
                    base[4] = "model"
            return P(*base)
        if s.endswith("_scale"):  # int8 KV scales: (periods, B, S)
            kv = table["kv"]
            return P(*kv[:nd])
        if s.endswith(".h"):
            return table["ssm_h"]
        if s.endswith(".conv"):
            return table["ssm_conv"]
        if s.endswith(".state"):
            return table["rwkv_state"]
        if s.endswith(".x_last"):
            return table["rwkv_x"]
        return P(*([None] * nd))

    flat = tree_util.flatten_with_path(cache)
    return tree_util.unflatten(cache, [pick(path, leaf) for path, leaf in flat])
