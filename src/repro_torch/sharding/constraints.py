"""In-model activation sharding constraints.

Eager DTensor ops are free to pick the placement of an intermediate
(a replicated operand propagates).  Production frameworks pin activations
at layer boundaries; we do the same with a context: step builders install
the mesh + batch axes, and the model calls :func:`constrain` at the few
points that matter (embedding output, period carry, logits).  Inside the
context a constraint redistributes a DTensor to the spec's placements (the
JAX package's ``with_sharding_constraint``).  When no context is installed
(single-device runs), or the activation is a plain tensor, the calls are
no-ops.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .rules import Mesh, PartitionSpec as P, axis_names, mesh_shape, placements

_CTX: contextvars.ContextVar[Optional["ActivationCtx"]] = contextvars.ContextVar(
    "activation_sharding", default=None
)


class ActivationCtx:
    def __init__(self, mesh: Mesh, batch_axes: Tuple[str, ...], vocab_axis: Optional[str]):
        self.mesh = mesh
        self.batch_axes = batch_axes
        self.vocab_axis = vocab_axis
        self.axis_names = axis_names(mesh)
        self.shape = mesh_shape(mesh)


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, *, batch: int, vocab: int):
    """Install activation constraints for the duration of a step."""
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    b_axes = tuple(a for a in ("pod", "data") if a in names)
    total = 1
    for a in b_axes:
        total *= sizes[a]
    if total and batch % total != 0:
        b_axes = b_axes[1:]
        total = 1
        for a in b_axes:
            total *= sizes[a]
        if b_axes and batch % total != 0:
            b_axes = ()
    vocab_axis = "model" if "model" in names else None
    if vocab_axis is not None and vocab % sizes["model"] != 0:
        vocab_axis = None
    token = _CTX.set(ActivationCtx(mesh, b_axes, vocab_axis))
    try:
        yield
    finally:
        _CTX.reset(token)


def _wsc(x, spec: P):
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


def constrain_bsd(x, *, seq_shard: bool = False):
    """(batch, seq, d_model) activations: batch on the DP axes.

    ``seq_shard=True`` additionally shards the sequence dim on ``model``
    (Megatron sequence parallelism).  Applied to the period carry it divides
    the saved-activation stack (L, B, S, D) by the model-axis size.  Skipped
    automatically when seq is not divisible (decode).
    """
    ctx = _CTX.get()
    if ctx is None:
        return x
    batch = ctx.batch_axes if ctx.batch_axes else None
    seq_axis = None
    if (
        seq_shard
        and x.ndim >= 3
        and "model" in ctx.axis_names
        and x.shape[1] % ctx.shape["model"] == 0
        and x.shape[1] >= ctx.shape["model"]
    ):
        seq_axis = "model"
    return _wsc(x, P(batch, seq_axis, *([None] * (x.ndim - 2))))


def model_axis_divides(dim: int) -> bool:
    """True when ``dim`` is divisible by the installed mesh's model axis
    (False when no context/mesh: callers then skip the constraint)."""
    ctx = _CTX.get()
    if ctx is None or "model" not in ctx.axis_names:
        return False
    return dim % ctx.shape["model"] == 0


def constrain(x, *spec):
    """Explicit PartitionSpec constraint under the installed mesh.

    Axis entries that do not divide the corresponding dim are dropped
    (same divisibility fallback as the parameter rules); no-op when no
    activation context is installed.
    """
    ctx = _CTX.get()
    if ctx is None:
        return x
    checked = []
    for dim, axis in enumerate(spec):
        if axis is None:
            checked.append(None)
            continue
        if axis == "batch":
            axis = ctx.batch_axes if ctx.batch_axes else None
            checked.append(axis)
            continue
        size = ctx.shape[axis] if axis in ctx.axis_names else 0
        checked.append(axis if size and x.shape[dim] % size == 0 else None)
    return _wsc(x, P(*checked))


def constrain_logits(x):
    """(batch, seq, vocab): batch on DP axes, vocab on model when divisible."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    batch = ctx.batch_axes if ctx.batch_axes else None
    return _wsc(x, P(batch, None, ctx.vocab_axis))


class _Replicated(torch.autograd.Function):
    """A redistribution whose gradient keeps the placements it arrives
    with: the backward of the view that follows then needs no uneven split
    either (``DTensor.redistribute`` would send the gradient back to the
    unsplittable layout)."""

    @staticmethod
    def forward(ctx, x, new):
        return x.redistribute(x.device_mesh, new)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def constrain_split(x, dim: int, parts: int):
    """``x`` ready for a reshape that splits dimension ``dim`` into
    ``parts`` major parts (heads, head groups).

    GSPMD reshards around such a reshape by itself; a DTensor view only
    splits a sharded dimension evenly.  So the mesh axes that shard ``dim``
    are replicated here from the first whose running size stops dividing
    ``parts``, in the forward pass and in the backward.  The port's own
    call, with no counterpart in the reference; a no-op outside a context
    or on a plain tensor.
    """
    if _CTX.get() is None or not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh = x.device_mesh
    new = list(x.placements)
    size = 1
    for i, p in enumerate(new):
        if isinstance(p, Shard) and p.dim == dim:
            if parts % (size * mesh.size(i)):
                new[i] = Replicate()
            else:
                size *= mesh.size(i)
    if new == list(x.placements):
        return x
    return _Replicated.apply(x, tuple(new))


def logits_pspec_ctx() -> Optional[P]:
    ctx = _CTX.get()
    if ctx is None:
        return None
    batch = ctx.batch_axes if ctx.batch_axes else None
    return P(batch, None, ctx.vocab_axis)
