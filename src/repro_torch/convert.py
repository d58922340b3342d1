"""Carry a compiled tape, an encoded token table and LM weights across from
the JAX package.

For the validator the "weights" are the compiled location tape and the
encoded document table.  The port builds both itself from its own copy of
the front end; these helpers exist so that a test can hand the *same* tape,
table and LM parameters to both packages.  They take the reference objects
as plain numpy arrays and Python values (for example
``{f.name: getattr(tape, f.name) for f in dataclasses.fields(tape)}``, or
``jax.device_get(params)``), so this module needs nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .core.batch_executor import resolve_device
from .core.tape import LocationTape
from .data.doc_table import TokenTable
from .registry.linker import LinkedTape
from .train.optimizer import OptState

__all__ = ["tape_from_reference", "table_from_reference", "params_from_jax", "opt_state_from_jax"]


def _copy(value: Any) -> Any:
    return np.array(value, copy=True) if isinstance(value, np.ndarray) else value


def _build(cls, fields: Mapping[str, Any]):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {unknown}")
    return cls(**{k: _copy(v) for k, v in fields.items()})


def tape_from_reference(fields: Mapping[str, Any]) -> LocationTape:
    """The port's ``LocationTape`` (or ``LinkedTape`` when the fields carry
    a linked tape's ``members``) with the reference tape's arrays."""
    cls = LinkedTape if "members" in fields else LocationTape
    return _build(cls, fields)


def table_from_reference(fields: Mapping[str, Any]) -> TokenTable:
    """The port's ``TokenTable`` with the reference table's columns."""
    out: Dict[str, Any] = dict(fields)
    out["errors"] = dict(out.get("errors", {}))
    return _build(TokenTable, out)


def params_from_jax(tree: Mapping[str, Any], device=None, dtype=None) -> Dict[str, Any]:
    """The JAX ``Model.init`` tree, given as nested dicts of numpy arrays, as
    the port's tensors on ``device`` (cuda unless told otherwise), in
    ``dtype`` when given, else each leaf's own.

    A bfloat16 leaf reaches numpy as an ``ml_dtypes`` array that
    ``torch.from_numpy`` refuses; it goes through float32, which holds every
    bfloat16 value exactly, and back.
    """
    device = resolve_device(device)
    out: Dict[str, Any] = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[key] = params_from_jax(leaf, device, dtype)
            continue
        arr = np.asarray(leaf)
        want = dtype
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
            want = want or torch.bfloat16
        out[key] = torch.from_numpy(np.array(arr, copy=True)).to(device=device, dtype=want)
    return out


def opt_state_from_jax(state: Any, device=None, dtype=None):
    """The JAX optimizer's ``OptState(step, m, v)``, given as numpy values
    (``jax.device_get(state)``), as the port's ``OptState`` on ``device``
    (cuda unless told otherwise): ``step`` a 0-d int32 tensor, the moments
    as :func:`params_from_jax` carries parameters.  With both, the two
    packages start a step from the same parameters and Adam moments."""
    device = resolve_device(device)
    step, m, v = state
    return OptState(
        step=torch.as_tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        m=params_from_jax(m, device, dtype),
        v=params_from_jax(v, device, dtype),
    )
