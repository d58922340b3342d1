"""Carry a compiled tape and an encoded token table across from the JAX package.

For this system the "weights" are the compiled location tape and the
encoded document table.  The port builds both itself from its own copy of
the front end; these helpers exist so that a test can hand the *same* tape
and table to both executors.  They take the reference objects' fields as a
plain mapping of numpy arrays and Python values (for example
``{f.name: getattr(tape, f.name) for f in dataclasses.fields(tape)}``), so
this module needs nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np

from .core.tape import LocationTape
from .data.doc_table import TokenTable
from .registry.linker import LinkedTape

__all__ = ["tape_from_reference", "table_from_reference"]


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
