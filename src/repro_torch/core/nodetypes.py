"""Canonical node-type codes for the columnar document encoding.

Single source of truth for the integer codes shared by the token-table
encoder (``data.doc_table``), the batched executor
(``core.batch_executor``), the tape builder (``core.tape``) and both
assertion kernels (``kernels.assertion_eval`` / ``kernels.ref``).  These
used to be mirrored as private constants in each module; keeping them here
means the codes cannot drift.

The codes double as bit positions in the TYPE_MASK assertion op:
``type_bit(t) = 1 << code(t)``.
"""

from __future__ import annotations

__all__ = [
    "T_PAD",
    "T_NULL",
    "T_BOOL",
    "T_NUM",
    "T_STR",
    "T_ARR",
    "T_OBJ",
    "TYPE_CODES",
    "TYPE_BIT",
]

T_PAD = 0
T_NULL = 1
T_BOOL = 2
T_NUM = 3
T_STR = 4
T_ARR = 5
T_OBJ = 6

# name -> code, as stored in TokenTable.node_type
TYPE_CODES = {
    "pad": T_PAD,
    "null": T_NULL,
    "boolean": T_BOOL,
    "number": T_NUM,
    "string": T_STR,
    "array": T_ARR,
    "object": T_OBJ,
}

# name -> TYPE_MASK bit (JSON types only; no bit for padding)
TYPE_BIT = {
    "null": 1 << T_NULL,
    "boolean": 1 << T_BOOL,
    "number": 1 << T_NUM,
    "string": 1 << T_STR,
    "array": 1 << T_ARR,
    "object": 1 << T_OBJ,
}
