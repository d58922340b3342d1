"""JSON documents as columnar token tables (the TPU-native document form).

The paper's C++ executor chases pointers through a DOM; a TPU wants flat,
fixed-shape tensors.  We encode each parsed document as struct-of-arrays in
**BFS order**, which guarantees (a) a node's parent precedes it, and (b) the
children of every node are *contiguous* -- property matching and item loops
become range scans.  Key/string hashes are computed at encode time, exactly
as the paper computes hashes during parsing (§4.1).

Long-string caveat: the paper resolves long-string (>31 byte) hash
collisions with a full string comparison.  The batched executor cannot
pointer-chase into variable-length strings, so long strings additionally
carry a 64-bit FNV-1a hash in lanes 6-7 (which the paper's scheme leaves
zero).  A residual collision needs identical length, first/last byte, *and*
FNV64 -- probability ~2^-64.  The sequential executor remains the exact
conformance oracle.  This deviation is recorded in DESIGN.md §7.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.doc_model import HashedObject
from ..core.hashing import SHORT_LIMIT, hash_lanes, shash_bytes
from ..core.nodetypes import TYPE_CODES
from ..core.outcomes import fault_point
from ..obs.profile import phase as _phase, profiler_armed as _profiler_armed

__all__ = ["TokenTable", "encode_document", "encode_batch", "key_lanes", "TYPE_CODES"]

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _fnv64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def key_lanes(s: str) -> np.ndarray:
    """8x uint32 lanes for a key/string: the paper's semi-perfect hash, with
    FNV64 strengthening in lanes 6-7 for long strings (batch mode only)."""
    data = s.encode("utf-8")
    lanes = hash_lanes(shash_bytes(data))
    if len(data) > SHORT_LIMIT:
        fnv = _fnv64(data)
        lanes = lanes.copy()
        lanes[6] = (fnv >> 32) & 0xFFFFFFFF
        lanes[7] = fnv & 0xFFFFFFFF
    return lanes


def _str_prefix8(data: bytes) -> Tuple[int, int]:
    padded = data[:8].ljust(8, b"\x00")
    return (
        int.from_bytes(padded[:4], "big"),
        int.from_bytes(padded[4:], "big"),
    )


@dataclass
class TokenTable:
    """Columnar encoding of a batch of documents, shape (B, N) per column."""

    node_type: np.ndarray  # int8   (B, N)
    is_int: np.ndarray  # bool     (B, N)
    num: np.ndarray  # float64    (B, N)   numeric value / bool as 0,1
    size: np.ndarray  # int32     (B, N)   str bytes / arr len / obj props
    parent: np.ndarray  # int32   (B, N)   -1 for root
    depth: np.ndarray  # int32    (B, N)
    idx_in_parent: np.ndarray  # int32 (B, N)  array index or object slot
    child_start: np.ndarray  # int32 (B, N)  BFS-contiguous children
    key_hash: np.ndarray  # uint32 (B, N, 8)  hash of member key (else 0)
    str_hash: np.ndarray  # uint32 (B, N, 8)  hash of string value (else 0)
    str_prefix: np.ndarray  # uint32 (B, N, 2)  first 8 bytes of string value
    str_last: np.ndarray  # uint32 (B, N)  last byte of string value
    n_nodes: np.ndarray  # int32  (B,)
    ok: np.ndarray  # bool (B,)  encoded within budget
    # row index -> error message for rows whose *encode* raised (isolated
    # faults, not budget overflows); those rows also have ok=False.
    errors: Dict[int, str] = field(default_factory=dict)

    @property
    def batch(self) -> int:
        return self.node_type.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_type.shape[1]

    def columns(self) -> Dict[str, np.ndarray]:
        return {
            "node_type": self.node_type,
            "is_int": self.is_int,
            "num": self.num,
            "size": self.size,
            "parent": self.parent,
            "depth": self.depth,
            "idx_in_parent": self.idx_in_parent,
            "child_start": self.child_start,
            "key_hash": self.key_hash,
            "str_hash": self.str_hash,
            "str_prefix": self.str_prefix,
            "str_last": self.str_last,
            "n_nodes": self.n_nodes,
            "ok": self.ok,
        }

    def take(self, rows: Sequence[int]) -> "TokenTable":
        """Row-slice a sub-batch (used by the bisecting launch isolator)."""
        idx = np.asarray(rows, np.int64)
        cols = {k: v[idx] for k, v in self.columns().items()}
        remap = {int(r): j for j, r in enumerate(idx)}
        errs = {remap[r]: m for r, m in self.errors.items() if r in remap}
        return TokenTable(errors=errs, **cols)


def _items_of(value: Any):
    if isinstance(value, HashedObject):
        return value.items()
    return list(value.items())


def encode_document(
    doc: Any,
    max_nodes: int = 256,
    max_depth: int = 16,
    hash_fn: Callable[[str], np.ndarray] = key_lanes,
) -> Optional[Dict[str, np.ndarray]]:
    """Encode one parsed JSON value into single-document columns (N,).

    Returns None when the document exceeds the node or depth budget
    (callers fall back to the sequential executor).  ``hash_fn``
    computes the 8-lane key/string hash; an armed profiler swaps in a
    timed wrapper (``encode_batch``) so the walk/hash split is
    attributable without taxing the disarmed path.
    """
    cols = {
        "node_type": np.zeros(max_nodes, np.int8),
        "is_int": np.zeros(max_nodes, bool),
        "num": np.zeros(max_nodes, np.float64),
        "size": np.zeros(max_nodes, np.int32),
        "parent": np.full(max_nodes, -1, np.int32),
        "depth": np.zeros(max_nodes, np.int32),
        "idx_in_parent": np.full(max_nodes, -1, np.int32),
        "child_start": np.zeros(max_nodes, np.int32),
        "key_hash": np.zeros((max_nodes, 8), np.uint32),
        "str_hash": np.zeros((max_nodes, 8), np.uint32),
        "str_prefix": np.zeros((max_nodes, 2), np.uint32),
        "str_last": np.zeros(max_nodes, np.uint32),
    }
    # BFS queue of (value, parent_idx, depth, key(str|None), idx_in_parent)
    queue: List[Tuple[Any, int, int, Optional[str], int]] = [(doc, -1, 0, None, -1)]
    count = 0
    while queue:
        value, parent, depth, key, idx = queue.pop(0)
        if count >= max_nodes or depth > max_depth:
            return None
        i = count
        count += 1
        cols["parent"][i] = parent
        cols["depth"][i] = depth
        cols["idx_in_parent"][i] = idx
        if key is not None:
            cols["key_hash"][i] = hash_fn(key)
        if value is None:
            cols["node_type"][i] = TYPE_CODES["null"]
        elif isinstance(value, bool):
            cols["node_type"][i] = TYPE_CODES["boolean"]
            cols["num"][i] = 1.0 if value else 0.0
        elif isinstance(value, (int, float)):
            cols["node_type"][i] = TYPE_CODES["number"]
            cols["num"][i] = float(value)
            cols["is_int"][i] = (
                isinstance(value, int) or float(value).is_integer()
            )
        elif isinstance(value, str):
            data = value.encode("utf-8")
            cols["node_type"][i] = TYPE_CODES["string"]
            cols["size"][i] = len(value)  # code points, matching len(str)
            cols["str_hash"][i] = hash_fn(value)
            p0, p1 = _str_prefix8(data)
            cols["str_prefix"][i] = (p0, p1)
            cols["str_last"][i] = data[-1] if data else 0
        elif isinstance(value, list):
            cols["node_type"][i] = TYPE_CODES["array"]
            cols["size"][i] = len(value)
            cols["child_start"][i] = count + len(queue)
            for j, item in enumerate(value):
                queue.append((item, i, depth + 1, None, j))
        elif isinstance(value, (dict, HashedObject)):
            items = _items_of(value)
            cols["node_type"][i] = TYPE_CODES["object"]
            cols["size"][i] = len(items)
            cols["child_start"][i] = count + len(queue)
            for j, (k, v) in enumerate(items):
                queue.append((v, i, depth + 1, k, j))
        else:
            raise TypeError(f"unsupported JSON value {type(value)!r}")
    cols["n_nodes"] = np.int32(count)
    return cols


def encode_batch(
    docs: List[Any],
    max_nodes: int = 256,
    max_depth: int = 16,
    *,
    isolate: bool = False,
    keys: Optional[Sequence[Any]] = None,
) -> TokenTable:
    """Encode a batch of documents; oversize docs get ok=False rows.

    With ``isolate=True`` a per-document encode exception (including an
    injected ``"encode"`` fault and ``RecursionError`` on hostile
    nesting) is trapped into ``TokenTable.errors[row]`` instead of
    aborting the whole batch; the poisoned row becomes an all-zero
    ok=False row, so every other row encodes bit-identically to a
    poison-free run.  ``keys`` names each row at the fault seam
    (defaults to the row index).
    """
    batch = len(docs)
    stacked: Dict[str, List[np.ndarray]] = {}
    ok = np.ones(batch, bool)
    n_nodes = np.zeros(batch, np.int32)
    errors: Dict[int, str] = {}
    template = encode_document(None, max_nodes)
    zero_cols = None
    # armed profiler: walk vs hash attribution (encode.hash nests inside
    # encode.walk, so exclusive times split the encode tax); disarmed,
    # hash_fn stays the raw key_lanes and the per-key path pays nothing
    if _profiler_armed():
        def hash_fn(s: str) -> np.ndarray:
            with _phase("encode.hash"):
                return key_lanes(s)
    else:
        hash_fn = key_lanes
    for b, doc in enumerate(docs):
        with _phase("encode.walk"):
            if isolate:
                try:
                    fault_point("encode", keys[b] if keys is not None else b)
                    cols = encode_document(doc, max_nodes, max_depth, hash_fn)
                except RecursionError:
                    errors[b] = "encode recursion limit exceeded"
                    cols = None
                except Exception as exc:  # isolated per-document fault
                    errors[b] = f"{type(exc).__name__}: {exc}"
                    cols = None
            else:
                cols = encode_document(doc, max_nodes, max_depth, hash_fn)
        if cols is None:
            ok[b] = False  # budget overflow (fallback) or isolated error row
            if zero_cols is None:
                zero_cols = {
                    k: np.zeros_like(v)
                    for k, v in template.items()
                    if k != "n_nodes"
                }
            cols = dict(zero_cols)
            cols["n_nodes"] = np.int32(0)
        n_nodes[b] = cols.pop("n_nodes")
        for k, v in cols.items():
            stacked.setdefault(k, []).append(v)
    with _phase("encode.pack"):
        arrays = {k: np.stack(v) for k, v in stacked.items()}
    return TokenTable(n_nodes=n_nodes, ok=ok, errors=errors, **arrays)
