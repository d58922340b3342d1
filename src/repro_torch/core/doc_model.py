"""Parsed-document model used by the sequential executor (Blaze §4.1/§4.5).

Keys are hashed *at parse time* (the paper stores the semi-perfect hash
while parsing) and objects are stored as a flat vector of entries rather
than a hash map: "documents generally have a small number [of] keys ...
looping over the small number of entries is more efficient than dealing
with the indirection inherent in hash tables" (§4.1).
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Tuple

from .hashing import is_short_hash, shash

__all__ = ["HashedObject", "parse_document", "json_type", "json_equal", "canonical"]

_MISS = object()


class HashedObject:
    """A JSON object as a vector of (hash, key, value) entries."""

    __slots__ = ("entries",)

    def __init__(self, entries: List[Tuple[int, str, Any]]):
        self.entries = entries

    # -- container protocol -------------------------------------------------

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[str]:
        return (k for _, k, _ in self.entries)

    def keys(self):
        return [k for _, k, _ in self.entries]

    def values(self):
        return [v for _, _, v in self.entries]

    def items(self):
        return [(k, v) for _, k, v in self.entries]

    # -- hash-accelerated lookup (Blaze §4.1) --------------------------------

    def get_hashed(self, key_hash: int, key: str, default: Any = None) -> Any:
        """Lookup by precomputed hash: short keys never compare strings."""
        if is_short_hash(key_hash):
            for h, _, v in self.entries:
                if h == key_hash:
                    return v
            return default
        for h, k, v in self.entries:
            if h == key_hash and k == key:
                return v
        return default

    def defines_hashed(self, key_hash: int, key: str) -> bool:
        return self.get_hashed(key_hash, key, _MISS) is not _MISS

    def get_item(self, key: str, default: Any = None) -> Any:
        """Plain-string lookup (used by generic instance-path resolution)."""
        return self.get_hashed(shash(key), key, default)

    def __repr__(self) -> str:
        return f"HashedObject({dict(self.items())!r})"


def parse_document(value: Any) -> Any:
    """Convert plain parsed JSON into the executor's document model.

    This is the parse stage: hashing happens here, once, not during
    validation (§4.1: "we store the hash of strings as part of the process
    of parsing documents").
    """
    if isinstance(value, dict):
        return HashedObject(
            [(shash(k), k, parse_document(v)) for k, v in value.items()]
        )
    if isinstance(value, list):
        return [parse_document(v) for v in value]
    return value


# ---------------------------------------------------------------------------
# JSON semantics helpers
# ---------------------------------------------------------------------------


def json_type(value: Any) -> str:
    """The JSON type name of a value ('integer' for whole numbers)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, int):
        return "integer"
    if isinstance(value, float):
        return "integer" if value.is_integer() else "number"
    if isinstance(value, str):
        return "string"
    if isinstance(value, list):
        return "array"
    return "object"


def has_type(value: Any, t: str) -> bool:
    """Type check per 2020-12 semantics (1.0 is an integer; bool is not)."""
    if t == "integer":
        if isinstance(value, bool):
            return False
        return isinstance(value, int) or (isinstance(value, float) and value.is_integer())
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t == "string":
        return isinstance(value, str)
    if t == "object":
        return isinstance(value, (dict, HashedObject))
    if t == "array":
        return isinstance(value, list)
    if t == "boolean":
        return isinstance(value, bool)
    if t == "null":
        return value is None
    return False


def json_equal(a: Any, b: Any) -> bool:
    """Deep JSON equality: 1 == 1.0, but True != 1 and 0 != False."""
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b if isinstance(a, bool) and isinstance(b, bool) else False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(json_equal(x, y) for x, y in zip(a, b))
    a_obj = isinstance(a, (dict, HashedObject))
    b_obj = isinstance(b, (dict, HashedObject))
    if a_obj and b_obj:
        a_items = a.items() if isinstance(a, HashedObject) else list(a.items())
        b_map = dict(b.items()) if isinstance(b, HashedObject) else b
        if len(a_items) != len(b_map):
            return False
        for k, v in a_items:
            if k not in b_map or not json_equal(v, b_map[k]):
                return False
        return True
    return False


def canonical(value: Any) -> Any:
    """Hashable canonical form (uniqueItems in O(n) via a set).

    Must agree with :func:`json_equal` pairwise semantics: numbers keep
    their native type (Python's cross-type ``==``/``hash`` already make
    ``1`` and ``1.0`` collide) instead of coercing through ``float``,
    which would merge distinct integers past 2**53 -- ``[2**53, 2**53+1]``
    has no duplicate.
    """
    if isinstance(value, bool):
        return ("b", value)
    if isinstance(value, (int, float)):
        return ("n", value)
    if isinstance(value, str):
        return ("s", value)
    if value is None:
        return ("z",)
    if isinstance(value, list):
        return ("a", tuple(canonical(v) for v in value))
    items = value.items() if isinstance(value, HashedObject) else value.items()
    return ("o", tuple(sorted((k, canonical(v)) for k, v in items)))
