"""Canonical serialization and structural hashing of schemas.

Two schemas that are structurally identical after key ordering and
numeric normalization hash equal, which is what the registry's
subgraph dedup and the subsumption fast path key on.  The hash is
*syntactic* (post-normalization): it never claims semantic
equivalence beyond what byte-identical canonical forms give.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Iterator, List, Tuple

__all__ = ["canonical_json", "structural_hash", "subschema_hashes"]


def _normalize(value: Any) -> Any:
    """Fold int-valued floats to ints so 1.0 and 1 serialize alike
    (matching ``json_equal`` semantics in core.doc_model)."""
    if isinstance(value, bool):
        return value
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, dict):
        return {k: _normalize(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_normalize(v) for v in value]
    return value


# Keys that can never influence validation in this repo's compiler or
# interpreter -- stripped before hashing so two schemas differing only
# in prose hash equal (and may share a linked segment).  ``format`` CAN
# assert under ``CompilerOptions.format_assertion`` and identifier /
# definition keys ($id, $anchor, $defs, ...) steer $ref resolution, so
# all of those stay in the hash.
_PURE_ANNOTATIONS = frozenset(
    {
        "title",
        "description",
        "$comment",
        "examples",
        "example",
        "default",
        "deprecated",
        "readOnly",
        "writeOnly",
        "contentMediaType",
        "contentEncoding",
    }
)


def _strip(schema: Any) -> Any:
    """Drop pure-annotation keys, recursing only into *schema
    positions* (a property NAMED "description" is data, not prose)."""
    if not isinstance(schema, dict):
        return schema
    out: Dict[str, Any] = {}
    for key, value in schema.items():
        if key in _PURE_ANNOTATIONS:
            continue
        if key in _SINGLE or (key == "items" and not isinstance(value, list)):
            out[key] = _strip(value)
        elif key in _LISTS or (key == "items" and isinstance(value, list)):
            out[key] = [_strip(v) for v in value] if isinstance(value, list) else _strip(value)
        elif key in _MAPS and isinstance(value, dict):
            out[key] = {k: _strip(v) for k, v in value.items()}
        else:
            out[key] = value
    return out


def canonical_json(schema: Any) -> str:
    """Deterministic serialization: sorted keys, no whitespace,
    int-valued floats folded, pure annotations stripped."""
    return json.dumps(_normalize(_strip(schema)), sort_keys=True, separators=(",", ":"))


def structural_hash(schema: Any) -> str:
    """Stable short digest of the canonical serialization."""
    return hashlib.blake2b(canonical_json(schema).encode("utf-8"), digest_size=16).hexdigest()


# Keyword positions holding a single subschema.
_SINGLE = (
    "additionalProperties",
    "unevaluatedProperties",
    "unevaluatedItems",
    "items",
    "additionalItems",
    "contains",
    "propertyNames",
    "not",
    "if",
    "then",
    "else",
)
# Keyword positions holding a list of subschemas.
_LISTS = ("allOf", "anyOf", "oneOf", "prefixItems")
# Keyword positions holding a map of subschemas.
_MAPS = ("properties", "patternProperties", "dependentSchemas", "$defs", "definitions")


def iter_subschemas(schema: Any, path: str = "#") -> Iterator[Tuple[str, Any]]:
    """Yield (json-pointer-ish path, subschema) for every schema
    position reachable from ``schema``, including itself."""
    if isinstance(schema, bool):
        yield path, schema
        return
    if not isinstance(schema, dict):
        return
    yield path, schema
    for kw in _SINGLE:
        if kw in schema:
            yield from iter_subschemas(schema[kw], f"{path}/{kw}")
    # draft-04 style `items: [..]` is a positional list
    items = schema.get("items")
    if isinstance(items, list):
        for i, sub in enumerate(items):
            yield from iter_subschemas(sub, f"{path}/items/{i}")
    for kw in _LISTS:
        subs = schema.get(kw)
        if isinstance(subs, list):
            for i, sub in enumerate(subs):
                yield from iter_subschemas(sub, f"{path}/{kw}/{i}")
    for kw in _MAPS:
        subs = schema.get(kw)
        if isinstance(subs, dict):
            for key, sub in subs.items():
                yield from iter_subschemas(sub, f"{path}/{kw}/{key}")


def subschema_hashes(schema: Any, *, min_size: int = 2) -> Dict[str, List[str]]:
    """Map structural hash -> paths of every *non-trivial* subschema.

    ``min_size`` filters out leaves (bare ``{"type": "string"}`` etc.)
    that would otherwise dominate the dedup report with noise: a
    subgraph only counts when it carries at least ``min_size`` keys.
    """
    out: Dict[str, List[str]] = {}
    for path, sub in iter_subschemas(schema):
        if not isinstance(sub, dict) or len(sub) < min_size:
            continue
        out.setdefault(structural_hash(sub), []).append(path)
    return out
