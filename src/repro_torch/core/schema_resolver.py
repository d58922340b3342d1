"""``$ref`` / ``$id`` / ``$anchor`` / ``$dynamicRef`` resolution and dialect
detection (Blaze §3.3-§3.4).

The resolver indexes every embedded resource (``$id``), plain anchor and
dynamic anchor in the root schema plus any externally supplied resources,
then resolves reference URIs to (subschema, new base URI) pairs.  Dynamic
references with a *single* possible context are rewritten to static
references at resolution time (§3.4) -- zero validation-time cost.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urldefrag, urljoin

from .json_pointer import resolve_pointer


class Dialect(Enum):
    DRAFT4 = "draft4"
    DRAFT6 = "draft6"
    DRAFT7 = "draft7"
    DRAFT2019 = "2019-09"
    DRAFT2020 = "2020-12"


_DIALECT_URIS = {
    "http://json-schema.org/draft-04/schema": Dialect.DRAFT4,
    "http://json-schema.org/draft-06/schema": Dialect.DRAFT6,
    "http://json-schema.org/draft-07/schema": Dialect.DRAFT7,
    "https://json-schema.org/draft/2019-09/schema": Dialect.DRAFT2019,
    "https://json-schema.org/draft/2020-12/schema": Dialect.DRAFT2020,
}


def detect_dialect(schema: Any, default: Dialect = Dialect.DRAFT2020) -> Dialect:
    if isinstance(schema, dict):
        uri = schema.get("$schema")
        if isinstance(uri, str):
            return _DIALECT_URIS.get(uri.rstrip("#"), default)
    return default


@dataclass
class ResolvedRef:
    """A resolved reference destination."""

    schema: Any
    base_uri: str
    key: str  # canonical identity used for use-counting / labels


class SchemaResolver:
    """Static index over a schema document (+ external resources)."""

    def __init__(self, root: Any, resources: Optional[Dict[str, Any]] = None):
        self.root = root
        self.dialect = detect_dialect(root)
        # canonical URI -> (schema fragment, base uri at that fragment)
        self._ids: Dict[str, Tuple[Any, str]] = {}
        self._anchors: Dict[str, Tuple[Any, str]] = {}
        # dynamic anchor name -> list of (schema, base uri) contexts
        self._dynamic: Dict[str, List[Tuple[Any, str]]] = {}
        self.root_base = ""
        if isinstance(root, dict):
            self.root_base = root.get("$id", "") or ""
        self._index(root, self.root_base)
        for uri, res in (resources or {}).items():
            base = res.get("$id", uri) if isinstance(res, dict) else uri
            self._ids.setdefault(uri.rstrip("#"), (res, base))
            self._index(res, base)

    # -- indexing -----------------------------------------------------------

    def _index(self, node: Any, base: str) -> None:
        if isinstance(node, dict):
            new_id = node.get("$id")
            if isinstance(new_id, str) and new_id:
                base = urljoin(base, new_id)
                self._ids[urldefrag(base)[0] or base] = (node, base)
            anchor = node.get("$anchor")
            if isinstance(anchor, str):
                self._anchors[urljoin(base, "#" + anchor)] = (node, base)
            dyn = node.get("$dynamicAnchor")
            if isinstance(dyn, str):
                self._dynamic.setdefault(dyn, []).append((node, base))
                # a $dynamicAnchor also behaves as a plain $anchor
                self._anchors.setdefault(urljoin(base, "#" + dyn), (node, base))
            if node.get("$recursiveAnchor") is True:
                self._dynamic.setdefault("", []).append((node, base))
            for key, value in node.items():
                if key in ("enum", "const", "default", "examples"):
                    continue  # instance data, not schemas
                self._index(value, base)
        elif isinstance(node, list):
            for item in node:
                self._index(item, base)

    # -- resolution ---------------------------------------------------------

    def resolve(self, ref: str, base: str) -> ResolvedRef:
        """Resolve ``$ref`` value ``ref`` against base URI ``base``."""
        target = urljoin(base, ref) if base or not ref.startswith("#") else ref
        uri, fragment = urldefrag(target)

        if not uri:  # same-document reference
            doc, doc_base = self.root, self.root_base
        elif uri in self._ids:
            doc, doc_base = self._ids[uri]
        elif uri == urldefrag(self.root_base)[0]:
            doc, doc_base = self.root, self.root_base
        else:
            raise KeyError(f"unresolvable $ref {ref!r} (base {base!r})")

        if not fragment:
            return ResolvedRef(doc, doc_base, key=uri or "#root")
        if fragment.startswith("/"):
            frag_schema = resolve_pointer(doc, fragment)
            # the fragment may itself re-declare $id; track base changes
            new_base = doc_base
            if isinstance(frag_schema, dict) and isinstance(frag_schema.get("$id"), str):
                new_base = urljoin(doc_base, frag_schema["$id"])
            return ResolvedRef(frag_schema, new_base, key=f"{uri}#{fragment}")
        # named anchor
        anchor_uri = urljoin(uri or doc_base or "#", "#" + fragment)
        if anchor_uri in self._anchors:
            schema, abase = self._anchors[anchor_uri]
            return ResolvedRef(schema, abase, key=anchor_uri)
        # anchors registered without base
        if "#" + fragment in self._anchors:
            schema, abase = self._anchors["#" + fragment]
            return ResolvedRef(schema, abase, key="#" + fragment)
        raise KeyError(f"unresolvable anchor {ref!r} (base {base!r})")

    def resolve_dynamic(self, ref: str, base: str) -> ResolvedRef:
        """Resolve ``$dynamicRef`` -- static rewrite for single contexts (§3.4).

        When the dynamic anchor has exactly one possible context across all
        known resources, the reference is replaced by a static one.  With
        multiple contexts we fall back to the lexically innermost definition
        (correct for schemas that never override the anchor; documented
        limitation for the general PSPACE-complete case).
        """
        _, fragment = urldefrag(ref)
        contexts = self._dynamic.get(fragment, [])
        if len(contexts) == 1:
            schema, cbase = contexts[0]
            return ResolvedRef(schema, cbase, key=f"dynamic:{fragment}")
        return self.resolve(ref, base)

    def resolve_recursive(self, base: str) -> ResolvedRef:
        """2019-09 ``$recursiveRef: "#"`` -- same single-context treatment."""
        contexts = self._dynamic.get("", [])
        if len(contexts) == 1:
            schema, cbase = contexts[0]
            return ResolvedRef(schema, cbase, key="recursive:#")
        return ResolvedRef(self.root, self.root_base, key="#root")
