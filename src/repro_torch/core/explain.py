"""First-failure attribution for the batched path (DESIGN.md §12).

The batched executor computes per-row assertion failures anyway; the
opt-in explain pass argmaxes over them to emit one
``(schema location, keyword, instance JSON pointer)`` per invalid
document -- the batched counterpart of the sequential
``Validator.explain()``.  This module owns the *host-side* half:

- :class:`FailureSite`: the structured attribution record carried on
  ``Verdict.site`` (and rendered into ``Verdict.reason``).
- :func:`node_pointer`: BFS-order node index -> RFC 6901 JSON pointer,
  replaying exactly the deterministic traversal of
  ``data/doc_table.encode_document`` (queue pop-front, children
  appended in document order), so index ``i`` on the device maps back
  to a human-readable instance path without shipping strings to the
  accelerator.
- :func:`resolve_site`: tape provenance (``asrt_path`` /
  ``loc_required_info`` / ``loc_closed_path`` / ``circ_path``) +
  the explain launch's per-document picks -> a :class:`FailureSite`.

Tie-break contract (documented in DESIGN.md §12): the attributed
failure is the one at the lowest BFS node index (document order);
within one node, assertion-row failures beat missing-required beats
closed-object, and among assertion rows the **lowest assertion row
wins**; structural failures beat circuit (logical-applicator)
failures anchored at the same node, and among circuits the lowest
circuit id wins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

__all__ = ["FailureSite", "node_pointer", "keyword_of", "resolve_site"]

# failure kinds, ordered by attribution priority within one node
KIND_ASSERTION = 0
KIND_REQUIRED = 1
KIND_CLOSED = 2
KIND_CIRCUIT = 3


@dataclass(frozen=True)
class FailureSite:
    """One attributed validation failure.

    ``schema_path`` is the keyword location in the source schema (the
    compiler's ``schema_path`` provenance, e.g.
    ``"/properties/a/minLength"``), ``keyword`` its final segment,
    ``instance_path`` an RFC 6901 JSON pointer into the document (empty
    = root, or when no document was supplied to reconstruct it).
    """

    schema_path: str
    keyword: str
    instance_path: str = ""
    detail: str = ""

    def render(self) -> str:
        """Human-readable one-liner for ``Verdict.reason``."""
        at = self.instance_path or "/"
        msg = f"schema validation failed at {at!r}: {self.keyword or 'schema'}"
        if self.schema_path:
            msg += f" ({self.schema_path})"
        if self.detail:
            msg += f" -- {self.detail}"
        return msg


def _escape(tok: str) -> str:
    return tok.replace("~", "~0").replace("/", "~1")


def keyword_of(schema_path: str) -> str:
    """Final path segment = the violated keyword (``/a/minLength`` ->
    ``minLength``); empty paths stay empty."""
    if not schema_path:
        return ""
    return schema_path.rsplit("/", 1)[-1]


def node_pointer(doc: Any, index: int) -> str:
    """JSON pointer of BFS node ``index`` in ``doc``.

    Replays ``encode_document``'s traversal order exactly: one queue,
    pop from the front, children appended in document order (object
    entries in insertion order, array items in index order).  Stops as
    soon as the target index is dequeued, so cost is O(index + queued).
    """
    from ..core.doc_model import HashedObject

    if index <= 0:
        return ""
    # queue of (value, pointer)
    queue: List[Tuple[Any, str]] = [(doc, "")]
    count = 0
    while queue:
        value, ptr = queue.pop(0)
        if count == index:
            return ptr
        count += 1
        if isinstance(value, list):
            for j, item in enumerate(value):
                queue.append((item, f"{ptr}/{j}"))
        elif isinstance(value, HashedObject):
            for _, k, v in value.entries:
                queue.append((v, f"{ptr}/{_escape(k)}"))
        elif isinstance(value, dict):
            for k, v in value.items():
                queue.append((v, f"{ptr}/{_escape(k)}"))
    return ""


def _required_site(tape, loc: int, missing_mask: int) -> Tuple[str, str, str]:
    """(schema_path, keyword, detail) for a missing-required failure.

    The lowest set bit of the missing mask wins (slot allocation order =
    source order of the requiring keywords).
    """
    info = ()
    if 0 <= loc < len(tape.loc_required_info):
        info = tape.loc_required_info[loc]
    if missing_mask:
        lowest = (missing_mask & -missing_mask).bit_length() - 1
        for slot, key, path in info:
            if slot == lowest:
                return path, "required", f"missing property {key!r}"
    return "", "required", "missing required property"


def resolve_site(
    tape,
    *,
    kind: int,
    node: int,
    row: int = -1,
    loc: int = -1,
    parent_loc: int = -1,
    missing_mask: int = 0,
    circ: int = -1,
    doc: Any = None,
) -> FailureSite:
    """Map one explain-launch pick onto tape provenance.

    ``node`` is the failing node's in-document BFS index; the remaining
    operands are kind-specific (assertion row id / owner location /
    parent location / missing-required bitmask / circuit id).
    """
    instance = node_pointer(doc, node) if doc is not None else ""
    if kind == KIND_ASSERTION:
        path = ""
        if 0 <= row < len(tape.asrt_path):
            path = tape.asrt_path[row]
        return FailureSite(path, keyword_of(path), instance)
    if kind == KIND_REQUIRED:
        path, kw, detail = _required_site(tape, loc, missing_mask)
        return FailureSite(path, kw, instance, detail)
    if kind == KIND_CLOSED:
        path = ""
        if 0 <= parent_loc < len(tape.loc_closed_path):
            path = tape.loc_closed_path[parent_loc]
        return FailureSite(
            path,
            keyword_of(path) or "additionalProperties",
            instance,
            "unexpected property (closed object)",
        )
    # KIND_CIRCUIT: the originating logical applicator
    path = ""
    if 0 <= circ < len(tape.circ_path):
        path = tape.circ_path[circ]
    return FailureSite(path, keyword_of(path), instance)
