"""RFC 6901 JSON Pointers and relative instance locations.

Schema locations (for ``$ref`` resolution and error reporting) use standard
JSON Pointer strings.  Instance locations inside compiled instructions are
tuples of tokens (str for object keys, int for array indices) *relative to
the parent instruction* -- Blaze §5.1.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple, Union

Token = Union[str, int]
InstancePath = Tuple[Token, ...]

_MISSING = object()


def escape(token: str) -> str:
    """Escape a reference token per RFC 6901 (~ -> ~0, / -> ~1)."""
    return token.replace("~", "~0").replace("/", "~1")


def unescape(token: str) -> str:
    """Unescape a reference token per RFC 6901 (order matters: ~1 first)."""
    return token.replace("~1", "/").replace("~0", "~")


def parse_pointer(pointer: str) -> Tuple[str, ...]:
    """Split a JSON Pointer string into unescaped tokens."""
    if pointer == "":
        return ()
    if not pointer.startswith("/"):
        raise ValueError(f"invalid JSON pointer: {pointer!r}")
    return tuple(unescape(tok) for tok in pointer[1:].split("/"))


def format_pointer(tokens: Iterable[Token]) -> str:
    """Render tokens back into a JSON Pointer string."""
    return "".join("/" + escape(str(tok)) for tok in tokens)


def resolve_pointer(document: Any, pointer: str) -> Any:
    """Resolve a JSON Pointer against a plain-dict/list document.

    Raises ``KeyError`` when the pointer does not exist -- used for ``$ref``
    resolution where a dangling pointer is a schema bug.
    """
    node = document
    for tok in parse_pointer(pointer):
        if isinstance(node, dict):
            if tok not in node:
                raise KeyError(f"pointer token {tok!r} not found ({pointer!r})")
            node = node[tok]
        elif isinstance(node, list):
            try:
                idx = int(tok)
            except ValueError as exc:
                raise KeyError(f"non-integer index {tok!r} ({pointer!r})") from exc
            if not 0 <= idx < len(node):
                raise KeyError(f"index {idx} out of range ({pointer!r})")
            node = node[idx]
        else:
            raise KeyError(f"cannot descend into scalar at {tok!r} ({pointer!r})")
    return node


def get_instance(value: Any, path: InstancePath) -> Any:
    """Resolve a relative instance path; returns ``MISSING`` when absent.

    Instructions whose target is absent are skipped (vacuously true) --
    requiredness is asserted separately via ``AssertionDefines``.
    """
    node = value
    for tok in path:
        if isinstance(tok, str):
            # Instance objects are stored as HashedObject (vector of
            # entries) by the executor; support both plain dicts and the
            # executor's representation via duck typing.
            getter = getattr(node, "get_item", None)
            if getter is not None:
                node = getter(tok, _MISSING)
            elif isinstance(node, dict):
                node = node.get(tok, _MISSING)
            else:
                return _MISSING
            if node is _MISSING:
                return _MISSING
        else:
            if not isinstance(node, list) or not 0 <= tok < len(node):
                return _MISSING
            node = node[tok]
    return node


MISSING = _MISSING
