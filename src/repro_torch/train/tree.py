"""Nested parameter and optimizer-state trees, flattened in JAX's order.

The JAX package walks its trees with ``jax.tree_util``: dict keys sorted,
``NamedTuple`` fields and sequence items in order, ``None`` an empty
subtree, anything else a leaf.  The optimizer's global norm sums leaves in
that order and checkpoints name leaves by their paths, so the port walks
its trees the same way.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


class Attr(str):
    """A ``NamedTuple`` field on a path; prints as JAX's ``GetAttrKey``
    (``.name``)."""

    def __str__(self) -> str:
        return "." + str.__str__(self)


Path = Tuple[Any, ...]
_END = object()


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_path(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``[(path, leaf)]`` in JAX's leaf order.  A path holds dict keys,
    :class:`Attr` field names and sequence indices."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += flatten_with_path(tree[key], prefix + (key,))
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += flatten_with_path(getattr(tree, name), prefix + (Attr(name),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += flatten_with_path(item, prefix + (i,))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves, in JAX's order, are
    ``new_leaves``."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def _rebuild(node: Any, it: Iterator[Any]) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        built = {key: _rebuild(node[key], it) for key in sorted(node)}
        return {key: built[key] for key in node}  # the caller's key order
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(getattr(node, f), it) for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(item, it) for item in node)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree has") from None


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest at the same place)`` over ``tree``."""
    flat = leaves(tree)
    others = [leaves(t) for t in rest]
    for other in others:
        if len(other) != len(flat):
            raise ValueError(f"trees differ: {len(flat)} and {len(other)} leaves")
    return unflatten(tree, [fn(leaf, *(o[i] for o in others)) for i, leaf in enumerate(flat)])
