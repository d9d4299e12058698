"""Trees of tensors: nested dicts, tuples and lists whose leaves are tensors
(or arrays, or scalars).

Counterpart of the reference's ``utils/tree.py``.  Dict leaves are visited
in sorted key order and sequences in order, as ``jax.tree.leaves`` visits
them, so a port tree and a JAX tree of the same structure list their
leaves one for one.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

_SEQUENCES = (tuple, list)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf-wise to ``tree`` and the trees in ``rest``, which
    share its structure; returns a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, _SEQUENCES):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree``: dict keys in sorted order, sequences in
    order."""
    return list(_iter_leaves(tree))


def _iter_leaves(tree: Any) -> Iterator:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k])
    elif isinstance(tree, _SEQUENCES):
        for v in tree:
            yield from _iter_leaves(v)
    else:
        yield tree


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, _SEQUENCES):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_size(tree: Any) -> int:
    """Total number of scalars in the tree."""
    return sum(int(leaf.numel()) if hasattr(leaf, "numel")
               else int(leaf.size) for leaf in tree_leaves(tree))
