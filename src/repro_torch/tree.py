"""Nested parameter trees: dicts, lists and tuples of tensors.

The port's parameter, gradient and optimizer trees are plain containers
(``models/model.py``: dicts, with a list over layers). These helpers are
the few ``jax.tree`` functions the training path needs: leaves in a fixed
order (dict insertion order, then list order), a tree rebuilt around new
leaves, and each leaf's ``/``-joined path (``layers/3/mixer/wq/w``), the
key a checkpoint stores it under.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple


_END = object()


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return ((str(k), v) for k, v in tree.items())
    return ((str(i), v) for i, v in enumerate(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in leaf order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(tree_paths(child, f"{prefix}/{key}" if prefix else key))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    cols = [tree_leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])
