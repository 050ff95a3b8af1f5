"""Nested-dict trees of tensors in ``jax.tree``'s leaf order.

``repro`` keeps parameters, optimizer moments, gradients and metrics in
nested dicts and walks them with ``jax.tree``, which visits dict keys in
sorted order.  The optimizer, the gradient bucketing and the gradient
sync of this package walk the same trees in the same order through
:func:`tree_flatten`, so per-leaf work (and the dataplane ops it issues)
comes in ``repro``'s order.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_flatten(tree, prefix: tuple[str, ...] = ()) -> list[tuple]:
    """``(path, leaf)`` pairs of a nested dict, keys sorted at every
    level; ``path`` is the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        out: list[tuple] = []
        for key in sorted(tree):
            out += tree_flatten(tree[key], prefix + (key,))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(paths, leaves) -> dict:
    """The nested dict holding ``leaves`` at ``paths``."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of each
    tree in ``rest``), in the same nesting."""
    pairs = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    return tree_unflatten([p for p, _ in pairs],
                          [fn(leaf, *(o[i] for o in others))
                           for i, (_, leaf) in enumerate(pairs)])


__all__ = ["tree_flatten", "tree_leaves", "tree_unflatten", "tree_map"]
