"""Leaves of the port's parameter trees (nested dicts and lists of tensors)
in the JAX package's order: dict keys sorted, lists in order."""
from __future__ import annotations

from typing import Any


def leaves(tree: Any) -> list:
    """The tensors of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def unflatten(like: Any, flat: list) -> Any:
    """A tree shaped like ``like`` holding ``flat`` (in ``leaves`` order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}        # the caller's order
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
