"""Pytree flattening in ``jax.tree_util`` order.

``jax.tree_util`` sorts dict keys when it flattens; ``torch.utils._pytree``
and ``nn.Module.named_parameters()`` keep insertion order.  Leaf order
fixes the ExchangePlan layout, the segment key tags and the noise each
bucket sees, so the port flattens every tree the way JAX does: dicts by
sorted key, lists and tuples in order, ``None`` as an empty subtree, any
other object as a leaf.
"""

from __future__ import annotations

from typing import Any


def tree_flatten(tree) -> tuple[list, Any]:
    """-> (leaves in JAX order, spec for :func:`tree_unflatten`)."""
    leaves: list = []

    def rec(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(rec(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node), tuple(rec(c) for c in node))
        leaves.append(node)
        return ("leaf",)

    spec = rec(tree)
    return leaves, spec


def tree_unflatten(spec, leaves) -> Any:
    it = iter(leaves)

    def rec(s):
        if s[0] == "none":
            return None
        if s[0] == "leaf":
            return next(it)
        if s[0] == "dict":
            return {k: rec(c) for k, c in zip(s[1], s[2])}
        return s[0](rec(c) for c in s[1])

    out = rec(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def path_sort_key(dotted: str) -> tuple:
    """Sort key of a ``named_parameters()`` path that reproduces the JAX
    flatten order of the same nested structure (dict keys sorted as
    strings, sequence indices as integers)."""
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in dotted.split("."))


def tree_map(fn, tree, *rest):
    """``fn`` applied leafwise over trees of the same structure."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])
