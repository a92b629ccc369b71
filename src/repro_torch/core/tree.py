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
    return leaves, _flatten(tree, leaves)


def _flatten(node, leaves: list):
    # module-level recursion: a nested recursive closure would form a
    # reference cycle holding ``leaves`` (the tensors) until the cyclic gc
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), tuple(_flatten(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node), tuple(_flatten(c, leaves) for c in node))
    leaves.append(node)
    return ("leaf",)


def tree_unflatten(spec, leaves) -> Any:
    it = iter(leaves)
    out = _unflatten(spec, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def _unflatten(s, it):
    if s[0] == "none":
        return None
    if s[0] == "leaf":
        return next(it)
    if s[0] == "dict":
        return {k: _unflatten(c, it) for k, c in zip(s[1], s[2])}
    return s[0](_unflatten(c, it) for c in s[1])


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
