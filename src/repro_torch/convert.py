"""Parameter exchange with the JAX reference, through numpy.

The two packages' init generators cannot give equal weights, so parity
checks start both sides from the same numpy parameters: a JAX params
pytree converted leaf by leaf with ``np.asarray`` goes into a port model
with :func:`params_from_jax`, and :func:`params_to_jax` gives the inverse
tree (nested dicts and tuples, the reference's structure).  Leaves are
matched in JAX flatten order and checked by shape.
:func:`gan_params_from_jax` and :func:`gan_params_to_jax` do the same for
the WGAN-GP testbed's generator and critic (:class:`repro_torch.gan.wgan.WGAN`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten


def _tree_of(model) -> dict:
    """The model's parameters as the reference's nested structure (a
    ModuleList index becomes a tuple position)."""
    tree: dict = {}
    for path, p in model.named_param_leaves():
        node, parts = tree, path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(int(part) if part.isdigit() else part, {})
        node[parts[-1]] = p
    return _ints_to_tuple(tree)


def _ints_to_tuple(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return tuple(_ints_to_tuple(node[k]) for k in sorted(node))
    return {k: _ints_to_tuple(v) for k, v in node.items()}


def params_to_jax(model) -> dict:
    """Model parameters -> the reference's params tree of numpy arrays
    (f32 for bf16 leaves, which numpy cannot hold)."""
    tree = _tree_of(model)
    tree.setdefault("layers_tail", ())
    leaves, spec = tree_flatten(tree)
    arrs = [l.detach().float().cpu().numpy() if l.dtype == torch.bfloat16
            else l.detach().cpu().numpy() for l in leaves]
    return tree_unflatten(spec, arrs)


@torch.no_grad()
def params_from_jax(tree_of_numpy, model):
    """Copy a reference params tree (numpy leaves) into ``model``; returns
    the model.  Raises if the leaf count or any shape disagrees."""
    src, _ = tree_flatten(tree_of_numpy)
    dst = model.named_param_leaves()
    if len(src) != len(dst):
        raise ValueError(f"reference tree has {len(src)} leaves, model has {len(dst)}")
    for a, (path, p) in zip(src, dst):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{path}: reference shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    return model


def gan_params_to_jax(model) -> dict:
    """WGAN parameters -> the reference's ``{"critic": [{"b", "w"}, ...],
    "gen": [...]}`` tree of numpy arrays."""
    return tree_map(lambda p: p.detach().cpu().numpy(), model.param_tree())


@torch.no_grad()
def gan_params_from_jax(tree_of_numpy, model):
    """Copy a reference WGAN params tree (numpy leaves) into ``model``;
    returns the model.  Raises if the leaf count or any shape disagrees."""
    src = tree_flatten(tree_of_numpy)[0]
    dst = tree_flatten(model.param_tree())[0]
    if len(src) != len(dst):
        raise ValueError(f"reference tree has {len(src)} leaves, model has {len(dst)}")
    for a, p in zip(src, dst):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"reference shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    return model
