"""Parameter exchange with the JAX reference, through numpy.

The two packages' init generators cannot give equal weights, so parity
checks start both sides from the same numpy parameters: a JAX params
pytree converted leaf by leaf with ``np.asarray`` goes into a port model
with :func:`params_from_jax`, and :func:`params_to_jax` gives the inverse
tree (nested dicts and tuples, the reference's structure).  Leaves are
matched in JAX flatten order and checked by shape.
:func:`gan_params_from_jax` and :func:`gan_params_to_jax` do the same for
the WGAN-GP testbed's generator and critic (:class:`repro_torch.gan.wgan.WGAN`).

The train state crosses the same way.  :func:`params_tree` and
:func:`opt_state_tree` give the reference's structure with the port's own
tensors as leaves (no copy; the optimizer's ``count`` stays a host int);
:class:`~repro_torch.core.exchange.ExchangeState` already has the
reference's six children (``step`` a host int).  These are the trees
:mod:`repro_torch.checkpoint.checkpointing` saves and restores.
:func:`to_numpy` turns such a tree into numpy (``opt_state_to_jax``,
``ex_state_to_jax``: ints as int32 0-d arrays, as the reference holds
them), and :func:`opt_state_from_jax` / :func:`ex_state_from_jax` take a
state of either package's structure (the reference's NamedTuple /
``ExchangeState`` with numpy leaves, or a restored tree) back into the
port's state on a device.  :func:`qgenx_state_to_jax` /
:func:`qgenx_state_from_jax` carry the toy-VI loop's
:class:`~repro_torch.core.extragradient.QGenXState` the same two ways
(its nine fields; ``t`` a host int in the port, an int32 0-d array in the
reference).

The serving path's paged arena crosses too: :func:`arena_from_jax` takes
the reference's arena (``repro.serve.kv_cache.init_paged_cache``'s dict,
numpy leaves ``[Lj, num_pages, ...]``) to the port's tensors, adding the
port's sink page of dropped writes after the real pages
(:mod:`repro_torch.serve.kv_cache`), and :func:`arena_to_jax` gives the
reference's dict back without it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exchange import ExchangeState
from repro_torch.core.extragradient import QGenXState
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.optim.optimizers import AdamState
from repro_torch.optim.qgenx import QGenXOptState


def _tree_of(model) -> dict:
    """The model's parameters as the reference's nested structure (a
    ModuleList index becomes a tuple position; an empty ``layers`` or
    ``layers_tail`` an empty tuple, as the reference holds it)."""
    tree: dict = {}
    for path, p in model.named_param_leaves():
        node, parts = tree, path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(int(part) if part.isdigit() else part, {})
        node[parts[-1]] = p
    tree = _ints_to_tuple(tree)
    tree.setdefault("layers", ())
    tree.setdefault("layers_tail", ())
    return tree


def _ints_to_tuple(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return tuple(_ints_to_tuple(node[k]) for k in sorted(node))
    return {k: _ints_to_tuple(v) for k, v in node.items()}


def params_tree(model) -> dict:
    """The model's parameters in the reference's params structure (the
    tensors themselves)."""
    return _tree_of(model)


def params_to_jax(model) -> dict:
    """Model parameters -> the reference's params tree of numpy arrays
    (f32 for bf16 leaves, which numpy cannot hold)."""
    leaves, spec = tree_flatten(_tree_of(model))
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


# ---------------------------------------------------------------------------
# Optimizer and exchange states
# ---------------------------------------------------------------------------

_TREE_FIELDS = {QGenXOptState: ("anchor", "y", "prev_half"),
                AdamState: ("mu", "nu", "prev_half_grad")}


def opt_state_tree(state, model):
    """The port's optimizer state (leaf lists in JAX order) in the
    reference's structure: the same NamedTuple with each params-shaped
    field nested like the params."""
    spec = tree_flatten(params_tree(model))[1]
    fields = _TREE_FIELDS[type(state)]
    return state._replace(**{f: tree_unflatten(spec, getattr(state, f))
                             for f in fields if getattr(state, f) is not None})


def to_numpy(tree):
    """A state tree with numpy leaves: tensors copied to the host (bf16 as
    f32), host ints as int32 0-d arrays."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        if isinstance(x, int):
            return np.asarray(x, np.int32)
        return np.asarray(x)

    def rec(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rec(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(rec(v) for v in node)
        if isinstance(node, ExchangeState):
            return ExchangeState(*(rec(getattr(node, f)) for f in _EX_FIELDS))
        return leaf(node)

    return rec(tree)


def opt_state_to_jax(state, model):
    """The optimizer state as the reference's numpy tree."""
    return to_numpy(opt_state_tree(state, model))


def ex_state_to_jax(state: ExchangeState) -> ExchangeState:
    """The exchange state with numpy leaves (the reference's children)."""
    return to_numpy(state)


_EX_FIELDS = ("levels", "levels_lo", "hist", "step", "error", "pending")


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    return torch.from_numpy(np.array(x)).to(device)


def opt_state_from_jax(tree, kind, device):
    """A reference-structured optimizer state (numpy or tensor leaves) ->
    the port's ``kind`` (:class:`QGenXOptState` or :class:`AdamState`) on
    ``device``, params-shaped fields as leaf lists in JAX order."""
    vals = {}
    for f in kind._fields:
        v = getattr(tree, f)
        if f == "count":
            vals[f] = int(np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v))
        elif v is None or f not in _TREE_FIELDS[kind]:
            vals[f] = None if v is None else _tensor(v, device)
        else:
            vals[f] = [_tensor(l, device) for l in tree_flatten(v)[0]]
    return kind(**vals)


def ex_state_from_jax(tree, device) -> ExchangeState:
    """A reference ``ExchangeState`` (numpy or tensor leaves) -> the port's,
    ``step`` as a host int."""
    vals = {f: getattr(tree, f) for f in _EX_FIELDS}
    step = vals.pop("step")
    step = int(np.asarray(step.cpu() if isinstance(step, torch.Tensor) else step))
    return ExchangeState(step=step, **{f: _tensor(v, device) for f, v in vals.items()})


_QGENX_FIELDS = ("x", "y", "sum_sq", "prev_half", "levels", "x_avg", "t", "bits_sent",
                 "ef_err")


def qgenx_state_to_jax(state: QGenXState) -> QGenXState:
    """The toy loop's state with numpy leaves (``t`` as an int32 0-d
    array, as the reference holds it)."""
    return QGenXState(*(to_numpy(getattr(state, f)) for f in _QGENX_FIELDS))


def qgenx_state_from_jax(tree, device) -> QGenXState:
    """A reference ``QGenXState`` (numpy or tensor leaves) -> the port's on
    ``device``, ``t`` as a host int."""
    vals = {f: getattr(tree, f) for f in _QGENX_FIELDS}
    t = vals.pop("t")
    t = int(np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t))
    return QGenXState(t=t, **{f: _tensor(v, device) for f, v in vals.items()})


# ---------------------------------------------------------------------------
# The serving path's paged arena
# ---------------------------------------------------------------------------


def arena_from_jax(arena, device) -> dict:
    """The reference's paged arena (name -> ``[Lj, P, ...]`` array) -> the
    port's (name -> ``[Lj, P + 1, ...]`` tensor on ``device``, the sink
    page zero)."""
    out = {}
    for name, a in arena.items():
        t = torch.from_numpy(np.array(a))
        sink = torch.zeros((t.shape[0], 1, *t.shape[2:]), dtype=t.dtype)
        out[name] = torch.cat([t, sink], dim=1).to(device)
    return out


def arena_to_jax(cache: dict) -> dict:
    """The port's arena -> the reference's dict of numpy arrays (the sink
    page dropped)."""
    return {name: t[:, :-1].detach().cpu().numpy() for name, t in cache.items()}
