"""Optimizers for model-scale training (port of ``repro/optim/optimizers.py``).

* ``adam`` — baseline (1 oracle call per step);
* ``extra_adam`` — extrapolate to params_half with the in-flight Adam
  direction, commit from the gradient there (2 calls: Example 3.2's
  pattern; the paper's Section 5 optimizer);
* ``optimistic_adam`` — extrapolate with the previous half-step gradient
  (1 call: Example 3.3's pattern);
* ``qgenx`` — the paper's adaptive algorithm, in :mod:`repro_torch.optim.qgenx`.

Trees are flattened in JAX order (:mod:`repro_torch.core.tree`); moments
are f32 on the parameters' device and the step count is a host int.
The functions return new trees; the caller writes them into its model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map

OPTIMIZERS = ("adam", "extra_adam", "optimistic_adam", "qgenx")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "extra_adam"  # adam | extra_adam | optimistic_adam | qgenx
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    gamma_scale: float = 1.0  # qgenx: scale on the adaptive step-size rule
    method: str = "de"  # qgenx oracle schedule ("de" | "optda")

    def __post_init__(self):
        if self.name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.name!r}; one of {OPTIMIZERS}")


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: int
    prev_half_grad: Optional[Any]  # optimistic variant only


def init_state(cfg: OptimizerConfig, params):
    """Optimizer state for ``cfg.name``: :class:`AdamState` for the adam
    family, :class:`repro_torch.optim.qgenx.QGenXOptState` for qgenx."""
    if cfg.name == "qgenx":
        from repro_torch.optim import qgenx  # local import: qgenx imports us

        return qgenx.init_qgenx_state(cfg, params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamState(mu=tree_map(zeros, params), nu=tree_map(zeros, params), count=0,
                     prev_half_grad=(tree_map(zeros, params)
                                     if cfg.name == "optimistic_adam" else None))


def _clip(grads, max_norm: float):
    """Scale the tree so its global L2 norm is at most ``max_norm``; the
    result is f32 (the reference's bf16 * f32-scale promotes)."""
    if max_norm <= 0:
        return grads
    sq = None
    for g in tree_leaves(grads):
        term = torch.sum(g.float() ** 2)
        sq = term if sq is None else sq + term
    gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads)


def _adam_direction(cfg: OptimizerConfig, mu, nu, count: int):
    # the bias corrections in f32, as the reference computes them from its
    # int32 count
    c = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** c)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** c)
    return tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps), mu, nu)


def _update_moments(cfg: OptimizerConfig, grads, mu, nu):
    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g.float(), mu, grads)
    nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * torch.square(g.float()), nu, grads)
    return mu, nu


def _apply(cfg: OptimizerConfig, params, direction):
    def one(p, d):
        new = p.detach().float() - cfg.lr * d
        if cfg.weight_decay:
            new = new - cfg.lr * cfg.weight_decay * p.detach().float()
        return new.to(p.dtype)

    return tree_map(one, params, direction)


def extrapolate(cfg: OptimizerConfig, params, state: AdamState, grads):
    """First half of ExtraAdam: the tentative step to params_half (the
    moments are not committed)."""
    grads = _clip(grads, cfg.grad_clip)
    mu, nu = _update_moments(cfg, grads, state.mu, state.nu)
    return _apply(cfg, params, _adam_direction(cfg, mu, nu, state.count + 1))


def commit(cfg: OptimizerConfig, params, state: AdamState, grads_half):
    """Second half: update ``params`` from the gradient at the extrapolated
    point; returns ``(new_params, new_state)``."""
    grads_half = _clip(grads_half, cfg.grad_clip)
    mu, nu = _update_moments(cfg, grads_half, state.mu, state.nu)
    count = state.count + 1
    new_params = _apply(cfg, params, _adam_direction(cfg, mu, nu, count))
    prev = (tree_map(lambda g: g.float(), grads_half)
            if state.prev_half_grad is not None else None)
    return new_params, AdamState(mu=mu, nu=nu, count=count, prev_half_grad=prev)


def adam_step(cfg: OptimizerConfig, params, state: AdamState, grads):
    """Plain Adam (baseline)."""
    return commit(cfg, params, state, grads)
