"""Model-scale adaptive Q-GenX — the paper's algorithm as the trainer's
optimizer (port of ``repro/optim/qgenx.py``).

    X_{t+1/2} = X_t - gamma_t * ghat_t            (extrapolate)
    Y_{t+1}   = Y_t - ghat_{t+1/2}                (dual accumulation)
    X_{t+1}   = X_1 + gamma_{t+1} * Y_{t+1}       (commit)
    gamma_t   = gamma_scale * K * (1 + sum_sq)^{-1/2}

Trees are flattened in JAX order (:mod:`repro_torch.core.tree`); the state
holds f32 tensors on the parameters' device.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.extragradient import adaptive_gamma
from repro_torch.core.methods import (
    commit_params,
    dual_step,
    get_method,
    half_step,
    sq_increment,
)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim.optimizers import OptimizerConfig, _clip


class QGenXOptState(NamedTuple):
    """anchor X_1 (f32), dual accumulator y (f32), running sum_sq (f32
    scalar), completed steps ``count`` (host int), and — optda only — the
    carried half-step feedback ``prev_half`` (f32; None under de)."""

    anchor: Any
    y: Any
    sum_sq: torch.Tensor
    count: int
    prev_half: Any = None


def init_qgenx_state(cfg: OptimizerConfig, params) -> QGenXOptState:
    method = get_method(cfg.method)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return QGenXOptState(
        anchor=tree_map(lambda p: p.detach().float().clone(), params),
        y=tree_map(zeros, params),
        sum_sq=torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device),
        count=0,
        prev_half=tree_map(zeros, params) if method.uses_prev_half else None,
    )


def state_norms(state: QGenXOptState) -> dict:
    """Host-side diagnostic of the recursion's sufficient statistics:
    ``{"y_l2", "sum_sq", "count", "prev_half_l2"}`` (floats / an int).

    The train loop's watchdog prints it when a rollback fires.  ``sum_sq``
    is a monotone accumulator: one non-finite increment destroys every
    later adaptive gamma, which is why the step guard rejects the whole
    state update, never just the params."""
    def l2(tree):
        if tree is None:
            return 0.0
        return float(torch.sqrt(sum(torch.sum(torch.square(l.float()))
                                    for l in tree_leaves(tree))))

    return {"y_l2": l2(state.y), "sum_sq": float(state.sum_sq),
            "count": int(state.count), "prev_half_l2": l2(state.prev_half)}


def local_sq_diff(g1, g2) -> torch.Tensor:
    """This worker's ||g_t - g_{t+1/2}||^2 (the caller sums over workers)."""
    return sq_increment(g1, g2)


def extrapolate(cfg: OptimizerConfig, params, state: QGenXOptState, ghat, num_workers):
    """X_{t+1/2} = X_t - gamma_t * clip(ghat_t)."""
    ghat = _clip(ghat, cfg.grad_clip)
    gamma_t = adaptive_gamma(state.sum_sq, num_workers, cfg.gamma_scale)
    return half_step(params, ghat, gamma_t)


def commit(cfg: OptimizerConfig, params, state: QGenXOptState, ghat_half,
           sq_inc: torch.Tensor, num_workers, prev_half=None):
    """Dual accumulation + adaptive re-projection; returns (params, state)."""
    ghat_half = _clip(ghat_half, cfg.grad_clip)
    y = dual_step(state.y, ghat_half)
    sum_sq = state.sum_sq + sq_inc.float()
    gamma_next = adaptive_gamma(sum_sq, num_workers, cfg.gamma_scale)
    new_params = commit_params(state.anchor, y, gamma_next, like=params)
    if prev_half is not None:
        prev_half = tree_map(lambda g: g.float(), prev_half)
    else:
        prev_half = state.prev_half
    return new_params, QGenXOptState(anchor=state.anchor, y=y, sum_sq=sum_sq,
                                     count=state.count + 1, prev_half=prev_half)
