"""Optimizer configuration and global-norm clipping (port of the qgenx
slice of ``repro/optim/optimizers.py``; the adam family is not ported).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "qgenx"  # only qgenx is ported (the adam family's fields are not)
    grad_clip: float = 1.0
    gamma_scale: float = 1.0  # qgenx: scale on the adaptive step-size rule
    method: str = "de"  # qgenx oracle schedule ("de" | "optda")

    def __post_init__(self):
        if self.name != "qgenx":
            raise ValueError(f"optimizer {self.name!r} is not ported (qgenx only)")


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
