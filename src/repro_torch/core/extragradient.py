"""The paper's adaptive step-size rule (port of
``repro/core/extragradient.py::adaptive_gamma``)."""

from __future__ import annotations

import torch


def adaptive_gamma(sum_sq: torch.Tensor, K: int, scale: float) -> torch.Tensor:
    """gamma_t = scale * K * (1 + sum_sq)^{-1/2}  (Theorems 3/4), in f32.

    ``scale * K`` is a host product, as in the reference's model-scale
    step (where K is the static worker count).
    """
    return (scale * K) * torch.rsqrt(1.0 + sum_sq)
