"""The extragradient method engine — oracle schedules and the recursion
algebra (port of ``repro/core/methods.py``).

    X_{t+1/2} = X_t    - gamma_t     * Vbar_t       (half_step)
    Y_{t+1}   = Y_t    - Vbar_{t+1/2}               (dual_step)
    X_{t+1}   = anchor + gamma_{t+1} * Y_{t+1}      (commit_params)

``de`` (Example 3.2) takes a fresh exchanged oracle at X_t for Vbar_t;
``optda`` (Example 3.3) reuses the previous half-step feedback.  The
algebra is pytree-generic (JAX flatten order), f32 accumulation, cast back
to each parameter's dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OracleSchedule:
    """Where the extrapolation feedback comes from, and what it costs."""

    name: str
    oracle_calls: int
    exchanges: int
    uses_prev_half: bool


METHODS = {
    "da": OracleSchedule("da", oracle_calls=1, exchanges=1, uses_prev_half=False),
    "de": OracleSchedule("de", oracle_calls=2, exchanges=2, uses_prev_half=False),
    "optda": OracleSchedule("optda", oracle_calls=1, exchanges=1, uses_prev_half=True),
}


def get_method(name: str) -> OracleSchedule:
    try:
        return METHODS[name]
    except KeyError:
        raise ValueError(f"unknown method {name!r}; registered: {sorted(METHODS)}") from None


def half_step(x, vbar, gamma_t: torch.Tensor):
    """X_{t+1/2} = X_t - gamma_t * Vbar_t, leafwise in f32, cast back."""
    return tree_map(lambda p, g: (p.float() - gamma_t * g.float()).to(p.dtype), x, vbar)


def dual_step(y, vbar_half):
    """Y_{t+1} = Y_t - Vbar_{t+1/2} (f32 dual accumulator)."""
    return tree_map(lambda yl, g: yl - g.float(), y, vbar_half)


def commit_params(anchor, y, gamma_next: torch.Tensor, like):
    """X_{t+1} = anchor + gamma_{t+1} * Y_{t+1}, cast to ``like``'s dtypes."""
    return tree_map(lambda a, yl, p: (a + gamma_next * yl).to(p.dtype), anchor, y, like)


def sq_increment(v1, v2) -> torch.Tensor:
    """||V_t - V_{t+1/2}||^2 summed over all leaves (f32)."""
    total = None
    for a, b in zip(tree_leaves(v1), tree_leaves(v2)):
        term = torch.sum((a.float() - b.float()) ** 2)
        total = term if total is None else total + term
    return total
