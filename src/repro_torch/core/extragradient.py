"""Q-GenX — quantized generalized extra-gradient (Algorithm 1, Section 3.1;
port of ``repro/core/extragradient.py``).

The template update on K workers:

    X_{t+1/2} = X_t  - (gamma_t / K) sum_k Vhat_{k,t}
    Y_{t+1}   = Y_t  - (1 / K)       sum_k Vhat_{k,t+1/2}
    X_{t+1}   = gamma_{t+1} Y_{t+1}

with the adaptive step-size (Theorems 3/4)

    gamma_t = K (1 + sum_{i<t} sum_k ||Vhat_{k,i} - Vhat_{k,i+1/2}||^2)^{-1/2}.

The variants ``da`` / ``de`` / ``optda`` (Examples 3.1-3.3) differ only in
where the extrapolation feedback Vhat_{k,t} comes from
(:mod:`repro_torch.core.methods`); the recursion algebra is the one the
model-scale optimizer (:mod:`repro_torch.optim.qgenx`) runs, so the two
are bit-identical on one oracle sequence.

This is the theory-faithful loop the paper's rates are checked on, with K
simulated workers on one device and a plain Python loop
(:func:`qgenx_run`).  Each worker's dual vector is compressed on its own
(Algorithm 1's CODE o Q(V_{k,t})): the K stacked vectors ``[K, d]`` go
through ``Exchange.compress_with_levels`` with ``workers=True``, one
launch of kernel 5 per exchange on a card (its plain version on the CPU).
QAda (``level_update_every`` > 0) refreshes the carried level table from
the fresh half-step duals (``Exchange.qada_propose``) on every
``level_update_every``-th step; the solve runs only on those steps.

Noise: every draw comes from one noise source (:mod:`repro_torch.core.noise`),
in this order within a step:

* ``de``: K oracle draws at X_t (one Rademacher ``[d]`` each, worker
  order), K rounding draws (one ``[rows, bucket]`` each, worker order),
  K oracle draws at X_{t+1/2}, K rounding draws;
* ``da`` and ``optda``: K oracle draws at X_{t+1/2}, K rounding draws;

with no rounding draws under full precision.  Under the sparse
compressors each rounding draw is a support draw instead (``subset``:
``randk`` and ``ef-randk``; ``ef21-topk`` draws nothing).  The reference
draws these from ``split(key, 5)``'s oracle and quantization keys, each
split K ways; replaying those arrays in this order reproduces its step.
:func:`qsgda_run` draws, per step, K oracle draws and then K rounding
draws.

``qgenx_run(exchange=ExchangeConfig(...))`` takes any compressor of the
registry.  Under a contractive one (``ef21-topk``, ``ef-randk``) each
worker's EF21 memory ``QGenXState.ef_err`` ``[K, d]`` threads through
the step's exchanges in order (``ef_compress``: the new memory row is
the worker's contribution); otherwise it stays zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.exchange import Exchange, ExchangeConfig, make_exchange
from repro_torch.core.methods import (
    METHODS,
    commit_params,
    dual_step,
    get_method,
    half_step,
    sq_increment,
)
from repro_torch.core.quantization import QuantConfig, uniform_levels


def adaptive_gamma(sum_sq: torch.Tensor, K: int, scale: float) -> torch.Tensor:
    """gamma_t = scale * K * (1 + sum_sq)^{-1/2}  (Theorems 3/4), in f32.

    ``scale * K`` is a host product, as in the reference.  The toy loop
    and the model-scale optimizer both call this one function."""
    return (scale * K) * torch.rsqrt(1.0 + sum_sq)


@dataclasses.dataclass(frozen=True)
class QGenXConfig:
    """``variant`` ``da`` | ``de`` | ``optda``; ``num_workers`` K;
    ``quant`` (shorthand for a qgenx exchange) or a full ``exchange``
    config, any compressor of the registry (None of both: full
    precision); ``level_update_every`` the QAda period in steps (0: fixed
    levels); ``gamma_scale`` a scale on the adaptive step-size."""

    variant: str = "de"
    num_workers: int = 4
    quant: Optional[QuantConfig] = None
    exchange: Optional[ExchangeConfig] = None
    level_update_every: int = 0
    gamma_scale: float = 1.0

    def __post_init__(self):
        if self.variant not in METHODS:
            raise ValueError(f"unknown variant {self.variant}")

    def make_exchange(self) -> Optional[Exchange]:
        """The Exchange this config compresses with (None: full precision)."""
        if self.exchange is not None:
            return make_exchange(self.exchange)
        if self.quant is not None:
            return make_exchange(ExchangeConfig(compressor="qgenx", quant=self.quant))
        return None


@dataclasses.dataclass
class QGenXState:
    """The reference's nine fields: X_t, the dual accumulator Y_t, the
    running ``sum_sq`` (f32 scalar), the per-worker previous half-step
    feedback ``prev_half`` [K, d] (optda), the level table, the ergodic
    average ``x_avg`` of X_{t+1/2}, the iteration count ``t`` (a host
    int), the cumulative per-worker fixed-width ``bits_sent`` (f32 scalar)
    and the error-feedback memory ``ef_err`` [K, d] (zeros unless the
    compressor is contractive)."""

    x: torch.Tensor
    y: torch.Tensor
    sum_sq: torch.Tensor
    prev_half: torch.Tensor
    levels: torch.Tensor
    x_avg: torch.Tensor
    t: int
    bits_sent: torch.Tensor
    ef_err: torch.Tensor


def _init_levels(ex: Optional[Exchange], device) -> torch.Tensor:
    if ex is None or not ex.compressor.has_levels:
        return uniform_levels(1, device)
    return ex.init_state(device).levels


def qgenx_init(x0: torch.Tensor, cfg: QGenXConfig, device) -> QGenXState:
    """The state at t = 0 on ``device``: X_1 = x0, Y_1 = x0 / gamma_1."""
    x0 = torch.as_tensor(x0).to(device=device, dtype=torch.float32)
    d = x0.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    gamma1 = cfg.gamma_scale * cfg.num_workers  # gamma at t = 1 (sum_sq = 0)
    return QGenXState(
        x=x0, y=x0 / gamma1, sum_sq=torch.zeros((), **f32),
        prev_half=torch.zeros((cfg.num_workers, d), **f32),
        levels=_init_levels(cfg.make_exchange(), device),
        x_avg=torch.zeros((d,), **f32), t=0, bits_sent=torch.zeros((), **f32),
        ef_err=torch.zeros((cfg.num_workers, d), **f32))


def _per_iter_bits(d: int, ex: Optional[Exchange]) -> float:
    """Fixed-width wire bits per worker per oracle exchange."""
    return 32.0 * d if ex is None else 8.0 * ex.compress_wire_bytes(d)


def _estimates(v: torch.Tensor, levels: torch.Tensor, ef_err: torch.Tensor, noise,
               ex: Optional[Exchange]) -> tuple:
    """Each worker's estimate of its row of ``v`` [K, d] (identity under
    full precision) and the error memory after it: under a contractive
    compressor the EF21 update of ``ef_err`` (its new rows are the
    estimates), else ``ef_err`` untouched."""
    if ex is None:
        return v, ef_err
    if ex.compressor.has_error:
        return ex.compressor.ef_compress(v, ef_err, ex.cfg, noise)
    return ex.compress_with_levels(v, levels, noise, workers=True), ef_err


def _oracles(oracle: Callable, z: torch.Tensor, noise, K: int) -> torch.Tensor:
    return torch.stack([oracle(z, noise) for _ in range(K)])


def qgenx_step(state: QGenXState, oracle: Callable, noise, cfg: QGenXConfig,
               ex: Optional[Exchange] = None) -> QGenXState:
    """One Q-GenX iteration with K simulated workers; ``oracle(z, noise)``
    is called once per worker (i.i.d. samples), ``ex`` defaults to
    ``cfg.make_exchange()``.  Draw order: the module docstring."""
    K = cfg.num_workers
    d = state.x.shape[0]
    method = get_method(cfg.variant)
    ex = ex if ex is not None else cfg.make_exchange()
    gamma_t = adaptive_gamma(state.sum_sq, K, cfg.gamma_scale)

    # extrapolation feedback Vhat_{k,t}, per the oracle schedule; the EF
    # memory threads through the exchanges in order
    ef_err = state.ef_err
    if method.uses_prev_half:  # optda: carried feedback, no fresh broadcast
        v_hat_t = state.prev_half
    elif method.oracle_calls == 2:  # de: fresh oracle + broadcast at X_t
        v_hat_t, ef_err = _estimates(_oracles(oracle, state.x, noise, K), state.levels,
                                     ef_err, noise, ex)
    else:  # da: zero feedback, nothing to communicate
        v_hat_t = torch.zeros((K, d), dtype=torch.float32, device=state.x.device)

    x_half = half_step(state.x, torch.sum(v_hat_t, dim=0) / K, gamma_t)

    # the (always fresh) half-step exchange Vhat_{k,t+1/2}
    v_hat_half, ef_err = _estimates(_oracles(oracle, x_half, noise, K), state.levels, ef_err,
                                    noise, ex)
    y_next = dual_step(state.y, torch.sum(v_hat_half, dim=0) / K)

    sum_sq = state.sum_sq + sq_increment(v_hat_t, v_hat_half)
    gamma_next = adaptive_gamma(sum_sq, K, cfg.gamma_scale)
    x_next = commit_params(torch.zeros_like(state.x), y_next, gamma_next,
                           like=state.x)  # origin-anchored: X = gamma Y

    # QAda refresh from the fresh duals, on the step that ends a period
    levels = state.levels
    every = cfg.level_update_every
    if (ex is not None and ex.compressor.has_levels and every > 0
            and state.t % every == every - 1):
        levels = ex.qada_propose(levels, v_hat_half)

    t_next = state.t + 1
    x_avg = state.x_avg + (x_half - state.x_avg) / float(t_next)
    return QGenXState(x=x_next, y=y_next, sum_sq=sum_sq, prev_half=v_hat_half,
                      levels=levels, x_avg=x_avg, t=t_next,
                      bits_sent=state.bits_sent + method.exchanges * _per_iter_bits(d, ex),
                      ef_err=ef_err)


def qgenx_run(x0: torch.Tensor, oracle: Callable, cfg: QGenXConfig, noise, num_steps: int,
              device) -> QGenXState:
    """``num_steps`` iterations from ``x0`` on ``device``; the output is
    the final state (``x_avg`` is the ergodic iterate)."""
    state = qgenx_init(x0, cfg, device)
    ex = cfg.make_exchange()
    for _ in range(num_steps):
        state = qgenx_step(state, oracle, noise, cfg, ex)
    return state


# ---------------------------------------------------------------------------
# QSGDA baseline (Beznosikov et al. 2022) — Appendix H.1 comparison
# ---------------------------------------------------------------------------


def qsgda_run(x0: torch.Tensor, oracle: Callable, noise, num_steps: int, num_workers: int,
              lr: float, device, quant: Optional[QuantConfig] = None) -> tuple:
    """Plain quantized stochastic gradient descent-ascent (no
    extra-gradient); returns (last iterate, ergodic average).  The paper's
    Figure 4: without the extra-gradient template QSGDA stalls on bilinear
    problems where Q-GenX makes steady progress."""
    levels = uniform_levels(quant.num_levels if quant else 1, device)
    ex = make_exchange(ExchangeConfig(compressor="qgenx", quant=quant)) if quant else None
    x = torch.as_tensor(x0).to(device=device, dtype=torch.float32)
    x_avg = torch.zeros_like(x)
    for t in range(1, num_steps + 1):
        v, _ = _estimates(_oracles(oracle, x, noise, num_workers), levels, None, noise, ex)
        x = x - lr * torch.mean(v, dim=0)
        x_avg = x_avg + (x - x_avg) / float(t)
    return x, x_avg
