"""The data-parallel train step (port of ``repro/launch/steps.py::core_step``:
the adam-family and qgenx ``de`` / ``optda`` branches).

One step on each worker:

* qgenx ``de`` (Example 3.2): gradient at X_t -> exchange -> extrapolate
  to X_{t+1/2} -> gradient there -> exchange -> commit (two exchanges).
* qgenx ``optda`` (Example 3.3): extrapolate with the carried half-step
  mean ``prev_half`` -> gradient at X_{t+1/2} -> exchange -> commit (one).
* ``extra_adam``: gradient -> exchange -> Adam extrapolation to
  params_half -> gradient there -> exchange -> Adam commit from the
  step's starting params (two exchanges).
* ``optimistic_adam``: extrapolate with the previous half-step gradient
  -> gradient -> exchange -> commit (one); ``adam``: gradient ->
  exchange -> Adam step (one).

The exchange is :class:`repro_torch.core.exchange.Exchange` (qgenx,
layerwise, or the exact ``none`` control); its quantize/dequantize steps
run the CUDA kernels for CUDA tensors.  PyTorch runs eagerly, so the step mutates the
model's parameters in place (X_{t+1/2} while the second gradient is taken,
then X_{t+1}) and returns the new optimizer and exchange states with the
``loss`` and ``wire_bytes`` metrics.  The guard, fault schedules,
``sync_every`` and re-centering are not ported: ``make_train_step`` has
no parameter for them.  The device-PRNG exchange needs no parameter here
either: it comes in with the exchange,
``make_exchange(ExchangeConfig(..., use_device_prng=True))``, and the
step's ``noise`` source is then asked for seeds instead of arrays.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.exchange import Exchange
from repro_torch.core.methods import get_method
from repro_torch.optim import optimizers as opt
from repro_torch.optim import qgenx as qgenx_opt
from repro_torch.optim.optimizers import OptimizerConfig


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       aux: float = 0.0) -> torch.Tensor:
    ll = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(ll, -1, labels[..., None])[..., 0]
    return torch.mean(nll) + 0.01 * aux


def make_loss_fn(model):
    def loss_fn(batch: dict) -> torch.Tensor:
        return cross_entropy_loss(model(batch["tokens"]), batch["labels"])

    return loss_fn


@torch.no_grad()
def _assign(params: list, values: list) -> None:
    for p, v in zip(params, values):
        p.copy_(v)


def make_train_step(model, opt_cfg: OptimizerConfig, exchange: Exchange):
    """Returns ``step(opt_state, ex_state, batch, noise) -> (opt_state,
    ex_state, metrics)`` for this worker's ``batch`` shard; ``noise`` is
    this worker's noise source (:mod:`repro_torch.core.noise`)."""
    method = get_method(opt_cfg.method)
    if opt_cfg.name == "qgenx" and method.name not in ("de", "optda"):
        raise ValueError(f"make_train_step supports qgenx methods 'de'/'optda', "
                         f"got {opt_cfg.method!r}")
    loss_fn = make_loss_fn(model)
    params = model.param_leaves()
    comm = exchange.comm
    K = comm.size

    def grad_at(batch):
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), list(grads)

    def adam_family_step(opt_state, ex_state, batch, noise):
        name = opt_cfg.name
        start = None
        if name == "extra_adam":
            _, g1 = grad_at(batch)
            g1, ex_state = exchange.pmean_tree(g1, ex_state, noise)
            half = opt.extrapolate(opt_cfg, params, opt_state, g1)
            del g1
        elif name == "optimistic_adam":
            half = opt.extrapolate(opt_cfg, params, opt_state, opt_state.prev_half_grad)
        if name != "adam":
            # the commit steps from the starting params, not params_half
            start = [p.detach().clone() for p in params]
            _assign(params, half)
            del half
        loss, g2 = grad_at(batch)
        g2, ex_state = exchange.pmean_tree(g2, ex_state, noise)
        new_params, opt_state = opt.commit(opt_cfg, start if start is not None else params,
                                           opt_state, g2)
        _assign(params, new_params)
        return loss, g2, opt_state, ex_state

    def qgenx_step(opt_state, ex_state, batch, noise):
        if method.uses_prev_half:
            ghat1 = opt_state.prev_half
            _assign(params, qgenx_opt.extrapolate(opt_cfg, params, opt_state, ghat1, K))
            loss, g2 = grad_at(batch)
            ghat2, ex_state = exchange.pmean_tree(g2, ex_state, noise)
            sq = qgenx_opt.local_sq_diff(ghat1, g2)
            prev_half = ghat2
        else:
            _, g1 = grad_at(batch)
            ghat1, ex_state = exchange.pmean_tree(g1, ex_state, noise)
            _assign(params, qgenx_opt.extrapolate(opt_cfg, params, opt_state, ghat1, K))
            del ghat1
            loss, g2 = grad_at(batch)
            ghat2, ex_state = exchange.pmean_tree(g2, ex_state, noise)
            sq = qgenx_opt.local_sq_diff(g1, g2)
            del g1
            prev_half = None
        sq = comm.all_reduce_sum(sq)
        new_params, opt_state = qgenx_opt.commit(opt_cfg, params, opt_state, ghat2, sq,
                                                 K, prev_half=prev_half)
        _assign(params, new_params)
        return loss, g2, opt_state, ex_state

    body = qgenx_step if opt_cfg.name == "qgenx" else adam_family_step

    def step(opt_state, ex_state, batch, noise):
        st_in = ex_state
        loss, g2, opt_state, ex_state = body(opt_state, ex_state, batch, noise)
        loss = comm.all_reduce_mean(loss)
        wire = exchange.wire_bytes_tree(g2, K) * (ex_state.step - st_in.step)
        return opt_state, ex_state, {"loss": loss, "wire_bytes": wire}

    return step
