"""The data-parallel train step (port of ``repro/launch/steps.py::core_step``:
the adam-family and qgenx ``de`` / ``optda`` branches, the local-update
regime, parameter re-centering and the step's metrics).

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

The exchange is :class:`repro_torch.core.exchange.Exchange` (any
compressor of its registry, the exact ``none`` control included); the
quantize/dequantize steps of qgenx and layerwise run the CUDA kernels
for CUDA tensors.  Under a contractive compressor (``ef21-topk``,
``ef-randk``) the qgenx gamma statistic is taken from the exchanged
estimates, ``||ghat_t - ghat_{t+1/2}||^2``, in place of the raw local
oracles (``de`` keeps the first mean until the second exchange), and
the error memory ``ex_state.error`` moves only on steps that exchange.  PyTorch runs eagerly, so the step mutates the
model's parameters in place (X_{t+1/2} while the second gradient is taken,
then X_{t+1}) and returns the new optimizer and exchange states with the
metrics.

The exchange's config carries the local-update regime, as in the
reference.  With ``sync_every = S`` the exchanges run only on a step whose
pre-step optimizer count satisfies ``count % S == S - 1`` (the count is a
host int, so the gate costs no device sync); on the other steps each
worker's gradients pass through unexchanged and ``ex_state`` is untouched.
A sync step with S > 1 also mean-reduces a probe of the step's starting
params (the first ``drift_probe`` coordinates, recorded as
``drift_probe`` wire traffic) into ``param_drift``, their RMS deviation
from the workers' mean.  With ``recenter_every = R`` > 0, every step with
``count % R == R - 1`` ends with one more exchange of the iterates: qgenx
exchanges its dual accumulator Y and recommits X = anchor + gamma Y, the
adam family exchanges the params.

Under ``level_schedule="qada"`` every exchange call (the gradient
exchanges and the re-centering one) also adds its histogram to
``ex_state.hist`` and advances the QAda cadence inside
``Exchange.pmean_tree``; a local step makes no call, so it moves neither.

Metrics: ``loss`` (mean over workers), ``wire_bytes`` (the analytic
collective-operand bytes of the exchanges that ran, the QAda histogram's
``4 * qada_bins`` a call included, plus the probe's
``4 * min(drift_probe, n)``), ``param_drift`` and ``coded_bits_est``
(the Theorem 2 entropy-coded estimate of this worker's gradient
broadcasts: ``Exchange.coded_bits_tree`` of the exchanged mean under the
pre-step level table (before any QAda refresh of this step), times the gradient exchanges that ran; the
re-centering exchange is not counted; 0 on steps that do not sync and for
every compressor but qgenx).  The guard and fault schedules are not
ported: ``make_train_step`` has no parameter for them.  The device-PRNG
exchange needs no parameter here either: it comes in with the exchange,
``make_exchange(ExchangeConfig(..., use_device_prng=True))``, and the
step's ``noise`` source is then asked for seeds instead of arrays.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.exchange import Exchange, record_wire
from repro_torch.core.extragradient import adaptive_gamma
from repro_torch.core.methods import commit_params, get_method
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
    cfg = exchange.cfg
    n_params = sum(p.numel() for p in params)
    probe_bytes = 4.0 * min(cfg.drift_probe, n_params)
    # under a contractive compressor the raw local gradient is no proxy for
    # the estimate the EF recursion applies: the gamma statistic takes the
    # exchanged estimates instead (the reference's rule)
    contractive = exchange.compressor.has_error

    def grad_at(batch):
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), list(grads)

    def adam_family_step(opt_state, ex_state, batch, exchange_grads):
        name = opt_cfg.name
        start = None
        if name == "extra_adam":
            _, g1 = grad_at(batch)
            g1, ex_state = exchange_grads(g1, ex_state)
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
        g2, ex_state = exchange_grads(g2, ex_state)
        new_params, opt_state = opt.commit(opt_cfg, start if start is not None else params,
                                           opt_state, g2)
        _assign(params, new_params)
        return loss, g2, opt_state, ex_state

    def qgenx_step(opt_state, ex_state, batch, exchange_grads):
        if method.uses_prev_half:
            ghat1 = opt_state.prev_half
            _assign(params, qgenx_opt.extrapolate(opt_cfg, params, opt_state, ghat1, K))
            loss, g2 = grad_at(batch)
            ghat2, ex_state = exchange_grads(g2, ex_state)
            sq = qgenx_opt.local_sq_diff(ghat1, ghat2 if contractive else g2)
            prev_half = ghat2
        else:
            _, g1 = grad_at(batch)
            ghat1, ex_state = exchange_grads(g1, ex_state)
            _assign(params, qgenx_opt.extrapolate(opt_cfg, params, opt_state, ghat1, K))
            first = ghat1 if contractive else g1  # the half of the pair sq needs
            del g1, ghat1
            loss, g2 = grad_at(batch)
            ghat2, ex_state = exchange_grads(g2, ex_state)
            sq = qgenx_opt.local_sq_diff(first, ghat2 if contractive else g2)
            del first
            prev_half = None
        del g2
        sq = comm.all_reduce_sum(sq)
        new_params, opt_state = qgenx_opt.commit(opt_cfg, params, opt_state, ghat2, sq,
                                                 K, prev_half=prev_half)
        _assign(params, new_params)
        return loss, ghat2, opt_state, ex_state

    body = qgenx_step if opt_cfg.name == "qgenx" else adam_family_step

    @torch.no_grad()
    def recenter(opt_state, ex_state, noise):
        """One exchange of the iterates: qgenx's dual accumulator Y (then
        X = anchor + gamma Y), the adam family's params."""
        if opt_cfg.name == "qgenx":
            y_bar, ex_state = exchange.pmean_tree(opt_state.y, ex_state, noise)
            gamma = adaptive_gamma(opt_state.sum_sq, K, opt_cfg.gamma_scale)
            _assign(params, commit_params(opt_state.anchor, y_bar, gamma, like=params))
            return opt_state._replace(y=y_bar), ex_state
        p_bar, ex_state = exchange.pmean_tree(params, ex_state, noise)
        _assign(params, p_bar)
        return opt_state, ex_state

    @torch.no_grad()
    def probe():
        """The first ``drift_probe`` parameter coordinates as one f32 copy."""
        chunks, have = [], 0
        for p in params:
            if have >= cfg.drift_probe:
                break
            take = min(p.numel(), cfg.drift_probe - have)
            chunks.append(p.reshape(-1)[:take].float())
            have += take
        return torch.cat(chunks)

    def param_drift(x):
        """RMS per-coordinate deviation of the probe from its workers' mean."""
        record_wire("drift_probe", x)
        mean = comm.all_reduce_mean(x)
        return torch.sqrt(comm.all_reduce_mean(torch.mean((x - mean) ** 2)))

    def step(opt_state, ex_state, batch, noise):
        st_in = ex_state
        count = opt_state.count
        is_sync = count % cfg.sync_every == cfg.sync_every - 1
        start_probe = probe() if is_sync and cfg.sync_every > 1 else None
        if is_sync:
            exchange_grads = lambda g, st: exchange.pmean_tree(g, st, noise)  # noqa: E731
        else:
            exchange_grads = lambda g, st: (g, st)  # noqa: E731
        loss, g2, opt_state, ex_state = body(opt_state, ex_state, batch, exchange_grads)
        # the gradient's metrics first, so the mean is freed before the
        # re-centering exchange allocates its own buffers
        per_call = exchange.wire_bytes_tree(g2, K)
        coded = 0.0
        if is_sync:
            coded = exchange.coded_bits_tree(g2, st_in) * (ex_state.step - st_in.step)
        del g2
        if cfg.recenter_every and count % cfg.recenter_every == cfg.recenter_every - 1:
            opt_state, ex_state = recenter(opt_state, ex_state, noise)
        loss = comm.all_reduce_mean(loss)
        wire = per_call * (ex_state.step - st_in.step)
        drift = 0.0
        if start_probe is not None:
            drift = param_drift(start_probe)
            wire += probe_bytes
        return opt_state, ex_state, {"loss": loss, "wire_bytes": wire, "param_drift": drift,
                                     "coded_bits_est": coded}

    return step
