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

The exchange's layouts need nothing of the step: ``wire_bytes`` is
``Exchange.wire_bytes_tree`` (under the bucketed exchange the sum of
``bucket_wire_bytes_tree``, under ``leafwise`` the per-leaf payload and
norms), and under ``overlap="defer_tail"`` the new ``ex_state.pending``
rides in the returned state like every other field: it moves only on
steps that exchange (the re-centering exchange swaps it too), a
rejected step hands back the old one, and the checkpoint and the
watchdog's snapshot hold it.  The reference stages its backward through
``jax.vjp`` under named scopes for the overlap; numerically that is
``value_and_grad``, which ``torch.autograd.grad`` already is.

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
every compressor but qgenx).  The device-PRNG exchange needs no
parameter here: it comes in with the exchange,
``make_exchange(ExchangeConfig(..., use_device_prng=True))``, and the
step's ``noise`` source is then asked for seeds instead of arrays.

The non-finite step guard (``guard=True``): the candidate step is
computed in full, one finiteness flag over (the mean loss, the new
params, the new optimizer state, the new exchange state) is taken per
worker (:func:`repro_torch.core.faults.tree_all_finite`) and all-reduced,
and when any alive worker saw a non-finite value the step is rejected:
everything is left exactly as it was before the step.  The params and
the contractive tier's ``ex_state.error`` are written in place, so a
guarded step keeps a device copy of the starting params (2 bytes a bf16
coordinate) and, on a step that exchanges under ``ef21-topk`` /
``ef-randk``, of the error memory (4 bytes a coordinate), and writes them
back on a rejection; the optimizer state and the rest of ``ex_state`` are
new objects each step, so the step returns the ones it was given (their
counters included: a rejected step advances neither ``sync_every``
gating, the QAda cadence nor ``prev_half``).  The verdict is one
device-to-host fetch a step.  Under the guard a QAda refresh from a
non-finite histogram does not raise: the exchange leaves that histogram
in the candidate state, which the guard then rejects.  Metrics gain
``rejected`` (1.0 = this step was rejected), ``nonfinite`` (1.0 = any
worker, alive or dropped, produced a non-finite candidate) and
``alive`` (the workers in the aggregate); a non-finite
``coded_bits_est`` is reported as 0, and ``wire_bytes`` is kept (the
candidate's exchanges moved those bytes).  ``guard=False`` adds nothing.

A fault schedule (``fault_spec``, a
:class:`repro_torch.core.faults.FaultSpec` with device events) makes the
step take ``fault_step``, the train loop's step: every local gradient
goes through ``poison_grads``, every exchanged gradient mean through
``corrupt_mean``, and with ``drop`` events every exchange of the step
(the re-centering one included) takes this worker's liveness mask; the
exchange then renormalizes over the alive set and ``wire_bytes`` is
scaled by alive / K.  A spec with no events of a kind changes nothing of
the step's arithmetic for that kind.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import faults as faults_mod
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
    """The loss of a batch: cross entropy plus 0.01 x the MoE layers'
    auxiliary loss (exactly 0 without experts), a VLM's ``embeds`` at the
    prefix."""
    def loss_fn(batch: dict) -> torch.Tensor:
        logits, aux = model.forward_aux(batch["tokens"], batch.get("embeds"))
        return cross_entropy_loss(logits, batch["labels"], aux)

    return loss_fn


@torch.no_grad()
def _assign(params: list, values: list) -> None:
    for p, v in zip(params, values):
        p.copy_(v)


def make_train_step(model, opt_cfg: OptimizerConfig, exchange: Exchange, *,
                    guard: bool = False,
                    fault_spec: Optional[faults_mod.FaultSpec] = None):
    """Returns ``step(opt_state, ex_state, batch, noise, fault_step=None)
    -> (opt_state, ex_state, metrics)`` for this worker's ``batch`` shard;
    ``noise`` is this worker's noise source (:mod:`repro_torch.core.noise`);
    ``fault_step`` (the train loop's step, a host int) is required when
    ``fault_spec`` has device events."""
    method = get_method(opt_cfg.method)
    if opt_cfg.name == "qgenx" and method.name not in ("de", "optda"):
        raise ValueError(f"make_train_step supports qgenx methods 'de'/'optda', "
                         f"got {opt_cfg.method!r}")
    needs_fault_step = fault_spec is not None and fault_spec.has_device_events
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

    def grad_at(batch, fault_step):
        loss = loss_fn(batch)
        grads = list(torch.autograd.grad(loss, params))
        if needs_fault_step:
            grads = fault_spec.poison_grads(grads, fault_step, comm.rank)
        return loss.detach(), grads

    def adam_family_step(opt_state, ex_state, grads, exchange_grads, start):
        name = opt_cfg.name
        if name == "extra_adam":
            _, g1 = grads()
            g1, ex_state = exchange_grads(g1, ex_state)
            half = opt.extrapolate(opt_cfg, params, opt_state, g1)
            del g1
        elif name == "optimistic_adam":
            half = opt.extrapolate(opt_cfg, params, opt_state, opt_state.prev_half_grad)
        if name != "adam":
            # the commit steps from the starting params, not params_half
            if start is None:
                start = [p.detach().clone() for p in params]
            _assign(params, half)
            del half
        loss, g2 = grads()
        g2, ex_state = exchange_grads(g2, ex_state)
        new_params, opt_state = opt.commit(opt_cfg, start if start is not None else params,
                                           opt_state, g2)
        _assign(params, new_params)
        return loss, g2, opt_state, ex_state

    def qgenx_step(opt_state, ex_state, grads, exchange_grads, start):
        if method.uses_prev_half:
            ghat1 = opt_state.prev_half
            _assign(params, qgenx_opt.extrapolate(opt_cfg, params, opt_state, ghat1, K))
            loss, g2 = grads()
            ghat2, ex_state = exchange_grads(g2, ex_state)
            sq = qgenx_opt.local_sq_diff(ghat1, ghat2 if contractive else g2)
            prev_half = ghat2
        else:
            _, g1 = grads()
            ghat1, ex_state = exchange_grads(g1, ex_state)
            _assign(params, qgenx_opt.extrapolate(opt_cfg, params, opt_state, ghat1, K))
            first = ghat1 if contractive else g1  # the half of the pair sq needs
            del g1, ghat1
            loss, g2 = grads()
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
    def recenter(opt_state, ex_state, noise, mask):
        """One exchange of the iterates: qgenx's dual accumulator Y (then
        X = anchor + gamma Y), the adam family's params."""
        if opt_cfg.name == "qgenx":
            y_bar, ex_state = exchange.pmean_tree(opt_state.y, ex_state, noise, mask=mask,
                                                  guarded=guard)
            gamma = adaptive_gamma(opt_state.sum_sq, K, opt_cfg.gamma_scale)
            _assign(params, commit_params(opt_state.anchor, y_bar, gamma, like=params))
            return opt_state._replace(y=y_bar), ex_state
        p_bar, ex_state = exchange.pmean_tree(params, ex_state, noise, mask=mask,
                                              guarded=guard)
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

    def step(opt_state, ex_state, batch, noise, fault_step: Optional[int] = None):
        if needs_fault_step and fault_step is None:
            raise TypeError("this step's fault schedule has device events: pass "
                            "fault_step (the train loop's step)")
        opt_in, st_in = opt_state, ex_state
        count = opt_state.count
        is_sync = count % cfg.sync_every == cfg.sync_every - 1
        start_probe = probe() if is_sync and cfg.sync_every > 1 else None
        mask = (fault_spec.liveness(fault_step, comm.rank, params[0].device)
                if needs_fault_step else None)
        # the guard's copies of what the step writes in place
        start = err_in = None
        if guard:
            start = [p.detach().clone() for p in params]
            if contractive and is_sync:
                err_in = ex_state.error.clone()

        def exchange_mean(g, st):
            m, st = exchange.pmean_tree(g, st, noise, mask=mask, guarded=guard)
            if needs_fault_step:
                m = fault_spec.corrupt_mean(m, fault_step)
            return m, st

        exchange_grads = exchange_mean if is_sync else (lambda g, st: (g, st))
        loss, g2, opt_state, ex_state = body(opt_state, ex_state,
                                             lambda: grad_at(batch, fault_step),
                                             exchange_grads, start)
        # the gradient's metrics first, so the mean is freed before the
        # re-centering exchange allocates its own buffers
        per_call = exchange.wire_bytes_tree(g2, K)
        coded = 0.0
        if is_sync:
            coded = exchange.coded_bits_tree(g2, st_in) * (ex_state.step - st_in.step)
        del g2
        if cfg.recenter_every and count % cfg.recenter_every == cfg.recenter_every - 1:
            opt_state, ex_state = recenter(opt_state, ex_state, noise, mask)
        loss = comm.all_reduce_mean(loss)
        wire = per_call * (ex_state.step - st_in.step)
        alive = float(K)
        rejected = nonfinite = 0.0
        if guard or mask is not None:
            # one all-reduce and one fetch: [alive, any bad, any alive bad]
            flags = [mask if mask is not None else torch.ones((), device=loss.device)]
            if guard:
                bad = (~faults_mod.tree_all_finite(loss, params, opt_state,
                                                   ex_state)).float()
                flags += [bad, bad * mask if mask is not None else bad]
            got = comm.all_reduce_sum(torch.stack(flags)).tolist()
            if mask is not None:
                # only alive workers transmit: the fleet's bill is alive / K
                alive = got[0]
                wire = wire * (alive / K)
            if guard:
                nonfinite = float(got[1] > 0)
                rejected = float(got[2] > 0)
        drift = 0.0
        if start_probe is not None:
            drift = param_drift(start_probe)
            wire += probe_bytes
        if guard:
            if torch.is_tensor(coded):
                coded = torch.where(torch.isfinite(coded), coded, 0.0)
            if rejected:
                _assign(params, start)
                opt_state = opt_in
                ex_state = st_in if err_in is None else dataclasses.replace(st_in,
                                                                            error=err_in)
        return opt_state, ex_state, {"loss": loss, "wire_bytes": wire, "param_drift": drift,
                                     "coded_bits_est": coded, "rejected": rejected,
                                     "nonfinite": nonfinite, "alive": alive}

    return step


def make_prefill_step(model):
    """Forward-only (inference prefill): tokens [B, S] -> logits."""

    @torch.no_grad()
    def prefill(tokens: torch.Tensor) -> torch.Tensor:
        return model(tokens)

    return prefill


def make_serve_step(model):
    """One greedy decode step against a dense KV cache
    (:func:`repro_torch.models.transformer.decode_step`):
    ``(cache, token, pos) -> (next_token, logits, cache)``."""
    from repro_torch.models.transformer import decode_step

    def serve_step(cache: dict, token: torch.Tensor, pos: int):
        logits, cache = decode_step(model, cache, token, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return serve_step
