"""Mixture-of-experts layer with capacity-based token dispatch (port of
``repro/models/moe.py``).

Experts are stacked ``[E, ...]``: the router is f32 ``[D, E]``, the
experts' ``wi`` / ``wg`` ``[E, D, F]`` and ``wo`` ``[E, F, D]``, and the
shared experts (always on, beside the routed ones) one MLP of width
``moe_d_ff * num_shared_experts``.  Tokens are routed top-k by an f32
softmax (ties to the lower expert index, as ``jax.lax.top_k`` ranks them)
and scattered into per-expert capacity buffers ``[E, C, D]``; the experts
run as batched products over those buffers, and each token's results are
gathered back weighted by its renormalized gate.  The Switch auxiliary
load-balance loss is returned beside the output for the train loop.

Capacity couples the tokens of one call: ``C = max(1, round(T K / E
capacity_factor))`` (Python's ``round``, half to even) slots an expert,
filled in flattened ``(token, k)`` order, so earlier tokens win them and
a later token routed to a full expert is dropped (its gate is zero).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert has for a call over ``tokens`` tokens."""
    return int(max(1, round(tokens * cfg.num_experts_per_tok / cfg.num_experts
                            * cfg.capacity_factor)))


def route(p, cfg: ModelConfig, xt: torch.Tensor):
    """xt [T, D] -> (probs [T, E] f32, renormalized gates [T, K], expert
    indices [T, K]); ties go to the lower expert index."""
    K = cfg.num_experts_per_tok
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    if K == 1:
        expert_idx = torch.argmax(probs, dim=-1, keepdim=True)  # the first maximum
        gate_vals = torch.gather(probs, 1, expert_idx)
    else:
        gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, expert_idx = gate_vals[:, :K], expert_idx[:, :K]
    # at top-1 the gate p / max(p, 1e-9) is exactly 1 (p >= 1 / E): the router
    # learns through the auxiliary loss alone, but for the rounding of p / p's
    # derivative, which is kept as the reference computes it
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def slots(cfg: ModelConfig, expert_idx: torch.Tensor, cap: int):
    """Each (token, k)'s rank in its expert's queue, in flattened order ->
    (flat expert [T K], slot clipped to the capacity [T K], kept [T K])."""
    flat_expert = expert_idx.reshape(-1)
    onehot = F.one_hot(flat_expert, cfg.num_experts)
    flat_slot = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = flat_slot < cap
    return flat_expert, torch.clamp(flat_slot, 0, cap - 1), keep


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor):
    """x [B, S, D] -> (out [B, S, D], aux_loss f32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xt = x.reshape(T, D)
    probs, gate_vals, expert_idx = route(p, cfg, xt)

    # Switch load-balance auxiliary loss
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(expert_idx, E).float().sum(1), dim=0)
    aux = E * torch.sum(me * ce)

    cap = capacity(cfg, T)
    flat_expert, flat_slot, keep = slots(cfg, expert_idx, cap)
    flat_gate = torch.where(keep, gate_vals.reshape(-1), 0.0)
    cell = flat_expert * cap + flat_slot  # the (expert, slot) cell of each (token, k)
    token_of = torch.arange(T, device=x.device).repeat_interleave(K)

    # dispatch: each cell receives at most one kept token (dropped ones add 0)
    picked = torch.where(keep[:, None], xt[token_of], torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
    buf = torch.zeros((E * cap, D), dtype=x.dtype, device=x.device).index_add(0, cell, picked)
    buf = buf.reshape(E, cap, D)
    h = torch.bmm(buf, p["wi"])
    if "wg" in p:
        g = torch.bmm(buf, p["wg"])
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    out_buf = torch.bmm(h, p["wo"]).reshape(E * cap, D)

    # combine: each (token, k)'s result weighted by its gate, summed in f32
    weighted = out_buf[cell].float() * flat_gate[:, None]
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device).index_add(
        0, token_of, weighted).to(x.dtype)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], xt, cfg.mlp_type)
    return out.reshape(B, S, D), aux

