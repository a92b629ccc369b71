"""The exchange seam of Algorithm 1 — the qgenx and none compressors.

Port of the slice of ``repro/core/exchange.py`` that the data-parallel
train step runs: :class:`ExchangeConfig`, :class:`ExchangeState`,
:func:`make_exchange`, ``Exchange.pmean_tree`` through the
static :class:`~repro_torch.core.exchange_plan.ExchangePlan`, the qgenx
mean :func:`qgenx_pmean` in ``gather`` and ``two_phase`` modes, and the
analytic wire accounting.

Collectives go through a small communicator object: :class:`SingleWorker`
(world size 1, no process group needed) or :class:`ProcessGroupComm`
(``torch.distributed``: NCCL on the card, gloo on the CPU).  Every place
that rounds stochastically takes a noise source
(:mod:`repro_torch.core.noise`) in the order the reference draws its
noise: per exchange, the quantize draw, then (two_phase) the re-quantize
draw.

The quantize / dequantize steps always run the exchange kernels of
:mod:`repro_torch.kernels` — the port's counterpart of the reference's
``use_pallas=True`` path (``acc * (1/K)`` mean; C2 in ROADMAP.md).

Not ported, and rejected by :class:`ExchangeConfig` (an unported value
raises ``ValueError``, an unported field ``TypeError``): the randk,
layerwise and error-feedback compressors, mode ``leafwise``, QAda level
schedules, ``sync_every`` / ``recenter_every``, bucketed overlap, the
device-PRNG variants and the unplanned layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import exchange_plan as xplan
from repro_torch.core.quantization import QuantConfig, pad_to_buckets, uniform_levels
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.kernels.dequant_reduce import (
    dequant_reduce_blocks,
    dequant_reduce_requantize_blocks,
)
from repro_torch.kernels.dequantize import dequantize_blocks
from repro_torch.kernels.quantize import quantize_blocks

COMPRESSORS = ("none", "qgenx")

# ---------------------------------------------------------------------------
# Communicators
# ---------------------------------------------------------------------------


class SingleWorker:
    """World size 1: every collective is the identity (no process group)."""

    size = 1
    rank = 0

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t.unsqueeze(0)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        return t


class ProcessGroupComm:
    """Collectives over a ``torch.distributed`` process group (the default
    group when ``group`` is None); the caller owns the group's lifetime."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """[K, ...] with row k destined to worker k -> [K, ...] with row j
        received from worker j (``lax.all_to_all`` tiled on axis 0)."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[...] -> [K, ...] stacked in worker order."""
        flat = t.contiguous().reshape(-1)
        out = flat.new_empty((self.size * flat.numel(),))
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, flat, group=self.group)
        return out.reshape(self.size, *t.shape)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce_sum(t) / self.size


# ---------------------------------------------------------------------------
# Config + state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """The exchange's static configuration (reference field names).

    Only the slice's fields exist: a field of the reference that is not
    ported yet (``sync_every``, ``use_device_prng``, ...) is an unknown
    keyword and raises ``TypeError``; an unported value of a ported field
    raises ``ValueError``.
    """

    compressor: str = "qgenx"
    quant: Optional[QuantConfig] = None
    mode: str = "two_phase"

    def __post_init__(self):
        if self.compressor not in COMPRESSORS:
            raise ValueError(f"compressor {self.compressor!r} is not ported; "
                             f"ported: {COMPRESSORS}")
        if self.compressor == "qgenx" and self.quant is None:
            raise ValueError("compressor='qgenx' requires ExchangeConfig.quant")
        if self.mode not in ("gather", "two_phase"):
            raise ValueError(f"mode {self.mode!r} is not ported (gather | two_phase)")


@dataclasses.dataclass
class ExchangeState:
    """Explicit exchange state, threaded through the train step.

    The reference's six children are kept so later slices need no
    reshaping: ``levels`` (primary level table), ``levels_lo``
    (layerwise low-bit table), ``hist`` (QAda statistics), ``step`` (pmean
    calls made — a host int here, read without a device sync), ``error``
    (error-feedback memory) and ``pending`` (defer_tail slot); the last
    three are [1] placeholders in this slice.
    """

    levels: torch.Tensor
    levels_lo: torch.Tensor
    hist: torch.Tensor
    step: int
    error: torch.Tensor
    pending: torch.Tensor


# ---------------------------------------------------------------------------
# Wire accounting
# ---------------------------------------------------------------------------


def exchange_buffer_bytes(n: int, axis_size: int, cfg: QuantConfig,
                          mode: str = "two_phase") -> dict:
    """Exact sizes (bytes) of each buffer one worker hands to a collective."""
    per = 1.0 if cfg.bits == 8 else 0.5
    b = cfg.bucket_size
    if mode == "gather":
        nb = -(-n // b)
        return {"gather_payload": int(nb * b * per), "gather_norms": 4 * nb}
    if mode == "two_phase":
        quota = axis_size * b
        n_pad = -(-n // quota) * quota
        nb = n_pad // b
        nb_per_chunk = nb // axis_size
        return {
            "a2a_payload": int(n_pad * per),
            "a2a_norms": 4 * nb,
            "gather_payload": int(nb_per_chunk * b * per),
            "gather_norms": 4 * nb_per_chunk,
        }
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# The qgenx mean (Algorithm 1 on the wire)
# ---------------------------------------------------------------------------


def qgenx_pmean(x: torch.Tensor, comm, levels: torch.Tensor, noise,
                cfg: QuantConfig, mode: str = "two_phase") -> torch.Tensor:
    """Unbiased quantized mean of each worker's flat f32 vector ``x``.

    ``gather``: quantize -> all_gather -> dequant_reduce (kernels 1, 4).
    ``two_phase``: quantize -> all_to_all -> dequant_reduce_requantize ->
    all_gather -> dequantize (kernels 1, 2, 3).
    """
    K = comm.size
    n = x.shape[0]
    bucket = cfg.bucket_size
    q_is_inf = cfg.q_is_inf
    x = x.float()
    if mode == "gather":
        x2d, _ = pad_to_buckets(x, bucket)
        r = noise.uniform(x2d.shape, x2d.device)
        payload, norms = quantize_blocks(x2d, r, levels, num_symbols=cfg.num_symbols,
                                         q_is_inf=q_is_inf, bits=cfg.bits)
        del r
        mean2d = dequant_reduce_blocks(
            comm.all_gather(payload), comm.all_gather(norms), levels,
            num_symbols=cfg.num_symbols, num_workers=K, bits=cfg.bits)
        return mean2d.reshape(-1)[:n]
    if mode == "two_phase":
        # pad to whole K-bucket quotas: K equal chunks of whole buckets
        xq, _ = pad_to_buckets(x, K * bucket)
        nbpc = xq.shape[0]
        x2d = xq.reshape(K * nbpc, bucket)
        r = noise.uniform(x2d.shape, x2d.device)
        payload, norms = quantize_blocks(x2d, r, levels, num_symbols=cfg.num_symbols,
                                         q_is_inf=q_is_inf, bits=cfg.bits)
        del r
        # row k of the [K, nbpc, P] payload is the chunk destined to worker k
        p_t = comm.all_to_all(payload.reshape(K, nbpc, -1))
        n_t = comm.all_to_all(norms.reshape(K, nbpc))
        del payload, norms
        r2 = noise.uniform((nbpc, bucket), x2d.device)
        ridx, rnorms = dequant_reduce_requantize_blocks(
            p_t, n_t, levels, r2, num_symbols=cfg.num_symbols, num_workers=K,
            q_is_inf=q_is_inf, bits=cfg.bits)
        del r2, p_t, n_t
        g_idx = comm.all_gather(ridx).reshape(K * nbpc, -1)
        g_norms = comm.all_gather(rnorms).reshape(K * nbpc)
        out = dequantize_blocks(g_idx, g_norms, levels, num_symbols=cfg.num_symbols,
                                bits=cfg.bits)
        return out.reshape(-1)[:n]
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# The Exchange object
# ---------------------------------------------------------------------------


class Exchange:
    """A configured exchange over one communicator.

    ``pmean_tree`` returns ``(mean, new_state)``; the caller
    threads :class:`ExchangeState` like the reference's train step does.
    """

    def __init__(self, cfg: ExchangeConfig, comm):
        self.cfg = cfg
        self.comm = comm

    def init_state(self, device) -> ExchangeState:
        if self.cfg.compressor == "qgenx":
            lv = uniform_levels(self.cfg.quant.num_levels, device)
        else:
            lv = torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)
        ph = torch.zeros((1,), dtype=torch.float32, device=device)
        return ExchangeState(levels=lv, levels_lo=lv.clone(), hist=ph.clone(), step=0,
                             error=ph.clone(), pending=ph.clone())

    def plan_for(self, leaves, purpose: str = "pmean") -> xplan.ExchangePlan:
        """The static plan of this leaf list (one segment, every leaf, the
        primary level table — the qgenx policy; unquantized for none)."""
        lk = xplan.leaf_key(leaves)
        groups = ((tuple(range(len(lk))), self.cfg.quant, 0, None),)
        return xplan.build_plan(lk, groups, self.cfg.mode, int(self.comm.size), purpose)

    def pmean_tree(self, tree, state: ExchangeState, noise):
        """Mean of a gradient pytree (flattened in JAX order) over the
        workers: the none compressor reduces leaf by leaf; qgenx packs the
        leaves through the plan into one buffer and exchanges it."""
        leaves, spec = tree_flatten(tree)
        if self.cfg.compressor == "none":
            out = [self.comm.all_reduce_mean(l) for l in leaves]
        else:
            plan = self.plan_for(leaves)
            flat = plan.pack(leaves)
            mean = qgenx_pmean(flat, self.comm, state.levels, noise, self.cfg.quant,
                               self.cfg.mode)
            del flat
            out = plan.unpack(mean, leaves)
        return tree_unflatten(spec, out), dataclasses.replace(state, step=state.step + 1)

    def wire_bytes(self, n: int, axis_size: int) -> float:
        """Analytic collective-operand bytes per worker for one pmean of n
        coordinates (none: the ring all-reduce's 2(K-1)/K * 4n)."""
        if self.cfg.compressor == "none":
            return 2 * (axis_size - 1) / axis_size * 4.0 * n
        return float(sum(exchange_buffer_bytes(n, axis_size, self.cfg.quant,
                                               self.cfg.mode).values()))

    def wire_bytes_tree(self, tree, axis_size: int) -> float:
        leaves, _ = tree_flatten(tree)
        return self.wire_bytes(sum(xplan.size_of(l) for l in leaves), axis_size)


def make_exchange(cfg: ExchangeConfig, comm=None) -> Exchange:
    """An :class:`Exchange` over ``comm`` (default: :class:`SingleWorker`)."""
    return Exchange(cfg, comm if comm is not None else SingleWorker())
