"""The exchange seam of Algorithm 1 — the none, qgenx and layerwise
compressors.

Port of the slice of ``repro/core/exchange.py`` that the data-parallel
train step and the WGAN-GP testbed run: :class:`ExchangeConfig`,
:class:`ExchangeState`, :func:`make_exchange`, ``Exchange.pmean_tree``
through the static :class:`~repro_torch.core.exchange_plan.ExchangePlan`,
the qgenx mean :func:`qgenx_pmean` in ``gather`` and ``two_phase`` modes,
the per-worker ``Exchange.compress_tree`` (one segment-fused
quantize∘dequantize, :func:`~repro_torch.core.exchange_plan.fused_compress`),
and the analytic wire accounting.  The layerwise compressor sends leaves
above ``layerwise_threshold`` coordinates with the low-bit ``quant`` and
the rest with ``quant_small``, each group a segment of the plan with its
own level table.

Collectives go through a small communicator object: :class:`SingleWorker`
(world size 1, no process group needed) or :class:`ProcessGroupComm`
(``torch.distributed``: NCCL on the card, gloo on the CPU).  Every place
that rounds stochastically takes a noise source
(:mod:`repro_torch.core.noise`) in the order the reference draws its
noise: per exchange, the quantize draw, then (two_phase) the re-quantize
draw.  With ``ExchangeConfig(use_device_prng=True)`` each of those draws
is one 64-bit seed asked of the source instead of a ``[rows, bucket]``
f32 array, and the kernels draw the noise themselves (Philox, the port of
TPU kernel B5): no noise buffer is made.  The two draws of one exchange
take two seeds, as the reference's ``k1`` / ``k2``; each worker's source
is its own, as the reference folds the worker index into its key.

The quantize / dequantize steps always run the exchange kernels of
:mod:`repro_torch.kernels` — the port's counterpart of the reference's
``use_pallas=True`` path (``acc * (1/K)`` mean; C2 in ROADMAP.md).

Not ported, and rejected by :class:`ExchangeConfig` (an unported value
raises ``ValueError``, an unported field ``TypeError``): the randk and
error-feedback compressors, mode ``leafwise``, QAda level schedules,
``sync_every`` / ``recenter_every``, bucketed overlap and the unplanned
layout (``use_plan``).  The flat per-vector
``compress`` is not ported either: :class:`Exchange` has no such method.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import exchange_plan as xplan
from repro_torch.core.noise import draw_rounding
from repro_torch.core.quantization import QuantConfig, pad_to_buckets, uniform_levels
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.kernels.dequant_reduce import (
    dequant_reduce_blocks,
    dequant_reduce_requantize_blocks,
)
from repro_torch.kernels.dequantize import dequantize_blocks
from repro_torch.kernels.quantize import quantize_blocks

COMPRESSORS = ("none", "qgenx", "layerwise")

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

    Only the ported fields exist: a field of the reference that is not
    ported yet (``sync_every``, ``allreduce_fallback``, ...) is an unknown
    keyword and raises ``TypeError``; an unported value of a ported field
    raises ``ValueError``.  ``quant`` is the qgenx quantizer, or
    layerwise's low-bit one for leaves above ``layerwise_threshold``
    coordinates (default: 4 bit, s = 5, bucket 512); ``quant_small`` is
    layerwise's quantizer for the other leaves.  ``use_device_prng``: the
    kernels draw their rounding noise themselves from a seed (no noise
    buffer); the exact ``none`` compressor draws nothing either way.  The
    reference requires ``use_pallas`` for it; the port always runs its
    kernels, so nothing is left to check.
    """

    compressor: str = "qgenx"
    quant: Optional[QuantConfig] = None
    quant_small: QuantConfig = QuantConfig(num_levels=15, bits=8, bucket_size=512)
    mode: str = "two_phase"
    layerwise_threshold: int = 65536
    use_device_prng: bool = False

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
                cfg: QuantConfig, mode: str = "two_phase", *,
                use_device_prng: bool = False) -> torch.Tensor:
    """Unbiased quantized mean of each worker's flat f32 vector ``x``.

    ``gather``: quantize -> all_gather -> dequant_reduce (kernels 1, 4).
    ``two_phase``: quantize -> all_to_all -> dequant_reduce_requantize ->
    all_gather -> dequantize (kernels 1, 2, 3).  With ``use_device_prng``
    kernels 1 and 2 draw their noise from one seed each.
    """
    K = comm.size
    n = x.shape[0]
    bucket = cfg.bucket_size
    q_is_inf = cfg.q_is_inf
    x = x.float()
    if mode == "gather":
        x2d, _ = pad_to_buckets(x, bucket)
        r, seed = draw_rounding(noise, x2d.shape, x2d.device, use_device_prng)
        payload, norms = quantize_blocks(x2d, r, levels, num_symbols=cfg.num_symbols,
                                         q_is_inf=q_is_inf, bits=cfg.bits, seed=seed)
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
        r, seed = draw_rounding(noise, x2d.shape, x2d.device, use_device_prng)
        payload, norms = quantize_blocks(x2d, r, levels, num_symbols=cfg.num_symbols,
                                         q_is_inf=q_is_inf, bits=cfg.bits, seed=seed)
        del r
        # row k of the [K, nbpc, P] payload is the chunk destined to worker k
        p_t = comm.all_to_all(payload.reshape(K, nbpc, -1))
        n_t = comm.all_to_all(norms.reshape(K, nbpc))
        del payload, norms
        r2, seed2 = draw_rounding(noise, (nbpc, bucket), x2d.device, use_device_prng)
        ridx, rnorms = dequant_reduce_requantize_blocks(
            p_t, n_t, levels, r2, num_symbols=cfg.num_symbols, num_workers=K,
            q_is_inf=q_is_inf, bits=cfg.bits, seed=seed2)
        del r2, p_t, n_t
        g_idx = comm.all_gather(ridx).reshape(K * nbpc, -1)
        g_norms = comm.all_gather(rnorms).reshape(K * nbpc)
        out = dequantize_blocks(g_idx, g_norms, levels, num_symbols=cfg.num_symbols,
                                bits=cfg.bits)
        return out.reshape(-1)[:n]
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# Compressors
# ---------------------------------------------------------------------------

_DEFAULT_QUANT_LO = QuantConfig(num_levels=5, bits=4, bucket_size=512)


@functools.lru_cache(maxsize=None)
def _uniform_table(s: int, device: str) -> torch.Tensor:
    """The uniform level table a compressor falls back to (one per device;
    never written to)."""
    return uniform_levels(s, device)


class NoneCompressor:
    """Exact f32 mean — the control arm."""

    name = "none"
    has_levels = False

    def init_levels(self, cfg, device):
        lv = torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)
        return lv, lv.clone()

    def plan_groups(self, leaves_key, cfg):
        return ((tuple(range(len(leaves_key))), None, 0, None),)

    def pmean_leaves(self, leaves, exchange, state, noise):
        return [exchange.comm.all_reduce_mean(l) for l in leaves]

    def compress_tree(self, leaves, cfg, levels, noise, lead):
        return list(leaves)

    def wire_bytes(self, n, axis_size, cfg):
        return 2 * (axis_size - 1) / axis_size * 4.0 * n

    def wire_bytes_tree(self, sizes, axis_size, cfg):
        return self.wire_bytes(sum(sizes), axis_size, cfg)

    def compress_wire_bytes(self, n, cfg):
        return 4.0 * n


class QgenxCompressor(NoneCompressor):
    """The paper's bucketed stochastic quantization (Definition 1): one plan
    segment, every leaf, the primary level table."""

    name = "qgenx"
    has_levels = True

    def init_levels(self, cfg, device):
        lv = uniform_levels(cfg.quant.num_levels, device)
        return lv, lv.clone()

    def plan_groups(self, leaves_key, cfg):
        return ((tuple(range(len(leaves_key))), cfg.quant, 0, None),)

    def pmean_leaves(self, leaves, exchange, state, noise):
        plan = exchange.plan_for(leaves)
        mean = qgenx_pmean(plan.pack(leaves), exchange.comm, state.levels, noise,
                           exchange.cfg.quant, exchange.cfg.mode,
                           use_device_prng=exchange.cfg.use_device_prng)
        return plan.unpack(mean, leaves)

    def _segment_table(self, seg, levels, device):
        return levels if levels is not None else _uniform_table(seg.quant.num_levels, device)

    def compress_tree(self, leaves, cfg, levels, noise, lead):
        """One segment-fused quantize∘dequantize over the packed buffer."""
        lk = xplan.leaf_key(leaves, lead)
        plan = xplan.build_plan(lk, self.plan_groups(lk, cfg), cfg.mode, 1, "compress")
        batch = tuple(leaves[0].shape[:lead])
        dev = str(leaves[0].device)
        tables = tuple(self._segment_table(seg, levels, dev) for seg in plan.segments)
        hat = xplan.fused_compress(plan, plan.pack(leaves, batch).reshape(-1, plan.total),
                                   tables, noise, use_device_prng=cfg.use_device_prng)
        return plan.unpack(hat.reshape(*batch, plan.total), leaves)

    def wire_bytes(self, n, axis_size, cfg):
        return float(sum(exchange_buffer_bytes(n, axis_size, cfg.quant, cfg.mode).values()))

    def compress_wire_bytes(self, n, cfg):
        return float(cfg.quant.payload_bytes(n))


class LayerwiseCompressor(QgenxCompressor):
    """Per-leaf bit-width policy: leaves above ``layerwise_threshold``
    coordinates take the low-bit ``quant`` (segment 0, table 1 =
    ``levels_lo``, key tag 0), the rest ``quant_small`` (segment 1, table
    0 = ``levels``, key tag 1); each segment is its own qgenx exchange."""

    name = "layerwise"

    def _cfgs(self, cfg):
        return (cfg.quant if cfg.quant is not None else _DEFAULT_QUANT_LO), cfg.quant_small

    def init_levels(self, cfg, device):
        lo, hi = self._cfgs(cfg)
        return uniform_levels(hi.num_levels, device), uniform_levels(lo.num_levels, device)

    def plan_groups(self, leaves_key, cfg):
        lo, hi = self._cfgs(cfg)
        sizes = [xplan.size_of(shape) for shape, _ in leaves_key]
        big = tuple(i for i, s in enumerate(sizes) if s > cfg.layerwise_threshold)
        small = tuple(i for i, s in enumerate(sizes) if s <= cfg.layerwise_threshold)
        return tuple((ids, qc, table, gid)
                     for gid, (ids, qc, table) in enumerate(((big, lo, 1), (small, hi, 0)))
                     if ids)

    def pmean_leaves(self, leaves, exchange, state, noise):
        """One qgenx exchange per plan segment, in segment order, each on
        its pre-padded slice of the shared buffer with its own table (the
        reference keys segment ``seg`` with ``fold_in(key, seg.key_tag)``,
        so the noise is drawn in segment order)."""
        plan = exchange.plan_for(leaves)
        flat = plan.pack(leaves)
        outs = [qgenx_pmean(flat[seg.start: seg.stop], exchange.comm,
                            state.levels_lo if seg.table == 1 else state.levels, noise,
                            seg.quant, exchange.cfg.mode,
                            use_device_prng=exchange.cfg.use_device_prng)
                for seg in plan.segments]
        del flat
        return plan.unpack(outs[0] if len(outs) == 1 else torch.cat(outs), leaves)

    def _segment_table(self, seg, levels, device):
        """The caller's table when it fits this segment's quantizer; the
        uniform table otherwise (the reference's ``_segment_table``)."""
        if levels is not None and levels.shape[0] == seg.quant.num_symbols:
            return levels
        return _uniform_table(seg.quant.num_levels, device)

    def wire_bytes(self, n, axis_size, cfg):
        lo, hi = self._cfgs(cfg)
        qcfg = lo if n > cfg.layerwise_threshold else hi
        return float(sum(exchange_buffer_bytes(n, axis_size, qcfg, cfg.mode).values()))

    def wire_bytes_tree(self, sizes, axis_size, cfg):
        lo, hi = self._cfgs(cfg)
        total = 0.0
        for qcfg, group in ((lo, [s for s in sizes if s > cfg.layerwise_threshold]),
                            (hi, [s for s in sizes if s <= cfg.layerwise_threshold])):
            if group:
                total += sum(exchange_buffer_bytes(sum(group), axis_size, qcfg,
                                                   cfg.mode).values())
        return float(total)

    def compress_wire_bytes(self, n, cfg):
        lo, hi = self._cfgs(cfg)
        return float((lo if n > cfg.layerwise_threshold else hi).payload_bytes(n))


_COMPRESSORS = {c.name: c() for c in (NoneCompressor, QgenxCompressor, LayerwiseCompressor)}


# ---------------------------------------------------------------------------
# The Exchange object
# ---------------------------------------------------------------------------


class Exchange:
    """A configured exchange over one communicator.

    ``pmean_tree`` returns ``(mean, new_state)``; the caller threads
    :class:`ExchangeState` like the reference's train step does.
    ``compress_tree`` is the collective-free per-worker estimate the
    simulated-worker testbed (``repro_torch.gan``) uses.
    """

    def __init__(self, cfg: ExchangeConfig, comm):
        self.cfg = cfg
        self.comm = comm
        self.compressor = _COMPRESSORS[cfg.compressor]

    def init_state(self, device) -> ExchangeState:
        lv, lv_lo = self.compressor.init_levels(self.cfg, device)
        ph = torch.zeros((1,), dtype=torch.float32, device=device)
        return ExchangeState(levels=lv, levels_lo=lv_lo, hist=ph.clone(), step=0,
                             error=ph.clone(), pending=ph.clone())

    def plan_for(self, leaves, purpose: str = "pmean", axis_size=None) -> xplan.ExchangePlan:
        """The static plan of this leaf list under the compressor's segment
        policy (``axis_size`` defaults to the communicator's size)."""
        lk = xplan.leaf_key(leaves)
        size = int(self.comm.size if axis_size is None else axis_size)
        return xplan.build_plan(lk, self.compressor.plan_groups(lk, self.cfg),
                                self.cfg.mode, size, purpose)

    def plan_for_tree(self, tree, axis_size: int = 1,
                      purpose: str = "pmean") -> xplan.ExchangePlan:
        return self.plan_for(tree_flatten(tree)[0], purpose, axis_size)

    def pmean_tree(self, tree, state: ExchangeState, noise):
        """Mean of a gradient pytree (flattened in JAX order) over the
        workers: none reduces leaf by leaf; qgenx packs the leaves through
        the plan into one buffer and exchanges it; layerwise exchanges each
        segment of that buffer."""
        leaves, spec = tree_flatten(tree)
        out = self.compressor.pmean_leaves(leaves, self, state, noise)
        return tree_unflatten(spec, out), dataclasses.replace(state, step=state.step + 1)

    def compress_tree(self, tree, noise, levels: Optional[torch.Tensor] = None,
                      workers: bool = False):
        """Per-worker unbiased estimate of a pytree, no collectives: one
        fused quantize∘dequantize over the planned buffer (kernel 5).

        ``levels=None`` takes the uniform tables.  With ``workers=True``
        every leaf carries a leading worker dim and all workers' buffers go
        through one launch per row geometry, each worker with its own noise
        draw (asked in worker order; with ``use_device_prng`` one seed per
        launch, the workers' rows being distinct Philox counters)."""
        leaves, spec = tree_flatten(tree)
        out = self.compressor.compress_tree(leaves, self.cfg, levels, noise, int(workers))
        return tree_unflatten(spec, out)

    def wire_bytes(self, n: int, axis_size: int) -> float:
        """Analytic collective-operand bytes per worker for one pmean of n
        coordinates (none: the ring all-reduce's 2(K-1)/K * 4n)."""
        return self.compressor.wire_bytes(n, axis_size, self.cfg)

    def wire_bytes_tree(self, tree, axis_size: int) -> float:
        """The same for one ``pmean_tree`` of this pytree (the layerwise
        policy bills each size group as its own exchange)."""
        sizes = [xplan.size_of(l) for l in tree_flatten(tree)[0]]
        return self.compressor.wire_bytes_tree(sizes, axis_size, self.cfg)

    def compress_wire_bytes(self, n: int) -> float:
        """Bytes one worker broadcasts for one compressed n-vector."""
        return self.compressor.compress_wire_bytes(n, self.cfg)

    def compress_wire_bytes_tree(self, tree) -> float:
        """Broadcast bytes of one ``compress_tree`` of this pytree: one
        shared padding tail per plan segment for the level-table
        compressors, 4 B per coordinate for none."""
        leaves = tree_flatten(tree)[0]
        if self.compressor.has_levels:
            return self.plan_for(leaves, "compress", 1).compress_payload_bytes()
        return float(sum(self.compress_wire_bytes(xplan.size_of(l)) for l in leaves))


def make_exchange(cfg: ExchangeConfig, comm=None) -> Exchange:
    """An :class:`Exchange` over ``comm`` (default: :class:`SingleWorker`)."""
    return Exchange(cfg, comm if comm is not None else SingleWorker())
