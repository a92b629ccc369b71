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

The wire recorder (:func:`wire_trace_start` / :func:`wire_trace_stop`,
:func:`record_wire`, :func:`wire_scope`) names every buffer the exchange
hands to a collective, under the reference's names.  The reference
records at trace time, once per call site; the port records at run time,
once per collective that runs, so the two lists agree on a step that
runs every exchange it has (a sync step).  ``Exchange.coded_bits_tree``
is the Theorem 2 entropy-coded estimate of one worker's broadcast
(:func:`expected_index_pmf`, :func:`theorem2_bits_traced`).

The train step's local-update fields ``sync_every`` / ``drift_probe`` /
``recenter_every`` live in :class:`ExchangeConfig` as in the reference;
:mod:`repro_torch.launch.steps` reads them.

QAda (``level_schedule="qada"``, Section 3.3): every exchange call adds
the weighted histogram of the exchanged tree's normalized coordinates
(:mod:`repro_torch.core.adaptive_levels`, per leaf, each leaf padded to
buckets on its own, on the tree's device) to ``ExchangeState.hist``,
merged over the workers with one all-reduce (recorded as ``qada_hist``
and billed at ``4 * qada_bins`` bytes a call); the call that completes a
period of ``level_update_every`` calls solves new level tables from it on
the host and zeroes it.  ``ExchangeState.step`` is a host int, so the
refresh is a host branch and the solve is paid on refresh calls only.
A non-finite histogram (outside the train step's guard) or a solved
table that fails :func:`~repro_torch.core.quantization.validate_levels`
raises ``ValueError``; the old table is never silently kept in its
place.  The flat per-vector ``compress`` / ``compress_with_levels`` (the
toy-VI loop's estimate) is ``compress_tree`` of one tensor, and
``qada_propose`` one refresh from the caller's vectors.

The sparse compressors send k coordinates a worker: ``randk`` (unbiased:
a uniform k-subset from the noise source's ``subset`` draw, values
scaled by n/k, the all-gathered values scatter-added worker by worker and
divided by K) and the contractive tier with EF21 error feedback,
``ef21-topk`` (the k largest |innovation|, ties to the lower index as
``jax.lax.top_k`` keeps them: :func:`topk_support`) and ``ef-randk``
(a uniform support, no rescale).  Each worker's ``[K, n]`` memory
``ExchangeState.error`` is replicated: every worker replays all K
workers' gathered innovations into it, in place.  Their wire is k f32
values and k int32 indices a worker (``randk_vals`` / ``randk_idx``,
``ef21_*``, ``ef_randk_*``).  None of them runs an exchange kernel: the
reference computes them outside any Pallas kernel too.  The registry
(:func:`get_compressor`, :func:`registered_compressors`) declares each
compressor's contract tier.

Partial participation: ``Exchange.pmean_tree(..., mask=m)`` takes this
worker's liveness, an f32 scalar (1.0 alive, 0.0 dropped).  A dropped
worker's leaves are zeroed with ``where`` (not a multiply, so its NaN
vanishes too) before they enter the exchange, which runs as before
(every worker still takes part in the collectives), and the mean is
rescaled by ``K / alive`` (alive = the all-reduced mask, clamped at 1):
the mean over the alive set.  With an all-ones mask the factor is exactly
1.0 and the mean is bit-equal to the unmasked one.  A dropped worker's
QAda histogram is zeroed with ``where`` before the merge.  The
contractive tier refuses a mask (its memory would go stale).  With
``guarded=True`` (the train step's guard) a QAda refresh from a
non-finite histogram keeps the old tables and leaves that histogram in
the new state, for the caller's finiteness check to reject, instead of
raising.

The layouts.  By default (``use_plan=True``, ``num_buckets=1``) a tree
goes through one plan, packed once.  ``use_plan=False`` is the per-call
layout.  The reference's per-call ``pmean_tree`` concatenates the leaves
in f32 and lets the exchange pad the buffer (layerwise: one concatenation
per size group); for every compressor that buffer is the plan's,
coordinate for coordinate, with the same tables and draws, so the port's
``pmean_tree`` goes through the plan under either layout and gives the
reference's per-call means bit for bit.  What the flag changes is
``compress_tree``, which then runs leaf by leaf (one launch of kernel 5 a
leaf, each leaf with its own padding tail and its own draw), and the
broadcast billed leaf by leaf; ``coded_bits_tree`` is the same under both
(the one-segment compress plan is the concatenate-and-pad buffer).

The bucketed exchange (``num_buckets`` = B >= 2 with ``overlap`` =
``"bucketed"`` or ``"defer_tail"``): :func:`~repro_torch.core.exchange_plan.partition_leaf_ids`
splits the leaves into B contiguous runs, each planned alone through the
compressor's segment policy and exchanged as its own chain, highest bucket
first (backprop order); each bucket asks the noise source for its draws
in that order (the reference keys bucket ``bi`` with ``fold_in(key,
bi)``), and its wire operands are recorded under ``b{bi}/``.  The
reference leaves the overlap to XLA's scheduler; the port issues each
bucket's last collectives with ``async_op=True`` and waits on them only
when the bucket's mean is unpacked, after the next bucket's quantize has
been launched (:func:`_pipeline`: two chains live at a time; a chain makes
every noise draw before its collectives go out, so the draws come in the
serial order and the means are the serial order's bit for bit).
:class:`SingleWorker` has nothing to overlap.  Each bucket's range is
named ``exchange/bucket{bi}`` for ``torch.profiler``.  Under
``defer_tail`` bucket 0's mean is not applied: it goes into the new
``ExchangeState.pending`` and its leaves get the old ``pending`` (zeros on
the first sync), sized by ``init_state(template=, num_workers=)``; every
``pmean_tree`` through this exchange swaps it, the re-centering one too,
as in the reference.  A mask under ``defer_tail`` raises.

The ``leafwise`` mode (qgenx and none only): each leaf is quantized in
place in rows over its trailing dim (kernel 1 with ``bucket`` = that dim;
int4 is packed only when the dim is even, else the 4-bit table's indices
travel as int8, as the reference's ``pack4`` rule), the payload and norms
are all-gathered and kernel 4 takes the mean of the K payloads.  With
``allreduce_fallback`` each worker dequantizes its own payload (kernel 3)
and the f32 estimate is all-reduced and divided by K.  The noise is one
``noise.uniform(leaf.shape)`` draw a leaf, in leaf order, whatever
``use_device_prng`` says (the reference's leafwise path draws with
``jax.random`` and reaches no kernel).  Leaves are exchanged one after
another.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import adaptive_levels as qada
from repro_torch.core import exchange_plan as xplan
from repro_torch.core.coding import C_B
from repro_torch.core.noise import draw_rounding
from repro_torch.core.quantization import (
    _NEAREST_NOISE,
    QuantConfig,
    bucket_norms,
    pad_to_buckets,
    quantize_dequantize,
    uniform_levels,
    validate_levels,
)
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.kernels.dequant_reduce import (
    dequant_reduce_blocks,
    dequant_reduce_requantize_blocks,
)
from repro_torch.kernels.dequantize import dequantize_blocks
from repro_torch.kernels.quantize import quantize_blocks

# bucket rows of one chunk of Exchange.coded_bits_tree (2^16 x 512
# coordinates: ~1.3 GB of temporaries at the peak of a chunk)
CODED_CHUNK_ROWS = 1 << 16

# ---------------------------------------------------------------------------
# Communicators
# ---------------------------------------------------------------------------


class _Ready:
    """A collective that has already completed: ``wait()`` returns its
    result."""

    def __init__(self, out: torch.Tensor):
        self.out = out

    def wait(self) -> torch.Tensor:
        return self.out


class _InFlight:
    """A collective issued with ``async_op=True``: ``wait()`` waits for it
    and returns its result (``post`` of it, when given).  Holds the
    operand until then."""

    def __init__(self, work, operand: torch.Tensor, out: torch.Tensor, post=None):
        self.work, self.operand, self.out, self.post = work, operand, out, post

    def wait(self) -> torch.Tensor:
        self.work.wait()
        self.operand = None
        return self.out if self.post is None else self.post(self.out)


class SingleWorker:
    """World size 1: every collective is the identity (no process group).
    ``start_*`` return a completed handle (nothing to overlap)."""

    size = 1
    rank = 0

    def start_all_gather(self, t: torch.Tensor) -> _Ready:
        return _Ready(t.unsqueeze(0))

    def start_all_reduce_sum(self, t: torch.Tensor) -> _Ready:
        return _Ready(t)

    def start_all_reduce_mean(self, t: torch.Tensor) -> _Ready:
        return _Ready(t)

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
    group when ``group`` is None); the caller owns the group's lifetime.
    Each ``start_*`` issues its collective with ``async_op=True`` and
    returns a handle whose ``wait()`` gives the result; the plain methods
    wait at once."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def start_all_gather(self, t: torch.Tensor) -> _InFlight:
        """[...] -> [K, ...] stacked in worker order."""
        flat = t.contiguous().reshape(-1)
        out = flat.new_empty((self.size * flat.numel(),))
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        work = gather(out, flat, group=self.group, async_op=True)
        return _InFlight(work, flat, out.reshape(self.size, *t.shape))

    def start_all_reduce_sum(self, t: torch.Tensor) -> _InFlight:
        t = t.clone()
        work = dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group, async_op=True)
        return _InFlight(work, t, t)

    def start_all_reduce_mean(self, t: torch.Tensor) -> _InFlight:
        h = self.start_all_reduce_sum(t)
        h.post = lambda s: s / self.size
        return h

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """[K, ...] with row k destined to worker k -> [K, ...] with row j
        received from worker j (``lax.all_to_all`` tiled on axis 0)."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.start_all_gather(t).wait()

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.start_all_reduce_sum(t).wait()

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        return self.start_all_reduce_mean(t).wait()


# ---------------------------------------------------------------------------
# Config + state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """The exchange's static configuration (reference field names).

    Only the ported fields exist: a field of the reference that is not
    ported yet (``axis_name``, ``use_pallas``, ``interpret``) is an unknown
    keyword and raises ``TypeError``; an invalid combination raises the
    reference's ``ValueError`` (the checks of its ``__post_init__`` and of
    ``Compressor.validate``, which the reference runs in
    ``make_exchange``, both run here).  ``quant`` is the qgenx quantizer, or
    layerwise's low-bit one for leaves above ``layerwise_threshold``
    coordinates (default: 4 bit, s = 5, bucket 512); ``quant_small`` is
    layerwise's quantizer for the other leaves.  ``use_device_prng``: the
    kernels draw their rounding noise themselves from a seed (no noise
    buffer); the exact ``none`` compressor draws nothing either way.  The
    reference requires ``use_pallas`` for it; the port always runs its
    kernels, so nothing is left to check.

    The local-update regime (read by the train step): ``sync_every`` —
    the step exchanges only on every ``sync_every``-th optimizer step
    (1 = every step); ``drift_probe`` — the leading parameter
    coordinates the ``param_drift`` probe takes on a sync step (its only
    extra wire traffic, counted); ``recenter_every`` — every
    ``recenter_every``-th step the iterates are re-centered through this
    exchange (0 = never).

    QAda: ``level_schedule`` ``"fixed"`` | ``"qada"``; under ``qada`` the
    level tables are refreshed every ``level_update_every`` exchange calls
    (required > 0) from a ``qada_bins``-bin histogram, by
    ``qada_sweeps`` coordinate-descent sweeps of ``qada_bisect_iters``
    bisection steps.

    The sparse compressors: ``rand_frac`` — the share of coordinates
    ``randk`` and ``ef-randk`` keep; ``ef_topk_frac`` — ``ef21-topk``'s
    (each in (0, 1]).  A contractive compressor cannot re-center
    (``recenter_every`` must be 0): its memory tracks gradient
    innovations.

    The layouts (the module docstring has the detail): ``mode`` may also
    be ``"leafwise"`` (qgenx and none only), where ``allreduce_fallback``
    all-reduces each worker's dequantized f32 estimate instead of
    gathering the payloads; ``use_plan=False`` is the per-call layout;
    ``num_buckets`` >= 2 with ``overlap`` ``"bucketed"`` or
    ``"defer_tail"`` is the bucketed exchange (planned, flat modes, no
    error feedback), and ``num_buckets=1, overlap="off"`` the default
    monolithic one.
    """

    compressor: str = "qgenx"
    quant: Optional[QuantConfig] = None
    quant_small: QuantConfig = QuantConfig(num_levels=15, bits=8, bucket_size=512)
    mode: str = "two_phase"
    layerwise_threshold: int = 65536
    use_device_prng: bool = False
    sync_every: int = 1
    drift_probe: int = 4096
    recenter_every: int = 0
    level_schedule: str = "fixed"
    level_update_every: int = 0
    qada_bins: int = 512
    qada_sweeps: int = 2
    qada_bisect_iters: int = 20
    rand_frac: float = 0.25
    ef_topk_frac: float = 0.25
    allreduce_fallback: bool = False
    use_plan: bool = True
    num_buckets: int = 1
    overlap: str = "off"

    def __post_init__(self):
        comp = get_compressor(self.compressor)
        if self.mode not in ("gather", "two_phase", "leafwise"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.overlap not in ("off", "bucketed", "defer_tail"):
            raise ValueError(f"unknown overlap {self.overlap!r}")
        if self.num_buckets < 1:
            raise ValueError(f"num_buckets must be >= 1, got {self.num_buckets}")
        if self.overlap != "off":
            if self.num_buckets < 2:
                raise ValueError(
                    f"overlap={self.overlap!r} needs num_buckets >= 2 (one bucket has "
                    "nothing to overlap); use overlap='off' for the monolithic exchange")
            if not self.use_plan:
                raise ValueError(
                    "bucketed overlap requires use_plan=True: the bucket sub-plans ARE "
                    "ExchangePlans (contiguous runs of whole segments) — there is no "
                    "per-call-layout bucketing")
            if self.mode == "leafwise":
                raise ValueError(
                    "mode='leafwise' has no flat buffer to bucket (each leaf is already "
                    "an independent collective chain; XLA overlaps them natively) — "
                    "bucketing applies to the gather/two_phase flat-buffer modes")
        elif self.num_buckets > 1:
            raise ValueError(
                f"num_buckets={self.num_buckets} with overlap='off' is ambiguous — the "
                "monolithic path ignores buckets; set overlap='bucketed' (or "
                "'defer_tail') to enter the bucketed pipeline, or num_buckets=1 to be "
                "explicit")
        if self.allreduce_fallback and self.mode != "leafwise":
            raise ValueError(
                "allreduce_fallback is a leafwise-exchange escape hatch; "
                f"mode={self.mode!r} would still all-gather/all-to-all and hit the "
                "partial-manual partitioner abort — use mode='leafwise'")
        if self.mode == "leafwise" and self.compressor not in ("qgenx", "none"):
            raise ValueError(
                f"compressor {self.compressor!r} ({comp.contract} contract) has no "
                "sharding-preserving leafwise path; use mode='gather' or 'two_phase'")
        if self.overlap != "off" and comp.has_error:
            raise ValueError(
                f"compressor {self.compressor!r} (contractive contract) cannot run the "
                "bucketed overlapped exchange: its [num_workers, n] error memory "
                "scatter-adds row offsets into the WHOLE-plan flat buffer atomically, and "
                "bucketing would split that update across independently-keyed chains — "
                "use overlap='off' (the EF path stays monolithic)")
        if self.compressor == "qgenx" and self.quant is None:
            raise ValueError("compressor='qgenx' requires ExchangeConfig.quant")
        if self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {self.sync_every}")
        if self.drift_probe < 1:
            raise ValueError(f"drift_probe must be >= 1, got {self.drift_probe}")
        if self.recenter_every < 0:
            raise ValueError(
                f"recenter_every must be >= 0, got {self.recenter_every}"
            )
        if self.level_schedule not in ("fixed", "qada"):
            raise ValueError(f"unknown level_schedule {self.level_schedule!r}")
        if self.level_schedule == "qada" and self.level_update_every <= 0:
            raise ValueError("level_schedule='qada' needs level_update_every > 0")
        if not 0.0 < self.rand_frac <= 1.0:
            raise ValueError(f"rand_frac must be in (0, 1], got {self.rand_frac}")
        if not 0.0 < self.ef_topk_frac <= 1.0:
            raise ValueError(f"ef_topk_frac must be in (0, 1], got {self.ef_topk_frac}")
        if comp.has_error and self.recenter_every > 0:
            raise ValueError(
                f"compressor {self.compressor!r} (contractive contract) cannot re-center "
                "parameters: the per-worker error memory tracks gradient innovations, and "
                "a recenter exchange would fold iterate residuals into it; set "
                "recenter_every=0")


@dataclasses.dataclass
class ExchangeState:
    """Explicit exchange state, threaded through the train step.

    The reference's six children: ``levels`` (primary level table),
    ``levels_lo`` (layerwise low-bit table), ``hist`` (QAda statistics
    since the last refresh: ``[qada_bins]`` under the qada schedule, a
    [1] placeholder otherwise), ``step`` (pmean calls made — a host int
    here, read without a device sync), ``error`` (the contractive tier's
    ``[num_workers, n]`` error-feedback memory, replicated over the
    workers; a [1] placeholder for every other compressor) and ``pending``
    (``overlap="defer_tail"``: the f32 mean of the tail bucket's last
    exchange, its padded plan length long, replicated over the workers,
    applied at the next call; a [1] placeholder otherwise).
    """

    levels: torch.Tensor
    levels_lo: torch.Tensor
    hist: torch.Tensor
    step: int
    error: torch.Tensor
    pending: torch.Tensor


# ---------------------------------------------------------------------------
# Wire accounting (run-time recorder + analytic buffer sizes)
# ---------------------------------------------------------------------------

_WIRE_TRACE: Optional[list] = None
_WIRE_PREFIX: str = ""


def wire_trace_start() -> None:
    """Begin recording ``(name, nbytes)`` for every buffer handed to a
    collective.  The port records when the collective runs (the reference
    when its step is traced): a step that does not sync records nothing."""
    global _WIRE_TRACE
    _WIRE_TRACE = []


def wire_trace_stop() -> list:
    """End recording; the ``[(name, nbytes), ...]`` collected since
    :func:`wire_trace_start` (empty when nothing ran)."""
    global _WIRE_TRACE
    rec, _WIRE_TRACE = _WIRE_TRACE, None
    return rec or []


@contextlib.contextmanager
def wire_scope(prefix: str):
    """Every operand recorded inside gets ``prefix`` prepended to its name;
    scopes nest by concatenation."""
    global _WIRE_PREFIX
    old = _WIRE_PREFIX
    _WIRE_PREFIX = old + prefix
    try:
        yield
    finally:
        _WIRE_PREFIX = old


def record_wire(name: str, t: torch.Tensor) -> None:
    """Count ``t`` as a collective operand in the active recording (free
    when none is active)."""
    if _WIRE_TRACE is not None:
        _WIRE_TRACE.append((_WIRE_PREFIX + name, t.numel() * t.element_size()))


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


def leafwise_buffer_bytes(shape: tuple, cfg: QuantConfig) -> dict:
    """Collective-operand bytes of one leaf of the leafwise exchange: the
    payload keeps the leaf's shape (its trailing dim halved when int4 is
    packed, which needs that dim even) and one f32 norm per trailing
    row."""
    d = shape[-1]
    rows = 1
    for s in shape[:-1]:
        rows *= s
    pack4 = cfg.bits == 4 and d % 2 == 0
    return {"leaf_payload": rows * (d // 2 if pack4 else d), "leaf_norms": 4 * rows}


def wire_bytes_per_device(n: int, axis_size: int, cfg: Optional[QuantConfig],
                          mode: str = "two_phase") -> float:
    """Bytes each worker transmits per reduction: an all_gather operand
    enters the network once; a tiled all_to_all keeps 1/K of its buffer
    local.  ``cfg=None``: the ring all-reduce of f32, 2(K-1)/K * 4n."""
    if cfg is None:
        return 2 * (axis_size - 1) / axis_size * 4.0 * n
    sizes = exchange_buffer_bytes(n, axis_size, cfg, mode)
    if mode == "gather":
        return float(sizes["gather_payload"] + sizes["gather_norms"])
    a2a = sizes["a2a_payload"] + sizes["a2a_norms"]
    gather = sizes["gather_payload"] + sizes["gather_norms"]
    return float(a2a * (axis_size - 1) / axis_size + gather)


# ---------------------------------------------------------------------------
# Entropy-coded wire estimate (Theorem 2)
# ---------------------------------------------------------------------------


def _bracket_select(u: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """The bracket index of normalized magnitudes ``u`` in [0, 1]:
    ``clip(searchsorted(levels, u, 'right') - 1, 0, s)``, the count of
    interior levels at or below u (the table is sorted); int32."""
    return torch.searchsorted(levels[1:-1].contiguous(), u.contiguous(), right=True,
                              out_int32=True)


def _index_mass(u: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Per-symbol expected counts of ``u`` ([rows, n]) under unbiased
    rounding: a coordinate in bracket tau, at fractional position
    xi = (u - l_tau) / (l_tau+1 - l_tau), gives 1 - xi to symbol tau and
    xi to tau + 1.  Returns [num_symbols] f64.

    Per bracket j only the count C_j and the sum U_j of u are needed: the
    mass rounded up is X_j = (U_j - C_j l_j) / (l_j+1 - l_j), and symbol j
    gets C_j - X_j + X_j-1.  Both sums come from ``bincount``s keyed by
    (row, bracket), so a bin takes at most n adds (f32) and no bin is
    shared by the whole buffer; the rows then add up in f64."""
    lv = levels.double()
    s = lv.shape[0]
    rows = u.shape[0]
    tau = _bracket_select(u, levels.float())
    key = tau.add_(torch.arange(rows, device=u.device, dtype=torch.int32)[:, None] * s)
    key = key.reshape(-1)
    usum = torch.bincount(key, weights=u.reshape(-1), minlength=rows * s)
    usum = usum.view(rows, s).sum(0, dtype=torch.float64)[: s - 1]
    count = torch.bincount(key, minlength=rows * s).view(rows, s).sum(0).double()[: s - 1]
    up = (usum - count * lv[:-1]) / (lv[1:] - lv[:-1])
    mass = torch.zeros(s, dtype=torch.float64, device=u.device)
    mass[:-1] = count - up
    mass[1:] += up
    return mass


def expected_index_pmf(u: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Expected |level-index| distribution under unbiased stochastic
    rounding (Definition 1) of normalized magnitudes ``u`` in [0, 1]: a
    [num_symbols] f32 pmf, no draw needed.  Rows of ``u``'s last dim are
    summed in f32 and added up in f64, so the pmf is the reference's f32
    sums' up to their rounding."""
    return (_index_mass(u.reshape(-1, u.shape[-1]).float(), levels) / u.numel()).float()


def theorem2_bits_traced(pmf: torch.Tensor, d: int, num_buckets: int) -> torch.Tensor:
    """Theorem 2 expected CODE o Q bits, an f32 scalar on the pmf's device
    (the formula of :func:`repro_torch.core.coding.theorem2_expected_bits`,
    in f32 as the reference's traced twin computes it)::

        C_b * num_buckets + (1 - p0) * d + (H(L) + 1) * d

    A NaN mass (a buffer with a non-finite coordinate) makes the estimate
    NaN, as in the reference: it puts a NaN coordinate in symbol 0 (``1 -
    p0``), :func:`_bracket_select` in the top symbols, so every NaN symbol
    enters the entropy here.
    """
    nz = ~(pmf <= 0)  # positive, or NaN
    h = -torch.sum(torch.where(nz, pmf * torch.log2(torch.where(nz, pmf, 1.0)), 0.0))
    f32 = dict(dtype=torch.float32, device=pmf.device)
    d_t = torch.tensor(d, **f32)
    return (C_B * torch.tensor(num_buckets, **f32) + (1.0 - pmf[0]) * d_t
            + (h + 1.0) * d_t)


# ---------------------------------------------------------------------------
# The qgenx mean (Algorithm 1 on the wire)
# ---------------------------------------------------------------------------


# An exchange runs as a chain: a generator that makes every noise draw and
# launches its kernels up to its last collectives, issues those
# (``comm.start_*``), yields once, and when resumed waits on them, runs
# its last kernel and returns its result.  ``_run`` drives one chain to its
# end (the serial order); ``_pipeline`` keeps two in flight.


def _resume(chain):
    """Resume a chain past its yield; its result."""
    try:
        next(chain)
    except StopIteration as stop:
        return stop.value
    raise RuntimeError("an exchange chain yielded twice")


def _run(chain):
    """Drive a chain to its result, serially."""
    next(chain)
    return _resume(chain)


def _pipeline(items, start, scope=lambda item: contextlib.nullcontext()):
    """Run one chain per item (``start(item)``), two deep: item i's chain
    runs to its yield (its draws made, its kernels launched, its last
    collectives in flight) before item i - 1's is resumed, so a collective
    overlaps the next item's kernels.  Every chain makes its draws before
    it yields, so the noise is asked for in the items' order, as serially.
    ``scope(item)`` wraps each part of an item's chain.  Yields ``(item,
    result)`` in the items' order."""
    prev = None
    for item in items:
        with scope(item):
            chain = start(item)
            next(chain)
        if prev is not None:
            with scope(prev[0]):
                result = _resume(prev[1])
            yield prev[0], result
        prev = (item, chain)
    if prev is not None:
        with scope(prev[0]):
            result = _resume(prev[1])
        yield prev[0], result


def qgenx_chain(x: torch.Tensor, comm, levels: torch.Tensor, noise,
                cfg: QuantConfig, mode: str = "two_phase", *,
                use_device_prng: bool = False):
    """The chain of :func:`qgenx_pmean` (see the note above it): the
    all-to-all of ``two_phase`` is waited on at once, the final all-gather
    (of either mode) over the yield."""
    if mode == "leafwise":
        raise ValueError("mode='leafwise' is a tree exchange; use pmean_tree")
    if mode not in ("gather", "two_phase"):
        raise ValueError(f"unknown mode {mode!r}")
    K = comm.size
    n = x.shape[0]
    bucket = cfg.bucket_size
    q_is_inf = cfg.q_is_inf
    x = x.float()
    if mode == "gather":
        x2d, _ = pad_to_buckets(x, bucket)
        del x
        r, seed = draw_rounding(noise, x2d.shape, x2d.device, use_device_prng)
        payload, norms = quantize_blocks(x2d, r, levels, num_symbols=cfg.num_symbols,
                                         q_is_inf=q_is_inf, bits=cfg.bits, seed=seed)
        del r, x2d
        record_wire("gather_payload", payload)
        record_wire("gather_norms", norms)
        hp, hn = comm.start_all_gather(payload), comm.start_all_gather(norms)
        del payload, norms
        yield
        mean2d = dequant_reduce_blocks(hp.wait(), hn.wait(), levels,
                                       num_symbols=cfg.num_symbols, num_workers=K,
                                       bits=cfg.bits)
        return mean2d.reshape(-1)[:n]
    # two_phase: pad to whole K-bucket quotas, K equal chunks of whole buckets
    xq, _ = pad_to_buckets(x, K * bucket)
    del x
    nbpc = xq.shape[0]
    x2d = xq.reshape(K * nbpc, bucket)
    del xq
    dev = x2d.device
    r, seed = draw_rounding(noise, x2d.shape, dev, use_device_prng)
    payload, norms = quantize_blocks(x2d, r, levels, num_symbols=cfg.num_symbols,
                                     q_is_inf=q_is_inf, bits=cfg.bits, seed=seed)
    del r, x2d
    # row k of the [K, nbpc, P] payload is the chunk destined to worker k
    payload, norms = payload.reshape(K, nbpc, -1), norms.reshape(K, nbpc)
    record_wire("a2a_payload", payload)
    record_wire("a2a_norms", norms)
    p_t = comm.all_to_all(payload)
    n_t = comm.all_to_all(norms)
    del payload, norms
    r2, seed2 = draw_rounding(noise, (nbpc, bucket), dev, use_device_prng)
    ridx, rnorms = dequant_reduce_requantize_blocks(
        p_t, n_t, levels, r2, num_symbols=cfg.num_symbols, num_workers=K,
        q_is_inf=q_is_inf, bits=cfg.bits, seed=seed2)
    del r2, p_t, n_t
    record_wire("gather_payload", ridx)
    record_wire("gather_norms", rnorms)
    hi, hn = comm.start_all_gather(ridx), comm.start_all_gather(rnorms)
    del ridx, rnorms
    yield
    out = dequantize_blocks(hi.wait().reshape(K * nbpc, -1), hn.wait().reshape(K * nbpc),
                            levels, num_symbols=cfg.num_symbols, bits=cfg.bits)
    return out.reshape(-1)[:n]


def qgenx_pmean(x: torch.Tensor, comm, levels: torch.Tensor, noise,
                cfg: QuantConfig, mode: str = "two_phase", *,
                use_device_prng: bool = False) -> torch.Tensor:
    """Unbiased quantized mean of each worker's flat f32 vector ``x``.

    ``gather``: quantize -> all_gather -> dequant_reduce (kernels 1, 4).
    ``two_phase``: quantize -> all_to_all -> dequant_reduce_requantize ->
    all_gather -> dequantize (kernels 1, 2, 3).  With ``use_device_prng``
    kernels 1 and 2 draw their noise from one seed each.  ``leafwise`` is a
    tree exchange (:func:`qgenx_pmean_leafwise`) and raises here.
    """
    return _run(qgenx_chain(x, comm, levels, noise, cfg, mode,
                            use_device_prng=use_device_prng))


def _leaf_pmean(g: torch.Tensor, comm, levels: torch.Tensor, noise, cfg: QuantConfig,
                allreduce_fallback: bool) -> torch.Tensor:
    """One leaf of :func:`qgenx_pmean_leafwise`."""
    K = comm.size
    d = g.shape[-1]
    x2d = g.reshape(-1, d)
    if cfg.stochastic:
        r = noise.uniform(tuple(g.shape), g.device).reshape(-1, d)
    else:
        r = torch.full(x2d.shape, _NEAREST_NOISE, dtype=torch.float32, device=g.device)
    # int4 is packed only on an even trailing dim (the reference's pack4);
    # otherwise the 4-bit table's indices travel as int8
    bits = 4 if cfg.bits == 4 and d % 2 == 0 else 8
    payload, norms = quantize_blocks(x2d, r, levels, num_symbols=cfg.num_symbols,
                                     q_is_inf=cfg.q_is_inf, bits=bits)
    del r, x2d
    if allreduce_fallback:
        hat = dequantize_blocks(payload, norms, levels, num_symbols=cfg.num_symbols,
                                bits=bits)
        del payload, norms
        record_wire("leaf_fallback", hat)
        mean = _div_exact(comm.all_reduce_sum(hat), K)
    else:
        record_wire("leaf_payload", payload)
        record_wire("leaf_norms", norms)
        mean = dequant_reduce_blocks(comm.all_gather(payload), comm.all_gather(norms), levels,
                                     num_symbols=cfg.num_symbols, num_workers=K, bits=bits)
    return mean.reshape(g.shape).to(g.dtype)


def qgenx_pmean_leafwise(leaves: list, comm, levels: torch.Tensor, noise,
                         cfg: QuantConfig, *, allreduce_fallback: bool = False) -> list:
    """The leafwise quantized mean (the reference's
    ``_qgenx_pmean_leafwise``): each leaf quantized in place in rows over
    its trailing dim (kernel 1, bucket = that dim, one ``noise.uniform``
    draw of the leaf's shape, in leaf order), the int8 / packed-int4
    payload and the row norms all-gathered and averaged by kernel 4; with
    ``allreduce_fallback``, this worker's payload dequantized (kernel 3),
    all-reduced in f32 and divided by K.  Each mean is cast to its leaf's
    dtype."""
    return [_leaf_pmean(g, comm, levels, noise, cfg, allreduce_fallback) for g in leaves]


# ---------------------------------------------------------------------------
# Compressors
# ---------------------------------------------------------------------------

_DEFAULT_QUANT_LO = QuantConfig(num_levels=5, bits=4, bucket_size=512)


@functools.lru_cache(maxsize=None)
def _uniform_table(s: int, device: str) -> torch.Tensor:
    """The uniform level table a compressor falls back to (one per device;
    never written to)."""
    return uniform_levels(s, device)


def _div_exact(x: torch.Tensor, K: int) -> torch.Tensor:
    """``x / K`` in place, as a true division by f32(K) (the reference's
    ``out / axis_size``): a divisor held on the host would let the card
    multiply by 1/K, an ulp off for K = 3."""
    return x.div_(torch.full((), float(K), dtype=torch.float32, device=x.device))


def _null_error(device) -> torch.Tensor:
    """The [1] error-memory placeholder of every unbiased compressor."""
    return torch.zeros((1,), dtype=torch.float32, device=device)


class NoneCompressor:
    """Exact f32 mean — the control arm.

    The base of every compressor: ``contract`` is ``"unbiased"``
    (E[compress(v)] = v) or ``"contractive"`` (E||C(v) - v||^2 <=
    (1 - alpha)||v||^2 with alpha = :meth:`contraction_alpha`; those set
    ``has_error`` and carry the per-worker memory ``ExchangeState.error``).

    :meth:`chain_flat` exchanges one packed buffer as a chain (see the
    note above :func:`qgenx_chain`): the bucketed exchange runs one a
    bucket, and :meth:`pmean_leaves` one for the whole plan.  The exact
    mean reduces leaf by leaf instead, and in ``leafwise`` mode too."""

    name = "none"
    contract = "unbiased"
    has_levels = False
    has_error = False

    def contraction_alpha(self, n, cfg):
        raise NotImplementedError(f"compressor {self.name!r} declares the "
                                  f"{self.contract!r} contract, which has no contraction "
                                  "factor")

    def init_error(self, n, num_workers, device):
        """The error-memory slot this compressor carries (default: the [1]
        placeholder)."""
        return _null_error(device)

    def init_levels(self, cfg, device):
        lv = torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)
        return lv, lv.clone()

    def plan_groups(self, leaves_key, cfg):
        return ((tuple(range(len(leaves_key))), None, 0, None),)

    def chain_flat(self, flat, plan, exchange, state, noise):
        h = exchange.comm.start_all_reduce_mean(flat)
        del flat
        yield
        return h.wait()

    def _pmean_planned(self, leaves, exchange, state, noise):
        plan = exchange.plan_for(leaves)
        return plan.unpack(_run(self.chain_flat(plan.pack(leaves), plan, exchange, state,
                                                noise)), leaves)

    def pmean_leaves(self, leaves, exchange, state, noise):
        return [exchange.comm.all_reduce_mean(l) for l in leaves]

    def pmean_leafwise(self, leaves, exchange, state, noise):
        return self.pmean_leaves(leaves, exchange, state, noise)

    def compress_tree(self, leaves, cfg, levels, noise, lead):
        return list(leaves)

    def wire_bytes(self, n, axis_size, cfg):
        return 2 * (axis_size - 1) / axis_size * 4.0 * n

    def wire_bytes_tree(self, shapes, axis_size, cfg):
        return self.wire_bytes(sum(xplan.size_of(s) for s in shapes), axis_size, cfg)

    def compress_wire_bytes(self, n, cfg):
        return 4.0 * n


class QgenxCompressor(NoneCompressor):
    """The paper's bucketed stochastic quantization (Definition 1): one plan
    segment, every leaf, the primary level table; in ``leafwise`` mode
    :func:`qgenx_pmean_leafwise`."""

    name = "qgenx"
    has_levels = True

    def init_levels(self, cfg, device):
        lv = uniform_levels(cfg.quant.num_levels, device)
        return lv, lv.clone()

    def plan_groups(self, leaves_key, cfg):
        return ((tuple(range(len(leaves_key))), cfg.quant, 0, None),)

    def chain_flat(self, flat, plan, exchange, state, noise):
        cfg = exchange.cfg
        chain = qgenx_chain(flat, exchange.comm, state.levels, noise, cfg.quant, cfg.mode,
                            use_device_prng=cfg.use_device_prng)
        del flat  # the chain frees the buffer once it is quantized
        return (yield from chain)

    def pmean_leaves(self, leaves, exchange, state, noise):
        """The plan's buffer, under either layout (see the module
        docstring)."""
        return self._pmean_planned(leaves, exchange, state, noise)

    def pmean_leafwise(self, leaves, exchange, state, noise):
        return qgenx_pmean_leafwise(leaves, exchange.comm, state.levels, noise,
                                    exchange.cfg.quant,
                                    allreduce_fallback=exchange.cfg.allreduce_fallback)

    def _table(self, quant, levels, device):
        """The level table ``compress_tree`` uses with quantizer ``quant``:
        the caller's, else the uniform one."""
        return levels if levels is not None else _uniform_table(quant.num_levels, device)

    def _leaf_quant(self, n, cfg):
        """The quantizer of an n-coordinate leaf."""
        return cfg.quant

    def compress_tree(self, leaves, cfg, levels, noise, lead):
        """One segment-fused quantize∘dequantize over the packed buffer; under
        ``use_plan=False`` leaf by leaf, one launch of kernel 5 a leaf."""
        dev = str(leaves[0].device)
        if not cfg.use_plan:
            out = []
            for l in leaves:
                q = self._leaf_quant(l[0].numel() if lead else l.numel(), cfg)
                out.append(quantize_dequantize(l, self._table(q, levels, dev), noise, q,
                                               workers=bool(lead)).to(l.dtype))
            return out
        lk = xplan.leaf_key(leaves, lead)
        plan = xplan.build_plan(lk, self.plan_groups(lk, cfg), cfg.mode, 1, "compress")
        batch = tuple(leaves[0].shape[:lead])
        tables = tuple(self._table(seg.quant, levels, dev) for seg in plan.segments)
        hat = xplan.fused_compress(plan, plan.pack(leaves, batch).reshape(-1, plan.total),
                                   tables, noise, use_device_prng=cfg.use_device_prng)
        return plan.unpack(hat.reshape(*batch, plan.total), leaves)

    def wire_bytes(self, n, axis_size, cfg):
        if cfg.mode == "leafwise":
            if cfg.allreduce_fallback:
                return 4.0 * n  # the f32 all-reduce operand is the payload
            return float(sum(leafwise_buffer_bytes((n,), cfg.quant).values()))
        return float(sum(exchange_buffer_bytes(n, axis_size, cfg.quant, cfg.mode).values()))

    def wire_bytes_tree(self, shapes, axis_size, cfg):
        """Under ``leafwise``, leaf by leaf (each payload keeps its leaf's
        shape); otherwise one exchange of the whole tree."""
        if cfg.mode != "leafwise":
            return super().wire_bytes_tree(shapes, axis_size, cfg)
        shapes = [tuple(s.shape) if hasattr(s, "shape") else tuple(s) for s in shapes]
        if cfg.allreduce_fallback:
            return float(sum(4.0 * xplan.size_of(s) for s in shapes))
        return float(sum(sum(leafwise_buffer_bytes(s, cfg.quant).values()) for s in shapes))

    def compress_wire_bytes(self, n, cfg):
        return float(cfg.quant.payload_bytes(n))

    def refresh_tables(self, levels, levels_lo, hist, cfg):
        """QAda refresh of the primary table from merged statistics."""
        return _qada_solve(levels, hist, cfg), levels_lo


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

    def chain_flat(self, flat, plan, exchange, state, noise):
        """One qgenx exchange per plan segment, each on its pre-padded slice
        of the shared buffer with its own table (the reference keys segment
        ``seg`` with ``fold_in(key, seg.key_tag)``, so the noise is drawn
        in segment order): every segment's chain is started, then each is
        resumed in turn."""
        cfg = exchange.cfg
        chains = []
        for seg in plan.segments:
            chain = qgenx_chain(flat[seg.start: seg.stop], exchange.comm,
                                state.levels_lo if seg.table == 1 else state.levels, noise,
                                seg.quant, cfg.mode, use_device_prng=cfg.use_device_prng)
            next(chain)
            chains.append(chain)
        del flat
        yield
        outs = [_resume(c) for c in chains]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _table(self, quant, levels, device):
        """The caller's table when it fits this quantizer; the uniform table
        otherwise (the reference's ``_segment_table`` and ``compress``)."""
        if levels is not None and levels.shape[0] == quant.num_symbols:
            return levels
        return _uniform_table(quant.num_levels, device)

    def _leaf_quant(self, n, cfg):
        """The size class's quantizer: the low-bit one above the threshold."""
        lo, hi = self._cfgs(cfg)
        return lo if n > cfg.layerwise_threshold else hi

    def wire_bytes(self, n, axis_size, cfg):
        return float(sum(exchange_buffer_bytes(n, axis_size, self._leaf_quant(n, cfg),
                                               cfg.mode).values()))

    def wire_bytes_tree(self, shapes, axis_size, cfg):
        lo, hi = self._cfgs(cfg)
        sizes = [xplan.size_of(s) for s in shapes]
        total = 0.0
        for qcfg, group in ((lo, [s for s in sizes if s > cfg.layerwise_threshold]),
                            (hi, [s for s in sizes if s <= cfg.layerwise_threshold])):
            if group:
                total += sum(exchange_buffer_bytes(sum(group), axis_size, qcfg,
                                                   cfg.mode).values())
        return float(total)

    def compress_wire_bytes(self, n, cfg):
        return float(self._leaf_quant(n, cfg).payload_bytes(n))

    def refresh_tables(self, levels, levels_lo, hist, cfg):
        """Both tables adapt from the same (table-independent) histogram."""
        return _qada_solve(levels, hist, cfg), _qada_solve(levels_lo, hist, cfg)


def _randk_k(n: int, cfg: ExchangeConfig) -> int:
    return max(1, int(round(cfg.rand_frac * n)))


def _kth_largest_bits(bits: torch.Tensor, k: int) -> int:
    """The k-th largest of ``bits`` (int32 >= 0): the largest t with at
    least k entries >= t, by bisection on t (31 counting passes, each one
    compare and one count over the buffer; no sort)."""
    lo, hi = 0, int(bits.max())
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if int(torch.count_nonzero(bits >= mid)) >= k:
            lo = mid
        else:
            hi = mid - 1
    return lo


TOPK_TIE_CHUNK = 1 << 25  # coordinates scanned at a time for the tied indices


def topk_support(x: torch.Tensor, k: int) -> torch.Tensor:
    """The index set of ``jax.lax.top_k(|x|, k)`` as int32, ascending.

    ``top_k`` keeps the lower index first among equal magnitudes, which
    ``torch.topk`` does not promise, and ``torch.topk`` sorts the whole
    buffer past 1e5 coordinates.  So: the k-th largest |x| is found on the
    bit patterns of |x| (f32 bits of a non-negative float order as the
    floats do), every coordinate above it is kept, and the lowest-index
    coordinates equal to it fill the set up to k (scanned in chunks, so
    no index list of every tie is built)."""
    n = x.shape[0]
    if k >= n:
        return torch.arange(n, dtype=torch.int32, device=x.device)
    bits = x.abs().view(torch.int32)
    t = _kth_largest_bits(bits, k)
    above = torch.nonzero(bits > t).squeeze(1)
    need = k - above.numel()
    parts = [above.to(torch.int32)]
    del above
    for start in range(0, n, TOPK_TIE_CHUNK):
        if need == 0:
            break
        tied = torch.nonzero(bits[start: start + TOPK_TIE_CHUNK] == t).squeeze(1)[:need]
        parts.append(tied.to(torch.int32).add_(start))
        need -= tied.numel()
    return torch.cat(parts) if len(parts) > 1 else parts[0]


class _SparseCompressor(NoneCompressor):
    """k coordinates a worker: k f32 values and k int32 indices on the wire
    (8k bytes), through the default plan group (one unquantized segment:
    the flat concatenation, no padding)."""

    rescale = False  # randk scales the kept values by n / k

    def _k(self, n: int, cfg) -> int:
        raise NotImplementedError

    def _support(self, v: torch.Tensor, k: int, cfg, noise) -> torch.Tensor:
        """int32 indices of the k coordinates kept of the flat ``v``."""
        return noise.subset(v.shape[0], k, v.device)

    def _compress_flat(self, v: torch.Tensor, cfg, noise) -> torch.Tensor:
        n = v.shape[0]
        k = self._k(n, cfg)
        idx = self._support(v.float(), k, cfg, noise)
        vals = v[idx]
        if self.rescale:
            vals = vals * (n / k)
        out = torch.zeros_like(v)
        out[idx] = vals
        return out

    def compress_tree(self, leaves, cfg, levels, noise, lead):
        """Leaf by leaf, one support draw a leaf (the reference splits its
        key per leaf); with a leading worker dim, worker by worker."""
        rows = leaves[0].shape[0] if lead else 1
        outs = [torch.empty_like(l) for l in leaves]
        for w in range(rows):
            for l, o in zip(leaves, outs):
                v = l[w] if lead else l
                (o[w] if lead else o).copy_(
                    self._compress_flat(v.reshape(-1), cfg, noise).reshape(v.shape))
        return outs

    def wire_bytes(self, n, axis_size, cfg):
        return 8.0 * self._k(n, cfg)  # 4 B value + 4 B index

    def compress_wire_bytes(self, n, cfg):
        return 8.0 * self._k(n, cfg)


class RandKCompressor(_SparseCompressor):
    """Unbiased rand-k: k = max(1, round(rand_frac * n)) coordinates drawn
    uniformly without replacement, scaled by n / k so E[compress(v)] = v.
    The mean all-gathers every worker's values and indices, scatter-adds
    them into zeros one worker row at a time (a row's indices are
    distinct, so each add is exact and the sum runs in worker order, as
    the reference's scatter) and divides by K."""

    name = "randk"
    rescale = True

    def _k(self, n, cfg):
        return _randk_k(n, cfg)

    def chain_flat(self, flat, plan, exchange, state, noise):
        n = flat.shape[0]
        k = self._k(n, exchange.cfg)
        idx = self._support(flat, k, exchange.cfg, noise)
        vals = flat.index_select(0, idx).mul_(n / k)
        del flat
        record_wire("randk_vals", vals)
        record_wire("randk_idx", idx)
        comm = exchange.comm
        hv, hi = comm.start_all_gather(vals), comm.start_all_gather(idx)
        del vals, idx
        yield
        all_vals, all_idx = hv.wait(), hi.wait()
        out = torch.zeros((n,), dtype=torch.float32, device=all_vals.device)
        for j in range(comm.size):
            out.index_add_(0, all_idx[j], all_vals[j])
        return _div_exact(out, comm.size)

    def pmean_leaves(self, leaves, exchange, state, noise):
        """The plan's buffer is the leaves' plain concatenation, so the
        per-call layout (``use_plan=False``) is the same exchange."""
        return self._pmean_planned(leaves, exchange, state, noise)


class _ErrorFeedbackCompressor(_SparseCompressor):
    """The contractive tier with EF21 error feedback (Richtarik et al.).
    Per worker, with C the bare contraction (:meth:`compress_tree`: keep k
    coordinates, no rescale)::

        c_k  = C(g_k - h_k)      # the sparse innovation, shipped
        h_k' = h_k + c_k         # the per-worker estimate
        mean = (1/K) sum_k h_k'  # what the step consumes

    ``h`` is ``ExchangeState.error`` ``[K, n]`` over the plan's flat buffer
    (the live coordinate count: the segment is unquantized, so unpadded).
    Every worker replays all K workers' gathered innovations into it, so
    it stays replicated; the update is in place, and exact (each row's
    indices are distinct).  Only :meth:`Exchange.pmean_tree` threads the
    memory, so :meth:`pmean_leaves` raises."""

    contract = "contractive"
    has_error = True
    wire_tag = "ef"

    def contraction_alpha(self, n, cfg):
        return self._k(n, cfg) / float(n)

    def init_error(self, n, num_workers, device):
        if n is None or num_workers is None:
            return _null_error(device)  # the exchange raises if it meets this
        return torch.zeros((int(num_workers), int(n)), dtype=torch.float32, device=device)

    def _check_error(self, h: torch.Tensor, n: int, K: int) -> None:
        if h.dim() != 2 or h.shape[1] != n:
            raise ValueError(
                f"compressor {self.name!r} (contractive contract) needs error memory of "
                f"shape [num_workers, {n}], found {tuple(h.shape)}; initialize the state "
                "with ex.init_state(device, template=params, num_workers=K)")
        if h.shape[0] != K:
            raise ValueError(
                f"compressor {self.name!r}: error memory was initialized for {h.shape[0]} "
                f"workers but the exchange has {K}")

    def pmean_leaves(self, leaves, exchange, state, noise):
        raise ValueError(
            f"compressor {self.name!r} (contractive contract) must be called through "
            "Exchange.pmean_tree, which threads the error memory back into ExchangeState")

    def pmean_tree_ef(self, leaves, exchange, state, noise):
        """One EF21 round on the packed buffer: ``(mean leaves, error)``,
        ``error`` being ``state.error`` updated in place."""
        plan = exchange.plan_for(leaves)
        innov = plan.pack(leaves)
        n = innov.shape[0]
        comm = exchange.comm
        h = state.error
        self._check_error(h, n, comm.size)
        innov.sub_(h[comm.rank])
        idx = self._support(innov, self._k(n, exchange.cfg), exchange.cfg, noise)
        vals = innov.index_select(0, idx)
        del innov
        record_wire(f"{self.wire_tag}_vals", vals)
        record_wire(f"{self.wire_tag}_idx", idx)
        all_vals, all_idx = comm.all_gather(vals), comm.all_gather(idx)
        del vals, idx
        for j in range(comm.size):
            h[j].index_add_(0, all_idx[j], all_vals[j])
        del all_vals, all_idx
        mean = _div_exact(torch.sum(h, 0), comm.size)
        return plan.unpack(mean, leaves), h

    def ef_compress(self, v: torch.Tensor, err: torch.Tensor, cfg, noise):
        """The collective-free EF21 update of W workers' rows (the toy-VI
        loop): ``v``, ``err`` ``[W, n]`` -> ``(h', h')`` with ``h' = err +
        C(v - err)`` row by row, one support draw a row in worker order;
        the contribution to the mean is the new memory row."""
        k = self._k(v.shape[-1], cfg)
        innov = v.float() - err
        h = err.clone()
        for w in range(v.shape[0]):
            idx = self._support(innov[w], k, cfg, noise)
            h[w].index_add_(0, idx, innov[w][idx])
        return h, h


class EF21TopKCompressor(_ErrorFeedbackCompressor):
    """EF21 with magnitude top-k: C keeps the max(1, round(ef_topk_frac *
    n)) largest-|.| coordinates (deterministic: the contraction holds per
    draw, and no draw is asked of the noise source)."""

    name = "ef21-topk"
    wire_tag = "ef21"

    def _k(self, n, cfg):
        return max(1, int(round(cfg.ef_topk_frac * n)))

    def _support(self, v, k, cfg, noise):
        return topk_support(v, k)


class EFRandKCompressor(_ErrorFeedbackCompressor):
    """Contractive rand-k: the EF21 recursion on a uniform support of
    max(1, round(rand_frac * n)) coordinates, no n/k rescale (E||C(x) -
    x||^2 = (1 - k/n)||x||^2 over the draw)."""

    name = "ef-randk"
    wire_tag = "ef_randk"

    def _k(self, n, cfg):
        return _randk_k(n, cfg)


_COMPRESSORS = {c.name: c() for c in (NoneCompressor, QgenxCompressor, LayerwiseCompressor,
                                      RandKCompressor, EF21TopKCompressor, EFRandKCompressor)}


def get_compressor(name: str):
    """Registry lookup; an unknown name raises ``ValueError`` listing the
    registered names with their contract tiers."""
    try:
        return _COMPRESSORS[name]
    except KeyError:
        entries = ", ".join(f"'{n}' ({_COMPRESSORS[n].contract})" for n in sorted(_COMPRESSORS))
        raise ValueError(f"unknown compressor {name!r}; registered: {entries}") from None


def registered_compressors() -> tuple:
    """The registered names, sorted (the train CLI's ``--compressor``
    choices)."""
    return tuple(sorted(_COMPRESSORS))


def _qada_solve(levels: torch.Tensor, hist: torch.Tensor, cfg: ExchangeConfig) -> torch.Tensor:
    """One QAda solve (:func:`~repro_torch.core.adaptive_levels.optimize_levels`
    on the host); raises ``ValueError`` on a non-finite histogram or a
    table that fails ``validate_levels``."""
    if not bool(torch.isfinite(hist).all()):
        raise ValueError("QAda histogram is not finite: no level table can be solved")
    new = qada.optimize_levels(levels, hist, sweeps=cfg.qada_sweeps,
                               bisect_iters=cfg.qada_bisect_iters)
    try:
        validate_levels(new, levels.shape[0] - 2)
    except ValueError as e:
        raise ValueError(f"QAda solved an invalid level table {new.tolist()}: {e}") from None
    return new


# ---------------------------------------------------------------------------
# Partial participation (liveness masking)
# ---------------------------------------------------------------------------


def _mask_tree(leaves: list, mask: torch.Tensor) -> list:
    """Zero every leaf of a dead worker (mask == 0) with ``where``, not a
    multiply, so a dropped worker's NaN (NaN * 0 is NaN) vanishes from the
    aggregate; ``where(1 > 0, g, 0)`` is ``g`` bit for bit."""
    return [torch.where(mask > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
            for g in leaves]


def _alive_renorm(mask: torch.Tensor, comm) -> tuple:
    """(renorm, alive): every mean is a sum / K, so the mean over the alive
    set is that times K / alive.  ``alive`` (one all-reduce of the mask)
    is clamped at 1, so an all-dead exchange gives zeros, not NaN (the
    step guard owns rejecting it).  Under an all-ones mask alive == K
    exactly and renorm is exactly 1.0."""
    alive = torch.clamp(comm.all_reduce_sum(mask.float()), min=1.0)
    return torch.full((), float(comm.size), dtype=torch.float32,
                      device=alive.device) / alive, alive


def _renorm_tree(leaves: list, renorm: torch.Tensor) -> list:
    return [(m.float() * renorm).to(m.dtype) for m in leaves]


# ---------------------------------------------------------------------------
# The bucketed exchange
# ---------------------------------------------------------------------------


def _check_pending(name: str, pending: torch.Tensor, total: int) -> None:
    """The defer_tail slot must be the tail bucket's padded plan length (a
    placeholder reaching the exchange is a pointed error)."""
    if pending.dim() != 1 or pending.shape[0] != total:
        raise ValueError(
            f"compressor {name!r} with overlap='defer_tail' needs a pending-tail buffer of "
            f"shape [{total}] (the tail bucket's padded plan length), found "
            f"{tuple(pending.shape)}; initialize the state with "
            "ex.init_state(device, template=params, num_workers=K)")


@contextlib.contextmanager
def _bucket_scope(bi: int):
    """Bucket ``bi``'s work: named ``exchange/bucket{bi}`` for
    ``torch.profiler``, its wire operands recorded under ``b{bi}/``."""
    with torch.profiler.record_function(f"exchange/bucket{bi}"), wire_scope(f"b{bi}/"):
        yield


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
        self.compressor = get_compressor(cfg.compressor)

    def init_state(self, device, template=None,
                   num_workers: Optional[int] = None) -> ExchangeState:
        """A fresh state on ``device``.  ``template`` (a params-shaped
        pytree) and ``num_workers`` (K) size a contractive compressor's
        zero ``[K, n]`` error memory, n the template's coordinate count;
        without them it is a [1] placeholder, which the exchange refuses.
        Under ``overlap="defer_tail"`` they size the zero ``pending`` slot
        too (the tail bucket's padded plan length at K workers); the other
        configs ignore both."""
        lv, lv_lo = self.compressor.init_levels(self.cfg, device)
        bins = self.cfg.qada_bins if self.cfg.level_schedule == "qada" else 1
        n = None
        if template is not None:
            n = sum(xplan.size_of(l) for l in tree_flatten(template)[0])
        return ExchangeState(levels=lv, levels_lo=lv_lo,
                             hist=torch.zeros((bins,), dtype=torch.float32, device=device),
                             step=0, error=self.compressor.init_error(n, num_workers, device),
                             pending=self._init_pending(template, num_workers, device))

    def _init_pending(self, template, num_workers, device) -> torch.Tensor:
        """The zero defer_tail slot, or the [1] placeholder (other overlaps,
        or no template: the exchange then refuses it)."""
        if self.cfg.overlap != "defer_tail" or template is None or num_workers is None:
            return _null_error(device)
        leaves = tree_flatten(template)[0]
        tail = [leaves[i] for i in self.bucket_partition(leaves)[0]]
        return torch.zeros((self.plan_for(tail, "pmean", num_workers).total,),
                           dtype=torch.float32, device=device)

    def bucket_partition(self, leaves) -> tuple:
        """The bucketed exchange's contiguous split of a leaf list (leaf-id
        tuples), shared by the exchange, its accounting and ``pending``."""
        return xplan.partition_leaf_ids(tuple(xplan.size_of(l) for l in leaves),
                                        self.cfg.num_buckets)

    # -- QAda ------------------------------------------------------------

    def _qada_active(self) -> bool:
        return self.cfg.level_schedule == "qada" and self.compressor.has_levels

    def _hist_quant(self) -> QuantConfig:
        return self.cfg.quant if self.cfg.quant is not None else _DEFAULT_QUANT_LO

    def _tree_hist(self, leaves) -> torch.Tensor:
        """Sufficient statistics of a leaf list, leaf by leaf: each leaf
        padded to buckets of the histogram quantizer on its own (not the
        plan's shared tail), the per-leaf histograms added in leaf order."""
        q = self._hist_quant()
        hist = None
        for g in leaves:
            v2d, _ = pad_to_buckets(g.reshape(-1).float(), q.bucket_size)
            h = qada.normalized_coord_histogram(v2d, bucket_norms(v2d, q.q_norm),
                                                bins=self.cfg.qada_bins)
            del v2d
            hist = h if hist is None else hist + h
        return hist

    def _leafwise_hist(self, leaves) -> torch.Tensor:
        """The same over the leafwise exchange's rows: each leaf in rows of
        its trailing dim, no padding."""
        q = self._hist_quant()
        hist = None
        for g in leaves:
            v2d = g.reshape(-1, g.shape[-1]).float()
            h = qada.normalized_coord_histogram(v2d, bucket_norms(v2d, q.q_norm),
                                                bins=self.cfg.qada_bins)
            del v2d
            hist = h if hist is None else hist + h
        return hist

    def _advance(self, state: ExchangeState, local_hist=None,
                 guarded: bool = False) -> ExchangeState:
        """Bump the call counter; with QAda statistics, merge them over the
        workers (one all-reduce, recorded as ``qada_hist``) and, on the
        call that completes a period, refresh every table the compressor
        carries from the merged histogram and zero it.  ``guarded``: a
        non-finite merged histogram skips the refresh and stays in the
        state (the caller's guard rejects it) instead of raising."""
        if local_hist is None:
            return dataclasses.replace(state, step=state.step + 1)
        record_wire("qada_hist", local_hist)
        hist = state.hist + self.comm.all_reduce_sum(local_hist)
        levels, levels_lo = state.levels, state.levels_lo
        every = self.cfg.level_update_every
        refresh = state.step % every == every - 1
        if refresh and guarded:
            refresh = bool(torch.isfinite(hist).all())
        if refresh:
            levels, levels_lo = self.compressor.refresh_tables(levels, levels_lo, hist,
                                                               self.cfg)
            hist = torch.zeros_like(hist)
        return dataclasses.replace(state, levels=levels, levels_lo=levels_lo, hist=hist,
                                   step=state.step + 1)

    def qada_propose(self, levels: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """One QAda refresh proposal from fresh vectors ``v`` (any shape
        whose trailing dim is the coordinate dim; rows of
        ``min(bucket, v.shape[-1])``), solved on the host."""
        q = self._hist_quant()
        v2d = v.reshape(-1, min(q.bucket_size, v.shape[-1])).float()
        hist = qada.normalized_coord_histogram(v2d, bucket_norms(v2d, q.q_norm),
                                               bins=self.cfg.qada_bins)
        return _qada_solve(levels, hist, self.cfg)

    def _qada_wire_bytes(self) -> float:
        """The qada schedule all-reduces the [qada_bins] f32 histogram once
        per exchange call."""
        return 4.0 * self.cfg.qada_bins if self._qada_active() else 0.0

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

    def pmean_tree(self, tree, state: ExchangeState, noise,
                   mask: Optional[torch.Tensor] = None, guarded: bool = False):
        """Mean of a gradient pytree (flattened in JAX order) over the
        workers: none reduces leaf by leaf; qgenx packs the leaves through
        the plan into one buffer and exchanges it; layerwise exchanges each
        segment of that buffer; randk and the contractive tier exchange k
        coordinates of the packed buffer, the latter threading (and
        updating in place) ``state.error``.  Under ``use_plan=False``,
        ``leafwise`` and the bucketed overlaps the layouts of the module
        docstring apply; ``defer_tail`` returns the new ``pending`` in the
        state.

        ``mask`` (this worker's f32 liveness scalar, or None) excludes a
        dropped worker and renormalizes the mean over the alive set;
        ``guarded`` lets a QAda refresh meet a non-finite histogram without
        raising (see the module docstring)."""
        leaves, spec = tree_flatten(tree)
        if self.cfg.mode == "leafwise":
            if mask is not None:
                leaves = _mask_tree(leaves, mask)
            out = self.compressor.pmean_leafwise(leaves, self, state, noise)
            hist = self._leafwise_hist(leaves) if self._qada_active() else None
            out, state = self._finish(out, state, hist, mask, guarded)
            return tree_unflatten(spec, out), state
        if self.compressor.has_error:
            self._reject_mask(mask)
            out, err = self.compressor.pmean_tree_ef(leaves, self, state, noise)
            return tree_unflatten(spec, out), dataclasses.replace(self._advance(state),
                                                                  error=err)
        if mask is not None and self.cfg.overlap == "defer_tail":
            raise ValueError(
                "overlap='defer_tail' does not support partial-participation masks: the "
                "applied tail mean is one sync stale, and renormalizing it over THIS "
                "step's alive set would rescale a buffer aggregated under a different "
                "one — use overlap='bucketed' with masks")
        if mask is not None:
            leaves = _mask_tree(leaves, mask)
        pending = state.pending
        if self.cfg.overlap != "off":
            out, pending = self._pmean_bucketed(leaves, state, noise)
        else:
            out = self.compressor.pmean_leaves(leaves, self, state, noise)
        hist = self._tree_hist(leaves) if self._qada_active() else None
        out, state = self._finish(out, state, hist, mask, guarded)
        return tree_unflatten(spec, out), dataclasses.replace(state, pending=pending)

    def _pmean_bucketed(self, leaves, state: ExchangeState, noise):
        """The bucketed exchange: one chain per contiguous bucket, each
        planned on its own, highest bucket first, pipelined two deep
        (:func:`_pipeline`).  Under ``defer_tail`` bucket 0's mean becomes
        the new ``pending`` and its leaves get (a copy of) the old one.
        Returns ``(mean leaves, new pending)``."""
        buckets = self.bucket_partition(leaves)
        plans = [self.plan_for([leaves[i] for i in ids]) for ids in buckets]
        defer = self.cfg.overlap == "defer_tail"
        if defer:
            _check_pending(self.cfg.compressor, state.pending, plans[0].total)

        def start(bi):
            sub = [leaves[i] for i in buckets[bi]]
            return self.compressor.chain_flat(plans[bi].pack(sub), plans[bi], self, state,
                                              noise)

        out = [None] * len(leaves)
        pending = state.pending
        for bi, mean in _pipeline(range(len(buckets) - 1, -1, -1), start, _bucket_scope):
            if defer and bi == 0:
                pending, mean = mean, state.pending.clone()
            sub = [leaves[i] for i in buckets[bi]]
            for i, m in zip(buckets[bi], plans[bi].unpack(mean, sub)):
                out[i] = m
        return out, pending

    def _reject_mask(self, mask) -> None:
        """Error feedback with partial participation is undefined: a dead
        worker's memory would go stale while the alive-set renorm rescales
        its stored innovations."""
        if mask is not None:
            raise ValueError(
                f"compressor {self.cfg.compressor!r} (contractive "
                "contract) does not support partial-participation masks; "
                "run error-feedback exchanges with full participation"
            )

    def _finish(self, leaves, state: ExchangeState, hist, mask, guarded: bool):
        """The masked epilogue: renormalize the mean over the alive set and
        keep a dead worker's statistics out of the QAda merge (``where``,
        not a multiply: they may be NaN, which may be why it dropped)."""
        if mask is not None:
            renorm, _ = _alive_renorm(mask, self.comm)
            leaves = _renorm_tree(leaves, renorm)
            if hist is not None:
                hist = torch.where(mask > 0, hist, torch.zeros_like(hist))
        return leaves, self._advance(state, hist, guarded)

    def compress_tree(self, tree, noise, levels: Optional[torch.Tensor] = None,
                      workers: bool = False):
        """Per-worker estimate of a pytree, no collectives: for the level-
        table compressors one fused quantize∘dequantize over the planned
        buffer (kernel 5), or under ``use_plan=False`` one launch of kernel 5
        a leaf (each leaf with its own padding tail; its draws are asked
        for leaf by leaf, worker by worker within a leaf, always as noise
        arrays, as the reference's per-leaf path); for the sparse ones each
        leaf on its own (one support draw a leaf, worker by worker), the
        contractive tier's being its bare contraction C (no rescale,
        biased).

        ``levels=None`` takes the uniform tables.  With ``workers=True``
        every leaf carries a leading worker dim and all workers' buffers go
        through one launch per row geometry, each worker with its own noise
        draw (asked in worker order; with ``use_device_prng`` one seed per
        launch, the workers' rows being distinct Philox counters)."""
        leaves, spec = tree_flatten(tree)
        out = self.compressor.compress_tree(leaves, self.cfg, levels, noise, int(workers))
        return tree_unflatten(spec, out)

    def compress(self, v: torch.Tensor, state: ExchangeState, noise,
                 workers: bool = False) -> torch.Tensor:
        """Per-worker unbiased estimate of one flat vector under
        ``state.levels`` (no collectives)."""
        return self.compress_with_levels(v, state.levels, noise, workers)

    def compress_with_levels(self, v: torch.Tensor, levels: torch.Tensor, noise,
                             workers: bool = False) -> torch.Tensor:
        """:meth:`compress` with a level table the caller carries (the
        Q-GenX loop keeps it in ``QGenXState``): the reference's flat
        per-vector quantize∘dequantize, padded to whole buckets.  With
        ``workers=True`` ``v`` is ``[W, n]``, W workers' vectors in one
        launch of kernel 5 and one noise draw each, in worker order."""
        return self.compress_tree(v, noise, levels, workers)

    def wire_bytes(self, n: int, axis_size: int) -> float:
        """Analytic collective-operand bytes per worker for one pmean of n
        coordinates (none: the ring all-reduce's 2(K-1)/K * 4n; qada adds
        the histogram's ``4 * qada_bins``)."""
        return self.compressor.wire_bytes(n, axis_size, self.cfg) + self._qada_wire_bytes()

    def wire_bytes_tree(self, tree, axis_size: int) -> float:
        """The same for one ``pmean_tree`` of this pytree (the layerwise
        policy bills each size group as its own exchange, ``leafwise`` each
        leaf; the bucketed exchange is the sum of
        :meth:`bucket_wire_bytes_tree`)."""
        if self.cfg.overlap != "off":
            return (float(sum(self.bucket_wire_bytes_tree(tree, axis_size)))
                    + self._qada_wire_bytes())
        shapes = [tuple(l.shape) for l in tree_flatten(tree)[0]]
        return (self.compressor.wire_bytes_tree(shapes, axis_size, self.cfg)
                + self._qada_wire_bytes())

    def bucket_wire_bytes_tree(self, tree, axis_size: int) -> list:
        """Per bucket, the collective-operand bytes of one bucketed
        ``pmean_tree``: entry i is what the recorder's ``b{i}/`` operands
        sum to (each bucket billed as its own monolithic exchange, with its
        own padding)."""
        leaves = tree_flatten(tree)[0]
        mono = dataclasses.replace(self.cfg, num_buckets=1, overlap="off")
        return [float(self.compressor.wire_bytes_tree([tuple(leaves[i].shape) for i in ids],
                                                      axis_size, mono))
                for ids in self.bucket_partition(leaves)]

    def compress_wire_bytes(self, n: int) -> float:
        """Bytes one worker broadcasts for one compressed n-vector."""
        return self.compressor.compress_wire_bytes(n, self.cfg)

    def coded_bits_tree(self, tree, state: ExchangeState):
        """Theorem 2 estimate of the entropy-coded bits ONE worker would
        broadcast for this pytree (CODE o Q with an optimal prefix code)
        under ``state.levels``: the expected index pmf of the unbiased
        rounding over the bucket-padded buffer of the ``compress`` plan
        (the coordinates the fixed-width payload pays for), an f32 scalar.
        0.0 for every compressor but qgenx (layerwise would need a pmf
        per table).  Under ``use_plan=False`` the reference concatenates
        and pads instead: that is this one-segment plan's buffer
        coordinate for coordinate, so the same estimate.

        The buffer is read in chunks of :data:`CODED_CHUNK_ROWS` bucket
        rows, each built from the leaves, so no full-size copy or
        per-coordinate temporary outlives a chunk; the per-bracket sums add
        up in f32 within a bucket row and in f64 over rows and chunks."""
        if self.cfg.compressor != "qgenx":
            return 0.0
        q = self.cfg.quant
        leaves = tree_flatten(tree)[0]
        plan = self.plan_for(leaves, "compress", 1)
        b = q.bucket_size
        rows = plan.total // b
        mass = None
        for r0 in range(0, rows, CODED_CHUNK_ROWS):
            r1 = min(rows, r0 + CODED_CHUNK_ROWS)
            v2d = plan.pack_range(leaves, r0 * b, r1 * b).reshape(-1, b)
            norms = bucket_norms(v2d, q.q_norm)
            u = v2d.abs_().div_(torch.where(norms > 0, norms, 1.0)[:, None]).clamp_(0.0, 1.0)
            m = _index_mass(u, state.levels)
            del v2d, u
            mass = m if mass is None else mass + m
        pmf = (mass / (rows * b)).float()
        return theorem2_bits_traced(pmf, rows * b, rows)

    def compress_wire_bytes_tree(self, tree) -> float:
        """Broadcast bytes of one ``compress_tree`` of this pytree: one
        shared padding tail per plan segment for the level-table
        compressors, or per leaf under ``use_plan=False``; 4 B per
        coordinate for none."""
        leaves = tree_flatten(tree)[0]
        if self.compressor.has_levels and self.cfg.use_plan:
            return self.plan_for(leaves, "compress", 1).compress_payload_bytes()
        return float(sum(self.compress_wire_bytes(xplan.size_of(l)) for l in leaves))


def make_exchange(cfg: ExchangeConfig, comm=None) -> Exchange:
    """An :class:`Exchange` over ``comm`` (default: :class:`SingleWorker`)."""
    return Exchange(cfg, comm if comm is not None else SingleWorker())
