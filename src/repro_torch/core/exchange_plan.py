"""ExchangePlan — static flat-buffer layout for tree exchanges.

Port of ``repro/core/exchange_plan.py``.  A plan fixes, once per (leaf
shapes, exchange config, worker count): the order leaves are packed, their
offsets in the flat f32 buffer, and the segments with their padding tails
(bucket, or ``axis_size * bucket`` quota in two-phase mode).  ``pack``
writes the buffer once in its final aligned layout, so the exchange needs
no further padding; ``unpack`` slices the leaves back out and casts to
their dtypes.  :func:`fused_compress` is the segment-fused quantize∘
dequantize of ``compress_tree``: one launch of kernel 5 per row geometry.
:func:`partition_leaf_ids` splits a leaf list into the contiguous buckets
of the bucketed exchange, each of which is planned on its own.

Its noise, with the device PRNG (``use_device_prng``): W workers' buffers
stacked as ``[W * rows, bucket]`` share ONE seed per launch, where the
host draw asks one ``[rows, bucket]`` array per worker.  Worker w's row j
is launch row ``w * rows + j``, a Philox counter no other worker's row
has, so the workers' draws stay independent (the reference gives each
worker its own key through ``vmap``); the draw equals the host path fed
``philox_uniform(seed, w * rows, rows, bucket)`` for worker w.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels.segment_quantize import quantize_dequantize_segments


@dataclasses.dataclass(frozen=True)
class PlanSegment:
    """One contiguous range of the flat buffer under one quantizer policy
    (fields as in the reference's ``PlanSegment``)."""

    start: int
    n: int
    padded: int
    table: int = 0
    quant: Optional[QuantConfig] = None
    key_tag: Optional[int] = None
    leaf_ids: tuple = ()

    @property
    def stop(self) -> int:
        return self.start + self.padded

    @property
    def pad(self) -> int:
        return self.padded - self.n


def size_of(s) -> int:
    """Coordinate count of a tensor or a bare shape tuple."""
    shape = s.shape if hasattr(s, "shape") else s
    n = 1
    for d in shape:
        n *= int(d)
    return n


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static layout of one pytree in the flat exchange buffer."""

    shapes: tuple
    offsets: tuple
    pack_order: tuple
    segments: tuple
    total: int
    n_live: int

    def pack(self, leaves, batch: tuple = ()) -> torch.Tensor:
        """Leaves -> the flat f32 buffer, written once in its final layout
        (each leaf copied into place with a dtype cast; only the padding
        tails are zeroed).  Leaves may carry leading ``batch`` dims (one
        buffer per worker: the flat buffer is then ``[*batch, total]``)."""
        dev = leaves[0].device if leaves else torch.device("cpu")
        flat = torch.empty((*batch, self.total), dtype=torch.float32, device=dev)
        pos = 0
        for i in self.pack_order:
            off = self.offsets[i]
            if off > pos:
                flat[..., pos:off].zero_()
            n = size_of(self.shapes[i])
            flat[..., off: off + n].copy_(leaves[i].reshape(*batch, n))
            pos = off + n
        if pos < self.total:
            flat[..., pos:].zero_()
        return flat

    def pack_range(self, leaves, start: int, stop: int) -> torch.Tensor:
        """Coordinates ``[start, stop)`` of :meth:`pack`'s buffer, built
        without the whole buffer (padding tails zero)."""
        dev = leaves[0].device if leaves else torch.device("cpu")
        out = torch.empty((stop - start,), dtype=torch.float32, device=dev)
        pos = start
        for i in self.pack_order:
            off, n = self.offsets[i], size_of(self.shapes[i])
            lo, hi = max(off, start), min(off + n, stop)
            if lo < hi:
                if lo > pos:
                    out[pos - start: lo - start].zero_()
                out[lo - start: hi - start].copy_(leaves[i].reshape(-1)[lo - off: hi - off])
                pos = hi
        if pos < stop:
            out[pos - start:].zero_()
        return out

    def unpack(self, flat: torch.Tensor, leaves) -> list:
        """Flat buffer (``[*batch, total]``) -> per-leaf tensors shaped and
        cast like ``leaves`` (f32 leaves are views of ``flat``)."""
        return [
            flat[..., off: off + size_of(shape)].reshape(l.shape).to(l.dtype)
            for l, off, shape in zip(leaves, self.offsets, self.shapes)
        ]

    def compress_payload_bytes(self) -> float:
        total = 0.0
        for s in self.segments:
            total += 4.0 * s.n if s.quant is None else float(s.quant.payload_bytes(s.n))
        return total

    def describe(self) -> str:
        return " | ".join(
            f"[{s.start}:{s.stop}) table={s.table} "
            f"bits={s.quant.bits if s.quant else 32} pad={s.pad}"
            for s in self.segments
        )


def leaf_key(leaves, lead: int = 0) -> tuple:
    """Hashable static descriptor of a leaf list — the plan cache key:
    ``((shape, dtype name), ...)`` with the reference's dtype names;
    ``lead`` leading (worker) dims of each tensor are left out."""
    out = []
    for l in leaves:
        shape = tuple(l.shape)[lead:] if hasattr(l, "shape") else tuple(l)
        dt = str(l.dtype).removeprefix("torch.") if hasattr(l, "dtype") else "float32"
        out.append((shape, dt))
    return tuple(out)


def _align(n: int, quant: Optional[QuantConfig], mode: str, axis_size: int,
           purpose: str) -> int:
    if quant is None or n == 0:
        return n
    quota = quant.bucket_size
    if purpose == "pmean" and mode == "two_phase":
        quota = axis_size * quant.bucket_size
    return -(-n // quota) * quota


@functools.lru_cache(maxsize=None)
def partition_leaf_ids(sizes: tuple, num_buckets: int) -> tuple:
    """Split leaf ids ``0..len(sizes)-1`` into ``min(num_buckets,
    len(sizes))`` contiguous runs in leaf (JAX flatten) order, greedily
    balanced by coordinate count: a bucket closes once it reaches the
    running average of what is left, never leaving fewer leaves than
    buckets still to fill; if one huge leaf makes the pass come up short,
    trailing leaves are split off the last bucket that has more than one.
    The reference's algorithm, so the port's buckets are the reference's
    (the bucketed exchange, its accounting and the ``pending`` slot's size
    all read this one cached partition).  A tuple of ascending leaf-id
    tuples."""
    n_leaves = len(sizes)
    k = max(1, min(int(num_buckets), n_leaves))
    if k == 1:
        return (tuple(range(n_leaves)),)
    total = sum(sizes)
    target = total / k
    out, cur, acc, remaining = [], [], 0, k
    for i, s in enumerate(sizes):
        cur.append(i)
        acc += s
        left = n_leaves - i - 1
        if len(out) < k - 1 and acc >= target and left >= remaining - 1:
            out.append(tuple(cur))
            cur, acc = [], 0
            remaining -= 1
            total_left = total - sum(sizes[j] for b in out for j in b)
            target = total_left / max(remaining, 1)
    if cur:
        out.append(tuple(cur))
    while len(out) < k:
        for bi in range(len(out) - 1, -1, -1):
            if len(out[bi]) > 1:
                out = out[:bi] + [out[bi][:-1], out[bi][-1:]] + out[bi + 1:]
                break
    return tuple(tuple(b) for b in out)


@functools.lru_cache(maxsize=None)
def build_plan(leaves_key: tuple, groups: tuple, mode: str, axis_size: int,
               purpose: str) -> ExchangePlan:
    """Build (and cache) the plan of one static layout; ``groups`` is
    ``((leaf_ids, quant, table, key_tag), ...)`` in buffer order."""
    sizes = [size_of(shape) for shape, _ in leaves_key]
    offsets = [0] * len(sizes)
    pack_order, segments, pos = [], [], 0
    for ids, quant, table, key_tag in groups:
        ids = tuple(ids)
        if not ids:
            continue
        start = pos
        for i in ids:
            offsets[i] = pos
            pos += sizes[i]
            pack_order.append(i)
        n = pos - start
        padded = _align(n, quant, mode, axis_size, purpose)
        pos = start + padded
        segments.append(PlanSegment(start=start, n=n, padded=padded, table=table,
                                    quant=quant, key_tag=key_tag, leaf_ids=ids))
    return ExchangePlan(
        shapes=tuple(shape for shape, _ in leaves_key),
        offsets=tuple(offsets),
        pack_order=tuple(pack_order),
        segments=tuple(segments),
        total=pos,
        n_live=sum(sizes),
    )


# ---------------------------------------------------------------------------
# Segment-fused compression dispatch (Q∘DEQ over the whole buffer)
# ---------------------------------------------------------------------------


def stack_level_tables(tables) -> tuple:
    """Stack level tables of (possibly) different sizes into one
    ``[T, S_max]`` f32 tensor (rows right-padded with 1.0, never gathered)
    plus the per-table symbol counts — the buffer kernel 5 keeps in shared
    memory."""
    num_symbols = tuple(int(t.shape[0]) for t in tables)
    s_max = max(num_symbols)
    rows = [torch.cat([t.float(), t.new_ones((s_max - ns,), dtype=torch.float32)])
            if ns < s_max else t.float() for t, ns in zip(tables, num_symbols)]
    return torch.stack(rows), num_symbols


@functools.lru_cache(maxsize=None)
def _row_tables(plan: ExchangePlan, seg_ids: tuple, bucket: int, workers: int,
                device: str) -> torch.Tensor:
    """[workers * rows] int32 local table id of each bucket row of one
    geometry class (built once per plan, class, worker count and device)."""
    row_tab = []
    for local_t, si in enumerate(seg_ids):
        row_tab.extend([local_t] * (plan.segments[si].padded // bucket))
    return torch.tensor(row_tab * workers, dtype=torch.int32, device=device)


def fused_compress(plan: ExchangePlan, flat: torch.Tensor, tables: tuple,
                   noise, *, use_device_prng: bool = False) -> torch.Tensor:
    """One fused quantize∘dequantize pass over the planned buffer.

    ``flat`` is ``[total]``, or ``[W, total]`` for W workers' buffers at
    once (the counterpart of the reference's ``vmap`` over the kernel).
    ``tables`` holds one level table per plan segment, in segment order.
    Segments that share row geometry (bucket size, norm order, rounding
    mode) take ONE launch of kernel 5 with stacked segment-indexed
    tables; classes run in sorted geometry order, and each asks ``noise``
    for one ``[rows, bucket]`` draw per worker, in worker order (the
    reference keys class ``gi`` with ``fold_in(key, gi)`` when there is
    more than one class), or with ``use_device_prng`` for one seed (the
    reference's ``derive_prng_seed`` branch).  Returns the f32 estimate,
    shaped like ``flat``.
    """
    if len(tables) != len(plan.segments):
        raise ValueError(f"{len(tables)} tables for {len(plan.segments)} segments")
    batched = flat.dim() == 2
    buf = flat if batched else flat.unsqueeze(0)
    W = buf.shape[0]
    classes: dict = {}
    for si, seg in enumerate(plan.segments):
        q = seg.quant
        if q is None:
            raise ValueError("fused_compress needs quantized segments")
        classes.setdefault((q.bucket_size, float(q.q_norm), q.stochastic), []).append(si)
    out_parts: list = [None] * len(plan.segments)
    for (bucket, q_norm, stochastic), seg_ids in sorted(classes.items()):
        chunks = [buf[:, plan.segments[si].start: plan.segments[si].stop] for si in seg_ids]
        x = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)
        rows = x.shape[1] // bucket
        x2d = x.reshape(W * rows, bucket)
        stacked, num_symbols = stack_level_tables([tables[si] for si in seg_ids])
        r = seed = None
        if stochastic and use_device_prng:
            seed = noise.seed()
        elif stochastic:
            draws = [noise.uniform((rows, bucket), x2d.device) for _ in range(W)]
            r = draws[0] if W == 1 else torch.cat(draws)
        hat2d = quantize_dequantize_segments(
            x2d, r, stacked, _row_tables(plan, tuple(seg_ids), bucket, W, str(x2d.device)),
            num_symbols=num_symbols, q_is_inf=math.isinf(q_norm), stochastic=stochastic,
            seed=seed)
        hat = hat2d.reshape(W, rows * bucket)
        col = 0
        for si in seg_ids:
            padded = plan.segments[si].padded
            out_parts[si] = hat[:, col: col + padded]
            col += padded
    out = out_parts[0] if len(out_parts) == 1 else torch.cat(out_parts, dim=1)
    return out if batched else out[0]
