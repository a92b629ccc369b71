"""ExchangePlan — static flat-buffer layout for tree exchanges.

Port of ``repro/core/exchange_plan.py`` (the layout half; the
segment-fused compression dispatch serves compress_tree and re-centering,
which are not ported yet).  A plan fixes, once per (leaf shapes, exchange
config, worker count): the order leaves are packed, their offsets in the
flat f32 buffer, and the segments with their padding tails (bucket, or
``axis_size * bucket`` quota in two-phase mode).  ``pack`` writes the
buffer once in its final aligned layout, so the exchange needs no further
padding; ``unpack`` slices the leaves back out and casts to their dtypes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.quantization import QuantConfig


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

    def pack(self, leaves) -> torch.Tensor:
        """Leaves -> the flat f32 buffer, written once in its final layout
        (each leaf copied into place with a dtype cast; only the padding
        tails are zeroed)."""
        dev = leaves[0].device if leaves else torch.device("cpu")
        flat = torch.empty((self.total,), dtype=torch.float32, device=dev)
        pos = 0
        for i in self.pack_order:
            off = self.offsets[i]
            if off > pos:
                flat[pos:off].zero_()
            n = size_of(self.shapes[i])
            flat[off: off + n].copy_(leaves[i].reshape(-1))
            pos = off + n
        if pos < self.total:
            flat[pos:].zero_()
        return flat

    def unpack(self, flat: torch.Tensor, leaves) -> list:
        """Flat buffer -> per-leaf tensors cast to each leaf's dtype (f32
        leaves are views of ``flat``)."""
        return [
            flat[off: off + l.numel()].reshape(l.shape).to(l.dtype)
            for l, off in zip(leaves, self.offsets)
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


def leaf_key(leaves) -> tuple:
    """Hashable static descriptor of a leaf list — the plan cache key:
    ``((shape, dtype name), ...)`` with the reference's dtype names."""
    out = []
    for l in leaves:
        shape = tuple(l.shape) if hasattr(l, "shape") else tuple(l)
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
