"""Kernel 5: segment-fused quantize∘dequantize, hand-written in CUDA for
Hopper.

Replaces ``repro/kernels/segment_quantize.py::quantize_dequantize_segments``
(Pallas body ``_seg_qdq_kernel``), the kernel of ``compress_tree``: one
launch over a planned flat buffer whose bucket rows each pick their level
table, by segment id, from a stacked ``[T, S_max]`` table buffer.  Per
row: the L^inf or L^2 norm, the level bracket in the row's own table,
stochastic (``r < xi``) or nearest (``xi >= 0.5``) rounding, and the
dequantized value ``sign * level * norm``.  The indices never leave
registers; only the f32 estimate is written.

Bound on the H100: device-memory traffic, and instruction issue about
as much.  It reads x and the noise and writes the estimate, 12 B per
coordinate (8 B with nearest rounding); at the tinyllama-1.1b planned
buffer (1,100,048,384 coordinates) that is 13.20 GB, 3.94 ms at 3.35
TB/s.  The design (``csrc/exchange_kernels.cu::segment_qdq_kernel``) is
kernels 1 and 2's: one warp per bucket row, 8 rows a block, a grid that
fills the card once (each warp strides over the rows), a 512 row of x
held whole in registers (two 256-wide chunks; at most 80 registers, 24
warps an SM), the norm by warp shuffles, the first chunk's noise loaded
(or drawn) with x before the norm, the second's after the first chunk is
written, and the bracket from a per-table 257-cell count of
[0, 1] plus one compare (a binary search for a table with two levels in
one cell).  The stacked tables and their cell counts are staged once per
block in shared memory.

Device-PRNG variant (``seed=`` in place of ``noise``; TPU kernel B5 at
its call site ``repro/kernels/segment_quantize.py:50``): the noise is
drawn with Philox4x32-10 in registers, 8 B per coordinate moved instead
of 12 (8.81 GB at the tinyllama-1.1b buffer); the draw's integer work
makes it issue-bound.

CPU tensors go to the plain version :func:`quantize_dequantize_segments_plain`
(same arithmetic, bit-identical); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import quantize_dequantize_segments_plain  # noqa: F401


def quantize_dequantize_segments(x2d: torch.Tensor, noise, tables: torch.Tensor,
                                 seg_ids: torch.Tensor, *, num_symbols: tuple,
                                 q_is_inf: bool, stochastic: bool = True,
                                 seed=None) -> torch.Tensor:
    """Fused Q∘DEQ of [nb, bucket] f32 under per-row level tables.

    ``noise``: [nb, bucket] uniform [0, 1), or ``None`` with the device
    PRNG's 64-bit ``seed`` (stochastic rounding takes exactly one of the
    two; nearest rounding, ``stochastic=False``, reads neither);
    ``tables``: [T, S_max] f32; ``seg_ids``: [nb] int32 table id per row;
    ``num_symbols``: live symbols per table.  Returns the [nb, bucket] f32
    estimate.
    """
    nb, bucket = x2d.shape
    num_symbols = tuple(int(n) for n in num_symbols)
    T, s_max = tables.shape
    if len(num_symbols) != T:
        raise ValueError(f"{len(num_symbols)} symbol counts for {T} tables")
    if any(n < 2 or n > s_max for n in num_symbols):
        raise ValueError(f"num_symbols {num_symbols} outside [2, {s_max}]")
    if tuple(seg_ids.shape) != (nb,):
        raise ValueError(f"seg_ids must be [nb]={nb}, got {tuple(seg_ids.shape)}")
    variant = ""
    if stochastic:
        variant = cuda.rounding(noise, seed, nb, bucket)
    else:
        noise = seed = None
    if x2d.device.type != "cuda":
        return quantize_dequantize_segments_plain(
            x2d, noise, tables, seg_ids, num_symbols=num_symbols, q_is_inf=q_is_inf,
            stochastic=stochastic, seed=seed)
    dev = x2d.device
    x = cuda.prepare(x2d, torch.float32, dev)
    r = cuda.prepare(noise, torch.float32, dev) if noise is not None else None
    tab = cuda.prepare(tables, torch.float32, dev)
    seg = cuda.prepare(seg_ids, torch.int32, dev)
    out = torch.empty((nb, bucket), dtype=torch.float32, device=dev)
    cuda.call("qx_segment_qdq", "quantize_dequantize_segments" + variant, dev, x.data_ptr(),
              None if r is None else r.data_ptr(), int(seed or 0), seed is not None,
              tab.data_ptr(), seg.data_ptr(), T, s_max, _counts(num_symbols), nb, bucket,
              int(q_is_inf), int(stochastic), out.data_ptr())
    return out


@functools.lru_cache(maxsize=None)
def _counts(num_symbols: tuple):
    """The launch's ``int[T]`` symbol counts, built once per tuple (the
    kernel copies them; nothing writes them)."""
    return (ctypes.c_int * len(num_symbols))(*num_symbols)
