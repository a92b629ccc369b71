"""Kernel 3: dequantization (DEQ of Algorithm 1), hand-written in CUDA for
Hopper.

Replaces ``repro/kernels/dequantize.py::dequantize_blocks``: the wire
payload (int8 signed indices, or packed int4 unpacked in the kernel) and
the per-row norms become ``sign * levels[|idx|] * norm`` in f32.

Bound on the H100: device-memory traffic, dominated by the f32 output
(4 B per coordinate written against 1 B or 0.5 B of payload read).  The
design (``csrc/exchange_kernels.cu::dequantize_kernel``) gives each bucket
row one thread block, reads the payload once, looks levels up in a
shared-memory table and writes the row with 16-byte stores.

CPU tensors go to the plain version :func:`dequantize_blocks_plain`;
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import dequantize_blocks_plain  # noqa: F401  (plain version)


def dequantize_blocks(idx2d: torch.Tensor, norms: torch.Tensor, levels: torch.Tensor, *,
                      num_symbols: int, bits: int = 8) -> torch.Tensor:
    """DEQ [nb, P] payload -> [nb, bucket] f32 (P = bucket or bucket / 2)."""
    nb, pcols = idx2d.shape
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    bucket = pcols if bits == 8 else 2 * pcols
    if tuple(norms.shape) != (nb,):
        raise ValueError(f"norms shape {tuple(norms.shape)} != ({nb},)")
    if levels.shape != (num_symbols,):
        raise ValueError(f"levels shape {tuple(levels.shape)} != ({num_symbols},)")
    if idx2d.device.type != "cuda":
        return dequantize_blocks_plain(idx2d, norms, levels, bits=bits)
    dev = idx2d.device
    idx = cuda.prepare(idx2d, torch.int8, dev)
    nrm = cuda.prepare(norms, torch.float32, dev)
    lv = cuda.prepare(levels, torch.float32, dev)
    out = torch.empty((nb, bucket), dtype=torch.float32, device=dev)
    cuda.call("qx_dequantize", "dequantize_blocks", dev, idx.data_ptr(), nrm.data_ptr(),
              lv.data_ptr(), num_symbols, nb, bucket, bits, out.data_ptr())
    return out
