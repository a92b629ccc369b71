"""Kernel 1: unbiased bucketed quantization (Definition 1), hand-written in
CUDA for Hopper.

Replaces ``repro/kernels/quantize.py::quantize_blocks`` (Pallas body
``_quantize_kernel``): per bucket row, the L^inf or L^2 norm,
``u = clip(|x| / norm, 0, 1)``, the level bracket
``tau = #{1 <= j <= s : levels[j] <= u}``, stochastic rounding
``r < xi`` against the host noise, and the signed index as int8 or packed
two per byte in the kernel (the buffer it writes is the wire payload).

Bound on the H100: device-memory traffic.  It reads x and the noise (4 B
each per coordinate) and writes 1 B (int8) or 0.5 B (int4) per coordinate
plus 4 B per row; at the tinyllama-1.1b exchange buffer (~1.1e9
coordinates) that is ~9.9 GB, ~3 ms at 3.35 TB/s.  The design
(``csrc/exchange_kernels.cu::quantize_kernel``) gives each bucket row one
warp, which holds 256 coordinates of it in registers (16-byte loads of x
and the noise issued together), takes the norm by warp shuffles and
re-reads the rest of a wider row from L1/L2 for its second pass.  The
bracket comes from a cell table of [0, 1] and one compare, or a binary
search over the interior levels: both need ``levels`` sorted ascending,
as every table the port builds is.

Device-PRNG variant (``seed=`` in place of ``noise``; TPU kernel B5 at
its call site ``repro/kernels/quantize.py:63``): the kernel draws each
coordinate's noise with Philox4x32-10 in registers
(:func:`repro_torch.kernels.ref.philox_uniform` is its plain version), so
the 4 B per coordinate of noise are neither written by a host draw nor
read here: ~5.5 GB (int8) at the tinyllama-1.1b buffer, against ~12
integer operations per coordinate for the draw, which the kernel computes
while the row's loads are in flight.

CPU tensors go to the plain version :func:`quantize_blocks_plain` (same
arithmetic, bit-identical); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import quantize_blocks_plain  # noqa: F401  (plain version)


def quantize_blocks(x2d: torch.Tensor, noise, levels: torch.Tensor, *,
                    num_symbols: int, q_is_inf: bool, bits: int = 8, seed=None):
    """Quantize [nb, bucket] -> (payload [nb, P] int8, norms [nb] f32).

    P = bucket (``bits=8``) or bucket // 2 (``bits=4``, packed in-kernel).
    The rounding noise is ``noise``, the [nb, bucket] uniform [0, 1)
    buffer, or, with ``noise=None``, the device PRNG's draw of the 64-bit
    ``seed`` (exactly one of the two; else ``ValueError``).
    """
    nb, bucket = x2d.shape
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if bits == 4 and bucket % 2:
        raise ValueError("4-bit packing needs an even bucket size")
    variant = cuda.rounding(noise, seed, nb, bucket)
    if levels.shape != (num_symbols,):
        raise ValueError(f"levels shape {tuple(levels.shape)} != ({num_symbols},)")
    if x2d.device.type != "cuda":
        return quantize_blocks_plain(x2d, noise, levels, num_symbols=num_symbols,
                                     q_is_inf=q_is_inf, bits=bits, seed=seed)
    dev = x2d.device
    x = cuda.prepare(x2d, torch.float32, dev)
    r = cuda.prepare(noise, torch.float32, dev) if seed is None else None
    lv = cuda.prepare(levels, torch.float32, dev)
    out = torch.empty((nb, bucket if bits == 8 else bucket // 2), dtype=torch.int8,
                      device=dev)
    norms = torch.empty((nb,), dtype=torch.float32, device=dev)
    cuda.call("qx_quantize", "quantize_blocks" + variant, dev, x.data_ptr(),
              None if r is None else r.data_ptr(), int(seed or 0), seed is not None,
              lv.data_ptr(), num_symbols, nb, bucket, int(q_is_inf), bits,
              out.data_ptr(), norms.data_ptr())
    return out, norms
