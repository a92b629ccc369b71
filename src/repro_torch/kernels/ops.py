"""Flat-vector wrappers around kernels 1 and 3.

Port of ``repro/kernels/ops.py`` (``quantize_pallas`` /
``dequantize_pallas``): pad a flat vector to whole buckets, quantize it
with :func:`repro_torch.kernels.quantize.quantize_blocks`, and invert with
:func:`repro_torch.kernels.dequantize.dequantize_blocks`.  The payload is
the in-kernel packed buffer in 4-bit mode.
"""

from __future__ import annotations

import torch

from repro_torch.core.noise import draw_rounding
from repro_torch.core.quantization import QuantConfig, Quantized, pad_to_buckets
from repro_torch.kernels.dequantize import dequantize_blocks
from repro_torch.kernels.quantize import quantize_blocks


def quantize_flat(v: torch.Tensor, levels: torch.Tensor, noise, cfg: QuantConfig, *,
                  use_device_prng: bool = False) -> Quantized:
    """Quantize a flat vector; ``noise`` is a noise source
    (:mod:`repro_torch.core.noise`) asked for one [nb, bucket] draw, or,
    with ``use_device_prng``, for one seed of the kernel's own draw."""
    x2d, n = pad_to_buckets(v.reshape(-1).float(), cfg.bucket_size)
    r, seed = draw_rounding(noise, x2d.shape, x2d.device, use_device_prng)
    idx, norms = quantize_blocks(x2d, r, levels, num_symbols=cfg.num_symbols,
                                 q_is_inf=cfg.q_is_inf, bits=cfg.bits, seed=seed)
    return Quantized(payload=idx.reshape(-1), norms=norms, n=n)


def dequantize_flat(qt: Quantized, levels: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    pcols = cfg.bucket_size if cfg.bits == 8 else cfg.bucket_size // 2
    out = dequantize_blocks(qt.payload.reshape(-1, pcols), qt.norms, levels,
                            num_symbols=cfg.num_symbols, bits=cfg.bits)
    return out.reshape(-1)[: qt.n]
