"""Kernels 2 and 4: the consumer side of the exchange, hand-written in
CUDA for Hopper.

``dequant_reduce_requantize_blocks`` (kernel 2) replaces
``repro/kernels/dequant_reduce.py::dequant_reduce_requantize_blocks``, the
two-phase middle step: unpack the K payloads received by the all_to_all,
dequantize, take ``acc * (1/K)`` summed in worker order, and quantize that
mean again against fresh noise.  The reduced row never reaches device
memory: one warp per row computes the K-mean straight into registers (256
coordinates of it; a wider row recomputes the rest from the payload for
its second pass), takes the norm by warp shuffles and re-quantizes from
there, with the bracket found as kernel 1 finds it (``levels`` sorted
ascending).  Bound on the H100: instruction issue as much as bytes — K
payload rows and norms plus the noise row read, one payload row and norm
written, against ~80 instructions per coordinate.

``dequant_reduce_blocks`` (kernel 4) replaces
``repro/kernels/dequant_reduce.py::dequant_reduce_blocks``, the gather
consumer: ``mean_k DEQ(payload_k)``, with only the f32 mean written.
Bound on the H100: device-memory traffic — K payload rows read, one f32
row written; the K dequantized rows stay in registers.

Both keep the level table in shared memory (``csrc/exchange_kernels.cu``;
kernel 4 gives each bucket row one thread block).  Kernel 2 has a
device-PRNG variant (``seed=`` in place of ``noise``; TPU kernel B5 at its
call site ``repro/kernels/dequant_reduce.py:124``): the re-quantize draw
is made with Philox4x32-10 in registers while the payload loads are in
flight, so of kernel 2's traffic only the K payloads in and the payload
out remain (2.2 GB instead of 6.6 GB at the tinyllama-1.1b buffer,
K = 1), and ~12 integer operations per coordinate bound it instead.  CPU
tensors go to the plain versions; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    dequant_reduce_blocks_plain,
    dequant_reduce_requantize_blocks_plain,
    inv_workers,
)


def _check(idx, norms, levels, num_symbols, num_workers, bits):
    K, nb, pcols = idx.shape
    if K != num_workers:
        raise ValueError(f"payload has {K} workers, num_workers={num_workers}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if tuple(norms.shape) != (K, nb):
        raise ValueError(f"norms shape {tuple(norms.shape)} != {(K, nb)}")
    if levels.shape != (num_symbols,):
        raise ValueError(f"levels shape {tuple(levels.shape)} != ({num_symbols},)")
    return K, nb, pcols if bits == 8 else 2 * pcols


def dequant_reduce_blocks(idx: torch.Tensor, norms: torch.Tensor, levels: torch.Tensor,
                          *, num_symbols: int, num_workers: int,
                          bits: int = 8) -> torch.Tensor:
    """Fused DEQ + mean over K workers: [K, nb, P] -> [nb, bucket] f32."""
    K, nb, bucket = _check(idx, norms, levels, num_symbols, num_workers, bits)
    if idx.device.type != "cuda":
        return dequant_reduce_blocks_plain(idx, norms, levels, bits=bits)
    dev = idx.device
    p = cuda.prepare(idx, torch.int8, dev)
    nrm = cuda.prepare(norms, torch.float32, dev)
    lv = cuda.prepare(levels, torch.float32, dev)
    out = torch.empty((nb, bucket), dtype=torch.float32, device=dev)
    cuda.call("qx_dequant_reduce", "dequant_reduce_blocks", dev, p.data_ptr(),
              nrm.data_ptr(), lv.data_ptr(), num_symbols, K, nb, bucket, bits,
              inv_workers(K), out.data_ptr())
    return out


def dequant_reduce_requantize_blocks(idx: torch.Tensor, norms: torch.Tensor,
                                     levels: torch.Tensor, noise, *,
                                     num_symbols: int, num_workers: int,
                                     q_is_inf: bool, bits: int = 8, seed=None):
    """Fused DEQ + mean + re-quantize -> (payload [nb, P] int8, norms [nb]).

    The re-quantize noise is ``noise`` ([nb, bucket] uniform) or, with
    ``noise=None``, the device PRNG's draw of ``seed`` (exactly one)."""
    K, nb, bucket = _check(idx, norms, levels, num_symbols, num_workers, bits)
    variant = cuda.rounding(noise, seed, nb, bucket)
    if idx.device.type != "cuda":
        return dequant_reduce_requantize_blocks_plain(
            idx, norms, levels, noise, num_symbols=num_symbols, q_is_inf=q_is_inf,
            bits=bits, seed=seed)
    dev = idx.device
    p = cuda.prepare(idx, torch.int8, dev)
    nrm = cuda.prepare(norms, torch.float32, dev)
    r = cuda.prepare(noise, torch.float32, dev) if seed is None else None
    lv = cuda.prepare(levels, torch.float32, dev)
    out = torch.empty((nb, bucket if bits == 8 else bucket // 2), dtype=torch.int8,
                      device=dev)
    onorms = torch.empty((nb,), dtype=torch.float32, device=dev)
    cuda.call("qx_dequant_reduce_requantize", "dequant_reduce_requantize_blocks" + variant,
              dev, p.data_ptr(), nrm.data_ptr(), None if r is None else r.data_ptr(),
              int(seed or 0), seed is not None, lv.data_ptr(), num_symbols, K, nb, bucket,
              int(q_is_inf), bits, inv_workers(K), out.data_ptr(), onorms.data_ptr())
    return out, onorms
