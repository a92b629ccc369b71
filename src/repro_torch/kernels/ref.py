"""Plain PyTorch versions of the exchange kernels' row math.

Port of ``repro/kernels/common.py`` (``norm_rows``, ``quant_rows``,
``dequant_rows``, ``pack4_rows``, ``unpack4_rows``,
``segment_quant_dequant_rows``) and of the K-mean ``_mean_rows`` of
``repro/kernels/dequant_reduce.py``.  These follow the
Pallas kernels' arithmetic, not ``repro/kernels/ref.py``'s: the level
bracket is found by compare-accumulate over the interior levels and the
K-mean is ``acc * (1/K)`` (not ``mean``) — the two differ in ulps (C2 in
ROADMAP.md), and these functions equal the Pallas kernels bit for bit.

Each ``*_blocks_plain`` function is the plain version of one CUDA kernel
in :mod:`repro_torch.kernels`: the wrapper there runs it for CPU tensors,
and ``chip_smoke.py`` holds the kernel against it on the card.  Given a
``seed`` in place of the noise buffer, each first draws that buffer with
:func:`philox_uniform`, the plain version of the kernels' in-kernel draw
(the port of ``repro/kernels/common.py::prng_uniform``).
"""

from __future__ import annotations

import numpy as np
import torch


# -- the device-PRNG draw: Philox4x32-10 ------------------------------------

PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers (Random123)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key schedule increments
_MASK32 = 0xFFFFFFFF
SEED_LIMIT = 1 << 64  # seeds are 64-bit: the two words of the Philox key


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of ``m * x`` for ``x`` in [0, 2^32) held in
    int64.  ``m`` is split into 16-bit halves so that no partial product
    reaches 2^63."""
    a = x * (m >> 16)  # < 2^48
    b = x * (m & 0xFFFF)  # < 2^48
    c = ((a & 0xFFFF) << 16) + b  # < 2^49
    return (a >> 16) + (c >> 32), c & _MASK32


def philox4x32_10(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11): four int64 tensors of 32-bit
    counter words (broadcastable) and a key of two 32-bit ints -> the four
    output words, broadcast to one shape."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for i in range(10):
        if i:
            k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.broadcast_tensors(c0, c1, c2, c3)


def seed_key(seed: int) -> tuple:
    """The Philox key of a 64-bit seed: (low word, high word)."""
    seed = int(seed)
    if not 0 <= seed < SEED_LIMIT:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    return seed & _MASK32, seed >> 32


def philox_uniform(seed: int, row0: int, rows: int, bucket: int, device) -> torch.Tensor:
    """The device-PRNG rounding noise of rows ``[row0, row0 + rows)`` of a
    launch: coordinate (row, col) is output word ``col % 4`` of
    Philox4x32-10 at counter ``(row, col // 4, 0, 0)`` under the key
    :func:`seed_key` (``seed``), mapped to the reference's 24-bit grid
    ``((w >> 8) & 0xFFFFFF) * 2^-24`` in [0, 1).  A draw depends only on
    (seed, row, col): not on the block, the tile or the bucket width.
    Returns [rows, bucket] f32 on ``device``."""
    key = seed_key(seed)
    if row0 < 0 or row0 + rows > 1 << 32:
        raise ValueError(f"rows [{row0}, {row0 + rows}) do not fit a 32-bit counter")
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)[:, None]
    q = torch.arange(-(-bucket // 4), dtype=torch.int64, device=device)[None, :]
    z = torch.zeros((), dtype=torch.int64, device=device)
    w = torch.stack(philox4x32_10((r, q, z, z), key), dim=-1).reshape(rows, -1)[:, :bucket]
    return ((w >> 8) & 0xFFFFFF).to(torch.float32) * 2.0**-24


def _noise_of(noise, seed, rows: int, bucket: int, device):
    """The rounding noise of a plain version: the given buffer, or the
    device-PRNG draw of ``seed``."""
    return noise if seed is None else philox_uniform(seed, 0, rows, bucket, device)


def inv_workers(num_workers: int) -> float:
    """``1/K`` rounded to f32, as the reference's ``acc * (1.0 / K)``."""
    return float(np.float32(1.0 / num_workers))


def norm_rows(x: torch.Tensor, q_is_inf: bool) -> torch.Tensor:
    """Per-row L^inf or L^2 norm of a [rows, bucket] f32 tile."""
    if q_is_inf:
        return x.abs().amax(dim=1)
    return torch.sqrt((x * x).sum(dim=1))


def pack4_rows(signed_idx: torch.Tensor) -> torch.Tensor:
    """[rows, bucket] int32 in [-7, 7] -> [rows, bucket // 2] int8 with
    byte = (a & 0xF) | ((b & 0xF) << 4) for column pairs (2j, 2j + 1)."""
    a = signed_idx[:, 0::2] & 0xF
    b = signed_idx[:, 1::2] & 0xF
    return (a | (b << 4)).to(torch.uint8).view(torch.int8)


def unpack4_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack4_rows`: [rows, P] int8 -> [rows, 2P] int32."""
    u = packed.to(torch.int32) & 0xFF
    a = u & 0xF
    b = (u >> 4) & 0xF
    a = torch.where(a >= 8, a - 16, a)
    b = torch.where(b >= 8, b - 16, b)
    rows, half = packed.shape
    return torch.stack([a, b], dim=-1).reshape(rows, 2 * half)


def dequant_rows(signed_idx: torch.Tensor, lv: torch.Tensor,
                 norms: torch.Tensor) -> torch.Tensor:
    """DEQ: signed int32 indices [rows, bucket] -> f32 values
    ``levels[|idx|] * sign * norm``."""
    vals = lv[signed_idx.abs()]
    sign = torch.where(signed_idx < 0, -1.0, 1.0)
    return vals * sign * norms[:, None]


def quant_rows(x: torch.Tensor, lv: torch.Tensor, r: torch.Tensor,
               num_symbols: int, q_is_inf: bool):
    """Q: f32 [rows, bucket] -> (signed int32 indices, f32 row norms).

    Row norm, ``u = clip(|x| / norm, 0, 1)`` (norm 0 -> 1), bracket
    ``tau = #{1 <= j <= s : levels[j] <= u}``, stochastic rounding
    ``up = r < (u - lo) / (hi - lo)`` against the uniform noise ``r``.
    """
    norms = norm_rows(x, q_is_inf)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    u = torch.clamp(x.abs() / safe[:, None], 0.0, 1.0)
    tau = torch.zeros(u.shape, dtype=torch.int32, device=x.device)
    for j in range(1, num_symbols - 1):
        tau += (u >= lv[j]).to(torch.int32)
    lo = lv[tau]
    hi = lv[tau + 1]
    xi = (u - lo) / (hi - lo)
    idx = tau + (r < xi).to(torch.int32)
    return torch.where(x < 0, -idx, idx), norms


def unpack_payload(payload: torch.Tensor, bits: int) -> torch.Tensor:
    """Wire payload [rows, P] int8 -> signed int32 indices [rows, bucket]."""
    return unpack4_rows(payload) if bits == 4 else payload.to(torch.int32)


def pack_payload(signed: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed int32 indices [rows, bucket] -> wire payload [rows, P] int8."""
    return pack4_rows(signed) if bits == 4 else signed.to(torch.int8)


def mean_rows(idx: torch.Tensor, norms: torch.Tensor, lv: torch.Tensor,
              bits: int) -> torch.Tensor:
    """``mean_k DEQ(payload_k)`` as ``(sum_k term_k) * (1/K)``, summed in
    worker order (idx [K, rows, P], norms [K, rows])."""
    acc = None
    for k in range(idx.shape[0]):
        term = dequant_rows(unpack_payload(idx[k], bits), lv, norms[k])
        acc = term if acc is None else acc + term
    return acc * inv_workers(idx.shape[0])


# -- the plain version of each kernel ---------------------------------------


def quantize_blocks_plain(x2d, noise, levels, *, num_symbols, q_is_inf, bits, seed=None):
    """Plain version of kernel 1 (``quantize_blocks``)."""
    r = _noise_of(noise, seed, *x2d.shape, x2d.device)
    signed, norms = quant_rows(x2d.float(), levels.float(), r.float(), num_symbols, q_is_inf)
    return pack_payload(signed, bits), norms


def dequantize_blocks_plain(idx2d, norms, levels, *, bits):
    """Plain version of kernel 3 (``dequantize_blocks``)."""
    return dequant_rows(unpack_payload(idx2d, bits), levels.float(), norms.float())


def dequant_reduce_blocks_plain(idx, norms, levels, *, bits):
    """Plain version of kernel 4 (``dequant_reduce_blocks``)."""
    return mean_rows(idx, norms.float(), levels.float(), bits)


def dequant_reduce_requantize_blocks_plain(idx, norms, levels, noise, *,
                                           num_symbols, q_is_inf, bits, seed=None):
    """Plain version of kernel 2 (``dequant_reduce_requantize_blocks``)."""
    lv = levels.float()
    reduced = mean_rows(idx, norms.float(), lv, bits)
    r = _noise_of(noise, seed, *reduced.shape, reduced.device)
    signed, norms2 = quant_rows(reduced, lv, r.float(), num_symbols, q_is_inf)
    return pack_payload(signed, bits), norms2


# -- kernel 5: segment-fused quantize∘dequantize -----------------------------


def segment_quant_dequant_rows(x: torch.Tensor, tables: torch.Tensor, seg: torch.Tensor,
                               r, *, num_symbols: tuple, q_is_inf: bool,
                               stochastic: bool = True) -> torch.Tensor:
    """Fused Q∘DEQ of [rows, bucket] f32 with a per-row level table (port of
    ``repro/kernels/common.py::segment_quant_dequant_rows``).

    ``tables`` is the stacked ``[T, S_max]`` buffer (short tables padded
    with 1.0), ``seg`` the [rows] table id of each row and ``num_symbols``
    the live symbol count of each table.  The bracket counts the interior
    levels ``1 .. num_symbols[t] - 2`` of the row's own table ``t``, which
    is the reference's masked compare over the union of levels.  Rounding
    is ``r < xi`` (stochastic) or ``xi >= 0.5`` (nearest, ``r`` unused);
    the output is ``where(x < 0, -v, v) * norm``.
    """
    norms = norm_rows(x, q_is_inf)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    u = torch.clamp(x.abs() / safe[:, None], 0.0, 1.0)
    seg = seg.long()
    row_lv = tables[seg]  # [rows, S_max]: each row's own table
    tau = torch.zeros(u.shape, dtype=torch.int64, device=x.device)
    for j in range(1, tables.shape[1] - 1):
        live = [t for t in range(len(num_symbols)) if j <= num_symbols[t] - 2]
        if not live:
            continue
        hit = u >= row_lv[:, j, None]
        if len(live) < len(num_symbols):
            act = torch.zeros(seg.shape, dtype=torch.bool, device=x.device)
            for t in live:
                act |= seg == t
            hit &= act[:, None]
        tau += hit
    lo = torch.gather(row_lv, 1, tau)
    hi = torch.gather(row_lv, 1, tau + 1)
    xi = (u - lo) / (hi - lo)
    up = (r < xi) if stochastic else (xi >= 0.5)
    vals = torch.gather(row_lv, 1, tau + up.long())
    return torch.where(x < 0, -vals, vals) * norms[:, None]


def quantize_dequantize_segments_plain(x2d, noise, tables, seg_ids, *, num_symbols,
                                       q_is_inf, stochastic=True, seed=None):
    """Plain version of kernel 5 (``quantize_dequantize_segments``)."""
    if stochastic:
        noise = _noise_of(noise, seed, *x2d.shape, x2d.device)
    return segment_quant_dequant_rows(
        x2d.float(), tables.float(), seg_ids, None if noise is None else noise.float(),
        num_symbols=tuple(num_symbols), q_is_inf=q_is_inf, stochastic=stochastic)
