"""Unbiased random quantization Q_ell (Definition 1 of the paper) — config,
level tables, bucketing and the int4 wire packing.

Port of ``repro/core/quantization.py``.  A vector is sent as a signed level
index per coordinate (int8, or two 4-bit indices per byte) plus one f32
L^q norm per bucket of ``bucket_size`` coordinates.  The quantize and
dequantize passes themselves are the exchange kernels in
:mod:`repro_torch.kernels`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of the quantizer.

    Attributes:
      num_levels: ``s`` — number of interior levels (s + 2 symbols with the
        0 and 1 endpoints).
      q_norm: the ``q`` of the L^q normalization (``math.inf`` or 2.0).
      bucket_size: coordinates per norm bucket (even: 4-bit packing).
      bits: 8 (one signed index per byte) or 4 (two per byte; s + 1 <= 7).
      stochastic: unbiased stochastic rounding (True) or round-to-nearest
        (False).  ``compress_tree`` (kernel 5) honours it; the pmean
        kernels (1-4), like the reference's Pallas route, always round
        stochastically.
    """

    num_levels: int = 15
    q_norm: float = math.inf
    bucket_size: int = 1024
    bits: int = 8
    stochastic: bool = True

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        max_idx = self.num_levels + 1
        limit = 7 if self.bits == 4 else 127
        if max_idx > limit:
            raise ValueError(
                f"num_levels={self.num_levels} does not fit {self.bits}-bit payload"
            )
        if self.bucket_size % 2:
            raise ValueError("bucket_size must be even (4-bit packing)")

    @property
    def num_symbols(self) -> int:
        return self.num_levels + 2

    @property
    def q_is_inf(self) -> bool:
        return math.isinf(self.q_norm)

    def payload_bytes(self, n: int) -> int:
        """Fixed-width wire bytes of an n-coordinate vector (incl. norms)."""
        nb = -(-n // self.bucket_size)
        per_coord = 1 if self.bits == 8 else 0.5
        return int(nb * self.bucket_size * per_coord) + 4 * nb


def uniform_levels(s: int, device) -> torch.Tensor:
    """QSGD-style uniform levels j / (s + 1), j = 0..s+1 (f32).

    Computed as ``jnp.linspace`` does in f32 so the table is bit-identical
    to the reference's.
    """
    lv = np.linspace(np.float32(0.0), np.float32(1.0), s + 2, dtype=np.float32)
    return torch.from_numpy(lv).to(device)


def exponential_levels(s: int, device) -> torch.Tensor:
    """NUQSGD-style levels 0, 2^-s, ..., 1/2, 1 (f32)."""
    interior = 2.0 ** np.arange(-s, 0, dtype=np.float32)
    lv = np.concatenate([[0.0], interior, [1.0]]).astype(np.float32)
    return torch.from_numpy(lv).to(device)


def validate_levels(levels: torch.Tensor, s: int) -> None:
    lv = levels.detach().cpu().numpy()
    if lv.shape != (s + 2,):
        raise ValueError(f"levels must have shape ({s + 2},), got {lv.shape}")
    if lv[0] != 0.0 or lv[-1] != 1.0:
        raise ValueError("levels must start at 0 and end at 1")
    if not np.all(np.diff(lv) > 0):
        raise ValueError("levels must be strictly increasing")


def pad_to_buckets(flat: torch.Tensor, bucket: int) -> tuple[torch.Tensor, int]:
    """[n] -> ([nb, bucket] zero-padded, n); ``bucket`` may be any quota
    (two_phase pads to K buckets)."""
    n = flat.shape[0]
    nb = -(-n // bucket)
    pad = nb * bucket - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nb, bucket), n


def bucket_norms(v2d: torch.Tensor, q: float) -> torch.Tensor:
    """Per-bucket L^q norm, [nb, bucket] -> [nb] (f32)."""
    a = v2d.float().abs()
    if math.isinf(q):
        return a.amax(dim=-1)
    if q == 2.0:
        return torch.sqrt((a * a).sum(dim=-1))
    if q == 1.0:
        return a.sum(dim=-1)
    return (a**q).sum(dim=-1) ** (1.0 / q)


def pack_int4(idx_signed: torch.Tensor) -> torch.Tensor:
    """Pack signed 4-bit values (in [-7, 7]) two per int8 byte.

    byte = (a & 0xF) | ((b & 0xF) << 4) for consecutive pairs (a, b).
    """
    flat = idx_signed.reshape(-1, 2).to(torch.int32)
    a = flat[:, 0] & 0xF
    b = flat[:, 1] & 0xF
    return (a | (b << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> int32 signed values, shape [2*len]."""
    p = packed.view(torch.uint8).to(torch.int32)
    a = p & 0xF
    b = (p >> 4) & 0xF
    a = torch.where(a >= 8, a - 16, a)
    b = torch.where(b >= 8, b - 16, b)
    return torch.stack([a, b], dim=-1).reshape(-1)
