"""Entropy coding of quantized dual vectors (Section 3.2, Theorem 2, App. K).

The port's own copy of ``repro/core/coding.py`` (numpy only; the port
imports nothing of the JAX package).

The wire format CODE o Q is: C_b bits for the bucket norm (f32 -> 32), one
sign bit per *nonzero* coordinate, and a prefix code for each level index.
Two codes are provided, per Appendix K:

* **Elias gamma** (distribution unknown, smaller indices more frequent):
  len(gamma(n)) = 2*floor(log2 n) + 1 bits for n >= 1; index j is coded as
  gamma(j + 1).
* **Huffman** (distribution known / estimated from QAda sufficient stats):
  optimal prefix code, expected length within 1 bit of entropy
  (Theorem 7 / Cover & Thomas).

On-device payloads stay fixed-width int8/int4 (a collective moves
fixed-size buffers, not ragged bitstreams); this module is the host-side
bit-exact oracle of Theorem 2's code lengths, and the source of ``C_B``
for the train step's ``coded_bits_est`` metric
(:func:`repro_torch.core.exchange.theorem2_bits_traced`).
"""

from __future__ import annotations

import heapq
import math
from typing import Sequence

import numpy as np

C_B = 32  # bits for the bucket norm scalar (standard f32, as in the paper)


# ---------------------------------------------------------------------------
# Code-length accounting (Theorem 2)
# ---------------------------------------------------------------------------


def entropy_bits(p: np.ndarray) -> float:
    """H(L) = -sum_j p_j log2 p_j over nonzero-probability symbols."""
    p = np.asarray(p, dtype=np.float64)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def theorem2_expected_bits(p: np.ndarray, d: int, num_buckets: int = 1) -> float:
    """Theorem 2 upper bound: C_b + (1 - p0) d + (H(L) + 1) d  (per bucket norm)."""
    p = np.asarray(p, dtype=np.float64)
    p0 = float(p[0])
    return C_B * num_buckets + (1.0 - p0) * d + (entropy_bits(p) + 1.0) * d


def elias_gamma_length(n: int) -> int:
    """Length in bits of the Elias gamma code of integer n >= 1."""
    if n < 1:
        raise ValueError("Elias gamma codes integers >= 1")
    return 2 * int(math.floor(math.log2(n))) + 1


def expected_elias_bits(p: np.ndarray, d: int, num_buckets: int = 1) -> float:
    """Expected wire bits with Elias-gamma coded indices + sign bits."""
    p = np.asarray(p, dtype=np.float64)
    per_sym = sum(
        pj * elias_gamma_length(j + 1) for j, pj in enumerate(p) if pj > 0
    )
    sign_bits = 1.0 - float(p[0])
    return C_B * num_buckets + (per_sym + sign_bits) * d


def huffman_code(p: Sequence[float]) -> dict[int, str]:
    """Build a Huffman code for symbol probabilities p (len >= 2)."""
    heap = [(float(pj), i, (i,)) for i, pj in enumerate(p)]
    heapq.heapify(heap)
    codes = {i: "" for i in range(len(p))}
    uid = len(p)
    while len(heap) > 1:
        pa, _, syms_a = heapq.heappop(heap)
        pb, _, syms_b = heapq.heappop(heap)
        for s in syms_a:
            codes[s] = "0" + codes[s]
        for s in syms_b:
            codes[s] = "1" + codes[s]
        heapq.heappush(heap, (pa + pb, uid, syms_a + syms_b))
        uid += 1
    return codes


def expected_huffman_bits(p: np.ndarray, d: int, num_buckets: int = 1) -> float:
    p = np.asarray(p, dtype=np.float64)
    codes = huffman_code(list(p))
    per_sym = sum(p[j] * len(codes[j]) for j in range(len(p)))
    sign_bits = 1.0 - float(p[0])
    return C_B * num_buckets + (per_sym + sign_bits) * d


# ---------------------------------------------------------------------------
# Bit-exact codec (oracle) — encodes signed level indices + norms to bytes
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def write(self, bitstring: str):
        self.bits.extend(1 if c == "1" else 0 for c in bitstring)

    def write_uint(self, value: int, width: int):
        for i in range(width - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def write_elias_gamma(self, n: int):
        nbits = int(math.floor(math.log2(n)))
        self.bits.extend([0] * nbits)
        self.write_uint(n, nbits + 1)

    def getvalue(self) -> bytes:
        pad = (-len(self.bits)) % 8
        bits = self.bits + [0] * pad
        arr = np.array(bits, dtype=np.uint8).reshape(-1, 8)
        return np.packbits(arr, axis=1).tobytes()

    def __len__(self):
        return len(self.bits)


class _BitReader:
    def __init__(self, data: bytes, nbits: int):
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))[:nbits]
        self.pos = 0

    def read_bit(self) -> int:
        b = int(self.bits[self.pos])
        self.pos += 1
        return b

    def read_uint(self, width: int) -> int:
        v = 0
        for _ in range(width):
            v = (v << 1) | self.read_bit()
        return v

    def read_elias_gamma(self) -> int:
        nbits = 0
        while self.read_bit() == 0:
            nbits += 1
        v = 1
        for _ in range(nbits):
            v = (v << 1) | self.read_bit()
        return v


def encode(
    signed_indices: np.ndarray,
    norms: np.ndarray,
    method: str = "elias",
    codes: dict[int, str] | None = None,
) -> tuple[bytes, int]:
    """CODE o Q: encode signed level indices and bucket norms to a bitstream.

    Returns (payload_bytes, exact_bit_length).
    """
    w = _BitWriter()
    for nrm in np.asarray(norms, dtype=np.float32):
        w.write_uint(int(np.float32(nrm).view(np.uint32)), C_B)
    for si in np.asarray(signed_indices, dtype=np.int64):
        j = abs(int(si))
        if method == "elias":
            w.write_elias_gamma(j + 1)
        elif method == "huffman":
            assert codes is not None
            w.write(codes[j])
        else:
            raise ValueError(method)
        if j != 0:
            w.bits.append(0 if si > 0 else 1)
    return w.getvalue(), len(w)


def decode(
    data: bytes,
    nbits: int,
    n: int,
    num_buckets: int,
    method: str = "elias",
    codes: dict[int, str] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """DEQ o CODE (index stage): recover signed indices and norms."""
    r = _BitReader(data, nbits)
    norms = np.empty(num_buckets, dtype=np.float32)
    for i in range(num_buckets):
        norms[i] = np.uint32(r.read_uint(C_B)).view(np.float32)
    inv = None
    if method == "huffman":
        assert codes is not None
        inv = {v: k for k, v in codes.items()}
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        if method == "elias":
            j = r.read_elias_gamma() - 1
        else:
            cur = ""
            while cur not in inv:
                cur += str(r.read_bit())
            j = inv[cur]
        if j == 0:
            out[i] = 0
        else:
            sign = -1 if r.read_bit() else 1
            out[i] = sign * j
    return out, norms
