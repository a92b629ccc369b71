"""Unbiased random quantization Q_ell (Definition 1 of the paper) — config,
level tables, bucketing and the int4 wire packing.

Port of ``repro/core/quantization.py``.  A vector is sent as a signed level
index per coordinate (int8, or two 4-bit indices per byte) plus one f32
L^q norm per bucket of ``bucket_size`` coordinates.  The quantize and
dequantize passes themselves are the exchange kernels in
:mod:`repro_torch.kernels`: the flat :func:`quantize` / :func:`dequantize`
run kernels 1 and 3 (through :mod:`repro_torch.kernels.ops`, the port of
TPU wrapper B7) and :func:`quantize_dequantize` runs kernel 5 with one
table; a CUDA tensor launches them, a CPU tensor takes their plain
versions.  Every stochastic rounding takes its uniform noise from a noise
source (:mod:`repro_torch.core.noise`), one ``[nb, bucket]`` draw per
vector (per leaf of a pytree, in leaf order), where the reference draws
``jax.random.uniform(key, u.shape)``.  :func:`theorem1_epsilon_q` is the
reference's numpy bound as it is.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten

# kernel 1 rounds up where r < xi; with every r at the largest f32 below
# 0.5 that is xi >= 0.5, the reference's round-to-nearest
_NEAREST_NOISE = float(np.nextafter(np.float32(0.5), np.float32(0.0)))


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


# ---------------------------------------------------------------------------
# Quantize / dequantize (flat vectors)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Quantized:
    """A quantized flat vector: ``payload`` int8 signed level indices,
    ``[nb * bucket]`` (8 bit) or packed two per byte ``[nb * bucket // 2]``
    (4 bit); ``norms`` f32 ``[nb]``; ``n`` the unpadded length."""

    payload: torch.Tensor
    norms: torch.Tensor
    n: int

    def wire_bytes(self) -> int:
        return int(self.payload.numel() * self.payload.element_size()
                   + self.norms.numel() * 4)


def _stochastic_round_indices(u: torch.Tensor, levels: torch.Tensor, noise,
                              stochastic: bool) -> torch.Tensor:
    """Normalized coordinates u in [0, 1] ([nb, bucket] f32) -> level
    indices in [0, s + 1] (int32), unbiased: ``tau + (r < xi)`` with one
    ``noise.uniform(u.shape)`` draw, or ``tau + (xi >= 0.5)``."""
    lv = levels.float()
    tau = torch.searchsorted(lv.contiguous(), u.contiguous(), right=True) - 1
    tau = tau.clamp(0, lv.shape[0] - 2)
    lo, hi = lv[tau], lv[tau + 1]
    xi = (u - lo) / (hi - lo)
    if stochastic:
        up = noise.uniform(u.shape, u.device) < xi
    else:
        up = xi >= 0.5
    return (tau + up.to(tau.dtype)).to(torch.int32)


class _Constant:
    """A noise source whose every draw is one constant."""

    def __init__(self, value: float):
        self.value = value

    def uniform(self, shape, device) -> torch.Tensor:
        return torch.full(tuple(shape), self.value, dtype=torch.float32, device=device)


def quantize(v: torch.Tensor, levels: torch.Tensor, noise, cfg: QuantConfig) -> Quantized:
    """Quantize a flat vector per Definition 1 (bucketed L^q normalization)
    with kernel 1.  ``noise`` gives one ``[nb, bucket]`` uniform draw
    (unused with ``cfg.stochastic=False``, which rounds to nearest)."""
    from repro_torch.kernels.ops import quantize_flat

    return quantize_flat(v, levels, noise if cfg.stochastic else _Constant(_NEAREST_NOISE), cfg)


def dequantize(qt: Quantized, levels: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Inverse map with kernel 3: signed index -> level * sign * bucket
    norm; returns the ``[n]`` f32 vector."""
    from repro_torch.kernels.ops import dequantize_flat

    return dequantize_flat(qt, levels, cfg)


def quantize_dequantize(v: torch.Tensor, levels: torch.Tensor, noise,
                        cfg: QuantConfig, workers: bool = False) -> torch.Tensor:
    """Q then DEQ fused (hat{v} = Q_ell(v)) in one launch of kernel 5 with
    one level table, on ``v``'s own bucket padding; shaped like ``v``, f32.
    With ``workers=True`` ``v``'s leading dim holds W workers' vectors, each
    padded on its own, all in the one launch, one ``[nb, bucket]`` draw a
    worker in worker order (none under round-to-nearest)."""
    from repro_torch.kernels.segment_quantize import quantize_dequantize_segments

    W = v.shape[0] if workers else 1
    x = v.reshape(W, -1).float()
    n, b = x.shape[1], cfg.bucket_size
    nb = -(-n // b)
    if nb * b > n:
        x = torch.cat([x, x.new_zeros((W, nb * b - n))], dim=1)
    x2d = x.reshape(W * nb, b)
    r = None
    if cfg.stochastic:
        draws = [noise.uniform((nb, b), x2d.device) for _ in range(W)]
        r = draws[0] if W == 1 else torch.cat(draws)
    seg = torch.zeros((W * nb,), dtype=torch.int32, device=x2d.device)
    hat = quantize_dequantize_segments(
        x2d, r, levels.float().reshape(1, -1), seg, num_symbols=(cfg.num_symbols,),
        q_is_inf=cfg.q_is_inf, stochastic=cfg.stochastic)
    return hat.reshape(W, nb * b)[:, :n].reshape(v.shape)


# ---------------------------------------------------------------------------
# Pytree forms (one noise draw per leaf, in JAX flatten order)
# ---------------------------------------------------------------------------


def quantize_pytree(tree, levels: torch.Tensor, noise, cfg: QuantConfig):
    """Quantize every leaf (a :class:`Quantized` per leaf)."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [quantize(l, levels, noise, cfg) for l in leaves])


def dequantize_pytree(qtree, shapes_tree, levels: torch.Tensor, cfg: QuantConfig):
    """Dequantize a pytree of :class:`Quantized` back to the leaf shapes of
    ``shapes_tree`` (tensors, or shape tuples as leaves of a list/dict)."""
    qleaves, spec = tree_flatten(qtree)
    shapes = _shape_leaves(shapes_tree)
    return tree_unflatten(spec, [dequantize(q, levels, cfg).reshape(sh)
                                 for q, sh in zip(qleaves, shapes)])


def _shape_leaves(tree) -> list:
    """Leaf shapes of a tree whose leaves are tensors or shape tuples."""
    out = []

    def rec(node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k])
        elif isinstance(node, (list, tuple)) and not all(isinstance(d, int) for d in node):
            for c in node:
                rec(c)
        else:
            out.append(tuple(node.shape) if hasattr(node, "shape") else tuple(node))

    rec(tree)
    return out


def quantize_dequantize_pytree(tree, levels: torch.Tensor, noise, cfg: QuantConfig):
    """Per-leaf Q∘DEQ, each leaf with its own padding tail and draw, cast
    back to the leaf's dtype (the unplanned layout; ``compress_tree``
    uses the plan)."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [quantize_dequantize(l, levels, noise, cfg).to(l.dtype)
                                 for l in leaves])


# ---------------------------------------------------------------------------
# Theorem 1 — analytic variance bound epsilon_Q
# ---------------------------------------------------------------------------


def theorem1_epsilon_q(levels, d: int, q: float) -> float:
    """Analytic variance multiplier bound of Theorem 1::

        eps_Q = (lbar + 1/lbar)/4 - 1/2
                + 1/4 l1^2 d^{2/min(q,2)}            if d <= d_th
                + (l1 d^{1/min(q,2)} - 1)            if d >= d_th

    with lbar = max_j l_{j+1}/l_j (interior ratios) and
    d_th = (2 / l1)^{min(q,2)}.  ``levels`` may be a tensor or an array."""
    if isinstance(levels, torch.Tensor):
        levels = levels.detach().cpu().numpy()
    levels = np.asarray(levels, dtype=np.float64)
    l1 = float(levels[1])
    ratios = levels[2:] / np.maximum(levels[1:-1], 1e-30)
    lbar = float(np.max(ratios)) if ratios.size else 1.0
    qm = min(q, 2.0)
    d_th = (2.0 / l1) ** qm
    eps = (lbar + 1.0 / lbar) / 4.0 - 0.5
    if d <= d_th:
        eps += 0.25 * l1**2 * d ** (2.0 / qm)
    else:
        eps += l1 * d ** (1.0 / qm) - 1.0
    return float(max(eps, 0.0))


def empirical_variance_multiplier(v: torch.Tensor, levels: torch.Tensor, cfg: QuantConfig,
                                  noise, trials: int = 64) -> float:
    """Monte-Carlo E||Q(v) - v||^2 / ||v||^2 over ``trials`` draws of
    ``noise`` (one per trial)."""
    flat = v.reshape(-1).float()
    errs = torch.stack([torch.sum((quantize_dequantize(v, levels, noise, cfg).reshape(-1)
                                   - flat) ** 2) for _ in range(trials)])
    return float(torch.mean(errs) / torch.sum(flat ** 2))
