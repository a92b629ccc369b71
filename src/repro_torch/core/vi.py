"""Monotone VI test problems and stochastic oracles (Section 2; port of
``repro/core/vi.py``).

The synthetic problems the paper's Theorems 3/4 are checked on: affine
monotone operators A(z) = M z + q.

* :func:`bilinear_saddle` — min_x max_y x^T B y + a^T x - b^T y, the
  skew-symmetric game operator (monotone, not co-coercive: gradient
  descent-ascent diverges, extra-gradient is needed).
* :func:`cocoercive_quadratic` — A = grad of a convex quadratic
  (symmetric PSD M), beta-cocoercive with beta = 1/L (Assumption 4).

M, q and z* are built on the host with the reference's
``np.random.RandomState`` calls, so one seed gives the same problem bit
for bit; :meth:`AffineVI.tensors` puts them on a device as f32 (the
operator's ``M @ z`` is a plain f32 product, TF32 off as is PyTorch's
default).

Noise oracles take their Rademacher signs xi from an explicit noise
source (``noise.rademacher``: :class:`~repro_torch.core.noise.GeneratorNoise`,
or :class:`~repro_torch.core.noise.ReplayNoise` for the reference's
draws), one ``[dim]`` draw per call:

* absolute: g = A(z) + sigma * xi / sqrt(dim) (Assumption 2);
* relative: g = A(z) * (1 + sqrt(c) * xi), E||U||^2 <= c ||A(z)||^2
  (Assumption 3): the noise vanishes at the solution.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AffineVI:
    """Operator A(z) = M @ z + q with known solution z*: M z* + q = 0
    (f64 numpy on the host, as the reference holds them)."""

    M: np.ndarray
    q: np.ndarray
    z_star: np.ndarray

    @property
    def dim(self) -> int:
        return self.M.shape[0]

    def tensors(self, device) -> tuple:
        """(M, q, z*) as f32 tensors on ``device``."""
        return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(device)
                     for a in (self.M, self.q, self.z_star))

    def operator(self, device) -> Callable:
        """A(z) = M @ z + q in f32 on ``device``."""
        M, q, _ = self.tensors(device)
        return lambda z: M @ z + q


def bilinear_saddle(d: int = 32, seed: int = 0, scale: float = 1.0) -> AffineVI:
    """Skew-symmetric game operator: monotone, zero symmetric part."""
    rng = np.random.RandomState(seed)
    B = rng.randn(d, d) / np.sqrt(d) * scale
    M = np.block([[np.zeros((d, d)), B], [-B.T, np.zeros((d, d))]])
    rng.randn(2 * d)  # the reference draws (and drops) an origin first
    z_star = rng.randn(2 * d)
    q = -M @ z_star
    return AffineVI(M=M, q=q, z_star=z_star)


def cocoercive_quadratic(d: int = 64, seed: int = 0, cond: float = 10.0) -> AffineVI:
    """Symmetric PSD operator (gradient of a convex quadratic): co-coercive."""
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.randn(d, d))
    eigs = np.geomspace(1.0, cond, d)
    M = (U * eigs) @ U.T
    z_star = rng.randn(d)
    q = -M @ z_star
    return AffineVI(M=M, q=q, z_star=z_star)


# ---------------------------------------------------------------------------
# Noise oracles (Assumptions 2 / 3)
# ---------------------------------------------------------------------------


def absolute_noise_oracle(vi: AffineVI, sigma: float, device) -> Callable:
    """``oracle(z, noise) = A(z) + sigma * xi / sqrt(dim)``, xi one Rademacher
    draw of ``noise`` (bounded: E||U||^2 = sigma^2 exactly)."""
    op = vi.operator(device)
    root = float(np.sqrt(np.float32(vi.dim)))

    def oracle(z: torch.Tensor, noise) -> torch.Tensor:
        xi = noise.rademacher((vi.dim,), z.device)
        return op(z) + sigma * xi / root

    return oracle


def relative_noise_oracle(vi: AffineVI, c: float, device) -> Callable:
    """``oracle(z, noise) = A(z) * (1 + sqrt(c) * xi)``, xi one Rademacher
    draw of ``noise`` (E||U||^2 <= c ||A(z)||^2)."""
    op = vi.operator(device)
    root = float(np.sqrt(np.float32(c)))

    def oracle(z: torch.Tensor, noise) -> torch.Tensor:
        a = op(z)
        return a * (1.0 + root * noise.rademacher(a.shape, z.device))

    return oracle


# ---------------------------------------------------------------------------
# Performance measures
# ---------------------------------------------------------------------------


def distance_to_solution(vi: AffineVI, z: torch.Tensor) -> torch.Tensor:
    z_star = torch.from_numpy(np.asarray(vi.z_star, np.float32)).to(z.device)
    return torch.linalg.vector_norm(z.float() - z_star)


def restricted_gap(vi: AffineVI, z_hat: torch.Tensor, radius: float = 2.0,
                   iters: int = 300) -> float:
    """Gap_C(z_hat) = sup_{z in C} <A(z), z_hat - z>, C = ball(z*, radius).

    For affine monotone A the inner objective is concave in z (its Hessian
    is -(M + M^T)/2 <= 0), so projected gradient ascent from the ball's
    center converges; a fixed budget of ``iters`` steps, the gradient in
    closed form, M^T (z_hat - z) - (M z + q), on ``z_hat``'s device."""
    M, q, c0 = vi.tensors(z_hat.device)
    z_hat = z_hat.float()
    lr = 0.5 / (float(np.linalg.norm(vi.M, 2)) + 1e-9)
    z = c0
    for _ in range(iters):
        z = z + lr * (M.T @ (z_hat - z) - (M @ z + q))
        delta = z - c0
        nrm = torch.linalg.vector_norm(delta)
        z = torch.where(nrm > radius, c0 + delta * (radius / nrm), z)
    return float(torch.dot(M @ z + q, z_hat - z))
