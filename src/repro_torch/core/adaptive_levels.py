r"""QAda — adaptive quantization levels (Section 3.3; port of
``repro/core/adaptive_levels.py``).

Levels are chosen to minimize the expected quantization variance

    min_{l in L}  sum_i  \int_{l_i}^{l_{i+1}} sigma_Q^2(u; l) dF~(u),
    sigma_Q^2(u; l) = (l_{tau(u)+1} - u)(u - l_{tau(u)}),

where F~ is the weighted empirical CDF of the normalized coordinates
(weights lambda_j proportional to ||g_j||_q^2).  The distribution is
summarized by a fixed-size weighted histogram (the sufficient statistics
of Algorithm 1 line 4), then the interior levels are optimized by
coordinate descent: the stationarity condition of level l_j between fixed
neighbours,

    sum_{u in (l_{j-1}, l_j)} w (u - l_{j-1})  =  sum_{u in (l_j, l_{j+1})} w (l_{j+1} - u),

has an LHS - RHS that increases with l_j, so each update is a bisection
on the cumulative histogram.

Where each part runs:

* :func:`normalized_coord_histogram` runs on the tensors' device.  Its sum
  has a fixed order and no float atomics, so two runs give the same bits:
  per chunk of rows, integer counts per (row, bin) from ``bincount``, then
  each bin's weighted sum ``sum_rows norm_r^2 * count_{r,b}`` as one
  f64 matrix-vector product, rounded to f32 at the end.
* :func:`optimize_levels` runs on the host in f32 (numpy scalars), on the
  histogram copied once: ``sweeps * s * bisect_iters`` evaluations of a
  dozen scalar operations, which would be thousands of launches on a card.
  Its arithmetic is the reference's, operation by operation; XLA may
  contract a multiply-add of ``_interp`` and sums ``cumsum`` in its own
  order, so levels agree with the reference to the bisection's resolution,
  not bit for bit.
* :func:`gradient_descent_levels` takes its gradient from ``torch.autograd``.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_BINS = 2048
# coordinates of one chunk's (row, bin) count matrix in the histogram pass
HIST_CHUNK_CELLS = 1 << 25
_F32 = np.float32
_EPS = _F32(1e-6)  # the solve's margin between neighbouring levels


def normalized_coord_histogram(v2d: torch.Tensor, norms: torch.Tensor,
                               bins: int = DEFAULT_BINS) -> torch.Tensor:
    """Weighted histogram of u = |v| / norm with weights norm^2 (QAda's
    lambda), over [0, 1] in ``bins`` equal bins.

    ``v2d``: [nb, bucket], ``norms``: [nb].  Returns [bins] f32 on their
    device.  Bin b = clip(int(u * bins), 0, bins - 1), u clipped to [0, 1]
    after dividing by the norm (1 where the norm is 0), as in the
    reference; the weighted sums are exact integer counts times f32 norm^2
    added up in f64."""
    rows, bucket = v2d.shape
    dev = v2d.device
    hist = torch.zeros((bins,), dtype=torch.float64, device=dev)
    chunk = max(1, HIST_CHUNK_CELLS // bins)
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        nrm = norms[r0:r1].float()
        safe = torch.where(nrm > 0, nrm, 1.0)
        u = v2d[r0:r1].float().abs().div_(safe[:, None]).clamp_(0.0, 1.0)
        idx = u.mul_(bins).to(torch.int32).clamp_(0, bins - 1)
        del u
        idx += torch.arange(r1 - r0, device=dev, dtype=torch.int32)[:, None] * bins
        counts = torch.bincount(idx.reshape(-1), minlength=(r1 - r0) * bins)
        del idx
        w = (nrm * nrm).double()
        hist += w @ counts.view(r1 - r0, bins).double()
        del counts
    return hist.float()


def merge_histograms(*hists: torch.Tensor) -> torch.Tensor:
    """Sufficient statistics merge across oracle samples / workers."""
    return sum(hists)


def _centers(bins: int) -> np.ndarray:
    return (np.arange(bins, dtype=_F32) + _F32(0.5)) / _F32(bins)


def _cumsum(x: np.ndarray, block: int = 16) -> np.ndarray:
    """Inclusive f32 prefix sum in XLA's order on the CPU: sequential
    within blocks of 16, plus the exclusive prefix of the block totals
    (taken the same way, recursively)."""
    n = x.shape[0]
    if n <= block:
        return np.cumsum(x, dtype=_F32)
    nb = -(-n // block)
    inner = np.cumsum(np.concatenate([x, np.zeros(nb * block - n, _F32)]).reshape(nb, block),
                      axis=1, dtype=_F32)
    excl = np.concatenate([np.zeros((1,), _F32), _cumsum(inner[:, -1].copy(), block)[:-1]])
    return (inner + excl[:, None]).reshape(-1)[:n]


def _cumulatives(hist: np.ndarray):
    """W(x), S(x) at the bin edges x = k / bins (f32)."""
    bins = hist.shape[0]
    zero = np.zeros((1,), _F32)
    W = np.concatenate([zero, _cumsum(hist)])
    S = np.concatenate([zero, _cumsum(hist * _centers(bins))])
    return W, S, bins


def _fma(a, b, c):
    """f32 a * b + c rounded once (the product is exact in f64)."""
    return _F32(np.float64(a) * np.float64(b) + np.float64(c))


def _interp(c: np.ndarray, x, bins: int):
    """Linear interpolation of a cumulative array ``c`` at x in [0, 1]
    (f32 scalars), ``c[i] * (1 - frac) + c[i + 1] * frac`` with the second
    product and the sum fused as XLA's CPU code fuses them."""
    pos = min(max(x * _F32(bins), _F32(0.0)), _F32(bins))
    i = min(max(int(pos), 0), bins - 1)
    frac = pos - _F32(i)
    return _fma(c[i + 1], frac, c[i] * (_F32(1.0) - frac))


def _searchsorted_tau(levels: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """clip(searchsorted(levels, centers, 'right') - 1, 0, s)."""
    tau = torch.searchsorted(levels.contiguous(), centers, right=True) - 1
    return tau.clamp(0, levels.shape[0] - 2)


def expected_variance(levels: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """sum_bins w_b (l_{tau+1} - u_b)(u_b - l_tau) — the QAda objective
    (f32 scalar on the histogram's device; differentiable in ``levels``)."""
    bins = hist.shape[0]
    centers = torch.from_numpy(_centers(bins)).to(hist.device)
    levels = levels.to(hist.device)
    tau = _searchsorted_tau(levels.detach(), centers)
    lo, hi = levels[tau], levels[tau + 1]
    return torch.sum(hist * (hi - centers) * (centers - lo))


def optimize_levels(levels: torch.Tensor, hist: torch.Tensor, sweeps: int = 8,
                    bisect_iters: int = 30) -> torch.Tensor:
    """Coordinate-descent QAda update of the interior levels.

    ``levels``: [s+2] with fixed endpoints 0 and 1.  Runs on the host in
    f32 (one copy of the histogram and the table); returns the updated
    table on ``levels``' device."""
    lv = levels.detach().cpu().numpy().astype(_F32)
    W, S, bins = _cumulatives(hist.detach().cpu().numpy().astype(_F32))

    def g(l, lo, hi):
        # LHS - RHS of the stationarity condition at candidate level l
        Wl, Wlo, Whi = _interp(W, l, bins), _interp(W, lo, bins), _interp(W, hi, bins)
        Sl, Slo, Shi = _interp(S, l, bins), _interp(S, lo, bins), _interp(S, hi, bins)
        lhs = (Sl - Slo) - lo * (Wl - Wlo)
        rhs = hi * (Whi - Wl) - (Shi - Sl)
        return lhs - rhs

    half = _F32(0.5)
    for _ in range(sweeps):
        for j in range(1, lv.shape[0] - 1):
            lo, hi = lv[j - 1], lv[j + 1]
            a, b = lo, hi
            for _ in range(bisect_iters):
                mid = half * (a + b)
                if g(mid, lo, hi) < 0:
                    a = mid
                else:
                    b = mid
            # keep strict monotonicity with a tiny margin (jnp.clip's order)
            lv[j] = min(max(half * (a + b), lo + _EPS), hi - _EPS)
    return torch.from_numpy(lv).to(levels.device)


def gradient_descent_levels(levels: torch.Tensor, hist: torch.Tensor, steps: int = 200,
                            lr: float = 0.05) -> torch.Tensor:
    """Alternative QAda solver: projected gradient descent on the variance
    objective, the gradient from ``torch.autograd``."""
    hist = hist.float()
    hist = hist / torch.clamp(torch.sum(hist), min=1e-30)  # scale-free objective
    dev = hist.device
    zero = torch.zeros((1,), dtype=torch.float32, device=dev)
    one = torch.ones((1,), dtype=torch.float32, device=dev)
    x = levels[1:-1].detach().float().to(dev)
    for _ in range(steps):
        x.requires_grad_(True)
        loss = expected_variance(torch.cat([zero, x, one]), hist)
        (grad,) = torch.autograd.grad(loss, x)
        with torch.no_grad():
            x = torch.sort(torch.clamp(x - lr * grad, 1e-6, 1 - 1e-6)).values
    return torch.cat([zero, x.detach(), one]).to(levels.device)


def symbol_probabilities(levels: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """Proposition 2 — occurrence probability of each level symbol,

        p_j = int_{l_{j-1}}^{l_j} (u - l_{j-1})/(l_j - l_{j-1}) dF~
            + int_{l_j}^{l_{j+1}} (l_{j+1} - u)/(l_{j+1} - l_j) dF~,

    against the normalized weighted histogram ([s+2] f32)."""
    bins = hist.shape[0]
    hist = hist.float()
    f = hist / torch.clamp(torch.sum(hist), min=1e-30)
    centers = torch.from_numpy(_centers(bins)).to(hist.device)
    levels = levels.float().to(hist.device)
    tau = _searchsorted_tau(levels, centers)
    lo, hi = levels[tau], levels[tau + 1]
    xi = (centers - lo) / (hi - lo)  # probability of rounding up to tau + 1
    p = torch.zeros((levels.shape[0],), dtype=torch.float32, device=hist.device)
    p.index_add_(0, tau, f * (1 - xi))
    p.index_add_(0, tau + 1, f * xi)
    return p
