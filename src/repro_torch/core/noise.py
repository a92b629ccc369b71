"""Sources of the uniform rounding noise the quantizer consumes.

The reference draws its stochastic-rounding noise with ``jax.random`` on
the host-noise path (DESIGN.md §3, the bit-exactness anchor).  The two
frameworks' generators give different numbers from one seed, so every
function of the port that rounds stochastically takes a noise source:

* :class:`GeneratorNoise` — native runs: draws from one explicit
  ``torch.Generator`` per worker (on the worker's device).
* :class:`ReplayNoise` — parity runs: hands out given arrays (e.g. the
  reference's ``jax.random.uniform`` draws) in the order they are asked
  for, checking each shape.

Both also give standard normal draws (``normal``), which the WGAN-GP
testbed takes its latent samples from, Rademacher signs (``rademacher``:
+-1 in f32), which the toy-VI oracles take their noise from, 64-bit
seeds (``seed``), which
the device-PRNG exchange (``ExchangeConfig(use_device_prng=True)``) hands
to the kernels in place of a noise buffer: the kernel draws its own
rounding noise with Philox from that seed, and the support of the sparse
compressors (``subset``): k distinct indices of ``range(n)``, int32,
drawn uniformly without replacement (the reference's
``jax.random.permutation(key, n)[:k]``).

The native support draw at full width.  The tinyllama-1.1b buffer has
n ~ 1.1e9 coordinates and randk keeps k ~ 2.75e8 of them.  One
``torch.randperm(n)`` on the card sorts n random 64-bit keys with n
values (PyTorch widens its keys to 64 bits at any n past ~100, so that
ties are rare): with the key, value and sort buffers about 36 bytes a
coordinate, ~40 GB beside a step that already peaks near 50 GB.
:meth:`GeneratorNoise.subset` therefore splits ``range(n)`` into blocks
of at most :data:`SUBSET_BLOCK` coordinates and draws how many of the k
fall in each block from the multivariate hypergeometric law (by halving:
one ``numpy`` hypergeometric draw per split, on the host, from the
source's seed stream), then takes each block's share from a
``randperm`` of the block on the worker's device (a block that gives
all its coordinates takes them in order, with no draw).  The result is
exactly a uniform k-subset; the transient is one block's sort (~1.2 GB)
and the output k x 4 bytes; the indices come out block by block, each
block's in random order.
"""

from __future__ import annotations

import numpy as np
import torch


# the seed stream's generator is seeded with the run seed xor this, so its
# numbers are not the first numbers of a CPU noise generator's own stream
_SEED_STREAM = 0x5EED5EED5EED5EED
# the most coordinates one randperm of GeneratorNoise.subset sorts
SUBSET_BLOCK = 1 << 25


def _split_counts(rng: np.random.Generator, start: int, size: int, count: int,
                  out: list) -> None:
    """Append ``(start, size, count)`` blocks of at most SUBSET_BLOCK
    coordinates: ``count`` draws without replacement from ``[start, start +
    size)`` split between the halves by the hypergeometric law, recursively
    (numpy's draw takes halves below 1e9, so n < 2^31 works)."""
    if count == 0:
        return
    if size <= SUBSET_BLOCK or count == size:  # a full block needs no draw
        out.append((start, size, count))
        return
    left = size // 2
    c_left = int(rng.hypergeometric(left, size - left, count))
    _split_counts(rng, start, left, c_left, out)
    _split_counts(rng, start + left, size - left, count - c_left, out)


def draw_rounding(noise, shape, device, use_device_prng: bool):
    """One stochastic-rounding draw from a noise source: ``(buffer, None)``,
    the uniform [0, 1) array of ``shape``, or with ``use_device_prng``
    ``(None, seed)``, the seed of the kernel's own draw."""
    if use_device_prng:
        return None, noise.seed()
    return noise.uniform(shape, device), None


class GeneratorNoise:
    """Uniform [0, 1) f32 noise from an explicit ``torch.Generator``; seeds
    from a CPU generator of its own, seeded from the same run seed, so
    asking for a seed never waits for the card."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._seeds = torch.Generator()
        self._seeds.manual_seed(generator.initial_seed() ^ _SEED_STREAM)

    @classmethod
    def seeded(cls, seed: int, device) -> "GeneratorNoise":
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return cls(g)

    def uniform(self, shape, device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator, device=device,
                          dtype=torch.float32)

    def normal(self, shape, device) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=device,
                           dtype=torch.float32)

    def rademacher(self, shape, device) -> torch.Tensor:
        bits = torch.randint(0, 2, tuple(shape), generator=self.generator, device=device)
        return (2 * bits - 1).to(torch.float32)

    def seed(self) -> int:
        """A 64-bit seed for the device PRNG (two 32-bit words)."""
        lo, hi = torch.randint(0, 1 << 32, (2,), generator=self._seeds,
                               dtype=torch.int64).tolist()
        return lo | (hi << 32)

    def subset(self, n: int, k: int, device) -> torch.Tensor:
        """k distinct indices of ``range(n)``, uniform, int32 on ``device``
        (the module docstring says how)."""
        _check_subset(n, k)
        blocks: list = []
        if n <= SUBSET_BLOCK:
            blocks.append((0, n, k))
        else:
            _split_counts(np.random.default_rng(self.seed()), 0, n, k, blocks)
        out = torch.empty((k,), dtype=torch.int32, device=device)
        pos = 0
        for start, size, count in blocks:
            if count == size:
                torch.arange(start, start + size, dtype=torch.int32, device=device,
                             out=out[pos: pos + count])
            else:
                perm = torch.randperm(size, generator=self.generator, device=device,
                                      dtype=torch.int32)
                out[pos: pos + count] = perm[:count].add_(start)
            pos += count
        return out


def _check_subset(n: int, k: int) -> None:
    if not 0 < k <= n < 2**31:
        raise ValueError(f"a subset draw needs 0 < k <= n < 2^31, got k={k}, n={n}")


def _is_seed(a) -> bool:
    return isinstance(a, (int, np.integer)) and not isinstance(a, bool)


class ReplayNoise:
    """Replays given draws, in order: noise arrays for ``uniform`` /
    ``normal`` and integers for ``seed``; raises on a shape mismatch, on
    an array where a seed is asked for (or the reverse), or when more draws
    are asked for than were given."""

    def __init__(self, arrays):
        self._arrays = list(arrays)
        self._next = 0

    def _take(self, what: str):
        if self._next >= len(self._arrays):
            raise RuntimeError(f"ReplayNoise exhausted after {self._next} draws")
        a = self._arrays[self._next]
        if _is_seed(a) != (what == "seed"):
            raise TypeError(f"draw {self._next} asks for {what}, the replayed item is "
                            f"{'a seed' if _is_seed(a) else 'an array'}")
        self._next += 1
        return a

    def seed(self) -> int:
        return int(self._take("seed"))

    def uniform(self, shape, device) -> torch.Tensor:
        a = self._take("an array")
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a, dtype=np.float32))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed noise has shape {tuple(t.shape)}, the draw "
                             f"asks for {tuple(shape)}")
        return t.to(device=device, dtype=torch.float32)

    normal = rademacher = uniform  # a replayed array is whatever the caller drew

    def subset(self, n: int, k: int, device) -> torch.Tensor:
        """The next replayed index array: shape ``(k,)``, integers in
        ``[0, n)``; returned as int32 on ``device``."""
        _check_subset(n, k)
        a = self._take("an array")
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        if tuple(t.shape) != (k,):
            raise ValueError(f"replayed support has shape {tuple(t.shape)}, the draw "
                             f"asks for ({k},)")
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise TypeError(f"replayed support has dtype {t.dtype}, not an integer type")
        if int(t.min()) < 0 or int(t.max()) >= n:
            raise ValueError(f"replayed support leaves range({n})")
        return t.to(device=device, dtype=torch.int32)

    @property
    def remaining(self) -> int:
        return len(self._arrays) - self._next
