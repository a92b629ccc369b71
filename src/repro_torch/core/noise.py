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
+-1 in f32), which the toy-VI oracles take their noise from, and 64-bit
seeds (``seed``), which
the device-PRNG exchange (``ExchangeConfig(use_device_prng=True)``) hands
to the kernels in place of a noise buffer: the kernel draws its own
rounding noise with Philox from that seed.
"""

from __future__ import annotations

import numpy as np
import torch


# the seed stream's generator is seeded with the run seed xor this, so its
# numbers are not the first numbers of a CPU noise generator's own stream
_SEED_STREAM = 0x5EED5EED5EED5EED


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

    @property
    def remaining(self) -> int:
        return len(self._arrays) - self._next
