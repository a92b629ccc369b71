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
testbed takes its latent samples from.
"""

from __future__ import annotations

import numpy as np
import torch


class GeneratorNoise:
    """Uniform [0, 1) f32 noise from an explicit ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

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


class ReplayNoise:
    """Replays given noise arrays, in order; raises on a shape mismatch or
    when more draws are asked for than were given."""

    def __init__(self, arrays):
        self._arrays = list(arrays)
        self._next = 0

    def uniform(self, shape, device) -> torch.Tensor:
        if self._next >= len(self._arrays):
            raise RuntimeError(f"ReplayNoise exhausted after {self._next} draws")
        a = self._arrays[self._next]
        self._next += 1
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a, dtype=np.float32))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed noise has shape {tuple(t.shape)}, the draw "
                             f"asks for {tuple(shape)}")
        return t.to(device=device, dtype=torch.float32)

    normal = uniform  # a replayed array is whatever the caller drew

    @property
    def remaining(self) -> int:
        return len(self._arrays) - self._next
