"""Bounded retry with deterministic jittered exponential backoff (the
port's copy of ``repro/core/retry.py``; stdlib only).

:class:`BackoffPolicy` decides "how many times, how long apart" for a
retry loop; its jitter is a crc32 hash of ``(token, attempt)`` scaled
into ``[1 - jitter, 1]`` instead of a random draw, so two callers retrying
the same resource de-synchronize while a replayed run backs off
identically.  Delay units are the caller's clock (seconds, decode steps);
the policy only does arithmetic.  :func:`attempts` bounds a walk over
candidates: the checkpoint fallback walk
(:func:`repro_torch.checkpoint.checkpointing.restore_with_fallback`) uses
it so a directory of garbage fails fast instead of scanning forever.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterable, Iterator, Tuple, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff: attempt ``a`` waits ``base * factor**a``
    (capped at ``cap``), scaled by a deterministic jitter factor in
    ``[1 - jitter, 1]`` derived from ``(token, attempt)``."""

    base: float = 1.0
    factor: float = 2.0
    cap: float = 60.0
    max_attempts: int = 3
    jitter: float = 0.5

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base < 0 or self.factor < 1.0 or self.cap < 0:
            raise ValueError(
                f"need base >= 0, factor >= 1, cap >= 0; got "
                f"base={self.base} factor={self.factor} cap={self.cap}"
            )
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delay(self, attempt: int, token=0) -> float:
        """Delay before retry number ``attempt`` (0-based) for the caller
        identified by ``token`` (any str()-able value, e.g. a request id)."""
        if attempt < 0:
            raise ValueError(f"attempt must be >= 0, got {attempt}")
        raw = min(self.cap, self.base * self.factor ** attempt)
        if not self.jitter:
            return raw
        h = zlib.crc32(f"{token}:{attempt}".encode()) / 0xFFFFFFFF
        return raw * (1.0 - self.jitter * h)

    def exhausted(self, attempt: int) -> bool:
        """True once ``attempt`` retries have been spent."""
        return attempt >= self.max_attempts


def attempts(candidates: Iterable[T], max_attempts: int) -> Iterator[Tuple[int, T]]:
    """Yield ``(attempt_index, candidate)`` for at most ``max_attempts``
    candidates."""
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    for i, cand in enumerate(candidates):
        if i >= max_attempts:
            return
        yield i, cand
