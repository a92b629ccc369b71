"""Bounded enumeration of candidates (the port's copy of ``attempts`` from
``repro/core/retry.py``; stdlib only).  The checkpoint fallback walk
(:func:`repro_torch.checkpoint.checkpointing.restore_with_fallback`) uses
it so a directory of garbage fails fast instead of scanning forever."""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple, TypeVar

T = TypeVar("T")


def attempts(candidates: Iterable[T], max_attempts: int) -> Iterator[Tuple[int, T]]:
    """Yield ``(attempt_index, candidate)`` for at most ``max_attempts``
    candidates."""
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    for i, cand in enumerate(candidates):
        if i >= max_attempts:
            return
        yield i, cand
