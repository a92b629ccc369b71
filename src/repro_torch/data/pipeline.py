"""Deterministic synthetic token pipeline (numpy; port of
``repro/data/pipeline.py``).

Batch ``t`` is a pure function of (seed, t): a noisy order-2
autoregressive token stream, so a model can reduce its loss.  Batches are
numpy ``int32`` arrays; :func:`add_modality_stubs` attaches a VLM's
stubbed image embeddings (f32), and :func:`to_device` moves a batch to
torch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0


def _batch_tokens(pc: PipelineConfig, step: int) -> np.ndarray:
    """Markov-ish synthetic stream: t_i = f(t_{i-1}, t_{i-2}) + noise."""
    rng = np.random.RandomState((pc.seed * 1_000_003 + step) % (2**31 - 1))
    B, S, V = pc.batch, pc.seq_len, pc.vocab_size
    toks = np.empty((B, S), np.int32)
    toks[:, 0] = rng.randint(0, V, size=B)
    toks[:, 1] = rng.randint(0, V, size=B)
    noise = rng.randint(0, V, size=(B, S))
    noisy = rng.rand(B, S) < 0.15
    for i in range(2, S):
        det = (toks[:, i - 1] * 31 + toks[:, i - 2] * 17 + 7) % V
        toks[:, i] = np.where(noisy[:, i], noise[:, i], det)
    return toks


@dataclasses.dataclass
class SyntheticPipeline:
    cfg: PipelineConfig
    step: int = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        toks = _batch_tokens(self.cfg, self.step)
        self.step += 1
        inputs = toks[:, :-1] if toks.shape[1] > 1 else toks
        labels = toks[:, 1:] if toks.shape[1] > 1 else toks
        return {"tokens": inputs, "labels": labels}

    def restore(self, state: dict) -> None:
        """Continue from ``state`` (``{"step", "seed"}``, as the launcher
        writes it after a checkpoint restore); the seed must match."""
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"pipeline seed mismatch: checkpoint {state['seed']}, "
                             f"pipeline {self.cfg.seed}")
        self.step = int(state["step"])


def make_pipeline(vocab_size: int, batch: int, seq_len: int, seed: int = 0) -> SyntheticPipeline:
    """Batches of ``batch`` rows of ``seq_len`` inputs (+1 token so inputs
    and labels shift within one stream)."""
    return SyntheticPipeline(PipelineConfig(vocab_size=vocab_size, batch=batch,
                                            seq_len=seq_len + 1, seed=seed))


def add_modality_stubs(batch: dict, model_cfg: ModelConfig, seed: int = 0) -> dict:
    """Attach a VLM's stubbed vision frontend: ``embeds`` [B,
    num_prefix_embeds, D] f32 from ``np.random.RandomState(seed)`` (the
    reference's draw, bit for bit); other configs' batches are returned
    as they are."""
    if model_cfg.arch_type != "vlm":
        return batch
    B = batch["tokens"].shape[0]
    rng = np.random.RandomState(seed)
    embeds = rng.randn(B, model_cfg.num_prefix_embeds, model_cfg.d_model).astype(np.float32)
    return {**batch, "embeds": embeds}


def to_device(batch: dict, device, rows: slice = slice(None)) -> dict:
    """numpy batch -> torch tensors on ``device``, tokens and labels int64
    and ``embeds`` f32 (optionally this worker's row shard of each)."""
    return {k: torch.as_tensor(np.ascontiguousarray(v[rows]),
                               dtype=torch.float32 if k == "embeds" else torch.int64,
                               device=device) for k, v in batch.items()}
