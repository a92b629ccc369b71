"""Model construction (port of ``repro/models/model.py::build`` for the
dense, MoE and VLM decoders)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Decoder


def build(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Decoder:
    """A randomly initialized model (weights from a ``torch.Generator``
    seeded with ``seed``) on ``device`` (cuda unless the caller asks for
    the CPU; raises if cuda is asked for and absent)."""
    return Decoder(cfg, seed=seed, device=resolve_device(device))
