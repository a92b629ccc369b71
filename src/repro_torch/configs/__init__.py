"""Model / shape configuration (own copy of the dense, MoE and VLM subset of
``repro.configs``)."""

from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, get_config  # noqa: F401
