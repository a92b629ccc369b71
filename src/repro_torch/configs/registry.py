"""--arch id -> ModelConfig registry (the architectures ported so far)."""

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma-2b": "gemma_2b",
    "qwen3-4b": "qwen3_4b",
    "gemma3-27b": "gemma3_27b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "internvl2-26b": "internvl2_26b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"available: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG
