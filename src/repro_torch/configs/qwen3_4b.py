"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    arch_type="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,            # qwen3 uses explicit head_dim 128
    qk_norm=True,
    rope_theta=1e6,
    d_ff=9728,
    mlp_type="swiglu",
    vocab_size=151936,
    tie_embeddings=True,
    citation="hf:Qwen/Qwen3-8B",
)
