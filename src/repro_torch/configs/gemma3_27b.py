"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global, 128k context. [hf:google/gemma-3-1b-pt]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    qk_norm=True,            # gemma3 uses qk-norm
    sliding_window=1024,
    global_every=6,          # 5 local : 1 global
    rope_theta=1e6,
    d_ff=21504,
    mlp_type="geglu",
    vocab_size=262144,
    tie_embeddings=True,
    citation="hf:google/gemma-3-1b-pt",
)
