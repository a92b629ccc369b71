"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000 — GeGLU, head_dim=256. [arXiv:2403.08295]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    mlp_type="geglu",
    vocab_size=256000,
    tie_embeddings=True,
    citation="arXiv:2403.08295",
)
