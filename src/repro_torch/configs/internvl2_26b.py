"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT STUB + InternLM2 backbone. [arXiv:2404.16821]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    mlp_type="swiglu",
    vocab_size=92553,
    num_prefix_embeds=256,   # ViT stub: 256 projected patch embeddings
    tie_embeddings=False,
    citation="arXiv:2404.16821",
)
