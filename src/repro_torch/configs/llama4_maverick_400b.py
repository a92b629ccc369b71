"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, early fusion, iRoPE 3:1
chunk-local:global. [hf:meta-llama/Llama-4-Scout-17B-16E]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    sliding_window=8192,     # chunk-local attention size (iRoPE)
    chunked_window=True,
    global_every=4,          # every 4th layer global (3:1)
    d_ff=8192,               # dense layers interleave with MoE (moe_every=2)
    num_experts=128,
    num_experts_per_tok=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    moe_every=2,             # maverick: every other layer is MoE
    mlp_type="swiglu",
    vocab_size=202048,
    num_prefix_embeds=0,     # early-fusion embeds supported via 'embeds' input
    tie_embeddings=False,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
