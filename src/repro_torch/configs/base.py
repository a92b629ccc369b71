"""Model / shape configuration schema — the decoder subset of
``repro/configs/base.py``: the dense, MoE and VLM families.

The fields kept are the ones these decoders read: RMSNorm, RoPE, GQA / MQA
attention with an optional per-head qk-norm, a sliding window on all but
every ``global_every``-th layer (gemma3's 5:1 local:global pattern) or,
with ``chunked_window``, llama4's chunk-local attention of chunks of
``sliding_window``, the SwiGLU / GeGLU / GELU MLP, the mixture-of-experts
layer on every ``moe_every``-th layer (top-k routing with capacity and
shared experts), and ``num_prefix_embeds`` image embeddings fused at a
VLM's prefix.  ``arch_type`` is ``"dense"``, ``"moe"`` or ``"vlm"``; any
other raises ``NotImplementedError``.  The reference's MLA, SSM and
encoder-decoder fields are not ported: passing one raises ``TypeError``.
``reduced()`` cuts a config to its CPU smoke size with the same rule as
the reference (2 layers, d_model <= 256, <= 4 heads, vocab <= 512, window
<= 64, <= 4 experts, top-k <= 2, <= 1 shared expert, moe_d_ff <= 128, <= 8
prefix embeds, f32).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: the architecture families the port has
ARCH_TYPES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | vlm (the ported families)
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full attention
    global_every: int = 0  # every Nth layer is global (rest windowed); 0 = n/a
    chunked_window: bool = False  # llama4-style chunk-local (no lookback)
    d_ff: int = 0
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1  # layer i is MoE iff i % moe_every == moe_every - 1
    num_prefix_embeds: int = 0  # image embeddings fused at the prefix (vlm)
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    citation: str = ""

    def __post_init__(self):
        if self.arch_type not in ARCH_TYPES:
            raise NotImplementedError(
                f"arch_type {self.arch_type!r} is not ported yet (ported: {ARCH_TYPES})"
            )

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path available (long_500k eligibility)."""
        return self.sliding_window > 0 or self.chunked_window

    def param_count(self) -> int:
        """Parameter count N (the reference's formula for these families)."""
        D, L, hd = self.d_model, self.num_layers, self.resolved_head_dim
        n = self.vocab_size * D
        if not self.tie_embeddings:
            n += self.vocab_size * D
        per_layer = D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd
        per_layer += self.num_heads * hd * D
        n += L * per_layer
        gate_mult = 2 if self.mlp_type in ("swiglu", "geglu") else 1
        if self.num_experts:
            n_moe_layers = L // self.moe_every
            moe_per = D * self.num_experts  # router
            moe_per += self.num_experts * (gate_mult + 1) * D * self.moe_d_ff
            moe_per += self.num_shared_experts * (gate_mult + 1) * D * self.moe_d_ff
            n += n_moe_layers * moe_per
            if self.d_ff:  # interleaved dense layers
                n += (L - n_moe_layers) * (gate_mult + 1) * D * self.d_ff
        elif self.d_ff:
            n += L * (gate_mult + 1) * D * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: only the routed top-k and the
        shared experts)."""
        if not self.num_experts:
            return self.param_count()
        gate_mult = 2 if self.mlp_type in ("swiglu", "geglu") else 1
        per_expert = (gate_mult + 1) * self.d_model * self.moe_d_ff
        n_moe_layers = self.num_layers // self.moe_every
        return (self.param_count() - n_moe_layers * self.num_experts * per_expert
                + n_moe_layers * self.num_experts_per_tok * per_expert)

    def reduced(self) -> "ModelConfig":
        """Same family, tiny: 2 layers, d_model <= 256, <= 4 experts
        (reference rule)."""
        hd = min(self.resolved_head_dim, 64)
        nh = max(2, min(self.num_heads, 4)) if self.num_heads else 0
        nkv = 0
        if self.num_kv_heads:
            nkv = 1 if self.num_kv_heads == 1 else 2
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=min(self.d_model, 256),
            vocab_size=min(self.vocab_size, 512),
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=hd if self.num_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=min(self.moe_d_ff, 128),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            num_prefix_embeds=min(self.num_prefix_embeds, 8),
            dtype="float32",
        )
