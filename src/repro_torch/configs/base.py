"""Model / shape configuration schema — the dense-decoder subset of
``repro/configs/base.py``.

Only the fields a dense decoder reads are kept: RMSNorm, RoPE, GQA / MQA
attention with an optional per-head qk-norm, a sliding window on all but
every ``global_every``-th layer (gemma3's 5:1 local:global pattern), and
the SwiGLU / GeGLU / GELU MLP.  The reference's chunk-local window, MoE,
MLA, SSM and encoder-decoder fields are not ported: passing one raises
``TypeError``.  ``reduced()`` cuts a config to its CPU smoke size with the
same rule as the reference (2 layers, d_model <= 256, <= 4 heads, vocab
<= 512, window <= 64, f32).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # only "dense" is ported
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
    d_ff: int = 0
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    citation: str = ""

    def __post_init__(self):
        if self.arch_type != "dense":
            raise NotImplementedError(
                f"arch_type {self.arch_type!r} is not ported yet (dense only)"
            )

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def param_count(self) -> int:
        """Parameter count N of the dense decoder."""
        D, L, hd = self.d_model, self.num_layers, self.resolved_head_dim
        n = self.vocab_size * D
        if not self.tie_embeddings:
            n += self.vocab_size * D
        per_layer = D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd
        per_layer += self.num_heads * hd * D
        gate_mult = 2 if self.mlp_type in ("swiglu", "geglu") else 1
        per_layer += (gate_mult + 1) * D * self.d_ff
        return n + L * per_layer

    def reduced(self) -> "ModelConfig":
        """Same family, tiny: 2 layers, d_model <= 256 (reference rule)."""
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
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
        )
