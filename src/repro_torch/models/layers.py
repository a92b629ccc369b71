"""Building blocks of the dense decoder (port of the dense parts of
``repro/models/layers.py``): RMS/layer norm, rotary embeddings, the
SwiGLU/GeGLU/GELU MLP and causal GQA attention in plain torch ops.

Each block takes its parameters as a dict of tensors (the reference's
layout: q/k/v weights ``[D, H, hd]``, output ``[H, hd, D]``), computes
norms, rope and softmax in f32 and returns the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def norm_apply(p, x: torch.Tensor, norm_type: str) -> torch.Tensor:
    xf = x.float()
    if norm_type == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + 1e-6) * p["scale"]
        if "bias" in p:
            out = out + p["bias"]
    return out.to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions [..., S] -> cos/sin [..., S, dim/2] (f32)."""
    half = dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; cos/sin [..., S, hd/2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    h = x @ p["wi"]
    if mlp_type == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif mlp_type == "geglu":
        h = F.gelu(x @ p["wg"]) * h
    else:
        h = F.gelu(h)
    return h @ p["wo"]


def _repeat_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """[B, S, KV, hd] -> [B, S, H, hd], each kv head repeated H/KV times."""
    KV = k.shape[-2]
    if KV == H:
        return k
    return torch.repeat_interleave(k, H // KV, dim=-2)


def _sdpa(q, k, v, mask, scale):
    """q [B,Sq,H,hd], k/v [B,Sk,H,hd], mask broadcastable [B,1,Sq,Sk]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, torch.full((), -1e30, device=logits.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def _causal_mask(Sq: int, Sk: int, device, offset: int = 0):
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    return kj <= qi + offset


def full_attention(q, k, v, causal: bool):
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if causal:
        mask = _causal_mask(Sq, Sk, q.device, offset=Sk - Sq)
    else:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    return _sdpa(q, k, v, mask[None, None], hd**-0.5)


def attention_apply(p, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Causal full-sequence self-attention (train/prefill). x: [B, S, D]."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = full_attention(q, _repeat_kv(k, H), _repeat_kv(v, H), causal=True)
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
