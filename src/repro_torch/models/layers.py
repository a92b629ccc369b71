"""Building blocks of the decoder (port of the dense parts of
``repro/models/layers.py``): RMS/layer norm, the per-head qk-norm, rotary
embeddings, the SwiGLU/GeGLU/GELU MLP and causal GQA / MQA attention,
full, banded to a sliding window or chunk-local (llama4), in plain torch
ops.

Each block takes its parameters as a dict of tensors (the reference's
layout: q/k/v weights ``[D, H, hd]``, output ``[H, hd, D]``, qk-norm
scales ``[hd]``), computes norms, rope and softmax in f32 and returns the
activation dtype.  qk-norm, where the config has it, is applied to q and
k before rope on every path.  A layer's :class:`AttnMode` says whether it
attends to the whole causal history, to its last ``window`` positions or,
in train and prefill, to the earlier positions of its own ``chunk``.
"""

from __future__ import annotations

import dataclasses

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


def head_rms_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-head rms norm over head_dim (qwen3-style qk-norm)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


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
        h = F.gelu(x @ p["wg"], approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
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


def banded_attention(q, k, v, window: int):
    """Sliding-window causal attention, chunk by chunk: queries of chunk c
    (``window`` positions each; the sequence padded to a multiple) attend
    the keys of chunks c - 1 and c, masked to exactly ``window`` history;
    the first chunk has no previous keys.  q/k/v [B, S, H, hd]."""
    B, S, H, hd = q.shape
    W = window
    pad = (-S) % W
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    Sp = S + pad
    nc = Sp // W
    qc, kc, vc = (t.reshape(B, nc, W, H, hd) for t in (q, k, v))
    k2 = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1), kc], dim=2)
    v2 = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1), vc], dim=2)
    qi = torch.arange(W, device=q.device)[:, None] + W  # index within the 2W keys
    kj = torch.arange(2 * W, device=q.device)[None, :]
    mask = (kj <= qi) & (kj > qi - W)
    first = (torch.arange(nc, device=q.device) == 0)[:, None, None]
    masks = torch.where(first, (mask & (kj >= W))[None], mask[None])  # [nc, W, 2W]
    logits = torch.einsum("bcqhd,bckhd->bchqk", qc.float(), k2.float()) * (hd**-0.5)
    logits = torch.where(masks[None, :, None], logits,
                         torch.full((), -1e30, device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bchqk,bckhd->bcqhd", w.to(v2.dtype), v2)
    return out.reshape(B, Sp, H, hd)[:, :S]


def chunk_local_attention(q, k, v, chunk: int):
    """llama4-style chunk-local causal attention: the sequence cut into
    chunks of ``min(chunk, S)`` (the tail padded), each query attending
    causally inside its own chunk, with no look back.  q/k/v [B, S, H, hd]."""
    B, S, H, hd = q.shape
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    Sp = S + pad
    nc = Sp // C
    qc, kc, vc = (t.reshape(B, nc, C, H, hd) for t in (q, k, v))
    mask = _causal_mask(C, C, q.device)
    logits = torch.einsum("bcqhd,bckhd->bchqk", qc.float(), kc.float()) * (hd**-0.5)
    logits = torch.where(mask[None, None, None], logits,
                         torch.full((), -1e30, device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bchqk,bckhd->bcqhd", w.to(vc.dtype), vc)
    return out.reshape(B, Sp, H, hd)[:, :S]


@dataclasses.dataclass(frozen=True)
class AttnMode:
    """Static attention behaviour of one layer.  The decode paths treat a
    chunk layer as a sliding window of ``chunk`` keys, as the reference
    does (so prefill and decode differ past position ``chunk``)."""

    causal: bool = True
    window: int = 0  # >0: banded sliding window
    chunk: int = 0  # >0: chunk-local (llama4)

    @property
    def decode_window(self) -> int:
        """The keys a decode step attends to (0: the whole history)."""
        return self.window or self.chunk


def _qk_norm(p, cfg: ModelConfig, q, k):
    if cfg.qk_norm:
        q = head_rms_norm(p["q_norm"], q)
        k = head_rms_norm(p["k_norm"], k)
    return q, k


def attention_apply(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                    mode: AttnMode) -> torch.Tensor:
    """Full-sequence self-attention (train/prefill), causal, banded to
    ``mode.window`` or chunk-local to ``mode.chunk``. x: [B, S, D]."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q, k = _qk_norm(p, cfg, q, k)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    if mode.window:
        out = banded_attention(q, k, v, mode.window)
    elif mode.chunk:
        out = chunk_local_attention(q, k, v, mode.chunk)
    else:
        out = full_attention(q, k, v, mode.causal)
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])


# -- decode path (one new token against a KV cache) -------------------------


def attention_prefill_kv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Project and rope K/V for cache population: k, v [B, S, KV, hd]."""
    hd = cfg.resolved_head_dim
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        k = head_rms_norm(p["k_norm"], k)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rope(k, cos, sin), v


def _project_decode(p, cfg: ModelConfig, x: torch.Tensor, cos, sin):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q, k_new = _qk_norm(p, cfg, q, k_new)
    return apply_rope(q, cos, sin), apply_rope(k_new, cos, sin), v_new


def _grouped_attend(p, cfg: ModelConfig, x, q, k_all, v_all, valid):
    """Grouped-query attention of one new token (no kv-head repeat):
    q [B, 1, H, hd], k/v [B, S, KV, hd], valid [B, S] -> [B, 1, D]."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    B, KV = x.shape[0], k_all.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_all.float()) * (hd**-0.5)
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full((), -1e30, device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v_all.float()).reshape(B, 1, H, hd)
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, pos: int,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     mode: AttnMode) -> torch.Tensor:
    """One-token decode against a dense cache: x [B, 1, D], ``pos`` the
    shared position; writes this token's K/V at ``pos`` of k_cache /
    v_cache [B, S, KV, hd] (in place) and attends over positions <= pos
    (a window or chunk layer over the last ``W`` cache entries only, from
    ``clip(pos - W + 1, 0, S - W)``).  Returns [B, 1, D]."""
    hd, S = cfg.resolved_head_dim, k_cache.shape[1]
    cos, sin = rope_cos_sin(torch.tensor([pos], device=x.device), hd, cfg.rope_theta)
    q, k_new, v_new = _project_decode(p, cfg, x, cos[None], sin[None])
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    start, n = 0, S
    if mode.decode_window:
        n = min(mode.decode_window, S)
        start = min(max(pos - n + 1, 0), S - n)
    key_pos = start + torch.arange(n, device=x.device)
    valid = (key_pos <= pos)[None].expand(x.shape[0], n)
    return _grouped_attend(p, cfg, x, q, k_cache[:, start:start + n],
                           v_cache[:, start:start + n], valid)


def attention_decode_paged(p, cfg: ModelConfig, pc, cache: dict, l: int, x: torch.Tensor,
                           pos: torch.Tensor, page_table: torch.Tensor, noise,
                           mode: AttnMode):
    """One-token decode against the paged quantized cache (port of the
    reference's ``attention_decode_paged``).

    Positions are per slot (``pos`` [B]), the history comes back
    dequantized from the arena through ``page_table`` [B, blocks_per_seq]
    (-1 = unmapped), and the current token rides as an always-valid extra
    key, so the attention never sees its own quantization noise; its K/V
    are written after the read.  Slots whose row is all -1 are inert:
    their writes drop and the extra key keeps their softmax finite.  A
    window or chunk layer masks ``key_pos > pos - W`` rather than slicing.
    Returns [B, 1, D]; ``cache`` is updated in place."""
    from repro_torch.serve import kv_cache as KVC  # lazy: serve imports configs only

    cos, sin = rope_cos_sin(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    q, k_new, v_new = _project_decode(p, cfg, x, cos, sin)
    k_hist, v_hist = KVC.read_kv(cache, pc, l, page_table)  # [B, T, KV, hd] f32
    T = k_hist.shape[1]
    key_pos = torch.arange(T, device=x.device)[None, :]
    mapped = torch.repeat_interleave(page_table >= 0, pc.page_size, dim=1)
    valid = (key_pos < pos[:, None]) & mapped
    if mode.decode_window:
        valid = valid & (key_pos > pos[:, None] - mode.decode_window)
    k_all = torch.cat([k_hist, k_new.float()], dim=1)
    v_all = torch.cat([v_hist, v_new.float()], dim=1)
    valid = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)
    out = _grouped_attend(p, cfg, x, q, k_all, v_all, valid)
    page_w = torch.gather(page_table, 1, (pos // pc.page_size)[:, None].long())[:, 0]
    KVC.write_token(cache, pc, l, k_new[:, 0], v_new[:, 0], page_w, pos % pc.page_size, noise)
    return out
