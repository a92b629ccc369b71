"""The decoder-only transformer of the dense, MoE and VLM families (port
of those paths of ``repro/models/transformer.py``).

Parameters keep the reference's pytree layout so the exchange sees the
same leaves.  Layers follow a repeating *pattern* of period
``lcm(global_every, moe_every)`` (gemma3's 5 local : 1 global; llama4's
chunk-local and MoE layers interleaved, :func:`layer_pattern`), each
offset ``j`` of the period flagged ``(is_moe, is_global)``:
``layers[j]`` stacks every layer at offset ``j`` over the ``n_periods``
periods (``[n, ...]`` leaves, ``[n, E, D, F]`` for experts), and the
``num_layers % period`` remainder layers sit unstacked in
``layers_tail`` (the pattern goes on through them).  Layer ``l`` is
``layers[l % period][l // period]`` below ``n_periods * period`` and
``layers_tail[l - n_periods * period]`` after (:func:`layer_params`).
A MoE layer holds ``moe`` (:mod:`repro_torch.models.moe`) where the
others hold ``mlp``.  ``embed`` and ``unembed`` are f32, beside ``ln_f``.
:meth:`Decoder.param_leaves` lists the leaves in JAX flatten order.

:meth:`Decoder.forward_aux` returns the logits and the MoE layers'
summed auxiliary loss; a VLM's ``embeds`` [B, P, D] replace the first P
positions' token embeddings (unscaled).  Decode: :func:`init_cache` /
:func:`decode_step` over a dense ``[L, B, S, KV, hd]`` cache, and the
paged quantized cache's :func:`prefill_paged` / :func:`decode_step_paged`
(:mod:`repro_torch.serve.kv_cache`), which serve by tokens alone.  They
take the model and write their caches in place.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import path_sort_key
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def layer_pattern(cfg: ModelConfig):
    """(period, flags, n_periods, n_rem); flags[j] = (is_moe, is_global).

    The period is ``lcm(global_every, moe_every)``: with a window (sliding
    or chunked) every ``global_every``-th layer is global and the rest are
    local, without one every layer is global; with experts every
    ``moe_every``-th layer is MoE."""
    has_window = bool(cfg.sliding_window or cfg.chunked_window)
    ge = cfg.global_every if (has_window and cfg.global_every) else 1
    me = cfg.moe_every if cfg.num_experts else 1
    period = math.lcm(ge, me)
    flags = tuple((bool(cfg.num_experts) and j % me == me - 1,
                   not has_window or (cfg.global_every > 0 and j % ge == ge - 1))
                  for j in range(period))
    n_periods = cfg.num_layers // period
    return period, flags, n_periods, cfg.num_layers - n_periods * period


def attn_mode(cfg: ModelConfig, is_global: bool) -> L.AttnMode:
    if is_global or not (cfg.sliding_window or cfg.chunked_window):
        return L.AttnMode(causal=True)
    if cfg.chunked_window:
        return L.AttnMode(causal=True, chunk=cfg.sliding_window)
    return L.AttnMode(causal=True, window=cfg.sliding_window)


def _normal(gen, shape, scale, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            * scale).to(dtype)


class Norm(nn.Module):
    def __init__(self, shape, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(shape, dtype=torch.float32, device=device))


class Attention(nn.Module):
    """q/k/v/o projections with the layer axis ``lead`` (``(n,)`` stacked,
    ``()`` unstacked) in front: wq [D, H, hd], wk/wv [D, KV, hd], wo
    [H, hd, D], and under qk-norm the f32 scales q_norm / k_norm [hd]."""

    def __init__(self, cfg: ModelConfig, lead: tuple, gen, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV = cfg.num_heads, cfg.num_kv_heads
        self.wq = nn.Parameter(_normal(gen, (*lead, d, H, hd), d**-0.5, dtype, device))
        self.wk = nn.Parameter(_normal(gen, (*lead, d, KV, hd), d**-0.5, dtype, device))
        self.wv = nn.Parameter(_normal(gen, (*lead, d, KV, hd), d**-0.5, dtype, device))
        self.wo = nn.Parameter(_normal(gen, (*lead, H, hd, d), (H * hd) ** -0.5, dtype,
                                       device))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones((*lead, hd), dtype=torch.float32,
                                                  device=device))
            self.k_norm = nn.Parameter(torch.ones((*lead, hd), dtype=torch.float32,
                                                  device=device))


class MLP(nn.Module):
    """MLP weights with the layer axis ``lead`` in front: wi/wg [D, F],
    wo [F, D] (F = ``d_ff``, else the config's)."""

    def __init__(self, cfg: ModelConfig, lead: tuple, gen, dtype, device, d_ff: int = 0):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.wi = nn.Parameter(_normal(gen, (*lead, d, f), d**-0.5, dtype, device))
        self.wo = nn.Parameter(_normal(gen, (*lead, f, d), f**-0.5, dtype, device))
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.wg = nn.Parameter(_normal(gen, (*lead, d, f), d**-0.5, dtype, device))


class MoE(nn.Module):
    """Expert weights with the layer axis ``lead`` in front: the f32 router
    [D, E], wi/wg [E, D, F], wo [E, F, D] (F = ``moe_d_ff``), and the
    shared experts as one MLP of width ``moe_d_ff * num_shared_experts``."""

    def __init__(self, cfg: ModelConfig, lead: tuple, gen, dtype, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        self.router = nn.Parameter(_normal(gen, (*lead, d, E), d**-0.5, torch.float32, device))
        self.wi = nn.Parameter(_normal(gen, (*lead, E, d, f), d**-0.5, dtype, device))
        self.wo = nn.Parameter(_normal(gen, (*lead, E, f, d), f**-0.5, dtype, device))
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.wg = nn.Parameter(_normal(gen, (*lead, E, d, f), d**-0.5, dtype, device))
        if cfg.num_shared_experts:
            self.shared = MLP(cfg, lead, gen, dtype, device,
                              d_ff=cfg.moe_d_ff * cfg.num_shared_experts)


def _nested(module: nn.Module, pick) -> dict:
    """A module's parameters as a nested dict of ``pick(tensor)``."""
    out: dict = {}
    for name, p in module.named_parameters():
        node, parts = out, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = pick(p)
    return out


class LayerStack(nn.Module):
    """The layers at one offset of the pattern, stacked over ``n`` periods
    (``n=None``: one unstacked tail layer, the reference's
    ``layers_tail`` leaves); ``is_moe`` puts experts where the MLP goes."""

    def __init__(self, cfg: ModelConfig, n, is_moe: bool, gen, dtype, device):
        super().__init__()
        self.n = n
        lead = () if n is None else (n,)
        self.ln_attn = Norm((*lead, cfg.d_model), device)
        self.attn = Attention(cfg, lead, gen, dtype, device)
        self.ln_mlp = Norm((*lead, cfg.d_model), device)
        if is_moe:
            self.moe = MoE(cfg, lead, gen, dtype, device)
        else:
            self.mlp = MLP(cfg, lead, gen, dtype, device)

    def layer(self, i: int) -> dict:
        """Layer i's parameters as the reference's per-layer dict (a tail
        layer's are its own, whatever ``i``)."""
        def pick(t):
            return t if self.n is None else t[i]

        ffn = "moe" if hasattr(self, "moe") else "mlp"
        return {
            "ln_attn": {"scale": pick(self.ln_attn.scale)},
            "attn": {name: pick(p) for name, p in self.attn.named_parameters()},
            "ln_mlp": {"scale": pick(self.ln_mlp.scale)},
            ffn: _nested(getattr(self, ffn), pick),
        }


def _ffn_residual(p, cfg: ModelConfig, x: torch.Tensor):
    """The MLP (or, on a MoE layer, the experts) with its residual ->
    (x, aux)."""
    h = L.norm_apply(p["ln_mlp"], x, cfg.norm_type)
    if "moe" in p:
        m, aux = MOE.moe_apply(p["moe"], cfg, h)
        return x + m, aux
    return x + L.mlp_apply(p["mlp"], h, cfg.mlp_type), 0.0


def block_apply(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                is_global: bool):
    """Train/prefill block -> (x, aux) (aux 0 on a layer without experts)."""
    h = L.norm_apply(p["ln_attn"], x, cfg.norm_type)
    x = x + L.attention_apply(p["attn"], cfg, h, positions, attn_mode(cfg, is_global))
    return _ffn_residual(p, cfg, x)


class Decoder(nn.Module):
    """tokens [B, S] (and a VLM's prefix ``embeds``) -> logits [B, S, V] (f32)."""

    def __init__(self, cfg: ModelConfig, *, device, seed: int = 0):
        super().__init__()
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        dtype = model_dtype(cfg)
        period, flags, n_periods, n_rem = layer_pattern(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0,
                                          torch.float32, device))
        self.layers = nn.ModuleList([LayerStack(cfg, n_periods, flags[j][0], gen, dtype, device)
                                     for j in range(period if n_periods else 0)])
        self.layers_tail = nn.ModuleList([LayerStack(cfg, None, flags[r % period][0], gen,
                                                     dtype, device) for r in range(n_rem)])
        self.ln_f = Norm((cfg.d_model,), device)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(_normal(gen, (cfg.d_model, cfg.vocab_size),
                                                cfg.d_model**-0.5, torch.float32, device))

    def param_leaves(self) -> list:
        """Parameters in JAX flatten order (the exchange's leaf order)."""
        return [p for _, p in self.named_param_leaves()]

    def named_param_leaves(self) -> list:
        return sorted(self.named_parameters(), key=lambda kv: path_sort_key(kv[0]))

    def forward(self, tokens: torch.Tensor, embeds=None) -> torch.Tensor:
        return self.forward_aux(tokens, embeds)[0]

    def forward_aux(self, tokens: torch.Tensor, embeds=None):
        """tokens [B, S], ``embeds`` [B, P, D] or None -> (logits, the MoE
        layers' summed auxiliary loss, 0.0 without experts)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = _embed(self, tokens, embeds)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        period, flags, _, _ = layer_pattern(cfg)
        aux = 0.0
        for l in range(cfg.num_layers):
            x, a = block_apply(layer_params(self, l), cfg, x, positions, flags[l % period][1])
            aux = aux + a
        return _unembed(self, x), aux



# ---------------------------------------------------------------------------
# Decode: the dense KV cache, and the paged cache of the serving path
# ---------------------------------------------------------------------------


def paged_eligible(cfg: ModelConfig) -> bool:
    """Architectures the paged quantized cache serves: pure-attention
    decoders with per-head K/V (the reference's rule).  Every family the
    port takes (dense, MoE, VLM) is one; ``ModelConfig`` refuses the
    rest (SSM, hybrid, encoder-decoder, audio, MLA's latent cache), so
    this is the place to refuse one once it is ported."""
    return True


def layer_params(model: Decoder, l: int) -> dict:
    """Layer ``l``'s parameters by absolute index (the reference's
    ``_layer_params_at``)."""
    period, _, n_periods, _ = layer_pattern(model.cfg)
    if l < n_periods * period:
        return model.layers[l % period].layer(l // period)
    return model.layers_tail[l - n_periods * period].layer(0)


def _embed(model: Decoder, token: torch.Tensor, embeds=None) -> torch.Tensor:
    """Scaled token embeddings; a VLM's ``embeds`` [B, P, D] overwrite the
    first P positions, cast to the model dtype and not scaled."""
    cfg = model.cfg
    x = model.embed[token].to(model_dtype(cfg)) * (cfg.d_model**0.5)
    if embeds is not None and cfg.num_prefix_embeds:
        x = torch.cat([embeds.to(x.dtype), x[:, cfg.num_prefix_embeds:]], dim=1)
    return x


def _unembed(model: Decoder, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = L.norm_apply({"scale": model.ln_f.scale}, x, cfg.norm_type)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x.float(), model.embed)
    return x.float() @ model.unembed


@torch.no_grad()
def forward_with_kv(model: Decoder, tokens: torch.Tensor, embeds=None):
    """Full-sequence prefill that also returns every layer's roped K/V:
    tokens [B, S] -> (logits [B, S, V], ((k, v) [B, S, KV, hd] per layer))
    (the K/V :func:`decode_step` would have written token by token)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = _embed(model, tokens, embeds)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    period, flags, _, _ = layer_pattern(cfg)
    kvs = []
    for l in range(cfg.num_layers):
        p = layer_params(model, l)
        h = L.norm_apply(p["ln_attn"], x, cfg.norm_type)
        kvs.append(L.attention_prefill_kv(p["attn"], cfg, h, positions))
        x, _ = block_apply(p, cfg, x, positions, flags[l % period][1])
    return _unembed(model, x), tuple(kvs)


@torch.no_grad()
def prefill_paged(model: Decoder, pc, cache: dict, tokens: torch.Tensor,
                  pages: torch.Tensor, noise):
    """Forward whole prompts and write every layer's K/V into the paged
    arena (in place).  tokens [B, S] with S == pages.shape[1] * page_size
    (padded: the padding is routed through a MoE layer's capacity too);
    pages [B, nblk]; ``noise`` the cache noise of these rows.  A VLM is
    served by its tokens alone, as the reference serves it.  Returns
    (logits [B, S, V], cache)."""
    from repro_torch.serve import kv_cache as KVC

    logits, kvs = forward_with_kv(model, tokens)
    for l, (k, v) in enumerate(kvs):
        KVC.write_prompt(cache, pc, l, k, v, pages, noise)
    return logits, cache


@torch.no_grad()
def decode_step_paged(model: Decoder, pc, cache: dict, token: torch.Tensor,
                      pos: torch.Tensor, page_table: torch.Tensor, noise):
    """Packed-batch paged decode: token / pos [B] (per-slot positions),
    page_table [B, blocks_per_seq], ``noise`` the cache noise of this wave
    -> (logits [B, V], cache written in place).  Idle slots are routed
    through a MoE layer with the others and take capacity."""
    cfg = model.cfg
    x = _embed(model, token)[:, None, :]
    period, flags, _, _ = layer_pattern(cfg)
    for l in range(cfg.num_layers):
        p = layer_params(model, l)
        h = L.norm_apply(p["ln_attn"], x, cfg.norm_type)
        x = x + L.attention_decode_paged(p["attn"], cfg, pc, cache, l, h, pos, page_table,
                                         noise, attn_mode(cfg, flags[l % period][1]))
        x, _ = _ffn_residual(p, cfg, x)
    return _unembed(model, x)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Dense decode state: k, v [L, B, max_len, KV, hd] in the model dtype."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = model_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_block(p, cfg: ModelConfig, x: torch.Tensor, pos: int, layer_cache: dict,
                 is_global: bool):
    """One layer of dense decode; ``layer_cache`` {"k", "v"} [B, S, KV, hd]
    is written in place.  Returns (x, layer_cache)."""
    h = L.norm_apply(p["ln_attn"], x, cfg.norm_type)
    x = x + L.attention_decode(p["attn"], cfg, h, pos, layer_cache["k"], layer_cache["v"],
                               attn_mode(cfg, is_global))
    return _ffn_residual(p, cfg, x)[0], layer_cache


@torch.no_grad()
def decode_step(model: Decoder, cache: dict, token: torch.Tensor, pos: int):
    """token [B], pos the shared position -> (logits [B, V], cache written
    in place)."""
    cfg = model.cfg
    x = _embed(model, token)[:, None, :]
    period, flags, _, _ = layer_pattern(cfg)
    for l in range(cfg.num_layers):
        x, _ = decode_block(layer_params(model, l), cfg, x, pos,
                            {"k": cache["k"][l], "v": cache["v"][l]}, flags[l % period][1])
    return _unembed(model, x)[:, 0], cache
