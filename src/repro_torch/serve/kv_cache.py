"""Paged, quantized KV-cache: one shared arena, per-layer bit policies
(port of ``repro/serve/kv_cache.py``).

Sequences of different lengths share one pool of fixed-size pages
(``page_size`` tokens each); a per-request *page table* maps sequence
blocks to arena pages, so admission and retirement are host-side
free-list operations and the device tensors never reshape.  K/V tokens
are stored through the paper's unbiased quantizer (Definition 1) with one
L^inf norm bucket per token (bucket = the padded ``kv_heads * head_dim``
feature vector), int8 or packed int4 payloads and stochastic rounding:

* a write quantizes its ``[rows, feat_pad]`` token rows with **kernel 1**
  (:func:`repro_torch.kernels.quantize.quantize_blocks`: host noise,
  bucket = ``feat_pad``, q = inf, the uniform table);
* a read dequantizes the gathered ``[B * T, W]`` payload with **kernel 3**
  (:func:`repro_torch.kernels.dequantize.dequantize_blocks`).

This is the reference's ``_tok_quantize`` / ``_tok_dequantize``
arithmetic (``tau = #{levels[j] <= u}``, ``r < xi``, pairs packed low
nibble first), so payloads and norms are bit-exact given the same noise.
CPU tensors take the kernels' plain versions.

The rounding noise comes from a *cache noise* object handed to each
writer: ``noise.draw(layer, tag, shape, device)`` returns the uniform
[0, 1) draw of one layer's K (tag 0) or V (tag 1) rows.
:class:`KeyedNoise` is the native draw: Philox4x32-10 (the arithmetic of
:func:`repro_torch.kernels.ref.philox4x32_10`) in plain torch on the
tensors' device, keyed by a 64-bit mix of (seed, request id, retry
salt, rank) per row (:func:`request_key`), with counter (position,
column // 4, layer, domain << 8 | tag), word ``column % 4`` mapped to the
24-bit grid.  A draw is a function of the request and the position, never
of the slot or the batch, so a request's rounding is the same alone or
packed.  It draws every layer's K and V at once on its first use (one
Philox evaluation per decode wave or prefill).  :class:`SourceNoise`
hands out the arrays of a noise source in call order (tests replay the
reference's ``jax.random.uniform`` draws through it).

Per-layer bit policies reuse the ExchangePlan segment table
(:class:`repro_torch.core.exchange_plan.PlanSegment`): contiguous layer
ranges under one :class:`~repro_torch.core.quantization.QuantConfig`
(``quant=None`` = fp32 storage).  ``mixed`` stores local-window layers
int4 and global-attention layers int8, as :func:`layer_bit_policy` reads
them off the model's layer pattern: gemma3-27b's 5:1 local:global layers
and llama4's 3:1 chunk-local:global layers take both widths, and a config
with no local layers (tinyllama, gemma-2b, qwen3-4b, internvl2) is
all-int8, as in the reference.

Storage per segment ``j`` (one tensor per name, ``P = num_pages``):

  fp32:   seg{j}_k         [Lj, P + 1, page_size, KV, hd] f32 (+ v)
  int8/4: seg{j}_k_payload [Lj, P + 1, page_size, W] int8 (+ v)
          seg{j}_k_norms   [Lj, P + 1, page_size]     f32 (+ v)

with ``W = feat_pad`` (int8) or ``feat_pad // 2`` (int4).  Page ``P`` is
the sink of dropped writes: torch has no ``mode="drop"`` scatter, so a
page of -1 (an inactive slot) is remapped there (:func:`_oob`, the
reference's remap past the end).  No page table maps it, and reads zero
every unmapped row (the reference's ``mode="fill"``), so it is never
seen.  :func:`cache_bytes` counts the ``P`` pages a request can hold, as
the reference does; :func:`arena_bytes` adds the sink.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exchange_plan import PlanSegment
from repro_torch.core.quantization import QuantConfig, uniform_levels
from repro_torch.kernels.dequantize import dequantize_blocks
from repro_torch.kernels.quantize import quantize_blocks
from repro_torch.kernels.ref import philox4x32_10

POLICIES = ("fp32", "int8", "int4", "mixed")

#: counter domains of the native draw
PREFILL, DECODE = 0, 1
#: request-key salt of guard retry ``attempt`` (>= 1): RETRY_SALT + attempt
RETRY_SALT = 0x9E77
_MASK64 = (1 << 64) - 1


def quant_for_bits(bits: int, bucket: int) -> Optional[QuantConfig]:
    """The cache quantizer for one bit-width (32 = fp32 storage, None)."""
    if bits == 32:
        return None
    s = 15 if bits == 8 else 5  # max levels each payload width can hold
    return QuantConfig(num_levels=s, q_norm=math.inf, bucket_size=bucket,
                       bits=bits, stochastic=True)


def layer_bit_policy(cfg: ModelConfig, policy: str) -> tuple:
    """Per-layer payload bits (32 | 8 | 4) under a named policy.

    ``mixed``: global-attention layers int8, local-window layers int4
    (the ``layer_pattern`` flags of the forward pass); an architecture
    with no local layers gets all-int8.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown cache policy {policy!r} (want {POLICIES})")
    if policy == "fp32":
        return (32,) * cfg.num_layers
    if policy in ("int8", "int4"):
        return (8 if policy == "int8" else 4,) * cfg.num_layers
    from repro_torch.models.transformer import layer_pattern  # lazy: no cycle
    period, flags, _, _ = layer_pattern(cfg)
    return tuple(8 if flags[l % period][1] else 4 for l in range(cfg.num_layers))


def build_layer_segments(bits_per_layer, feat_pad: int) -> tuple:
    """Group contiguous same-policy layer runs into PlanSegments
    (``start`` / ``n`` index layers here, not buffer coordinates)."""
    segs, run_start = [], 0
    for l in range(1, len(bits_per_layer) + 1):
        if l == len(bits_per_layer) or bits_per_layer[l] != bits_per_layer[run_start]:
            n = l - run_start
            segs.append(PlanSegment(
                start=run_start, n=n, padded=n,
                quant=quant_for_bits(bits_per_layer[run_start], feat_pad),
                key_tag=len(segs),
            ))
            run_start = l
    return tuple(segs)


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Static layout of the paged cache."""

    num_layers: int
    kv_heads: int
    head_dim: int
    page_size: int
    num_pages: int
    blocks_per_seq: int  # page-table width (max pages one sequence maps)
    segments: tuple  # PlanSegment per contiguous same-policy layer range

    @property
    def feat(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def feat_pad(self) -> int:
        """Feature vector padded to even length (int4 packs index pairs)."""
        return self.feat + (self.feat % 2)

    @property
    def max_len(self) -> int:
        return self.page_size * self.blocks_per_seq

    def segment_of(self, l: int):
        """(segment index, PlanSegment) covering layer ``l``."""
        for j, seg in enumerate(self.segments):
            if seg.start <= l < seg.start + seg.n:
                return j, seg
        raise IndexError(f"layer {l} outside {self.num_layers} layers")

    def describe(self) -> str:
        parts = []
        for seg in self.segments:
            b = 32 if seg.quant is None else seg.quant.bits
            parts.append(f"L{seg.start}-{seg.start + seg.n - 1}:int{b}"
                         if b != 32 else
                         f"L{seg.start}-{seg.start + seg.n - 1}:fp32")
        return (f"pages={self.num_pages}x{self.page_size}tok "
                f"feat={self.feat} [{' '.join(parts)}]")


def make_paged_cache_config(cfg: ModelConfig, policy: str, page_size: int, num_pages: int,
                            blocks_per_seq: int) -> PagedCacheConfig:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    feat_pad = kv * hd + (kv * hd) % 2
    return PagedCacheConfig(
        num_layers=cfg.num_layers, kv_heads=kv, head_dim=hd,
        page_size=page_size, num_pages=num_pages,
        blocks_per_seq=blocks_per_seq,
        segments=build_layer_segments(layer_bit_policy(cfg, policy), feat_pad),
    )


def blocks_for(pc: PagedCacheConfig, total_len: int) -> int:
    """Pages one sequence of ``total_len`` tokens needs (ceil)."""
    return -(-total_len // pc.page_size)


def _width(pc: PagedCacheConfig, quant: QuantConfig) -> int:
    return pc.feat_pad if quant.bits == 8 else pc.feat_pad // 2


# ---------------------------------------------------------------------------
# Arena init + byte accounting
# ---------------------------------------------------------------------------


def init_paged_cache(pc: PagedCacheConfig, device) -> dict:
    """Zeroed arena tensors on ``device``, one group per segment, each
    with the sink page after the ``num_pages`` real ones."""
    cache = {}
    for j, seg in enumerate(pc.segments):
        Lj, Pn, T = seg.n, pc.num_pages + 1, pc.page_size
        if seg.quant is None:
            shape = (Lj, Pn, T, pc.kv_heads, pc.head_dim)
            cache[f"seg{j}_k"] = torch.zeros(shape, dtype=torch.float32, device=device)
            cache[f"seg{j}_v"] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            W = _width(pc, seg.quant)
            for kv in ("k", "v"):
                cache[f"seg{j}_{kv}_payload"] = torch.zeros((Lj, Pn, T, W), dtype=torch.int8,
                                                            device=device)
                cache[f"seg{j}_{kv}_norms"] = torch.zeros((Lj, Pn, T), dtype=torch.float32,
                                                          device=device)
    return cache


def corrupt_page(cache: dict, pc: PagedCacheConfig, page: int) -> dict:
    """NaN-scribble one arena page across every layer, in place (the
    ``page_corrupt`` fault): the per-token norms of quantized segments and
    the raw K of fp32 segments.  One NaN norm makes every dequantized
    feature of its token non-finite, which the decode guard must catch;
    only the page's owner reads it (masked reads replace scores with
    ``where``).  In the engine's ensemble mode one rank corrupts its own
    arena only, so the all-reduced veto must reject the slot everywhere."""
    for j, seg in enumerate(pc.segments):
        name = f"seg{j}_k_norms" if seg.quant is not None else f"seg{j}_k"
        cache[name][:, page] = float("nan")
    return cache


def cache_bytes(pc: PagedCacheConfig) -> int:
    """Bytes of the arena's ``num_pages`` pages (the reference's count;
    the sink page is :func:`arena_bytes`' difference)."""
    total = 0
    for seg in pc.segments:
        per_tok = (2 * pc.feat * 4 if seg.quant is None
                   else 2 * (_width(pc, seg.quant) + 4))
        total += seg.n * pc.num_pages * pc.page_size * per_tok
    return total


def arena_bytes(pc: PagedCacheConfig) -> int:
    """Bytes the arena allocates: :func:`cache_bytes` plus the sink page
    (equals the sum of :func:`init_paged_cache`'s tensors' sizes)."""
    return cache_bytes(pc) * (pc.num_pages + 1) // pc.num_pages


def fp32_cache_bytes(pc: PagedCacheConfig) -> int:
    """What the same arena would cost stored fp32 (the ratio baseline)."""
    return pc.num_layers * pc.num_pages * pc.page_size * 2 * pc.feat * 4


# ---------------------------------------------------------------------------
# The rounding noise of the cache writes
# ---------------------------------------------------------------------------


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def request_key(seed: int, rid: int, salt: int = 0, rank: int = 0) -> int:
    """The 64-bit Philox key of one request's cache writes: splitmix64
    chained over (seed, rid, salt, rank).  ``salt`` is 0 for a request's
    first decode attempt and ``RETRY_SALT + attempt`` for a guard retry
    (a fresh draw, not a replay of the failed one); ``rank`` gives each
    rank of the logit ensemble its own quantization of the same tokens."""
    h = _splitmix64(int(seed) & _MASK64)
    for word in (rid, salt, rank):
        h = _splitmix64(h ^ (int(word) & _MASK64))
    return h


class KeyedNoise:
    """The native cache draw of one decode wave or one prefill.

    ``keys``: one 64-bit :func:`request_key` per row (B); ``positions``:
    a [B] (decode) or [B, S] (prefill) integer array of token positions;
    ``domain``: :data:`DECODE` or :data:`PREFILL`.  ``draw(l, tag, shape,
    device)`` returns ``[*positions.shape, F]`` f32 (``shape`` names F);
    the first call computes every layer and tag at once."""

    def __init__(self, keys, positions, domain: int, num_layers: int):
        self.keys = [int(k) for k in keys]
        self.positions = np.asarray(positions, np.int64)
        self.domain = int(domain)
        self.num_layers = int(num_layers)
        self._block = None

    def _compute(self, F: int, device) -> torch.Tensor:
        pos = torch.from_numpy(self.positions).to(device)
        lead = pos.shape  # (B,) or (B, S)
        # 64-bit keys as int64 bit patterns; the masks below recover the words
        keys = torch.tensor([k - (1 << 64) if k >> 63 else k for k in self.keys],
                            dtype=torch.int64, device=device)
        keys = keys.reshape((-1,) + (1,) * (len(lead) - 1))
        # broadcast layout [L, 2, *lead, F4]
        extra = (1,) * len(lead)
        c0 = pos.reshape((1, 1) + lead + (1,))
        q4 = torch.arange(-(-F // 4), dtype=torch.int64, device=device)
        c1 = q4.reshape((1, 1) + extra + (-1,))
        c2 = torch.arange(self.num_layers, dtype=torch.int64, device=device)
        c2 = c2.reshape((-1, 1) + extra + (1,))
        tags = torch.tensor([(self.domain << 8) | t for t in (0, 1)], dtype=torch.int64,
                            device=device)
        c3 = tags.reshape((1, -1) + extra + (1,))
        k = keys.reshape((1, 1) + tuple(keys.shape) + (1,))
        words = philox4x32_10((c0, c1, c2, c3), (k & 0xFFFFFFFF, (k >> 32) & 0xFFFFFFFF))
        w = torch.stack(words, dim=-1).flatten(-2)[..., :F]
        return ((w >> 8) & 0xFFFFFF).to(torch.float32) * 2.0**-24

    def draw(self, l: int, tag: int, shape, device) -> torch.Tensor:
        want = tuple(self.positions.shape) + (int(shape[-1]),)
        if tuple(shape) != want:
            raise ValueError(f"cache draw shape {tuple(shape)} != {want}")
        if self._block is None or self._block.shape[-1] != want[-1]:
            self._block = self._compute(want[-1], device)
        return self._block[l, tag]


class SourceNoise:
    """Cache noise from a noise source (:mod:`repro_torch.core.noise`):
    each draw is the source's next ``uniform(shape)`` array, whatever the
    layer and tag (a :class:`~repro_torch.core.noise.ReplayNoise` replays
    the reference's draws in the order the writers ask for them)."""

    def __init__(self, source):
        self.source = source

    def draw(self, l: int, tag: int, shape, device) -> torch.Tensor:
        return self.source.uniform(tuple(shape), device)


class KeyedCacheNoise:
    """The engine's native cache noise: :class:`KeyedNoise` for each
    prefill and decode wave, keyed by :func:`request_key` (seed, rid,
    retry salt, rank)."""

    def __init__(self, seed: int, rank: int, num_layers: int):
        self.seed, self.rank, self.num_layers = int(seed), int(rank), int(num_layers)

    def key(self, rid: int, attempt: int = 0) -> int:
        return request_key(self.seed, rid, RETRY_SALT + attempt if attempt else 0, self.rank)

    def prefill(self, rid: int, length: int) -> KeyedNoise:
        return KeyedNoise([self.key(rid)], np.arange(length)[None], PREFILL, self.num_layers)

    def decode(self, rows) -> KeyedNoise:
        """``rows``: per slot, ``(rid, attempt, pos)`` or None (an empty
        slot, whose writes drop)."""
        keys = [0 if r is None else self.key(r[0], r[1]) for r in rows]
        pos = [0 if r is None else r[2] for r in rows]
        return KeyedNoise(keys, pos, DECODE, self.num_layers)


# ---------------------------------------------------------------------------
# Page reads / writes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _levels(s: int, device: str) -> torch.Tensor:
    """The uniform table on ``device``, made once (not a copy a call)."""
    return uniform_levels(s, torch.device(device))


def _pad_feat(x: torch.Tensor, feat_pad: int) -> torch.Tensor:
    pad = feat_pad - x.shape[-1]
    if pad:
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)
    return x


def _oob(pages: torch.Tensor, num_pages: int) -> torch.Tensor:
    """Map the -1 'unmapped' sentinel to the sink page ``num_pages``
    (torch indexing, like jax, wraps -1 to the last page)."""
    return torch.where(pages < 0, torch.full_like(pages, num_pages), pages)


def _quantize_rows(x: torch.Tensor, quant: QuantConfig, r: torch.Tensor):
    """[rows, feat_pad] f32 -> (payload [rows, W] int8, norms [rows]) via
    kernel 1 (host noise ``r``, q = inf, the uniform table)."""
    return quantize_blocks(x, r, _levels(quant.num_levels, str(x.device)),
                           num_symbols=quant.num_symbols, q_is_inf=quant.q_is_inf,
                           bits=quant.bits)


def write_token(cache: dict, pc: PagedCacheConfig, l: int, k_t: torch.Tensor,
                v_t: torch.Tensor, pages: torch.Tensor, offs: torch.Tensor, noise) -> dict:
    """Write one new token per slot into layer ``l``, in place.

    k_t / v_t [B, KV, hd]; pages / offs [B] int — a page of -1 drops the
    write (an inactive slot).  ``noise``: the cache noise, asked for
    ``draw(l, 0 | 1, (B, feat_pad))`` (K, then V) on a quantized layer."""
    j, seg = pc.segment_of(l)
    lj = l - seg.start
    pages = _oob(pages.long(), pc.num_pages)
    offs = offs.long()
    if seg.quant is None:
        for name, t in ((f"seg{j}_k", k_t), (f"seg{j}_v", v_t)):
            cache[name][lj].index_put_((pages, offs), t.float())
        return cache
    B = k_t.shape[0]
    for tag, name, t in ((0, f"seg{j}_k", k_t), (1, f"seg{j}_v", v_t)):
        x = _pad_feat(t.reshape(B, -1).float(), pc.feat_pad)
        r = noise.draw(l, tag, (B, pc.feat_pad), x.device)
        payload, norms = _quantize_rows(x, seg.quant, r)
        cache[f"{name}_payload"][lj].index_put_((pages, offs), payload)
        cache[f"{name}_norms"][lj].index_put_((pages, offs), norms)
    return cache


def write_prompt(cache: dict, pc: PagedCacheConfig, l: int, k: torch.Tensor,
                 v: torch.Tensor, pages: torch.Tensor, noise) -> dict:
    """Write whole prefilled sequences into layer ``l`` in one scatter, in
    place.

    k / v [B, S, KV, hd] with S == pages.shape[1] * page_size (the caller
    pads the prompt to whole pages; padded positions are overwritten by
    decode at its own position before a read can see them).  pages
    [B, nblk] (-1 drops).  ``noise`` is asked for ``draw(l, 0 | 1, (B, S,
    feat_pad))``."""
    j, seg = pc.segment_of(l)
    lj = l - seg.start
    B, S = k.shape[:2]
    nblk = pages.shape[1]
    pages = _oob(pages.long(), pc.num_pages)
    if seg.quant is None:
        for name, t in ((f"seg{j}_k", k), (f"seg{j}_v", v)):
            val = t.float().reshape(B, nblk, pc.page_size, pc.kv_heads, pc.head_dim)
            cache[name][lj].index_put_((pages,), val)
        return cache
    for tag, name, t in ((0, f"seg{j}_k", k), (1, f"seg{j}_v", v)):
        x = _pad_feat(t.reshape(B, S, -1).float(), pc.feat_pad)
        r = noise.draw(l, tag, (B, S, pc.feat_pad), x.device)
        payload, norms = _quantize_rows(x.reshape(B * S, -1), seg.quant,
                                        r.reshape(B * S, -1))
        cache[f"{name}_payload"][lj].index_put_(
            (pages,), payload.reshape(B, nblk, pc.page_size, -1))
        cache[f"{name}_norms"][lj].index_put_((pages,), norms.reshape(B, nblk, pc.page_size))
    return cache


def read_kv(cache: dict, pc: PagedCacheConfig, l: int, page_table: torch.Tensor) -> tuple:
    """Gather + dequantize a layer's history for every slot.

    page_table [B, nblk] -> k, v [B, nblk * page_size, KV, hd] f32.
    Unmapped pages (-1) read as zeros; the attention mask drops them
    anyway (page >= 0 and key_pos < pos)."""
    j, seg = pc.segment_of(l)
    lj = l - seg.start
    B, nblk = page_table.shape
    T = nblk * pc.page_size
    mapped = page_table >= 0
    pt = _oob(page_table.long(), pc.num_pages)
    if seg.quant is None:
        out = []
        for kv in ("k", "v"):
            x = cache[f"seg{j}_{kv}"][lj][pt]  # [B, nblk, T, KV, hd]
            x = torch.where(mapped[:, :, None, None, None], x, torch.zeros((), device=x.device))
            out.append(x.reshape(B, T, pc.kv_heads, pc.head_dim))
        return tuple(out)
    q = seg.quant
    out = []
    for kv in ("k", "v"):
        payload = cache[f"seg{j}_{kv}_payload"][lj][pt]  # [B, nblk, T, W]
        norms = cache[f"seg{j}_{kv}_norms"][lj][pt]  # [B, nblk, T]
        payload = torch.where(mapped[:, :, None, None], payload,
                              torch.zeros((), dtype=payload.dtype, device=payload.device))
        norms = torch.where(mapped[:, :, None], norms, torch.zeros((), device=norms.device))
        deq = dequantize_blocks(payload.reshape(B * T, -1), norms.reshape(-1),
                                _levels(q.num_levels, str(payload.device)),
                                num_symbols=q.num_symbols, bits=q.bits)
        out.append(deq[:, :pc.feat].reshape(B, T, pc.kv_heads, pc.head_dim))
    return tuple(out)


# ---------------------------------------------------------------------------
# Page allocator (host-side free list)
# ---------------------------------------------------------------------------


class PageAllocator:
    """Free-list allocator over the arena's pages (host-side).

    Invariants (tested): a page is never held by two owners, ``free`` of
    a page not currently held raises, and alloc/free round-trips restore
    ``n_free`` exactly.  ``alloc`` is all-or-nothing: it returns None
    (admission waits) rather than a partial grant.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._held: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        if n <= 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._held.update(pages)
        return pages

    def free(self, pages) -> None:
        pages = list(pages)
        # validate the whole batch before mutating: a double-free (or a
        # duplicate within one call) must not partially release pages
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate pages in free: {pages}")
        for p in pages:
            if p not in self._held:
                raise ValueError(f"free of page {p} not currently held")
        for p in pages:
            self._held.remove(p)
            self._free.append(p)
