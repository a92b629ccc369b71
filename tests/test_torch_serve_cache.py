"""The port's paged quantized KV-cache (``repro_torch.serve.kv_cache``)
against the reference's (``repro.serve.kv_cache``), on the reduced
tinyllama-1.1b layout (2 layers, 2 kv heads x 64: feat 128).

* The segment table, ``describe()``, ``cache_bytes`` / ``fp32_cache_bytes``
  equal the reference's for every policy; the port's tensors add up to
  ``arena_bytes`` (the reference's count plus the sink page).
* ``write_token``, ``write_prompt``, ``read_kv`` and ``corrupt_page`` from
  one arena state (``convert.arena_from_jax``), the reference's
  ``jax.random.uniform`` draws replayed (``SourceNoise(ReplayNoise)``):
  payloads, norms and the whole arena bit-equal at int8, int4 and fp32,
  with -1 rows (dropped writes, zero reads).  The writes run kernel 1's
  plain version and the reads kernel 3's (CPU tensors).
* The native draw (``KeyedNoise``): a row's draw depends on its key and
  position only (not its slot or its batch), the domains, layers, tags
  and retry salts give distinct draws, and the draws are uniform on the
  24-bit grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.kv_cache as JK
from repro.configs.registry import get_config as jax_get_config
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.noise import ReplayNoise
from repro_torch.serve import kv_cache as K
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

POLICIES = ("fp32", "int8", "int4", "mixed")
PAGE, PAGES, BPS = 4, 8, 4


def _configs(policy):
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    return (JK.make_paged_cache_config(jcfg, policy, PAGE, PAGES, BPS),
            K.make_paged_cache_config(cfg, policy, PAGE, PAGES, BPS))


@pytest.mark.parametrize("policy", POLICIES)
def test_layout_and_bytes_match_reference(policy):
    jpc, pc = _configs(policy)
    assert pc.describe() == jpc.describe()
    assert [(s.start, s.n, s.key_tag, None if s.quant is None else
             (s.quant.num_levels, s.quant.bits, s.quant.bucket_size)) for s in pc.segments] == \
        [(s.start, s.n, s.key_tag, None if s.quant is None else
          (s.quant.num_levels, s.quant.bits, s.quant.bucket_size)) for s in jpc.segments]
    assert K.cache_bytes(pc) == JK.cache_bytes(jpc)
    assert K.fp32_cache_bytes(pc) == JK.fp32_cache_bytes(jpc)
    cache = K.init_paged_cache(pc, "cpu")
    assert sum(t.numel() * t.element_size() for t in cache.values()) == K.arena_bytes(pc)
    ratio = K.fp32_cache_bytes(pc) / K.cache_bytes(pc)
    assert ratio >= {"fp32": 1.0, "int8": 2.0, "mixed": 2.0, "int4": 4.0}[policy]
    # the reference's arena and the port's convert both ways
    jarena = {k: np.asarray(v) for k, v in JK.init_paged_cache(jpc).items()}
    back = convert.arena_to_jax(convert.arena_from_jax(jarena, "cpu"))
    assert back.keys() == jarena.keys()
    assert all(np.array_equal(back[k], jarena[k]) and back[k].dtype == jarena[k].dtype
               for k in jarena)


def test_mixed_is_all_int8_without_local_layers():
    jpc, pc = _configs("mixed")
    assert K.layer_bit_policy(get_config("tinyllama-1.1b").reduced(), "mixed") == (8, 8)
    assert len(pc.segments) == 1 and pc.segments[0].quant.bits == 8
    with pytest.raises(ValueError, match="unknown cache policy"):
        K.layer_bit_policy(get_config("tinyllama-1.1b").reduced(), "int2")


def _rand_state(jpc, rng):
    """A reference arena with random contents (finite payloads / norms)."""
    out = {}
    q = jpc.segments[0].quant
    for name, a in JK.init_paged_cache(jpc).items():
        if a.dtype == jnp.int8:
            top = q.num_levels + 1  # signed indices in [-(s + 1), s + 1]
            if q.bits == 8:
                out[name] = rng.randint(-top, top + 1, size=a.shape).astype(np.int8)
            else:
                idx = rng.randint(-top, top + 1, size=(*a.shape[:-1], 2 * a.shape[-1]))
                out[name] = ((idx[..., 0::2] & 0xF) | ((idx[..., 1::2] & 0xF) << 4)
                             ).astype(np.uint8).view(np.int8)
        else:
            out[name] = rng.randn(*a.shape).astype(np.float32)
    return out


def _tok_draws(keys, tag, shape):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, tag),
                                                            shape))(keys))


def _assert_arena_equal(cache, jcache):
    got = convert.arena_to_jax(cache)
    for name, want in jcache.items():
        np.testing.assert_array_equal(got[name], np.asarray(want), err_msg=name)


@pytest.mark.parametrize("policy", ["int8", "int4", "fp32"])
def test_writes_reads_and_corruption_match_reference(policy):
    jpc, pc = _configs(policy)
    rng = np.random.RandomState(3)
    jcache = {k: jnp.asarray(v) for k, v in _rand_state(jpc, rng).items()}
    cache = convert.arena_from_jax({k: np.asarray(v) for k, v in jcache.items()}, "cpu")
    KV, hd, F = pc.kv_heads, pc.head_dim, pc.feat_pad
    quant = pc.segments[0].quant is not None
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(7),
                                                   jnp.arange(3, dtype=jnp.uint32))
    for l in range(pc.num_layers):
        # write_token: three slots, the middle one inactive (-1)
        k_t = (rng.randn(3, KV, hd) * np.linspace(0.1, 4, hd)).astype(np.float32)
        v_t = rng.randn(3, KV, hd).astype(np.float32)
        k_t[0, 1] = 0.0  # a zero head inside a token
        pages, offs = np.array([2, -1, 5], np.int32), np.array([1, 3, 0], np.int32)
        lkeys = jax.vmap(jax.random.fold_in, (0, None))(keys, l)
        jcache = JK.write_token(jcache, jpc, l, jnp.asarray(k_t), jnp.asarray(v_t),
                                jnp.asarray(pages), jnp.asarray(offs), lkeys)
        draws = [_tok_draws(lkeys, t, (F,)) for t in (0, 1)] if quant else []
        noise = ReplayNoise(draws)
        K.write_token(cache, pc, l, torch.from_numpy(k_t), torch.from_numpy(v_t),
                      torch.from_numpy(pages), torch.from_numpy(offs), K.SourceNoise(noise))
        assert noise.remaining == 0
        _assert_arena_equal(cache, jcache)
        # write_prompt: two sequences of 2 pages, the second's last unmapped
        S = 2 * PAGE
        k = rng.randn(2, S, KV, hd).astype(np.float32)
        v = rng.randn(2, S, KV, hd).astype(np.float32)
        ppages = np.array([[0, 7], [3, -1]], np.int32)
        jcache = JK.write_prompt(jcache, jpc, l, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(ppages), lkeys[:2])
        draws = [_tok_draws(lkeys[:2], t, (S, F)) for t in (0, 1)] if quant else []
        K.write_prompt(cache, pc, l, torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(ppages), K.SourceNoise(ReplayNoise(draws)))
        _assert_arena_equal(cache, jcache)
        # read_kv with unmapped pages in the table
        pt = np.array([[0, 7, -1, -1], [3, 2, 5, -1], [-1, -1, -1, -1]], np.int32)
        jk, jv = JK.read_kv(jcache, jpc, l, jnp.asarray(pt))
        pk, pv = K.read_kv(cache, pc, l, torch.from_numpy(pt))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        assert not pk[2].any() and not pv[0, PAGE * 2:].any()
    # corrupt_page: NaN norms (quantized) / NaN K (fp32) on every layer
    jcache = JK.corrupt_page(jcache, jpc, 5)
    K.corrupt_page(cache, pc, 5)
    _assert_arena_equal(cache, jcache)
    pk, _ = K.read_kv(cache, pc, 0, torch.tensor([[5, -1, -1, -1]]))
    assert torch.isnan(pk[0, :PAGE]).all() and not pk[0, PAGE:].any()


def test_native_draw_is_keyed_by_request_and_position():
    L, F = 3, 130
    a = K.KeyedNoise([11, 22, 33], [5, 9, 0], K.DECODE, L)
    b = K.KeyedNoise([33, 11], [0, 5], K.DECODE, L)  # other slots, other batch
    for l in range(L):
        for tag in (0, 1):
            da, db = a.draw(l, tag, (3, F), "cpu"), b.draw(l, tag, (2, F), "cpu")
            assert torch.equal(da[0], db[1]) and torch.equal(da[2], db[0])
    # a prefill of the same request shares no draw with its decode, and
    # each position's prefill row is the same whatever the prompt length
    p8 = K.KeyedNoise([11], np.arange(8)[None], K.PREFILL, L)
    p4 = K.KeyedNoise([11], np.arange(4)[None], K.PREFILL, L)
    assert torch.equal(p8.draw(1, 0, (1, 8, F), "cpu")[:, :4], p4.draw(1, 0, (1, 4, F), "cpu"))
    assert not torch.equal(p8.draw(0, 0, (1, 8, F), "cpu")[0, 5], a.draw(0, 0, (3, F), "cpu")[0])
    d = a.draw(0, 0, (3, F), "cpu")
    others = [a.draw(1, 0, (3, F), "cpu"), a.draw(0, 1, (3, F), "cpu")]
    assert all(not torch.equal(d, o) for o in others)
    # the request key: seed, rid, retry salt and rank each change it
    base = K.request_key(0, 4)
    assert len({base, K.request_key(1, 4), K.request_key(0, 5),
                K.request_key(0, 4, K.RETRY_SALT + 1), K.request_key(0, 4, 0, 1)}) == 5
    assert K.request_key(0, 4) >> 64 == 0 and base == K.request_key(0, 4)
    # keys with the top bit set survive the int64 round trip
    hi = K.KeyedNoise([(1 << 64) - 5], [3], K.DECODE, 1).draw(0, 0, (1, 8), "cpu")
    lo = K.KeyedNoise([(1 << 63) - 5], [3], K.DECODE, 1).draw(0, 0, (1, 8), "cpu")
    assert not torch.equal(hi, lo)
    with pytest.raises(ValueError, match="cache draw shape"):
        a.draw(0, 0, (2, F), "cpu")


def test_native_draw_is_uniform_on_the_24_bit_grid():
    n = K.KeyedNoise(list(range(64)), np.arange(64), K.DECODE, 2)
    r = n.draw(1, 1, (64, 256), "cpu").double()
    assert r.min() >= 0.0 and r.max() < 1.0
    assert torch.equal(r * 2**24, torch.floor(r * 2**24))
    assert abs(float(r.mean()) - 0.5) < 0.01 and abs(float(r.var()) - 1 / 12) < 0.005
    hist = torch.histc(r, bins=16, min=0.0, max=1.0) / r.numel()
    assert float((hist - 1 / 16).abs().max()) < 0.01
