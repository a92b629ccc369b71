"""The serving paths of the MoE and VLM families against the reference on
the CPU, f32, the same numpy params in both (``test_torch_moe``'s).

On llama4-5 (chunk 64; the MoE layers at offsets 1 and 3):

* ``--kv-bits mixed`` gives the chunk-local layers int4 and the global
  layer int8 in both packages (``[4, 4, 4, 8, 4]``), segment for segment
  the reference's layout;
* paged, at int8, mixed and fp32: a prefill of two 70-token prompts padded
  to 72 (9 pages of 8; the padding is routed and takes capacity; the
  second prompt ends in a run of one token, which crowds an expert past its
  capacity of 45; the prompts pass the chunk of 64, so the prefill's second
  chunk starts afresh), then 6 packed decode waves from position 70 (the windowed
  decode masks the keys before ``pos - 63``) with a third, idle slot
  (token 0 at position 0, no pages) that is routed with the others: at 3
  tokens over 4 experts the capacity is 1.  Every cache draw of the
  reference is replayed and each wave starts both packages from the same
  arena (the reference's, converted).  Held as
  ``test_torch_archs.test_paged_prefill_and_decode_match_reference``
  holds gemma3 (logits rtol 1e-5, atol 1e-5 times the largest logit;
  payloads equal but for adjacent-level flips, at most 1e-4 of the
  coordinates written, each prefill flip where the reference's ``|r -
  xi|`` is below the two packages' ``xi`` difference; norms and fp32 K/V
  rtol 1e-5 / atol 1e-5 times the largest: the bar of the logits, where
  gemma3's 20 positions held 1e-6, since at positions up to 76 a K
  coordinate of the first layer already moves by 1e-6 of the largest and
  one of the fifth by 1.5e-6).  The port's MoE layers must
  drop tokens at capacity in the prefill and in the waves (counted);
* the dense decode: ``make_serve_step`` against the reference's
  ``decode_step`` token by token to position 76 (the chunk layers slice
  their last 64 entries), logits as above and tokens equal, and
  ``make_prefill_step`` against ``forward`` on the 70-token prompts.

On internvl2: the paged int8 prefill and decode waves as above (12-token
prompts), served by tokens alone as the reference serves a VLM.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.kv_cache as JK
from repro.models import transformer as JT
from repro.configs.registry import get_config as jax_get_config
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.noise import ReplayNoise
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as K

from test_torch_archs import FAST_COMPILE, _close, _jdraws, _layer_of
from test_torch_moe import LLAMA4, dropped, params_np, port_model, small_configs
from test_torch_serve_model import _unpack, _xi
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SLOTS, PAGE, WAVES, FLIP_SHARE = 3, 8, 6, 1e-4
PROMPT = {"llama4-5": 70, "internvl2": 12}


@pytest.fixture
def drops(monkeypatch):
    """Counts of the (token, k) assignments the port's MoE layers drop, by
    call kind ("prefill": more than one position a row, else "decode")."""
    seen = {"prefill": 0, "decode": 0}
    apply = MOE.moe_apply

    def counted(p, cfg, x):
        seen["prefill" if x.shape[1] > 1 else "decode"] += dropped(cfg, p, x)
        return apply(p, cfg, x)

    monkeypatch.setattr(MOE, "moe_apply", counted)
    return seen


@functools.lru_cache(maxsize=None)
def served(name):
    jc, _ = small_configs(name)
    params = params_np(name)
    return jc, jax.tree_util.tree_map(jnp.asarray, params), port_model(name, params, grad=False)


def _shapes(name, policy):
    """(paged cache configs of both packages, prompt length, blocks a
    prompt, blocks a sequence, padded prompt length) of a paged case."""
    jc, tc = small_configs(name)
    plen = PROMPT[name]
    nblk, bps = -(-plen // PAGE), -(-(plen + WAVES) // PAGE)
    pc = K.make_paged_cache_config(tc, policy, PAGE, 2 * bps, bps)
    jpc = JK.make_paged_cache_config(jc, policy, PAGE, 2 * bps, bps)
    return pc, jpc, plen, nblk, bps, nblk * PAGE


PAGED = (("llama4-5", "int8"), ("llama4-5", "mixed"), ("llama4-5", "fp32"),
         ("internvl2", "int8"))


@pytest.fixture(scope="module")
def ref_fns():
    """The reference's functions of every case, lowered first and then
    compiled at once in threads (XLA's compiles release the GIL):
    ``(name, policy)`` -> (prefill_paged, decode_step_paged), and
    ``"dense"`` -> (forward, decode_step) of llama4-5."""
    lowered = {}
    for name, policy in PAGED:
        jc, params, _ = served(name)
        _, jpc, _, nblk, bps, s_pad = _shapes(name, policy)
        cache = JK.init_paged_cache(jpc)
        keys = jnp.zeros((2,) + jax.random.PRNGKey(0).shape, jnp.uint32)
        lowered[(name, policy, "prefill")] = jax.jit(
            lambda *a, jc=jc, jpc=jpc, params=params: JT.prefill_paged(params, jc, jpc, *a)
        ).lower(cache, jnp.zeros((2, s_pad), jnp.int32), jnp.zeros((2, nblk), jnp.int32), keys)
        wkeys = jnp.zeros((SLOTS,) + keys.shape[1:], jnp.uint32)
        lowered[(name, policy, "decode")] = jax.jit(
            lambda *a, jc=jc, jpc=jpc, params=params: JT.decode_step_paged(params, jc, jpc, *a)
        ).lower(cache, jnp.zeros((SLOTS,), jnp.int32), jnp.zeros((SLOTS,), jnp.int32),
                jnp.zeros((SLOTS, bps), jnp.int32), wkeys)
    jc, params, _ = served("llama4-5")
    Sd = PROMPT["llama4-5"]
    lowered[("dense", "forward")] = jax.jit(lambda t: JT.forward(params, jc, t)).lower(
        jnp.zeros((2, Sd), jnp.int32))
    lowered[("dense", "decode")] = jax.jit(
        lambda c, t, p: JT.decode_step(params, jc, c, t, p)).lower(
        JT.init_cache(jc, 2, Sd + WAVES), jnp.zeros((2,), jnp.int32), jnp.int32(0))
    with ThreadPoolExecutor(4) as pool:
        done = dict(zip(lowered, pool.map(
            lambda k: lowered[k].compile(compiler_options=FAST_COMPILE), lowered)))
    out = {case: (done[case + ("prefill",)], done[case + ("decode",)]) for case in PAGED}
    out["dense"] = (done[("dense", "forward")], done[("dense", "decode")])
    return out


def test_mixed_policy_stores_chunk_layers_as_int4():
    jc, tc = small_configs("llama4-5")
    assert K.layer_bit_policy(tc, "mixed") == JK.layer_bit_policy(jc, "mixed") == \
        (4, 4, 4, 8, 4)
    # the card's cut of the full config: one period of 4 layers
    cut = [dataclasses.replace(get(LLAMA4), num_layers=4, num_experts=16)
           for get in (get_config, jax_get_config)]
    assert K.layer_bit_policy(cut[0], "mixed") == JK.layer_bit_policy(cut[1], "mixed") == \
        (4, 4, 4, 8)
    pc = K.make_paged_cache_config(tc, "mixed", PAGE, 16, 4)
    jpc = JK.make_paged_cache_config(jc, "mixed", PAGE, 16, 4)
    assert [(s.start, s.n, s.quant.bits) for s in pc.segments] == \
        [(s.start, s.n, s.quant.bits) for s in jpc.segments]
    assert K.cache_bytes(pc) == JK.cache_bytes(jpc)


def _compare_arena(cache, jcache, pc, stats):
    """Payloads equal but for adjacent-level flips (counted); norms and fp32
    K/V within rtol 1e-5 / atol 1e-5 times the largest; returns the flipped
    coordinates' (name, index) list."""
    got = convert.arena_to_jax(cache)
    flips = []
    for name, want in jcache.items():
        want = np.asarray(want)
        if name.endswith("_payload"):
            bits = pc.segments[int(name[3:name.index("_")])].quant.bits
            a, b = _unpack(got[name], bits), _unpack(want, bits)
            assert np.all(np.abs(a - b)[a != b] == 1), name
            flips += [(name, tuple(i)) for i in np.argwhere(a != b)]
        else:
            np.testing.assert_allclose(got[name], want, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(want).max(), 1.0), err_msg=name)
    stats["flips"] += len(flips)
    return flips


@functools.lru_cache(maxsize=None)
def _prompt_kv_fn(name):
    jc, params, model = served(name)
    return jax.jit(lambda t: JT.forward_with_kv(params, jc, t))


def _prompt_kvs(name, toks):
    """Both packages' K/V of the prompts (the same under every policy)."""
    key = (name, toks.tobytes())
    if key not in _PROMPT_KVS:
        _, jkvs = _prompt_kv_fn(name)(jnp.asarray(toks))
        _, pkvs = T.forward_with_kv(served(name)[2], torch.from_numpy(toks).long())
        _PROMPT_KVS[key] = ([[np.asarray(a) for a in kv] for kv in jkvs],
                            [[a.numpy() for a in kv] for kv in pkvs])
    return _PROMPT_KVS[key]


_PROMPT_KVS: dict = {}


def _paged(name, policy, fns):
    """One paged prefill of two prompts, then WAVES packed waves with an idle
    third slot, both packages from the same arena each wave; ``fns`` the
    reference's compiled prefill and decode."""
    jc, params, model = served(name)
    pc, jpc, plen, nblk, bps, s_pad = _shapes(name, policy)
    n_layers = jc.num_layers
    jpre, jdec = fns
    quant = policy != "fp32"
    F = pc.feat_pad
    rng = np.random.RandomState(5)
    toks = np.zeros((2, s_pad), np.int32)
    toks[:, :plen] = rng.randint(0, jc.vocab_size, size=(2, plen))
    toks[1, plen // 2:plen] = toks[1, plen // 2]  # a run of one token crowds an expert
    pages = np.stack([np.arange(nblk), bps + np.arange(nblk)]).astype(np.int32)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(9),
                                                   jnp.arange(SLOTS, dtype=jnp.uint32))
    jcache0 = JK.init_paged_cache(jpc)
    cache = convert.arena_from_jax({k: np.asarray(v) for k, v in jcache0.items()}, "cpu")
    jlg, jcache = jpre(jcache0, jnp.asarray(toks), jnp.asarray(pages), keys[:2])
    draws = _jdraws(keys[:2], n_layers, (s_pad, F)) if quant else []
    noise = ReplayNoise(draws)
    lg, _ = T.prefill_paged(model, pc, cache, torch.from_numpy(toks).long(),
                            torch.from_numpy(pages).long(), K.SourceNoise(noise))
    assert noise.remaining == 0
    _close(lg.numpy(), jlg)
    stats = {"flips": 0, "coords": 0}
    flips = _compare_arena(cache, jcache, pc, stats)
    if quant:
        stats["coords"] += n_layers * 2 * 2 * s_pad * F
        if flips:  # each prefill flip: |r - xi_ref| below the xi difference
            jkvs, pkvs = _prompt_kvs(name, toks)
            for nm, (ls, page, off, col) in flips:
                l, tag = _layer_of(pc, nm, ls), 0 if "_k_" in nm else 1
                q = pc.segments[int(nm[3:nm.index("_")])].quant
                b, blk = np.argwhere(pages == page)[0]
                s = blk * PAGE + off
                xr = _xi(jkvs[l][tag][b, s][None], q)[0]
                xp = _xi(pkvs[l][tag][b, s][None], q)[0]
                assert abs(draws[2 * l + tag][b, s, col] - xr[col]) <= abs(xr[col] - xp[col])
    pt = np.full((SLOTS, bps), -1, np.int32)
    pt[0], pt[1] = np.arange(bps), bps + np.arange(bps)
    tok = np.zeros((SLOTS,), np.int32)
    tok[:2] = np.asarray(jnp.argmax(jlg[:, plen - 1], -1))
    for w in range(WAVES):
        pos = np.array([plen + w, plen + w, 0], np.int32)
        wk = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos))
        cache = convert.arena_from_jax({k: np.asarray(v) for k, v in jcache.items()}, "cpu")
        jlg, jcache = jdec(jcache, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(pt), wk)
        noise = ReplayNoise(_jdraws(wk, n_layers, (F,)) if quant else [])
        lg, _ = T.decode_step_paged(model, pc, cache, torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long(), torch.from_numpy(pt).long(),
                                    K.SourceNoise(noise))
        assert noise.remaining == 0
        _close(lg.numpy(), jlg)
        _compare_arena(cache, jcache, pc, stats)
        stats["coords"] += n_layers * 2 * 2 * F if quant else 0
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    assert stats["flips"] <= FLIP_SHARE * stats["coords"], stats


@pytest.mark.parametrize("policy", ["int8", "mixed", "fp32"])
def test_paged_prefill_and_decode_match_reference(policy, ref_fns, drops):
    _paged("llama4-5", policy, ref_fns[("llama4-5", policy)])
    # capacity bites: the padded prompts' and the 3-slot waves' (capacity 1)
    assert drops["prefill"] > 0 and drops["decode"] > 0, drops


def test_vlm_paged_int8_matches_reference(ref_fns):
    _paged("internvl2", "int8", ref_fns[("internvl2", "int8")])


def test_dense_decode_and_prefill_steps_match_reference(ref_fns, drops):
    jc, params, model = served("llama4-5")
    jfwd, jstep = ref_fns["dense"]
    rng = np.random.RandomState(6)
    Bd, Sd = 2, PROMPT["llama4-5"]
    total = Sd + WAVES
    toks = rng.randint(0, jc.vocab_size, size=(Bd, Sd)).astype(np.int32)
    toks[1, Sd // 2:] = toks[1, Sd // 2]  # a run of one token crowds an expert
    jlg, _ = jfwd(jnp.asarray(toks))
    _close(make_prefill_step(model)(torch.from_numpy(toks).long()).numpy(), jlg)
    jcache = JT.init_cache(jc, Bd, total)
    cache = T.init_cache(model.cfg, Bd, total, "cpu")
    serve = make_serve_step(model)
    tok = toks[:, 0]
    for t in range(total):
        jl, jcache = jstep(jcache, jnp.asarray(tok), jnp.int32(t))
        nxt, lg, cache = serve(cache, torch.from_numpy(tok).long(), t)
        _close(lg.numpy(), jl)
        jnxt = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(nxt.numpy(), jnxt)
        tok = toks[:, t + 1] if t + 1 < Sd else jnxt.astype(np.int32)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=1e-5,
                               atol=1e-5)
    assert drops["prefill"] > 0  # the 140-token prefill over 4 experts, capacity 44
