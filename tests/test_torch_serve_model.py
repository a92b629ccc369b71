"""The port's decode paths (``repro_torch.models.transformer``: the paged
``prefill_paged`` / ``decode_step_paged`` and the dense ``init_cache`` /
``decode_step``, ``launch.steps.make_prefill_step`` / ``make_serve_step``)
against the reference's, reduced tinyllama-1.1b (f32), the same params.

* Paged, at int8 / int4 / fp32: a prefill of two 8-token prompts, then 4
  packed decode waves with a third, inactive slot (-1 row), every cache
  draw of the reference replayed.  Each wave starts both packages from the
  same arena (the reference's, converted).  Logits: rtol 1e-5, atol 1e-6.
  Payloads: equal except stochastic-rounding flips, each one level apart,
  at most 1e-4 of the coordinates written (ROADMAP C2: the frameworks'
  K/V differ in the last bits); at the prefill, each flip must also sit
  where the reference's own ``|r - xi|`` is below the two packages' ``xi``
  difference.  Norms: rtol 1e-6.
* The dense decode: ``make_serve_step`` against the reference's
  ``decode_step`` token by token (logits rtol 1e-5, atol 1e-6; tokens
  equal), ``make_prefill_step`` against ``forward``.
* Inside the port: fp32 paged decode equals the dense ``decode_step``
  (atol 1e-5), and ``forward_with_kv`` gives the K/V the dense loop writes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.kv_cache as JK
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.core.noise import ReplayNoise
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as K

from _torch_serve_common import port_model, reference_params
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, S, WAVES, PAGE = 3, 8, 4, 4
RTOL, ATOL = 1e-5, 1e-6
FLIP_SHARE = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg, params = reference_params()
    return cfg, jax.tree_util.tree_map(jnp.asarray, params), port_model(params)


def _fold_rows(keys, x):
    return jax.vmap(jax.random.fold_in, (0, None))(keys, x)


def _draws(keys, L, shape):
    """The reference's write draws, per layer K then V (keys [rows])."""
    out = []
    for l in range(L):
        lk = _fold_rows(keys, l)
        out += [np.asarray(jax.vmap(lambda k: jax.random.uniform(
            jax.random.fold_in(k, t), shape))(lk)) for t in (0, 1)]
    return out


def _xi(x, quant):
    """The reference's rounding threshold of each coordinate (per token)."""
    x = np.asarray(x, np.float32).reshape(-1, x.shape[-2] * x.shape[-1])
    norms = np.abs(x).max(axis=-1, keepdims=True)
    u = np.clip(np.abs(x) / np.where(norms > 0, norms, 1), 0, 1)
    lv = np.linspace(np.float32(0), np.float32(1), quant.num_levels + 2, dtype=np.float32)
    tau = np.clip(np.searchsorted(lv, u, side="right") - 1, 0, len(lv) - 2)
    return (u - lv[tau]) / (lv[tau + 1] - lv[tau])


def _unpack(a, bits):
    a = np.asarray(a)
    if bits == 8:
        return a.astype(np.int32)
    u = a.view(np.uint8).astype(np.int32)
    lo, hi = u & 0xF, (u >> 4) & 0xF
    lo, hi = np.where(lo >= 8, lo - 16, lo), np.where(hi >= 8, hi - 16, hi)
    return np.stack([lo, hi], -1).reshape(*a.shape[:-1], -1)


def _compare_arena(cache, jcache, pc, stats):
    """Payloads equal but for adjacent-level flips (counted); norms and fp32
    K/V close; returns the flipped coordinates' (name, index) list."""
    got = convert.arena_to_jax(cache)
    flips = []
    for name, want in jcache.items():
        want = np.asarray(want)
        if name.endswith("_payload"):
            bits = pc.segments[0].quant.bits
            a, b = _unpack(got[name], bits), _unpack(want, bits)
            diff = np.argwhere(a != b)
            assert np.all(np.abs(a - b)[a != b] == 1), name
            flips += [(name, tuple(i)) for i in diff]
        else:
            np.testing.assert_allclose(got[name], want, rtol=1e-6, atol=1e-6, err_msg=name)
    stats["flips"] += len(flips)
    return flips


@pytest.mark.parametrize("policy", ["int8", "int4", "fp32"])
def test_paged_prefill_and_decode_match_reference(setup, policy):
    jcfg, params, model = setup
    L = jcfg.num_layers
    pc = K.make_paged_cache_config(model.cfg, policy, PAGE, 12, 4)
    jpc = JK.make_paged_cache_config(jcfg, policy, PAGE, 12, 4)
    quant = pc.segments[0].quant
    F = pc.feat_pad
    rng = np.random.RandomState(5)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, S)).astype(np.int32)
    pages = np.array([[0, 1], [4, 5]], np.int32)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(9),
                                                   jnp.arange(B, dtype=jnp.uint32))
    jcache0 = JK.init_paged_cache(jpc)
    cache = convert.arena_from_jax({k: np.asarray(v) for k, v in jcache0.items()}, "cpu")
    jpre = jax.jit(lambda c, t, p, k: JT.prefill_paged(params, jcfg, jpc, c, t, p, k))
    jlg, jcache = jpre(jcache0, jnp.asarray(toks), jnp.asarray(pages), keys[:2])
    noise = ReplayNoise(_draws(keys[:2], L, (S, F)) if quant else [])
    lg, _ = T.prefill_paged(model, pc, cache, torch.from_numpy(toks).long(),
                            torch.from_numpy(pages).long(), K.SourceNoise(noise))
    assert noise.remaining == 0
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=RTOL, atol=ATOL)
    stats = {"flips": 0, "coords": 0}
    flips = _compare_arena(cache, jcache, pc, stats)
    if quant:
        stats["coords"] += L * 2 * 2 * S * F
        if flips:  # each prefill flip: |r - xi_ref| below the xi difference
            _, jkvs = JT.forward_with_kv(params, jcfg, jnp.asarray(toks))
            _, pkvs = T.forward_with_kv(model, torch.from_numpy(toks).long())
            draws = _draws(keys[:2], L, (S, F))
            for name, (l, page, off, col) in flips:
                tag = 0 if "_k_" in name else 1
                b, blk = np.argwhere(pages == page)[0]
                s = blk * PAGE + off
                xr = _xi(np.asarray(jkvs[l][tag])[b, s][None], quant)[0]
                xp = _xi(pkvs[l][tag].numpy()[b, s][None], quant)[0]
                assert abs(draws[2 * l + tag][b, s, col] - xr[col]) <= abs(xr[col] - xp[col])
    # decode waves: slots 0, 1 active at pos 8.., slot 2 inactive
    pt = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [-1, -1, -1, -1]], np.int32)
    tok = np.zeros((B,), np.int32)
    tok[:2] = np.asarray(jnp.argmax(jlg[:, -1], -1))
    jdec = jax.jit(lambda c, t, p, ptab, wk: JT.decode_step_paged(params, jcfg, jpc, c, t, p,
                                                                  ptab, wk))
    for w in range(WAVES):
        pos = np.array([S + w, S + w, 0], np.int32)
        wk = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos))
        cache = convert.arena_from_jax({k: np.asarray(v) for k, v in jcache.items()}, "cpu")
        jlg, jcache = jdec(jcache, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(pt), wk)
        noise = ReplayNoise(_draws(wk, L, (F,)) if quant else [])
        lg, _ = T.decode_step_paged(model, pc, cache, torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long(), torch.from_numpy(pt).long(),
                                    K.SourceNoise(noise))
        assert noise.remaining == 0
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=RTOL, atol=ATOL)
        _compare_arena(cache, jcache, pc, stats)
        stats["coords"] += L * 2 * 2 * F if quant else 0
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    assert stats["flips"] <= FLIP_SHARE * stats["coords"], stats


def test_dense_decode_and_prefill_steps_match_reference(setup):
    jcfg, params, model = setup
    rng = np.random.RandomState(6)
    Bd, Sd = 2, 6
    toks = rng.randint(0, jcfg.vocab_size, size=(Bd, Sd)).astype(np.int32)
    jlg, _ = JT.forward(params, jcfg, jnp.asarray(toks))
    lg = make_prefill_step(model)(torch.from_numpy(toks).long())
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=RTOL, atol=ATOL)
    jstep = jax.jit(lambda c, t, p: JT.decode_step(params, jcfg, c, t, p))
    jcache = JT.init_cache(jcfg, Bd, Sd + 3)
    cache = T.init_cache(model.cfg, Bd, Sd + 3, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    serve = make_serve_step(model)
    tok = toks[:, 0]
    for t in range(Sd + 3):
        jl, jcache = jstep(jcache, jnp.asarray(tok), jnp.int32(t))
        nxt, l, cache = serve(cache, torch.from_numpy(tok).long(), t)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
        jnxt = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(nxt.numpy(), jnxt)
        tok = toks[:, t + 1] if t + 1 < Sd else jnxt.astype(np.int32)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=1e-5,
                               atol=1e-6)


def test_fp32_paged_equals_dense_decode_in_the_port(setup):
    _, _, model = setup
    cfg = model.cfg
    rng = np.random.RandomState(7)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(2, S))).long()
    pc = K.make_paged_cache_config(cfg, "fp32", PAGE, 8, 4)
    pt = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]])
    lg_fwd = model(toks)
    lg_kv, kvs = T.forward_with_kv(model, toks)
    torch.testing.assert_close(lg_kv, lg_fwd, rtol=0, atol=0)
    dense = T.init_cache(cfg, 2, S + 4, "cpu")
    for t in range(S):
        lg_d, dense = T.decode_step(model, dense, toks[:, t], t)
    for l in range(cfg.num_layers):
        torch.testing.assert_close(dense["k"][l][:, :S], kvs[l][0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dense["v"][l][:, :S], kvs[l][1], rtol=1e-5, atol=1e-5)
    lgp, pcache = T.prefill_paged(model, pc, K.init_paged_cache(pc, "cpu"), toks, pt[:, :2],
                                  None)
    torch.testing.assert_close(lgp, lg_fwd, rtol=0, atol=0)
    nxt = torch.argmax(lg_d, -1)
    for t in range(S, S + 4):
        lg_p, _ = T.decode_step_paged(model, pc, pcache, nxt, torch.full((2,), t), pt, None)
        lg_d, _ = T.decode_step(model, dense, nxt, t)
        torch.testing.assert_close(lg_p, lg_d, rtol=1e-5, atol=1e-5)
        nxt = torch.argmax(lg_d, -1)
