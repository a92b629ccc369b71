"""The port's toy-VI testbed (``repro_torch.core.vi``, the Q-GenX loop and
QSGDA of ``repro_torch.core.extragradient``) against the JAX reference on
the CPU, every reference draw replayed.

The reference's ``qgenx_step`` runs eagerly (op by op, as the port does);
each step's draws are recomputed from its keys (``split(key, 5)``, each
oracle and quantization key split K ways: Rademacher ``[d]`` oracle
signs and ``[rows, bucket]`` rounding noise) and replayed into the port
through ``ReplayNoise`` in the port's draw order (the module docstring of
``repro_torch.core.extragradient``).

Tolerances:

* the problems' M, q and z* are bit-equal (the same numpy calls);
* the oracles and the restricted gap: rtol 1e-6 and 1e-5 (the matvec's
  order of summation differs);
* per step, over 16 steps: x, y, sum_sq, x_avg and prev_half at rtol 1e-5
  with an atol floor of 1e-6 times the vector's largest magnitude (the
  matvec's order, and kernel 5's plain version against the reference's
  jnp quantize∘dequantize, which differ in ulps: ROADMAP C2; the dual
  accumulator Y reaches ~10 while a coordinate of it passes near 0, where
  one ulp of 10 is 0.02 % of it), ``t`` and ``bits_sent`` exactly;
* each QAda refresh: a valid table (ends 0 and 1, strictly increasing)
  whose QAda objective on the reference's histogram of the same duals is
  at most the reference table's times (1 + 2e-4).  The levels themselves
  are not held elementwise here: the duals differ from the reference's in
  ulps, so the histograms do, and where a bin range is empty the
  objective is flat and coordinate descent can settle a level on either
  side (4 of the 72 refreshes of this file move a level by more than
  9e-6, up to 0.18; the port's objective ranges from 26 % below the
  reference table's to 1.46e-4 above it).  ``tests/test_torch_qada.py``
  holds the solve elementwise on fixed histograms.  After each step the
  port's table is set to the reference's, so every later step is held
  given the reference's levels.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extragradient as jeg
from repro.core import vi as jvi
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.quantization import QuantConfig as JaxQuant
from repro_torch import convert
from repro_torch.core import extragradient as eg
from repro_torch.core import vi
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from repro_torch.core.quantization import QuantConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

K = 4


def _close(got, want, what):
    """rtol 1e-5 with an atol floor of 1e-6 times the vector's largest
    magnitude (at least 1e-6)."""
    want = np.asarray(want)
    floor = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=floor, err_msg=what)


@pytest.mark.parametrize("make", [lambda m: m.bilinear_saddle(d=16, seed=6),
                                  lambda m: m.bilinear_saddle(d=32, seed=4),
                                  lambda m: m.cocoercive_quadratic(d=32, seed=1)],
                         ids=["bilinear16", "bilinear32", "cocoercive32"])
def test_problems_oracles_and_gap_match(make):
    jp, tp = make(jvi), make(vi)
    for f in ("M", "q", "z_star"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    rng = np.random.RandomState(0)
    z = (jp.z_star + rng.randn(jp.dim)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    xi = np.asarray(jax.random.rademacher(key, (jp.dim,), dtype=jnp.float32))
    for jo, to in ((jvi.absolute_noise_oracle(jp, 0.5), vi.absolute_noise_oracle(tp, 0.5, "cpu")),
                   (jvi.relative_noise_oracle(jp, 0.2), vi.relative_noise_oracle(tp, 0.2, "cpu"))):
        want = np.asarray(jo(jnp.asarray(z), key))
        got = to(torch.from_numpy(z), ReplayNoise([xi])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vi.restricted_gap(tp, torch.from_numpy(z)),
                               jvi.restricted_gap(jp, jnp.asarray(z)), rtol=1e-5)
    np.testing.assert_allclose(float(vi.distance_to_solution(tp, torch.from_numpy(z))),
                               float(jvi.distance_to_solution(jp, jnp.asarray(z))), rtol=1e-6)


def _configs(kind):
    """(reference QGenXConfig kwargs, port kwargs) of one compressor arm."""
    if kind == "none":
        return {}, {}
    if kind == "layerwise":
        return (dict(exchange=JaxExchangeConfig(compressor="layerwise")),
                dict(exchange=ExchangeConfig(compressor="layerwise")))
    bits, s = (8, 15) if kind == "int8" else (4, 5)
    kw = dict(num_levels=s, bits=bits, bucket_size=64, q_norm=math.inf)
    return dict(quant=JaxQuant(**kw)), dict(quant=QuantConfig(**kw))


def _assert_levels_as_good(got, want, v, ex, what):
    """A refreshed table: valid, and no worse than the reference's on the
    QAda objective of the reference's histogram of the same duals."""
    from repro.core import adaptive_levels as jqada
    from repro.core.quantization import bucket_norms

    assert got[0] == 0.0 and got[-1] == 1.0 and np.all(np.diff(got) > 0), what
    q = ex.cfg.quant if ex.cfg.quant is not None else QuantConfig(num_levels=5, bits=4,
                                                                  bucket_size=512)
    v2d = jnp.asarray(v).reshape(-1, min(q.bucket_size, v.shape[-1]))
    hist = jqada.normalized_coord_histogram(v2d, bucket_norms(v2d, q.q_norm), ex.cfg.qada_bins)
    f_got = float(jqada.expected_variance(jnp.asarray(got), hist))
    f_want = float(jqada.expected_variance(jnp.asarray(want), hist))
    assert f_got <= f_want * (1 + 2e-4), (what, f_got, f_want, np.abs(got - want).max())


def _step_draws(key, method, d, rows, bucket, quantized):
    """The reference step's draws in the port's order."""
    k_q1, k_q2, k_o1, k_o2, _ = jax.random.split(key, 5)
    rounds = [(k_o2, k_q2)] if method in ("da", "optda") else [(k_o1, k_q1), (k_o2, k_q2)]
    out = []
    for ko, kq in rounds:
        out += [np.asarray(jax.random.rademacher(k, (d,), dtype=jnp.float32))
                for k in jax.random.split(ko, K)]
        if quantized:
            out += [np.asarray(jax.random.uniform(k, (rows, bucket)))
                    for k in jax.random.split(kq, K)]
    return out


@pytest.mark.parametrize("kind,every", [("none", 0), ("int8", 0), ("int8", 2), ("int4", 0),
                                        ("int4", 2), ("layerwise", 0), ("layerwise", 2)])
@pytest.mark.parametrize("method", ["da", "de", "optda"])
def test_qgenx_steps_match_reference(method, kind, every):
    """16 steps of ``qgenx_step`` on bilinear_saddle(d=16) (32 operator
    coordinates) with absolute noise, every state field held per step
    (full precision has no level table, so no QAda case)."""
    jp, tp = jvi.bilinear_saddle(d=16, seed=6), vi.bilinear_saddle(d=16, seed=6)
    jkw, tkw = _configs(kind)
    jcfg = jeg.QGenXConfig(variant=method, num_workers=K, level_update_every=every, **jkw)
    tcfg = eg.QGenXConfig(variant=method, num_workers=K, level_update_every=every, **tkw)
    joracle = jvi.absolute_noise_oracle(jp, 0.5)
    toracle = vi.absolute_noise_oracle(tp, 0.5, "cpu")
    x0 = (jp.z_star + 1.0).astype(np.float32)
    jst = jeg.qgenx_init(jnp.asarray(x0), jcfg)
    tst = eg.qgenx_init(torch.from_numpy(x0), tcfg, "cpu")
    ex = tcfg.make_exchange()
    d = jp.dim
    bucket = ex.plan_for([torch.zeros(d)], "compress", 1).segments[0].quant.bucket_size \
        if ex is not None else 1
    rows = -(-d // bucket)
    for t, key in enumerate(jax.random.split(jax.random.PRNGKey(11), 16)):
        jst = jeg.qgenx_step(jst, joracle, key, jcfg)
        noise = ReplayNoise(_step_draws(key, method, d, rows, bucket, ex is not None))
        tst = eg.qgenx_step(tst, toracle, noise, tcfg, ex)
        assert noise.remaining == 0
        for f in ("x", "y", "sum_sq", "x_avg", "prev_half"):
            _close(getattr(tst, f), getattr(jst, f), f"{f} at step {t}")
        assert tst.t == int(jst.t) == t + 1
        assert float(tst.bits_sent) == float(jst.bits_sent)
        if every and t % every == every - 1:
            _assert_levels_as_good(tst.levels.numpy(), np.asarray(jst.levels), jst.prev_half,
                                   ex, f"levels at step {t}")
        tst.levels = torch.from_numpy(np.array(jst.levels))
    if every:
        uniform = np.linspace(0, 1, tst.levels.shape[0], dtype=np.float32)
        assert not np.allclose(tst.levels.numpy(), uniform, atol=1e-4)


@pytest.mark.parametrize("quant", [None, (8, 15)], ids=["fp32", "uq8"])
def test_qsgda_matches_reference(quant):
    jp, tp = jvi.bilinear_saddle(d=16, seed=6), vi.bilinear_saddle(d=16, seed=6)
    kw = None if quant is None else dict(num_levels=quant[1], bits=quant[0], bucket_size=64)
    jq, tq = (None, None) if kw is None else (JaxQuant(**kw), QuantConfig(**kw))
    x0 = (jp.z_star + 1.0).astype(np.float32)
    T, key = 16, jax.random.PRNGKey(5)
    jx, javg = jeg.qsgda_run(jnp.asarray(x0), jvi.absolute_noise_oracle(jp, 0.1), key, T,
                             num_workers=K, lr=0.05, quant=jq)
    draws = []
    for k in jax.random.split(key, T):
        ko, kq = jax.random.split(k)
        draws += [np.asarray(jax.random.rademacher(kk, (jp.dim,), dtype=jnp.float32))
                  for kk in jax.random.split(ko, K)]
        if jq is not None:
            draws += [np.asarray(jax.random.uniform(kk, (1, 64))) for kk in jax.random.split(kq, K)]
    noise = ReplayNoise(draws)
    tx, tavg = eg.qsgda_run(torch.from_numpy(x0), vi.absolute_noise_oracle(tp, 0.1, "cpu"),
                            noise, T, num_workers=K, lr=0.05, device="cpu", quant=tq)
    assert noise.remaining == 0
    _close(tx, jx, "last iterate")
    _close(tavg, javg, "ergodic average")


def test_qgenx_state_converts_both_ways():
    """``convert`` carries the toy loop's state into the reference's
    ``QGenXState`` (numpy leaves, ``t`` int32) and back, leaf for leaf; the
    reference steps on from it as from its own."""
    tp = vi.bilinear_saddle(d=16, seed=6)
    cfg = eg.QGenXConfig(variant="de", num_workers=K,
                         quant=QuantConfig(num_levels=7, bits=8, bucket_size=64),
                         level_update_every=2)
    x0 = torch.from_numpy(tp.z_star.astype(np.float32)) + 1.0
    st = eg.qgenx_run(x0, vi.absolute_noise_oracle(tp, 0.5, "cpu"), cfg,
                      GeneratorNoise.seeded(0, "cpu"), 4, "cpu")
    arrs = convert.qgenx_state_to_jax(st)
    jst = jeg.QGenXState(*(jnp.asarray(getattr(arrs, f)) for f in convert._QGENX_FIELDS))
    assert jst.t.dtype == jnp.int32 and int(jst.t) == 4
    back = convert.qgenx_state_from_jax(jst, "cpu")
    assert back.t == 4
    for f in convert._QGENX_FIELDS:
        if f != "t":
            assert torch.equal(getattr(back, f), getattr(st, f)), f
    jcfg = jeg.QGenXConfig(variant="de", num_workers=K, level_update_every=2,
                           quant=JaxQuant(num_levels=7, bits=8, bucket_size=64))
    nxt = jeg.qgenx_step(jst, jvi.absolute_noise_oracle(jvi.bilinear_saddle(d=16, seed=6), 0.5),
                         jax.random.PRNGKey(0), jcfg)
    assert int(nxt.t) == 5 and np.all(np.isfinite(np.asarray(nxt.x)))
