"""QAda (``repro_torch.core.adaptive_levels``), the flat quantizer of
``repro_torch.core.quantization`` and the QAda exchange against the JAX
reference on the CPU, inputs made with numpy from a seed.

Tolerances:

* ``normalized_coord_histogram``: rtol 1e-5 (the port adds exact counts
  times f32 norm^2 in f64, the reference scatter-adds in f32);
* ``optimize_levels`` at the exchange's solve (2 sweeps of 20 bisection
  steps) on the reference's own histograms: levels atol 2e-5 (measured
  up to 8.1e-6: the port sums the histogram's prefix and fuses
  ``_interp``'s multiply-add as XLA's CPU code does, yet a bisection step
  whose g(mid) is a few ulps from 0 can still go the other way) where the
  histogram's mass reaches u = 1 (q = inf); where it ends below 1 (q = 2
  over 256-wide buckets), the objective is flat above its top and a level
  there may settle anywhere in the empty range (the port's top eight
  levels of the Gaussian s = 15 case sit at 0.5625, the reference's at
  0.2363, with the same objective), so only the objective is held;
  ``expected_variance`` rtol 1e-5, ``symbol_probabilities`` rtol 1e-5
  (atol 1e-7) and summing to 1 within 1e-6; ``gradient_descent_levels``
  atol 1e-5;
* the flat quantizer with the reference's noise replayed: payload bytes
  and norms bit-exact, dequantized f32 rtol 1e-6 (``quantize_dequantize``
  runs kernel 5's plain version, which differs from the reference's jnp
  composite in ulps: ROADMAP C2); ``theorem1_epsilon_q`` equal;
* the degenerate table an all-zero histogram solves to (levels 1e-6
  apart) passes ``validate_levels`` and kernels 1, 2 and 5's plain
  versions take it, payload bit-exact against the reference's quantize.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive_levels as jqada
from repro.core import quantization as jq
from repro_torch.core import adaptive_levels as qada
from repro_torch.core import quantization as tq
from repro_torch.core.exchange import (
    ExchangeConfig,
    make_exchange,
    wire_trace_start,
    wire_trace_stop,
)
from repro_torch.core.noise import ReplayNoise
from repro_torch.kernels import ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BINS = 512


def _inputs(name, rng):
    """[nb, bucket] f32 test inputs."""
    if name == "gauss":
        return rng.randn(64, 256)
    if name == "zero_rows":
        v = rng.randn(16, 130)
        v[[0, 5, 11]] = 0.0
        return v
    if name == "bucket130":
        return rng.standard_t(3, size=(40, 130))
    if name == "uniform":
        return rng.rand(32, 64)
    if name == "spike":
        return np.concatenate([np.zeros(129), [3.0]] * 4).reshape(4, 130)
    if name == "zero":
        return np.zeros((8, 130))
    raise KeyError(name)


def _hist_pair(name, q, bins=BINS):
    v = _inputs(name, np.random.RandomState(0)).astype(np.float32)
    n = np.asarray(jq.bucket_norms(jnp.asarray(v), q))
    want = np.asarray(jqada.normalized_coord_histogram(jnp.asarray(v), jnp.asarray(n), bins))
    got = qada.normalized_coord_histogram(torch.from_numpy(v), torch.from_numpy(n.copy()),
                                          bins).numpy()
    return got, want


@pytest.mark.parametrize("q", [math.inf, 2.0], ids=["qinf", "q2"])
@pytest.mark.parametrize("name", ["gauss", "zero_rows", "bucket130", "zero"])
def test_histogram_matches_reference(name, q):
    got, want = _hist_pair(name, q)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    got2048, want2048 = _hist_pair(name, q, 2048)
    np.testing.assert_allclose(got2048, want2048, rtol=1e-5, atol=0)


def test_histogram_chunks_agree(monkeypatch):
    v = torch.from_numpy(_inputs("gauss", np.random.RandomState(1)).astype(np.float32))
    n = tq.bucket_norms(v, math.inf)
    whole = qada.normalized_coord_histogram(v, n, BINS)
    monkeypatch.setattr(qada, "HIST_CHUNK_CELLS", 7 * BINS)  # chunks of 7 rows
    assert torch.equal(qada.normalized_coord_histogram(v, n, BINS), whole)


@pytest.mark.parametrize("s", [1, 5, 15])
@pytest.mark.parametrize("name,q", [("gauss", math.inf), ("gauss", 2.0), ("uniform", math.inf),
                                    ("spike", math.inf), ("zero", math.inf)])
def test_optimize_levels_matches_reference(name, q, s):
    _, hist = _hist_pair(name, q)
    lv0 = jq.uniform_levels(s)
    want = np.asarray(jqada.optimize_levels(lv0, jnp.asarray(hist), sweeps=2, bisect_iters=20))
    got = qada.optimize_levels(torch.from_numpy(np.asarray(lv0)), torch.from_numpy(hist),
                               sweeps=2, bisect_iters=20)
    if q == math.inf:  # the mass reaches u = 1: every level is pinned
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    tq.validate_levels(got, s)
    th = torch.from_numpy(hist)
    np.testing.assert_allclose(float(qada.expected_variance(got, th)),
                               float(jqada.expected_variance(jnp.asarray(want), jnp.asarray(hist))),
                               rtol=1e-5)
    p = qada.symbol_probabilities(torch.from_numpy(want), th)
    np.testing.assert_allclose(p.numpy(), np.asarray(jqada.symbol_probabilities(
        jnp.asarray(want), jnp.asarray(hist))), rtol=1e-5, atol=1e-7)
    if hist.sum() > 0:
        assert abs(float(p.sum()) - 1.0) < 1e-6


def test_all_zero_histogram_collapses_to_a_valid_table_the_kernels_take():
    """The degenerate solve (levels 1e-6 apart near 0) is a table every
    kernel's plain version takes, equal to the reference's quantize."""
    s = 15
    lv = qada.optimize_levels(tq.uniform_levels(s, "cpu"), torch.zeros(BINS), 2, 20)
    tq.validate_levels(lv, s)
    assert float(lv[s]) < 1e-4  # every interior level sits near 0
    rng = np.random.RandomState(2)
    x = (rng.randn(6, 256) * rng.rand(6, 1) ** 8).astype(np.float32)
    cfg = jq.QuantConfig(num_levels=s, bucket_size=256)
    # the reference draws its own noise: replay it into the plain kernels
    key = jax.random.PRNGKey(4)
    want = jq.quantize(jnp.asarray(x.reshape(-1)), jnp.asarray(lv.numpy()), key, cfg)
    r = np.asarray(jax.random.uniform(key, (6, 256)))
    payload, norms = ref.quantize_blocks_plain(torch.from_numpy(x), torch.from_numpy(r), lv,
                                               num_symbols=s + 2, q_is_inf=True, bits=8)
    np.testing.assert_array_equal(payload.reshape(-1).numpy(), np.asarray(want.payload))
    np.testing.assert_array_equal(norms.numpy(), np.asarray(want.norms))
    idx, _ = ref.dequant_reduce_requantize_blocks_plain(
        payload[None], norms[None], lv, torch.from_numpy(r), num_symbols=s + 2,
        q_is_inf=True, bits=8)
    assert idx.shape == payload.shape
    hat = ref.quantize_dequantize_segments_plain(
        torch.from_numpy(x), torch.from_numpy(r), lv[None], torch.zeros(6, dtype=torch.int32),
        num_symbols=(s + 2,), q_is_inf=True)
    np.testing.assert_allclose(hat.numpy().reshape(-1), np.asarray(jq.dequantize(
        want, jnp.asarray(lv.numpy()), cfg)), rtol=1e-6, atol=0)


def test_gradient_descent_levels_matches_reference():
    _, hist = _hist_pair("gauss", math.inf)
    lv0 = jq.uniform_levels(5)
    want = np.asarray(jqada.gradient_descent_levels(lv0, jnp.asarray(hist), steps=200, lr=0.05))
    got = qada.gradient_descent_levels(torch.from_numpy(np.asarray(lv0)), torch.from_numpy(hist),
                                       steps=200, lr=0.05)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The flat quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stochastic", [True, False], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("bits,s,q", [(8, 15, math.inf), (4, 5, math.inf), (8, 7, 2.0)])
def test_flat_quantizer_matches_reference(bits, s, q, stochastic):
    rng = np.random.RandomState(bits + s)
    v = (rng.randn(1000) * 3).astype(np.float32)
    kw = dict(num_levels=s, bits=bits, bucket_size=256, q_norm=q, stochastic=stochastic)
    jcfg, tcfg = jq.QuantConfig(**kw), tq.QuantConfig(**kw)
    jlv = jq.exponential_levels(s) if q == 2.0 else jq.uniform_levels(s)
    tlv = torch.from_numpy(np.asarray(jlv))
    key = jax.random.PRNGKey(7)
    draws = [np.asarray(jax.random.uniform(key, (4, 256)))] if stochastic else []
    want = jq.quantize(jnp.asarray(v), jlv, key, jcfg)
    got = tq.quantize(torch.from_numpy(v), tlv, ReplayNoise(draws), tcfg)
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    np.testing.assert_array_equal(got.norms.numpy(), np.asarray(want.norms))
    assert got.n == want.n and got.wire_bytes() == want.wire_bytes()
    np.testing.assert_allclose(tq.dequantize(got, tlv, tcfg).numpy(),
                               np.asarray(jq.dequantize(want, jlv, jcfg)), rtol=1e-6, atol=0)
    hat = tq.quantize_dequantize(torch.from_numpy(v), tlv, ReplayNoise(draws), tcfg)
    np.testing.assert_allclose(hat.numpy(), np.asarray(jq.quantize_dequantize(
        jnp.asarray(v), jlv, key, jcfg)), rtol=1e-6, atol=0)
    u = torch.from_numpy(rng.rand(4, 256).astype(np.float32))
    np.testing.assert_array_equal(
        tq._stochastic_round_indices(u, tlv, ReplayNoise(draws), stochastic).numpy(),
        np.asarray(jq._stochastic_round_indices(jnp.asarray(u.numpy()), jlv, key, stochastic)))


def test_pytree_forms_and_theorem1_match_reference():
    rng = np.random.RandomState(3)
    tree = {"w": rng.randn(33, 17).astype(np.float32), "b": [rng.randn(300).astype(np.float32)]}
    cfg_kw = dict(num_levels=15, bits=8, bucket_size=128)
    jcfg, tcfg = jq.QuantConfig(**cfg_kw), tq.QuantConfig(**cfg_kw)
    jlv = jq.uniform_levels(15)
    tlv = torch.from_numpy(np.asarray(jlv))
    key = jax.random.PRNGKey(9)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    leaves = jax.tree_util.tree_leaves(jtree)
    draws = [np.asarray(jax.random.uniform(k, (-(-l.size // 128), 128)))
             for k, l in zip(jax.random.split(key, len(leaves)), leaves)]
    jqt = jq.quantize_pytree(jtree, jlv, key, jcfg)
    tqt = tq.quantize_pytree(ttree, tlv, ReplayNoise(draws), tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(tqt["b"]) + [tqt["w"]],
                    [jqt["b"][0], jqt["w"]]):
        np.testing.assert_array_equal(a.payload.numpy(), np.asarray(b.payload))
    shapes = {"w": (33, 17), "b": [(300,)]}
    back = tq.dequantize_pytree(tqt, shapes, tlv, tcfg)
    jback = jq.dequantize_pytree(jqt, jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jtree), jlv, jcfg)
    np.testing.assert_allclose(back["w"].numpy(), np.asarray(jback["w"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(back["b"][0].numpy(), np.asarray(jback["b"][0]), rtol=1e-6, atol=0)
    qd = tq.quantize_dequantize_pytree(ttree, tlv, ReplayNoise(draws), tcfg)
    jqd = jq.quantize_dequantize_pytree(jtree, jlv, key, jcfg)
    np.testing.assert_allclose(qd["w"].numpy(), np.asarray(jqd["w"]), rtol=1e-6, atol=0)
    for lv in (jq.uniform_levels(15), jq.exponential_levels(7), jq.uniform_levels(1)):
        for d, qn in ((1024, math.inf), (64, 2.0), (10**6, 2.0)):
            assert tq.theorem1_epsilon_q(torch.from_numpy(np.asarray(lv)), d, qn) == \
                jq.theorem1_epsilon_q(np.asarray(lv), d, qn)
    v = torch.from_numpy(rng.randn(512).astype(np.float32))
    trials = [np.asarray(jax.random.uniform(k, (4, 128))) for k in jax.random.split(key, 8)]
    got = tq.empirical_variance_multiplier(v, tlv, tcfg, ReplayNoise(trials), trials=8)
    want = jq.empirical_variance_multiplier(jnp.asarray(v.numpy()), jlv, jcfg, key, trials=8)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# The QAda exchange: cadence, wire, failures
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    return {"a": torch.from_numpy((rng.randn(40, 30) * scale).astype(np.float32)),
            "b": [torch.from_numpy((rng.randn(700) * scale).astype(np.float32))]}


@pytest.mark.parametrize("compressor", ["qgenx", "layerwise"])
def test_exchange_cadence_counts_calls(compressor):
    """Statistics accumulate on every call; the call that completes a
    period refreshes every table the compressor carries and zeroes the
    histogram; the histogram is a recorded collective operand billed at
    4 * qada_bins bytes a call."""
    quant = tq.QuantConfig(num_levels=15, bits=8, bucket_size=256) if compressor == "qgenx" \
        else None
    ex = make_exchange(ExchangeConfig(compressor=compressor, quant=quant,
                                      level_schedule="qada", level_update_every=3,
                                      layerwise_threshold=1000))
    st = ex.init_state("cpu")
    assert st.hist.shape == (512,) and float(st.hist.sum()) == 0.0
    rng = np.random.RandomState(0)
    want_hist = torch.zeros(512)
    tables = [(st.levels.clone(), st.levels_lo.clone())]
    for call in range(6):
        tree = _tree(rng, 10.0 ** -call)
        wire_trace_start()
        _, st = ex.pmean_tree(tree, st, ReplayNoise([rng.rand(*shape).astype(np.float32)
                                                     for shape in _draw_shapes(ex, tree)]))
        rec = wire_trace_stop()
        assert rec[-1] == ("qada_hist", 4 * 512)
        assert sum(b for _, b in rec) == ex.wire_bytes_tree(tree, 1)
        assert st.step == call + 1
        want_hist = want_hist + ex._tree_hist([tree["a"], tree["b"][0]])
        if call % 3 == 2:
            assert float(st.hist.abs().sum()) == 0.0
            assert not torch.equal(st.levels, tables[-1][0])
            if compressor == "layerwise":
                assert not torch.equal(st.levels_lo, tables[-1][1])
            tq.validate_levels(st.levels, st.levels.shape[0] - 2)
            tables.append((st.levels.clone(), st.levels_lo.clone()))
            want_hist = torch.zeros(512)
        else:
            torch.testing.assert_close(st.hist, want_hist, rtol=1e-6, atol=0)
            assert torch.equal(st.levels, tables[-1][0])


def _draw_shapes(ex, tree):
    """[rows, bucket] of each draw one pmean_tree asks for at K = 1."""
    plan = ex.plan_for([tree["a"], tree["b"][0]])
    out = []
    for seg in plan.segments:
        b = seg.quant.bucket_size
        out += [(seg.padded // b, b), (seg.padded // b, b)]
    return out


def test_non_finite_histogram_raises():
    ex = make_exchange(ExchangeConfig(quant=tq.QuantConfig(num_levels=15, bucket_size=256),
                                      level_schedule="qada", level_update_every=1))
    st = ex.init_state("cpu")
    tree = {"a": torch.full((300,), float("nan"))}
    with pytest.raises(ValueError, match="QAda histogram is not finite"):
        ex.pmean_tree(tree, st, ReplayNoise([np.zeros((2, 256), np.float32)] * 2))
    with pytest.raises(ValueError, match="not finite"):
        ex.qada_propose(st.levels, torch.full((4, 64), float("inf")))


def test_qada_propose_matches_reference():
    from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
    from repro.core.exchange import make_exchange as jax_make_exchange

    v = np.random.RandomState(5).randn(4, 64).astype(np.float32)
    kw = dict(num_levels=7, bucket_size=64)
    jex = jax_make_exchange(JaxExchangeConfig(compressor="qgenx", quant=jq.QuantConfig(**kw)))
    tex = make_exchange(ExchangeConfig(compressor="qgenx", quant=tq.QuantConfig(**kw)))
    lv = jq.uniform_levels(7)
    want = np.asarray(jex.qada_propose(lv, jnp.asarray(v)))
    got = tex.qada_propose(torch.from_numpy(np.asarray(lv)), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert not np.allclose(want, np.asarray(lv), atol=1e-4)
