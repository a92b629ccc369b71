"""Kernel 5 (segment-fused quantize∘dequantize) and the compress dispatch
against the JAX reference, on the CPU.

* The plain version ``quantize_dequantize_segments_plain`` (what a CPU
  tensor takes, and the oracle of the CUDA kernel) against the reference
  row math ``segment_quant_dequant_rows`` and against the Pallas kernel
  ``quantize_dequantize_segments(interpret=True)``, with the same noise,
  over T in {1, 2, 3} tables with mixed symbol counts, q in {inf, 2},
  stochastic and nearest rounding, an odd row count (the Pallas grid pads
  to 8 rows), zero rows and a row holding a NaN.  q = inf is held bit for
  bit (NaN where the reference has NaN).  q = 2 is held to rtol 1e-6: the
  L^2 norm is a sum whose order differs between the frameworks, which can
  move the norm by an ulp.
* ``stack_level_tables`` and ``fused_compress`` against the reference for
  the same noise (replayed in the order the port asks for it), including a
  plan with three row geometries (two bucket sizes, two norms), where the
  reference keys each class with ``fold_in(key, class)``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exchange_plan as jplan
from repro.core.quantization import QuantConfig as JaxQuant
from repro.core.quantization import exponential_levels as jax_exp_levels
from repro.core.quantization import uniform_levels as jax_levels
from repro.kernels.common import segment_quant_dequant_rows as jax_rows
from repro.kernels.segment_quantize import quantize_dequantize_segments as pallas_qdq
from repro_torch.core import exchange_plan as tplan
from repro_torch.core.noise import ReplayNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.ref import quantize_dequantize_segments_plain
from repro_torch.kernels.segment_quantize import quantize_dequantize_segments

NB, BUCKET = 37, 128
TABLES = [np.asarray(jax_levels(15)), np.asarray(jax_levels(5)),
          np.asarray(jax_exp_levels(3))]  # 17, 7 and 5 symbols


def _case(T, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(NB, BUCKET) * rng.uniform(0.01, 5.0, (NB, 1))).astype(np.float32)
    x[0] = 0.0
    x[17] = 0.0
    x[5, 9] = np.nan
    noise = rng.rand(NB, BUCKET).astype(np.float32)
    seg = rng.randint(0, T, NB).astype(np.int32)
    stacked, num_symbols = jplan.stack_level_tables([jnp.asarray(t) for t in TABLES[:T]])
    return x, noise, np.array(stacked), seg, num_symbols


def _assert_same(got, want, q_is_inf):
    if q_is_inf:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("q_is_inf", [True, False])
@pytest.mark.parametrize("T", [1, 2, 3])
def test_plain_version_matches_reference_and_pallas(T, q_is_inf, stochastic):
    x, noise, stacked, seg, num_symbols = _case(T, seed=10 * T + 2 * q_is_inf + stochastic)
    kw = dict(num_symbols=num_symbols, q_is_inf=q_is_inf, stochastic=stochastic)
    before = cuda.launch_counts()
    got = quantize_dequantize_segments(
        torch.from_numpy(x), torch.from_numpy(noise) if stochastic else None,
        torch.from_numpy(stacked), torch.from_numpy(seg), **kw).numpy()
    assert cuda.launch_counts() == before  # a CPU tensor takes the plain version
    want_rows = np.asarray(jax_rows(jnp.asarray(x), jnp.asarray(stacked), jnp.asarray(seg),
                                    jnp.asarray(noise), **kw))
    want_pallas = np.asarray(pallas_qdq(jnp.asarray(x), jnp.asarray(noise),
                                        jnp.asarray(stacked), jnp.asarray(seg),
                                        interpret=True, **kw))
    _assert_same(got, want_rows, q_is_inf)
    _assert_same(got, want_pallas, q_is_inf)
    assert np.isnan(got[5]).all() and not np.isnan(np.delete(got, 5, axis=0)).any()
    assert (got[[0, 17]] == 0).all()


def test_plain_version_checks_its_arguments():
    x, noise, stacked, seg, num_symbols = _case(2, seed=0)
    args = (torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(stacked))
    with pytest.raises(ValueError, match="seg_ids"):
        quantize_dequantize_segments(*args, torch.from_numpy(seg[:-1]),
                                     num_symbols=num_symbols, q_is_inf=True)
    with pytest.raises(ValueError, match="noise"):
        quantize_dequantize_segments(args[0], None, args[2], torch.from_numpy(seg),
                                     num_symbols=num_symbols, q_is_inf=True)
    with pytest.raises(ValueError, match="symbol counts"):
        quantize_dequantize_segments(*args, torch.from_numpy(seg), num_symbols=(17,),
                                     q_is_inf=True)
    # the plain version alone: no argument checks, same numbers
    got = quantize_dequantize_segments_plain(*args, torch.from_numpy(seg),
                                             num_symbols=num_symbols, q_is_inf=True)
    assert got.shape == (NB, BUCKET)


def test_stack_level_tables_matches():
    tables = TABLES[:3]
    want, want_ns = jplan.stack_level_tables([jnp.asarray(t) for t in tables])
    got, got_ns = tplan.stack_level_tables([torch.from_numpy(t) for t in tables])
    assert got_ns == want_ns == (17, 7, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _groups(jax_side, quants, table_ids):
    Q = JaxQuant if jax_side else QuantConfig
    return tuple((ids, Q(**q), table, tag)
                 for tag, ((ids, q), table) in enumerate(zip(quants, table_ids)))


SHAPES = [(40, 30), (7,), (300,), (5, 5), (1000,), (33,)]
PLANS = {
    # one geometry: two segments of one bucket, T = 2 (the layerwise shape)
    "one_class": ([((0, 2, 4), dict(num_levels=5, bits=4, bucket_size=64)),
                   ((1, 3, 5), dict(num_levels=15, bits=8, bucket_size=64))], (1, 0)),
    # three geometries (bucket 64 and 128, q = inf and 2): three launches,
    # fold_in per class
    "three_classes": ([((0, 1), dict(num_levels=15, bits=8, bucket_size=128)),
                     ((2, 3), dict(num_levels=5, bits=4, bucket_size=64)),
                     ((4, 5), dict(num_levels=15, bits=8, bucket_size=64, q_norm=2.0))],
                    (0, 1, 0)),
}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_fused_compress_matches_reference(name, use_pallas):
    quants, table_ids = PLANS[name]
    rng = np.random.RandomState(7)
    leaves = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    key_np = [(s, "float32") for s in SHAPES]
    jp = jplan.build_plan(tuple(key_np), _groups(True, quants, table_ids), "two_phase", 1,
                          "compress")
    tp = tplan.build_plan(tuple(key_np), _groups(False, quants, table_ids), "two_phase", 1,
                          "compress")
    level_of = {15: jax_levels(15), 5: jax_levels(5)}
    jtables = tuple(level_of[s.quant.num_levels] for s in jp.segments)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jplan.fused_compress(jp, jp.pack([jnp.asarray(a) for a in leaves]),
                                           jtables, key, use_pallas=use_pallas))
    # the reference's noise, in the order the port asks for it: one draw per
    # geometry class, classes sorted, fold_in(key, class) when there are several
    classes = sorted({(s.quant.bucket_size, float(s.quant.q_norm), s.quant.stochastic)
                      for s in jp.segments})
    draws = []
    for gi, geo in enumerate(classes):
        rows = sum(s.padded for s in jp.segments
                   if (s.quant.bucket_size, float(s.quant.q_norm), s.quant.stochastic)
                   == geo) // geo[0]
        k = jax.random.fold_in(key, gi) if len(classes) > 1 else key
        draws.append(np.asarray(jax.random.uniform(k, (rows, geo[0]), jnp.float32)))
    noise = ReplayNoise(draws)
    flat = tp.pack([torch.from_numpy(a) for a in leaves])
    got = tplan.fused_compress(tp, flat, tuple(torch.from_numpy(np.asarray(t))
                                                for t in jtables), noise)
    assert noise.remaining == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # the q = inf segments bit for bit
    for s in tp.segments:
        if math.isinf(s.quant.q_norm):
            np.testing.assert_array_equal(got[s.start: s.stop].numpy(), want[s.start: s.stop])
    # several workers' buffers at once: worker w's rows with worker w's noise
    noise2 = ReplayNoise([d for d in draws for _ in range(2)])
    both = tplan.fused_compress(tp, torch.stack([flat, flat]), tuple(
        torch.from_numpy(np.asarray(t)) for t in jtables), noise2)
    np.testing.assert_array_equal(both[0].numpy(), got.numpy())
    np.testing.assert_array_equal(both[1].numpy(), got.numpy())
