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

import functools
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
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

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


# ---------------------------------------------------------------------------
# The precondition of kernel 5's bracket rule, on every table set the
# port's paths stack
# ---------------------------------------------------------------------------

CELLS = 256  # kernel 5's cells of [0, 1] (kCells)


def _count_levels(lv, s, x, strict=False):
    """The kernel's ``count_levels``: interior levels 1 .. s of a table at
    or below x (below with ``strict``), by binary search from the largest
    power of two <= s; vectorized over x (f32)."""
    n = np.zeros(x.shape, dtype=np.int64)
    step = 1 << (s.bit_length() - 1) if s > 0 else 0
    while step:
        j = n + step
        lev = lv[np.minimum(j, s)]
        hit = (j <= s) & ((lev < x) if strict else (lev <= x))
        n = np.where(hit, j, n)
        step >>= 1
    return n


def _kernel_bracket(lv, ns, u):
    """Kernel 5's bracket tau of u (f32) in one table (``lv``, ``ns``
    symbols), as the kernel stages and reads it: each cell c of [0, 1]
    keeps how many interior levels lie at or below c / 256; a table whose
    open cells each hold at most one level takes that count plus one
    compare, any other the binary search.  Returns (tau, fine)."""
    s = ns - 2
    c = np.arange(CELLS + 1, dtype=np.float32)
    edge = np.float32(1.0 / CELLS)
    below = _count_levels(lv, s, c * edge)
    fine = not (_count_levels(lv, s, (c + 1) * edge, strict=True) - below > 1).any()
    if not fine:
        return _count_levels(lv, s, u), fine
    cell = np.minimum(np.maximum(u * np.float32(CELLS), 0), CELLS).astype(np.int64)  # u*256 exact
    b = below[cell]
    return np.minimum(b + (lv[b + 1] <= u), s), fine


def _probe_points(lv, ns):
    """u = 0, 1, on each level and each cell edge, and one f32 step to
    either side of each (clamped to [0, 1], as the kernel clamps u)."""
    edges = np.arange(CELLS + 1, dtype=np.float32) / np.float32(CELLS)
    pts = np.concatenate([np.float32([0.0, 1.0]), lv[:ns], edges])
    pts = np.concatenate([pts, np.nextafter(pts, np.float32(-1)),
                          np.nextafter(pts, np.float32(2))])
    return np.clip(pts, 0.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _port_table_sets():
    """(name, stacked tables, symbol counts) of every set the port stacks:
    the GAN testbed's kernel-5 calls (uq8, uq4, the layerwise pair, and uq8
    with the device PRNG), recorded from ``compress_tree`` on a WGAN-shaped
    tree; uniform and exponential tables of 3-128 symbols; and 32 mixed
    tables of 2-128 symbols stacked at once."""
    import dataclasses

    from repro_torch.core.quantization import exponential_levels, uniform_levels
    from repro_torch.core.tree import tree_map
    from repro_torch.gan import wgan
    from repro_torch.launch import train_gan

    gen = torch.Generator()
    gen.manual_seed(0)
    model = wgan.WGAN(wgan.GANConfig(), gen, "cpu")
    wrapper, sets = tplan.quantize_dequantize_segments, []

    def recorder(x2d, noise, tables, seg_ids, **kw):
        sets.append((arm, tables.numpy(), kw["num_symbols"]))
        return wrapper(x2d, noise, tables, seg_ids, **kw)

    tplan.quantize_dequantize_segments = recorder
    try:
        for arm in ("uq8", "uq4", "layerwise", "uq8-prng"):
            cfg = train_gan.arm_exchange(arm.split("-")[0])
            if arm.endswith("prng"):
                cfg = dataclasses.replace(cfg, use_device_prng=True)
            grads = tree_map(lambda p: torch.randn((3, *p.shape), generator=gen),
                             model.param_tree())
            noise = ReplayNoise([7] if arm.endswith("prng") else [
                np.random.RandomState(k).rand(19, 512).astype(np.float32) for k in range(3)])
            wgan.GANConfig(exchange=cfg).make_exchange().compress_tree(grads, noise, workers=True)
    finally:
        tplan.quantize_dequantize_segments = wrapper
    for s in range(1, 127):
        for make in (uniform_levels, exponential_levels):
            stacked, ns = tplan.stack_level_tables([make(s, "cpu")])
            sets.append((f"{make.__name__}({s})", stacked.numpy(), ns))
    mixed = ([uniform_levels(s, "cpu") for s in (0, 1, 2, 3, 5, 7, 10, 15, 20, 31, 40, 63, 64,
                                                 100, 125, 126)]
             + [exponential_levels(s, "cpu") for s in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 15,
                                                       20, 30, 60, 126)])
    stacked, ns = tplan.stack_level_tables(mixed)
    sets.append(("32 mixed", stacked.numpy(), ns))
    return sets


@pytest.mark.parametrize("which", ["gan", "uniform", "exponential", "32 mixed"])
def test_kernel5_bracket_rule_precondition(which):
    """Kernel 5 finds the bracket tau = #{1 <= j <= ns - 2 : lv[j] <= u} by
    a cell count plus one compare (or a binary search), which equals the
    plain version's compare count only on a sorted table whose interior
    levels sit below the 1.0 padding.  On every table set the port's paths
    stack: each table is strictly increasing from 0 to 1 over its live
    symbols, padded with 1.0 past them, and a model of the kernel's rule
    gives the compare count at u = 0, 1, on each level and cell edge and
    one step to either side."""
    sets = [s for s in _port_table_sets()
            if {"gan": lambda n: n.startswith("uq") or n == "layerwise",
                "uniform": lambda n: n.startswith("uniform"),
                "exponential": lambda n: n.startswith("exponential"),
                "32 mixed": lambda n: n == "32 mixed"}[which](s[0])]
    if which == "gan":
        assert [s[0] for s in sets] == ["uq8", "uq4", "layerwise", "uq8-prng"]
        assert [s[2] for s in sets] == [(17,), (7,), (7, 17), (17,)]
    routes = set()
    for name, stacked, num_symbols in sets:
        for t, ns in enumerate(num_symbols):
            lv = stacked[t]
            assert lv.dtype == np.float32 and lv[0] == 0.0 and lv[ns - 1] == 1.0, name
            assert (np.diff(lv[:ns]) > 0).all(), f"{name} table {t} is not sorted"
            assert (lv[ns:] == 1.0).all() and (lv[1:ns - 1] < 1.0).all(), name
            u = _probe_points(lv, ns)
            want = (lv[None, 1:ns - 1] <= u[:, None]).sum(1)  # the plain version's compares
            got, fine = _kernel_bracket(lv, ns, u)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} table {t}")
            routes.add(fine)
    if which in ("exponential", "32 mixed"):
        assert routes == {True, False}  # both the cell lookup and the binary search ran
