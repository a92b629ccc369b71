"""The port's quantizer config, level tables, int4 packing and ExchangePlan
against the JAX reference (CPU, numpy inputs from a seed).

Everything here is integer layout or exact f32 arithmetic, so it is held
bit-exact, except the L^2 / L^1 bucket norms (summation order differs:
rtol 1e-6).
"""

import gc
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exchange as jex
from repro.core import quantization as jq
from repro_torch.core import exchange as tex
from repro_torch.core import quantization as tq
from repro_torch.core.tree import tree_flatten, tree_unflatten
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(bits=4, num_levels=5), dict(bits=4, num_levels=7), dict(bits=6),
    dict(num_levels=126), dict(num_levels=127), dict(bucket_size=7),
    dict(bits=4, num_levels=6, bucket_size=64, q_norm=2.0),
])
def test_quant_config_validation_matches(kwargs):
    """Same configs accepted, same rejected, same payload accounting."""
    try:
        ref = jq.QuantConfig(**kwargs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tq.QuantConfig(**kwargs)
        assert str(got.value) == str(e)
        return
    port = tq.QuantConfig(**kwargs)
    assert port.num_symbols == ref.num_symbols
    for n in (1, 511, 512, 513, 100_003):
        assert port.payload_bytes(n) == ref.payload_bytes(n)


@pytest.mark.parametrize("s", [1, 3, 5, 7, 15, 126])
def test_level_tables_bit_exact(s):
    np.testing.assert_array_equal(tq.uniform_levels(s, "cpu").numpy(),
                                  np.asarray(jq.uniform_levels(s)))
    np.testing.assert_array_equal(tq.exponential_levels(s, "cpu").numpy(),
                                  np.asarray(jq.exponential_levels(s)))
    tq.validate_levels(tq.uniform_levels(s, "cpu"), s)
    with pytest.raises(ValueError):
        tq.validate_levels(tq.uniform_levels(s, "cpu").flip(0), s)


@pytest.mark.parametrize("make", [tq.uniform_levels, tq.exponential_levels])
def test_level_tables_are_sorted_for_the_bracket_search(make):
    """The CUDA quantize kernels find the bracket by binary search, which
    equals the reference's compare count only on a sorted table: every
    table the port builds, up to the kernels' 128 symbols, is strictly
    increasing from 0 to 1, and ``validate_levels`` refuses an unsorted
    one."""
    for s in range(1, 127):
        lv = make(s, "cpu")
        tq.validate_levels(lv, s)
        assert bool((lv[1:] > lv[:-1]).all())
    with pytest.raises(ValueError, match="strictly increasing"):
        tq.validate_levels(torch.tensor([0.0, 0.5, 0.25, 1.0]), 2)


def test_pack_int4_bytes_and_inverse():
    rng = np.random.RandomState(0)
    v = rng.randint(-7, 8, size=4096).astype(np.int32)
    got = tq.pack_int4(torch.from_numpy(v)).numpy()
    want = np.asarray(jq.pack_int4(jnp.asarray(v)))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tq.unpack_int4(torch.from_numpy(got)).numpy(), v)
    np.testing.assert_array_equal(np.asarray(jq.unpack_int4(jnp.asarray(got))), v)


@pytest.mark.parametrize("q", [math.inf, 2.0, 1.0])
def test_pad_and_bucket_norms(q):
    rng = np.random.RandomState(1)
    v = rng.randn(1000).astype(np.float32)
    t2d, n = tq.pad_to_buckets(torch.from_numpy(v), 128)
    j2d, jn = jq._pad_to_buckets(jnp.asarray(v), 128)
    assert n == jn == 1000
    np.testing.assert_array_equal(t2d.numpy(), np.asarray(j2d))
    got = tq.bucket_norms(t2d, q).numpy()
    want = np.asarray(jq.bucket_norms(j2d, q))
    if math.isinf(q):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _nested_tree(rng):
    """Nested dicts whose insertion order differs from sorted order."""
    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    return {
        "zeta": arr(3, 5),
        "alpha": {"w": arr(300), "b": arr(7, 2, 2)},
        "mid": ({"y": arr(1), "x": arr(513)}, arr(64)),
        "beta": arr(129, 3),
    }


def test_tree_flatten_is_jax_order():
    tree = _nested_tree(np.random.RandomState(2))
    jleaves = jax.tree_util.tree_leaves(tree)
    tleaves, spec = tree_flatten(tree)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert a is b
    back = tree_unflatten(spec, tleaves)
    assert list(back) == sorted(tree) and back["mid"][0]["x"] is tree["mid"][0]["x"]


def test_tree_flatten_and_unflatten_leave_no_reference_cycles():
    """A recursive closure inside them would hold every leaf in a reference
    cycle until the cyclic gc runs: at full width, gigabytes of gradients
    and states a train step (an H100 peak 10 GB higher in one run than in
    another, by the gc's timing alone)."""
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    gc.collect()
    gc.disable()
    try:
        leaves, spec = tree_flatten({"a": [leaf, None], "b": (leaf,)})
        assert tree_unflatten(spec, leaves)["b"][0] is leaf
        del leaves, spec, leaf
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("purpose", ["pmean", "compress"])
@pytest.mark.parametrize("axis_size", [1, 2, 4])
@pytest.mark.parametrize("mode", ["gather", "two_phase"])
@pytest.mark.parametrize("bits", [8, 4])
def test_plan_layout_and_packing_match(bits, mode, axis_size, purpose):
    quant = jq.QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=64)
    tquant = tq.QuantConfig(num_levels=quant.num_levels, bits=bits, bucket_size=64)
    jcfg = jex.ExchangeConfig(compressor="qgenx", quant=quant, mode=mode)
    tcfg = tex.ExchangeConfig(compressor="qgenx", quant=tquant, mode=mode)
    tree = _nested_tree(np.random.RandomState(3))
    jleaves = [jnp.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    tleaves = [torch.from_numpy(a) for a in tree_flatten(tree)[0]]
    jplan = jex.make_exchange(jcfg).compressor.plan_for(jleaves, jcfg, axis_size, purpose)

    class _Comm:
        size = axis_size

    tplan = tex.make_exchange(tcfg, _Comm()).plan_for(tleaves, purpose)
    for field in ("shapes", "offsets", "pack_order", "total", "n_live"):
        assert getattr(tplan, field) == getattr(jplan, field), field
    assert len(tplan.segments) == len(jplan.segments)
    for ts, js in zip(tplan.segments, jplan.segments):
        for field in ("start", "n", "padded", "table", "key_tag", "leaf_ids", "stop", "pad"):
            assert getattr(ts, field) == getattr(js, field), field
        assert (ts.quant.bits, ts.quant.bucket_size) == (js.quant.bits, js.quant.bucket_size)
    assert tplan.compress_payload_bytes() == jplan.compress_payload_bytes()
    assert tplan.describe() == jplan.describe()
    flat = tplan.pack(tleaves)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jplan.pack(jleaves)))
    for a, b in zip(tplan.unpack(flat, tleaves), tleaves):
        assert torch.equal(a, b)
    for start, stop in ((0, tplan.total), (0, 1), (37, 901), (tplan.total - 70, tplan.total)):
        assert torch.equal(tplan.pack_range(tleaves, start, stop), flat[start:stop])
    # the analytic wire bill of one exchange of this tree
    assert (tex.make_exchange(tcfg, _Comm()).wire_bytes_tree(tleaves, axis_size)
            == jex.make_exchange(jcfg).wire_bytes_tree(jleaves, axis_size))


def test_plan_leaf_key_dtype_names():
    from repro.core.exchange_plan import leaf_key as jax_leaf_key
    from repro_torch.core.exchange_plan import leaf_key

    shapes = [(3, 4), (5,)]
    tl = [torch.zeros(shapes[0], dtype=torch.bfloat16), torch.zeros(shapes[1])]
    jl = [jnp.zeros(shapes[0], jnp.bfloat16), jnp.zeros(shapes[1], jnp.float32)]
    assert leaf_key(tl) == jax_leaf_key(jl)
    assert leaf_key(shapes) == jax_leaf_key(shapes)
