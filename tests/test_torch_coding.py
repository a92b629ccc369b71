"""The port's Theorem 2 code-length pieces against the reference.

``repro_torch.core.coding`` is the port's own copy of the numpy-only
``repro.core.coding``: every function is held exactly equal to the
reference's on random pmfs and symbol streams.

``expected_index_pmf``, ``theorem2_bits_traced`` and
``Exchange.coded_bits_tree`` (the train step's ``coded_bits_est``) are
held to the reference's traced versions on the same inputs, for qgenx in
both modes at int8 and int4, with q = inf and q = 2.  Tolerance: rtol
1e-6.  The port sums each symbol's mass in f64 (per chunk of bucket rows,
then over chunks) where the reference sums in f32 over the whole vector,
so the two pmfs differ by the reference's f32 rounding; the port's
chunked and one-chunk sums agree to rtol 1e-12.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jax_coding
from repro.core import exchange as jax_exchange
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.quantization import QuantConfig as JaxQuant
from repro.core.quantization import exponential_levels as jax_exp_levels
from repro_torch.core import coding
from repro_torch.core import exchange as xmod
from repro_torch.core.exchange import ExchangeConfig, make_exchange
from repro_torch.core.quantization import QuantConfig, exponential_levels, uniform_levels
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _pmfs(seed):
    rng = np.random.RandomState(seed)
    out = []
    for n in (2, 3, 7, 17, 33):
        p = rng.dirichlet(np.ones(n) * 0.5)
        p[rng.rand(n) < 0.2] = 0.0  # zero-probability symbols
        p[0] = max(p[0], 1e-3)
        out.append(p / p.sum())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_code_lengths_equal_reference(seed):
    for p in _pmfs(seed):
        for d, nb in ((1, 1), (512, 3), (4096, 8)):
            assert coding.entropy_bits(p) == jax_coding.entropy_bits(p)
            assert coding.theorem2_expected_bits(p, d, nb) == \
                jax_coding.theorem2_expected_bits(p, d, nb)
            assert coding.expected_elias_bits(p, d, nb) == \
                jax_coding.expected_elias_bits(p, d, nb)
            assert coding.expected_huffman_bits(p, d, nb) == \
                jax_coding.expected_huffman_bits(p, d, nb)
        assert coding.huffman_code(list(p)) == jax_coding.huffman_code(list(p))
    for n in (1, 2, 3, 255, 256, 1 << 20):
        assert coding.elias_gamma_length(n) == jax_coding.elias_gamma_length(n)
    with pytest.raises(ValueError):
        coding.elias_gamma_length(0)
    assert coding.C_B == jax_coding.C_B


@pytest.mark.parametrize("method", ["elias", "huffman"])
def test_codec_bytes_equal_reference(method):
    rng = np.random.RandomState(5)
    s = 15
    idx = rng.randint(-(s + 1), s + 2, size=700) * (rng.rand(700) < 0.6)
    norms = rng.rand(3).astype(np.float32) * 4
    codes = None
    if method == "huffman":
        p = np.bincount(np.abs(idx), minlength=s + 2) / idx.size
        codes = coding.huffman_code(list(p))
    got = coding.encode(idx, norms, method, codes)
    assert got == jax_coding.encode(idx, norms, method, codes)
    back, bnorms = coding.decode(*got, idx.size, 3, method, codes)
    np.testing.assert_array_equal(back, idx)
    np.testing.assert_array_equal(bnorms, norms)


@pytest.mark.parametrize("s,table", [(15, "uniform"), (5, "uniform"), (5, "exponential")])
def test_expected_index_pmf_matches_reference(s, table):
    rng = np.random.RandomState(s)
    u = rng.rand(37, 512).astype(np.float32)
    u[0] = 0.0
    u[1, :7] = 1.0
    jl = jnp.linspace(0.0, 1.0, s + 2) if table == "uniform" else jax_exp_levels(s)
    tl = uniform_levels(s, "cpu") if table == "uniform" else exponential_levels(s, "cpu")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    want = np.asarray(jax_exchange.expected_index_pmf(jnp.asarray(u), jl))
    got = xmod.expected_index_pmf(torch.from_numpy(u), tl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert abs(got.sum() - 1.0) < 1e-6
    bits = xmod.theorem2_bits_traced(torch.tensor(want), u.size, u.shape[0])
    np.testing.assert_allclose(float(bits), float(jax_exchange.theorem2_bits_traced(
        jnp.asarray(want), u.size, u.shape[0])), rtol=1e-6)
    # the numpy oracle computes the same formula in f64
    np.testing.assert_allclose(float(bits), coding.theorem2_expected_bits(
        want.astype(np.float64), u.size, u.shape[0]), rtol=1e-5)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(300, 70) * 0.02).astype(np.float32),
            "b": (rng.randn(1000) * 3).astype(np.float32),
            "z": np.zeros((9, 5), np.float32),
            "blocks": [{"k": (rng.standard_t(2, (40, 41)) * 1e-3).astype(np.float32)}] * 2}


@pytest.mark.parametrize("q_norm", [math.inf, 2.0])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", ["two_phase", "gather"])
def test_coded_bits_tree_matches_reference(mode, bits, q_norm, monkeypatch):
    s = 15 if bits == 8 else 5
    tree = _tree(bits)
    jex = jax_make_exchange(JaxExchangeConfig(
        compressor="qgenx", mode=mode,
        quant=JaxQuant(num_levels=s, bits=bits, bucket_size=256, q_norm=q_norm)))
    tex = make_exchange(ExchangeConfig(
        compressor="qgenx", mode=mode,
        quant=QuantConfig(num_levels=s, bits=bits, bucket_size=256, q_norm=q_norm)))
    want = float(jex.coded_bits_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                                     jex.init_state()))
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    got = tex.coded_bits_tree(ttree, tex.init_state("cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    monkeypatch.setattr(xmod, "CODED_CHUNK_ROWS", 7)  # many chunks, a ragged last one
    np.testing.assert_allclose(float(tex.coded_bits_tree(ttree, tex.init_state("cpu"))),
                               float(got), rtol=1e-6)
    if bits == 8:  # the reference's bound for 8-bit configs
        assert float(got) <= 8 * tex.compress_wire_bytes_tree(ttree)


@pytest.mark.parametrize("cfg", [dict(compressor="none"),
                                 dict(compressor="layerwise",
                                      quant=QuantConfig(num_levels=5, bits=4, bucket_size=256))],
                         ids=["none", "layerwise"])
def test_coded_bits_is_zero_off_qgenx(cfg):
    ex = make_exchange(ExchangeConfig(**cfg))
    tree = jax.tree_util.tree_map(torch.from_numpy, _tree(0))
    assert ex.coded_bits_tree(tree, ex.init_state("cpu")) == 0.0


def test_wire_bytes_per_device_matches_reference():
    for bits in (8, 4):
        for K in (1, 2, 8):
            for mode in ("gather", "two_phase"):
                s = 15 if bits == 8 else 5
                jq = JaxQuant(num_levels=s, bits=bits, bucket_size=512)
                tq = QuantConfig(num_levels=s, bits=bits, bucket_size=512)
                for n in (1, 4096, 123457):
                    assert xmod.wire_bytes_per_device(n, K, tq, mode) == \
                        jax_exchange.wire_bytes_per_device(n, K, jq, mode)
                    assert xmod.wire_bytes_per_device(n, K, None, mode) == \
                        jax_exchange.wire_bytes_per_device(n, K, None, mode)
