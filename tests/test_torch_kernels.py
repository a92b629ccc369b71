"""The port's exchange kernels (plain versions, the path CPU tensors take)
against the Pallas kernels themselves, run with ``interpret=True``.

Inputs and noise are made with numpy from a seed and handed to both sides.
Tolerances:

* payload indices and packed int4 bytes: bit-exact for q = inf.  For q = 2
  the row norm is a sum whose order differs between the frameworks, so the
  indices are exact in every row whose norm is bit-identical and at most
  one level apart elsewhere.
* norms: rtol 1e-6 (L^inf norms are also checked bit-exact).
* f32 outputs: rtol 1e-6, atol 1e-6 — the bar ``tests/test_dequant_reduce.py``
  sets for the Pallas kernels.  XLA on the CPU contracts the K-sum's
  ``acc + level * norm`` into a fused multiply-add inside the interpreted
  kernel, which the port (like the Pallas kernel's own arithmetic) does
  not, so K >= 2 means differ in the last ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.quantization import uniform_levels as jax_uniform_levels
from repro.kernels.dequant_reduce import (
    dequant_reduce_blocks as jax_dequant_reduce,
    dequant_reduce_requantize_blocks as jax_requantize,
)
from repro.kernels.dequantize import dequantize_blocks as jax_dequantize
from repro.kernels.quantize import quantize_blocks as jax_quantize
from repro_torch.core.quantization import uniform_levels
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.dequant_reduce import (
    dequant_reduce_blocks,
    dequant_reduce_requantize_blocks,
)
from repro_torch.kernels.dequantize import dequantize_blocks
from repro_torch.kernels.quantize import quantize_blocks
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

NB, BUCKET = 11, 256  # 11 rows: not a multiple of the reference's 8-row tile
RTOL = ATOL = 1e-6


def _levels(bits):
    s = 15 if bits == 8 else 5
    return s, np.asarray(jax_uniform_levels(s)), uniform_levels(s, "cpu")


def _x(rng, zero_row=True):
    x = (rng.randn(NB, BUCKET) * 3).astype(np.float32)
    if zero_row:
        x[4] = 0.0  # norm 0 -> safe norm 1, all indices 0
    return x


def _payloads(rng, K, s, bits):
    idx = rng.randint(-(s + 1), s + 2, size=(K, NB, BUCKET)).astype(np.int32)
    norms = (np.abs(rng.randn(K, NB)) + 0.1).astype(np.float32)
    idx[:, 2] = 0
    norms[:, 2] = 0.0
    payload = torch.stack([ref.pack_payload(torch.from_numpy(idx[k]), bits)
                           for k in range(K)])
    return payload, torch.from_numpy(norms)


def _assert_indices(got, want, bits, q_is_inf, norms_got, norms_want):
    got, want = np.array(got), np.array(want)
    if q_is_inf:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(norms_got, norms_want)
        return
    gi = ref.unpack_payload(torch.from_numpy(got), bits).numpy()
    wi = ref.unpack_payload(torch.from_numpy(want), bits).numpy()
    same = np.asarray(norms_got) == np.asarray(norms_want)
    np.testing.assert_array_equal(gi[same], wi[same])
    assert np.abs(gi - wi).max() <= 1


@pytest.mark.parametrize("q_is_inf", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_dequantize_match_pallas(bits, q_is_inf):
    rng = np.random.RandomState(bits * 10 + q_is_inf)
    s, jlv, tlv = _levels(bits)
    x, r = _x(rng), rng.rand(NB, BUCKET).astype(np.float32)
    pj, nj = jax_quantize(jnp.asarray(x), jnp.asarray(r), jnp.asarray(jlv),
                          num_symbols=s + 2, q_is_inf=q_is_inf, bits=bits)
    pt, nt = quantize_blocks(torch.from_numpy(x), torch.from_numpy(r), tlv,
                             num_symbols=s + 2, q_is_inf=q_is_inf, bits=bits)
    assert pt.dtype == torch.int8 and pt.shape == (NB, BUCKET if bits == 8 else BUCKET // 2)
    _assert_indices(pt.numpy(), pj, bits, q_is_inf, nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=RTOL)
    assert (pt[4] == 0).all() and float(nt[4]) == 0.0
    # kernel 3 on the same payload: the same arithmetic, bit-exact
    dj = jax_dequantize(jnp.asarray(pt.numpy()), jnp.asarray(nt.numpy()),
                        jnp.asarray(jlv), num_symbols=s + 2, bits=bits)
    dt = dequantize_blocks(pt, nt, tlv, num_symbols=s + 2, bits=bits)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("q_is_inf", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_reduce_kernels_match_pallas(bits, q_is_inf, K):
    rng = np.random.RandomState(100 + K * 4 + bits + q_is_inf)
    s, jlv, tlv = _levels(bits)
    P, N = _payloads(rng, K, s, bits)
    mj = jax_dequant_reduce(jnp.asarray(P.numpy()), jnp.asarray(N.numpy()),
                            jnp.asarray(jlv), num_symbols=s + 2, num_workers=K, bits=bits)
    mt = dequant_reduce_blocks(P, N, tlv, num_symbols=s + 2, num_workers=K, bits=bits)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=RTOL, atol=ATOL)
    if K == 1:  # no K-sum: bit-exact
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    r2 = rng.rand(NB, BUCKET).astype(np.float32)
    oj, onj = jax_requantize(jnp.asarray(P.numpy()), jnp.asarray(N.numpy()),
                             jnp.asarray(jlv), jnp.asarray(r2), num_symbols=s + 2,
                             num_workers=K, q_is_inf=q_is_inf, bits=bits)
    ot, ont = dequant_reduce_requantize_blocks(P, N, tlv, torch.from_numpy(r2),
                                               num_symbols=s + 2, num_workers=K,
                                               q_is_inf=q_is_inf, bits=bits)
    np.testing.assert_allclose(ont.numpy(), np.asarray(onj), rtol=RTOL)
    # the indices are held to the q_norm rule in every row whose reduced
    # norm came out bit-identical; the one-ulp K-mean differences can move
    # a norm only at K >= 2
    _assert_indices(ot.numpy(), oj, bits, q_is_inf and K == 1, ont.numpy(),
                    np.asarray(onj))


@pytest.mark.parametrize("q_is_inf", [True, False])
def test_non_finite_rows_match_pallas(q_is_inf):
    """A NaN or inf coordinate gives the reference's row: the norm carries
    it (NaN is not dropped by the max), the indices are those of norm 1."""
    rng = np.random.RandomState(21)
    s, jlv, tlv = _levels(8)
    x, r = _x(rng), rng.rand(NB, BUCKET).astype(np.float32)
    x[1, 3], x[6, 200] = np.nan, -np.inf
    pj, nj = jax_quantize(jnp.asarray(x), jnp.asarray(r), jnp.asarray(jlv),
                          num_symbols=s + 2, q_is_inf=q_is_inf, bits=8)
    pt, nt = quantize_blocks(torch.from_numpy(x), torch.from_numpy(r), tlv,
                             num_symbols=s + 2, q_is_inf=q_is_inf, bits=8)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert np.isnan(nt[1].item()) and np.isinf(nt[6].item())
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=RTOL)  # NaN == NaN here


def test_plain_versions_are_the_row_math():
    """The plain kernel versions compose the shared row helpers exactly."""
    rng = np.random.RandomState(5)
    s, _, lv = _levels(8)
    x = torch.from_numpy(_x(rng))
    r = torch.from_numpy(rng.rand(NB, BUCKET).astype(np.float32))
    signed, norms = ref.quant_rows(x, lv, r, s + 2, True)
    payload, norms2 = ref.quantize_blocks_plain(x, r, lv, num_symbols=s + 2,
                                                q_is_inf=True, bits=8)
    assert torch.equal(payload.to(torch.int32), signed) and torch.equal(norms, norms2)
    back = ref.dequant_rows(signed, lv, norms)
    assert torch.allclose(back, x, atol=float(norms.max()) / (s + 1))


def test_wrappers_validate_shapes():
    s, _, lv = _levels(8)
    x = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="noise shape"):
        quantize_blocks(x, torch.zeros((3, 4)), lv, num_symbols=s + 2, q_is_inf=True)
    with pytest.raises(ValueError, match="bits"):
        quantize_blocks(x, x, lv, num_symbols=s + 2, q_is_inf=True, bits=6)
    with pytest.raises(ValueError, match="num_workers"):
        dequant_reduce_blocks(torch.zeros((2, 3, 8), dtype=torch.int8), torch.zeros((2, 3)),
                              lv, num_symbols=s + 2, num_workers=3)


def test_cpu_tensors_launch_nothing():
    """CPU tensors take the plain versions and are not counted as launches."""
    cuda.reset_launch_counts()
    s, _, lv = _levels(8)
    x = torch.randn(3, 8)
    quantize_blocks(x, torch.rand(3, 8), lv, num_symbols=s + 2, q_is_inf=True)
    assert all(v == 0 for v in cuda.launch_counts().values())


@pytest.mark.parametrize("bits", [8, 4])
def test_flat_wrappers_match_ops(bits):
    """``kernels/ops.py``: pad -> kernel 1 -> kernel 3 on a flat vector,
    against ``quantize_pallas`` / ``dequantize_pallas`` with the same key's
    noise replayed."""
    import jax

    from repro.core.quantization import QuantConfig as JaxQuant
    from repro.kernels.ops import dequantize_pallas, quantize_pallas
    from repro_torch.core.noise import ReplayNoise
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.kernels.ops import dequantize_flat, quantize_flat

    s, jlv, tlv = _levels(bits)
    v = np.random.RandomState(9).randn(1000).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jcfg = JaxQuant(num_levels=s, bits=bits, bucket_size=256)
    qj = quantize_pallas(jnp.asarray(v), jnp.asarray(jlv), key, jcfg)
    noise = ReplayNoise([np.asarray(jax.random.uniform(key, (4, 256)))])
    qt = quantize_flat(torch.from_numpy(v), tlv, noise, QuantConfig(num_levels=s, bits=bits,
                                                                    bucket_size=256))
    np.testing.assert_array_equal(qt.payload.numpy(), np.asarray(qj.payload))
    np.testing.assert_array_equal(qt.norms.numpy(), np.asarray(qj.norms))
    assert qt.n == qj.n and qt.wire_bytes() == qj.wire_bytes()
    np.testing.assert_array_equal(
        dequantize_flat(qt, tlv, QuantConfig(num_levels=s, bits=bits, bucket_size=256)).numpy(),
        np.asarray(dequantize_pallas(qj, jnp.asarray(jlv), jcfg)))
