"""The paper's convergence claims (Theorems 3 and 4, Fig. 4) in the port
alone: ``tests/test_extragradient.py``'s assertions, sizes and T, run on
``repro_torch.core.extragradient`` on the CPU with a ``GeneratorNoise``
seeded 42 (the reference's ``PRNGKey(42)``; the two frameworks' streams
differ, so these are the claims on the port's own draws, not a replay).

* O(1/sqrt(T)) gap decay under absolute noise (Thm 3);
* fast decay under relative noise and co-coercivity (Thm 4);
* more workers K give a smaller gap at equal T (distributed acceleration);
* every variant (da, de, optda) converges;
* unbiased quantization keeps the rate and cuts the bits;
* QAda levels do not hurt, and move away from uniform;
* Q-GenX beats QSGDA on the bilinear problem (Fig. 4);
* under relative noise the iterates approach z*;

and the toy loop bit-identical to the model-scale qgenx optimizer on one
oracle sequence.  No T is cut.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core.extragradient import (
    QGenXConfig,
    adaptive_gamma,
    qgenx_init,
    qgenx_run,
    qgenx_step,
    qsgda_run,
)
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.vi import (
    absolute_noise_oracle,
    bilinear_saddle,
    cocoercive_quadratic,
    distance_to_solution,
    relative_noise_oracle,
    restricted_gap,
)
from repro_torch.optim import optimizers as opt
from repro_torch.optim import qgenx as qgenx_opt
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEED = 42


def _x0(vi):
    return torch.from_numpy(np.asarray(vi.z_star, np.float32)) + 1.0


def _gap_at(vi, oracle, cfg, T):
    st = qgenx_run(_x0(vi), oracle, cfg, GeneratorNoise.seeded(SEED, "cpu"), T, "cpu")
    return restricted_gap(vi, st.x_avg), st


def test_absolute_noise_rate_bilinear():
    vi = bilinear_saddle(d=16, seed=0)
    oracle = absolute_noise_oracle(vi, 0.5, "cpu")
    cfg = QGenXConfig(variant="de", num_workers=4)
    g_small, _ = _gap_at(vi, oracle, cfg, 128)
    g_big, _ = _gap_at(vi, oracle, cfg, 2048)
    assert g_big < g_small / 2.5, (g_small, g_big)  # sqrt rate predicts 4x


def test_relative_noise_fast_rate():
    vi = cocoercive_quadratic(d=32, seed=1)
    oracle = relative_noise_oracle(vi, 0.5, "cpu")
    cfg = QGenXConfig(variant="de", num_workers=4)
    g_small, _ = _gap_at(vi, oracle, cfg, 128)
    g_big, _ = _gap_at(vi, oracle, cfg, 1024)
    assert g_big < g_small / 4.0, (g_small, g_big)  # linear rate predicts 8x


def test_distributed_acceleration():
    vi = bilinear_saddle(d=16, seed=2)
    oracle = absolute_noise_oracle(vi, 1.0, "cpu")
    T = 4096  # past gamma_1 = K's transient
    g1, _ = _gap_at(vi, oracle, QGenXConfig(variant="de", num_workers=1), T)
    g16, _ = _gap_at(vi, oracle, QGenXConfig(variant="de", num_workers=16), T)
    assert g16 < g1 * 0.8, (g1, g16)


@pytest.mark.parametrize("variant", ["da", "de", "optda"])
def test_variants_converge(variant):
    vi = cocoercive_quadratic(d=16, seed=3)
    oracle = absolute_noise_oracle(vi, 0.2, "cpu")
    g, st = _gap_at(vi, oracle, QGenXConfig(variant=variant, num_workers=4), 1024)
    g0 = restricted_gap(vi, _x0(vi))
    assert g < g0 / 3.0, (variant, g, g0)
    assert math.isfinite(float(st.sum_sq))


@pytest.mark.parametrize("bits,s", [(8, 15), (4, 5)])
def test_quantization_preserves_convergence(bits, s):
    vi = bilinear_saddle(d=32, seed=4)
    oracle = absolute_noise_oracle(vi, 0.5, "cpu")
    quant = QuantConfig(num_levels=s, bits=bits, bucket_size=64, q_norm=math.inf)
    g_fp, st_fp = _gap_at(vi, oracle, QGenXConfig(variant="de", num_workers=4), 1024)
    g_q, st_q = _gap_at(vi, oracle, QGenXConfig(variant="de", num_workers=4, quant=quant), 1024)
    assert g_q < g_fp * 3.0 + 0.05, (g_q, g_fp)
    assert float(st_q.bits_sent) < float(st_fp.bits_sent) / 3.0


def test_adaptive_levels_do_not_hurt():
    vi = cocoercive_quadratic(d=64, seed=5)
    oracle = absolute_noise_oracle(vi, 0.3, "cpu")
    quant = QuantConfig(num_levels=7, bucket_size=64, q_norm=math.inf)
    g_base, _ = _gap_at(vi, oracle, QGenXConfig(variant="de", num_workers=4, quant=quant), 512)
    g_ada, st = _gap_at(vi, oracle, QGenXConfig(variant="de", num_workers=4, quant=quant,
                                                level_update_every=32), 512)
    assert g_ada < g_base * 1.5 + 0.05
    assert not np.allclose(st.levels.numpy(), np.linspace(0, 1, 9), atol=1e-4)


def test_qgenx_beats_qsgda_on_bilinear():
    vi = bilinear_saddle(d=16, seed=6)
    oracle = absolute_noise_oracle(vi, 0.1, "cpu")
    T = 1024
    g_qgenx, _ = _gap_at(vi, oracle, QGenXConfig(variant="de", num_workers=4), T)
    _, x_avg = qsgda_run(_x0(vi), oracle, GeneratorNoise.seeded(SEED, "cpu"), T,
                         num_workers=4, lr=0.05, device="cpu")
    g_qsgda = restricted_gap(vi, x_avg)
    assert g_qgenx < g_qsgda, (g_qgenx, g_qsgda)


def test_last_iterate_distance_relative_noise():
    vi = cocoercive_quadratic(d=16, seed=7)
    oracle = relative_noise_oracle(vi, 0.2, "cpu")
    st = qgenx_run(_x0(vi), oracle, QGenXConfig(variant="de", num_workers=4),
                   GeneratorNoise.seeded(SEED, "cpu"), 2048, "cpu")
    d_end = float(distance_to_solution(vi, st.x_avg))
    assert d_end < 0.25 * float(distance_to_solution(vi, _x0(vi))), d_end


@pytest.mark.parametrize("method", ["de", "optda"])
def test_toy_loop_and_trainer_optimizer_are_bit_identical(method):
    """The toy loop and the model-scale qgenx optimizer on one oracle
    sequence (K = 1, full precision, X_1 = 0, where the toy's
    origin-anchored recursion and the optimizer's X_1-anchored one
    coincide): iterates, sum_sq, gamma and optda's carried feedback bit
    for bit (``tests/test_qgenx_optimizer.py:80,126``)."""
    d, T, scale = 64, 12, 0.37
    rng = np.random.RandomState(0)
    xi = [rng.randn(d).astype(np.float32) for _ in range(2 * T)]

    def oracle(z, noise):  # elementwise: no reduction order to differ
        return 0.8 * z + 0.3 * noise.normal((d,), z.device)

    cfg = QGenXConfig(variant=method, num_workers=1, gamma_scale=scale)
    toy = qgenx_init(torch.zeros(d), cfg, "cpu")
    opt_cfg = opt.OptimizerConfig(name="qgenx", method=method, gamma_scale=scale, grad_clip=0.0)
    params = [torch.zeros(d)]
    st = opt.init_state(opt_cfg, params)
    draws = iter(xi)
    for _ in range(T):
        if method == "de":
            a, b = next(draws), next(draws)
            toy = qgenx_step(toy, oracle, ReplayNoise([a, b]), cfg)
            v1 = [oracle(params[0], ReplayNoise([a]))]
        else:
            b = next(draws)
            toy = qgenx_step(toy, oracle, ReplayNoise([b]), cfg)
            v1 = st.prev_half
        half = qgenx_opt.extrapolate(opt_cfg, params, st, v1, 1)
        v2 = [oracle(half[0], ReplayNoise([b]))]
        sq = qgenx_opt.local_sq_diff(v1, v2)
        params, st = qgenx_opt.commit(opt_cfg, params, st, v2, sq, 1,
                                      prev_half=v2 if method == "optda" else None)
        assert torch.equal(params[0], toy.x)
        assert torch.equal(st.sum_sq, toy.sum_sq)
        assert torch.equal(adaptive_gamma(st.sum_sq, 1, scale), adaptive_gamma(toy.sum_sq, 1, scale))
        if method == "optda":
            assert torch.equal(st.prev_half[0], toy.prev_half[0])
