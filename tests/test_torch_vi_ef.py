"""The toy-VI Q-GenX loop (``repro_torch.core.extragradient``) under the
sparse compressors against the reference, K = 4 simulated workers, on the
CPU: ``randk`` through the per-worker estimate, ``ef21-topk`` and
``ef-randk`` through ``ef_compress`` with the ``[K, d]`` memory
``QGenXState.ef_err`` threaded through the step's exchanges.

Every reference draw is recomputed from its keys and replayed in the
port's order (the module docstring of ``repro_torch.core.extragradient``):
per exchange the K Rademacher oracle draws, then the K support draws
``permutation(key_k, d)[:k]`` of ``split(k_q, K)`` (none under
``ef21-topk``).  Tolerances, those of ``tests/test_torch_vi.py``: x, y,
sum_sq, x_avg, prev_half and ef_err at rtol 1e-5 with an atol floor of
1e-6 times the vector's largest magnitude (the matvec sums in another
order), ``t`` and ``bits_sent`` exactly.  The top-k support of a 32-vector
of duals did not meet a near tie in these runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extragradient as jeg
from repro.core import vi as jvi
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro_torch.core import extragradient as eg
from repro_torch.core import vi
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.core.noise import ReplayNoise
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

K, STEPS, FRAC = 4, 8, 0.25


def _close(got, want, what):
    want = np.asarray(want)
    floor = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=floor, err_msg=what)


def _step_draws(key, method, d, comp):
    k_q1, k_q2, k_o1, k_o2, _ = jax.random.split(key, 5)
    rounds = [(k_o2, k_q2)] if method == "optda" else [(k_o1, k_q1), (k_o2, k_q2)]
    k = max(1, round(FRAC * d))
    out = []
    for ko, kq in rounds:
        out += [np.asarray(jax.random.rademacher(kk, (d,), dtype=jnp.float32))
                for kk in jax.random.split(ko, K)]
        if comp != "ef21-topk":
            out += [np.asarray(jax.random.permutation(kk, d)[:k]) for kk in jax.random.split(kq, K)]
    return out


@pytest.mark.parametrize("method", ["de", "optda"])
@pytest.mark.parametrize("comp", ["randk", "ef21-topk", "ef-randk"])
def test_qgenx_steps_match_reference(comp, method):
    """8 steps on bilinear_saddle(d=16) (32 operator coordinates), absolute
    noise 0.5: every state field held per step."""
    jp, tp = jvi.bilinear_saddle(d=16, seed=6), vi.bilinear_saddle(d=16, seed=6)
    kw = dict(compressor=comp, rand_frac=FRAC, ef_topk_frac=FRAC)
    jcfg = jeg.QGenXConfig(variant=method, num_workers=K, exchange=JaxExchangeConfig(**kw))
    tcfg = eg.QGenXConfig(variant=method, num_workers=K, exchange=ExchangeConfig(**kw))
    joracle = jvi.absolute_noise_oracle(jp, 0.5)
    toracle = vi.absolute_noise_oracle(tp, 0.5, "cpu")
    x0 = (jp.z_star + 1.0).astype(np.float32)
    jst = jeg.qgenx_init(jnp.asarray(x0), jcfg)
    tst = eg.qgenx_init(torch.from_numpy(x0), tcfg, "cpu")
    ex = tcfg.make_exchange()
    d = jp.dim
    for t, key in enumerate(jax.random.split(jax.random.PRNGKey(13), STEPS)):
        jst = jeg.qgenx_step(jst, joracle, key, jcfg)
        noise = ReplayNoise(_step_draws(key, method, d, comp))
        tst = eg.qgenx_step(tst, toracle, noise, tcfg, ex)
        assert noise.remaining == 0
        for f in ("x", "y", "sum_sq", "x_avg", "prev_half", "ef_err"):
            _close(getattr(tst, f), getattr(jst, f), f"{f} at step {t}")
        assert tst.t == int(jst.t) == t + 1
        assert float(tst.bits_sent) == float(jst.bits_sent)
    calls = 1 if method == "optda" else 2
    assert float(tst.bits_sent) == STEPS * calls * 8 * 8 * round(FRAC * d)
    assert bool(tst.ef_err.any()) == (comp != "randk")
