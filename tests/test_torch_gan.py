"""The port's WGAN-GP testbed (``repro_torch.gan.wgan``) against the
reference ``repro/gan/wgan.py``, on the CPU at the reference's width
(latent 8, hidden 64, batch 256 per worker, K = 3 workers).

Weights come across with ``gan_params_from_jax``.  Every random draw of
the reference (latent z, gradient-penalty eps, quantizer noise) is
recomputed here with ``jax.random`` from the reference's keys and replayed
into the port; the real batches are numpy arrays handed to both.

Tolerances (f32; the frameworks sum matmuls and reductions in different
orders):

* one worker's dual vector: rtol 1e-5, atol 1e-6 (atol: a floor for
  coordinates near zero);
* ``compress_tree`` on the reference's gradients with its noise replayed:
  bit for bit (the same arithmetic on the same inputs);
* 3 fp32-arm steps: params rtol 1e-5, atol 1e-6;
* one uq8 step with every draw replayed: the gradients differ in the last
  bits, which can move a stochastic rounding decision where the noise sits
  within an ulp of the threshold.  A flip changes one coordinate of one
  worker's estimate by one level, so after the mean and ExtraAdam's
  normalized update that coordinate can move by at most a few learning
  rates; all other coordinates are held to rtol 1e-5 / atol 1e-6, and at
  most 1e-3 of the coordinates may be off;
* the randk25 arm: ``compress_tree`` bit for bit and 3 steps with every
  draw (its supports included) replayed at the fp32 arm's bar;
* the energy distance on the same point sets: 1e-5 absolute (its three
  terms are f32 means of 2^20 distances of order 1, summed in different
  orders);
* ``grad_bytes``: exactly equal for every arm.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.quantization import QuantConfig as JaxQuant
from repro.gan import wgan as jgan
from repro.optim import optimizers as jax_opt
from repro_torch.convert import gan_params_from_jax, gan_params_to_jax
from repro_torch.core.exchange import make_exchange
from repro_torch.core.noise import ReplayNoise
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.gan import wgan
from repro_torch.kernels import cuda
from repro_torch.launch import train_gan
from repro_torch.optim import optimizers as opt
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

K, B, LATENT = 3, 256, 8
JAX_ARMS = {
    "fp32": None,
    "uq8": JaxExchangeConfig(compressor="qgenx", quant=JaxQuant(num_levels=15, bits=8,
                                                                bucket_size=512)),
    "uq4": JaxExchangeConfig(compressor="qgenx", quant=JaxQuant(num_levels=5, bits=4,
                                                                bucket_size=512)),
    "layerwise": JaxExchangeConfig(compressor="layerwise",
                                   quant=JaxQuant(num_levels=5, bits=4, bucket_size=512),
                                   layerwise_threshold=2048),
    "randk25": JaxExchangeConfig(compressor="randk", rand_frac=0.25),
}
ROWS = 19  # ceil(9283 coordinates / bucket 512), for every compressed arm


@pytest.fixture(scope="module")
def ref_params():
    params = jgan.init_gan(jax.random.PRNGKey(0), jgan.GANConfig())
    return jax.tree_util.tree_map(np.asarray, params)


def _port_params(params_np):
    model = wgan.WGAN(wgan.GANConfig(), torch.Generator(), "cpu")
    gan_params_from_jax(params_np, model)
    return tree_map(lambda p: p.detach().clone(), model.param_tree())


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [t.detach().numpy() for t in tree_flatten(tree)[0]]


def _worker_draws(key):
    """z [K, B, L] and eps [K, B, 1] as the reference's vmapped
    ``_game_grads`` draws them from one key."""
    zs, es = [], []
    for kk in jax.random.split(key, K):
        kz, kgp = jax.random.split(kk)
        zs.append(np.asarray(jax.random.normal(kz, (B, LATENT))))
        es.append(np.asarray(jax.random.uniform(kgp, (B, 1))))
    return np.stack(zs), np.stack(es)


def _exchange_draws(key, rows=ROWS):
    return [np.asarray(jax.random.uniform(k, (rows, 512), jnp.float32))
            for k in jax.random.split(key, K)]


def _step_draws(key):
    """The port's two sources for one reference step keyed ``key``."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    z1, e1 = _worker_draws(k1)
    z2, e2 = _worker_draws(k3)
    return [z1, e1, z2, e2], _exchange_draws(k2) + _exchange_draws(k4)


def _real(seed):
    return np.random.RandomState(seed).randn(K, B, 2).astype(np.float32)


def test_params_round_trip(ref_params):
    model = wgan.WGAN(wgan.GANConfig(), torch.Generator(), "cpu")
    back = gan_params_to_jax(gan_params_from_jax(ref_params, model))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref_params)
    for a, b in zip(_leaves(back), _leaves(ref_params)):
        np.testing.assert_array_equal(a, b)
    assert sum(a.size for a in _leaves(ref_params)) == 9283


def test_one_worker_dual_vector_matches(ref_params):
    key = jax.random.PRNGKey(5)
    real = _real(1)[0]
    want = jgan._game_grads(jax.tree_util.tree_map(jnp.asarray, ref_params),
                            jnp.asarray(real), key, jgan.GANConfig())
    kz, kgp = jax.random.split(key)
    z = torch.from_numpy(np.array(jax.random.normal(kz, (B, LATENT))))
    eps = torch.from_numpy(np.array(jax.random.uniform(kgp, (B, 1))))
    params = tree_map(lambda p: p.unsqueeze(0), _port_params(ref_params))
    got = wgan._game_grads(params, torch.from_numpy(real)[None], z[None], eps[None], 1.0)
    for a, b in zip(_port_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a[0], b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arm", ["uq8", "uq4", "layerwise"])
def test_compress_tree_bit_equal(ref_params, arm):
    """compress_tree on the reference's gradients with its noise: one worker,
    then all K workers in one call (the reference vmaps over keys)."""
    jex = jax_make_exchange(JAX_ARMS[arm])
    grads = jax.vmap(lambda r, k: jgan._game_grads(
        jax.tree_util.tree_map(jnp.asarray, ref_params), r, k, jgan.GANConfig()))(
        jnp.asarray(_real(2)), jax.random.split(jax.random.PRNGKey(6), K))
    key = jax.random.PRNGKey(8)
    keys = jax.random.split(key, K)
    want = jax.vmap(jex.compress_tree)(grads, keys)
    tex = make_exchange(train_gan.arm_exchange(arm))
    tgrads = tree_map(lambda a: torch.from_numpy(np.array(a)), grads)
    before = cuda.launch_counts()
    one = tex.compress_tree(tree_map(lambda g: g[0], tgrads),
                            ReplayNoise([np.asarray(jax.random.uniform(keys[0], (ROWS, 512)))]))
    for a, b in zip(_port_leaves(one), _leaves(want)):
        np.testing.assert_array_equal(a, b[0])
    every = tex.compress_tree(tgrads, ReplayNoise(_exchange_draws(key)), workers=True)
    for a, b in zip(_port_leaves(every), _leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert cuda.launch_counts() == before  # CPU tensors: the plain version


def _run_reference(ref_params, arm, keys, reals):
    cfg = jgan.GANConfig(exchange=JAX_ARMS[arm])
    opt_cfg = jax_opt.OptimizerConfig(name="extra_adam", lr=cfg.lr, grad_clip=0.0)
    params = jax.tree_util.tree_map(jnp.asarray, ref_params)
    state = jax_opt.init_state(opt_cfg, params)
    step = jgan.make_step(cfg, opt_cfg)
    for key, real in zip(keys, reals):
        params, state = step(params, state, jnp.asarray(real), key)
    return _leaves(params)


def _run_port(ref_params, arm, keys, reals):
    cfg = wgan.GANConfig(exchange=train_gan.arm_exchange(arm))
    opt_cfg = opt.OptimizerConfig(name="extra_adam", lr=cfg.lr, grad_clip=0.0)
    params = _port_params(ref_params)
    state = opt.init_state(opt_cfg, params)
    step = wgan.make_step(cfg, opt_cfg)
    for key, real in zip(keys, reals):
        rng_draws, noise_draws = _step_draws(key)
        rng = ReplayNoise(rng_draws)
        noise = ReplayNoise(noise_draws if arm != "fp32" else [])
        params, state = step(params, state, torch.from_numpy(real), rng, noise)
        assert rng.remaining == 0 and noise.remaining == 0
    return _port_leaves(params)


def test_fp32_steps_match(ref_params):
    keys = [jax.random.fold_in(jax.random.PRNGKey(11), i) for i in range(3)]
    reals = [_real(20 + i) for i in range(3)]
    want = _run_reference(ref_params, "fp32", keys, reals)
    got = _run_port(ref_params, "fp32", keys, reals)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_uq8_step_with_replayed_draws(ref_params):
    keys, reals = [jax.random.PRNGKey(12)], [_real(30)]
    want = _run_reference(ref_params, "uq8", keys, reals)
    got = _run_port(ref_params, "uq8", keys, reals)
    lr = wgan.GANConfig().lr
    total = sum(a.size for a in want)
    off = 0
    for a, b in zip(got, want):
        off += int((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).sum())
        assert np.abs(a - b).max() <= 4 * lr
    assert off <= 1e-3 * total, f"{off} of {total} coordinates off"


def test_energy_distance_matches(ref_params):
    key = jax.random.PRNGKey(999)
    want = jgan.energy_distance(key, jax.tree_util.tree_map(jnp.asarray, ref_params),
                                jgan.GANConfig())
    k1, k2 = jax.random.split(key)
    real = torch.from_numpy(np.array(jgan.eight_gaussians(k1, 1024)))
    z = torch.from_numpy(np.array(jax.random.normal(k2, (1024, LATENT))))
    got = wgan.energy_distance(_port_params(ref_params), wgan.GANConfig(), real=real, z=z)
    assert abs(got - want) <= 1e-5, (got, want)


@pytest.mark.parametrize("arm", sorted(JAX_ARMS))
def test_grad_bytes_match(ref_params, arm):
    jex = jax_make_exchange(JAX_ARMS[arm]) if JAX_ARMS[arm] is not None else None
    want = jgan.grad_bytes(jax.tree_util.tree_map(jnp.asarray, ref_params), jex)
    tcfg = train_gan.arm_exchange(arm)
    got = wgan.grad_bytes(_port_params(ref_params),
                          make_exchange(tcfg) if tcfg is not None else None)
    assert got == want


def _randk_draws(key, params_np):
    """The randk25 arm's support draws of one exchange keyed ``key``, in the
    port's order: worker by worker (``split(key, K)``), leaf by leaf (each
    worker's key split once per leaf, JAX leaf order)."""
    sizes = [a.size for a in _leaves(params_np)]
    out = []
    for wk in jax.random.split(key, K):
        for lk, n in zip(jax.random.split(wk, len(sizes)), sizes):
            out.append(np.asarray(jax.random.permutation(lk, n)[:max(1, round(0.25 * n))]))
    return out


def test_randk25_arm_matches_reference(ref_params):
    """The randk25 arm (``ExchangeConfig(compressor="randk",
    rand_frac=0.25)``, as ``examples/train_gan.py`` has it): compress_tree
    of the reference's gradients bit for bit, then 3 steps with every
    draw replayed (params at the fp32 arm's bar: the supports are the
    reference's, so only the last bits of the gradients differ), and its
    bytes per step."""
    assert train_gan.arm_exchange("randk25") == wgan.GANConfig(
        exchange=train_gan.arm_exchange("randk25")).exchange
    jex = jax_make_exchange(JAX_ARMS["randk25"])
    grads = jax.vmap(lambda r, k: jgan._game_grads(
        jax.tree_util.tree_map(jnp.asarray, ref_params), r, k, jgan.GANConfig()))(
        jnp.asarray(_real(3)), jax.random.split(jax.random.PRNGKey(7), K))
    key = jax.random.PRNGKey(9)
    want = jax.vmap(jex.compress_tree)(grads, jax.random.split(key, K))
    tex = make_exchange(train_gan.arm_exchange("randk25"))
    noise = ReplayNoise(_randk_draws(key, ref_params))
    got = tex.compress_tree(tree_map(lambda a: torch.from_numpy(np.array(a)), grads), noise,
                            workers=True)
    assert noise.remaining == 0
    for a, b in zip(_port_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, b)

    keys = [jax.random.fold_in(jax.random.PRNGKey(14), i) for i in range(3)]
    reals = [_real(40 + i) for i in range(3)]
    ref = _run_reference(ref_params, "randk25", keys, reals)
    cfg = wgan.GANConfig(exchange=train_gan.arm_exchange("randk25"))
    opt_cfg = opt.OptimizerConfig(name="extra_adam", lr=cfg.lr, grad_clip=0.0)
    params = _port_params(ref_params)
    state = opt.init_state(opt_cfg, params)
    step = wgan.make_step(cfg, opt_cfg)
    for key, real in zip(keys, reals):
        rng_draws, _ = _step_draws(key)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        rng = ReplayNoise(rng_draws)
        noise = ReplayNoise(_randk_draws(k2, ref_params) + _randk_draws(k4, ref_params))
        params, state = step(params, state, torch.from_numpy(real), rng, noise)
        assert rng.remaining == 0 and noise.remaining == 0
    for a, b in zip(_port_leaves(params), ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    per_leaf = sum(8 * max(1, round(0.25 * a.size)) for a in _leaves(ref_params))
    assert wgan.grad_bytes(_port_params(ref_params), tex) == per_leaf == \
        jgan.grad_bytes(jax.tree_util.tree_map(jnp.asarray, ref_params), jex)


def test_train_gan_cli_on_cpu(capsys):
    out = train_gan.main(["--device", "cpu", "--steps", "3"])
    assert sorted(out) == sorted(train_gan.ARMS)
    for res in out.values():
        assert math.isfinite(res["energy_distance"])
    assert out["uq8"]["bytes_per_step_per_worker"] == 2 * (19 * 512 + 4 * 19)
    assert "layerwise |" in capsys.readouterr().out
