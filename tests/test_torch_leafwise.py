"""The port's ``leafwise`` mode (with ``allreduce_fallback``) and its
per-call layout (``use_plan=False``) against the reference.

The leafwise exchange (``qgenx_pmean_leafwise``) against the reference's
``_qgenx_pmean_leafwise`` (through ``pmean_tree`` under ``jax.jit(jax.vmap(...,
axis_name="data"))``), on ``_torch_layouts.TREE``, whose trailing dims
include 31 and 77 (odd: int4 travels unpacked as int8 there), each
worker's noise drawn as the reference draws it and replayed:

* kernel 1 at ``bucket`` = a leaf's trailing dim: the payload bytes and
  norms equal the reference's leafwise rounding (``_round_indices_select``
  and ``pack4_rows`` when the dim is even) exactly, int4 at q = inf and
  int8 at q = 2;
* the mean at K = 1: bit for bit at q = inf, gathered (int8 and int4) and
  under the fallback (int8); at q = 2 within rtol 1e-6 (the L2 norm's sum
  order);
* at K = 3 over gloo workers (int8, int4, and int4 under the fallback):
  within rtol 1e-6 / atol 1e-6 (kernel 4
  multiplies the sum by 1/K where the reference divides: the last ulp),
  identical on every worker;
* the recorder's ``leaf_payload`` / ``leaf_norms`` (``leaf_fallback``)
  operands, ``leafwise_buffer_bytes`` and ``wire_bytes`` /
  ``wire_bytes_tree`` equal the reference's; QAda's ``_leafwise_hist``
  equals the reference's.

The per-call layout: qgenx and layerwise ``pmean_tree`` under
``use_plan=False`` equal the planned layout and the reference's per-call
path bit for bit at K = 1; ``compress_tree`` leaf by leaf (the GAN
testbed's uq8 and layerwise arms, K = 3 workers in one call) equals the reference's
``quantize_dequantize_pytree`` / per-leaf ``compress`` bit for bit, and
``compress_wire_bytes_tree`` / ``coded_bits_tree`` the reference's.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_exchange_worker as worker
import _torch_layouts as lay
from repro.core import exchange as jx
from repro.gan import wgan as jgan
from repro.kernels.common import pack4_rows as jax_pack4_rows
from repro_torch.core import exchange as tx
from repro_torch.core.noise import ReplayNoise
from repro_torch.core.quantization import QuantConfig, uniform_levels
from repro_torch.core.tree import tree_map
from repro_torch.gan import wgan
from repro_torch.kernels.quantize import quantize_blocks
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = [s for _, s in lay.tree_paths()]


def _inputs(K, seed):
    return lay.tree_leaves_np(np.random.RandomState(seed), K)


def _reference(jex, per_worker, key, state=None):
    K = len(per_worker)
    st = jex.init_state() if state is None else state
    stacked = lay.as_tree([jnp.asarray(np.stack([w[j] for w in per_worker]))
                           for j in range(len(SHAPES))])
    mean, new = lay.jit(jax.vmap(lambda t, s, k: jex.pmean_tree(t, s, k), axis_name="data",
                                 in_axes=(0, None, None)))(stacked, st, key)
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(mean)]
    return [[l[k] for l in leaves] for k in range(K)], jax.tree_util.tree_map(lambda x: x[0],
                                                                               new)


def _port(ex, leaves_np, noise):
    tree = lay.as_tree([torch.from_numpy(a) for a in leaves_np])
    mean, st = ex.pmean_tree(tree, ex.init_state("cpu"), noise)
    return [m.numpy() for m in tx.tree_flatten(mean)[0]], st


def _cat(leaves):
    return np.concatenate([np.asarray(l).ravel() for l in leaves])


# -- kernel 1 at a leaf's trailing dim ------------------------------------------


@functools.partial(lay.jit, static_argnums=(3, 4))
def _jax_leaf_rounding(gf, r, lv, q_is_inf, pack4):
    """The reference's leafwise rounding of rows ``gf`` with noise ``r``
    (``_qgenx_pmean_leafwise``'s norm, bracket and packing): (norms
    [rows, 1], payload)."""
    if q_is_inf:
        jn = jnp.max(jnp.abs(gf), axis=-1, keepdims=True)
    else:
        jn = jnp.sqrt(jnp.sum(gf * gf, axis=-1, keepdims=True))
    u = jnp.clip(jnp.abs(gf) / jnp.where(jn > 0, jn, 1.0), 0.0, 1.0)
    tau, _, _, xi = jx._bracket_select(u, lv)
    idx = tau + (r < xi).astype(jnp.int32)
    signed = jnp.where(gf < 0, -idx, idx)
    return jn, jax_pack4_rows(signed) if pack4 else signed.astype(jnp.int8)


@pytest.mark.parametrize("bits,q_norm", [(4, math.inf), (8, 2.0)])
def test_leaf_payload_bytes_match_reference(bits, q_norm):
    q = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, q_norm=q_norm)
    lv = uniform_levels(q.num_levels, "cpu")
    key = jax.random.PRNGKey(3)
    for j, g in enumerate(_inputs(1, 5)[0]):
        d = g.shape[-1]
        x2d = g.reshape(-1, d)
        r = np.array(jax.random.uniform(jax.random.fold_in(key, j), g.shape)).reshape(-1, d)
        pack4 = bits == 4 and d % 2 == 0
        payload, norms = quantize_blocks(torch.from_numpy(x2d), torch.from_numpy(r), lv,
                                         num_symbols=q.num_symbols, q_is_inf=q.q_is_inf,
                                         bits=4 if pack4 else 8)
        jn, want = _jax_leaf_rounding(jnp.asarray(x2d), jnp.asarray(r), jnp.asarray(lv.numpy()),
                                      math.isinf(q_norm), pack4)
        np.testing.assert_allclose(norms.numpy(), np.asarray(jn)[:, 0], rtol=1e-6)
        np.testing.assert_array_equal(payload.numpy(), np.asarray(want))


# -- the leafwise mean ---------------------------------------------------------

LEAFWISE = [  # (bits, q_norm, allreduce_fallback); int4 under the fallback: the K = 3 test
    (8, math.inf, False), (4, math.inf, False), (4, 2.0, False), (8, math.inf, True),
]


def _leafwise_cfg(bits, q_norm, fallback, **kw):
    return lay.port_config("qgenx", bits, "leafwise", q_norm=q_norm,
                           allreduce_fallback=fallback, **kw)


@pytest.mark.parametrize("bits,q_norm,fallback", LEAFWISE)
def test_leafwise_matches_reference_one_worker(bits, q_norm, fallback):
    cfg = _leafwise_cfg(bits, q_norm, fallback)
    jex = jx.make_exchange(lay.jax_config(cfg))
    key = jax.random.PRNGKey(9)
    per_worker = _inputs(1, 6)
    want, _ = _reference(jex, per_worker, key)
    ex = tx.make_exchange(cfg)
    noise = ReplayNoise(lay.leafwise_draws(SHAPES, key, 0))
    tx.wire_trace_start()
    got, st = _port(ex, per_worker[0], noise)
    rec = tx.wire_trace_stop()
    assert noise.remaining == 0 and st.step == 1
    if math.isinf(q_norm):
        np.testing.assert_array_equal(_cat(got), _cat(want[0]))
    else:
        np.testing.assert_allclose(_cat(got), _cat(want[0]), rtol=1e-6, atol=1e-7)
    # the recorder against the per-leaf accounting of both packages
    names = ["leaf_fallback"] if fallback else ["leaf_payload", "leaf_norms"]
    assert [n for n, _ in rec] == names * len(SHAPES)
    for j, s in enumerate(SHAPES):
        sizes = tx.leafwise_buffer_bytes(s, cfg.quant)
        assert sizes == jx.leafwise_buffer_bytes(s, lay.jax_config(cfg).quant)
        want_bytes = [4 * math.prod(s)] if fallback else list(sizes.values())
        assert [b for _, b in rec[len(names) * j: len(names) * (j + 1)]] == want_bytes
    tree = lay.as_tree([torch.zeros(s) for s in SHAPES])
    jtree = lay.as_tree([jnp.zeros(s) for s in SHAPES])
    assert ex.wire_bytes_tree(tree, 1) == jex.wire_bytes_tree(jtree, 1) == sum(
        b for _, b in rec)
    for n in (31, 64, 1000):
        assert ex.wire_bytes(n, 1) == jex.wire_bytes(n, 1)


def test_leafwise_matches_reference_gloo_workers(tmp_path):
    K = 3
    cases = [(dict(compressor="qgenx", bits=8, mode="leafwise"), 1),
             (dict(compressor="qgenx", bits=4, mode="leafwise", allreduce_fallback=True), 1),
             (dict(compressor="qgenx", bits=4, mode="leafwise"), 1)]
    inputs, refs = {}, []
    for i, (kw, _) in enumerate(cases):
        jex = jx.make_exchange(lay.jax_config(lay.port_config(**kw)))
        per_worker = _inputs(K, 30 + i)
        key = jax.random.PRNGKey(40 + i)
        for k in range(K):
            for j, a in enumerate(per_worker[k]):
                inputs[f"x_{i}_0_{k}_{j}"] = a
            for j, d in enumerate(lay.leafwise_draws(SHAPES, key, k)):
                inputs[f"noise_{i}_{k}_{j}"] = d
        refs.append((jex, per_worker, key))
    outs, want = worker.run_group(
        K, tmp_path, inputs, cases, target=worker.run_layouts,
        while_running=lambda: [_reference(*r)[0] for r in refs])
    for i in range(len(cases)):
        for k in range(K):
            got = outs[i][k]["mean_0"]
            np.testing.assert_allclose(got, _cat(want[i][k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"case {i} worker {k}")
            np.testing.assert_array_equal(got, outs[i][0]["mean_0"])


def test_leafwise_qada_histogram_matches_reference():
    cfg = _leafwise_cfg(8, math.inf, False, level_schedule="qada", level_update_every=100)
    jex = jx.make_exchange(lay.jax_config(cfg))
    ex = tx.make_exchange(cfg)
    leaves = _inputs(1, 7)[0]
    want = lay.jit(jex._leafwise_hist)(lay.as_tree([jnp.asarray(a) for a in leaves]))
    got = ex._leafwise_hist([torch.from_numpy(a) for a in leaves])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    key = jax.random.PRNGKey(2)
    _, jst = _reference(jex, [leaves], key)
    _, st = _port(ex, leaves, ReplayNoise(lay.leafwise_draws(SHAPES, key, 0)))
    np.testing.assert_allclose(st.hist.numpy(), np.asarray(jst.hist), rtol=1e-6)


def test_flat_mean_refuses_leafwise():
    with pytest.raises(ValueError, match="mode='leafwise' is a tree exchange; use pmean_tree"):
        tx.qgenx_pmean(torch.zeros(8), tx.SingleWorker(), uniform_levels(15, "cpu"),
                       ReplayNoise([]), QuantConfig(), "leafwise")


# -- the per-call layout -------------------------------------------------------

PER_CALL = [("qgenx", "gather", 8), ("qgenx", "two_phase", 4), ("layerwise", "two_phase", 4),
            ("layerwise", "gather", 8), ("randk", "gather", 8)]


@pytest.mark.parametrize("compressor,mode,bits", PER_CALL)
def test_per_call_layout_matches_planned_and_reference(compressor, mode, bits):
    cfg = lay.port_config(compressor, bits, mode, use_plan=False)
    planned = lay.port_config(compressor, bits, mode)
    jex = jx.make_exchange(lay.jax_config(cfg))
    key = jax.random.PRNGKey(13)
    per_worker = _inputs(1, 8)
    want, _ = _reference(jex, per_worker, key)
    if compressor == "randk":
        n = sum(math.prod(s) for s in SHAPES)
        kk = jax.random.fold_in(key, 0)
        draws = [np.asarray(jax.random.permutation(kk, n)[:jx._randk_k(n, jex.cfg)])]
    else:
        draws = lay.planned_draws(jx.make_exchange(lay.jax_config(planned)), SHAPES, key, 1, 0)
    got, _ = _port(tx.make_exchange(cfg), per_worker[0], ReplayNoise(draws))
    plan_got, _ = _port(tx.make_exchange(planned), per_worker[0], ReplayNoise(draws))
    np.testing.assert_array_equal(_cat(got), _cat(plan_got))
    np.testing.assert_array_equal(_cat(got), _cat(want[0]))


GAN_ARMS = {"uq8": ("qgenx", 8), "layerwise": ("layerwise", 4)}  # layerwise holds int4 too


@pytest.fixture(scope="module")
def gan_grads():
    """K = 3 workers' WGAN-GP dual vectors from the reference."""
    params = jgan.init_gan(jax.random.PRNGKey(0), jgan.GANConfig())
    real = np.random.RandomState(2).randn(3, 256, 2).astype(np.float32)
    return lay.jit(jax.vmap(lambda r, k: jgan._game_grads(params, r, k, jgan.GANConfig())))(
        jnp.asarray(real), jax.random.split(jax.random.PRNGKey(6), 3))


@pytest.mark.parametrize("arm", GAN_ARMS)
def test_per_call_compress_tree_matches_reference(arm, gan_grads):
    """The GAN testbed's per-worker compression leaf by leaf: K = 3 workers'
    gradients in one call, against the reference's per-worker
    ``compress_tree`` under ``use_plan=False``."""
    compressor, bits = GAN_ARMS[arm]
    from repro_torch.core.exchange import ExchangeConfig

    q = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=512)
    cfg = ExchangeConfig(compressor=compressor, quant=q, use_plan=False,
                         layerwise_threshold=2048)
    jex = jx.make_exchange(lay.jax_config(cfg))
    K = 3
    grads = gan_grads
    keys = jax.random.split(jax.random.PRNGKey(8), K)
    want = lay.jit(jax.vmap(jex.compress_tree))(grads, keys)
    leaves = jax.tree_util.tree_leaves(grads)
    # the port asks leaf by leaf, worker by worker within a leaf
    per_worker = [jax.random.split(k, len(leaves)) for k in keys]
    draws = []
    for j, l in enumerate(leaves):
        n = math.prod(l.shape[1:])
        if compressor == "layerwise" and n > cfg.layerwise_threshold:
            b = q.bucket_size
        else:
            b = (cfg.quant_small if compressor == "layerwise" else q).bucket_size
        for w in range(K):
            draws.append(np.asarray(jax.random.uniform(per_worker[w][j], (-(-n // b), b))))
    tex = tx.make_exchange(cfg)
    noise = ReplayNoise(draws)
    got = tex.compress_tree(tree_map(lambda a: torch.from_numpy(np.array(a)), grads), noise,
                            workers=True)
    assert noise.remaining == 0
    for a, b in zip(tx.tree_flatten(got)[0], jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one = jax.tree_util.tree_map(lambda g: g[0], grads)
    assert tex.compress_wire_bytes_tree(tree_map(lambda a: torch.from_numpy(np.array(a)), one)) \
        == jex.compress_wire_bytes_tree(one)


def test_per_call_coded_bits_and_the_gan_arm_run():
    cfg = lay.port_config("qgenx", 8, "two_phase", use_plan=False)
    jex = jx.make_exchange(lay.jax_config(cfg))
    ex = tx.make_exchange(cfg)
    leaves = _inputs(1, 9)[0]
    st = ex.init_state("cpu")
    got = ex.coded_bits_tree([torch.from_numpy(a) for a in leaves], st)
    want = jex.coded_bits_tree(lay.as_tree([jnp.asarray(a) for a in leaves]),
                               jex.init_state())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    planned = tx.make_exchange(lay.port_config("qgenx", 8, "two_phase"))
    assert float(planned.coded_bits_tree([torch.from_numpy(a) for a in leaves], st)) == \
        float(got)
    # the GAN testbed's layerwise arm per leaf: a few steps, finite, billed
    # leaf by leaf as the reference bills it
    lw = tx.ExchangeConfig(compressor="layerwise", use_plan=False, layerwise_threshold=2048,
                           quant=QuantConfig(num_levels=5, bits=4, bucket_size=512))
    out = wgan.train(wgan.GANConfig(exchange=lw, batch_per_worker=32), steps=3, seed=0,
                     device="cpu")
    assert math.isfinite(out["energy_distance"])
    jparams = jgan.init_gan(jax.random.PRNGKey(0), jgan.GANConfig())
    assert out["bytes_per_step_per_worker"] == 2 * jgan.grad_bytes(
        jparams, jx.make_exchange(lay.jax_config(lw)))
