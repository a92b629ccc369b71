"""The port's quantized mean (``repro_torch.core.exchange.qgenx_pmean``)
against the reference ``_qgenx_pmean`` at K = 1, 2 and 4 workers.

The oracle is ``jax.vmap(lambda x: _qgenx_pmean(x, "data", ...),
axis_name="data")`` with ``use_pallas=True`` (the path the port's kernels
follow).  The reference draws each worker's noise as ``fold_in(key,
worker)`` -> ``split`` -> ``uniform``; the test draws the same arrays with
``jax.random`` and hands worker k its own.  K = 1 runs in this process;
K > 1 runs one gloo worker per rank (``_torch_exchange_worker.py``),
started with ``spawn`` on a ``FileStore`` in ``tmp_path``, joined under a
hard timeout, each destroying its process group.

Tolerance: rtol 1e-6, atol 1e-6 on the f32 mean (the reference's own bar
for f32 kernel outputs; the interpreted K-mean differs from the port's in
the last ulp, see test_torch_kernels.py), and the result must be
identical on every worker.

The layerwise compressor's ``Exchange.pmean_tree`` (one qgenx exchange
per plan segment, each with its own quantizer and level table, the noise
keyed ``fold_in(key, seg.key_tag)``) is held to the reference's
``Exchange.pmean_tree`` the same way, on a pytree with leaves on both
sides of the threshold and of different scales: bit for bit at K = 1
(q = inf: the same arithmetic on the same inputs, and the mean of one
worker is that worker's estimate), rtol 1e-6 / atol 1e-6 at K = 2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import _qgenx_pmean
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.quantization import QuantConfig as JaxQuant, uniform_levels as jax_levels
from repro_torch.core.exchange import SingleWorker, make_exchange, qgenx_pmean
from repro_torch.core.noise import ReplayNoise
from repro_torch.core.quantization import QuantConfig, uniform_levels

import _torch_exchange_worker
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, BUCKET = 5000, 256
CASES = [  # (mode, bits, q_norm, bucket): both modes, both widths, both norms
    ("two_phase", 8, math.inf, BUCKET),
    ("two_phase", 4, 2.0, BUCKET),
    ("gather", 8, 2.0, BUCKET),
    ("gather", 4, math.inf, BUCKET),
]


def _inputs(K, seed):
    """Every case's per-worker vectors and noise, drawn as the reference
    draws them (worker k: fold_in(key, k) -> split -> uniform)."""
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    inputs = {}
    for i, (mode, bits, q_norm, bucket) in enumerate(CASES):
        xs = (rng.randn(K, N) * np.linspace(0.1, 3, N)).astype(np.float32)
        for k in range(K):
            k1, k2 = jax.random.split(jax.random.fold_in(key, k))
            if mode == "gather":
                rows = -(-N // bucket)
            else:
                quota = K * bucket
                rows = -(-N // quota) * quota // bucket
            inputs[f"x_{i}_{k}"] = xs[k]
            inputs[f"n1_{i}_{k}"] = np.asarray(jax.random.uniform(k1, (rows, bucket)))
            inputs[f"n2_{i}_{k}"] = np.asarray(jax.random.uniform(k2, (rows // K, bucket)))
    return inputs


def _reference(K, seed, inputs):
    """The oracle's per-worker means for every case."""
    key = jax.random.PRNGKey(seed)
    refs = []
    for i, (mode, bits, q_norm, bucket) in enumerate(CASES):
        s = 15 if bits == 8 else 5
        cfg = JaxQuant(num_levels=s, bits=bits, bucket_size=bucket, q_norm=q_norm)
        xs = np.stack([inputs[f"x_{i}_{k}"] for k in range(K)])
        fn = jax.vmap(lambda x: _qgenx_pmean(x, "data", jax_levels(s), key, cfg, mode,
                                             use_pallas=True), axis_name="data")
        refs.append(np.asarray(fn(jnp.asarray(xs))))
    return refs


def _check(outs, refs):
    for i, ref in enumerate(refs):
        for k, out in enumerate(outs[i]):
            np.testing.assert_allclose(out, ref[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"case {CASES[i]} worker {k}")
            np.testing.assert_array_equal(out, outs[i][0])  # replicated


def test_exchange_matches_reference_one_worker():
    inputs = _inputs(1, seed=0)
    refs = _reference(1, 0, inputs)
    outs = []
    for i, (mode, bits, q_norm, bucket) in enumerate(CASES):
        s = 15 if bits == 8 else 5
        cfg = QuantConfig(num_levels=s, bits=bits, bucket_size=bucket, q_norm=q_norm)
        draws = [inputs[f"n1_{i}_0"]] + ([inputs[f"n2_{i}_0"]] if mode == "two_phase" else [])
        noise = ReplayNoise(draws)
        out = qgenx_pmean(torch.from_numpy(inputs[f"x_{i}_0"]), SingleWorker(),
                          uniform_levels(s, "cpu"), noise, cfg, mode)
        assert noise.remaining == 0 and out.shape == (N,)
        outs.append([out.numpy()])
    _check(outs, refs)


@pytest.mark.parametrize("K", [2, 4])
def test_exchange_matches_reference_gloo_workers(K, tmp_path):
    inputs = _inputs(K, seed=K)
    outs, refs = _torch_exchange_worker.run_group(
        K, tmp_path, inputs, CASES, while_running=lambda: _reference(K, K, inputs))
    _check(outs, refs)


LAYERWISE_CASES = [("two_phase", 4), ("gather", 4), ("two_phase", 8)]  # (mode, low bits)


def _layerwise_inputs(K, seed):
    """Every case's per-worker trees (each leaf at its own scale) and the
    reference's noise for worker k: per plan segment in order,
    fold_in(fold_in(key, seg.key_tag), k) -> split -> the quantize draw
    (and, two_phase, the re-quantize draw)."""
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    leaves = _torch_exchange_worker.LAYERWISE_TREE
    inputs = {}
    for i, (mode, bits) in enumerate(LAYERWISE_CASES):
        jex = jax_make_exchange(_jax_layerwise_config(mode, bits))
        shapes = [jax.ShapeDtypeStruct(shape, jnp.float32)
                  for shape in (leaves[name] for name in sorted(leaves))]
        plan = jex.compressor.plan_for(shapes, jex.cfg, K, "pmean")
        for k in range(K):
            for j, name in enumerate(sorted(leaves)):
                scale = 10.0 ** (j - 2)
                inputs[f"{name}_{i}_{k}"] = (rng.randn(*leaves[name]) * scale).astype(np.float32)
            draws = []
            for seg in plan.segments:
                bucket = seg.quant.bucket_size
                rows = seg.padded // bucket
                k1, k2 = jax.random.split(jax.random.fold_in(
                    jax.random.fold_in(key, seg.key_tag), k))
                draws.append(jax.random.uniform(k1, (rows, bucket)))
                if mode == "two_phase":
                    draws.append(jax.random.uniform(k2, (rows // K, bucket)))
            for j, d in enumerate(draws):
                inputs[f"noise_{i}_{k}_{j}"] = np.asarray(d)
        assert len(plan.segments) == 2  # both size groups exist
    return inputs


def _jax_layerwise_config(mode, bits):
    port = _torch_exchange_worker.layerwise_config(mode, bits)
    q = port.quant
    return JaxExchangeConfig(
        compressor="layerwise", mode=mode, use_pallas=True, axis_name="data",
        layerwise_threshold=port.layerwise_threshold,
        quant=JaxQuant(num_levels=q.num_levels, bits=q.bits, bucket_size=q.bucket_size))


def _layerwise_reference(K, seed, inputs):
    """The reference pmean_tree's per-worker means (leaves concatenated in
    tree order) for every case."""
    key = jax.random.PRNGKey(seed)
    leaves = _torch_exchange_worker.LAYERWISE_TREE
    refs = []
    for i, (mode, bits) in enumerate(LAYERWISE_CASES):
        jex = jax_make_exchange(_jax_layerwise_config(mode, bits))
        state = jex.init_state()
        trees = {name: jnp.asarray(np.stack([inputs[f"{name}_{i}_{k}"] for k in range(K)]))
                 for name in leaves}
        mean = jax.vmap(lambda t: jex.pmean_tree(t, state, key)[0], axis_name="data")(trees)
        refs.append(np.concatenate([np.asarray(mean[name]).reshape(K, -1)
                                    for name in sorted(leaves)], axis=1))
    return refs


def test_layerwise_pmean_tree_matches_reference_one_worker():
    inputs = _layerwise_inputs(1, seed=3)
    refs = _layerwise_reference(1, 3, inputs)
    leaves = _torch_exchange_worker.LAYERWISE_TREE
    for i, case in enumerate(LAYERWISE_CASES):
        ex = make_exchange(_torch_exchange_worker.layerwise_config(*case))
        tree = {name: torch.from_numpy(inputs[f"{name}_{i}_0"]) for name in leaves}
        draws = sorted((k for k in inputs if k.startswith(f"noise_{i}_0_")),
                       key=lambda k: int(k.rsplit("_", 1)[1]))
        noise = ReplayNoise([inputs[k] for k in draws])
        mean, state = ex.pmean_tree(tree, ex.init_state("cpu"), noise)
        assert noise.remaining == 0 and state.step == 1
        got = np.concatenate([mean[name].numpy().ravel() for name in sorted(leaves)])
        np.testing.assert_array_equal(got, refs[i][0], err_msg=f"case {case}")


def test_layerwise_pmean_tree_matches_reference_gloo_workers(tmp_path):
    K = 2
    inputs = _layerwise_inputs(K, seed=4)
    outs, refs = _torch_exchange_worker.run_group(
        K, tmp_path, inputs, LAYERWISE_CASES, target=_torch_exchange_worker.run_layerwise,
        while_running=lambda: _layerwise_reference(K, 4, inputs))
    for i, ref in enumerate(refs):
        for k, out in enumerate(outs[i]):
            np.testing.assert_allclose(out, ref[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"case {LAYERWISE_CASES[i]} worker {k}")
            np.testing.assert_array_equal(out, outs[i][0])  # replicated
