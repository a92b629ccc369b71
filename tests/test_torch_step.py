"""The port's model and Q-GenX train step against the JAX reference, on the
CPU at ``reduced()`` size (tinyllama-1.1b: 2 layers, d_model 256, f32).

Weights come across with ``params_from_jax``; batches come from the
numpy token pipeline.  The reference step is ``make_train_step`` on a
1-device mesh.  On this jax its ``shard_map(..., auto=, check_rep=)`` call
does not build (C1 in ROADMAP.md), so the test swaps in, with
``monkeypatch``, a shim that maps ``auto`` to ``axis_names`` and
``check_rep`` to ``check_vma``; no JAX file changes.

Tolerances (f32; the two frameworks sum matmuls in different orders):

* forward logits: rtol 1e-5, atol 1e-5;
* ``compressor none``, 3 ``de`` and 3 ``optda`` steps: losses rtol 1e-5,
  params rtol 1e-5 with atol 1e-6 (a floor for coordinates near zero);
* one int8 two_phase ``de`` step with the reference's noise replayed: the
  gradients differ in the last bits, which can move a stochastic rounding
  decision where the noise sits within an ulp of the threshold, so the
  loss is held to rtol 1e-5 and the params to rtol 1e-5 / atol 1e-6 on all
  but 1e-5 of the coordinates, with every coordinate within one
  quantization step's update;
* ``extra_adam`` steps (exact ``none`` exchange, and the layerwise int4 /
  int8 two_phase exchange with the noise replayed): loss rtol 1e-5, params
  rtol 1e-5 / atol 1e-6 on all but 1e-4 of the coordinates, and every
  coordinate within 2 lr.  Adam divides each gradient coordinate by its
  own magnitude (plus eps 1e-8), so where the gradient at params_half is
  only a few times eps (a few coordinates in a million), the frameworks'
  different summation orders change the update by a few percent of lr;
  the commit's direction is at most 1 in magnitude, so no coordinate can
  move by more than 2 lr (a flipped sign, or a flipped rounding in the
  compressed exchange);
* the local-update regime at K = 1: ``test_torch_step_sync.py``;
* the adam family's update rules on random pytrees: rtol 1e-6 with an
  atol 1e-8 floor.  The global-norm clip sums in another order, which
  moves each update by about an ulp of its size (lr = 3e-3), and a
  coordinate that the updates bring near zero keeps that absolute error
  (a few 1e-10 per step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.launch.steps as jax_steps
from repro.configs.registry import get_config as jax_get_config
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.quantization import QuantConfig as JaxQuant
from repro.models.model import build as jax_build
from repro.optim import optimizers as jax_opt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.exchange import (
    ExchangeConfig,
    make_exchange,
)
from repro_torch.core.noise import ReplayNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BATCH, SEQ, GAMMA = 4, 16, 0.02


def _shard_map_shim(f, *, mesh, in_specs, out_specs, check_rep=False, auto=frozenset()):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         axis_names=set(mesh.axis_names) - set(auto), check_vma=check_rep)


@pytest.fixture
def reference(monkeypatch):
    monkeypatch.setattr(jax_steps, "shard_map", _shard_map_shim)
    cfg = jax_get_config("tinyllama-1.1b").reduced()
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _batches(n):
    pipe = make_pipeline(512, BATCH, SEQ, seed=0)
    return [next(pipe) for _ in range(n)]


def _port_model(params_np):
    cfg = get_config("tinyllama-1.1b").reduced()
    return params_from_jax(params_np, build(cfg, device="cpu"))


def _run_reference(model, params_np, ex_cfg, method, batches, keys, name="qgenx"):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    opt_cfg = jax_opt.OptimizerConfig(name=name, gamma_scale=GAMMA, method=method)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_state = jax_opt.init_state(opt_cfg, params)
    ex = jax_make_exchange(ex_cfg)
    ex_state = ex.init_state()
    step = jax.jit(jax_steps.make_train_step(model, opt_cfg, exchange=ex, mesh=mesh))
    losses, wires = [], []
    with mesh:
        for b, key in zip(batches, keys):
            batch = {k: jnp.asarray(v) for k, v in b.items()}
            params, opt_state, ex_state, m = step(params, opt_state, ex_state, batch, key)
            losses.append(float(m["loss"]))
            wires.append(float(m["wire_bytes"]))
    return losses, wires, [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]


def _run_port(params_np, ex_cfg, method, batches, noise=None, name="qgenx"):
    model = _port_model(params_np)
    opt_cfg = OptimizerConfig(name=name, gamma_scale=GAMMA, method=method)
    ex = make_exchange(ex_cfg)
    step = make_train_step(model, opt_cfg, ex)
    opt_state = port_opt.init_state(opt_cfg, model.param_leaves())
    ex_state = ex.init_state("cpu")
    losses, wires = [], []
    for b in batches:
        opt_state, ex_state, m = step(opt_state, ex_state, to_device(b, "cpu"), noise)
        losses.append(float(m["loss"]))
        wires.append(float(m["wire_bytes"]))
    return losses, wires, [p.detach().numpy() for p in model.param_leaves()]


def test_forward_logits_match(reference):
    model, params_np = reference
    b = _batches(1)[0]
    want = np.asarray(model.forward(jax.tree_util.tree_map(jnp.asarray, params_np),
                                    {"tokens": jnp.asarray(b["tokens"])})[0])
    port = _port_model(params_np)
    with torch.no_grad():
        got = port(to_device(b, "cpu")["tokens"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_params_round_trip(reference):
    _, params_np = reference
    back = params_to_jax(_port_model(params_np))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params_np)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params_np)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["de", "optda"])
def test_exact_exchange_steps_match(reference, method):
    """compressor none: three steps, losses and params."""
    model, params_np = reference
    batches = _batches(3)
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(3)]
    jl, jw, jp = _run_reference(model, params_np, JaxExchangeConfig(compressor="none"),
                                method, batches, keys)
    tl, tw, tp = _run_port(params_np, ExchangeConfig(compressor="none"), method, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tw == jw
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _replayed_noise(key, n_live, bucket, calls):
    """The reference's per-exchange noise at K = 1: the step splits its key
    into one key per exchange; each exchange folds in worker 0, splits, and
    draws the quantize then the re-quantize noise."""
    rows = -(-n_live // bucket)
    draws = []
    for k in jax.random.split(key)[:calls]:
        a, b = jax.random.split(jax.random.fold_in(k, 0))
        draws += [np.asarray(jax.random.uniform(a, (rows, bucket))),
                  np.asarray(jax.random.uniform(b, (rows, bucket)))]
    return ReplayNoise(draws)


def _assert_adam_close(tp, jp, lr):
    """Params within rtol 1e-5 / atol 1e-6 on all but 1e-4 of the
    coordinates, every coordinate within 2 lr (see the module docstring)."""
    total = sum(a.size for a in jp)
    off = 0
    for a, b in zip(tp, jp):
        off += int((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).sum())
        assert np.abs(a - b).max() <= 2 * lr
    assert off <= 1e-4 * total, f"{off} of {total} coordinates off"


def test_int8_two_phase_step_with_replayed_noise(reference):
    model, params_np = reference
    batches = _batches(1)
    key = jax.random.PRNGKey(42)
    jquant = JaxQuant(num_levels=15, bits=8, bucket_size=512)
    jl, jw, jp = _run_reference(
        model, params_np, JaxExchangeConfig(compressor="qgenx", quant=jquant,
                                            mode="two_phase", use_pallas=True),
        "de", batches, [key])
    n_live = sum(a.size for a in jax.tree_util.tree_leaves(params_np))
    noise = _replayed_noise(key, n_live, 512, calls=2)
    tquant = QuantConfig(num_levels=15, bits=8, bucket_size=512)
    tl, tw, tp = _run_port(params_np, ExchangeConfig(compressor="qgenx", quant=tquant,
                                                     mode="two_phase"), "de", batches, noise)
    assert noise.remaining == 0
    assert tw == jw
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    total = sum(a.size for a in jp)
    off = 0
    for a, b in zip(tp, jp):
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        off += int((~close).sum())
        # one flipped rounding moves a coordinate by at most one level step
        # of its bucket, scaled by the step size: far below the weights
        assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1.0)
    assert off <= 1e-5 * total, f"{off} of {total} coordinates off"


def test_reduced_config_matches_reference():
    want = jax_get_config("tinyllama-1.1b").reduced()
    got = get_config("tinyllama-1.1b").reduced()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    full = get_config("tinyllama-1.1b")
    assert full.param_count() == jax_get_config("tinyllama-1.1b").param_count()


def test_extra_adam_exact_exchange_step_matches(reference):
    model, params_np = reference
    batches = _batches(1)
    keys = [jax.random.PRNGKey(3)]
    jl, jw, jp = _run_reference(model, params_np, JaxExchangeConfig(compressor="none"),
                                "de", batches, keys, name="extra_adam")
    tl, tw, tp = _run_port(params_np, ExchangeConfig(compressor="none"), "de", batches,
                           name="extra_adam")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tw == jw
    _assert_adam_close(tp, jp, OptimizerConfig().lr)


def _layerwise_noise(key, plan, bucket, calls):
    """The reference's layerwise noise at K = 1: per exchange key, per plan
    segment in order, fold_in(key, seg.key_tag), then the worker fold and
    the quantize / re-quantize split."""
    draws = []
    for k in jax.random.split(key)[:calls]:
        for seg in plan.segments:
            rows = seg.padded // bucket
            a, b = jax.random.split(jax.random.fold_in(jax.random.fold_in(k, seg.key_tag), 0))
            draws += [np.asarray(jax.random.uniform(a, (rows, bucket))),
                      np.asarray(jax.random.uniform(b, (rows, bucket)))]
    return ReplayNoise(draws)


def test_extra_adam_layerwise_step_with_replayed_noise(reference):
    model, params_np = reference
    batches = _batches(1)
    key = jax.random.PRNGKey(44)
    jcfg = JaxExchangeConfig(compressor="layerwise", mode="two_phase", use_pallas=True,
                             quant=JaxQuant(num_levels=5, bits=4, bucket_size=512))
    tcfg = ExchangeConfig(compressor="layerwise", mode="two_phase",
                          quant=QuantConfig(num_levels=5, bits=4, bucket_size=512))
    jl, jw, jp = _run_reference(model, params_np, jcfg, "de", batches, [key],
                                name="extra_adam")
    leaves = [torch.from_numpy(np.asarray(a)) for a in jax.tree_util.tree_leaves(params_np)]
    ex = make_exchange(tcfg)
    plan = ex.plan_for(leaves)
    assert [s.quant.bits for s in plan.segments] == [4, 8]  # both size groups exist
    noise = _layerwise_noise(key, plan, 512, calls=2)
    tl, tw, tp = _run_port(params_np, tcfg, "de", batches, noise, name="extra_adam")
    assert noise.remaining == 0
    assert tw == jw
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_adam_close(tp, jp, OptimizerConfig().lr)


@pytest.mark.parametrize("axis_size", [1, 2, 8])
@pytest.mark.parametrize("mode", ["gather", "two_phase"])
def test_layerwise_wire_bytes_match(reference, mode, axis_size):
    _, params_np = reference
    jleaves = jax.tree_util.tree_leaves(params_np)
    tleaves = [torch.from_numpy(np.asarray(a)) for a in jleaves]
    for kw in (dict(), dict(quant_small=(8, 7)), dict(layerwise_threshold=1000)):
        jkw = dict(kw)
        tkw = dict(kw)
        if "quant_small" in kw:
            jkw["quant_small"] = JaxQuant(num_levels=7, bits=8, bucket_size=256)
            tkw["quant_small"] = QuantConfig(num_levels=7, bits=8, bucket_size=256)
        jex = jax_make_exchange(JaxExchangeConfig(compressor="layerwise", mode=mode, **jkw))
        tex = make_exchange(ExchangeConfig(compressor="layerwise", mode=mode, **tkw))
        assert tex.wire_bytes_tree(tleaves, axis_size) == jex.wire_bytes_tree(jleaves,
                                                                              axis_size)
        assert tex.compress_wire_bytes_tree(tleaves) == jex.compress_wire_bytes_tree(jleaves)
        n = sum(a.size for a in jleaves)
        assert tex.wire_bytes(n, axis_size) == jex.wire_bytes(n, axis_size)
        assert tex.compress_wire_bytes(n) == jex.compress_wire_bytes(n)


def _random_tree(rng, scale=1.0):
    return {"w": (rng.randn(33, 17) * scale).astype(np.float32),
            "blocks": [{"b": (rng.randn(17) * scale).astype(np.float32),
                        "k": (rng.randn(4, 5, 6) * scale).astype(np.float32)}] * 2,
            "tiny": (rng.randn(3) * 1e-9 * scale).astype(np.float32)}


@pytest.mark.parametrize("name", ["adam", "extra_adam", "optimistic_adam"])
def test_adam_family_matches_reference(name):
    """Several steps of each update rule on random pytrees (weight decay and
    clipping on), every intermediate held to the reference's."""
    rng = np.random.RandomState(0)
    kw = dict(name=name, lr=3e-3, weight_decay=0.01, grad_clip=5.0)
    jcfg, tcfg = jax_opt.OptimizerConfig(**kw), OptimizerConfig(**kw)
    params_np = _random_tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    tparams = jax.tree_util.tree_map(torch.from_numpy, params_np)
    jstate, tstate = jax_opt.init_state(jcfg, jparams), port_opt.init_state(tcfg, tparams)

    def check(t, j):
        for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda x: x.numpy(), t)), jax.tree_util.tree_leaves(j)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-8)

    for _ in range(4):
        g1, g2 = _random_tree(rng, 3.0), _random_tree(rng, 3.0)
        j1 = jax.tree_util.tree_map(jnp.asarray, g1)
        j2 = jax.tree_util.tree_map(jnp.asarray, g2)
        t1 = jax.tree_util.tree_map(torch.from_numpy, g1)
        t2 = jax.tree_util.tree_map(torch.from_numpy, g2)
        if name == "adam":
            jparams, jstate = jax_opt.adam_step(jcfg, jparams, jstate, j2)
            tparams, tstate = port_opt.adam_step(tcfg, tparams, tstate, t2)
        else:
            jg = j1 if name == "extra_adam" else jstate.prev_half_grad
            tg = t1 if name == "extra_adam" else tstate.prev_half_grad
            check(port_opt.extrapolate(tcfg, tparams, tstate, tg),
                  jax_opt.extrapolate(jcfg, jparams, jstate, jg))
            jparams, jstate = jax_opt.commit(jcfg, jparams, jstate, j2)
            tparams, tstate = port_opt.commit(tcfg, tparams, tstate, t2)
        check(tparams, jparams)
        check(tstate.mu, jstate.mu)
        check(tstate.nu, jstate.nu)
        assert tstate.count == int(jstate.count)
        assert (tstate.prev_half_grad is None) == (jstate.prev_half_grad is None)
