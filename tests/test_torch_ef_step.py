"""The port's train step under the sparse compressors (``ef21-topk``,
``randk``) against the reference at K = 1, and their error memory in
checkpoints (reduced tinyllama-1.1b, f32, batch 4 x seq 16, CPU).

The reference step is ``make_train_step`` on a 1-device mesh under the
``shard_map`` shim of ``tests/test_torch_step.py`` (C1 in ROADMAP.md);
its exchange state is built with ``init_state(template=params,
num_workers=1)``.  randk's support draws are recomputed from the step's
keys (``split(key)`` into the two exchanges' keys, an ``optda`` step
using the second only; each folded with worker 0, then ``permutation(key,
n)[:k]``) and replayed; ``ef21-topk`` draws nothing.

Tolerances, those of ``tests/test_torch_step.py`` for the exact
exchange: losses rtol 1e-5, params, the optimizer state's f32 trees and
the ``[1, n]`` error memory rtol 1e-5 / atol 1e-6, ``wire_bytes`` and the
optimizer's ``count`` exactly.  ``ef21-topk``'s support follows the
ranking of |g - h|: where the frameworks' gradients differ in their last
bits, two coordinates on either side of the k-th largest magnitude can
swap, and then both coordinates of the mean, of the memory and of the
update differ by a whole innovation.  So for ``ef21-topk`` all but 1e-5
of the coordinates (14 of the 1,443,072) are held to that bar, and every
coordinate of the params within 1 % of its leaf's largest weight (the
bar ``tests/test_torch_step.py`` sets for a flipped rounding).  Measured:
``de`` 0 params and 1 memory coordinate off, ``optda`` 1 and 2 (the
memory 2.6e-4 apart there: one swap).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.launch.steps as jax_steps
from repro.checkpoint import checkpointing as jax_ckpt
from repro.configs.registry import get_config as jax_get_config
from repro.core import extragradient as jeg
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.models.model import build as jax_build
from repro.optim import optimizers as jax_opt
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import extragradient as eg
from repro_torch.core import vi
from repro_torch.core.exchange import ExchangeConfig, make_exchange
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BATCH, SEQ, GAMMA, STEPS = 4, 16, 0.02, 3
FRAC = 0.25


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


def _exchange_keys(method, key):
    k1, k2 = jax.random.split(key)
    return [k2] if method == "optda" else [k1, k2]


def _run_reference(model, params_np, comp, method, batches, keys):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    opt_cfg = jax_opt.OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method=method)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_state = jax_opt.init_state(opt_cfg, params)
    ex = jax_make_exchange(JaxExchangeConfig(compressor=comp, rand_frac=FRAC,
                                             ef_topk_frac=FRAC))
    ex_state = ex.init_state(template=params, num_workers=1)
    step = jax.jit(jax_steps.make_train_step(model, opt_cfg, exchange=ex, mesh=mesh))
    losses, wires = [], []
    with mesh:
        for b, key in zip(batches, keys):
            batch = {k: jnp.asarray(v) for k, v in b.items()}
            params, opt_state, ex_state, m = step(params, opt_state, ex_state, batch, key)
            losses.append(float(m["loss"]))
            wires.append(float(m["wire_bytes"]))
    return (losses, wires, [np.asarray(l) for l in jax.tree_util.tree_leaves(params)],
            jax.tree_util.tree_map(np.asarray, opt_state), np.asarray(ex_state.error))


def _run_port(params_np, comp, method, batches, noise):
    model = params_from_jax(params_np, build(get_config("tinyllama-1.1b").reduced(),
                                             device="cpu"))
    opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method=method)
    ex = make_exchange(ExchangeConfig(compressor=comp, rand_frac=FRAC, ef_topk_frac=FRAC))
    step = make_train_step(model, opt_cfg, ex)
    opt_state = port_opt.init_state(opt_cfg, model.param_leaves())
    ex_state = ex.init_state("cpu", template=model.param_leaves(), num_workers=1)
    losses, wires = [], []
    for b in batches:
        opt_state, ex_state, m = step(opt_state, ex_state, to_device(b, "cpu"), noise)
        losses.append(float(m["loss"]))
        wires.append(float(m["wire_bytes"]))
    return (losses, wires, [p.detach().numpy() for p in model.param_leaves()],
            convert.opt_state_to_jax(opt_state, model), ex_state.error.numpy())


def _count_off(got, want):
    return int((~np.isclose(got, want, rtol=1e-5, atol=1e-6)).sum())


@pytest.mark.parametrize("method", ["de", "optda"])
@pytest.mark.parametrize("comp", ["ef21-topk", "randk"])
def test_steps_match_reference(reference, comp, method):
    """Three steps: losses, wire bytes, params, the optimizer state and the
    error memory."""
    model, params_np = reference
    batches = _batches(STEPS)
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), t) for t in range(STEPS)]
    jl, jw, jp, jopt, jerr = _run_reference(model, params_np, comp, method, batches, keys)
    n = sum(a.size for a in jp)
    k = max(1, round(FRAC * n))
    draws = []
    if comp == "randk":
        draws = [np.asarray(jax.random.permutation(jax.random.fold_in(ek, 0), n)[:k])
                 for key in keys for ek in _exchange_keys(method, key)]
    noise = ReplayNoise(draws)
    tl, tw, tp, topt, terr = _run_port(params_np, comp, method, batches, noise)
    assert noise.remaining == 0
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    calls = 1 if method == "optda" else 2
    assert tw == jw == [calls * 8.0 * k] * STEPS
    allowed = 1e-5 * n if comp == "ef21-topk" else 0
    off = sum(_count_off(a, b) for a, b in zip(tp, jp))
    assert off <= allowed, f"{off} of {n} param coordinates off"
    for a, b in zip(tp, jp):
        assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1.0)
    assert topt.count == jopt.count == STEPS
    np.testing.assert_allclose(topt.sum_sq, jopt.sum_sq, rtol=1e-5)
    fields = ["y", "anchor"] + (["prev_half"] if method == "optda" else [])
    for f in fields:
        off = sum(_count_off(a, b) for a, b in zip(jax.tree_util.tree_leaves(getattr(topt, f)),
                                                  jax.tree_util.tree_leaves(getattr(jopt, f))))
        assert off <= allowed, f"{f}: {off} coordinates off"
    assert terr.shape == jerr.shape == ((1, n) if comp == "ef21-topk" else (1,))
    assert _count_off(terr, jerr) <= allowed


def test_local_steps_leave_the_error_memory_untouched():
    """``sync_every=2``: step 0 is local (no exchange, memory unchanged,
    0 wire bytes), step 1 syncs (two exchanges of 8k bytes each)."""
    model = build(get_config("tinyllama-1.1b").reduced(), device="cpu")
    ex = make_exchange(ExchangeConfig(compressor="ef21-topk", ef_topk_frac=0.1, sync_every=2))
    opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
    step = make_train_step(model, opt_cfg, ex)
    opt_state = port_opt.init_state(opt_cfg, model.param_leaves())
    st = ex.init_state("cpu", template=model.param_leaves(), num_workers=1)
    n = st.error.shape[1]
    batches = _batches(2)
    opt_state, st, m0 = step(opt_state, st, to_device(batches[0], "cpu"), ReplayNoise([]))
    assert st.step == 0 and not st.error.any() and m0["wire_bytes"] == 0
    opt_state, st, m1 = step(opt_state, st, to_device(batches[1], "cpu"), ReplayNoise([]))
    assert st.step == 2 and bool(st.error.any())
    assert m1["wire_bytes"] == 2 * 8.0 * round(0.1 * n) + 4.0 * ex.cfg.drift_probe


def _jax_ex_state(error):
    jex = jax_make_exchange(JaxExchangeConfig(compressor="ef21-topk"))
    st = jex.init_state()
    import dataclasses

    return dataclasses.replace(st, error=jnp.zeros(error.shape, jnp.float32))


def test_error_memory_checkpoint_interoperates_with_reference(tmp_path):
    """A ``[K, n]`` memory saved by the port restores bit for bit in the port
    and in the reference (which re-saves the same meta bytes), and the
    reference's save restores bit for bit in the port."""
    ex = make_exchange(ExchangeConfig(compressor="ef21-topk"))
    tree = {"a": torch.zeros(300), "b": torch.zeros(7, 11)}
    st = ex.init_state("cpu", template=tree, num_workers=3)
    st.error.copy_(torch.from_numpy(np.random.RandomState(5).randn(3, 377).astype(np.float32)))
    st.error[1, 5] = -0.0
    st.step = 7
    ckpt.save(str(tmp_path / "port"), 7, {"ex_state": st})
    _, mine = ckpt.restore(str(tmp_path / "port"),
                           {"ex_state": ex.init_state("cpu", template=tree, num_workers=3)})
    back = convert.ex_state_from_jax(mine["ex_state"], "cpu")
    assert back.step == 7
    assert back.error.numpy().tobytes() == st.error.numpy().tobytes()
    step, got = jax_ckpt.restore(str(tmp_path / "port"),
                                 {"ex_state": _jax_ex_state(st.error)})
    assert step == 7
    assert np.asarray(got["ex_state"].error).tobytes() == st.error.numpy().tobytes()
    jax_ckpt.save(str(tmp_path / "ref"), 7, got)
    assert (tmp_path / "ref" / "ckpt_7.meta").read_bytes() == \
        (tmp_path / "port" / "ckpt_7.meta").read_bytes()
    _, theirs = ckpt.restore(str(tmp_path / "ref"),
                             {"ex_state": ex.init_state("cpu", template=tree, num_workers=3)})
    back = convert.ex_state_from_jax(theirs["ex_state"], "cpu")
    assert back.error.numpy().tobytes() == st.error.numpy().tobytes()
    # a memory of another shape is refused, not resized
    with pytest.raises(ckpt.CheckpointStructureError, match="ex_state"):
        ckpt.restore(str(tmp_path / "port"),
                     {"ex_state": ex.init_state("cpu", template=tree, num_workers=2)})


def _cli(tmp_path, *extra, steps):
    return ["--reduced", "--steps", str(steps), "--batch", "4", "--seq", "16",
            "--optimizer", "qgenx", "--compressor", "ef21-topk", "--ef-topk-frac", "0.1",
            "--device", "cpu", *extra]


def test_cli_resume_restores_the_error_memory(tmp_path):
    """A CPU run of the CLI under ef21-topk resumed at step 2 equals the
    uninterrupted run bit for bit: losses, metrics, the final error memory
    and the final checkpoint's arrays."""
    full_dir, part_dir = str(tmp_path / "full"), str(tmp_path / "part")
    full = train.main(_cli(tmp_path, "--checkpoint-dir", full_dir, steps=4))
    first = train.main(_cli(tmp_path, "--checkpoint-dir", part_dir, "--checkpoint-every", "2",
                            steps=2))
    rest = train.main(_cli(tmp_path, "--checkpoint-dir", part_dir, steps=4))
    assert rest["start_step"] == 2
    for key in ("loss", "wire_bytes"):
        assert first[key] + rest[key] == full[key], key
    assert torch.equal(rest["ex_state"].error, full["ex_state"].error)
    assert rest["ex_state"].error.shape[0] == 1 and bool(rest["ex_state"].error.any())
    with np.load(os.path.join(full_dir, "ckpt_4.npz")) as a, \
            np.load(os.path.join(part_dir, "ckpt_4.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_qgenx_state_carries_the_ef_memory_both_ways():
    """``convert`` carries a non-zero ``QGenXState.ef_err`` into the
    reference's state and back, and the reference steps on from it."""
    tp = vi.bilinear_saddle(d=16, seed=6)
    cfg = eg.QGenXConfig(variant="de", num_workers=4,
                         exchange=ExchangeConfig(compressor="ef21-topk"))
    x0 = torch.from_numpy(tp.z_star.astype(np.float32)) + 1.0
    st = eg.qgenx_run(x0, vi.absolute_noise_oracle(tp, 0.5, "cpu"), cfg,
                      GeneratorNoise.seeded(0, "cpu"), 3, "cpu")
    assert bool(st.ef_err.any())
    arrs = convert.qgenx_state_to_jax(st)
    jst = jeg.QGenXState(*(jnp.asarray(getattr(arrs, f)) for f in convert._QGENX_FIELDS))
    np.testing.assert_array_equal(np.asarray(jst.ef_err), st.ef_err.numpy())
    back = convert.qgenx_state_from_jax(jst, "cpu")
    assert torch.equal(back.ef_err, st.ef_err)
    from repro.core import vi as jvi

    jcfg = jeg.QGenXConfig(variant="de", num_workers=4,
                           exchange=JaxExchangeConfig(compressor="ef21-topk"))
    nxt = jeg.qgenx_step(jst, jvi.absolute_noise_oracle(jvi.bilinear_saddle(d=16, seed=6), 0.5),
                         jax.random.PRNGKey(0), jcfg)
    assert int(nxt.t) == 4 and np.all(np.isfinite(np.asarray(nxt.ef_err)))
