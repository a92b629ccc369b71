"""The port's train step under ``level_schedule="qada"`` against the JAX
reference at K = 1 (reduced tinyllama-1.1b, f32, the ``shard_map`` shim
of ``tests/test_torch_step.py``), every exchange's noise replayed.

Cases: qgenx ``de``, int8 two_phase, ``level_update_every=2`` (2 steps,
4 exchange calls, 2 refreshes); the same with ``sync_every=2`` (4 steps:
the histogram moves only on the sync steps 1 and 3); and the layerwise
compressor (int4 above the threshold, int8 below), where both tables
move.

Held per step: ``ExchangeState.step`` exactly; each refreshed table valid,
elementwise within 1e-4 of the reference's (q = inf: the histogram's mass
reaches u = 1, so every level is pinned; measured up to 3.04e-5: the
merged histograms differ in their last bits, rtol ~1e-7, and the
bisection amplifies that where the objective is flat — ``tests/test_torch_vi.py``
says more) and no worse than the reference's table on the QAda objective
 ``wire_bytes``
exactly (the histogram's 2048 bytes a call included); the loss rtol
1e-5; the port's wire recorder list of the first step that exchanges
equal to the reference's trace-time list (``qada_hist`` after each
exchange's operands).  After each step the port's tables are set to the
reference's, so later steps are held given the reference's levels.  The
final params as ``test_torch_step.py``'s int8 case: rtol 1e-5 / atol
1e-6 on all but 1e-5 of the coordinates, each within 1 % of the largest
weight of its leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.launch.steps as jax_steps
from repro.configs.registry import get_config as jax_get_config
from repro.core import adaptive_levels as jqada
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.exchange import wire_trace_start as jax_trace_start
from repro.core.exchange import wire_trace_stop as jax_trace_stop
from repro.core.quantization import QuantConfig as JaxQuant
from repro.models.model import build as jax_build
from repro.optim import optimizers as jax_opt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import exchange as xmod
from repro_torch.core.exchange import (
    ExchangeConfig,
    make_exchange,
    wire_trace_start,
    wire_trace_stop,
)
from repro_torch.core.noise import ReplayNoise
from repro_torch.core.quantization import QuantConfig, validate_levels
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig

GAMMA = 0.02
# name -> (compressor, bits, sync_every, steps)
CASES = {"qgenx": ("qgenx", 8, 1, 2), "sync2": ("qgenx", 8, 2, 4),
         "layerwise": ("layerwise", 4, 1, 2)}


def _shard_map_shim(f, *, mesh, in_specs, out_specs, check_rep=False, auto=frozenset()):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         axis_names=set(mesh.axis_names) - set(auto), check_vma=check_rep)


@pytest.fixture
def reference(monkeypatch):
    monkeypatch.setattr(jax_steps, "shard_map", _shard_map_shim)
    model = jax_build(jax_get_config("tinyllama-1.1b").reduced())
    params = model.init(jax.random.PRNGKey(0))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _draws(key, plan, sync):
    """The reference's noise of one step at K = 1: per exchange key (the
    step's split), per plan segment, fold_in(key, key_tag) (layerwise),
    fold_in(worker 0), then the quantize and re-quantize draws."""
    if not sync:
        return []
    out = []
    for k in jax.random.split(key):
        for seg in plan.segments:
            b = seg.quant.bucket_size
            kk = k if seg.key_tag is None else jax.random.fold_in(k, seg.key_tag)
            a, c = jax.random.split(jax.random.fold_in(kk, 0))
            out += [np.asarray(jax.random.uniform(a, (seg.padded // b, b))),
                    np.asarray(jax.random.uniform(c, (seg.padded // b, b)))]
    return out


def _check_table(got, want, hist, what):
    validate_levels(torch.from_numpy(got), got.shape[0] - 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=what)
    f_got = float(jqada.expected_variance(jnp.asarray(got), jnp.asarray(hist)))
    f_want = float(jqada.expected_variance(jnp.asarray(want), jnp.asarray(hist)))
    assert f_got <= f_want * (1 + 2e-4), (what, f_got, f_want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_qada_steps_match_reference(reference, case, monkeypatch):
    compressor, bits, sync_every, n_steps = CASES[case]
    model, params_np = reference
    s = 15 if bits == 8 else 5
    kw = dict(compressor=compressor, mode="two_phase", level_schedule="qada",
              level_update_every=2, sync_every=sync_every)
    jcfg = JaxExchangeConfig(quant=JaxQuant(num_levels=s, bits=bits, bucket_size=512),
                             use_pallas=True, **kw)
    tcfg = ExchangeConfig(quant=QuantConfig(num_levels=s, bits=bits, bucket_size=512), **kw)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jopt = jax_opt.OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    jopt_state = jax_opt.init_state(jopt, params)
    jex = jax_make_exchange(jcfg)
    jst = jex.init_state()
    step = jax.jit(jax_steps.make_train_step(model, jopt, exchange=jex, mesh=mesh))

    solved = []  # (table in, merged histogram) of each port solve
    solve = xmod._qada_solve

    def recording_solve(levels, hist, cfg):
        solved.append(hist.clone())
        return solve(levels, hist, cfg)

    monkeypatch.setattr(xmod, "_qada_solve", recording_solve)
    port = params_from_jax(params_np, build(get_config("tinyllama-1.1b").reduced(), device="cpu"))
    topt = OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
    tex = make_exchange(tcfg)
    tstep = make_train_step(port, topt, tex)
    topt_state = port_opt.init_state(topt, port.param_leaves())
    tst = tex.init_state("cpu")
    assert tst.hist.shape == (512,) and jst.hist.shape == (512,)
    plan = tex.plan_for(port.param_leaves())
    if compressor == "layerwise":
        assert [sg.quant.bits for sg in plan.segments] == [4, 8]  # both tables in use
    tables = ("levels", "levels_lo") if compressor == "layerwise" else ("levels",)
    pipe = make_pipeline(512, 4, 16, seed=0)
    traced = False
    with mesh:
        for t in range(n_steps):
            b = next(pipe)
            key = jax.random.fold_in(jax.random.PRNGKey(21), t)
            sync = t % sync_every == sync_every - 1
            before = {f: np.asarray(getattr(jst, f)) for f in tables}
            prev_hist = np.asarray(jst.hist)
            if t == 0:  # the jitted step's trace-time list: every call site once
                jax_trace_start()
            params, jopt_state, jst, m = step(params, jopt_state, jst,
                                              {k: jnp.asarray(v) for k, v in b.items()}, key)
            if t == 0:
                jtrace = jax_trace_stop()
            record = sync and not traced
            if record:
                wire_trace_start()
            n_solved = len(solved)
            noise = ReplayNoise(_draws(key, plan, sync))
            topt_state, tst, tm = tstep(topt_state, tst, to_device(b, "cpu"), noise)
            if record:
                traced = True
                ttrace = wire_trace_stop()
                assert ttrace == [(n, nb) for n, nb in jtrace]
                assert [n for n, _ in ttrace].count("qada_hist") == 2
            assert noise.remaining == 0
            assert tst.step == int(jst.step) == 2 * ((t + 1) // sync_every)
            assert float(tm["wire_bytes"]) == float(m["wire_bytes"])
            np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]), rtol=1e-5)
            want_hist = np.asarray(jst.hist)
            want_cdf = np.cumsum(want_hist, dtype=np.float64)
            np.testing.assert_allclose(np.cumsum(tst.hist.numpy(), dtype=np.float64), want_cdf,
                                       rtol=0, atol=1e-5 * want_cdf[-1])
            if not sync:  # a local step moves no statistics and no table
                assert np.array_equal(want_hist, prev_hist) and len(solved) == n_solved
            # one refresh a sync step (the second call ends a period)
            assert len(solved) - n_solved == (len(tables) if sync else 0)
            for f, hist in zip(tables, solved[n_solved:]):
                got, want = getattr(tst, f).numpy(), np.asarray(getattr(jst, f))
                assert not np.array_equal(want, before[f])
                _check_table(got, want, hist.numpy(), f"{f} at step {t}")
                setattr(tst, f, torch.from_numpy(np.array(want)))
    jp = [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]
    tp = [p.detach().numpy() for p in port.param_leaves()]
    total = sum(a.size for a in jp)
    off = 0
    for a, b in zip(tp, jp):
        off += int((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).sum())
        assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1.0)
    assert off <= 1e-5 * total, f"{off} of {total} coordinates off"
