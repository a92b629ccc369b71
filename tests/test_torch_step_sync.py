"""The local-update regime at K = 1 against the JAX reference, on the CPU
at ``reduced()`` size (tinyllama-1.1b: 2 layers, d_model 256, f32), with
``test_torch_step.py``'s reference fixture, shim and helpers (split out
of that file so that the suite's workers share its load).

``sync_every=2``, ``recenter_every=2``: a local step, then a step that
syncs and re-centers, int8 two_phase with the noise replayed, qgenx
``de`` and ``extra_adam``: the int8 ``de`` step's and the ``extra_adam``
steps' tolerances of ``test_torch_step.py``; the metrics ``wire_bytes``
exactly, ``param_drift`` 0 on both sides (one worker), ``coded_bits_est``
rtol 1e-5, and the port's wire recorder list of the sync step equal to
the reference's trace-time list.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import repro.launch.steps as jax_steps
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.exchange import wire_trace_start as jax_trace_start
from repro.core.exchange import wire_trace_stop as jax_trace_stop
from repro.core.quantization import QuantConfig as JaxQuant
from repro.optim import optimizers as jax_opt
from repro_torch.core.exchange import (
    ExchangeConfig,
    make_exchange,
    wire_trace_start,
    wire_trace_stop,
)
from repro_torch.core.noise import ReplayNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig

from test_torch_step import (  # noqa: F401  (reference: the fixture)
    GAMMA,
    _assert_adam_close,
    _batches,
    _port_model,
    reference,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("name", ["qgenx", "extra_adam"])
def test_sync_and_recenter_steps_match(reference, name):
    """sync_every=2, recenter_every=2 at K = 1: step 0 is local (no
    exchange, no draw), step 1 exchanges twice and re-centers (qgenx: Y,
    extra_adam: the params), each exchange with its replayed noise."""
    model, params_np = reference
    batches = _batches(2)
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(2)]
    kw = dict(compressor="qgenx", mode="two_phase", sync_every=2, recenter_every=2)
    jcfg = JaxExchangeConfig(quant=JaxQuant(num_levels=15, bits=8, bucket_size=512),
                             use_pallas=True, **kw)
    tcfg = ExchangeConfig(quant=QuantConfig(num_levels=15, bits=8, bucket_size=512), **kw)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    opt_cfg = jax_opt.OptimizerConfig(name=name, gamma_scale=GAMMA, method="de")
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_state = jax_opt.init_state(opt_cfg, params)
    ex = jax_make_exchange(jcfg)
    ex_state = ex.init_state()
    step = jax.jit(jax_steps.make_train_step(model, opt_cfg, exchange=ex, mesh=mesh))
    want = []
    with mesh:
        for i, (b, key) in enumerate(zip(batches, keys)):
            batch = {k: jnp.asarray(v) for k, v in b.items()}
            if i == 0:
                jax_trace_start()
            params, opt_state, ex_state, m = step(params, opt_state, ex_state, batch, key)
            if i == 0:
                jtrace = jax_trace_stop()
            want.append({k: float(m[k]) for k in
                         ("loss", "wire_bytes", "param_drift", "coded_bits_est")})
    jp = [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]

    rows = -(-sum(a.size for a in jp) // 512)
    draws = []
    k1, k2 = jax.random.split(keys[1])
    for k in (k1, k2, jax.random.fold_in(keys[1], 0x5EED)):
        a, b = jax.random.split(jax.random.fold_in(k, 0))
        draws += [np.asarray(jax.random.uniform(a, (rows, 512))),
                  np.asarray(jax.random.uniform(b, (rows, 512)))]
    noise = ReplayNoise(draws)
    port = _port_model(params_np)
    tstep = make_train_step(port, OptimizerConfig(name=name, gamma_scale=GAMMA, method="de"),
                            make_exchange(tcfg))
    opt_state = port_opt.init_state(OptimizerConfig(name=name, method="de"),
                                    port.param_leaves())
    ex_state = make_exchange(tcfg).init_state("cpu")
    got, traces = [], []
    for b in batches:
        wire_trace_start()
        opt_state, ex_state, m = tstep(opt_state, ex_state, to_device(b, "cpu"), noise)
        traces.append(wire_trace_stop())
        got.append({k: float(m[k]) for k in want[0]})
    assert noise.remaining == 0 and ex_state.step == 3
    assert traces[0] == [] and traces[1] == [(n, b) for n, b in jtrace]
    assert [g["wire_bytes"] for g in got] == [w["wire_bytes"] for w in want]
    assert got[1]["wire_bytes"] == sum(b for _, b in traces[1])
    assert [g["param_drift"] for g in got] == [w["param_drift"] for w in want] == [0.0, 0.0]
    np.testing.assert_allclose([g["loss"] for g in got], [w["loss"] for w in want], rtol=1e-5)
    assert got[0]["coded_bits_est"] == want[0]["coded_bits_est"] == 0.0
    np.testing.assert_allclose(got[1]["coded_bits_est"], want[1]["coded_bits_est"], rtol=1e-5)
    tp = [p.detach().numpy() for p in port.param_leaves()]
    if name == "extra_adam":
        _assert_adam_close(tp, jp, OptimizerConfig().lr)
        return
    total = sum(a.size for a in jp)
    off = sum(int((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).sum()) for a, b in zip(tp, jp))
    assert off <= 1e-5 * total, f"{off} of {total} coordinates off"
