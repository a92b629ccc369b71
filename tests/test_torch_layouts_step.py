"""The LM train step under the exchange's layouts against the reference's
``core_step``, at K = 1 on the CPU (reduced tinyllama-1.1b, f32).

Two qgenx ``de`` steps each, with the reference's noise replayed
(``_torch_layouts.exchange_draws``: per exchange key, the layout's own
keying) and the reference step built as ``tests/test_torch_step.py``
builds it (a 1-device mesh under the test-side ``shard_map`` shim),
compiled with XLA's optimisation passes off:

* ``--num-buckets 3 --overlap bucketed``, int8 two_phase;
* ``--num-buckets 3 --overlap defer_tail``, int8 two_phase, with
  ``recenter_every=2``: the second step's re-centering exchange goes
  through the same bucketed ``pmean_tree``, so it applies the gradient
  exchange's tail mean and leaves its own in ``pending`` (the
  reference's behaviour, pinned here with the final ``pending``);
* ``--no-exchange-plan``, int4 gather;
* ``--compress-mode leafwise``, int4 (the reference's leafwise rounding
  unrolls over the level table, so its compile grows with the table: int8
  leafwise is held at the exchange level, ``tests/test_torch_leafwise.py``).

``wire_bytes`` must equal the reference's exactly.  The frameworks'
gradients differ in their last bits (matmul sums in another order), so
the losses are held to rtol 1e-6 and the params to rtol 1e-6 / atol 1e-6
on all but 1e-5 of the coordinates, with every coordinate within 1 % of
its leaf's largest weight: where the noise of a stochastic rounding sits
within an ulp of its threshold, a last-bit difference flips it and moves
that coordinate by one level step times gamma (measured: at most 22 of
1,443,072 coordinates off rtol 1e-6 / atol 1e-7, by 0.35e-6 to 2.9e-5,
in the defer_tail case's three exchanges).  ``pending`` is the
re-centering exchange's quantized mean of the dual accumulator, whose
every coordinate already carries the params' last-bit differences, so
its roundings flip more often: it is held to rtol 1e-6 / atol 1e-6 on
all but 1e-4 of its coordinates (measured 15 of 524,288), every
coordinate within 5 % of its largest value (a flip moves a coordinate by
one level step of its bucket's norm: measured at most 4.8e-5 against a
largest value of 2.8e-3, 1.7 %).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_layouts as lay
import repro.launch.steps as jax_steps
from repro.core import exchange as jx
from repro.optim import optimizers as jax_opt
from repro_torch.core import exchange as tx
from repro_torch.core.noise import ReplayNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig
from repro.configs.registry import get_config as jax_get_config
from repro.models.model import build as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_to_jax
from repro_torch.models.model import build
from test_torch_step import _batches, _port_model, _shard_map_shim
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GAMMA, RECENTER_TAG = 0.02, 0x5EED
# XLA options of the reference's compiles (as tests/test_torch_archs.py's):
# one small step compiled once, where the optimisation passes cost more
# than they save
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
CASES = {  # name -> (bits, mode, exchange fields)
    "bucketed": (8, "two_phase", dict(num_buckets=3, overlap="bucketed")),
    "defer_tail": (8, "two_phase", dict(num_buckets=3, overlap="defer_tail",
                                        recenter_every=2)),
    "no_plan": (4, "gather", dict(use_plan=False)),
    "leafwise": (4, "leafwise", dict()),
}


@pytest.fixture(scope="module")
def reference():
    """The reference model under the ``shard_map`` shim, and its params: the
    port's init from seed 0 through ``params_to_jax`` (a fraction of the
    reference's eager ``init_params``)."""
    old = jax_steps.shard_map
    jax_steps.shard_map = _shard_map_shim
    try:
        params = params_to_jax(build(get_config("tinyllama-1.1b").reduced(), seed=0,
                                     device="cpu"))
        yield jax_build(jax_get_config("tinyllama-1.1b").reduced()), params
    finally:
        jax_steps.shard_map = old


def _config(case):
    bits, mode, kw = CASES[case]
    quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=512)
    return tx.ExchangeConfig(quant=quant, mode=mode, **kw)


def _exchange_keys(cfg, count, key):
    k1, k2 = jax.random.split(key)
    keys = [k1, k2]
    if cfg.recenter_every and count % cfg.recenter_every == cfg.recenter_every - 1:
        keys.append(jax.random.fold_in(key, RECENTER_TAG))
    return keys


@pytest.fixture(scope="module")
def compiled(reference):
    """Each case's reference step, lowered one after another and compiled
    in a thread each (XLA's compiles release the GIL): case -> (compiled
    step, params, optimizer state, exchange state)."""
    model, params_np = reference
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    opt_cfg = jax_opt.OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
    batch = {k: jnp.asarray(v) for k, v in _batches(1)[0].items()}
    lowered = {}
    with mesh:
        for case in CASES:
            params = jax.tree_util.tree_map(jnp.asarray, params_np)
            opt_state = jax_opt.init_state(opt_cfg, params)
            jex = jx.make_exchange(lay.jax_config(_config(case)))
            ex_state = jex.init_state(template=params, num_workers=1)
            step = jax_steps.make_train_step(model, opt_cfg, exchange=jex, mesh=mesh)
            lowered[case] = (jax.jit(step).lower(params, opt_state, ex_state, batch,
                                                 jax.random.PRNGKey(0)),
                             params, opt_state, ex_state)
    with ThreadPoolExecutor(len(lowered)) as pool:
        steps = dict(zip(lowered, pool.map(
            lambda v: v[0].compile(compiler_options=FAST_COMPILE), lowered.values())))
    return {case: (steps[case],) + v[1:] for case, v in lowered.items()}, mesh


def _run_reference(compiled, case, batches, keys):
    entries, mesh = compiled
    step, params, opt_state, ex_state = entries[case]
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    losses, wires = [], []
    with mesh:
        for batch, key in zip(batches, keys):
            params, opt_state, ex_state, m = step(params, opt_state, ex_state, batch, key)
            losses.append(float(m["loss"]))
            wires.append(float(m["wire_bytes"]))
    return (losses, wires, [np.asarray(l) for l in jax.tree_util.tree_leaves(params)],
            np.asarray(ex_state.pending))


def _run_port(params_np, cfg, batches, noise):
    model = _port_model(params_np)
    opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
    ex = tx.make_exchange(cfg)
    step = make_train_step(model, opt_cfg, ex)
    opt_state = port_opt.init_state(opt_cfg, model.param_leaves())
    ex_state = ex.init_state("cpu", template=model.param_leaves(), num_workers=1)
    losses, wires = [], []
    for b in batches:
        opt_state, ex_state, m = step(opt_state, ex_state, to_device(b, "cpu"), noise)
        losses.append(float(m["loss"]))
        wires.append(float(m["wire_bytes"]))
    return (losses, wires, [p.detach().numpy() for p in model.param_leaves()],
            ex_state.pending.numpy())


def _assert_close(got, want, quantum, share=1e-5):
    """rtol 1e-6 / atol 1e-6 on all but ``share`` of the coordinates, every
    coordinate within ``quantum`` times its leaf's largest value."""
    total = sum(a.size for a in want)
    off = 0
    for a, b in zip(got, want):
        off += int((~np.isclose(a, b, rtol=1e-6, atol=1e-6)).sum())
        assert np.abs(a - b).max() <= quantum * np.abs(b).max()
    assert off <= share * total, f"{off} of {total} coordinates off"


@pytest.mark.parametrize("case", CASES)
def test_layout_steps_match_reference(reference, compiled, case):
    _, params_np = reference
    cfg = _config(case)
    batches = _batches(2)
    keys = [jax.random.fold_in(jax.random.PRNGKey(17), t) for t in range(2)]
    jl, jw, jp, jpend = _run_reference(compiled, case, batches, keys)
    jex = jx.make_exchange(lay.jax_config(cfg))
    shapes = [a.shape for a in jax.tree_util.tree_leaves(params_np)]
    draws = [d for t, key in enumerate(keys) for ek in _exchange_keys(cfg, t, key)
             for d in lay.exchange_draws(jex, shapes, ek, 1, 0)]
    noise = ReplayNoise(draws)
    tl, tw, tp, tpend = _run_port(params_np, cfg, batches, noise)
    assert noise.remaining == 0
    assert tw == jw
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_close(tp, jp, 1e-2)
    assert tpend.shape == jpend.shape
    if case == "defer_tail":
        assert np.abs(jpend).max() > 0
        _assert_close([tpend], [jpend], 5e-2, share=1e-4)
