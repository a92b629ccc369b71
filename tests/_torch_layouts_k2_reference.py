"""The reference train step at K = 2 under the exchange's layouts, run in
a process of its own.

    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_torch_layouts_k2_reference.py OUT.npz CASE...

JAX fixes its device count when it first starts, so
``tests/test_torch_layouts_k2.py`` runs this file in a subprocess, while
the port's workers run.  For each case of ``_torch_layouts.STEP_CASES`` it
builds reduced tinyllama-1.1b (f32) from ``_torch_layouts.step_params``,
lowers two qgenx ``de`` steps of ``make_train_step`` on a 2-device mesh
under the ``shard_map`` shim of ``tests/test_torch_step.py`` (C1 in
ROADMAP.md), its jnp path, compiles every case at once (a thread each,
XLA's optimisation passes off), runs them on
``_torch_layouts.step_batches`` with the step keys
``fold_in(PRNGKey(STEP_KEY), t)``, and writes to ``OUT.npz``, each key
prefixed ``{case}_``: the metrics ``loss`` and ``wire_bytes``, the final
params (``p_{j}``) and the trace-time wire recorder's list
(``wire_names``, ``wire_nbytes``).
"""

import sys
from concurrent.futures import ThreadPoolExecutor


def main(out_path: str, *cases: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import _torch_layouts as lay
    import repro.launch.steps as steps
    from _torch_step_k2_reference import shard_map_shim
    from repro.configs.registry import get_config
    from repro.core.exchange import make_exchange, wire_trace_start, wire_trace_stop
    from repro.models.model import build
    from repro.optim import optimizers as opt

    K = 2
    assert jax.device_count() == K, "run with --xla_force_host_platform_device_count=2"
    steps.shard_map = shard_map_shim
    fast = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    model = build(get_config("tinyllama-1.1b").reduced())
    mesh = Mesh(np.array(jax.devices()), ("data",))
    init = lay.step_params()
    batches = [{"tokens": jnp.asarray(t), "labels": jnp.asarray(l)}
               for t, l in lay.step_batches()]
    opt_cfg = opt.OptimizerConfig(name="qgenx", gamma_scale=0.02, method="de")
    runs, traces = {}, {}
    with mesh:
        for case in cases:
            params = jax.tree_util.tree_map(jnp.asarray, init)
            ex = make_exchange(lay.jax_config(lay.step_config(case)))
            state = (params, opt.init_state(opt_cfg, params),
                     ex.init_state(template=params, num_workers=K))
            step = jax.jit(steps.make_train_step(model, opt_cfg, exchange=ex, mesh=mesh))
            wire_trace_start()
            runs[case] = (step.lower(*state, batches[0], jax.random.PRNGKey(0)), state)
            traces[case] = wire_trace_stop()
    with ThreadPoolExecutor(len(runs)) as pool:
        compiled = dict(zip(runs, pool.map(lambda r: r[0].compile(compiler_options=fast),
                                           runs.values())))
    out = {}
    with mesh:
        for case in cases:
            params, opt_state, ex_state = runs[case][1]
            loss, wire = [], []
            for t, batch in enumerate(batches):
                key = jax.random.fold_in(jax.random.PRNGKey(lay.STEP_KEY), t)
                params, opt_state, ex_state, m = compiled[case](params, opt_state, ex_state,
                                                                batch, key)
                loss.append(float(m["loss"]))
                wire.append(float(m["wire_bytes"]))
            out[f"{case}_loss"] = np.asarray(loss, np.float64)
            out[f"{case}_wire_bytes"] = np.asarray(wire, np.float64)
            for j, l in enumerate(jax.tree_util.tree_leaves(params)):
                out[f"{case}_p_{j}"] = np.asarray(l)
            out[f"{case}_wire_names"] = np.asarray([nm for nm, _ in traces[case]])
            out[f"{case}_wire_nbytes"] = np.asarray([nb for _, nb in traces[case]], np.int64)
    np.savez(out_path, **out)


if __name__ == "__main__":
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    main(*sys.argv[1:])
