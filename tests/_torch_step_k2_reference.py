"""The reference train step at K = 2, run in a process of its own.

    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_torch_step_k2_reference.py CASE OUT.npz [jnp]

JAX fixes its device count when it first starts, so the two forced host
devices cannot be had inside the pytest process: ``tests/test_torch_step_k2.py``
runs this file in a subprocess.  It builds reduced tinyllama-1.1b (f32,
weights from ``PRNGKey(0)``), runs ``make_train_step`` of case ``CASE``
(:data:`CASES`) on a 2-device mesh under the ``shard_map`` shim of
``tests/test_torch_step.py`` (C1 in ROADMAP.md), and writes to ``OUT.npz``:

* the initial params (``p0_{j}``, leaves in JAX order) and each step's
  batch (``tokens_{t}``, ``labels_{t}``, global: worker k takes rows
  ``k * B/2 : (k + 1) * B/2``);
* per step, the metrics ``loss``, ``wire_bytes``, ``param_drift`` and
  ``coded_bits_est`` (arrays over steps) and the exchange-call count;
* the final params (``p_{j}``) and optimizer state's ``count`` and, for
  qgenx, ``sum_sq`` (``opt_count``, ``opt_sum_sq``);
* each step's exchange state's level table and QAda histogram
  (``levels_{t}``, ``hist_{t}``);
* each worker's noise draws in the order its exchanges ask for them
  (``noise_{k}_{i}``): per exchange key, ``fold_in(key, worker)`` ->
  ``split`` -> the quantize draw and, two_phase, the re-quantize draw.
  The step splits its key into the first and second exchange's keys (an
  ``optda`` step uses the second only); the re-centering exchange's key
  is ``fold_in(key, 0x5eed)``.  Only the exchanges that run draw: the
  schedule is read off ``opt_state.count`` as the step gates it, and
  checked against the exchange-call counter (which a rejected step leaves
  where it was);
* the trace-time wire recorder's ``(name, nbytes)`` list of the jitted
  step (``wire_names``, ``wire_nbytes``: every call site once).

A case of :data:`FAULT_CASES` builds the step with ``guard=True`` and its
fault schedule and passes each step's index as ``fault_step``; every case
also writes the metrics ``rejected``, ``nonfinite`` and ``alive``.

A case of :data:`ARCH_CASES` (:func:`main_arch`) runs case (a)'s step
once on another model (:func:`arch_config`) from the caller's inputs
(``INPUTS.npz``: ``p0_{j}``, ``tokens_0``, ``labels_0``, ``embeds_0``),
so that the caller can run the port's workers beside it:

    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_torch_step_k2_reference.py m OUT.npz jnp INPUTS.npz

It writes the metrics, the final params and the wire list as above.

The reference runs with ``use_pallas=True``, the path the port's kernels
follow (interpret-mode Pallas; the 2-device rendezvous does not stall at
this size), or with a third argument ``jnp`` on its jnp path
(``use_pallas=False``), which differs from the Pallas path only in the
last ulp of the K-mean (C2 in ROADMAP.md).
"""

import sys

BATCH, SEQ, GAMMA, BUCKET = 4, 16, 0.02, 256
RECENTER_TAG = 0x5EED

# name -> (optimizer, method, bits, mode, sync_every, recenter_every, steps,
#          level_update_every: 0 = fixed levels, else the QAda period)
CASES = {
    "a": ("qgenx", "de", 8, "two_phase", 1, 0, 2, 0),
    "b": ("qgenx", "optda", 4, "gather", 2, 2, 4, 0),
    "c": ("extra_adam", "de", 8, "two_phase", 2, 0, 4, 0),
    "d": ("qgenx", "de", 8, "two_phase", 2, 2, 4, 2),
}
# guarded cases: (the case's fields as above, its fault schedule): worker
# 0's gradients NaN at step 1, worker 1 dropped at step 2
FAULT_CASES = {
    "g": (("qgenx", "de", 8, "two_phase", 1, 0, 3, 0), "nan_grad@1:worker=0;drop@2:worker=1"),
}
# the families' case: case (a)'s step, once, on llama4-5 with internvl2's 8
# stubbed prefix embeds (each worker routes its own rows with its own
# capacity, and takes its own rows of the embeds)
ARCH_CASES = {"m": "llama4-5-vlm"}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
METRICS = ("loss", "wire_bytes", "param_drift", "coded_bits_est", "rejected", "nonfinite",
           "alive")


def case_fields(case):
    """The fields of a case of :data:`CASES`, :data:`FAULT_CASES` or
    :data:`ARCH_CASES`."""
    if case in ARCH_CASES:
        return CASES["a"][:6] + (1, 0)
    return CASES[case] if case in CASES else FAULT_CASES[case][0]


def arch_config(arch, get_config):
    """The test model ``arch`` of either package (``get_config`` its
    registry's): reduced tinyllama-1.1b, or ``llama4-5-vlm``: llama4's
    reduced() at 5 layers (one period of chunk / MoE-chunk / chunk /
    MoE-global and a chunk tail layer) with internvl2's 8 prefix embeds
    (``arch_type="vlm"``, so the stubs attach)."""
    import dataclasses

    if arch == "llama4-5-vlm":
        return dataclasses.replace(get_config("llama4-maverick-400b-a17b").reduced(),
                                   num_layers=5, arch_type="vlm", num_prefix_embeds=8)
    return get_config("tinyllama-1.1b").reduced()


def exchange_keys(case, count, key):
    """The keys of the exchanges a step with pre-step optimizer count
    ``count`` runs, in order (``jax`` imported by the caller)."""
    import jax

    name, method, _, _, sync_every, recenter_every, _, _ = case_fields(case)
    k1, k2 = jax.random.split(key)
    keys = []
    if count % sync_every == sync_every - 1:
        keys += [k2] if (name == "qgenx" and method == "optda") else [k1, k2]
    if recenter_every and count % recenter_every == recenter_every - 1:
        keys.append(jax.random.fold_in(key, RECENTER_TAG))
    return keys


def shard_map_shim(f, *, mesh, in_specs, out_specs, check_rep=False, auto=frozenset()):
    import jax

    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         axis_names=set(mesh.axis_names) - set(auto), check_vma=check_rep)


def main(case: str, out_path: str, path: str = "pallas") -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import repro.launch.steps as steps
    from repro.configs.registry import get_config
    from repro.core.exchange import ExchangeConfig, make_exchange, wire_trace_start, \
        wire_trace_stop
    from repro.core.faults import FaultSpec
    from repro.core.quantization import QuantConfig
    from repro.data.pipeline import _batch_tokens, PipelineConfig
    from repro.models.model import build
    from repro.optim import optimizers as opt

    K = 2
    assert jax.device_count() == K, "run with --xla_force_host_platform_device_count=2"
    steps.shard_map = shard_map_shim
    name, method, bits, mode, sync_every, recenter_every, n_steps, every = case_fields(case)
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=BUCKET)
    ex = make_exchange(ExchangeConfig(compressor="qgenx", quant=quant, mode=mode,
                                      use_pallas=path == "pallas", sync_every=sync_every,
                                      recenter_every=recenter_every,
                                      level_schedule="qada" if every else "fixed",
                                      level_update_every=every))
    opt_cfg = opt.OptimizerConfig(name=name, gamma_scale=GAMMA, method=method)
    opt_state = opt.init_state(opt_cfg, params)
    ex_state = ex.init_state()
    mesh = Mesh(np.array(jax.devices()), ("data",))
    spec = FaultSpec.parse(FAULT_CASES[case][1]) if case in FAULT_CASES else None
    step = jax.jit(steps.make_train_step(model, opt_cfg, exchange=ex, mesh=mesh,
                                         guard=spec is not None, fault_spec=spec))

    leaves = jax.tree_util.tree_leaves(params)
    out = {f"p0_{j}": np.asarray(l) for j, l in enumerate(leaves)}
    n = sum(l.size for l in leaves)
    if mode == "two_phase":
        rows = -(-n // (K * BUCKET)) * K
    else:
        rows = -(-n // BUCKET)
    pc = PipelineConfig(vocab_size=cfg.vocab_size, batch=BATCH, seq_len=SEQ + 1, seed=0)
    draws = [[] for _ in range(K)]
    metrics = {k: [] for k in METRICS}
    calls = []
    base = jax.random.PRNGKey(7)
    with mesh:
        for t in range(n_steps):
            toks = _batch_tokens(pc, t)
            out[f"tokens_{t}"], out[f"labels_{t}"] = toks[:, :-1], toks[:, 1:]
            batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
            key = jax.random.fold_in(base, t)
            keys = exchange_keys(case, int(opt_state.count), key)
            for k in range(K):
                for ek in keys:
                    a, b = jax.random.split(jax.random.fold_in(ek, k))
                    draws[k].append(np.asarray(jax.random.uniform(a, (rows, BUCKET))))
                    if mode == "two_phase":
                        draws[k].append(np.asarray(jax.random.uniform(b, (rows // K, BUCKET))))
            before = int(ex_state.step)
            if t == 0:
                wire_trace_start()
            extra = [jnp.int32(t)] if spec is not None else []
            params, opt_state, ex_state, m = step(params, opt_state, ex_state, batch, key,
                                                  *extra)
            if t == 0:
                trace = wire_trace_stop()
            calls.append(int(ex_state.step) - before)
            # a rejected step's exchanges ran (and drew) but its state is the old one
            ran = 0 if float(m["rejected"]) else len(keys)
            assert calls[-1] == ran, (t, calls[-1], ran)
            for k in metrics:
                metrics[k].append(float(m[k]))
            out[f"levels_{t}"] = np.asarray(ex_state.levels)
            out[f"hist_{t}"] = np.asarray(ex_state.hist)
    for k, v in metrics.items():
        out[k] = np.asarray(v, np.float64)
    out["calls"] = np.asarray(calls)
    out["opt_count"] = np.asarray(opt_state.count)
    if name == "qgenx":
        out["opt_sum_sq"] = np.asarray(opt_state.sum_sq)
    for j, l in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"p_{j}"] = np.asarray(l)
    for k in range(K):
        for i, d in enumerate(draws[k]):
            out[f"noise_{k}_{i}"] = d
    out["wire_names"] = np.asarray([nm for nm, _ in trace])
    out["wire_nbytes"] = np.asarray([nb for _, nb in trace], np.int64)
    np.savez(out_path, **out)


def main_arch(case: str, out_path: str, path: str, inputs_path: str) -> None:
    """An :data:`ARCH_CASES` step from the caller's params and batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import repro.launch.steps as steps
    from repro.configs.registry import get_config
    from repro.core.exchange import ExchangeConfig, make_exchange, wire_trace_start, \
        wire_trace_stop
    from repro.core.quantization import QuantConfig
    from repro.models.model import build
    from repro.optim import optimizers as opt

    assert jax.device_count() == 2, "run with --xla_force_host_platform_device_count=2"
    steps.shard_map = shard_map_shim
    name, method, bits, mode = case_fields(case)[:4]
    model = build(arch_config(ARCH_CASES[case], get_config))
    data = np.load(inputs_path)
    treedef = jax.tree_util.tree_structure(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(data[f"p0_{j}"]) for j in range(treedef.num_leaves)])
    quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=BUCKET)
    ex = make_exchange(ExchangeConfig(compressor="qgenx", quant=quant, mode=mode,
                                      use_pallas=path == "pallas"))
    opt_cfg = opt.OptimizerConfig(name=name, gamma_scale=GAMMA, method=method)
    batch = {k: jnp.asarray(data[f"{k}_0"]) for k in ("tokens", "labels", "embeds")
             if f"{k}_0" in data.files}
    args = (params, opt.init_state(opt_cfg, params), ex.init_state(), batch,
            jax.random.fold_in(jax.random.PRNGKey(7), 0))
    mesh = Mesh(np.array(jax.devices()), ("data",))
    with mesh:
        wire_trace_start()  # the recorder fires as the step is traced
        step = jax.jit(steps.make_train_step(model, opt_cfg, exchange=ex, mesh=mesh)).lower(
            *args).compile(compiler_options=FAST_COMPILE)
        trace = wire_trace_stop()
        params, opt_state, ex_state, m = step(*args)
    out = {k: np.asarray([float(m[k])], np.float64) for k in METRICS}
    out["calls"] = np.asarray([int(ex_state.step)])
    out["opt_count"] = np.asarray(opt_state.count)
    out["opt_sum_sq"] = np.asarray(opt_state.sum_sq)
    for j, l in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"p_{j}"] = np.asarray(l)
    out["wire_names"] = np.asarray([nm for nm, _ in trace])
    out["wire_nbytes"] = np.asarray([nb for _, nb in trace], np.int64)
    np.savez(out_path, **out)


if __name__ == "__main__":
    if sys.argv[1] in ARCH_CASES:
        main_arch(*sys.argv[1:])
    else:
        main(*sys.argv[1:])
