"""The reference train step at K = 2 under the sparse compressors, in a
process of its own.

    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_torch_sparse_step_k2_reference.py OUT.npz CASE...

JAX fixes its device count when it first starts, so
``tests/test_torch_ef_step_k2.py`` runs this file in a subprocess.  For
each case named (of :data:`CASES`: qgenx ``de`` / ``optda`` under
``ef21-topk`` and ``randk``, ``frac`` 0.25, 3 steps) it builds reduced tinyllama-1.1b
(f32, weights from ``PRNGKey(0)``), runs ``make_train_step`` on a
2-device mesh under the ``shard_map`` shim of
``_torch_step_k2_reference.py``, with the exchange state from
``init_state(template=params, num_workers=2)``, and writes to
``OUT.npz``:

* the initial params (``p0_{j}``) and each step's global batch
  (``tokens_{t}``, ``labels_{t}``; worker k takes rows ``2k : 2k + 2``);
* per case ``c``: the metrics ``{c}_loss`` and ``{c}_wire_bytes``, the
  final params ``{c}_p_{j}``, the optimizer state's ``count`` and
  ``sum_sq``, the final error memory ``{c}_error`` (replicated: each
  worker's copy equal), the trace-time wire list of the jitted step, and
  each worker's support draws in the order its exchanges ask for them
  (``{c}_sup_{k}_{i}``: ``permutation(fold_in(key, k), n)[:k]`` with the
  step's exchange keys ``split(key)``, an ``optda`` step using the
  second; none for ``ef21-topk``).
"""

import sys

BATCH, SEQ, GAMMA, FRAC, STEPS = 4, 16, 0.02, 0.25, 3
CASES = {"ef21-de": ("ef21-topk", "de"), "ef21-optda": ("ef21-topk", "optda"),
         "randk-de": ("randk", "de"), "randk-optda": ("randk", "optda")}


def main(out_path: str, *cases: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import repro.launch.steps as steps
    from _torch_step_k2_reference import shard_map_shim
    from repro.configs.registry import get_config
    from repro.core.exchange import ExchangeConfig, make_exchange, wire_trace_start, \
        wire_trace_stop
    from repro.data.pipeline import PipelineConfig, _batch_tokens
    from repro.models.model import build
    from repro.optim import optimizers as opt

    K = 2
    assert jax.device_count() == K, "run with --xla_force_host_platform_device_count=2"
    steps.shard_map = shard_map_shim
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build(cfg)
    params0 = model.init(jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(params0)
    out = {f"p0_{j}": np.asarray(l) for j, l in enumerate(leaves)}
    n = sum(l.size for l in leaves)
    k_keep = max(1, int(round(FRAC * n)))
    pc = PipelineConfig(vocab_size=cfg.vocab_size, batch=BATCH, seq_len=SEQ + 1, seed=0)
    batches = []
    for t in range(STEPS):
        toks = _batch_tokens(pc, t)
        out[f"tokens_{t}"], out[f"labels_{t}"] = toks[:, :-1], toks[:, 1:]
        batches.append({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})
    mesh = Mesh(np.array(jax.devices()), ("data",))
    for case in cases:
        comp, method = CASES[case]
        ex = make_exchange(ExchangeConfig(compressor=comp, rand_frac=FRAC, ef_topk_frac=FRAC))
        opt_cfg = opt.OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method=method)
        params = params0
        opt_state = opt.init_state(opt_cfg, params)
        ex_state = ex.init_state(template=params, num_workers=K)
        step = jax.jit(steps.make_train_step(model, opt_cfg, exchange=ex, mesh=mesh))
        draws = [[] for _ in range(K)]
        loss, wire = [], []
        base = jax.random.PRNGKey(11)
        with mesh:
            for t in range(STEPS):
                key = jax.random.fold_in(base, t)
                k1, k2 = jax.random.split(key)
                if comp == "randk":
                    for w in range(K):
                        for ek in ([k2] if method == "optda" else [k1, k2]):
                            draws[w].append(np.asarray(
                                jax.random.permutation(jax.random.fold_in(ek, w), n)[:k_keep]))
                if t == 0:
                    wire_trace_start()
                params, opt_state, ex_state, m = step(params, opt_state, ex_state,
                                                      batches[t], key)
                if t == 0:
                    trace = wire_trace_stop()
                loss.append(float(m["loss"]))
                wire.append(float(m["wire_bytes"]))
        out[f"{case}_loss"] = np.asarray(loss, np.float64)
        out[f"{case}_wire_bytes"] = np.asarray(wire, np.float64)
        for j, l in enumerate(jax.tree_util.tree_leaves(params)):
            out[f"{case}_p_{j}"] = np.asarray(l)
        out[f"{case}_opt_count"] = np.asarray(opt_state.count)
        out[f"{case}_opt_sum_sq"] = np.asarray(opt_state.sum_sq)
        err = ex_state.error
        shards = [np.asarray(s.data) for s in err.addressable_shards]
        for s in shards[1:]:
            np.testing.assert_array_equal(s, shards[0])
        out[f"{case}_error"] = np.asarray(err)
        for w in range(K):
            for i, d in enumerate(draws[w]):
                out[f"{case}_sup_{w}_{i}"] = d
        out[f"{case}_wire_names"] = np.asarray([nm for nm, _ in trace])
        out[f"{case}_wire_nbytes"] = np.asarray([nb for _, nb in trace], np.int64)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
