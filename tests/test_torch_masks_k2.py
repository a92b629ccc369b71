"""Partial participation in the port's exchange and the guarded step at
K = 2, against the reference.

* ``Exchange.pmean_tree(..., mask=m)`` over K gloo workers
  (``_torch_exchange_worker.run_masked``) against the reference's
  ``pmean_tree(..., mask=m)`` under ``jax.vmap(..., axis_name="data")``
  (its collectives over a mapped worker axis, ``use_pallas=True``), each
  worker's noise drawn as the reference draws it and replayed: qgenx int8
  two_phase under QAda (its histogram merged), layerwise int4 two_phase,
  none and randk (the mask acts on the leaves before any layout, so the
  mode does not enter it), each at K = 2 and 3 under an all-ones mask and
  with a dropped worker, in one group of workers per K.
  - An all-ones mask is bit-equal to no mask in the port (mean and
    merged histogram; the reference's own parity is
    ``tests/test_faults.py``'s).
  - A dropped worker (K = 2: worker 1; K = 3: worker 1 of 3), whose tree
    holds a NaN: the mean is the mean over the alive set, within rtol
    1e-6 / atol 1e-6 of the reference's (the bar of the port's K > 1
    exchange tests), finite, and identical on every worker; the QAda
    histogram keeps the dead worker out (finite, rtol 1e-5 of the
    reference's: the frameworks' bucket norms may differ in the last bit,
    which can move a coordinate between neighbouring bins).  Under
    ``none`` at K = 2 the mean is the alive worker's tree bit for bit
    (sum / 2 * 2).
* ``ef21-topk`` and ``ef-randk`` refuse a mask with the reference's
  ``ValueError``.
* The guarded train step at K = 2 (qgenx ``de``, int8 two_phase, 3 steps)
  under ``nan_grad@1:worker=0;drop@2:worker=1`` against the reference on
  two forced host devices (``_torch_step_k2_reference.py g``, in a
  subprocess, under the test-side ``shard_map`` shim), the port as two
  gloo workers (``run_step``): ``rejected`` [0, 1, 0], ``nonfinite``
  [0, 1, 0] and ``alive`` [2, 2, 1] exactly, ``wire_bytes``
  exactly (halved at step 2), the losses rtol 1e-5 and the final params
  as ``tests/test_torch_step_k2.py`` holds the qgenx cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_exchange_worker as worker
import _torch_step_k2_reference as ref_k2
from repro.core import exchange as jx
from repro.core.quantization import QuantConfig as JaxQuant
from repro_torch.core import exchange as tx
from repro_torch.core.noise import ReplayNoise
from test_torch_step_k2 import _assert_params_close, _references
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = [("qgenx", "two_phase", 8, True), ("layerwise", "two_phase", 4, False),
         ("none", "two_phase", 0, False), ("randk", "two_phase", 0, False)]


def _jcfg(compressor, mode, bits, qada):
    port = worker.mask_config(compressor, mode, bits, qada)
    kw = dict(compressor=compressor, mode=mode, use_pallas=True, axis_name="data",
              rand_frac=worker.MASK_FRAC, ef_topk_frac=worker.MASK_FRAC,
              level_schedule=port.level_schedule, level_update_every=port.level_update_every)
    if compressor == "layerwise":
        kw["layerwise_threshold"] = port.layerwise_threshold
    if port.quant is not None and compressor != "none":
        q = port.quant
        kw["quant"] = JaxQuant(num_levels=q.num_levels, bits=q.bits, bucket_size=q.bucket_size)
    return jx.ExchangeConfig(**kw)


def _draws(case, key, K, k, leaves):
    """Worker k's noise for one ``pmean_tree`` call, as the reference draws
    it: qgenx folds the worker into the call's key, layerwise each
    segment's tag first; randk's support is a permutation's head."""
    compressor, mode = case[0], case[1]
    ex = tx.make_exchange(worker.mask_config(*case))
    n = sum(l.size for l in leaves)
    if compressor == "randk":
        kk = max(1, round(worker.MASK_FRAC * n))
        return [np.asarray(jax.random.permutation(jax.random.fold_in(key, k), n)[:kk])]
    if compressor == "none":
        return []
    plan = ex.plan_for([torch.from_numpy(l) for l in leaves], axis_size=K)
    draws = []
    for seg in plan.segments:
        b = seg.quant.bucket_size
        rows = seg.padded // b
        base = jax.random.fold_in(key, seg.key_tag) if compressor == "layerwise" else key
        a, c = jax.random.split(jax.random.fold_in(base, k))
        draws.append(np.asarray(jax.random.uniform(a, (rows, b))))
        if mode == "two_phase":
            draws.append(np.asarray(jax.random.uniform(c, (rows // K, b))))
    return draws


def _inputs(K, runs, seed):
    """Each run's per-worker trees (the dropped worker's with a NaN), masks
    and noise."""
    rng = np.random.RandomState(seed)
    inputs = {}
    for i, (case, masks) in enumerate(runs):
        key = jax.random.PRNGKey(seed * 100 + i)
        for k in range(K):
            tree = {}
            for j, (name, shape) in enumerate(sorted(worker.LAYERWISE_TREE.items())):
                tree[name] = (rng.randn(*shape) * 10.0 ** (j - 2)).astype(np.float32)
            if masks[k] == 0.0:
                tree["b"][3] = np.nan  # why it dropped: it must vanish from the mean
            for name, v in tree.items():
                inputs[f"{name}_{i}_{k}"] = v
            inputs[f"mask_{i}_{k}"] = np.float32(masks[k])
            for j, d in enumerate(_draws(case, key, K, k, [tree[n] for n in sorted(tree)])):
                inputs[f"noise_{i}_{k}_{j}"] = d
    return inputs


def _reference(K, runs, seed, inputs):
    """Per run: the reference's masked per-worker means (leaves
    concatenated in tree order) and merged histograms.  (Its all-ones mask
    is bit-equal to no mask: ``tests/test_faults.py`` holds that.)"""
    refs = []
    for i, (case, masks) in enumerate(runs):
        ex = jx.make_exchange(_jcfg(*case))
        state = ex.init_state()
        key = jax.random.PRNGKey(seed * 100 + i)
        trees = {name: jnp.asarray(np.stack([inputs[f"{name}_{i}_{k}"] for k in range(K)]))
                 for name in worker.LAYERWISE_TREE}
        mean, st = jax.vmap(lambda t, mm: ex.pmean_tree(t, state, key, mask=mm),
                            axis_name="data")(trees, jnp.asarray(masks, jnp.float32))
        refs.append({"mean": np.concatenate([np.asarray(mean[n]).reshape(K, -1)
                                             for n in sorted(mean)], axis=1),
                     "hist": np.asarray(st.hist)})
    return refs


@pytest.mark.parametrize("K,dropped", [(2, [1.0, 0.0]), (3, [1.0, 0.0, 1.0])])
def test_masked_exchange_matches_reference(K, dropped, tmp_path):
    """Every case twice in one group of K workers: under an all-ones mask,
    then with a dropped worker."""
    runs = [(case, [1.0] * K) for case in CASES] + [(case, dropped) for case in CASES]
    inputs = _inputs(K, runs, K)
    outs, refs = worker.run_group(K, tmp_path, inputs, [case for case, _ in runs],
                                  target=worker.run_masked,
                                  while_running=lambda: _reference(K, runs, K, inputs))
    for i, ((case, masks), ref) in enumerate(zip(runs, refs)):
        for k, out in enumerate(outs[i]):
            msg = f"{case} masks {masks} worker {k}"
            np.testing.assert_allclose(out["mean"], ref["mean"][k], rtol=1e-6, atol=1e-6,
                                       err_msg=msg)
            np.testing.assert_array_equal(out["mean"], outs[i][0]["mean"])  # replicated
            assert out["step"] == 1
            if all(masks):
                np.testing.assert_array_equal(out["mean"], out["mean_nomask"], err_msg=msg)
                np.testing.assert_array_equal(out["hist"], out["hist_nomask"], err_msg=msg)
                continue
            assert np.isfinite(out["mean"]).all() and np.isfinite(ref["mean"][k]).all()
            if case[0] != "randk":  # (randk may leave the NaN out of its support)
                assert not np.isfinite(out["mean_nomask"]).all()  # the NaN, unmasked
            if case[3]:  # qada: the dead worker's NaN statistics stay out
                assert np.isfinite(out["hist"]).all() and out["hist"].sum() > 0
                np.testing.assert_allclose(out["hist"], ref["hist"][k], rtol=1e-5)
        if case[0] == "none" and K == 2 and not all(masks):
            alive = np.concatenate([inputs[f"{n}_{i}_0"].ravel()
                                    for n in sorted(worker.LAYERWISE_TREE)])
            np.testing.assert_array_equal(outs[i][0]["mean"], alive)


@pytest.mark.parametrize("compressor", ["ef21-topk", "ef-randk"])
def test_error_feedback_refuses_a_mask(compressor):
    tree = {"a": np.ones((4, 5), np.float32), "b": np.arange(7, dtype=np.float32)}
    jex = jx.make_exchange(jx.ExchangeConfig(compressor=compressor, axis_name="data"))
    jtree = {k: jnp.asarray(v)[None] for k, v in tree.items()}
    state = jex.init_state(template=tree, num_workers=1)
    with pytest.raises(ValueError) as want:
        jax.vmap(lambda t: jex.pmean_tree(t, state, jax.random.PRNGKey(0),
                                          mask=jnp.float32(1.0)), axis_name="data")(jtree)
    ex = tx.make_exchange(tx.ExchangeConfig(compressor=compressor))
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    st = ex.init_state("cpu", template=ttree, num_workers=1)
    with pytest.raises(ValueError) as got:
        ex.pmean_tree(ttree, st, ReplayNoise([]), mask=torch.tensor(1.0))
    assert str(got.value) == str(want.value)


def test_guarded_step_under_nan_grad_and_drop_matches_reference(tmp_path):
    fields, spec = ref_k2.FAULT_CASES["g"]
    (ref,) = _references("g", tmp_path)
    inputs = {k: v for k, v in ref.items()
              if k.startswith(("p0_", "tokens_", "labels_", "noise_"))}
    outs, _ = worker.run_group(2, tmp_path / "port", inputs, [fields + (spec,)],
                               target=worker.run_step)
    w0, w1 = outs[0]
    for k in w0:  # every step syncs: the workers stay replicated
        np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)
    assert list(ref["rejected"]) == list(w0["rejected"]) == [0.0, 1.0, 0.0]
    assert list(ref["nonfinite"]) == list(w0["nonfinite"]) == [0.0, 1.0, 0.0]
    assert list(ref["alive"]) == list(w0["alive"]) == [2.0, 2.0, 1.0]
    wire = list(w0["wire_bytes"])
    assert wire == list(ref["wire_bytes"]) and wire[2] == wire[0] / 2 and wire[1] == wire[0]
    np.testing.assert_allclose(w0["loss"], ref["loss"], rtol=1e-5)
    assert int(w0["opt_count"]) == int(ref["opt_count"]) == 2
    np.testing.assert_allclose(w0["opt_sum_sq"], ref["opt_sum_sq"], rtol=1e-5)
    n_leaves = sum(1 for k in ref if k.startswith("p_"))
    _assert_params_close([w0[f"p_{j}"] for j in range(n_leaves)],
                         [ref[f"p_{j}"] for j in range(n_leaves)], "qgenx", fields[6])
