"""The MoE and VLM train step at K = 2 against the reference on 2 forced
host devices.

One case, ``_torch_step_k2_reference.ARCH_CASES["m"]``: llama4-5 (llama4's
reduced() at 5 layers: one period of chunk / MoE-chunk / chunk /
MoE-global and a chunk tail layer) carrying internvl2's 8 stubbed prefix
embeds, batch 4 x sequence 80 (two chunks of 64), case (a)'s qgenx ``de``
int8 two_phase step (bucket 256), once.  Each worker takes its own 2 rows:
its MoE layers route its 160 tokens with its own capacity (50 slots, not
the batch's 100), and it takes its own rows of the embeds.  At these
inputs worker 0's second MoE layer drops tokens at its capacity where the
whole batch at capacity 100 drops none (asserted), so a port that sized
capacity from the batch, or gave each worker the first rows' embeds,
misses the loss by far more than the tolerance.

The test makes the inputs (the port's init from seed 0 as the params,
the pipeline's batch with ``add_modality_stubs``' embeds, and each
worker's noise draws from the reference's keys), starts the reference
(``_torch_step_k2_reference.py m OUT.npz jnp INPUTS.npz``, under the
``shard_map`` shim, its step compiled with XLA's passes off) in a
subprocess under a hard timeout, and runs the port's two gloo workers
(``_torch_exchange_worker.run_step``) beside it.  The reference runs its
jnp path, which differs from its Pallas path only in the last ulp of the
K-mean (C2 in ROADMAP.md; interpret-mode Pallas over the 13,332 rows took
four times as long on the CPU; the K = 1 steps of ``test_torch_moe_step``
and ``test_torch_archs`` run the jnp path too).

Held as ``test_torch_step_k2`` holds case (a): both workers' outputs
identical, the loss rtol 1e-5, ``wire_bytes`` and the optimizer's
``count`` exactly, ``sum_sq`` rtol 1e-5, the params rtol 1e-5 / atol 1e-6
on all but 1e-5 of the coordinates (each within 1 % of its leaf's largest
weight), and the wire recorder's list equal to the reference's
trace-time list.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import torch

import _torch_exchange_worker
import _torch_step_k2_reference as ref_k2
from repro_torch.configs import get_config
from repro_torch.convert import params_to_jax
from repro_torch.data.pipeline import add_modality_stubs, make_pipeline, to_device
from repro_torch.models import moe as MOE
from repro_torch.models.model import build
from test_torch_moe import dropped
from test_torch_step_k2 import HERE, REF_TIMEOUT_S, _assert_params_close
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASE, K, BATCH, SEQ = "m", 2, 4, 80


def _drops(model, batch, rows) -> list:
    """Each MoE layer's dropped count on ``rows`` of the batch."""
    seen = []
    apply = MOE.moe_apply

    def counted(p, cfg, x):
        seen.append(dropped(cfg, p, x))
        return apply(p, cfg, x)

    MOE.moe_apply = counted
    try:
        with torch.no_grad():
            model.forward_aux(batch["tokens"][rows], batch["embeds"][rows])
    finally:
        MOE.moe_apply = apply
    return seen


def _inputs() -> dict:
    """Params, the batch and each worker's noise draws, as the reference
    would draw them (``_torch_step_k2_reference.main``'s keys)."""
    cfg = ref_k2.arch_config(ref_k2.ARCH_CASES[CASE], get_config)
    model = build(cfg, seed=0, device="cpu")
    leaves = jax.tree_util.tree_leaves(params_to_jax(model))
    out = {f"p0_{j}": np.asarray(a) for j, a in enumerate(leaves)}
    batch = add_modality_stubs(next(make_pipeline(cfg.vocab_size, BATCH, SEQ, seed=0)), cfg,
                               seed=0)
    assert batch["embeds"].shape == (BATCH, 8, cfg.d_model)
    tb = to_device(batch, "cpu")
    assert sum(_drops(model, tb, slice(0, BATCH // K))) > 0
    assert sum(_drops(model, tb, slice(None))) == 0
    out.update({f"{k}_0": v for k, v in batch.items()})
    n = sum(a.size for a in leaves)
    rows = -(-n // (K * ref_k2.BUCKET)) * K
    i = 0
    for ek in ref_k2.exchange_keys(CASE, 0, jax.random.fold_in(jax.random.PRNGKey(7), 0)):
        for k in range(K):
            a, b = jax.random.split(jax.random.fold_in(ek, k))
            out[f"noise_{k}_{i}"] = np.asarray(jax.random.uniform(a, (rows, ref_k2.BUCKET)))
            out[f"noise_{k}_{i + 1}"] = np.asarray(
                jax.random.uniform(b, (rows // K, ref_k2.BUCKET)))
        i += 2
    return out


def test_family_step_matches_reference_at_two_workers(tmp_path):
    inputs = _inputs()
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    src = str(HERE.parent / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen([sys.executable, str(HERE / "_torch_step_k2_reference.py"), CASE,
                             str(tmp_path / "reference.npz"), "jnp",
                             str(tmp_path / "inputs.npz")],
                            env=env, cwd=str(HERE.parent), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        fields = ref_k2.case_fields(CASE) + (None, ref_k2.ARCH_CASES[CASE])
        outs, _ = _torch_exchange_worker.run_group(K, tmp_path / "port", inputs, [fields],
                                                   target=_torch_exchange_worker.run_step)
        err = proc.communicate(timeout=REF_TIMEOUT_S)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0, err[-4000:]
    with np.load(tmp_path / "reference.npz") as z:
        ref = dict(z)
    w0, w1 = outs[0]
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)
    assert ref["calls"][0] == 2
    np.testing.assert_allclose(w0["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_array_equal(w0["wire_bytes"], ref["wire_bytes"])
    assert w0["opt_count"] == ref["opt_count"]
    np.testing.assert_allclose(w0["opt_sum_sq"], ref["opt_sum_sq"], rtol=1e-5)
    n_leaves = sum(1 for k in ref if k.startswith("p_"))
    _assert_params_close([w0[f"p_{j}"] for j in range(n_leaves)],
                         [ref[f"p_{j}"] for j in range(n_leaves)], "qgenx", 1)
    assert list(zip(w0["wire_names"], w0["wire_nbytes"])) == \
        list(zip(ref["wire_names"], ref["wire_nbytes"]))
