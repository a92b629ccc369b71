"""The port's train step at K = 2 under ``ef21-topk`` against the reference
on 2 forced host devices (reduced tinyllama-1.1b, f32, qgenx ``de`` and
``optda``, ``ef_topk_frac`` 0.25, 3 steps).  ``tests/test_torch_randk_step_k2.py``
holds ``randk`` by the same helpers.

The reference runs in a subprocess (``_torch_sparse_step_k2_reference.py``:
JAX fixes its device count at first start) under a hard timeout and
writes the initial params, the batches, each worker's support draws, the
metrics, the final params, optimizer state and error memory, and its
trace-time wire list.  The port then runs as two gloo workers
(``_torch_exchange_worker.run_sparse_step``), each replaying its draws.

Tolerances, those of ``tests/test_torch_step_k2.py`` for its qgenx
cases: losses and the all-reduced ``sum_sq`` rtol 1e-5, ``wire_bytes``
and ``count`` exactly; the params and the ``[2, n]`` error memory rtol
1e-5 / atol 1e-6 on all but 1e-5 of the coordinates, every param within
1 % of its leaf's largest weight.  For ``ef21-topk`` the "all but" is
the swap ``tests/test_torch_ef_step.py`` explains: two coordinates on
either side of the k-th largest |g - h| may trade places where the
frameworks' gradients differ in their last bits.  Both workers' metrics,
params and error memory must be identical (every step syncs, and the
memory is replicated), and the port's wire recorder list of the first
step must equal the reference's trace-time list.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_exchange_worker
import _torch_sparse_step_k2_reference as ref_sparse
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = Path(__file__).resolve().parent
REF_TIMEOUT_S = 300


def outputs(cases, tmp_path):
    """(the reference's outputs, the port's ``outs[case][worker]``) for
    ``cases`` (names of ``ref_sparse.CASES``)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    src = str(HERE.parent / "src")
    env["PYTHONPATH"] = os.pathsep.join([src, str(HERE)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = tmp_path / "reference.npz"
    proc = subprocess.run([sys.executable, str(HERE / "_torch_sparse_step_k2_reference.py"),
                           str(out), *cases], env=env, cwd=str(HERE.parent),
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                          timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        ref = dict(z)
    inputs = {k: v for k, v in ref.items()
              if k.startswith(("p0_", "tokens_", "labels_")) or "_sup_" in k}
    specs = [(c, *ref_sparse.CASES[c], ref_sparse.FRAC, ref_sparse.STEPS) for c in cases]
    outs, _ = _torch_exchange_worker.run_group(2, tmp_path / "port", inputs, specs,
                                               target=_torch_exchange_worker.run_sparse_step)
    return ref, outs


def _off(got, want):
    return int((~np.isclose(got, want, rtol=1e-5, atol=1e-6)).sum())


def check_case(case, ref, w0, w1):
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)
    comp, method = ref_sparse.CASES[case]
    np.testing.assert_allclose(w0["loss"], ref[f"{case}_loss"], rtol=1e-5)
    np.testing.assert_array_equal(w0["wire_bytes"], ref[f"{case}_wire_bytes"])
    n = sum(ref[k].size for k in ref if k.startswith("p0_"))
    kk = max(1, round(ref_sparse.FRAC * n))
    calls = 1 if method == "optda" else 2
    assert list(w0["wire_bytes"]) == [8.0 * kk * calls] * ref_sparse.STEPS
    assert int(w0["opt_count"]) == int(ref[f"{case}_opt_count"]) == ref_sparse.STEPS
    np.testing.assert_allclose(w0["opt_sum_sq"], ref[f"{case}_opt_sum_sq"], rtol=1e-5)
    n_leaves = sum(1 for k in ref if k.startswith("p0_"))
    off = 0
    for j in range(n_leaves):
        a, b = w0[f"p_{j}"], ref[f"{case}_p_{j}"]
        off += _off(a, b)
        assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1.0)
    assert off <= 1e-5 * n, f"{off} of {n} param coordinates off"
    want_err = ref[f"{case}_error"]
    assert w0["error"].shape == want_err.shape == ((2, n) if comp == "ef21-topk" else (1,))
    assert _off(w0["error"], want_err) <= 1e-5 * want_err.size
    assert list(zip(w0["wire_names"], w0["wire_nbytes"])) == \
        list(zip(ref[f"{case}_wire_names"], ref[f"{case}_wire_nbytes"]))
    assert sum(w0["wire_nbytes"]) == ref[f"{case}_wire_bytes"][0]


CASES = ("ef21-de", "ef21-optda")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return outputs(CASES, tmp_path_factory.mktemp("ef21_k2"))


@pytest.mark.parametrize("case", CASES)
def test_ef21_steps_match_reference_at_two_workers(case, runs):
    ref, outs = runs
    w0, w1 = outs[CASES.index(case)]
    check_case(case, ref, w0, w1)
