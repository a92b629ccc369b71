"""The port's train step at K = 2 against the reference on 2 forced host
devices (reduced tinyllama-1.1b, f32, bucket 256).

The reference runs in a subprocess (``_torch_step_k2_reference.py``: JAX
fixes its device count at first start, so the pytest process cannot host
it) under a hard timeout, with ``use_pallas=True`` and the ``shard_map``
shim of ``test_torch_step.py``.  It writes the initial params, the
batches, every worker's noise draws, the per-step metrics, the final
params and its trace-time wire recorder list.  The port then runs as two
gloo workers (``_torch_exchange_worker.run_step``: ``spawn``, a
``FileStore`` in ``tmp_path``, a hard join timeout, process-group
teardown), each replaying its own draws.

Cases (``_torch_step_k2_reference.CASES``; (c) and (d) run in
``test_torch_step_k2_adam_qada.py``):

* (a) qgenx ``de``, int8 two_phase, 2 steps;
* (b) qgenx ``optda``, int4 gather, ``sync_every=2``, ``recenter_every=2``,
  4 steps;
* (c) ``extra_adam``, int8 two_phase, ``sync_every=2``, 4 steps;
* (d) qgenx ``de``, int8 two_phase, ``level_schedule="qada"``,
  ``level_update_every=2``, ``sync_every=2``, ``recenter_every=2``, 4
  steps: 3 exchange calls on each sync step (the re-centering one
  included), so the refreshes fall on calls 2, 4 and 6 (one of them
  inside the re-centering call), and the local steps move no statistics.

Tolerances: losses, ``param_drift``, ``coded_bits_est`` and qgenx's
all-reduced ``sum_sq`` (read through ``convert.opt_state_to_jax``) rtol
1e-5, ``wire_bytes`` and the optimizer's ``count`` exactly; the final params as ``test_torch_step.py``'s
docstring states for the matching K = 1 case (a stochastic rounding may
flip where the gradients differ in the last bits): the qgenx cases rtol
1e-5 / atol 1e-6 on all but 1e-5 of the coordinates, each within 1 % of
the largest weight of its leaf; ``extra_adam`` rtol 1e-5 / atol 1e-6 on
all but 1e-4 after one step and all but 1e-3 after more, each within
2 lr.  Adam turns one flipped rounding of a coordinate into a move of
up to lr there, and that changes the next steps' gradients and so their
roundings: four steps of case (c) leave 7.9e-4 of the coordinates off
rtol 1e-5 in the port (90 after its first, local, step, where Adam meets
gradients a few times its eps), and the reference's own Pallas and jnp
paths, which differ only in the last ulp of the K-mean, leave up to
3.6e-4 apart after two synced steps.  ``test_reference_paths_agree_at_two_workers``
holds those two paths to the same bar.  Case (d) also holds each step's
QAda histogram as a distribution (its running sum within 1e-5 of its
total mass: a coordinate whose last bits differ can cross a bin edge,
which moves its whole weight between two neighbouring bins, up to 7 % of
a sparse bin) and level table at atol 5e-4, with the port's table set
to the reference's after each step (``tests/test_torch_qada_step.py``
says why tables are not held bit for bit).  A refresh inside a sync step
is used by that step's later calls (calls 3, 5 and 6) before the
reference's table can be set, so every coordinate those calls quantize
in a bracket whose ends moved moves with it, and the histogram the next
refresh solves from holds those exchanges too: the tables drift further
than at K = 1 (measured 1.6e-4 after step 3), and the final params are
held to rtol 1e-5 / atol 1e-6 on all but 1e-3 of the coordinates
(measured 5.2e-4), each within 1 % of the largest weight of its leaf.
Both workers' metrics must be
identical, and so must their final params where the last step leaves
them equal (every step syncs, or the last step re-centers; in case (c)
each worker's Adam moments hold its own local gradients, so the params
stay apart and the reference's replicated output is worker 0's).  The
port's wire recorder list of a step that syncs must equal the
reference's trace-time list (each call site once).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_exchange_worker
import _torch_step_k2_reference as ref_k2
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = Path(__file__).resolve().parent
REF_TIMEOUT_S = 240
LR = 1e-3  # OptimizerConfig's default, the extra_adam case's


def _start_reference(case: str, out: Path, path: str) -> subprocess.Popen:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    src = str(HERE.parent / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.Popen([sys.executable, str(HERE / "_torch_step_k2_reference.py"), case,
                             str(out), path], env=env, cwd=str(HERE.parent),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


# the reference's outputs by (case, path): a run made for one test is
# reused by the next (case (b)'s Pallas run serves both tests that hold it)
_REFERENCE_RUNS: dict = {}


def _references(case: str, tmp_path: Path, paths=("pallas",)) -> list:
    """The reference's outputs on each of ``paths``, the runs this process
    has not made yet run side by side, each under a hard timeout."""
    todo = [p for p in paths if (case, p) not in _REFERENCE_RUNS]
    procs = [_start_reference(case, tmp_path / f"reference_{p}.npz", p) for p in todo]
    try:
        errs = [p.communicate(timeout=REF_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    assert [p.returncode for p in procs] == [0] * len(procs), [e[-4000:] for e in errs]
    for p in todo:
        with np.load(tmp_path / f"reference_{p}.npz") as z:
            _REFERENCE_RUNS[(case, p)] = dict(z)
    return [_REFERENCE_RUNS[(case, p)] for p in paths]


def _assert_params_close(got, want, name, steps, qada=False):
    total = sum(a.size for a in want)
    off = 0
    for a, b in zip(got, want):
        off += int((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).sum())
        if name == "extra_adam":
            assert np.abs(a - b).max() <= 2 * LR
        else:
            assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1.0)
    if qada:
        allowed = 1e-3
    elif name != "extra_adam":
        allowed = 1e-5
    else:
        allowed = 1e-4 if steps == 1 else 1e-3
    assert off <= allowed * total, f"{off} of {total} coordinates off"


# the cases of this file; the others (extra_adam's and QAda's) run in
# test_torch_step_k2_adam_qada.py, so that the suite's workers share them
CASES_HERE = ("a", "b")


@pytest.mark.parametrize("case", [c for c in sorted(ref_k2.CASES) if c in CASES_HERE])
def test_step_matches_reference_at_two_workers(case, tmp_path):
    check_case(case, tmp_path)


def check_case(case, tmp_path):
    """One case of ``_torch_step_k2_reference.CASES``, port against
    reference (the module docstring's checks)."""
    (ref,) = _references(case, tmp_path)
    inputs = {k: v for k, v in ref.items()
              if k.startswith(("p0_", "tokens_", "labels_", "noise_", "levels_"))}
    outs, _ = _torch_exchange_worker.run_group(
        2, tmp_path / "port", inputs, [ref_k2.CASES[case]],
        target=_torch_exchange_worker.run_step)
    w0, w1 = outs[0]
    n_leaves = sum(1 for k in ref if k.startswith("p_"))
    _, _, _, _, sync_every, recenter_every, n_steps, every = ref_k2.CASES[case]
    replicated = sync_every == 1 or recenter_every  # the last step leaves equal params
    for k in w0:
        if replicated or not k.startswith("p_"):
            np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)
    np.testing.assert_allclose(w0["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_array_equal(w0["wire_bytes"], ref["wire_bytes"])
    np.testing.assert_allclose(w0["param_drift"], ref["param_drift"], rtol=1e-5)
    np.testing.assert_allclose(w0["coded_bits_est"], ref["coded_bits_est"], rtol=1e-5)
    assert w0["opt_count"].dtype == ref["opt_count"].dtype and w0["opt_count"] == ref["opt_count"]
    if "opt_sum_sq" in ref:  # the all-reduced gamma statistic
        np.testing.assert_allclose(w0["opt_sum_sq"], ref["opt_sum_sq"], rtol=1e-5)
    _assert_params_close([w0[f"p_{j}"] for j in range(n_leaves)],
                         [ref[f"p_{j}"] for j in range(n_leaves)], ref_k2.CASES[case][0],
                         n_steps, qada=bool(every))
    assert list(zip(w0["wire_names"], w0["wire_nbytes"])) == \
        list(zip(ref["wire_names"], ref["wire_nbytes"]))
    for t in range(n_steps):
        want_cdf = np.cumsum(ref[f"hist_{t}"], dtype=np.float64)
        np.testing.assert_allclose(np.cumsum(w0[f"hist_{t}"], dtype=np.float64), want_cdf,
                                   rtol=0, atol=1e-5 * want_cdf[-1], err_msg=f"hist {t}")
        np.testing.assert_allclose(w0[f"levels_{t}"], ref[f"levels_{t}"], rtol=0, atol=5e-4,
                                   err_msg=f"levels after step {t}")
    if every:
        uniform = np.linspace(0, 1, ref["levels_0"].shape[0], dtype=np.float32)
        assert not np.allclose(ref[f"levels_{n_steps - 1}"], uniform, atol=1e-4)
        assert [n for n in ref["wire_names"]].count("qada_hist") == 3
    synced = ref["wire_bytes"] > 0
    assert sum(w0["wire_nbytes"]) == ref["wire_bytes"][synced][0]
    assert not ref["wire_bytes"][~synced].any()


@pytest.mark.parametrize("case", ["b", "c"])
def test_reference_paths_agree_at_two_workers(case, tmp_path):
    """The reference's Pallas and jnp paths, which differ only in the last
    ulp of the K-mean (C2), held to each other by the bar the port is held
    to: the bar is no looser than the reference's own spread."""
    pallas, jnp_path = _references(case, tmp_path, ("pallas", "jnp"))
    np.testing.assert_allclose(jnp_path["loss"], pallas["loss"], rtol=1e-5)
    np.testing.assert_array_equal(jnp_path["wire_bytes"], pallas["wire_bytes"])
    np.testing.assert_allclose(jnp_path["param_drift"], pallas["param_drift"], rtol=1e-5)
    np.testing.assert_allclose(jnp_path["coded_bits_est"], pallas["coded_bits_est"], rtol=1e-5)
    n_leaves = sum(1 for k in pallas if k.startswith("p_"))
    _assert_params_close([jnp_path[f"p_{j}"] for j in range(n_leaves)],
                         [pallas[f"p_{j}"] for j in range(n_leaves)], ref_k2.CASES[case][0],
                         ref_k2.CASES[case][6])
