"""The LM train step at K = 2 under the bucketed two_phase exchange and
the leafwise mode, against the reference on 2 forced host devices
(reduced tinyllama-1.1b, f32, bucket 256, two qgenx ``de`` steps each;
``_torch_layouts.STEP_CASES``).

The reference runs in one subprocess for both cases
(``_torch_layouts_k2_reference.py``, its jnp path, under the
``shard_map`` shim) and writes the metrics, the final params and its
trace-time wire list.  While it compiles, this process draws each
worker's noise with ``jax.random`` (``_torch_layouts.step_draws``) and
the port runs as two gloo workers (``_torch_exchange_worker.run_layout_step``)
from the same initial params and batches (``_torch_layouts.step_params``,
``step_batches``), each replaying its draws; the bucketed exchange's last
collectives go out with ``async_op=True`` and are waited on after the
next bucket's quantize.

Tolerances: ``wire_bytes`` exactly, and the port's recorder list of the
first step equal to the reference's trace-time list (every call site
once: two exchanges a step); losses rtol 1e-6; the final params rtol
1e-6 / atol 1e-6 on all but 1e-5 of the coordinates, each within 1 % of
the largest weight of its leaf (``tests/test_torch_layouts_step.py``
says why), and equal on both workers.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import _torch_exchange_worker as worker
import _torch_layouts as lay
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = Path(__file__).resolve().parent
REF_TIMEOUT_S = 300


def _start_reference(out: Path, cases) -> subprocess.Popen:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    src = str(HERE.parent / "src")
    env["PYTHONPATH"] = os.pathsep.join([src, str(HERE)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen([sys.executable, str(HERE / "_torch_layouts_k2_reference.py"),
                             str(out), *cases], env=env, cwd=str(HERE.parent),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _finish_reference(proc: subprocess.Popen, out: Path) -> dict:
    err = proc.communicate(timeout=REF_TIMEOUT_S)[1]
    assert proc.returncode == 0, err[-4000:]
    with np.load(out) as z:
        return dict(z)


def _port_inputs(cases) -> dict:
    """The workers' inputs, keyed as ``run_layout_step`` reads them."""
    import jax

    init = [np.asarray(l) for l in jax.tree_util.tree_leaves(lay.step_params())]
    batches = lay.step_batches()
    inputs = {}
    for case in cases:
        for j, a in enumerate(init):
            inputs[f"{case}_p0_{j}"] = a
        for t, (tokens, labels) in enumerate(batches):
            inputs[f"{case}_tokens_{t}"], inputs[f"{case}_labels_{t}"] = tokens, labels
        for k, draws in enumerate(lay.step_draws(case, [a.shape for a in init], 2)):
            for i, d in enumerate(draws):
                inputs[f"{case}_noise_{k}_{i}"] = d
    return inputs


def test_layout_steps_match_reference_at_two_workers(tmp_path):
    cases = list(lay.STEP_CASES)
    out = tmp_path / "reference.npz"
    proc = _start_reference(out, cases)
    try:
        outs, ref = worker.run_group(2, tmp_path / "port", _port_inputs(cases), cases,
                                     target=worker.run_layout_step,
                                     while_running=lambda: _finish_reference(proc, out))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    for i, case in enumerate(cases):
        want_p = [ref[f"{case}_p_{j}"] for j in range(sum(
            1 for k in ref if k.startswith(f"{case}_p_")))]
        for k in range(2):
            got = outs[i][k]
            assert list(got["wire_bytes"]) == list(ref[f"{case}_wire_bytes"]), case
            assert list(got["wire_names"]) == list(ref[f"{case}_wire_names"]), case
            assert list(got["wire_nbytes"]) == list(ref[f"{case}_wire_nbytes"]), case
            np.testing.assert_allclose(got["loss"], ref[f"{case}_loss"], rtol=1e-6)
            total, off = 0, 0
            for j, b in enumerate(want_p):
                a = got[f"p_{j}"]
                total += a.size
                off += int((~np.isclose(a, b, rtol=1e-6, atol=1e-6)).sum())
                assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max(), (case, j)
                np.testing.assert_array_equal(a, outs[i][0][f"p_{j}"])
            assert off <= 1e-5 * total, f"{case}: {off} of {total} coordinates off"
