"""Resuming the port's train CLI from its checkpoints, on the CPU (reduced
tinyllama-1.1b, f32; split out of ``test_torch_checkpoint.py`` so that
the suite's workers share its load).

* A changed exchange config makes the train CLI exit 2, or reset
  ``ex_state`` under ``--allow-ckpt-reset``.
* A CPU run resumed at step 2 equals the uninterrupted run bit for bit
  (losses, metrics and the final checkpoint's arrays).
"""

import os

import numpy as np
import pytest

from repro_torch.launch import train
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _cli(tmp_path, *extra, steps=4, optimizer="qgenx"):
    return ["--reduced", "--steps", str(steps), "--batch", "4", "--seq", "16",
            "--compression", "int8", "--optimizer", optimizer, "--sync-every", "2",
            "--recenter-every", "2", "--device", "cpu", *extra]


def test_cli_exits_2_on_a_changed_exchange_config(tmp_path, capsys):
    d = str(tmp_path / "ck")
    train.main(_cli(tmp_path, "--checkpoint-dir", d, steps=1))
    args = _cli(tmp_path, "--checkpoint-dir", d, steps=2)
    args[args.index("int8")] = "int4"
    with pytest.raises(SystemExit) as e:
        train.main(args)
    assert e.value.code == 2
    assert "ex_state" in capsys.readouterr().err
    out = train.main(args + ["--allow-ckpt-reset"])
    assert out["start_step"] == 1 and len(out["loss"]) == 1


@pytest.mark.parametrize("optimizer", ["qgenx", "extra_adam"])
def test_resumed_run_equals_uninterrupted_run(tmp_path, optimizer):
    full_dir, part_dir = str(tmp_path / "full"), str(tmp_path / "part")
    full = train.main(_cli(tmp_path, "--checkpoint-dir", full_dir, optimizer=optimizer))
    first = train.main(_cli(tmp_path, "--checkpoint-dir", part_dir, "--checkpoint-every", "2",
                            steps=2, optimizer=optimizer))
    rest = train.main(_cli(tmp_path, "--checkpoint-dir", part_dir, optimizer=optimizer))
    assert rest["start_step"] == 2 and rest["restored"]["step"] == 2
    for key in ("loss", "wire_bytes", "param_drift", "coded_bits_est"):
        assert first[key] + rest[key] == full[key], key
    again = train.main(_cli(tmp_path, "--checkpoint-dir", part_dir, optimizer=optimizer))
    assert again["loss"] == [] and again["saves"] == []  # nothing ran, nothing saved
    with np.load(os.path.join(full_dir, "ckpt_4.npz")) as a, \
            np.load(os.path.join(part_dir, "ckpt_4.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
