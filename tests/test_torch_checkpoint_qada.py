"""QAda's exchange state in checkpoints, on the CPU (split out of
``test_torch_checkpoint.py`` so that the suite's workers share its load):
a CLI run resumed from a checkpoint mid-period equals the uninterrupted
run bit for bit; a port checkpoint of a QAda state loads in the
reference and back; a fixed-table checkpoint into a QAda run exits 2 or
resets.
"""

import os

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jax_ckpt
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.quantization import QuantConfig as JaxQuant
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.core.exchange import ExchangeConfig, make_exchange
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.launch import train

from test_torch_checkpoint import Q8, _assert_trees_equal
from test_torch_checkpoint_resume import _cli
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# ---------------------------------------------------------------------------
# QAda state: a [512] histogram mid-period and refreshed tables
# ---------------------------------------------------------------------------

QADA = ("--level-schedule", "qada", "--level-update-every", "4")


def test_qada_checkpoint_resumes_bit_equal(tmp_path):
    """de makes 2 exchange calls a step and sync_every=2 / recenter_every=2
    a third on each sync step (steps 1, 3, 5), so with a period of 4 calls
    the step-4 checkpoint (6 calls) holds the table refreshed at call 4 and
    the histogram of calls 5 and 6."""
    full_dir, part_dir = str(tmp_path / "full"), str(tmp_path / "part")
    full = train.main(_cli(tmp_path, "--checkpoint-dir", full_dir, *QADA, steps=6))
    first = train.main(_cli(tmp_path, "--checkpoint-dir", part_dir, "--checkpoint-every", "4",
                            *QADA, steps=4))
    _, mid = ckpt.restore(part_dir, {"ex_state": make_exchange(ExchangeConfig(
        quant=QuantConfig(**Q8), level_schedule="qada",
        level_update_every=4)).init_state("cpu")})
    assert mid["ex_state"].hist.shape == (512,) and float(mid["ex_state"].hist.sum()) > 0
    assert not np.allclose(mid["ex_state"].levels.numpy(), np.linspace(0, 1, 17), atol=1e-4)
    rest = train.main(_cli(tmp_path, "--checkpoint-dir", part_dir, *QADA, steps=6))
    assert rest["start_step"] == 4
    for key in ("loss", "wire_bytes", "param_drift", "coded_bits_est"):
        assert first[key] + rest[key] == full[key], key
    assert rest["levels"] == full["levels"]
    with np.load(os.path.join(full_dir, "ckpt_6.npz")) as a, \
            np.load(os.path.join(part_dir, "ckpt_6.npz")) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_qada_checkpoint_interoperates_with_reference(tmp_path):
    ex = make_exchange(ExchangeConfig(quant=QuantConfig(**Q8), level_schedule="qada",
                                      level_update_every=3))
    st = ex.init_state("cpu")
    rng = np.random.RandomState(4)
    tree = {"a": torch.from_numpy(rng.randn(3000).astype(np.float32))}
    for _ in range(4):  # 4 calls: one refresh, one call of statistics since
        _, st = ex.pmean_tree(tree, st, GeneratorNoise.seeded(1, "cpu"))
    assert float(st.hist.sum()) > 0 and st.step == 4
    jcfg = JaxExchangeConfig(compressor="qgenx", quant=JaxQuant(**Q8), level_schedule="qada",
                             level_update_every=3)
    jtemplate = jax_make_exchange(jcfg).init_state()
    ckpt.save(str(tmp_path / "port"), 4, {"ex_state": st})
    step, got = jax_ckpt.restore(str(tmp_path / "port"), {"ex_state": jtemplate})
    want = convert.ex_state_to_jax(st)
    for f in ("levels", "levels_lo", "hist", "step", "error", "pending"):
        _assert_trees_equal(getattr(got["ex_state"], f), getattr(want, f))
    jax_ckpt.save(str(tmp_path / "ref"), 4, got)
    assert (tmp_path / "ref" / "ckpt_4.meta").read_bytes() == \
        (tmp_path / "port" / "ckpt_4.meta").read_bytes()
    _, back = ckpt.restore(str(tmp_path / "ref"), {"ex_state": ex.init_state("cpu")})
    back = convert.ex_state_from_jax(back["ex_state"], "cpu")
    assert back.step == 4 and torch.equal(back.hist, st.hist) and torch.equal(back.levels,
                                                                               st.levels)


def test_fixed_checkpoint_into_a_qada_run_exits_or_resets(tmp_path, capsys):
    d = str(tmp_path / "ck")
    train.main(_cli(tmp_path, "--checkpoint-dir", d, steps=1))
    args = _cli(tmp_path, "--checkpoint-dir", d, *QADA, steps=2)
    with pytest.raises(SystemExit) as e:
        train.main(args)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "ex_state" in err and "(1,) != template (512,)" in err  # the histogram
    out = train.main(args + ["--allow-ckpt-reset"])
    assert out["start_step"] == 1 and len(out["loss"]) == 1
