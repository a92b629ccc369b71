"""The port's entry points: device selection, rejected options, the build
step's failure path, noise sources and the training CLI on the CPU."""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.exchange import (
    ExchangeConfig,
    exchange_buffer_bytes,
    make_exchange,
)
from repro_torch.core.extragradient import QGenXConfig, qgenx_init
from repro_torch.core.faults import FaultSpec
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from repro_torch.core.quantization import QuantConfig, exponential_levels, uniform_levels
from repro_torch.core.vi import bilinear_saddle
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.models.transformer import Decoder
from repro_torch.optim.optimizers import OptimizerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

Q8 = QuantConfig(num_levels=15, bits=8, bucket_size=512)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build(get_config("tinyllama-1.1b").reduced())
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("make", [
    lambda: Decoder(get_config("tinyllama-1.1b").reduced()),
    lambda: make_exchange(ExchangeConfig(quant=Q8)).init_state(),
    lambda: uniform_levels(15),
    lambda: exponential_levels(5),
    lambda: bilinear_saddle(d=4).tensors(),
    lambda: qgenx_init(torch.zeros(8), QGenXConfig()),
], ids=["DenseDecoder", "init_state", "uniform_levels", "exponential_levels",
        "AffineVI.tensors", "qgenx_init"])
def test_constructors_take_no_default_device(make):
    # below the entry points, a caller names the device: nothing lands on
    # the CPU unasked
    with pytest.raises(TypeError, match="device"):
        make()


@pytest.mark.parametrize("kwargs", [
    dict(compressor="qgenx"),
    # kwargs4, 8, 10 and 12: the layouts are ported; what stays invalid is
    # the reference's invalid combinations of their options: buckets
    # without an overlap, an overlap without buckets, a planless overlap,
    # allreduce_fallback outside leafwise (kwargs9), error feedback with an
    # overlap; kwargs5: QAda without a refresh period
    dict(quant=Q8, num_buckets=2), dict(quant=Q8, level_schedule="qada"),
    dict(quant=Q8, drift_probe=0), dict(quant=Q8, recenter_every=-1),
    dict(quant=Q8, overlap="bucketed"), dict(quant=Q8, allreduce_fallback=True),
    dict(quant=Q8, num_buckets=2, overlap="bucketed", use_plan=False),
    dict(quant=Q8, level_schedule="bogus"),
    dict(compressor="ef21-topk", num_buckets=2, overlap="defer_tail"),
    # kwargs13: a field of the reference that has no counterpart in the
    # port (it always runs its kernels) is an unknown keyword
    dict(quant=Q8, use_pallas=True),
], ids=[f"kwargs{i}" for i in range(3, 14)])  # kwargs0-2 were randk / ef-randk / ef21-topk
def test_unported_exchange_options_are_rejected(kwargs):
    # an invalid combination raises ValueError; a field the port does not
    # have is an unknown keyword, TypeError
    with pytest.raises((TypeError, ValueError)):
        ExchangeConfig(**kwargs)


@pytest.mark.parametrize("compressor", ["randk", "ef21-topk", "ef-randk"])
def test_sparse_compressors_build_and_validate_their_fractions(compressor):
    cfg = ExchangeConfig(compressor=compressor, rand_frac=0.5, ef_topk_frac=0.1)
    assert (cfg.rand_frac, cfg.ef_topk_frac) == (0.5, 0.1)
    assert make_exchange(cfg).compressor.name == compressor
    for field in ("rand_frac", "ef_topk_frac"):
        assert getattr(ExchangeConfig(compressor=compressor), field) == 0.25
        assert getattr(ExchangeConfig(compressor=compressor, **{field: 1.0}), field) == 1.0
        for bad in (0.0, -0.25, 1.5):
            with pytest.raises(ValueError, match=field):
                ExchangeConfig(compressor=compressor, **{field: bad})


def test_device_prng_option_is_accepted():
    assert ExchangeConfig(quant=Q8, use_device_prng=True).use_device_prng
    assert not ExchangeConfig(quant=Q8).use_device_prng


def test_none_compressor_ignores_the_device_prng():
    # as in the reference: the exact mean draws no noise and asks no seed
    ex = make_exchange(ExchangeConfig(compressor="none", use_device_prng=True))
    tree = {"a": torch.randn(3, 5), "b": torch.randn(7)}
    mean, state = ex.pmean_tree(tree, ex.init_state("cpu"), ReplayNoise([]))
    assert state.step == 1
    assert all(torch.equal(mean[k], tree[k]) for k in tree)
    out = ex.compress_tree({k: v.unsqueeze(0) for k, v in tree.items()}, ReplayNoise([]),
                           workers=True)
    assert all(torch.equal(out[k][0], tree[k]) for k in tree)


def test_unported_optimizer_and_step_options_are_rejected():
    with pytest.raises(ValueError, match="unknown optimizer"):
        OptimizerConfig(name="sgd")
    model = build(get_config("tinyllama-1.1b").reduced(), device="cpu")
    ex = make_exchange(ExchangeConfig(quant=Q8))
    with pytest.raises(ValueError, match="da"):
        make_train_step(model, OptimizerConfig(name="qgenx", method="da"), ex)


@pytest.mark.parametrize("compression,compressor,bits", [
    ("none", "none", None), ("int8", "qgenx", 8), ("int4", "qgenx", 4),
])
def test_compression_flag_picks_the_compressor(compression, compressor, bits):
    args = train.parser().parse_args(["--compression", compression])
    cfg = train.build_exchange_config(args)
    assert cfg.compressor == compressor
    assert (cfg.quant.bits if cfg.quant else None) == bits


@pytest.mark.parametrize("argv", [
    ["--compressor", "none", "--compression", "int8"],
    ["--compressor", "none", "--compression", "int4"],
    ["--compressor", "layerwise"],
])
def test_contradictory_compressor_flags_raise(argv):
    with pytest.raises(ValueError, match="--compression"):
        train.build_exchange_config(train.parser().parse_args(argv))


@pytest.mark.parametrize("argv", [["--use-pallas"], ["--optimizer", "sgd"],
                                  ["--profile-dir", "x"], ["--compilation-cache-dir", "x"]])
def test_train_cli_has_no_unported_flags(argv, capsys):
    with pytest.raises(SystemExit):
        train.parser().parse_args(argv)


@pytest.mark.parametrize("argv,fields", [
    (["--num-buckets", "4", "--overlap", "defer_tail"],
     dict(num_buckets=4, overlap="defer_tail", use_plan=True)),
    (["--num-buckets", "3", "--overlap", "bucketed"], dict(num_buckets=3, overlap="bucketed")),
    (["--no-exchange-plan"], dict(use_plan=False, num_buckets=1, overlap="off")),
    (["--compress-mode", "leafwise"], dict(mode="leafwise", allreduce_fallback=False)),
])
def test_layout_flags_set_the_exchange_config(argv, fields):
    cfg = train.build_exchange_config(train.parser().parse_args(["--compression", "int8"] + argv))
    assert {k: getattr(cfg, k) for k in fields} == fields
    with pytest.raises(ValueError, match="ambiguous"):
        train.build_exchange_config(train.parser().parse_args(["--num-buckets", "2"]))


@pytest.mark.parametrize("spec,why", [("nan_grad@x", "bad step range"),
                                      ("nan_logits@1", "is not a train fault")])
def test_train_cli_exits_2_on_a_bad_fault_spec(spec, why, capsys):
    with pytest.raises(SystemExit) as e:
        train.main(["--reduced", "--device", "cpu", "--steps", "1", "--fault-spec", spec])
    assert e.value.code == 2
    assert "[train] bad --fault-spec" in capsys.readouterr().err
    with pytest.raises(ValueError, match=why):
        FaultSpec.parse_cli(spec, "train")


@pytest.mark.parametrize("argv,compressor,rand_frac,ef_topk_frac", [
    (["--compressor", "ef21-topk", "--ef-topk-frac", "0.1"], "ef21-topk", 0.25, 0.1),
    (["--compressor", "randk", "--rand-frac", "0.3"], "randk", 0.3, 0.25),
    (["--compressor", "ef-randk", "--rand-frac", "0.05", "--compression", "int8"],
     "ef-randk", 0.05, 0.25),
])
def test_train_cli_sparse_compressor_flags(argv, compressor, rand_frac, ef_topk_frac):
    cfg = train.build_exchange_config(train.parser().parse_args(argv))
    assert (cfg.compressor, cfg.rand_frac, cfg.ef_topk_frac) == (compressor, rand_frac,
                                                                 ef_topk_frac)


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no device compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_replay_noise_checks_shape_and_count():
    noise = ReplayNoise([np.zeros((2, 4), np.float32)])
    with pytest.raises(ValueError, match="shape"):
        noise.uniform((4, 2), "cpu")
    with pytest.raises(RuntimeError, match="exhausted"):
        noise.uniform((2, 4), "cpu")
    g = GeneratorNoise.seeded(3, "cpu")
    a = g.uniform((5, 7), "cpu")
    assert a.dtype == torch.float32 and bool(((a >= 0) & (a < 1)).all())
    assert not torch.equal(a, g.uniform((5, 7), "cpu"))


@pytest.mark.parametrize("mode,bits,method", [("two_phase", 8, "de"), ("gather", 4, "optda")])
def test_train_cli_on_cpu(mode, bits, method, capsys):
    out = train.main(["--reduced", "--steps", "2", "--batch", "4", "--seq", "16",
                      "--compression", f"int{bits}", "--compress-mode", mode,
                      "--optimizer", "qgenx", "--method", method, "--device", "cpu"])
    assert all(math.isfinite(v) for v in out["loss"])
    reduced = get_config("tinyllama-1.1b").reduced()
    n = sum(p.numel() for p in build(reduced, device="cpu").param_leaves())
    quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=512)
    calls = 2 if method == "de" else 1
    assert out["wire_bytes"] == [calls * sum(exchange_buffer_bytes(n, 1, quant, mode).values())] * 2
    assert "final_loss=" in capsys.readouterr().out


def test_qada_cli_prints_and_returns_levels(capsys):
    with pytest.raises(ValueError, match="level_update_every"):
        train.build_exchange_config(train.parser().parse_args(
            ["--compression", "int8", "--level-schedule", "qada"]))
    out = train.main(["--reduced", "--steps", "2", "--batch", "4", "--seq", "16",
                      "--compression", "int8", "--optimizer", "qgenx", "--level-schedule", "qada",
                      "--level-update-every", "2", "--device", "cpu"])
    levels = np.asarray(out["levels"], np.float32)
    assert levels.shape == (17,) and levels[0] == 0.0 and levels[-1] == 1.0
    assert not np.allclose(levels, np.linspace(0, 1, 17), atol=1e-4)
    reduced = get_config("tinyllama-1.1b").reduced()
    n = sum(p.numel() for p in build(reduced, device="cpu").param_leaves())
    per_call = sum(exchange_buffer_bytes(n, 1, Q8, "two_phase").values()) + 4 * 512
    assert out["wire_bytes"] == [2 * per_call] * 2
    assert "[train] qada levels=" in capsys.readouterr().out


@pytest.mark.parametrize("field", [dict(kv_lora_rank=32), dict(ssm_state=16)])
def test_unported_model_fields_are_rejected(field):
    # deepseek's MLA and the SSM fields come with ROADMAP A6: until then
    # they are unknown keywords
    with pytest.raises(TypeError):
        ModelConfig(name="x", arch_type="dense", num_layers=2, d_model=64, vocab_size=32,
                    **field)


@pytest.mark.parametrize("arch_type", ["ssm", "hybrid", "audio"])
def test_unported_arch_types_are_rejected(arch_type):
    # dense, moe and vlm are ported; the SSM, hybrid and audio families are not
    with pytest.raises(NotImplementedError, match=arch_type):
        ModelConfig(name="x", arch_type=arch_type, num_layers=2, d_model=64, vocab_size=32)


@pytest.mark.parametrize("argv", [["--host-devices", "2"], ["--compilation-cache-dir", "x"],
                                  ["--arch", "mamba2-2.7b"]])
def test_serve_cli_has_no_xla_only_flags(argv, capsys):
    # XLA-only flags (ROADMAP A8) are unknown; --arch offers ported configs only
    # (mamba2-2.7b comes with the SSM family, ROADMAP A6)
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.parser().parse_args(argv)
    assert serve.parser().parse_args([]).device == "cuda"


def test_serve_constructors_take_no_default_device():
    from repro_torch.serve import kv_cache

    pc = kv_cache.make_paged_cache_config(get_config("tinyllama-1.1b").reduced(), "int8",
                                          4, 8, 2)
    with pytest.raises(TypeError, match="device"):
        kv_cache.init_paged_cache(pc)


def test_port_imports_no_jax_and_nothing_of_the_reference():
    # every module of the package, and chip_smoke.py, in a fresh process
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import importlib.util as u\n"
        "spec = u.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(sum(k.startswith('repro_torch') for k in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(root / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 40  # serve, launch.serve among them
    for path in [root / "chip_smoke.py", *(root / "src" / "repro_torch").rglob("*.py")]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro"), (path, line)
