"""The port's checkpoints (``repro_torch.checkpoint.checkpointing``)
against the reference's format.

* A checkpoint the port saves (reduced tinyllama-1.1b, f32, after two
  steps of qgenx ``de`` / ``optda`` / ``extra_adam``) restores in
  ``repro.checkpoint.checkpointing.restore`` into the reference's own
  templates, leaf for leaf equal to the port's state, and the reverse;
  the reference re-saving what it restored writes the same meta bytes.
  The array keys are the reference's ``_flatten_with_paths`` strings,
  generated here from the reference's trees.
* The meta codec writes ``msgpack.packb``'s bytes and reads
  ``msgpack.unpackb``'s values.
* A truncated npz and a garbage ``latest`` walk back; a changed exchange
  config raises ``CheckpointStructureError`` or resets ``ex_state`` under
  ``allow_reset`` (the train CLI's exit and resumed runs:
  ``test_torch_checkpoint_resume.py``; QAda's state:
  ``test_torch_checkpoint_qada.py``).
* bf16 layer weights round-trip bit for bit.
* A reference-saved f32 checkpoint resumes in the port's train CLI.
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jax_ckpt
from repro.configs.registry import get_config as jax_get_config
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import ExchangeState as JaxExchangeState
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.exchange import null_exchange_state
from repro.core.quantization import QuantConfig as JaxQuant
from repro.models.model import build as jax_build
from repro.optim import optimizers as jax_opt
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs import get_config
from repro_torch.core.exchange import ExchangeConfig, make_exchange
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

OPTS = [("qgenx", "de"), ("qgenx", "optda"), ("extra_adam", "de")]
Q8 = dict(num_levels=15, bits=8, bucket_size=512)


@pytest.fixture(scope="module")
def reference():
    cfg = jax_get_config("tinyllama-1.1b").reduced()
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _port_state(params_np, name, method, steps=2):
    """A port model and its states after ``steps`` int8 two_phase steps."""
    model = convert.params_from_jax(params_np, build(get_config("tinyllama-1.1b").reduced(),
                                                     device="cpu"))
    opt_cfg = OptimizerConfig(name=name, method=method, gamma_scale=0.02)
    ex = make_exchange(ExchangeConfig(quant=QuantConfig(**Q8)))
    step = make_train_step(model, opt_cfg, ex)
    opt_state = port_opt.init_state(opt_cfg, model.param_leaves())
    ex_state = ex.init_state("cpu")
    pipe = make_pipeline(512, 4, 16)
    for t in range(steps):
        opt_state, ex_state, _ = step(opt_state, ex_state, to_device(next(pipe), "cpu"),
                                      GeneratorNoise.seeded(t, "cpu"))
    return model, opt_state, ex_state


def _jax_templates(params_np, name, method):
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_state = jax_opt.init_state(jax_opt.OptimizerConfig(name=name, method=method), params)
    ex_state = jax_make_exchange(JaxExchangeConfig(compressor="qgenx",
                                                   quant=JaxQuant(**Q8))).init_state()
    return {"params": params, "opt_state": opt_state, "ex_state": ex_state}


def _port_trees(model, opt_state, ex_state):
    return {"params": convert.params_tree(model),
            "opt_state": convert.opt_state_tree(opt_state, model),
            "ex_state": ex_state}


def _assert_trees_equal(got, want):
    gl, gd = jax.tree_util.tree_flatten(got)
    wl, wd = jax.tree_util.tree_flatten(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


@pytest.mark.parametrize("name,method", OPTS)
def test_port_checkpoint_loads_in_reference(reference, name, method, tmp_path):
    model, opt_state, ex_state = _port_state(reference, name, method)
    trees = _port_trees(model, opt_state, ex_state)
    info = ckpt.save(str(tmp_path / "port"), 2, trees)
    templates = _jax_templates(reference, name, method)
    for tname, tree in templates.items():  # the keys are the reference's
        want_keys = sorted(jax_ckpt._flatten_with_paths(tree))
        assert sorted(ckpt._flatten_with_paths(trees[tname])) == want_keys
        assert ckpt.treedef_str(trees[tname]) == str(jax.tree_util.tree_structure(tree))
    step, got = jax_ckpt.restore(str(tmp_path / "port"), templates)
    assert step == 2
    _assert_trees_equal(got["params"], convert.params_to_jax(model))
    _assert_trees_equal(got["opt_state"], convert.opt_state_to_jax(opt_state, model))
    assert int(got["ex_state"].step) == ex_state.step == (4 if method == "de" else 2)
    want_ex = convert.ex_state_to_jax(ex_state)
    for f in ("levels", "levels_lo", "hist", "step", "error", "pending"):
        _assert_trees_equal(getattr(got["ex_state"], f), getattr(want_ex, f))
    assert int(got["opt_state"].count) == opt_state.count == 2
    jax_ckpt.save(str(tmp_path / "ref"), 2, got)
    meta = (tmp_path / "port" / "ckpt_2.meta").read_bytes()
    assert meta == (tmp_path / "ref" / "ckpt_2.meta").read_bytes()
    assert info["bytes"] == os.path.getsize(tmp_path / "port" / "ckpt_2.npz") + len(meta)


@pytest.mark.parametrize("name,method", OPTS)
def test_reference_checkpoint_loads_in_port(reference, name, method, tmp_path):
    rng = np.random.RandomState(3)
    noisy = lambda a: np.asarray(a) + np.asarray(rng.randn(*np.shape(a)), np.float32)  # noqa: E731
    ref = _jax_templates(reference, name, method)
    opt_state = ref["opt_state"]
    fields = {f: (jax.tree_util.tree_map(noisy, v) if f != "count" else jnp.int32(5))
              for f, v in opt_state._asdict().items() if v is not None}
    ref["opt_state"] = opt_state._replace(**fields)
    ex = ref["ex_state"]
    ref["ex_state"] = JaxExchangeState(ex.levels, ex.levels_lo, ex.hist, jnp.int32(9),
                                       ex.error, ex.pending)
    jax_ckpt.save(str(tmp_path / "ref"), 5, ref)
    model, opt_state, ex_state = _port_state(reference, name, method, steps=0)
    step, trees = ckpt.restore(str(tmp_path / "ref"), _port_trees(model, opt_state, ex_state))
    assert step == 5
    new_opt = convert.opt_state_from_jax(trees["opt_state"], type(opt_state), "cpu")
    new_ex = convert.ex_state_from_jax(trees["ex_state"], "cpu")
    assert new_opt.count == 5 and new_ex.step == 9
    _assert_trees_equal(convert.opt_state_to_jax(new_opt, model),
                        jax.tree_util.tree_map(np.asarray, ref["opt_state"]))
    _assert_trees_equal(trees["params"], ref["params"])
    ckpt.save(str(tmp_path / "port"), 5, _port_trees(model, new_opt, new_ex))
    assert (tmp_path / "port" / "ckpt_5.meta").read_bytes() == \
        (tmp_path / "ref" / "ckpt_5.meta").read_bytes()


@pytest.mark.parametrize("obj", [
    {}, [], 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, -1, -32, -33,
    -128, -129, -2**15 - 1, -2**31 - 1, "", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
    "é" * 40000, list(range(15)), list(range(16)), list(range(70000)),
    {f"k{i}": i for i in range(15)}, {f"k{i}": [i, str(i)] for i in range(16)},
    {"step": 3, "trees": {"t": {"keys": ["a/b", ".c"], "crc32": {"a/b": 4294967295}}},
     "extra": {}}, [[], {"x": [-7, "y"]}],
    # the serve engine's snapshot extra: None (an empty slot, no deadline),
    # bools and float deadlines
    None, 0.0, [None, True, False, -2.5, 1e300], {"slots": [None, {"ttl_left": 41.75,
                                                                   "stalled": False}]},
])
def test_meta_codec_is_msgpack(obj):
    data = ckpt.packb(obj)
    assert data == msgpack.packb(obj)
    assert ckpt.unpackb(data) == msgpack.unpackb(data)


# \xc0 (nil) and \xcb (float 64) left this list when the serve snapshot's
# extra brought them into the meta (test_meta_codec_is_msgpack holds them);
# float 32, bin 8 and fixext, which the codec never writes, took their place
@pytest.mark.parametrize("bad", [b"", b"\x92\x01", b"\x81\x01\x02", b"\xc1", b"\x01\x02",
                                 b"\xca" + bytes(4), b"\xc4\x01\x00", b"\xd4\x00\x00",
                                 b"\xcb" + bytes(4)])
def test_meta_codec_rejects_garbage(bad):
    with pytest.raises(ValueError):
        ckpt.unpackb(bad)


def _small_trees(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"w": torch.from_numpy(rng.randn(3, 4).astype(np.float32)),
                       "b": [torch.from_numpy(rng.randn(5).astype(np.float32))]},
            "opt_state": port_opt.AdamState(mu={"w": np.zeros((3, 4), np.float32)},
                                            nu={"w": np.ones((3, 4), np.float32)},
                                            count=seed, prev_half_grad=None)}


def test_fallback_walks_past_a_truncated_npz_and_a_garbage_latest(tmp_path):
    d = str(tmp_path)
    for s in (2, 4):
        ckpt.save(d, s, _small_trees(s))
    (tmp_path / "latest").write_text("not-a-step")
    assert ckpt.latest_step(d) is None
    step, trees, reset = ckpt.restore_with_fallback(d, _small_trees(0))
    assert step == 4 and reset == () and trees["opt_state"].count == 4
    npz = tmp_path / "ckpt_4.npz"
    npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 2])
    step, trees, _ = ckpt.restore_with_fallback(d, _small_trees(0))
    assert step == 2 and trees["opt_state"].count == 2
    torch.testing.assert_close(trees["params"]["w"], _small_trees(2)["params"]["w"],
                               rtol=0, atol=0)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(d, _small_trees(0), step=4)
    (tmp_path / "ckpt_2.meta").write_bytes(b"\xc1garbage")
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore_with_fallback(d, _small_trees(0))


def test_changed_exchange_config_raises_or_resets(tmp_path):
    d = str(tmp_path)
    e8 = make_exchange(ExchangeConfig(quant=QuantConfig(**Q8))).init_state("cpu")
    e4 = make_exchange(ExchangeConfig(quant=QuantConfig(num_levels=5, bits=4,
                                                        bucket_size=512))).init_state("cpu")
    ckpt.save(d, 1, {**_small_trees(1), "ex_state": e8})
    with pytest.raises(ckpt.CheckpointStructureError) as err:
        ckpt.restore_with_fallback(d, {**_small_trees(0), "ex_state": e4})
    assert err.value.tree == "ex_state" and "shape" in err.value.detail
    step, trees, reset = ckpt.restore_with_fallback(d, {**_small_trees(0), "ex_state": e4},
                                                    allow_reset=("ex_state",))
    assert step == 1 and reset == ("ex_state",) and "ex_state" not in trees
    bad = _small_trees(0)
    bad["params"]["w"] = bad["params"]["w"].double()  # never a silent cast
    with pytest.raises(ckpt.CheckpointStructureError, match="dtype"):
        ckpt.restore(d, {"params": bad["params"]})


def test_bf16_round_trips(tmp_path):
    cfg = get_config("tinyllama-1.1b").reduced()
    import dataclasses

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = build(cfg, seed=1, device="cpu")
    dtypes = {str(p.dtype) for p in model.param_leaves()}
    assert "torch.bfloat16" in dtypes
    ckpt.save(str(tmp_path), 1, {"params": convert.params_tree(model)})
    meta = ckpt.read_meta(str(tmp_path), 1)
    assert "bfloat16" in meta["trees"]["params"]["dtypes"].values()
    fresh = build(cfg, seed=2, device="cpu")
    _, got = ckpt.restore(str(tmp_path), {"params": convert.params_tree(fresh)})
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]), model.param_leaves()):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.detach().view(torch.int16) if b.dtype == torch.bfloat16
                           else b.detach())


@pytest.mark.parametrize("ex_kind", ["qgenx", "null"])
def test_reference_checkpoint_resumes_in_port_cli(reference, tmp_path, ex_kind, capsys):
    trees = _jax_templates(reference, "qgenx", "de")
    if ex_kind == "null":  # the reference CLI at one device builds no exchange
        trees["ex_state"] = null_exchange_state()
    d = str(tmp_path / "ck")
    jax_ckpt.save(d, 3, trees)
    argv = ["--reduced", "--steps", "4", "--batch", "4", "--seq", "16", "--compression",
            "int8", "--optimizer", "qgenx", "--device", "cpu", "--checkpoint-dir", d]
    if ex_kind == "null":
        with pytest.raises(SystemExit) as e:
            train.main(argv)
        assert e.value.code == 2
        argv.append("--allow-ckpt-reset")
    out = train.main(argv)
    assert out["start_step"] == 3 and len(out["loss"]) == 1
    assert np.isfinite(out["loss"][0])
    _, got = jax_ckpt.restore(d, _jax_templates(reference, "qgenx", "de"), step=4)
    assert int(got["opt_state"].count) == 1
