"""The port's other dense families (gemma-2b, qwen3-4b, gemma3-27b) against
the JAX reference on the CPU, f32, the same numpy params in both.

The params are the port's init from a seed converted with
``params_to_jax``, every norm scale (``ln_*``, ``ln_f``, ``q_norm``,
``k_norm``) drawn as 1 + 0.1 N(0, 1) rather than left at one, so that a
misplaced scale shows (the reference's ``init_params`` costs seconds of
eager JAX per config).  gemma3 runs at its own ``reduced()`` (2 layers,
no period fits: ``layers = ()`` and two local tail layers, window 64) and
at ``replace(reduced(), num_layers=7, sliding_window=8)`` in both packages
("gemma3-27b-7": one period of 5 local and 1 global layer plus a local
tail layer; at sequence 20, or a 12-token prompt decoded to position 20,
the band bites and the padding path runs).  The reference compiles each
function once, with :data:`FAST_COMPILE`.

Configs and layers:

* the full configs: every field, ``layer_pattern``, ``param_count`` and
  ``reduced()`` equal to the reference's (tinyllama-1.1b too);
* ``head_rms_norm`` and ``banded_attention`` on random inputs (the window
  dividing the sequence, padding it, and longer than it): rtol 1e-6,
  atol 1e-6 (the same f32 arithmetic in another order);
* forward logits and loss gradients for gemma-2b (GeGLU, MQA), qwen3-4b
  (qk-norm, GQA), gemma3-27b and gemma3-27b-7.  Logits: rtol 1e-5 with
  atol 1e-5 times the largest logit (tied embeddings give logits near 300
  where tinyllama's untied ones are near 1; the f32 ulp at 300 is 3e-5);
  the loss rtol 1e-5; each gradient leaf rtol 1e-4 with atol 1e-5 times
  the leaf's largest magnitude (the frameworks sum the backward's matmuls
  in other orders);
* ``params_from_jax`` -> ``params_to_jax`` gives the reference's tree back
  bit for bit, empty ``layers`` and unstacked tail included.

The train step on gemma3-27b-7's pattern-stacked layout:

* the ExchangePlan's layout (shapes, offsets, the q_norm / k_norm leaves
  in JAX order) and packed buffer equal the reference's, and one int8
  two_phase exchange of a gradient-shaped tree with the reference's noise
  replayed returns the reference's mean bit for bit (the payloads exact);
* one qgenx ``de`` step with the int8 two_phase exchange and the
  reference's noise replayed, against the reference's ``make_train_step``
  under the test-side ``shard_map`` shim of ``test_torch_step``, held as
  ``test_torch_step.test_int8_two_phase_step_with_replayed_noise`` holds
  it (loss rtol 1e-5; params rtol 1e-5 / atol 1e-6 on all but 1e-5 of
  the coordinates, every coordinate within 1e-2 of the largest weight),
  ``wire_bytes`` exactly;
* the port's checkpoint of that state (params, optimizer and exchange
  state) restores in the reference's ``checkpointing.restore`` into the
  reference's own templates, every leaf equal to the port's, and the
  reference re-saving it writes the same meta bytes.

The decode paths on gemma3-27b-7:

* ``--kv-bits mixed`` gives local layers int4 and global layers int8 in
  both packages (``[4]*5, [8], [4]`` at 7 layers; gemma3 at 12:
  ``[4]*5, [8], [4]*5, [8]``), segment for segment the reference's
  layout, and an arena smaller than all-int8's;
* paged, at int8, int4, mixed and fp32: a prefill of two 12-token prompts
  (the banded prefill pads to 16), then 8 packed decode waves to position
  20 (the window of 8 masks the oldest keys) with a third, inactive slot,
  every cache draw of the reference replayed; each wave starts both
  packages from the same arena (the reference's, converted).  Held as
  ``test_torch_serve_model`` holds tinyllama: logits as the forward's
  above; payloads equal but for stochastic-rounding flips, each one level
  apart, at most 1e-4 of the coordinates written (the frameworks' K/V
  differ in the last bits), each prefill flip where the reference's
  ``|r - xi|`` is below the two packages' ``xi`` difference; norms and
  fp32 K/V rtol 1e-6, atol 1e-6 times the array's largest magnitude (the
  qk-norm's rsqrt before rope moves a K coordinate by an ulp or two of
  the head's scale);
* the dense decode: ``make_serve_step`` against the reference's
  ``decode_step`` token by token to position 20 (the window layers slice
  their last 8 entries), logits as above and tokens equal, and
  ``make_prefill_step`` against ``forward``;
* inside the port, fp32 paged decode equals the dense ``decode_step``
  (atol 1e-5 times the largest logit).
"""

import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.launch.steps as jax_steps
import repro.serve.kv_cache as JK
from repro.checkpoint import checkpointing as jax_ckpt
from repro.configs.registry import get_config as jax_get_config
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import _qgenx_pmean
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.quantization import QuantConfig as JaxQuant
from repro.core.quantization import uniform_levels as jax_levels
from repro.launch.steps import cross_entropy_loss as jax_loss
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import build as jax_build
from repro.optim import optimizers as jax_opt
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.exchange import ExchangeConfig, SingleWorker, make_exchange, qgenx_pmean
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from repro_torch.core.quantization import QuantConfig, uniform_levels
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.launch.steps import (
    cross_entropy_loss,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import build
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.serve import kv_cache as K

from test_torch_serve_model import _unpack, _xi
from test_torch_step import _replayed_noise, _shard_map_shim
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FULL = ("tinyllama-1.1b", "gemma-2b", "qwen3-4b", "gemma3-27b")
SMALL = ("gemma-2b", "qwen3-4b", "gemma3-27b", "gemma3-27b-7")
NAME = "gemma3-27b-7"  # the step and decode tests' config
FWD_BATCH, FWD_SEQ = 2, 20
BATCH, SEQ, GAMMA, BUCKET = 4, 20, 0.02, 512
KEY = jax.random.PRNGKey(42)
Q8 = dict(num_levels=15, bits=8, bucket_size=BUCKET)
SLOTS, PROMPT, WAVES, PAGE, NBLK = 3, 12, 8, 4, 5
RTOL, FLIP_SHARE = 1e-5, 1e-4


#: XLA options of the reference's compiles: these tests compile small
#: graphs once each, where XLA's optimisation passes cost more than they save
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def small_configs(name: str):
    """(reference config, port config) of a test arch at reduced size;
    ``gemma3-27b-7``: 7 layers and window 8 in both packages (one period
    of 5 local and 1 global layer, then a local tail layer)."""
    arch = name.removesuffix("-7")
    jc, tc = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if name.endswith("-7"):
        jc = dataclasses.replace(jc, num_layers=7, sliding_window=8)
        tc = dataclasses.replace(tc, num_layers=7, sliding_window=8)
    return jc, tc


@functools.lru_cache(maxsize=None)
def params_np(name: str, seed: int = 0):
    """The reference's params tree of numpy arrays for ``name``."""
    model = build(small_configs(name)[1], seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for path, p in model.named_param_leaves():
            if "norm" in path or any(part.startswith("ln") for part in path.split(".")):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen))
    return params_to_jax(model)


def port_model(name: str, params, grad: bool = True):
    model = params_from_jax(params, build(small_configs(name)[1], device="cpu"))
    for p in model.parameters():
        p.requires_grad_(grad)
    return model


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for arguments shaped as ``args`` with
    :data:`FAST_COMPILE` (call it with such arguments)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Configs, layers, forward and gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference(name: str):
    """The reference's batch, logits, loss and gradients at the test size
    (one compile per config)."""
    jc, _ = small_configs(name)
    batch = next(make_pipeline(jc.vocab_size, FWD_BATCH, FWD_SEQ, seed=0))
    tokens, labels = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])

    def loss_logits(p):
        logits, aux = JT.forward(p, jc, tokens)
        return jax_loss(logits, labels, aux), logits

    params = jax.tree_util.tree_map(jnp.asarray, params_np(name))
    fn = jax.value_and_grad(loss_logits, has_aux=True)
    (loss, logits), grads = compiled(fn, params)(params)
    return batch, np.asarray(logits), float(loss), tree_np(grads)


def _pattern(cfg):
    period, flags, n_periods, n_rem = cfg
    return period, tuple(tuple(f) for f in flags), n_periods, n_rem


@pytest.mark.parametrize("arch", FULL)
def test_full_configs_match_reference(arch):
    want, got = jax_get_config(arch), get_config(arch)
    assert arch in ARCHS
    for cfg_w, cfg_g in ((want, got), (want.reduced(), got.reduced())):
        for f in dataclasses.fields(cfg_g):
            assert getattr(cfg_g, f.name) == getattr(cfg_w, f.name), (arch, f.name)
        assert _pattern(T.layer_pattern(cfg_g)) == _pattern(JT.layer_pattern(cfg_w))
        assert cfg_g.param_count() == cfg_w.param_count()
    if arch == "gemma3-27b":  # 10 periods of 5 local : 1 global, 2 local tail layers
        assert T.layer_pattern(got)[2:] == (10, 2)
        assert got.reduced().sliding_window == 64


def test_head_rms_norm_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    want = np.asarray(JL.head_rms_norm(jnp.asarray(scale), jnp.asarray(x)))
    got = L.head_rms_norm(torch.from_numpy(scale), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seq,window", [(16, 8), (20, 8), (5, 8), (23, 4)])
def test_banded_attention_matches_reference(seq, window):
    rng = np.random.RandomState(seq * 31 + window)
    q, k, v = (rng.randn(2, seq, 4, 16).astype(np.float32) for _ in range(3))
    args = [jnp.asarray(t) for t in (q, k, v)]
    want = np.asarray(compiled(lambda *a: JL.banded_attention(*a, window), *args)(*args))
    got = L.banded_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # exactly `window` keys of history: the band equals full attention
    # masked to (i - window, i]
    i, j = np.arange(seq)[:, None], np.arange(seq)[None, :]
    mask = torch.from_numpy((j <= i) & (j > i - window))
    full = L._sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                   mask[None, None], 16**-0.5).numpy()
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", SMALL)
def test_forward_and_gradients_match_reference(name):
    batch, want_logits, want_loss, want_grads = reference(name)
    model = port_model(name, params_np(name))
    tokens = torch.from_numpy(batch["tokens"]).long()
    logits = model(tokens)
    loss = cross_entropy_loss(logits, torch.from_numpy(batch["labels"]).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-5,
                               atol=1e-5 * np.abs(want_logits).max())
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    want = jax.tree_util.tree_leaves(want_grads)
    got = model.param_leaves()
    assert len(got) == len(want)
    for p, g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-30))


@pytest.mark.parametrize("name", SMALL)
def test_params_round_trip(name):
    want = params_np(name)
    back = params_to_jax(port_model(name, want))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if name == "gemma3-27b":  # layers = (), two unstacked tail layers
        assert back["layers"] == () and len(back["layers_tail"]) == 2
        assert back["layers_tail"][0]["attn"]["wq"].ndim == 3
    if name == "gemma3-27b-7":  # six stacks of one period, one tail layer
        assert len(back["layers"]) == 6 and len(back["layers_tail"]) == 1
        assert back["layers"][5]["attn"]["q_norm"].shape == (1, 64)

# ---------------------------------------------------------------------------
# One train step on gemma3's pattern layout, and its checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def steps():
    """The reference's step and the port's, from the same params and batch;
    the reference compiles once.  Returns both states and metrics."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_steps, "shard_map", _shard_map_shim)
    try:
        jc, _ = small_configs(NAME)
        jmodel = jax_build(jc)
        batch = next(make_pipeline(jc.vocab_size, BATCH, SEQ, seed=0))
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        jopt = jax_opt.OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
        jex = jax_make_exchange(JaxExchangeConfig(compressor="qgenx", quant=JaxQuant(**Q8),
                                                  mode="two_phase"))
        params = jax.tree_util.tree_map(jnp.asarray, params_np(NAME))
        args = (params, jax_opt.init_state(jopt, params), jex.init_state(),
                {k: jnp.asarray(v) for k, v in batch.items()}, KEY)
        with mesh:
            step = compiled(jax_steps.make_train_step(jmodel, jopt, exchange=jex, mesh=mesh),
                            *args)
            jparams, jopt_state, jex_state, jm = step(*args)
    finally:
        mp.undo()
    model = port_model(NAME, params_np(NAME))
    opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
    ex = make_exchange(ExchangeConfig(compressor="qgenx", quant=QuantConfig(**Q8),
                                      mode="two_phase"))
    n_live = sum(a.size for a in jax.tree_util.tree_leaves(params_np(NAME)))
    noise = _replayed_noise(KEY, n_live, BUCKET, calls=2)
    opt_state, ex_state, m = make_train_step(model, opt_cfg, ex)(
        port_opt.init_state(opt_cfg, model.param_leaves()), ex.init_state("cpu"),
        to_device(batch, "cpu"), noise)
    assert noise.remaining == 0
    return {"batch": batch,
            "jax": (jparams, jopt_state, jex_state, jm),
            "port": (model, opt_state, ex_state, m)}


def test_exchange_at_the_pattern_layout_is_bit_exact(steps):
    """The plan over the pattern-stacked tree and one int8 two_phase mean
    of a gradient-shaped tree (the reference's params scaled), with the
    reference's noise, equal the reference's."""
    jleaves = [jnp.asarray(a) for a in jax.tree_util.tree_leaves(params_np(NAME))]
    tleaves = [p.detach() for p in steps["port"][0].param_leaves()]
    assert [tuple(t.shape) for t in tleaves] == [a.shape for a in jleaves]
    jcfg = JaxExchangeConfig(compressor="qgenx", quant=JaxQuant(**Q8), mode="two_phase")
    tcfg = ExchangeConfig(compressor="qgenx", quant=QuantConfig(**Q8), mode="two_phase")
    jplan = jax_make_exchange(jcfg).compressor.plan_for(jleaves, jcfg, 1, "pmean")
    tplan = make_exchange(tcfg).plan_for(tleaves, "pmean")
    for field in ("shapes", "offsets", "pack_order", "total", "n_live"):
        assert getattr(tplan, field) == getattr(jplan, field), field
    rng = np.random.RandomState(3)
    grads = [(rng.randn(*a.shape) * (1e-3 + np.abs(np.asarray(a)).mean())).astype(np.float32)
             for a in jleaves]
    jflat = jplan.pack([jnp.asarray(g) for g in grads])
    tflat = tplan.pack([torch.from_numpy(g) for g in grads])
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    k1, k2 = jax.random.split(jax.random.fold_in(KEY, 0))
    rows = tplan.total // BUCKET
    noise = ReplayNoise([np.asarray(jax.random.uniform(k1, (rows, BUCKET))),
                         np.asarray(jax.random.uniform(k2, (rows, BUCKET)))])
    mean = jax.vmap(lambda x: _qgenx_pmean(x, "data", jax_levels(15), KEY, JaxQuant(**Q8),
                                           "two_phase"), axis_name="data")
    want = compiled(mean, jflat[None])(jflat[None])[0]
    got = qgenx_pmean(tflat, SingleWorker(), uniform_levels(15, "cpu"), noise,
                      QuantConfig(**Q8), "two_phase")
    assert noise.remaining == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_two_phase_step_with_replayed_noise(steps):
    jparams, _, _, jm = steps["jax"]
    model, _, _, m = steps["port"]
    assert float(m["wire_bytes"]) == float(jm["wire_bytes"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    jp = [np.asarray(a) for a in jax.tree_util.tree_leaves(jparams)]
    tp = [p.detach().numpy() for p in model.param_leaves()]
    total = sum(a.size for a in jp)
    off = 0
    for a, b in zip(tp, jp):
        off += int((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).sum())
        # one flipped rounding moves a coordinate by at most one level step
        # of its bucket, scaled by the step size: far below the weights
        assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1.0)
    assert off <= 1e-5 * total, f"{off} of {total} coordinates off"


def test_port_checkpoint_of_the_step_loads_in_reference(steps, tmp_path):
    model, opt_state, ex_state, _ = steps["port"]
    jparams, jopt_state, jex_state, _ = steps["jax"]
    trees = {"params": convert.params_tree(model),
             "opt_state": convert.opt_state_tree(opt_state, model), "ex_state": ex_state}
    ckpt.save(str(tmp_path / "port"), 1, trees)
    templates = {"params": jparams, "opt_state": jopt_state, "ex_state": jex_state}
    for name, tree in templates.items():  # the reference's keys and treedefs
        assert sorted(ckpt._flatten_with_paths(trees[name])) == \
            sorted(jax_ckpt._flatten_with_paths(tree))
        assert ckpt.treedef_str(trees[name]) == str(jax.tree_util.tree_structure(tree))
    step, got = jax_ckpt.restore(str(tmp_path / "port"), templates)
    assert step == 1
    want = {"params": convert.params_to_jax(model),
            "opt_state": convert.opt_state_to_jax(opt_state, model),
            "ex_state": convert.ex_state_to_jax(ex_state)}
    pairs = [(got[n], want[n]) for n in ("params", "opt_state")]
    pairs += [(getattr(got["ex_state"], f), getattr(want["ex_state"], f))
              for f in ("levels", "levels_lo", "hist", "step", "error", "pending")]
    for g, w in pairs:
        gl, wl = jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(w)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype
    assert int(got["opt_state"].count) == opt_state.count == 1
    jax_ckpt.save(str(tmp_path / "ref"), 1, got)
    assert (tmp_path / "port" / "ckpt_1.meta").read_bytes() == \
        (tmp_path / "ref" / "ckpt_1.meta").read_bytes()

def test_train_step_and_checkpoint_leave_no_tensor_in_a_reference_cycle(tmp_path):
    """Every tensor a step, a checkpoint save and a restore drop is freed at
    once: none waits in a reference cycle for the cyclic gc (whose timing
    would otherwise move the step's peak by gigabytes at full width)."""
    model = port_model(NAME, params_np(NAME))
    opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
    ex = make_exchange(ExchangeConfig(compressor="qgenx", quant=QuantConfig(**Q8),
                                      mode="two_phase"))
    step = make_train_step(model, opt_cfg, ex)
    batch = to_device(next(make_pipeline(model.cfg.vocab_size, BATCH, SEQ, seed=1)), "cpu")
    state = (port_opt.init_state(opt_cfg, model.param_leaves()), ex.init_state("cpu"))
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        opt_state, ex_state, _ = step(*state, batch, GeneratorNoise.seeded(0, "cpu"))
        trees = {"params": convert.params_tree(model),
                 "opt_state": convert.opt_state_tree(opt_state, model), "ex_state": ex_state}
        ckpt.save(str(tmp_path), 1, trees)
        ckpt.restore(str(tmp_path), trees)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic, f"{len(cyclic)} tensors held in reference cycles"


# ---------------------------------------------------------------------------
# The decode paths on gemma3's local:global pattern
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    jc, _ = small_configs(NAME)
    params = params_np(NAME)
    return jc, jax.tree_util.tree_map(jnp.asarray, params), port_model(NAME, params, grad=False)


def _draws_arrays(keys, n_layers, shape):
    """``test_torch_serve_model._draws`` as one traced function."""
    fold = jax.vmap(jax.random.fold_in, (0, None))
    return [jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, t), shape))(
        fold(keys, l)) for l in range(n_layers) for t in (0, 1)]


_draws_jit = jax.jit(_draws_arrays, static_argnums=(1, 2))


def _jdraws(keys, n_layers, shape):
    return [np.asarray(a) for a in _draws_jit(keys, n_layers, shape)]


def _close(got, want):
    """Logits: rtol 1e-5, atol 1e-5 times the largest logit."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5 * np.abs(want).max())


def test_mixed_policy_stores_local_layers_as_int4():
    jc, tc = small_configs(NAME)
    assert K.layer_bit_policy(tc, "mixed") == JK.layer_bit_policy(jc, "mixed") == \
        (4, 4, 4, 4, 4, 8, 4)
    full = (get_config("gemma3-27b"), jax_get_config("gemma3-27b"))
    twelve = [dataclasses.replace(c, num_layers=12) for c in full]
    assert K.layer_bit_policy(twelve[0], "mixed") == JK.layer_bit_policy(twelve[1], "mixed") \
        == (4,) * 5 + (8,) + (4,) * 5 + (8,)
    for cfg, jcfg in ((tc, jc), (twelve[0], twelve[1])):
        pc = K.make_paged_cache_config(cfg, "mixed", 16, 8, 4)
        jpc = JK.make_paged_cache_config(jcfg, "mixed", 16, 8, 4)
        assert [(s.start, s.n, s.quant.bits) for s in pc.segments] == \
            [(s.start, s.n, s.quant.bits) for s in jpc.segments]
        assert K.cache_bytes(pc) == JK.cache_bytes(jpc)
        int8 = K.make_paged_cache_config(cfg, "int8", 16, 8, 4)
        assert K.cache_bytes(pc) < K.cache_bytes(int8)
        arena = K.init_paged_cache(pc, "cpu")
        assert sum(t.numel() * t.element_size() for t in arena.values()) == K.arena_bytes(pc)


def _compare_arena(cache, jcache, pc, stats):
    """Payloads equal but for adjacent-level flips (counted); norms and fp32
    K/V close; returns the flipped coordinates' (name, index) list."""
    got = convert.arena_to_jax(cache)
    flips = []
    for name, want in jcache.items():
        want = np.asarray(want)
        if name.endswith("_payload"):
            bits = pc.segments[int(name[3:name.index("_")])].quant.bits
            a, b = _unpack(got[name], bits), _unpack(want, bits)
            assert np.all(np.abs(a - b)[a != b] == 1), name
            flips += [(name, tuple(i)) for i in np.argwhere(a != b)]
        else:
            np.testing.assert_allclose(got[name], want, rtol=1e-6,
                                       atol=1e-6 * max(np.abs(want).max(), 1.0), err_msg=name)
    stats["flips"] += len(flips)
    return flips


def _layer_of(pc, name, l_in_seg):
    return pc.segments[int(name[3:name.index("_")])].start + l_in_seg


@pytest.fixture(scope="module")
def prompt_kvs(served):
    """Both packages' K/V of the prompts (the same for every policy),
    computed on first use."""
    jc, params, model = served
    box = {}

    def get(toks):
        if not box:
            args = (jnp.asarray(toks),)
            _, jkvs = compiled(lambda t: JT.forward_with_kv(params, jc, t), *args)(*args)
            _, pkvs = T.forward_with_kv(model, torch.from_numpy(toks).long())
            box["kvs"] = ([[np.asarray(a) for a in kv] for kv in jkvs],
                          [[a.numpy() for a in kv] for kv in pkvs])
        return box["kvs"]

    return get


@pytest.mark.parametrize("policy", ["int8", "int4", "mixed", "fp32"])
def test_paged_prefill_and_decode_match_reference(served, prompt_kvs, policy):
    jc, params, model = served
    n_layers = jc.num_layers
    pc = K.make_paged_cache_config(model.cfg, policy, PAGE, 2 * NBLK, NBLK)
    jpc = JK.make_paged_cache_config(jc, policy, PAGE, 2 * NBLK, NBLK)
    quant = [s.quant for s in pc.segments if s.quant is not None]
    F = pc.feat_pad
    rng = np.random.RandomState(5)
    toks = rng.randint(0, jc.vocab_size, size=(2, PROMPT)).astype(np.int32)
    pages = np.array([[0, 1, 2], [5, 6, 7]], np.int32)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(9),
                                                   jnp.arange(SLOTS, dtype=jnp.uint32))
    jcache0 = JK.init_paged_cache(jpc)
    cache = convert.arena_from_jax({k: np.asarray(v) for k, v in jcache0.items()}, "cpu")
    args = (jcache0, jnp.asarray(toks), jnp.asarray(pages), keys[:2])
    jlg, jcache = compiled(lambda *a: JT.prefill_paged(params, jc, jpc, *a), *args)(*args)
    draws = _jdraws(keys[:2], n_layers, (PROMPT, F)) if quant else []
    noise = ReplayNoise(draws)
    lg, _ = T.prefill_paged(model, pc, cache, torch.from_numpy(toks).long(),
                            torch.from_numpy(pages).long(), K.SourceNoise(noise))
    assert noise.remaining == 0
    _close(lg.numpy(), jlg)
    stats = {"flips": 0, "coords": 0}
    flips = _compare_arena(cache, jcache, pc, stats)
    if quant:
        stats["coords"] += n_layers * 2 * 2 * PROMPT * F
        if flips:  # each prefill flip: |r - xi_ref| below the xi difference
            jkvs, pkvs = prompt_kvs(toks)
            for name, (ls, page, off, col) in flips:
                l, tag = _layer_of(pc, name, ls), 0 if "_k_" in name else 1
                q = pc.segments[int(name[3:name.index("_")])].quant
                b, blk = np.argwhere(pages == page)[0]
                s = blk * PAGE + off
                xr = _xi(jkvs[l][tag][b, s][None], q)[0]
                xp = _xi(pkvs[l][tag][b, s][None], q)[0]
                assert abs(draws[2 * l + tag][b, s, col] - xr[col]) <= abs(xr[col] - xp[col])
    # decode waves: slots 0, 1 active at pos 12..19, slot 2 inactive
    pt = np.array([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [-1] * NBLK], np.int32)
    tok = np.zeros((SLOTS,), np.int32)
    tok[:2] = np.asarray(jnp.argmax(jlg[:, -1], -1))
    jdec = None
    for w in range(WAVES):
        pos = np.array([PROMPT + w, PROMPT + w, 0], np.int32)
        wk = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos))
        cache = convert.arena_from_jax({k: np.asarray(v) for k, v in jcache.items()}, "cpu")
        args = (jcache, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(pt), wk)
        jdec = jdec or compiled(lambda *a: JT.decode_step_paged(params, jc, jpc, *a), *args)
        jlg, jcache = jdec(*args)
        noise = ReplayNoise(_jdraws(wk, n_layers, (F,)) if quant else [])
        lg, _ = T.decode_step_paged(model, pc, cache, torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long(), torch.from_numpy(pt).long(),
                                    K.SourceNoise(noise))
        assert noise.remaining == 0
        _close(lg.numpy(), jlg)
        _compare_arena(cache, jcache, pc, stats)
        stats["coords"] += n_layers * 2 * 2 * F if quant else 0
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    assert stats["flips"] <= FLIP_SHARE * stats["coords"], stats


def test_dense_decode_and_prefill_steps_match_reference(served):
    jc, params, model = served
    rng = np.random.RandomState(6)
    Bd, Sd, total = 2, PROMPT, PROMPT + WAVES
    toks = rng.randint(0, jc.vocab_size, size=(Bd, Sd)).astype(np.int32)
    args = (jnp.asarray(toks),)
    jlg, _ = compiled(lambda t: JT.forward(params, jc, t), *args)(*args)
    _close(make_prefill_step(model)(torch.from_numpy(toks).long()).numpy(), jlg)
    jcache = JT.init_cache(jc, Bd, total)
    args = (jcache, jnp.asarray(toks[:, 0]), jnp.int32(0))
    jstep = compiled(lambda c, t, p: JT.decode_step(params, jc, c, t, p), *args)
    cache = T.init_cache(model.cfg, Bd, total, "cpu")
    serve = make_serve_step(model)
    tok = toks[:, 0]
    for t in range(total):
        jl, jcache = jstep(jcache, jnp.asarray(tok), jnp.int32(t))
        nxt, lg, cache = serve(cache, torch.from_numpy(tok).long(), t)
        _close(lg.numpy(), jl)
        jnxt = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(nxt.numpy(), jnxt)
        tok = toks[:, t + 1] if t + 1 < Sd else jnxt.astype(np.int32)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=1e-5,
                               atol=1e-5)


def test_fp32_paged_equals_dense_decode_in_the_port(served):
    _, _, model = served
    cfg = model.cfg
    rng = np.random.RandomState(7)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(2, PROMPT))).long()
    pc = K.make_paged_cache_config(cfg, "fp32", PAGE, 2 * NBLK, NBLK)
    pt = torch.arange(2 * NBLK).reshape(2, NBLK)
    lg_fwd = model(toks)
    dense = T.init_cache(cfg, 2, PROMPT + WAVES, "cpu")
    for t in range(PROMPT):
        lg_d, dense = T.decode_step(model, dense, toks[:, t], t)
    lgp, pcache = T.prefill_paged(model, pc, K.init_paged_cache(pc, "cpu"), toks,
                                  pt[:, :PROMPT // PAGE], None)
    torch.testing.assert_close(lgp, lg_fwd, rtol=0, atol=0)
    scale = float(lg_d.abs().max())
    nxt = torch.argmax(lg_d, -1)
    for t in range(PROMPT, PROMPT + WAVES):
        lg_p, _ = T.decode_step_paged(model, pc, pcache, nxt, torch.full((2,), t), pt, None)
        lg_d, _ = T.decode_step(model, dense, nxt, t)
        torch.testing.assert_close(lg_p, lg_d, rtol=1e-5, atol=1e-5 * scale)
        nxt = torch.argmax(lg_d, -1)
