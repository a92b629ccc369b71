"""One qgenx train step of the MoE family against the reference at K = 1,
and the port's checkpoint of its state in the reference.

On ``llama4-5`` (batch 4 x sequence 80: two chunks of 64, the second
padded; two MoE layers, each routing its 320 tokens with capacity 100),
from the same numpy params (``test_torch_moe.params_np``);
``test_torch_moe_step_vlm.py`` runs the same step on ``internvl2`` with
its 8 stubbed prefix embeds (batch 4 x 20), a file of its own so that
the suite's workers can take the two compiles side by side:

* one qgenx ``de`` step with the int8 two_phase exchange (bucket 512) and
  the reference's noise replayed, against the reference's
  ``make_train_step`` under the ``shard_map`` shim of ``test_torch_step``
  (one compile, ``FAST_COMPILE``), held as
  ``test_torch_archs.test_int8_two_phase_step_with_replayed_noise`` holds
  gemma3: loss rtol 1e-5, ``wire_bytes`` exactly, params rtol 1e-5 /
  atol 1e-6 on all but 1e-5 of the coordinates, every coordinate within
  1e-2 of the largest weight (a flipped stochastic rounding moves one by
  a level step); the loss includes 0.01 x the MoE layers' auxiliary loss;
* the port's checkpoint of the llama4-5 state (params, optimizer and
  exchange state, the stacked ``[1, E, D, F]`` expert leaves among them)
  restores in the reference's ``checkpointing.restore`` into the
  reference's own templates, every leaf equal to the port's, and the
  reference re-saving it writes the same meta bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import repro.launch.steps as jax_steps
from repro.checkpoint import checkpointing as jax_ckpt
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.quantization import QuantConfig as JaxQuant
from repro.models.model import build as jax_build
from repro.optim import optimizers as jax_opt
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.core.exchange import ExchangeConfig, make_exchange
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig

from test_torch_archs import compiled
from test_torch_moe import batch_np, params_np, port_model, small_configs
from test_torch_step import _replayed_noise, _shard_map_shim
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEQ = {"llama4-5": 80, "internvl2": 20}
BATCH, GAMMA, BUCKET = 4, 0.02, 512
KEY = jax.random.PRNGKey(42)
Q8 = dict(num_levels=15, bits=8, bucket_size=BUCKET)


def step_pair(name: str) -> dict:
    """The reference's step and the port's on config ``name``, from the
    same params and batch: ``{"jax": (params, opt_state, ex_state,
    metrics), "port": (model, opt_state, ex_state, metrics)}``.  The
    reference's step is compiled once, with ``FAST_COMPILE``."""
    jc, _ = small_configs(name)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jopt = jax_opt.OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
    jex = jax_make_exchange(JaxExchangeConfig(compressor="qgenx", quant=JaxQuant(**Q8),
                                              mode="two_phase"))
    params = jax.tree_util.tree_map(jnp.asarray, params_np(name))
    args = (params, jax_opt.init_state(jopt, params), jex.init_state(),
            {k: jnp.asarray(v) for k, v in batch_np(name, BATCH, SEQ[name]).items()}, KEY)
    with pytest.MonkeyPatch.context() as mp, mesh:
        mp.setattr(jax_steps, "shard_map", _shard_map_shim)
        step = compiled(jax_steps.make_train_step(jax_build(jc), jopt, exchange=jex, mesh=mesh),
                        *args)
        out = {"jax": step(*args)}
    opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=GAMMA, method="de")
    model = port_model(name, params_np(name))
    ex = make_exchange(ExchangeConfig(compressor="qgenx", quant=QuantConfig(**Q8),
                                      mode="two_phase"))
    n_live = sum(a.size for a in jax.tree_util.tree_leaves(params_np(name)))
    noise = _replayed_noise(KEY, n_live, BUCKET, calls=2)
    opt_state, ex_state, m = make_train_step(model, opt_cfg, ex)(
        port_opt.init_state(opt_cfg, model.param_leaves()), ex.init_state("cpu"),
        to_device(batch_np(name, BATCH, SEQ[name]), "cpu"), noise)
    assert noise.remaining == 0
    out["port"] = (model, opt_state, ex_state, m)
    return out


def check_step(pair: dict) -> None:
    """The port's step against the reference's: ``wire_bytes`` exactly,
    the loss and the params at the module's bar."""
    jparams, _, _, jm = pair["jax"]
    model, _, _, m = pair["port"]
    assert float(m["wire_bytes"]) == float(jm["wire_bytes"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    jp = [np.asarray(a) for a in jax.tree_util.tree_leaves(jparams)]
    tp = [p.detach().numpy() for p in model.param_leaves()]
    assert [a.shape for a in tp] == [b.shape for b in jp]
    total = sum(a.size for a in jp)
    off = 0
    for a, b in zip(tp, jp):
        off += int((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).sum())
        assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1.0)
    assert off <= 1e-5 * total, f"{off} of {total} coordinates off"


@pytest.fixture(scope="module")
def llama4():
    return step_pair("llama4-5")


@pytest.mark.parametrize("name", ["llama4-5"])  # the vlm file holds "internvl2"
def test_int8_two_phase_step_with_replayed_noise(llama4, name):
    check_step(llama4)


def test_port_checkpoint_of_the_moe_step_loads_in_reference(llama4, tmp_path):
    model, opt_state, ex_state, _ = llama4["port"]
    jparams, jopt_state, jex_state, _ = llama4["jax"]
    trees = {"params": convert.params_tree(model),
             "opt_state": convert.opt_state_tree(opt_state, model), "ex_state": ex_state}
    ckpt.save(str(tmp_path / "port"), 1, trees)
    templates = {"params": jparams, "opt_state": jopt_state, "ex_state": jex_state}
    for name, tree in templates.items():  # the reference's keys and treedefs
        assert sorted(ckpt._flatten_with_paths(trees[name])) == \
            sorted(jax_ckpt._flatten_with_paths(tree))
        assert ckpt.treedef_str(trees[name]) == str(jax.tree_util.tree_structure(tree))
    assert "layers/1/moe/wi" in ckpt._flatten_with_paths(trees["params"])
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
    jax_ckpt.save(str(tmp_path / "ref"), 1, got)
    assert (tmp_path / "port" / "ckpt_1.meta").read_bytes() == \
        (tmp_path / "ref" / "ckpt_1.meta").read_bytes()
