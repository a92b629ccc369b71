"""The port's MoE and VLM families (llama4-maverick-400b-a17b, internvl2-26b)
against the JAX reference on the CPU, f32, the same numpy params in both.

Two test configs, the same in both packages:

* ``llama4-5``: llama4's ``reduced()`` at 5 layers (d_model 256, 4 / 2
  heads, 4 experts top-1 with a shared expert, ``moe_d_ff`` 128, chunk 64):
  one period of chunk / MoE-chunk / chunk / MoE-global layers, stacked
  ``[1, E, D, F]`` expert leaves, then a chunk tail layer;
* ``internvl2``: internvl2's ``reduced()`` (2 dense layers, 8 prefix
  embeds).

``llama4-2`` (llama4's own ``reduced()``: two tail layers, the second a MoE
layer, ``layers = ()``) only round-trips.  The params are the port's init
converted with ``params_to_jax``, every norm scale drawn as 1 + 0.1 N(0, 1)
(``test_torch_archs.params_np``'s rule).  The reference compiles each
function once with ``test_torch_archs.FAST_COMPILE``.

* the full configs: every field, ``layer_pattern``, ``param_count``,
  ``active_param_count`` and ``reduced()`` equal to the reference's;
* ``chunk_local_attention`` on random inputs, the chunk dividing the
  sequence, padding it and longer than it: rtol 1e-6, atol 1e-6;
* ``moe_apply`` with a shared expert, forward (output and ``aux``) and the
  gradient of ``sum(out) + aux`` with respect to x and every MoE leaf,
  against ``jax.grad`` of the reference: at a train shape (48 tokens,
  capacity 15) and a 3-token decode shape (capacity 1), the kept mask
  equal to the reference's and the dropped count asserted > 0 in both.
  Outputs rtol 1e-6 (each expert cell takes at most one token, so the
  scatter and, at top-1, the combine are exact in any order), gradients
  rtol 1e-5 with atol 1e-6 times the leaf's largest magnitude (the
  backward's matmuls sum in other orders); at top-1 the renormalized gate
  is exactly 1, so the router learns through ``aux`` alone;
* ``add_modality_stubs`` equal to the reference's bit for bit, and
  ``to_device`` slicing ``embeds`` by rows as it slices tokens;
* forward logits, ``aux``, loss and every gradient leaf for llama4-5 at
  sequence 80 (two chunks, the second padded) and internvl2 with its
  embeds, held as ``test_torch_archs`` holds the dense families;
* ``params_from_jax`` -> ``params_to_jax`` gives the reference's tree
  back bit for bit, a MoE tail layer included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import add_modality_stubs as jax_stubs
from repro.launch.steps import cross_entropy_loss as jax_loss
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data.pipeline import add_modality_stubs, make_pipeline, to_device
from repro_torch.launch.steps import cross_entropy_loss
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.model import build

from test_torch_archs import compiled, tree_np
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

LLAMA4, INTERNVL2 = "llama4-maverick-400b-a17b", "internvl2-26b"
FWD_BATCH = 2
FWD_SEQ = {"llama4-5": 80, "internvl2": 20}


def small_configs(name: str):
    """(reference config, port config) of a test config (module docstring)."""
    if name == "internvl2":
        return jax_get_config(INTERNVL2).reduced(), get_config(INTERNVL2).reduced()
    jc, tc = jax_get_config(LLAMA4).reduced(), get_config(LLAMA4).reduced()
    if name == "llama4-5":
        jc, tc = (dataclasses.replace(c, num_layers=5) for c in (jc, tc))
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


def batch_np(name: str, batch: int, seq: int, seed: int = 0) -> dict:
    """A pipeline batch, with the reference's stubbed embeds for a VLM."""
    jc, _ = small_configs(name)
    return add_modality_stubs(next(make_pipeline(jc.vocab_size, batch, seq, seed=seed)),
                              small_configs(name)[1], seed=seed)


def dropped(cfg, p, x) -> int:
    """How many (token, k) assignments of ``x`` [B, S, D] the port's MoE
    layer with params ``p`` drops at capacity."""
    xt = x.reshape(-1, x.shape[-1])
    _, _, expert_idx = MOE.route(p, cfg, xt)
    return int((~MOE.slots(cfg, expert_idx, MOE.capacity(cfg, xt.shape[0]))[2]).sum())


def _pattern(p):
    period, flags, n_periods, n_rem = p
    return period, tuple(tuple(f) for f in flags), n_periods, n_rem


# ---------------------------------------------------------------------------
# Configs and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [LLAMA4, INTERNVL2])
def test_full_configs_match_reference(arch):
    want, got = jax_get_config(arch), get_config(arch)
    assert arch in ARCHS
    for cfg_w, cfg_g in ((want, got), (want.reduced(), got.reduced()),
                         (dataclasses.replace(want, num_layers=5),
                          dataclasses.replace(got, num_layers=5))):
        for f in dataclasses.fields(cfg_g):
            assert getattr(cfg_g, f.name) == getattr(cfg_w, f.name), (arch, f.name)
        assert _pattern(T.layer_pattern(cfg_g)) == _pattern(JT.layer_pattern(cfg_w))
        assert cfg_g.param_count() == cfg_w.param_count()
        assert cfg_g.active_param_count() == cfg_w.active_param_count()
        assert cfg_g.supports_long_context == cfg_w.supports_long_context
        assert T.paged_eligible(cfg_g) and JT.paged_eligible(cfg_w)
    if arch == LLAMA4:  # 12 periods of chunk / MoE-chunk / chunk / MoE-global
        assert T.layer_pattern(got) == (4, ((False, False), (True, False), (False, False),
                                            (True, True)), 12, 0)
        assert got.param_count() == 397_691_453_440
        red = got.reduced()
        assert (red.num_experts, red.num_experts_per_tok, red.num_shared_experts,
                red.moe_d_ff, red.sliding_window) == (4, 1, 1, 128, 64)
    else:
        assert got.param_count() == 19_860_664_320 and got.reduced().num_prefix_embeds == 8


@pytest.mark.parametrize("seq,chunk", [(16, 8), (20, 8), (5, 8)])
def test_chunk_local_attention_matches_reference(seq, chunk):
    rng = np.random.RandomState(seq * 31 + chunk)
    q, k, v = (rng.randn(2, seq, 4, 16).astype(np.float32) for _ in range(3))
    args = [jnp.asarray(t) for t in (q, k, v)]
    want = np.asarray(compiled(lambda *a: JL.chunk_local_attention(*a, chunk), *args)(*args))
    got = L.chunk_local_attention(*(torch.from_numpy(t) for t in (q, k, v)), chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # no look back: full attention masked to the query's own chunk
    i, j = np.arange(seq)[:, None], np.arange(seq)[None, :]
    C = min(chunk, seq)
    mask = torch.from_numpy((j <= i) & (j // C == i // C))
    full = L._sdpa(*(torch.from_numpy(t) for t in (q, k, v)), mask[None, None], 16**-0.5)
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


def _moe_tree(module) -> dict:
    return T._nested(module, lambda t: t.detach().numpy().copy())


def _ref_keep(p, cfg, x):
    """The reference's kept mask over flattened (token, k), from its own
    routing ops (``jax.lax.top_k``, the cumulative slot count)."""
    T_, D = x.shape[0] * x.shape[1], x.shape[2]
    probs = jax.nn.softmax(x.reshape(T_, D) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    onehot = jax.nn.one_hot(idx.reshape(-1), cfg.num_experts, dtype=jnp.int32)
    slot = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    return np.asarray(slot < MOE.capacity(cfg, T_))


@pytest.mark.parametrize("shape", [(2, 24), (3, 1)], ids=["train-48", "decode-3"])
def test_moe_apply_forward_and_gradients_match_reference(shape):
    jc, tc = small_configs("llama4-5")
    layer = T.LayerStack(tc, None, True, torch.Generator().manual_seed(3), torch.float32,
                         "cpu")
    p_np = _moe_tree(layer.moe)
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape, tc.d_model).astype(np.float32)
    if shape[0] == 3:  # the last token leans on the first's expert: capacity 1 drops it
        x[2] = 0.5 * x[2] + 2.0 * x[0]

    def f(p, x):
        out, aux = JMOE.moe_apply(p, jc, x)
        return jnp.sum(out) + aux, (out, aux)

    def grads(p, x):
        (_, outs), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, x)
        return outs, g, jax.grad(lambda r: JMOE.moe_apply({**p, "router": r}, jc, x)[1])(
            p["router"])

    jp, jx = jax.tree_util.tree_map(jnp.asarray, p_np), jnp.asarray(x)
    (want_out, want_aux), (gp, gx), want_aux_router = compiled(grads, jp, jx)(jp, jx)

    def port(router_from_aux_only=False):
        tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).requires_grad_(), p_np)
        tx = torch.from_numpy(x).requires_grad_()
        out, aux = MOE.moe_apply(tp, tc, tx)
        (aux if router_from_aux_only else out.sum() + aux).backward()
        return tp, tx, out, aux

    tp, tx, out, aux = port()
    want_out = np.asarray(want_out)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-6,
                               atol=1e-6 * np.abs(want_out).max())
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=1e-6)
    with torch.no_grad():
        xt = tx.reshape(-1, tc.d_model)
        _, _, idx = MOE.route(tp, tc, xt)
        keep = MOE.slots(tc, idx, MOE.capacity(tc, xt.shape[0]))[2].numpy()
    np.testing.assert_array_equal(keep, _ref_keep(jp, jc, jx))
    assert (~keep).sum() > 0 and dropped(tc, tp, tx.detach()) == (~keep).sum()
    assert MOE.capacity(tc, shape[0] * shape[1]) == {48: 15, 3: 1}[shape[0] * shape[1]]
    got = dict(zip(_paths(tp), jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp))))
    got["x"] = tx.grad.numpy()
    want = dict(zip(_paths(tp), jax.tree_util.tree_leaves(gp)))
    want["x"] = gx
    for name, w in want.items():
        if name != "router":
            w = np.asarray(w)
            np.testing.assert_allclose(got[name], w, rtol=1e-5,
                                       atol=1e-6 * max(np.abs(w).max(), 1e-30), err_msg=name)
    # top-1: every gate is exactly 1, so the router's gradient is aux's, in
    # each framework up to the rounding of p / p's derivative (6e-5 of its
    # largest magnitude at the train shape)
    aux_router = port(router_from_aux_only=True)[0]["router"].grad.numpy()
    want_aux_router = np.asarray(want_aux_router)
    scale = np.abs(want_aux_router).max()
    np.testing.assert_allclose(aux_router, want_aux_router, rtol=1e-5, atol=1e-6 * scale)
    for full, alone in ((got["router"], aux_router), (np.asarray(want["router"]),
                                                      want_aux_router)):
        assert np.abs(full - alone).max() <= 1e-3 * scale


def _paths(tree) -> list:
    """The dotted paths of a nested dict's leaves, in JAX flatten order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += [f"{k}.{sub}" for sub in _paths(tree[k])]
        else:
            out.append(k)
    return out


def test_modality_stubs_match_reference_and_split_by_rows():
    for name in ("internvl2", "llama4-5"):
        jc, tc = small_configs(name)
        raw = next(make_pipeline(jc.vocab_size, 4, 12, seed=3))
        got, want = add_modality_stubs(raw, tc, seed=5), jax_stubs(raw, jc, seed=5)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got is raw  # no embeds for a config without a prefix
    _, tc = small_configs("internvl2")
    batch = add_modality_stubs(raw, tc, seed=5)
    assert batch["embeds"].shape == (4, 8, 256)
    half = to_device(batch, "cpu", slice(2, 4))
    assert half["embeds"].dtype == torch.float32 and half["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(half["embeds"].numpy(), batch["embeds"][2:4])
    np.testing.assert_array_equal(half["tokens"].numpy(), batch["tokens"][2:4])


# ---------------------------------------------------------------------------
# Forward, gradients and the params' round trip
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference(name: str):
    """The reference's batch, logits, aux, loss and gradients."""
    jc, _ = small_configs(name)
    batch = batch_np(name, FWD_BATCH, FWD_SEQ[name])
    tokens, labels = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])
    embeds = jnp.asarray(batch["embeds"]) if "embeds" in batch else None

    def loss_logits(p):
        logits, aux = JT.forward(p, jc, tokens, embeds)
        return jax_loss(logits, labels, aux), (logits, aux)

    params = jax.tree_util.tree_map(jnp.asarray, params_np(name))
    fn = jax.value_and_grad(loss_logits, has_aux=True)
    (loss, (logits, aux)), grads = compiled(fn, params)(params)
    return batch, np.asarray(logits), float(aux), float(loss), tree_np(grads)


@pytest.mark.parametrize("name", ["llama4-5", "internvl2"])
def test_forward_and_gradients_match_reference(name):
    batch, want_logits, want_aux, want_loss, want_grads = reference(name)
    model = port_model(name, params_np(name))
    tb = to_device(batch, "cpu")
    logits, aux = model.forward_aux(tb["tokens"], tb.get("embeds"))
    loss = cross_entropy_loss(logits, tb["labels"], aux)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-5,
                               atol=1e-5 * np.abs(want_logits).max())
    np.testing.assert_allclose(float(aux.detach()) if torch.is_tensor(aux) else aux, want_aux, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    if name == "llama4-5":  # two MoE layers, each E * sum(me * ce) >= 1
        assert want_aux >= 2.0
    else:  # the embeds move the logits of the prefix
        assert float(aux) == 0.0
        plain = model(tb["tokens"])
        assert not torch.allclose(plain[:, :8], logits[:, :8])
    want = jax.tree_util.tree_leaves(want_grads)
    got = model.param_leaves()
    assert len(got) == len(want)
    for p, g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-30))


@pytest.mark.parametrize("name", ["llama4-5", "llama4-2", "internvl2"])
def test_params_round_trip(name):
    want = params_np(name)
    model = port_model(name, want)
    back = params_to_jax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the reference's own init has the same tree (leaf order and shapes)
    jc, _ = small_configs(name)
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jc), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(want)
    assert [s.shape for s in jax.tree_util.tree_leaves(shapes)] == \
        [a.shape for a in jax.tree_util.tree_leaves(want)]
    paths = [p for p, _ in model.named_param_leaves()]
    if name == "llama4-5":  # four stacks of one period, the MoE at offsets 1 and 3
        assert len(back["layers"]) == 4 and len(back["layers_tail"]) == 1
        assert back["layers"][1]["moe"]["wi"].shape == (1, 4, 256, 128)
        assert back["layers"][3]["moe"]["router"].shape == (1, 256, 4)
        assert "mlp" in back["layers_tail"][0]
        moe = [p.split(".", 3)[3] for p in paths if p.startswith("layers.1.moe.")]
        assert moe == ["router", "shared.wg", "shared.wi", "shared.wo", "wg", "wi", "wo"]
    if name == "llama4-2":  # layers = (), the MoE layer in the tail
        assert back["layers"] == () and "moe" in back["layers_tail"][1]
        assert back["layers_tail"][1]["moe"]["wo"].shape == (4, 128, 256)
