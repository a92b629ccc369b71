"""The port's bucketed exchange (``num_buckets`` with ``overlap`` =
bucketed | defer_tail, ``ExchangeState.pending``) against the reference.

Mirrors the reference's own harness, ``tests/test_bucketed_exchange.py``
(items 1-6 of its docstring), on the same inputs and the reference's
noise replayed (``_torch_layouts.py`` says how the reference keys it):

1. ``partition_leaf_ids`` equals the reference's on the same sizes, and
   its buckets are contiguous, covering and exactly ``min(k, n)``.
2. ``num_buckets=1, overlap="off"`` is the default config, and its mean
   equals the default exchange's bit for bit.
3. The bucketed ``pmean_tree`` equals the reference's
   ``pmean_tree_bucketed`` (its jnp path, under ``jax.vmap(...,
   axis_name="data")``), at 2 and 3 buckets, in gather and two_phase,
   int8 and int4, for qgenx, and layerwise / none / randk at one size:
   bit for bit at K = 1 (q = inf: the same arithmetic on the same
   inputs); over two gloo workers (the ``async_op`` collectives) within
   rtol 1e-6 / atol 1e-6 (the K-mean's last ulp, C2 / C5 in ROADMAP.md)
   and identical on both.  It also equals each bucket exchanged alone,
   serially, with its own draws (the pipeline changes no number).
4. The recorder's ``b{i}/`` operands sum per bucket to
   ``bucket_wire_bytes_tree`` (the reference's too), and in all to
   ``wire_bytes_tree``.
5. defer_tail over two calls: the reference's means and ``pending``,
   the first call's tail zero, the second call's tail the first call's
   pending; ``pending`` bitwise across a checkpoint, a guard rejection
   and a Watchdog rollback.
6. Every invalid combination raises the reference's message.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_exchange_worker as worker
import _torch_layouts as lay
from repro.core import exchange as jx
from repro.core import exchange_plan as jplan
from repro.core.quantization import QuantConfig as JaxQuant
from repro_torch.checkpoint import checkpointing
from repro_torch.configs import get_config
from repro_torch.core import exchange as tx
from repro_torch.core import exchange_plan as tplan
from repro_torch.core.faults import FaultSpec, Watchdog
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = [s for _, s in lay.tree_paths()]


# -- 1. partition -----------------------------------------------------------


@pytest.mark.parametrize("sizes,k", [
    ((1024, 1023, 31, 1232, 77, 5), 3), ((10, 10, 10, 10), 4), ((5000, 1, 1, 1), 2),
    ((7,), 4), ((3, 3, 3), 8), (tuple(range(1, 40)), 8), ((100,) * 8, 4),
    ((1, 1, 1, 5000), 3),
])
def test_partition_matches_reference(sizes, k):
    buckets = tplan.partition_leaf_ids(sizes, k)
    assert buckets == jplan.partition_leaf_ids(sizes, k)
    assert len(buckets) == min(k, len(sizes)) and all(buckets)
    assert [i for b in buckets for i in b] == list(range(len(sizes)))
    assert tplan.partition_leaf_ids(sizes, k) is buckets  # cached


# -- helpers ----------------------------------------------------------------


def _inputs(K, seed, calls=1):
    rng = np.random.RandomState(seed)
    return [lay.tree_leaves_np(rng, K) for _ in range(calls)]  # [call][worker][leaf]


def _reference(jex, per_worker, key, state=None):
    """The reference's ``pmean_tree`` of each worker's tree under
    ``jax.vmap``: (per-worker means as leaf lists, the new state of
    worker 0)."""
    K = len(per_worker)
    st = jex.init_state() if state is None else state
    stacked = lay.as_tree([jnp.asarray(np.stack([w[j] for w in per_worker]))
                           for j in range(len(SHAPES))])
    mean, new = lay.jit(jax.vmap(lambda t, s, k: jex.pmean_tree(t, s, k), axis_name="data",
                                 in_axes=(0, None, None)))(stacked, st, key)
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(mean)]
    return ([[l[k] for l in leaves] for k in range(K)],
            jax.tree_util.tree_map(lambda x: x[0], new))


def _port(ex, leaves_np, noise, state=None):
    st = ex.init_state("cpu") if state is None else state
    tree = lay.as_tree([torch.from_numpy(a) for a in leaves_np])
    mean, new = ex.pmean_tree(tree, st, noise)
    return [m.numpy() for m in tx.tree_flatten(mean)[0]], new


def _cat(leaves):
    return np.concatenate([np.asarray(l).ravel() for l in leaves])


# -- 2. one bucket, overlap off ------------------------------------------------


@pytest.mark.parametrize("compressor", ["qgenx", "layerwise", "none"])
@pytest.mark.parametrize("mode", ["gather", "two_phase"])
def test_one_bucket_without_overlap_is_the_default_exchange(compressor, mode):
    explicit = lay.port_config(compressor, 8, mode, num_buckets=1, overlap="off")
    assert explicit == lay.port_config(compressor, 8, mode)
    leaves = _inputs(1, 0)[0][0]
    got, _ = _port(tx.make_exchange(explicit), leaves, GeneratorNoise.seeded(3, "cpu"))
    want, _ = _port(tx.make_exchange(lay.port_config(compressor, 8, mode)), leaves,
                    GeneratorNoise.seeded(3, "cpu"))
    np.testing.assert_array_equal(_cat(got), _cat(want))


# -- 3 and 4. bucketed == reference; the recorder ------------------------------

BUCKETED = [  # (compressor, num_buckets, mode, bits)
    ("qgenx", 2, "gather", 8), ("qgenx", 2, "two_phase", 4), ("qgenx", 3, "gather", 4),
    ("qgenx", 3, "two_phase", 8), ("layerwise", 2, "two_phase", 4), ("none", 3, "gather", 8),
    ("randk", 2, "two_phase", 8),
]


def _bucketed_cfg(compressor, nb, mode, bits, overlap="bucketed"):
    return lay.port_config(compressor, bits, mode, num_buckets=nb, overlap=overlap)


def _draws(jex, key, K, k, shapes=SHAPES):
    """Worker k's draws of one exchange; randk's support draws as the
    reference's ``permutation(fold_in(fold_in(key, bi), k), n)[:k]``."""
    if jex.cfg.compressor == "none":
        return []
    if jex.cfg.compressor == "randk":
        leaves = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
        out = []
        buckets = jex.compressor.bucket_partition(leaves, jex.cfg)
        for bi in range(len(buckets) - 1, -1, -1):
            n = sum(math.prod(shapes[i]) for i in buckets[bi])
            kk = jax.random.fold_in(jax.random.fold_in(key, bi), k)
            out.append(np.asarray(jax.random.permutation(kk, n)[:jx._randk_k(n, jex.cfg)]))
        return out
    return lay.exchange_draws(jex, shapes, key, K, k)


@pytest.mark.parametrize("case", BUCKETED, ids=["-".join(map(str, c)) for c in BUCKETED])
def test_bucketed_matches_reference_one_worker(case):
    cfg = _bucketed_cfg(*case)
    jex = jx.make_exchange(lay.jax_config(cfg))
    key = jax.random.PRNGKey(11)
    per_worker = _inputs(1, 1)[0]
    want, _ = _reference(jex, per_worker, key)
    ex = tx.make_exchange(cfg)
    noise = ReplayNoise(_draws(jex, key, 1, 0))
    tx.wire_trace_start()
    got, state = _port(ex, per_worker[0], noise)
    rec = tx.wire_trace_stop()
    assert noise.remaining == 0 and state.step == 1
    np.testing.assert_array_equal(_cat(got), _cat(want[0]))
    # the recorder, per bucket, against both packages' accounting
    tree = lay.as_tree([torch.from_numpy(a) for a in per_worker[0]])
    jtree = lay.as_tree([jnp.asarray(a) for a in per_worker[0]])
    per_bucket = ex.bucket_wire_bytes_tree(tree, 1)
    assert per_bucket == jex.bucket_wire_bytes_tree(jtree, 1)
    assert sum(per_bucket) == ex.wire_bytes_tree(tree, 1) == jex.wire_bytes_tree(jtree, 1)
    if case[0] != "none":  # the exact mean hands no explicit buffer to the recorder
        sums = [0] * case[1]
        for name, nbytes in rec:
            assert name.startswith("b"), name
            sums[int(name.split("/")[0][1:])] += nbytes
        assert sums == per_bucket


def test_pipelined_buckets_equal_each_bucket_exchanged_alone():
    """The reference's item 3 on the port: the pipelined exchange equals
    each bucket's monolithic exchange run serially with its own draws."""
    cfg = _bucketed_cfg("layerwise", 3, "two_phase", 4)
    ex, mono = tx.make_exchange(cfg), tx.make_exchange(lay.port_config("layerwise", 4,
                                                                       "two_phase"))
    leaves = [torch.from_numpy(a) for a in _inputs(1, 2)[0][0]]
    got = ex.pmean_tree(leaves, ex.init_state("cpu"), GeneratorNoise.seeded(5, "cpu"))[0]
    noise = GeneratorNoise.seeded(5, "cpu")
    want = [None] * len(leaves)
    buckets = ex.bucket_partition(leaves)
    for bi in range(len(buckets) - 1, -1, -1):
        sub = [leaves[i] for i in buckets[bi]]
        for i, m in zip(buckets[bi], mono.pmean_tree(sub, mono.init_state("cpu"), noise)[0]):
            want[i] = m
    for a, b in zip(got, want):
        assert torch.equal(a, b)


K2_CASES = [(dict(compressor="qgenx", bits=8, mode="two_phase", num_buckets=3,
                  overlap="bucketed"), 1),
            (dict(compressor="layerwise", bits=4, mode="gather", num_buckets=2,
                  overlap="bucketed"), 1),
            (dict(compressor="qgenx", bits=4, mode="two_phase", num_buckets=2,
                  overlap="defer_tail"), 2)]


def test_bucketed_matches_reference_gloo_workers(tmp_path):
    K = 2
    inputs, refs = {}, []
    for i, (kw, calls) in enumerate(K2_CASES):
        cfg = lay.port_config(**kw)
        jex = jx.make_exchange(lay.jax_config(cfg))
        trees = _inputs(K, 20 + i, calls)
        keys = [jax.random.PRNGKey(30 + c) for c in range(calls)]
        for c in range(calls):
            for k in range(K):
                for j, a in enumerate(trees[c][k]):
                    inputs[f"x_{i}_{c}_{k}_{j}"] = a
        for k in range(K):
            draws = [d for key in keys for d in _draws(jex, key, K, k)]
            for j, d in enumerate(draws):
                inputs[f"noise_{i}_{k}_{j}"] = d
        refs.append((jex, trees, keys))

    def reference():
        out = []
        for jex, trees, keys in refs:
            st = jex.init_state(template=lay.as_tree([jnp.zeros(s) for s in SHAPES]),
                                num_workers=K)
            means = []
            for tree, key in zip(trees, keys):
                m, st = _reference(jex, tree, key, st)
                means.append(m)
            out.append((means, np.asarray(st.pending)))
        return out

    outs, want = worker.run_group(K, tmp_path, inputs, K2_CASES, target=worker.run_layouts,
                                  while_running=reference)
    for i, (means, pending) in enumerate(want):
        for k in range(K):
            for c, m in enumerate(means):
                got = outs[i][k][f"mean_{c}"]
                np.testing.assert_allclose(got, _cat(m[k]), rtol=1e-6, atol=1e-6,
                                           err_msg=f"case {i} call {c} worker {k}")
                np.testing.assert_array_equal(got, outs[i][0][f"mean_{c}"])
            np.testing.assert_allclose(outs[i][k]["pending"], pending, rtol=1e-6, atol=1e-6)
            assert all(n.startswith("b") for n in outs[i][k]["wire_names"])


# -- 5. defer_tail -----------------------------------------------------------


def test_defer_tail_two_calls_match_reference():
    cfg = _bucketed_cfg("qgenx", 2, "gather", 8, overlap="defer_tail")
    jex = jx.make_exchange(lay.jax_config(cfg))
    ex = tx.make_exchange(cfg)
    calls = _inputs(1, 3, calls=2)
    keys = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    template = lay.as_tree([torch.zeros(s) for s in SHAPES])
    st = ex.init_state("cpu", template=template, num_workers=1)
    jst = jex.init_state(template=lay.as_tree([jnp.zeros(s) for s in SHAPES]), num_workers=1)
    assert st.pending.shape == jst.pending.shape and not st.pending.any()
    assert ex.init_state("cpu").pending.shape == (1,)  # no template: the placeholder
    tail = set(ex.bucket_partition(SHAPES)[0])
    got, pend = [], [st.pending]
    for leaves, key in zip(calls, keys):
        want, jst = _reference(jex, leaves, key, jst)
        g, st = _port(ex, leaves[0], ReplayNoise(_draws(jex, key, 1, 0)), st)
        np.testing.assert_array_equal(_cat(g), _cat(want[0]))
        np.testing.assert_array_equal(st.pending.numpy(), np.asarray(jst.pending))
        got.append(g)
        pend.append(st.pending)
    plan = ex.plan_for([torch.zeros(SHAPES[i]) for i in sorted(tail)])
    applied = plan.unpack(pend[1], [torch.zeros(SHAPES[i]) for i in sorted(tail)])
    for j in sorted(tail):
        assert not got[0][j].any()  # the first sync applies zeros
        np.testing.assert_array_equal(got[1][j], applied[sorted(tail).index(j)].numpy())
    assert not torch.equal(pend[1], pend[2])


def _step_setup(overlap_kw, guard=False, spec=None):
    torch.manual_seed(0)
    model = build(get_config("tinyllama-1.1b").reduced(), device="cpu")
    quant = QuantConfig(num_levels=15, bits=8, bucket_size=512)
    ex = tx.make_exchange(tx.ExchangeConfig(quant=quant, mode="two_phase", **overlap_kw))
    opt_cfg = OptimizerConfig(name="qgenx", method="de", gamma_scale=0.02)
    step = make_train_step(model, opt_cfg, ex, guard=guard, fault_spec=spec)
    opt_state = port_opt.init_state(opt_cfg, model.param_leaves())
    ex_state = ex.init_state("cpu", template=model.param_leaves(), num_workers=1)
    pipe = make_pipeline(512, 4, 16, seed=0)
    return model, step, opt_state, ex_state, pipe


def test_pending_survives_checkpoint_guard_rejection_and_rollback(tmp_path):
    defer = dict(num_buckets=3, overlap="defer_tail")
    model, step, opt_state, ex_state, pipe = _step_setup(
        defer, guard=True, spec=FaultSpec.parse("nan_grad@1"))
    batch = to_device(next(pipe), "cpu")
    opt_state, ex_state, m = step(opt_state, ex_state, batch, GeneratorNoise.seeded(0, "cpu"),
                                  fault_step=0)
    assert not m["rejected"] and ex_state.pending.abs().sum() > 0
    good = ex_state.pending.clone()
    # a guard rejection: nan_grad at step 1 reaches the new pending; the
    # state handed back is the old one, bit for bit
    opt_state, ex_state, m = step(opt_state, ex_state, batch, GeneratorNoise.seeded(1, "cpu"),
                                  fault_step=1)
    assert m["rejected"] == 1.0 and ex_state.step == 2
    assert torch.equal(ex_state.pending, good)
    # the watchdog's host snapshot and rollback
    dog = Watchdog(rollback_after=1)
    dog.record_good(1, {"params": model.param_leaves(), "opt_state": opt_state,
                        "ex_state": ex_state})
    _, trees = dog.rollback("cpu")
    assert torch.equal(trees["ex_state"].pending, good)
    # a checkpoint in the reference's format
    from repro_torch.launch.train import state_trees

    checkpointing.save(str(tmp_path), 1, state_trees(model, opt_state, ex_state))
    _, back = checkpointing.restore(str(tmp_path), state_trees(model, opt_state, ex_state))
    from repro_torch.convert import ex_state_from_jax

    assert torch.equal(ex_state_from_jax(back["ex_state"], "cpu").pending, good)


# -- 6. invalid combinations ---------------------------------------------------

INVALID = {
    "buckets without overlap": dict(num_buckets=2),
    "overlap without buckets": dict(overlap="bucketed"),
    "unknown overlap": dict(num_buckets=2, overlap="async"),
    "no buckets": dict(num_buckets=0),
    "planless overlap": dict(num_buckets=2, overlap="bucketed", use_plan=False),
    "leafwise overlap": dict(num_buckets=2, overlap="defer_tail", mode="leafwise"),
    "fallback outside leafwise": dict(allreduce_fallback=True),
    "leafwise randk": dict(compressor="randk", mode="leafwise"),
    "leafwise layerwise": dict(compressor="layerwise", mode="leafwise"),
    "ef21-topk with overlap": dict(compressor="ef21-topk", num_buckets=2, overlap="bucketed"),
    "ef-randk with overlap": dict(compressor="ef-randk", num_buckets=3, overlap="defer_tail"),
    "unknown mode": dict(mode="ring"),
}


@pytest.mark.parametrize("kw", INVALID.values(), ids=INVALID.keys())
def test_invalid_combinations_raise_the_reference_message(kw):
    kw = dict(kw)
    if kw.get("compressor", "qgenx") in ("qgenx", "layerwise"):
        kw["quant"] = QuantConfig(num_levels=15, bits=8, bucket_size=64)
    with pytest.raises(ValueError) as want:
        jkw = dict(kw)
        if "quant" in jkw:
            jkw["quant"] = JaxQuant(num_levels=15, bits=8, bucket_size=64)
        jx.make_exchange(jx.ExchangeConfig(**jkw))
    with pytest.raises(ValueError) as got:
        tx.ExchangeConfig(**kw)
    assert str(got.value) == str(want.value)


def test_defer_tail_refuses_a_mask_and_a_placeholder_pending():
    cfg = _bucketed_cfg("qgenx", 2, "gather", 8, overlap="defer_tail")
    ex = tx.make_exchange(cfg)
    leaves = [torch.from_numpy(a) for a in _inputs(1, 4)[0][0]]
    with pytest.raises(ValueError, match="does not support partial-participation masks"):
        ex.pmean_tree(leaves, ex.init_state("cpu", template=leaves, num_workers=1),
                      GeneratorNoise.seeded(0, "cpu"), mask=torch.ones(()))
    with pytest.raises(ValueError, match=r"needs a pending-tail buffer of shape \[\d+\]"):
        ex.pmean_tree(leaves, ex.init_state("cpu"), GeneratorNoise.seeded(0, "cpu"))
    # bucketed (no defer) takes a mask: the tree is masked first
    ex_b = tx.make_exchange(_bucketed_cfg("qgenx", 2, "gather", 8))
    mean, _ = ex_b.pmean_tree(leaves, ex_b.init_state("cpu"), GeneratorNoise.seeded(0, "cpu"),
                              mask=torch.zeros(()))
    assert all(not m.any() for m in mean)
