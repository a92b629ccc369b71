"""The sparse compressors of the port's registry (``randk``, ``ef21-topk``,
``ef-randk``) against the reference ``repro/core/exchange.py`` on the CPU.

The reference's exchange runs under ``jax.vmap(..., axis_name="data")``
over a leading worker axis: its collectives (``all_gather``, ``psum``,
``axis_index``) then run over the K mapped workers in one process, with
the per-worker keys ``fold_in(key, worker)`` it derives itself.  Every
support draw it makes (``jax.random.permutation(key, n)[:k]``) is
recomputed here and replayed into the port through ``ReplayNoise``.  The
port runs in-process at K = 1 and as K gloo workers
(``_torch_exchange_worker.run_sparse``) at K = 2 and 3.

Tolerances:

* ``pmean_tree`` over three chained calls, the error memory threaded
  through: the mean and the ``[K, n]`` memory bit for bit at K = 1 and 2.
  At K = 3 the memory bit for bit (each of its coordinates takes at most
  one add a call) and the mean within rtol 1e-6: the mean of three rows
  may sum in another order;
* ``compress_tree``, ``ef_compress`` and the top-k support: bit for bit
  (the same arithmetic on the same inputs);
* the contract properties on the port's own draws, each from a fixed
  seed (no test draws its seed at random): randk's mean over 4096 draws
  within 6 standard deviations of the estimator (plus an absolute floor
  of 1.7e-6 above the f32 rounding of the mean); top-k's
  ||C(v) - v||^2 <= (1 - k/n) ||v||^2 on every draw, summed in f64
  with a relative slack of 1e-12; rand-k's mean of ||C(v) - v||^2 within
  6 standard deviations of (1 - k/n) ||v||^2.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_exchange_worker as worker
from repro.core import exchange as jx
from repro_torch.core import exchange as tx
from repro_torch.core import noise as noise_mod
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SPARSE = ("randk", "ef21-topk", "ef-randk")
DRAWS = ("randk", "ef-randk")  # the compressors that draw a support
CALLS = 3


def _jcfg(comp, frac):
    return jx.ExchangeConfig(compressor=comp, rand_frac=frac, ef_topk_frac=frac)


def _k(comp, frac, n):
    return max(1, int(round(frac * n)))


def _trees(K, seed, calls=CALLS):
    """``calls`` trees of ``SPARSE_TREE``'s leaves, each leaf ``[K, ...]``."""
    rng = np.random.RandomState(seed)
    return [{name: rng.randn(K, *shape).astype(np.float32)
             for name, shape in worker.SPARSE_TREE.items()} for _ in range(calls)]


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).reshape(-1) for k in sorted(tree)])


def _reference_chain(comp, frac, trees, keys):
    """The reference's chained ``pmean_tree`` over K vmapped workers:
    (per-call means of worker 0, each worker's final error memory, the
    trace-time wire list)."""
    K = trees[0]["a"].shape[0]
    ex = jx.make_exchange(_jcfg(comp, frac))
    state = ex.init_state(template={k: v[0] for k, v in trees[0].items()}, num_workers=K)
    err = state.error
    means, wires = [], []
    for tree, key in zip(trees, keys):
        def one(t, e):
            m, st = ex.pmean_tree(t, dataclasses.replace(state, error=e), key)
            return m, st.error

        jx.wire_trace_start()
        mean, errs = jax.vmap(one, axis_name="data", in_axes=(0, None))(
            jax.tree_util.tree_map(jnp.asarray, tree), err)
        wires += jx.wire_trace_stop()
        errs = np.asarray(errs)
        for w in range(1, K):  # the memory stays replicated
            np.testing.assert_array_equal(errs[w], errs[0])
        err = jnp.asarray(errs[0])
        means.append(np.stack([_flat({k: np.asarray(v)[w] for k, v in mean.items()})
                               for w in range(K)]))
    return means, np.asarray(err), wires


def _supports(comp, frac, n, keys, K):
    """The reference's support draws at each call, per worker:
    ``permutation(fold_in(key, worker), n)[:k]``."""
    if comp not in DRAWS:
        return [[None] * K for _ in keys]
    k = _k(comp, frac, n)
    return [[np.asarray(jax.random.permutation(jax.random.fold_in(key, w), n)[:k])
             for w in range(K)] for key in keys]


def _compress_reference(comp, frac, tree, key):
    """The reference's per-worker ``compress_tree`` and its per-leaf draws
    (the key split once per leaf, leaves in sorted order)."""
    ex = jx.make_exchange(_jcfg(comp, frac))
    out = ex.compress_tree(jax.tree_util.tree_map(jnp.asarray, tree), key)
    draws = {}
    if comp in DRAWS:
        for name, k_leaf in zip(sorted(tree), jax.random.split(key, len(tree))):
            n = tree[name].size
            draws[name] = np.asarray(jax.random.permutation(k_leaf, n)[:_k(comp, frac, n)])
    return _flat({k: np.asarray(v) for k, v in out.items()}), draws


def test_registry_matches_reference():
    assert tx.registered_compressors() == jx.registered_compressors()
    for name in tx.registered_compressors():
        t, j = tx.get_compressor(name), jx.get_compressor(name)
        assert (t.contract, t.has_levels, t.has_error) == (j.contract, j.has_levels,
                                                          j.has_error), name
    with pytest.raises(ValueError) as want:
        jx.get_compressor("topk")
    with pytest.raises(ValueError) as got:
        tx.get_compressor("topk")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="'ef21-topk' \\(contractive\\)"):
        tx.ExchangeConfig(compressor="topk")


@pytest.mark.parametrize("comp", ["ef21-topk", "ef-randk"])
def test_contraction_alpha_matches_reference(comp):
    for n, frac in ((1000, 0.1), (7, 0.25), (2022, 1.0)):
        want = jx.get_compressor(comp).contraction_alpha(n, _jcfg(comp, frac))
        got = tx.get_compressor(comp).contraction_alpha(n, worker.sparse_config(comp, frac))
        assert got == want
    with pytest.raises(NotImplementedError):
        tx.get_compressor("randk").contraction_alpha(10, worker.sparse_config("randk", 0.5))


@pytest.mark.parametrize("comp", ["ef21-topk", "ef-randk"])
def test_contractive_compressors_cannot_recenter(comp):
    with pytest.raises(ValueError, match="recenter"):
        tx.ExchangeConfig(compressor=comp, recenter_every=2)
    assert tx.ExchangeConfig(compressor="randk", recenter_every=2).recenter_every == 2


def test_init_state_sizes_the_error_memory():
    tree = {k: torch.zeros(shape) for k, shape in worker.SPARSE_TREE.items()}
    for comp in SPARSE:
        ex = tx.make_exchange(worker.sparse_config(comp, 0.25))
        st = ex.init_state("cpu", template=tree, num_workers=3)
        want = (3, 2022) if ex.compressor.has_error else (1,)
        assert tuple(st.error.shape) == want and not st.error.any()
        assert tuple(ex.init_state("cpu").error.shape) == (1,)
        assert tuple(st.pending.shape) == (1,)


def test_contractive_exchange_refuses_a_wrong_memory():
    tree = {k: torch.ones(shape) for k, shape in worker.SPARSE_TREE.items()}
    ex = tx.make_exchange(worker.sparse_config("ef21-topk", 0.25))
    with pytest.raises(ValueError, match=r"shape \[num_workers, 2022\]"):
        ex.pmean_tree(tree, ex.init_state("cpu"), ReplayNoise([]))
    with pytest.raises(ValueError, match="initialized for 2 workers"):
        ex.pmean_tree(tree, ex.init_state("cpu", template=tree, num_workers=2), ReplayNoise([]))
    # the compressor's own pmean does not thread the memory: it refuses
    with pytest.raises(ValueError, match="through Exchange.pmean_tree"):
        ex.compressor.pmean_leaves(list(tree.values()), ex, ex.init_state("cpu"),
                                   ReplayNoise([]))


def _tied_vector(seed, n):
    """Magnitudes from a few values, both signs, and zeros (+0 and -0)."""
    rng = np.random.RandomState(seed)
    x = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0, 3.0]), size=n) * rng.choice([-1, 1], n)
    x[rng.rand(n) < 0.1] = -0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("seed,n,k", [(0, 200, 1), (1, 200, 37), (2, 200, 100),
                                      (3, 200, 163), (4, 200, 199), (5, 200, 200),
                                      (6, 5000, 1250)])
def test_topk_support_matches_lax_top_k_on_ties(seed, n, k, monkeypatch):
    x = _tied_vector(seed, n)
    want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)[1])
    monkeypatch.setattr(tx, "TOPK_TIE_CHUNK", 16)  # the tie scan crosses chunks
    got = tx.topk_support(torch.from_numpy(x), k)
    assert got.dtype == torch.int32 and got.numel() == k
    assert sorted(got.tolist()) == sorted(want.tolist())


def test_topk_support_on_distinct_and_extreme_magnitudes():
    rng = np.random.RandomState(7)
    x = (rng.randn(3000) * np.exp(rng.randn(3000) * 8)).astype(np.float32)
    x[:5] = [np.inf, -np.inf, 1e-45, -3e38, 0.0]
    for k in (1, 2, 3, 10, 1500, 2999):
        want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)[1])
        got = tx.topk_support(torch.from_numpy(x), k)
        assert sorted(got.tolist()) == sorted(want.tolist()), k


def _port_chain_single(comp, frac, trees, supports):
    """The port's chain at K = 1, in-process (``run_sparse``'s steps)."""
    ex = tx.make_exchange(worker.sparse_config(comp, frac))
    tt = [{k: torch.from_numpy(v[0]) for k, v in t.items()} for t in trees]
    state = ex.init_state("cpu", template=tt[0], num_workers=1)
    noise = ReplayNoise([s[0] for s in supports if s[0] is not None])
    tx.wire_trace_start()
    means = []
    for t in tt:
        mean, state = ex.pmean_tree(t, state, noise)
        means.append(_flat({k: v.numpy() for k, v in mean.items()}))
    wires = tx.wire_trace_stop()
    assert noise.remaining == 0 and state.step == len(trees)
    return means, state.error.numpy(), wires


@pytest.mark.parametrize("frac", [0.25, 1.0])
@pytest.mark.parametrize("comp", SPARSE)
def test_pmean_tree_matches_reference_at_one_worker(comp, frac):
    trees = _trees(1, seed=10)
    keys = [jax.random.fold_in(jax.random.PRNGKey(4), c) for c in range(CALLS)]
    want_means, want_err, want_wires = _reference_chain(comp, frac, trees, keys)
    n = sum(int(np.prod(s)) for s in worker.SPARSE_TREE.values())
    means, err, wires = _port_chain_single(comp, frac, trees, _supports(comp, frac, n, keys, 1))
    for c in range(CALLS):
        np.testing.assert_array_equal(means[c], want_means[c][0], err_msg=f"call {c}")
    np.testing.assert_array_equal(err, want_err)
    assert wires == want_wires
    assert [nb for _, nb in wires] == [4 * _k(comp, frac, n)] * (2 * CALLS)
    if frac == 1.0 and comp != "randk":  # from zero memory h' = 0 + (g - 0) = g
        np.testing.assert_array_equal(means[0], _flat({k: v[0] for k, v in trees[0].items()}))
    if frac == 1.0 and comp == "randk":  # every coordinate, n/k = 1
        for c in range(CALLS):
            np.testing.assert_array_equal(means[c], _flat({k: v[0] for k, v in trees[c].items()}))


@pytest.mark.parametrize("K", [2, 3])
def test_pmean_tree_matches_reference_over_gloo_workers(K, tmp_path):
    """Every sparse compressor, three chained calls, on K gloo workers; then
    each worker's ``compress_tree`` of its first tree."""
    n = sum(int(np.prod(s)) for s in worker.SPARSE_TREE.values())
    frac = 0.25
    inputs, wants = {}, []
    for i, comp in enumerate(SPARSE):
        trees = _trees(K, seed=20 + i)
        keys = [jax.random.fold_in(jax.random.PRNGKey(5 + i), c) for c in range(CALLS)]
        wants.append(_reference_chain(comp, frac, trees, keys))
        sups = _supports(comp, frac, n, keys, K)
        compressed = []
        for w in range(K):
            for c, tree in enumerate(trees):
                for name, v in tree.items():
                    inputs[f"{name}_{i}_{c}_{w}"] = v[w]
                if sups[c][w] is not None:
                    inputs[f"sup_{i}_{c}_{w}"] = sups[c][w]
            out, draws = _compress_reference(comp, frac, {k: v[w] for k, v in trees[0].items()},
                                             jax.random.fold_in(jax.random.PRNGKey(9), w))
            compressed.append(out)
            for name, d in draws.items():
                inputs[f"csup_{i}_{name}_{w}"] = d
        wants[-1] = wants[-1] + (compressed,)
    outs, _ = worker.run_group(K, tmp_path, inputs, [(c, frac, CALLS) for c in SPARSE],
                               target=worker.run_sparse)
    for i, comp in enumerate(SPARSE):
        want_means, want_err, want_wires, compressed = wants[i]
        for w in range(K):
            got = outs[i][w]
            for c in range(CALLS):
                if K == 2:
                    np.testing.assert_array_equal(got[f"mean_{c}"], want_means[c][w],
                                                  err_msg=f"{comp} call {c} worker {w}")
                else:
                    np.testing.assert_allclose(got[f"mean_{c}"], want_means[c][w], rtol=1e-6,
                                               atol=0, err_msg=f"{comp} call {c} worker {w}")
            np.testing.assert_array_equal(got["error"], want_err, err_msg=comp)
            np.testing.assert_array_equal(got["compressed"], compressed[w], err_msg=comp)
            assert int(got["steps"]) == CALLS
            assert list(zip(got["wire_names"], got["wire_nbytes"])) == want_wires, comp


@pytest.mark.parametrize("comp", SPARSE)
def test_compress_tree_matches_reference(comp):
    """One worker's tree, then three workers' in one call (worker by
    worker, leaf by leaf: the reference vmaps over per-worker keys)."""
    trees = _trees(3, seed=30, calls=1)[0]
    key = jax.random.PRNGKey(12)
    wkeys = jax.random.split(key, 3)
    outs, draws = zip(*(_compress_reference(comp, 0.25, {k: v[w] for k, v in trees.items()},
                                            wkeys[w]) for w in range(3)))
    ex = tx.make_exchange(worker.sparse_config(comp, 0.25))
    one = ex.compress_tree({k: torch.from_numpy(v[0]) for k, v in trees.items()},
                           ReplayNoise([draws[0][k] for k in sorted(draws[0])]))
    np.testing.assert_array_equal(_flat({k: v.numpy() for k, v in one.items()}), outs[0])
    noise = ReplayNoise([d[k] for d in draws for k in sorted(d)])
    every = ex.compress_tree({k: torch.from_numpy(v) for k, v in trees.items()}, noise,
                             workers=True)
    assert noise.remaining == 0
    for w in range(3):
        np.testing.assert_array_equal(_flat({k: v[w].numpy() for k, v in every.items()}),
                                      outs[w])


@pytest.mark.parametrize("comp", ["ef21-topk", "ef-randk"])
def test_ef_compress_matches_reference(comp):
    """The collective-free EF21 update of K = 4 rows, chained twice."""
    K, d = 4, 64
    rng = np.random.RandomState(40)
    jcomp = jx.get_compressor(comp)
    jcfg = _jcfg(comp, 0.25)
    err_j = jnp.zeros((K, d), jnp.float32)
    err_t = torch.zeros((K, d))
    ex = tx.make_exchange(worker.sparse_config(comp, 0.25))
    for call in range(2):
        v = rng.randn(K, d).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(50 + call), K)
        contrib_j, err_j = jax.vmap(lambda a, e, k: jcomp.ef_compress(a, e, jcfg, k))(
            jnp.asarray(v), err_j, keys)
        draws = [np.asarray(jax.random.permutation(k, d)[:16]) for k in keys]
        noise = ReplayNoise(draws if comp == "ef-randk" else [])
        contrib_t, err_t = ex.compressor.ef_compress(torch.from_numpy(v), err_t, ex.cfg, noise)
        assert noise.remaining == 0
        np.testing.assert_array_equal(contrib_t.numpy(), np.asarray(contrib_j))
        np.testing.assert_array_equal(err_t.numpy(), np.asarray(err_j))


@pytest.mark.parametrize("comp", SPARSE)
def test_wire_accounting_matches_reference(comp):
    tree = {k: np.zeros(s, np.float32) for k, s in worker.SPARSE_TREE.items()}
    jex = jx.make_exchange(_jcfg(comp, 0.3))
    tex = tx.make_exchange(worker.sparse_config(comp, 0.3))
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    for K in (1, 2, 8):
        assert tex.wire_bytes_tree(ttree, K) == jex.wire_bytes_tree(jtree, K) == 8 * 607
    assert tex.compress_wire_bytes_tree(ttree) == jex.compress_wire_bytes_tree(jtree)
    assert tex.compress_wire_bytes(2022) == jex.compress_wire_bytes(2022)


# -- the contracts, on the port's own draws (fixed seeds) --------------------


def test_randk_is_unbiased():
    n, k, M = 64, 16, 4096
    v = torch.from_numpy(np.random.RandomState(60).randn(n).astype(np.float32))
    ex = tx.make_exchange(worker.sparse_config("randk", k / n))
    draws = ex.compress_tree(v.expand(M, n).contiguous(), GeneratorNoise.seeded(61, "cpu"),
                             workers=True).double()
    assert int((draws != 0).sum(1).max()) == k
    sd = v.double().abs() * math.sqrt((n / k - 1) / M)
    err = (draws.mean(0) - v.double()).abs()
    assert bool((err <= 6 * sd + 1.7e-6).all()), float((err / (sd + 1e-30)).max())


def test_topk_contraction_holds_per_draw():
    ex = tx.make_exchange(worker.sparse_config("ef21-topk", 0.25))
    rng = np.random.RandomState(70)
    for n in (4, 64, 1000):
        k = max(1, round(0.25 * n))
        for _ in range(50):
            v = torch.from_numpy((rng.randn(n) * rng.choice([1e-3, 1.0, 1e3])).astype(np.float32))
            c = ex.compress_tree(v, ReplayNoise([])).double()
            assert int((c != 0).sum()) <= k
            lhs = float(((c - v.double()) ** 2).sum())
            assert lhs <= (1 - k / n) * float((v.double() ** 2).sum()) * (1 + 1e-12)
    tied = torch.from_numpy(_tied_vector(71, 400))
    c = ex.compress_tree(tied, ReplayNoise([])).double()
    assert float(((c - tied.double()) ** 2).sum()) <= 0.75 * float((tied.double() ** 2).sum())


def test_ef_randk_contraction_holds_in_expectation():
    n, k, M = 64, 16, 4096
    v = torch.from_numpy(np.random.RandomState(80).randn(n).astype(np.float32)).double()
    ex = tx.make_exchange(worker.sparse_config("ef-randk", k / n))
    draws = ex.compress_tree(v.float().expand(M, n).contiguous(),
                             GeneratorNoise.seeded(81, "cpu"), workers=True).double()
    per_draw = ((draws - v) ** 2).sum(1)
    want = (1 - k / n) * float((v ** 2).sum())
    assert float(per_draw.max()) <= float((v ** 2).sum())
    # the dropped set is a uniform (n - k)-subset: the variance of its
    # squared mass is that of sampling without replacement
    sq = v ** 2
    var = (n - k) * k / (n - 1) * float(sq.var(unbiased=False))
    assert abs(float(per_draw.mean()) - want) <= 6 * math.sqrt(var / M)


# -- the support draw ------------------------------------------------------


def test_generator_subset_is_a_uniform_subset(monkeypatch):
    g = GeneratorNoise.seeded(90, "cpu")
    idx = g.subset(1000, 250, "cpu")
    assert idx.dtype == torch.int32 and idx.shape == (250,)
    assert len(set(idx.tolist())) == 250 and 0 <= int(idx.min()) and int(idx.max()) < 1000
    # above the block size the draw splits range(n) by hypergeometric counts
    monkeypatch.setattr(noise_mod, "SUBSET_BLOCK", 64)
    n, k, M = 1000, 300, 400
    hits = torch.zeros(n)
    for _ in range(M):
        idx = g.subset(n, k, "cpu")
        assert len(set(idx.tolist())) == k and 0 <= int(idx.min()) and int(idx.max()) < n
        hits[idx.long()] += 1
    p = k / n
    sd = math.sqrt(M * p * (1 - p))
    assert float((hits - M * p).abs().max()) <= 6 * sd
    # the full set, block by block
    assert sorted(g.subset(n, n, "cpu").tolist()) == list(range(n))


def test_replay_subset_checks_its_draw():
    with pytest.raises(ValueError, match="shape"):
        ReplayNoise([np.arange(4)]).subset(10, 5, "cpu")
    with pytest.raises(TypeError, match="dtype"):
        ReplayNoise([np.zeros(5, np.float32)]).subset(10, 5, "cpu")
    with pytest.raises(ValueError, match="range"):
        ReplayNoise([np.arange(5) + 6]).subset(10, 5, "cpu")
    with pytest.raises(TypeError, match="seed"):
        ReplayNoise([3]).subset(10, 1, "cpu")
    with pytest.raises(ValueError, match="0 < k <= n"):
        GeneratorNoise.seeded(0, "cpu").subset(10, 11, "cpu")
    got = ReplayNoise([np.array([7, 2], np.int64)]).subset(10, 2, "cpu")
    assert got.dtype == torch.int32 and got.tolist() == [7, 2]
