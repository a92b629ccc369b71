"""Shared pieces of the tests of the exchange's layouts (the bucketed
exchange, the per-call layout, the leafwise mode): a small tree, the two
packages' configs of one case, and the reference's noise draws, in the
order the port's exchange asks for them.

Imports numpy only at module level (``jax`` inside the functions), so
the spawned gloo workers of ``_torch_exchange_worker.py`` can import the
tree and the configs too.

The reference keys its noise as follows, worker ``k`` of K:

* flat qgenx exchange of one buffer under key ``key``: ``fold_in(key,
  k)`` -> ``split`` -> the quantize draw ``[rows, bucket]`` and, under
  two_phase, the re-quantize draw ``[rows // K, bucket]``; a layerwise
  segment first folds in its ``key_tag``;
* the bucketed exchange: bucket ``bi`` takes ``fold_in(key, bi)``, the
  highest bucket first;
* the leafwise mode: ``split(fold_in(key, k), n_leaves)``, one draw of
  each leaf's shape, in leaf order.
"""

import functools
import math

import numpy as np

# leaves in JAX flatten order (sorted keys): 5 leaves, trailing dims 16,
# 31, 31 (odd: int4 travels unpacked under leafwise), 77 and 16
TREE = {"emb": (64, 16), "h0": {"b": (31,), "w": (33, 31)}, "head": (16, 77),
        "norm": (16,)}
SCALES = {"emb": 1.0, "h0/b": 0.01, "h0/w": 3.0, "head": 0.3, "norm": 10.0}
BUCKET = 64
# XLA options of the reference's compiles (as tests/test_torch_archs.py's):
# each function runs once or twice, where the optimisation passes cost
# more than they save
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jit(fn, **kw):
    """``jax.jit`` with :data:`FAST_COMPILE`."""
    import jax

    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def tree_paths():
    """``(path, shape)`` of :data:`TREE`'s leaves in JAX order."""
    out = []

    def rec(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], prefix + [k])
        else:
            out.append(("/".join(prefix), node))

    rec(TREE, [])
    return out


def tree_leaves_np(rng, K):
    """Per worker, the leaves of one tree (f32, each at its own scale)."""
    return [[(rng.randn(*shape) * SCALES[path]).astype(np.float32)
             for path, shape in tree_paths()] for _ in range(K)]


def as_tree(leaves, make=lambda a: a):
    """Leaves in JAX order -> the nested dict of :data:`TREE`."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        return make(next(it))

    return rec(TREE)


def port_config(compressor="qgenx", bits=8, mode="two_phase", q_norm=math.inf, **kw):
    """The port's exchange of a case: qgenx (or layerwise's low-bit
    quantizer) at bucket 64, s = 15 (int8) or 5 (int4)."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.quantization import QuantConfig

    quant = None
    if compressor in ("qgenx", "layerwise"):
        quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=BUCKET,
                            q_norm=q_norm)
    if compressor == "layerwise":
        kw.setdefault("layerwise_threshold", 1000)
    return ExchangeConfig(compressor=compressor, quant=quant, mode=mode, **kw)


def jax_config(port_cfg, use_pallas=False):
    """The reference's config of the same case."""
    import dataclasses

    from repro.core.exchange import ExchangeConfig
    from repro.core.quantization import QuantConfig

    def q(c):
        return None if c is None else QuantConfig(num_levels=c.num_levels, bits=c.bits,
                                                  bucket_size=c.bucket_size, q_norm=c.q_norm,
                                                  stochastic=c.stochastic)

    kw = {f.name: getattr(port_cfg, f.name) for f in dataclasses.fields(port_cfg)}
    kw["quant"], kw["quant_small"] = q(port_cfg.quant), q(port_cfg.quant_small)
    kw.pop("use_device_prng")
    return ExchangeConfig(axis_name="data", use_pallas=use_pallas, **kw)


def flat_draws(key, plan, K, worker, mode):
    """The reference's draws of one planned flat exchange (every segment in
    order; a layerwise segment folds in its key tag)."""
    import jax

    out = []
    for seg in plan.segments:
        if seg.quant is None:
            continue
        kk = key if seg.key_tag is None else jax.random.fold_in(key, seg.key_tag)
        a, b = jax.random.split(jax.random.fold_in(kk, worker))
        bucket = seg.quant.bucket_size
        rows = seg.padded // bucket
        out.append(np.asarray(jax.random.uniform(a, (rows, bucket))))
        if mode == "two_phase":
            out.append(np.asarray(jax.random.uniform(b, (rows // K, bucket))))
    return out


def bucketed_draws(jex, shapes, key, K, worker):
    """The reference's draws of one bucketed ``pmean_tree`` of a tree with
    these leaf shapes, highest bucket first."""
    import jax
    import jax.numpy as jnp

    leaves = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    buckets = jex.compressor.bucket_partition(leaves, jex.cfg)
    out = []
    for bi in range(len(buckets) - 1, -1, -1):
        plan = jex.compressor.plan_for([leaves[i] for i in buckets[bi]], jex.cfg, K, "pmean")
        out += flat_draws(jax.random.fold_in(key, bi), plan, K, worker, jex.cfg.mode)
    return out


def planned_draws(jex, shapes, key, K, worker):
    """The reference's draws of one monolithic ``pmean_tree``."""
    import jax
    import jax.numpy as jnp

    leaves = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    plan = jex.compressor.plan_for(leaves, jex.cfg, K, "pmean")
    return flat_draws(key, plan, K, worker, jex.cfg.mode)


def leafwise_draws(shapes, key, worker):
    """The reference's draws of one leafwise ``pmean_tree``."""
    return [np.asarray(d) for d in _leafwise_draw_fn(tuple(map(tuple, shapes)))(key, worker)]


@functools.lru_cache(maxsize=None)
def _leafwise_draw_fn(shapes):
    """One compiled function of (key, worker) for all leaves' draws (a draw
    at a time would compile once per leaf shape)."""
    import jax

    def draws(key, worker):
        keys = jax.random.split(jax.random.fold_in(key, worker), len(shapes))
        return [jax.random.uniform(k, s) for k, s in zip(keys, shapes)]

    return jit(draws)


def exchange_draws(jex, shapes, key, K, worker):
    """The draws of one ``pmean_tree`` of this config, whatever its layout."""
    if jex.cfg.mode == "leafwise":
        return leafwise_draws(shapes, key, worker)
    if jex.cfg.overlap != "off":
        return bucketed_draws(jex, shapes, key, K, worker)
    return planned_draws(jex, shapes, key, K, worker)


# The K = 2 train-step cases (``_torch_layouts_k2_reference.py`` and
# ``_torch_exchange_worker.run_layout_step``): qgenx ``de``, bucket 256,
# 2 steps each.  name -> (bits, mode, exchange fields)
STEP_CASES = {
    "bucketed": (8, "two_phase", dict(num_buckets=3, overlap="bucketed")),
    "leafwise": (4, "leafwise", dict()),
}
STEP_BUCKET, STEP_BATCH, STEP_SEQ, STEP_COUNT, STEP_KEY = 256, 4, 16, 2, 7


def step_params():
    """The K = 2 step cases' initial params (the reference's pytree): the
    port's init of reduced tinyllama-1.1b from seed 0 through
    ``convert.params_to_jax`` (a fraction of the reference's eager
    ``init_params``)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_to_jax
    from repro_torch.models.model import build

    return params_to_jax(build(get_config("tinyllama-1.1b").reduced(), seed=0, device="cpu"))


def step_batches():
    """The K = 2 step cases' ``(tokens, labels)`` of each step: the
    reference's synthetic stream (worker k takes rows ``2k : 2k + 2``)."""
    from repro.data.pipeline import PipelineConfig, _batch_tokens

    pc = PipelineConfig(vocab_size=512, batch=STEP_BATCH, seq_len=STEP_SEQ + 1, seed=0)
    return [(t[:, :-1], t[:, 1:]) for t in (_batch_tokens(pc, s) for s in range(STEP_COUNT))]


def step_draws(name, shapes, K):
    """Each worker's draws of a K = 2 step case, in the order its exchanges
    ask for them: per step, the step key ``fold_in(PRNGKey(STEP_KEY), t)``
    split into the two exchanges' keys, each drawn as
    :func:`exchange_draws` says."""
    import jax

    from repro.core.exchange import make_exchange

    jex = make_exchange(jax_config(step_config(name)))
    draws = [[] for _ in range(K)]
    for t in range(STEP_COUNT):
        key = jax.random.fold_in(jax.random.PRNGKey(STEP_KEY), t)
        for k in range(K):
            for ek in jax.random.split(key):
                draws[k] += exchange_draws(jex, shapes, ek, K, k)
    return draws


def step_config(name):
    """The port's exchange of a K = 2 step case."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.quantization import QuantConfig

    bits, mode, kw = STEP_CASES[name]
    quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=STEP_BUCKET)
    return ExchangeConfig(quant=quant, mode=mode, **kw)
