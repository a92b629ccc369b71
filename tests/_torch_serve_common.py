"""Shared helpers of the serving-path parity tests (``test_torch_serve_*``):
the reduced tinyllama-1.1b reference params, the port model built from
them, and noise sources that recompute the reference's ``jax.random``
draws for the port's cache writers and logit exchange."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.noise import ReplayNoise
from repro_torch.models.model import build

#: the reference engine's retry / exchange salts (repro/serve/engine.py)
RETRY_SALT, RETRY_EX_SALT, STEP_SALT = 0x9E77, 0x0A11, 0x5E4E


@functools.lru_cache(maxsize=None)
def reference_params(seed: int = 1):
    """Reduced tinyllama (2 layers, d_model 256, 4 heads / 2 kv heads, vocab
    512, f32) and its reference params as numpy."""
    cfg = jax_get_config("tinyllama-1.1b").reduced()
    params = JT.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def port_model(params_np):
    model = params_from_jax(params_np, build(get_config("tinyllama-1.1b").reduced(),
                                             device="cpu"))
    for p in model.parameters():
        p.requires_grad_(False)
    return model


class _Draws:
    """Cache noise over a precomputed [L, 2, ...] block."""

    def __init__(self, block):
        self.block = np.asarray(block)

    def draw(self, l, tag, shape, device):
        a = self.block[l, tag]
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.array(a)).to(device)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _decode_block(keys, pos, L, F, ix):
    wk = jax.vmap(jax.random.fold_in)(keys, pos)
    if ix >= 0:
        wk = jax.vmap(jax.random.fold_in, (0, None))(wk, ix)
    return jnp.stack([jnp.stack([
        jax.vmap(lambda k: jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(k, l), tag), (F,)))(wk)
        for tag in (0, 1)]) for l in range(L)])


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _prefill_block(key, S, L, F, ix):
    if ix >= 0:
        key = jax.random.fold_in(key, ix)
    return jnp.stack([jnp.stack([
        jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, l), tag), (S, F))[None]
        for tag in (0, 1)]) for l in range(L)])


class JaxCacheNoise:
    """The reference engine's cache draws, recomputed: request key
    ``fold_in(PRNGKey(seed), rid)`` (a retry re-salted with
    ``RETRY_SALT + attempt``), then the position (decode), the device index
    ``ix`` (ensemble mode; -1 = none), the layer and the K/V tag."""

    def __init__(self, seed, num_layers, feat_pad, ix=-1):
        self.root = jax.random.PRNGKey(seed)
        self.L, self.F, self.ix = num_layers, feat_pad, ix

    def key(self, rid, attempt=0):
        k = jax.random.fold_in(self.root, rid)
        return jax.random.fold_in(k, RETRY_SALT + attempt) if attempt else k

    def prefill(self, rid, length):
        return _Draws(_prefill_block(self.key(rid), length, self.L, self.F, self.ix))

    def decode(self, rows):
        zero = jnp.zeros_like(self.root)
        keys = jnp.stack([zero if r is None else self.key(r[0], r[1]) for r in rows])
        pos = jnp.asarray([0 if r is None else r[2] for r in rows], jnp.int32)
        return _Draws(_decode_block(keys, pos, self.L, self.F, self.ix))


def jax_exchange_noise(seed, rows, bucket, K=1, ix=0):
    """``exchange_noise(step, attempt)`` replaying the reference engine's
    two_phase logit exchange: step key ``fold_in(root, 0x5e4e + step)``
    (a retry folds ``0x0a11 + attempt``), the device index, then split ->
    the quantize draw [rows, bucket] and the re-quantize draw [rows / K,
    bucket]."""
    root = jax.random.PRNGKey(seed)

    def noise(step, attempt):
        key = jax.random.fold_in(root, STEP_SALT + step)
        if attempt:
            key = jax.random.fold_in(key, RETRY_EX_SALT + attempt)
        k1, k2 = jax.random.split(jax.random.fold_in(key, ix))
        return ReplayNoise([np.asarray(jax.random.uniform(k1, (rows, bucket))),
                            np.asarray(jax.random.uniform(k2, (rows // K, bucket)))])

    return noise
