"""The device-PRNG exchange (``ExchangeConfig(use_device_prng=True)``, the
port of TPU kernel B5) on the CPU.

The reference cannot run this path on the CPU: ``pltpu.prng_seed`` has no
interpret-mode lowering, so ``tests/test_kernels.py`` only traces it with
``jax.eval_shape``.  The port's draw is Philox4x32-10, not the TPU's bits,
so the contract is exact where the port can be exact and statistical,
against the reference's own bounds, where it cannot:

* ``philox_uniform`` gives Random123's Philox4x32-10 known-answer
  vectors; its draws depend only on (seed, row, column) and lie on the
  reference's 24-bit grid; a histogram of them is uniform and neighbouring
  streams are uncorrelated;
* every path with the flag gives, bit for bit, what the host-noise path
  gives when fed ``philox_uniform``'s draws of the same seeds: the three
  kernel wrappers, ``qgenx_pmean`` (K = 1 here, K = 2 over gloo) and
  ``compress_tree`` / ``fused_compress`` with W = 3 workers stacked;
* over a fixed set of seeds, E[DEQ(Q(x))] = x within 5 sigma / sqrt(n)
  plus an absolute floor of 2e-6 (f32 rounding alone reaches 1.7e-6,
  ROADMAP C4), and E||DEQ(Q(x)) - x||^2 <= eps_Q ||x||^2 with eps_Q from
  the reference's ``theorem1_epsilon_q``;
* the outputs have the shapes and dtypes that ``jax.eval_shape`` gives
  for the reference's device-PRNG kernels;
* the LM and GAN steps with the flag ask their noise source only for
  seeds, and bill the same wire bytes as without it.

Every draw comes from a fixed seed, so no test here can come out
differently from one run to the next.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core.quantization import theorem1_epsilon_q
from repro.kernels.dequant_reduce import dequant_reduce_requantize_blocks as jax_b2
from repro.kernels.quantize import quantize_blocks as jax_b1
from repro.kernels.segment_quantize import quantize_dequantize_segments as jax_b6
from repro_torch.configs import get_config
from repro_torch.core.exchange import ExchangeConfig, SingleWorker, make_exchange, qgenx_pmean
from repro_torch.core.exchange_plan import stack_level_tables
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from repro_torch.core.quantization import QuantConfig, uniform_levels
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.gan import wgan
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.dequant_reduce import dequant_reduce_requantize_blocks
from repro_torch.kernels.dequantize import dequantize_blocks
from repro_torch.kernels.ops import dequantize_flat, quantize_flat
from repro_torch.kernels.prng import philox_words
from repro_torch.kernels.quantize import quantize_blocks
from repro_torch.kernels.ref import philox_uniform
from repro_torch.kernels.segment_quantize import quantize_dequantize_segments
from repro_torch.launch import train_gan
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import optimizers as opt

import _torch_exchange_worker
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# Random123's kat_vectors, "philox4x32 10": counter, key -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


class SeedsOnly:
    """A noise source that hands out seeds from a generator and records
    them; asking it for a noise array fails the test."""

    def __init__(self, run_seed):
        self.source = GeneratorNoise.seeded(run_seed, "cpu")
        self.seeds = []

    def seed(self):
        self.seeds.append(self.source.seed())
        return self.seeds[-1]

    def uniform(self, shape, device):
        raise AssertionError(f"a [{shape}] noise array was asked for with the device PRNG")

    normal = uniform


def _corr(a, b):
    return float(np.corrcoef(a.reshape(-1).numpy(), b.reshape(-1).numpy())[0, 1])


# -- the draw -----------------------------------------------------------------


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answer_vectors(ctr, key, want):
    got = philox_words(torch.tensor([ctr], dtype=torch.int64),
                       torch.tensor([key], dtype=torch.int64))
    assert [int(w) for w in got[0]] == list(want)


def test_draws_depend_only_on_seed_row_and_column():
    seed = 0xDEADBEEF12345678
    full = philox_uniform(seed, 0, 64, 512, "cpu")
    assert torch.equal(philox_uniform(seed, 10, 20, 512, "cpu"), full[10:30])
    assert torch.equal(philox_uniform(seed, 0, 64, 130, "cpu"), full[:, :130])
    # coordinate (row, col) is word col % 4 of Philox at counter (row, col // 4, 0, 0)
    row, col = 37, 201
    w = philox_words(torch.tensor([[row, col // 4, 0, 0]]),
                     torch.tensor([[seed & 0xFFFFFFFF, seed >> 32]]))[0, col % 4]
    assert float(full[row, col]) == float(int(w) >> 8) * 2.0**-24
    # the last rows a 32-bit counter holds, and no further
    assert philox_uniform(seed, (1 << 32) - 2, 2, 8, "cpu").shape == (2, 8)
    with pytest.raises(ValueError, match="32-bit"):
        philox_uniform(seed, (1 << 32) - 1, 2, 8, "cpu")
    with pytest.raises(ValueError, match="64-bit"):
        philox_uniform(1 << 64, 0, 2, 8, "cpu")


def test_draws_lie_on_the_24_bit_grid():
    u = philox_uniform(7, 0, 256, 512, "cpu").double()
    k = u * 2.0**24
    assert torch.equal(k, k.floor())
    assert float(k.min()) >= 0 and float(k.max()) < 2**24


def test_draws_are_uniform():
    u = philox_uniform(2024, 0, 2048, 512, "cpu")  # 2^20 draws
    counts = torch.histc(u, bins=256, min=0.0, max=1.0).numpy()
    assert counts.sum() == u.numel()
    expected = u.numel() / 256
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert stats.chi2.sf(chi2, 255) > 1e-4, chi2


def _exchange_seeds():
    """The two seeds one two_phase exchange asks for (quantize, re-quantize)."""
    noise = SeedsOnly(11)
    qgenx_pmean(torch.randn(4096), SingleWorker(), uniform_levels(15, "cpu"), noise,
                QuantConfig(num_levels=15, bits=8, bucket_size=512), "two_phase",
                use_device_prng=True)
    assert len(noise.seeds) == 2 and noise.seeds[0] != noise.seeds[1]
    return noise.seeds


@pytest.mark.parametrize("pair", ["adjacent rows", "adjacent seeds", "one exchange's two draws",
                                  "two workers"])
def test_streams_are_uncorrelated(pair):
    rows, bucket = 512, 512  # n = 2^18 coordinates per stream
    if pair == "adjacent rows":
        both = philox_uniform(5, 0, 2 * rows, bucket, "cpu")
        a, b = both[0::2], both[1::2]
    else:
        if pair == "adjacent seeds":
            s1, s2 = 5, 6
        elif pair == "one exchange's two draws":
            s1, s2 = _exchange_seeds()
        else:  # the train CLI seeds worker `rank` with (seed << 16) + rank
            s1, s2 = (GeneratorNoise.seeded((3 << 16) + rank, "cpu").seed() for rank in (0, 1))
        a = philox_uniform(s1, 0, rows, bucket, "cpu")
        b = philox_uniform(s2, 0, rows, bucket, "cpu")
    assert abs(_corr(a, b)) < 5 / math.sqrt(a.numel())


# -- the noise sources ---------------------------------------------------------


def test_noise_sources_give_seeds():
    g = GeneratorNoise.seeded(3, "cpu")
    h = GeneratorNoise.seeded(3, "cpu")
    seeds = [g.seed() for _ in range(4)]
    assert seeds == [h.seed() for _ in range(4)]
    assert len(set(seeds)) == 4 and all(0 <= s < 1 << 64 for s in seeds)
    # the seed stream is the source's own: asking for seeds moves no noise draw
    assert torch.equal(g.uniform((3, 4), "cpu"), h.uniform((3, 4), "cpu"))
    replay = ReplayNoise([5, np.zeros((2, 4), np.float32), np.uint64(2**63 + 1)])
    assert replay.seed() == 5
    with pytest.raises(TypeError, match="seed"):
        replay.seed()  # the next item is an array
    assert replay.uniform((2, 4), "cpu").shape == (2, 4)
    with pytest.raises(TypeError, match="array"):
        replay.uniform((2, 4), "cpu")  # the next item is a seed
    assert replay.seed() == 2**63 + 1
    with pytest.raises(RuntimeError, match="exhausted"):
        replay.seed()


# -- the kernels' device-PRNG variants, their plain versions -------------------


def test_wrappers_take_exactly_one_noise_source():
    lv = uniform_levels(15, "cpu")
    x = torch.randn(3, 8)
    kw = dict(num_symbols=17, q_is_inf=True)
    with pytest.raises(ValueError, match="exactly one"):
        quantize_blocks(x, None, lv, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        quantize_blocks(x, torch.rand(3, 8), lv, seed=1, **kw)
    with pytest.raises(ValueError, match="64-bit"):
        quantize_blocks(x, None, lv, seed=-1, **kw)
    idx, norms = torch.zeros((1, 3, 8), dtype=torch.int8), torch.ones((1, 3))
    with pytest.raises(ValueError, match="exactly one"):
        dequant_reduce_requantize_blocks(idx, norms, lv, None, num_workers=1, **kw)
    tables, ns = stack_level_tables([lv])
    seg = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one"):
        quantize_dequantize_segments(x, torch.rand(3, 8), tables, seg, num_symbols=ns,
                                     q_is_inf=True, seed=2)
    # nearest rounding reads neither
    assert quantize_dequantize_segments(x, None, tables, seg, num_symbols=ns, q_is_inf=True,
                                        stochastic=False).shape == (3, 8)


@pytest.mark.parametrize("q_is_inf", [True, False])
@pytest.mark.parametrize("bits,bucket", [(8, 512), (4, 512), (8, 130), (4, 130), (8, 37)])
def test_kernel_wrappers_with_a_seed_equal_the_host_noise_path(bits, bucket, q_is_inf):
    """B1, B2 and B6 given a seed equal themselves given philox_uniform's
    draw of it: payload, norms, estimates bit for bit; launches nothing."""
    cuda.reset_launch_counts()
    s = 15 if bits == 8 else 5
    lv = uniform_levels(s, "cpu")
    rng = np.random.RandomState(bucket + bits)
    nb, seed = 19, 0xABCDEF0123456789
    x = torch.from_numpy((rng.randn(nb, bucket) * 3).astype(np.float32))
    x[4] = 0
    r = philox_uniform(seed, 0, nb, bucket, "cpu")
    kw = dict(num_symbols=s + 2, q_is_inf=q_is_inf, bits=bits)
    p1, n1 = quantize_blocks(x, None, lv, seed=seed, **kw)
    p0, n0 = quantize_blocks(x, r, lv, **kw)
    assert torch.equal(p1, p0) and torch.equal(n1, n0)
    P, N = torch.stack([p0, p0.flip(0)]), torch.stack([n0, n0.flip(0)])
    q1, m1 = dequant_reduce_requantize_blocks(P, N, lv, None, num_workers=2, seed=seed, **kw)
    q0, m0 = dequant_reduce_requantize_blocks(P, N, lv, r, num_workers=2, **kw)
    assert torch.equal(q1, q0) and torch.equal(m1, m0)
    tables, ns = stack_level_tables([lv, uniform_levels(5, "cpu")])
    seg = torch.from_numpy(rng.randint(0, 2, nb).astype(np.int32))
    kw6 = dict(num_symbols=ns, q_is_inf=q_is_inf)
    assert torch.equal(quantize_dequantize_segments(x, None, tables, seg, seed=seed, **kw6),
                       quantize_dequantize_segments(x, r, tables, seg, **kw6))
    assert not any(cuda.launch_counts().values())


@pytest.mark.parametrize("bits", [8, 4])
def test_flat_wrapper_asks_for_one_seed(bits):
    cfg = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=256)
    lv = uniform_levels(cfg.num_levels, "cpu")
    v = torch.randn(1000)
    qt = quantize_flat(v, lv, ReplayNoise([42]), cfg, use_device_prng=True)
    want = quantize_flat(v, lv, ReplayNoise([philox_uniform(42, 0, 4, 256, "cpu")]), cfg)
    assert torch.equal(qt.payload, want.payload) and torch.equal(qt.norms, want.norms)
    assert dequantize_flat(qt, lv, cfg).shape == (1000,)


def test_shapes_match_the_reference_device_prng_kernels():
    """The reference's device-PRNG kernels only trace on the CPU: their
    eval_shape is the contract the port's outputs are held to."""
    nb, bucket, K = 9, 256, 2
    seed = jnp.zeros((1,), jnp.int32)
    x = jax.ShapeDtypeStruct((nb, bucket), jnp.float32)
    tx = torch.randn(nb, bucket)
    for bits, s in ((8, 15), (4, 5)):
        levels = jnp.linspace(0.0, 1.0, s + 2)
        lv = uniform_levels(s, "cpu")
        p = bucket if bits == 8 else bucket // 2
        want = jax.eval_shape(lambda a, sd: jax_b1(a, None, levels, num_symbols=s + 2,
                                                   q_is_inf=True, bits=bits,
                                                   use_device_prng=True, seed=sd), x, seed)
        got = quantize_blocks(tx, None, lv, num_symbols=s + 2, q_is_inf=True, bits=bits,
                              seed=3)
        assert [(tuple(g.shape), str(g.dtype)) for g in got] == \
            [((nb, p), "torch.int8"), ((nb,), "torch.float32")]
        assert [(w.shape, str(w.dtype)) for w in want] == [((nb, p), "int8"),
                                                           ((nb,), "float32")]
        idx = jax.ShapeDtypeStruct((K, nb, p), jnp.int8)
        norms = jax.ShapeDtypeStruct((K, nb), jnp.float32)
        want = jax.eval_shape(lambda i, n, sd: jax_b2(
            i, n, levels, None, num_symbols=s + 2, num_workers=K, q_is_inf=True, bits=bits,
            use_device_prng=True, seed=sd), idx, norms, seed)
        got = dequant_reduce_requantize_blocks(
            torch.stack([got[0]] * K), torch.stack([got[1]] * K), lv, None,
            num_symbols=s + 2, num_workers=K, q_is_inf=True, bits=bits, seed=4)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        assert [str(g.dtype).removeprefix("torch.") for g in got] == \
            [str(w.dtype) for w in want]
    tables, ns = stack_level_tables([uniform_levels(15, "cpu"), uniform_levels(5, "cpu")])
    seg = jax.ShapeDtypeStruct((nb,), jnp.int32)
    want = jax.eval_shape(lambda a, sg, sd: jax_b6(
        a, None, jnp.asarray(tables.numpy()), sg, num_symbols=ns, q_is_inf=True,
        use_device_prng=True, seed=sd), x, seg, seed)
    got = quantize_dequantize_segments(tx, None, tables, torch.zeros(nb, dtype=torch.int32),
                                       num_symbols=ns, q_is_inf=True, seed=5)
    assert tuple(got.shape) == want.shape and str(want.dtype) == "float32"
    assert got.dtype == torch.float32


# -- the exchange ----------------------------------------------------------------

N, BUCKET = 5000, 256
CASES = [("two_phase", 8, math.inf, BUCKET), ("two_phase", 4, 2.0, BUCKET),
         ("gather", 8, 2.0, BUCKET), ("gather", 4, math.inf, BUCKET)]


def _rows(mode, K, bucket=BUCKET):
    quota = bucket if mode == "gather" else K * bucket
    return -(-N // quota) * quota // bucket


def _host_draws(mode, K, seeds):
    """The host-noise path's draws that equal the device PRNG's draws of
    ``seeds`` (the quantize seed, and in two_phase the re-quantize one)."""
    rows = _rows(mode, K)
    draws = [philox_uniform(seeds[0], 0, rows, BUCKET, "cpu")]
    if mode == "two_phase":
        draws.append(philox_uniform(seeds[1], 0, rows // K, BUCKET, "cpu"))
    return draws


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-int{c[1]}" for c in CASES])
def test_pmean_with_device_prng_equals_host_noise_one_worker(case):
    mode, bits, q_norm, bucket = case
    s = 15 if bits == 8 else 5
    cfg = QuantConfig(num_levels=s, bits=bits, bucket_size=bucket, q_norm=q_norm)
    x = torch.from_numpy((np.random.RandomState(bits).randn(N) * 2).astype(np.float32))
    lv = uniform_levels(s, "cpu")
    noise = SeedsOnly(bits)
    got = qgenx_pmean(x, SingleWorker(), lv, noise, cfg, mode, use_device_prng=True)
    assert len(noise.seeds) == (2 if mode == "two_phase" else 1)
    host = ReplayNoise(_host_draws(mode, 1, noise.seeds))
    want = qgenx_pmean(x, SingleWorker(), lv, host, cfg, mode)
    assert host.remaining == 0
    assert torch.equal(got, want)


def test_pmean_with_device_prng_equals_host_noise_gloo_workers(tmp_path):
    """K = 2 over gloo: cases 0-3 run with seeds, cases 4-7 are the same
    cases on the host-noise path fed philox_uniform's draws of the seeds."""
    K = 2
    rng = np.random.RandomState(21)
    inputs = {}
    for i, (mode, _, _, _) in enumerate(CASES):
        for k in range(K):
            x = (rng.randn(N) * np.linspace(0.1, 3, N)).astype(np.float32)
            s1, s2 = (int(v) for v in rng.randint(0, 2**62, 2, dtype=np.int64))
            inputs[f"x_{i}_{k}"] = inputs[f"x_{i + 4}_{k}"] = x
            inputs[f"s1_{i}_{k}"], inputs[f"s2_{i}_{k}"] = np.uint64(s1), np.uint64(s2)
            draws = _host_draws(mode, K, (s1, s2))
            inputs[f"n1_{i + 4}_{k}"] = draws[0].numpy()
            inputs[f"n2_{i + 4}_{k}"] = draws[-1].numpy()
    outs, _ = _torch_exchange_worker.run_group(K, tmp_path, inputs, CASES + CASES)
    for i in range(len(CASES)):
        for k in range(K):
            np.testing.assert_array_equal(outs[i][k], outs[i + 4][k], err_msg=f"{CASES[i]}")
            np.testing.assert_array_equal(outs[i][k], outs[i][0])  # replicated


def _gan_grads(W, seed=0):
    """A [W, ...] stack of GAN-shaped dual vectors (the testbed's tree)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = wgan.WGAN(wgan.GANConfig(), gen, "cpu").param_tree()
    return tree_map(lambda p: torch.randn((W, *p.shape), generator=gen), params)


@pytest.mark.parametrize("arm", ["uq8", "uq4", "layerwise"])
def test_compress_tree_with_device_prng_equals_host_noise(arm):
    """W = 3 workers' buffers in one launch share one seed: worker w's rows
    draw philox_uniform(seed, w * rows, rows, bucket)."""
    W = 3
    grads = _gan_grads(W)
    cfg = train_gan.arm_exchange(arm)
    ex_prng = make_exchange(dataclasses.replace(cfg, use_device_prng=True))
    noise = SeedsOnly(5)
    got = ex_prng.compress_tree(grads, noise, workers=True)
    assert len(noise.seeds) == 1  # one row geometry: one launch, one seed
    ex = make_exchange(cfg)
    leaves = [l[0] for l in tree_flatten(grads)[0]]
    rows = ex.plan_for(leaves, "compress", 1).total // 512
    host = ReplayNoise([philox_uniform(noise.seeds[0], w * rows, rows, 512, "cpu")
                        for w in range(W)])
    want = ex.compress_tree(grads, host, workers=True)
    assert host.remaining == 0
    for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert torch.equal(g, w)


# -- unbiasedness and Theorem 1 ------------------------------------------------

SEEDS = range(256)


def _estimates(x, bits, q_norm, kernel):
    """DEQ(Q(x)) for every seed in SEEDS: through kernels 1 and 3, or 5."""
    s = 15 if bits == 8 else 5
    lv = uniform_levels(s, "cpu")
    q_is_inf = math.isinf(q_norm)
    out = []
    for seed in SEEDS:
        if kernel == "B1":
            p, n = quantize_blocks(x, None, lv, num_symbols=s + 2, q_is_inf=q_is_inf,
                                   bits=bits, seed=seed)
            out.append(dequantize_blocks(p, n, lv, num_symbols=s + 2, bits=bits))
        else:
            tables, ns = stack_level_tables([lv])
            out.append(quantize_dequantize_segments(
                x, None, tables, torch.zeros(x.shape[0], dtype=torch.int32),
                num_symbols=ns, q_is_inf=q_is_inf, seed=seed))
    return torch.stack(out).double(), lv


@pytest.mark.parametrize("kernel", ["B1", "B6"])
@pytest.mark.parametrize("bits,q_norm", [(8, math.inf), (4, 2.0)])
def test_device_prng_rounding_is_unbiased_within_theorem_1(bits, q_norm, kernel):
    rng = np.random.RandomState(bits)
    x = torch.from_numpy((rng.randn(4, 512) * rng.uniform(0.1, 3.0, (4, 1))).astype(np.float32))
    est, lv = _estimates(x, bits, q_norm, kernel)
    # each coordinate rounds to lo or hi (times the norm) with P(hi) = xi:
    # its exact standard deviation (a sample's would read 0 for a small xi
    # that no draw of SEEDS rounds up)
    xd, lvd = x.double(), lv.double()
    norms = ref.norm_rows(xd, math.isinf(q_norm))[:, None]
    u = (xd.abs() / norms).clamp(0, 1)
    tau = (u[..., None] >= lvd[1:-1]).sum(-1)
    lo, hi = lvd[tau], lvd[tau + 1]
    xi = (u - lo) / (hi - lo)
    sigma = (hi - lo) * norms * (xi * (1 - xi)).sqrt()
    gap = (est.mean(0) - xd).abs()
    assert bool((gap <= 5 * sigma / math.sqrt(est.shape[0]) + 2e-6).all()), float(gap.max())
    eps_q = theorem1_epsilon_q(lv.numpy(), 512, q_norm)
    emp = ((est - x.double()) ** 2).sum(-1).mean(0) / (x.double() ** 2).sum(-1)
    assert bool((emp <= eps_q).all()), (emp, eps_q)


# -- the steps -----------------------------------------------------------------


@pytest.mark.parametrize("mode,bits", [("two_phase", 8), ("gather", 4)])
def test_lm_step_with_device_prng_asks_only_for_seeds(mode, bits):
    cfg = get_config("tinyllama-1.1b").reduced()
    quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=512)
    opt_cfg = opt.OptimizerConfig(name="qgenx", gamma_scale=0.02, method="de")
    gen = torch.Generator()
    gen.manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    metrics = []
    for flag in (True, False):
        model = build(cfg, seed=0, device="cpu")
        ex = make_exchange(ExchangeConfig(quant=quant, mode=mode, use_device_prng=flag))
        step = make_train_step(model, opt_cfg, ex)
        state = opt.init_state(opt_cfg, model.param_leaves())
        noise = SeedsOnly(1) if flag else GeneratorNoise.seeded(1, "cpu")
        _, ex_state, m = step(state, ex.init_state("cpu"), batch, noise)
        metrics.append(m)
        if flag:  # de: two exchanges, one seed per draw
            assert len(noise.seeds) == 2 * (2 if mode == "two_phase" else 1)
    assert all(math.isfinite(float(m["loss"])) for m in metrics)
    assert metrics[0]["wire_bytes"] == metrics[1]["wire_bytes"] > 0


def test_gan_step_with_device_prng_asks_only_for_seeds():
    cfg = wgan.GANConfig(exchange=dataclasses.replace(train_gan.arm_exchange("uq8"),
                                                      use_device_prng=True))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tree_map(lambda p: p.detach(), wgan.WGAN(cfg, gen, "cpu").param_tree())
    opt_cfg = opt.OptimizerConfig(name="extra_adam", lr=cfg.lr, grad_clip=0.0)
    state = opt.init_state(opt_cfg, params)
    step = wgan.make_step(cfg, opt_cfg)
    noise = SeedsOnly(2)
    real = wgan.eight_gaussians(gen, cfg.num_workers * cfg.batch_per_worker, "cpu")
    params, state = step(params, state, real.reshape(cfg.num_workers, -1, 2),
                         GeneratorNoise(gen), noise)
    assert len(noise.seeds) == 2  # two exchanges, one launch each
    assert all(bool(torch.isfinite(l).all()) for l in tree_flatten(params)[0])
    base = wgan.grad_bytes(params, wgan.GANConfig(exchange=train_gan.arm_exchange("uq8"))
                           .make_exchange())
    assert wgan.grad_bytes(params, cfg.make_exchange()) == base
    assert math.isfinite(wgan.energy_distance(params, cfg, n=256, generator=gen))
