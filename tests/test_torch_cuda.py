"""The CUDA exchange kernels against their plain versions on the card,
and the multi-worker exchange over NCCL against gloo.

These tests need CUDA GPUs and nvcc; where there are none they skip with a
reason (``pytest -m gpu tests/test_torch_cuda.py`` runs them on the card;
``python3 chip_smoke.py`` runs the same comparison and more).  The
extension is built lazily, inside the tests.  Indices and packed bytes
must be equal (q = inf), f32 outputs within rtol 1e-6, NaN in the same
places.
"""

import pytest
import torch

from repro_torch.core.quantization import uniform_levels
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.dequant_reduce import (
    dequant_reduce_blocks,
    dequant_reduce_requantize_blocks,
)
from repro_torch.kernels.dequantize import dequantize_blocks
from repro_torch.kernels.quantize import quantize_blocks
from repro_torch.kernels.segment_quantize import quantize_dequantize_segments

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def same(a, b):
    """Bit-equal, NaN equal to NaN in the same places."""
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
    return torch.equal(a, b)


def close(a, b):
    """NaN in the same places, the rest within rtol 1e-6."""
    return torch.equal(a.isnan(), b.isnan()) and torch.allclose(
        a.nan_to_num(), b.nan_to_num(), rtol=1e-6, atol=0)


def rows_for(rows, dev):
    """37, or ``"wrap"``: more rows than warps the card holds at once (one
    row per warp in kernels 1 and 2, 64 warps per SM), so their grid-stride
    loop wraps, and not a multiple of a block's 8 rows."""
    if rows != "wrap":
        return rows
    return torch.cuda.get_device_properties(dev).multi_processor_count * 64 + 37


# buckets 2 (VEC 2), 512 (one warp's registers), 1024 (QuantConfig's
# default), 4096 (wider than the registers: the second pass)
SHAPES = [(37, 512), (37, 2), (37, 1024), (37, 4096), ("wrap", 512)]


@pytest.mark.parametrize("rows,bucket", SHAPES)
@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("bits", [8, 4])
def test_kernels_match_plain_versions(dev, bits, K, rows, bucket):
    """Kernels 1-4 against their plain versions with an all-zero row and a
    NaN row (kernels 2-4 get the NaN row's norm from every worker)."""
    s = 15 if bits == 8 else 5
    lv = uniform_levels(s, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(bits * 10 + K)
    nb = rows_for(rows, dev)
    x = torch.randn((nb, bucket), generator=gen, device=dev)
    x[5] = 0
    x[6, bucket // 2] = float("nan")
    r = torch.rand((nb, bucket), generator=gen, device=dev)
    before = cuda.launch_counts()
    pk, nk = quantize_blocks(x, r, lv, num_symbols=s + 2, q_is_inf=True, bits=bits)
    pp, np_ = ref.quantize_blocks_plain(x, r, lv, num_symbols=s + 2, q_is_inf=True, bits=bits)
    assert torch.equal(pk, pp) and same(nk, np_) and bool(nk[6].isnan())
    assert close(dequantize_blocks(pk, nk, lv, num_symbols=s + 2, bits=bits),
                 ref.dequantize_blocks_plain(pk, nk, lv, bits=bits))
    P = torch.stack([pk] * K)
    N = torch.stack([nk] * K)
    assert close(dequant_reduce_blocks(P, N, lv, num_symbols=s + 2, num_workers=K, bits=bits),
                 ref.dequant_reduce_blocks_plain(P, N, lv, bits=bits))
    ok, onk = dequant_reduce_requantize_blocks(P, N, lv, r, num_symbols=s + 2, num_workers=K,
                                               q_is_inf=True, bits=bits)
    op, onp = ref.dequant_reduce_requantize_blocks_plain(P, N, lv, r, num_symbols=s + 2,
                                                         q_is_inf=True, bits=bits)
    assert torch.equal(ok, op) and same(onk, onp) and bool(onk[6].isnan())
    after = cuda.launch_counts()
    assert all(after[k] - before[k] == 1 for k in ("quantize_blocks", "dequantize_blocks",
                                                   "dequant_reduce_blocks",
                                                   "dequant_reduce_requantize_blocks"))


@pytest.mark.parametrize("q_is_inf", [True, False])
@pytest.mark.parametrize("s,bits", [(15, 8), (30, 8), (5, 4)])
def test_quantize_kernels_with_exponential_levels(dev, s, bits, q_is_inf):
    """Kernels 1 and 2 on exponential level tables against their plain
    versions: s = 15 and 30 put two levels in one cell of [0, 1], so the
    bracket comes from the binary search; s = 5 from the cell table."""
    from repro_torch.core.quantization import exponential_levels

    lv = exponential_levels(s, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(s + bits + q_is_inf)
    nb, bucket = 37, 512
    x = torch.randn((nb, bucket), generator=gen, device=dev) * torch.exp2(
        torch.randint(-24, 1, (nb, bucket), generator=gen, device=dev).float())
    x[5] = 0
    r = torch.rand((nb, bucket), generator=gen, device=dev)
    kw = dict(num_symbols=s + 2, q_is_inf=q_is_inf, bits=bits)

    def held(got, want):
        """q = inf: bytes and norms equal; q = 2 (the L2 sum's order
        differs): norms within rtol 1e-6, indices equal where they agree."""
        (pg, ng), (pw, nw) = got, want
        assert torch.allclose(ng, nw, rtol=1e-6, atol=0)
        rows = ng == nw
        assert bool(rows.all()) or not q_is_inf
        assert torch.equal(ref.unpack_payload(pg, bits)[rows], ref.unpack_payload(pw, bits)[rows])

    pp, np_ = ref.quantize_blocks_plain(x, r, lv, **kw)
    held(quantize_blocks(x, r, lv, **kw), (pp, np_))
    P, N = torch.stack([pp, pp.flip(0)]), torch.stack([np_, np_.flip(0)])
    held(dequant_reduce_requantize_blocks(P, N, lv, r, num_workers=2, **kw),
         ref.dequant_reduce_requantize_blocks_plain(P, N, lv, r, **kw))



def qada_table(kind, s, dev):
    """A level table QAda solves (the exchange's 2 sweeps x 20 bisection
    steps over 512 bins): from a Gaussian's or a t(3)'s histogram over
    512-wide L^inf buckets, or the degenerate table of an all-zero
    histogram (every interior level within 1e-5 of 0)."""
    from repro_torch.core import adaptive_levels as qada
    from repro_torch.core.quantization import bucket_norms

    gen = torch.Generator()
    gen.manual_seed(s)
    if kind == "zero":
        hist = torch.zeros(512)
    else:
        v = torch.randn((256, 512), generator=gen)
        if kind == "t3":
            v = v / torch.sqrt(torch.randn((256, 512), generator=gen) ** 2 / 3 + 1e-3)
        hist = qada.normalized_coord_histogram(v, bucket_norms(v, float("inf")), 512)
    return qada.optimize_levels(uniform_levels(s, "cpu"), hist, sweeps=2,
                                bisect_iters=20).to(dev)


@pytest.mark.parametrize("kind,s,bits", [("gauss", 15, 8), ("t3", 5, 4), ("zero", 15, 8)])
def test_quantize_kernels_with_qada_tables(dev, kind, s, bits):
    """Kernels 1 and 2 on tables QAda produces, bit-equal to their plain
    versions at q = inf (whichever bracket branch the table sends them
    down: the degenerate table puts every level in one cell)."""
    lv = qada_table(kind, s, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(s + bits)
    nb, bucket = rows_for("wrap", dev), 512
    x = torch.randn((nb, bucket), generator=gen, device=dev) * torch.exp2(
        torch.randint(-24, 1, (nb, bucket), generator=gen, device=dev).float())
    x[5] = 0
    r = torch.rand((nb, bucket), generator=gen, device=dev)
    kw = dict(num_symbols=s + 2, q_is_inf=True, bits=bits)
    pp, np_ = ref.quantize_blocks_plain(x, r, lv, **kw)
    pk, nk = quantize_blocks(x, r, lv, **kw)
    assert torch.equal(pk, pp) and torch.equal(nk, np_)
    P, N = torch.stack([pp, pp.flip(0)]), torch.stack([np_, np_.flip(0)])
    got = dequant_reduce_requantize_blocks(P, N, lv, r, num_workers=2, **kw)
    want = ref.dequant_reduce_requantize_blocks_plain(P, N, lv, r, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("levels_kind", ["uniform", "qada"])
def test_segment_kernel_at_the_toy_vi_shape(dev, levels_kind):
    """Kernel 5 as the toy-VI loop calls it: K = 4 workers' 64-coordinate
    duals (bilinear_saddle(d=32)), bucket 64, one table, one launch per
    exchange, bit-equal to the plain version."""
    from repro_torch.core.exchange import ExchangeConfig, make_exchange
    from repro_torch.core.noise import ReplayNoise
    from repro_torch.core.quantization import QuantConfig

    s = 15
    lv = uniform_levels(s, dev) if levels_kind == "uniform" else qada_table("gauss", s, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    v = torch.randn((4, 64), generator=gen, device=dev)
    r = [torch.rand((1, 64), generator=gen, device=dev) for _ in range(4)]
    ex = make_exchange(ExchangeConfig(quant=QuantConfig(num_levels=s, bits=8, bucket_size=64)))
    before = cuda.launch_counts()["quantize_dequantize_segments"]
    got = ex.compress_with_levels(v, lv, ReplayNoise(r), workers=True)
    assert cuda.launch_counts()["quantize_dequantize_segments"] == before + 1
    want = ref.quantize_dequantize_segments_plain(
        v, torch.cat(r), lv[None], torch.zeros(4, dtype=torch.int32, device=dev),
        num_symbols=(s + 2,), q_is_inf=True)
    assert torch.equal(got, want)

def segment_tables(name, dev):
    """Kernel 5's stacked level tables of one case: 17, 7 and 5 symbols
    (T = 1, 2, 3); 32 tables of 2-128 symbols, uniform (cell lookup) and
    exponential (binary search), the contract's maximum T; or a 128-symbol
    exponential table beside a 128-symbol uniform one."""
    from repro_torch.core.exchange_plan import stack_level_tables
    from repro_torch.core.quantization import exponential_levels

    if name == "T32":
        return stack_level_tables(
            [uniform_levels(s, dev) for s in (0, 1, 2, 3, 5, 7, 10, 15, 20, 31, 40, 63, 64,
                                              100, 125, 126)]
            + [exponential_levels(s, dev) for s in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 15, 20,
                                                    30, 60, 126)])
    if name == "exp128":
        return stack_level_tables([exponential_levels(126, dev), uniform_levels(126, dev)])
    T = {"T1": 1, "T2": 2}.get(name, 3)
    return stack_level_tables([uniform_levels(15, dev), uniform_levels(5, dev),
                               exponential_levels(3, dev)][:T])


# kernel 5's cases: (tables, rows, bucket); rows "wrap" strides every warp
# over several rows; "bad_seg" gives rows a table id outside [0, T)
SEGMENT_CASES = {
    "T1": ("T1", 37, 512), "T2": ("T2", 37, 512), "T3": ("T3", 37, 512),
    "T32": ("T32", 101, 512), "exp128": ("exp128", 37, 512),
    "bucket1024": ("T3", 37, 1024), "bucket1023": ("T3", 37, 1023),
    "bucket130": ("T3", 37, 130), "wrap": ("T2", "wrap", 512), "bad_seg": ("T3", 37, 512),
}


def rounding_ties(got, want, x, r, tables, seg, ns, stochastic):
    """The q = 2 coordinates where kernel 5 and its plain version differ
    beyond rtol 1e-6; each must be a rounding tie that the L^2 norm's last
    bit decides (the two sum in different orders): the plain version's xi
    within 1e-5 of the draw (of 0.5 when rounding to nearest), the
    kernel's value the other end of its bracket.  Returns their mask."""
    import math

    flips = ~torch.isclose(got.nan_to_num(), want.nan_to_num(), rtol=1e-6, atol=0)
    norms = ref.norm_rows(x, False)
    for i, j in flips.nonzero().tolist():
        t, norm = int(seg[i]), float(norms[i])
        lv = tables[t]
        u = min(abs(float(x[i, j])) / (norm if norm > 0 else 1.0), 1.0)
        tau = int((lv[1:ns[t] - 1] <= u).sum())
        lo, hi = float(lv[tau]), float(lv[tau + 1])
        edge = float(r[i, j]) if stochastic else 0.5
        assert abs((u - lo) / (hi - lo) - edge) <= 1e-5
        assert any(math.isclose(abs(float(got[i, j])), e * norm, rel_tol=1e-5) for e in (lo, hi))
    return flips


@pytest.mark.parametrize("rounding", ["host noise", "device PRNG", "nearest"])
@pytest.mark.parametrize("q_is_inf", [True, False])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_kernel_matches_plain_version(dev, case, q_is_inf, rounding):
    """Kernel 5 over stacked tables with mixed symbol counts, zero rows and a
    NaN row, with host noise, the device PRNG (``seed=``) and nearest
    rounding: bit-equal for q = inf, rtol 1e-6 for q = 2 (the L^2 sum's
    order; over the ``wrap`` case's 4 M coordinates a rounding tie may go
    the other way, see ``rounding_ties``).  A row whose table id lies
    outside [0, T) is NaN throughout."""
    tab_name, rows, bucket = SEGMENT_CASES[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(sorted(SEGMENT_CASES).index(case) * 8 + 2 * q_is_inf + len(rounding))
    nb = rows_for(rows, dev)
    tables, ns = segment_tables(tab_name, dev)
    T = len(ns)
    x = torch.randn((nb, bucket), generator=gen, device=dev) * 3
    x[[0, 17]] = 0
    x[5, bucket // 2] = float("nan")
    r = torch.rand((nb, bucket), generator=gen, device=dev)
    seg = torch.randint(0, T, (nb,), generator=gen, device=dev, dtype=torch.int32)
    bad = [3, 20] if case == "bad_seg" else []
    seg[bad] = torch.tensor([-1, T], dtype=torch.int32, device=dev)[:len(bad)]
    stochastic, seed = rounding != "nearest", None
    if rounding == "device PRNG":
        r, seed = None, 0x0123456789ABCDEF
    kw = dict(num_symbols=ns, q_is_inf=q_is_inf, stochastic=stochastic)
    counter = "quantize_dequantize_segments" + ("/prng" if seed is not None else "")
    before = cuda.launch_counts()[counter]
    got = quantize_dequantize_segments(x, r, tables, seg, seed=seed, **kw)
    want = ref.quantize_dequantize_segments_plain(x, r, tables, seg.clamp(0, T - 1), seed=seed,
                                                  **kw)
    want[bad] = float("nan")
    torch.cuda.synchronize()
    assert cuda.launch_counts()[counter] == before + 1
    assert bool(got[5].isnan().all()) and bool((got[[0, 17]] == 0).all())
    if q_is_inf:
        assert same(got, want)
    else:
        if case == "wrap":
            draw = r if seed is None else ref.philox_uniform(seed, 0, nb, bucket, dev)
            flips = rounding_ties(got, want, x, draw, tables, seg, ns, stochastic)
            got, want = got.masked_fill(flips, 0.0), want.masked_fill(flips, 0.0)
        assert close(got, want)


def test_philox_known_answer_vectors_on_the_card(dev):
    """The kernels' device Philox (through its test entry) gives Random123's
    known answers, and the plain version's words on random counters."""
    from repro_torch.kernels.prng import philox_words

    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    ctr = torch.tensor([c for c, _, _ in kat], dtype=torch.int64)
    key = torch.tensor([k for _, k, _ in kat], dtype=torch.int64)
    got = philox_words(ctr.to(dev), key.to(dev)).cpu()
    assert got.tolist() == [list(w) for _, _, w in kat]
    gen = torch.Generator()
    gen.manual_seed(0)
    ctr = torch.randint(0, 1 << 32, (1000, 4), generator=gen, dtype=torch.int64)
    key = torch.randint(0, 1 << 32, (1000, 2), generator=gen, dtype=torch.int64)
    assert torch.equal(philox_words(ctr.to(dev), key.to(dev)).cpu(), philox_words(ctr, key))


@pytest.mark.parametrize("q_is_inf", [True, False])
@pytest.mark.parametrize("bits,bucket,rows", [
    (8, 512, 37), (4, 512, 37), (8, 130, 37), (4, 130, 37), (8, 1023, 37),
    (8, 2, 37), (4, 2, 37), (8, 1024, 37), (4, 1024, 37), (8, 4096, 37), (4, 4096, 37),
    (8, 130, "wrap"), (4, 130, "wrap")])
def test_device_prng_kernels_match_host_noise_kernels(dev, bits, bucket, rows, q_is_inf):
    """Kernels 1, 2 (K = 1, 2, 8) and 5 drawing their own noise equal the
    same kernels fed philox_uniform's draw of the seed, materialized on the
    card: payload bytes, norms and estimates bit for bit (the same
    arithmetic on the same noise), with an all-zero row and a NaN row; and,
    at q = inf, the plain versions on the CPU."""
    from repro_torch.core.exchange_plan import stack_level_tables

    s = 15 if bits == 8 else 5
    lv = uniform_levels(s, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(bits + bucket)
    nb, seed = rows_for(rows, dev), 0x0123456789ABCDEF
    x = torch.randn((nb, bucket), generator=gen, device=dev) * 3
    x[5] = 0
    x[6, bucket // 2] = float("nan")
    r = ref.philox_uniform(seed, 0, nb, bucket, dev)
    kw = dict(num_symbols=s + 2, q_is_inf=q_is_inf, bits=bits)
    before = cuda.launch_counts()
    pk, nk = quantize_blocks(x, None, lv, seed=seed, **kw)
    ph, nh = quantize_blocks(x, r, lv, **kw)
    assert torch.equal(pk, ph) and same(nk, nh)
    for K in (1, 2, 8):
        P = torch.stack([pk.roll(k, 0) for k in range(K)])
        N = torch.stack([nk.roll(k, 0) for k in range(K)])
        qk, mk = dequant_reduce_requantize_blocks(P, N, lv, None, num_workers=K, seed=seed, **kw)
        qh, mh = dequant_reduce_requantize_blocks(P, N, lv, r, num_workers=K, **kw)
        assert torch.equal(qk, qh) and same(mk, mh)
    for T in (1, 2):
        tables, ns = stack_level_tables([lv, uniform_levels(5, dev)][:T])
        seg = torch.randint(0, T, (nb,), generator=gen, device=dev, dtype=torch.int32)
        kw5 = dict(num_symbols=ns, q_is_inf=q_is_inf)
        ek = quantize_dequantize_segments(x, None, tables, seg, seed=seed, **kw5)
        assert same(ek, quantize_dequantize_segments(x, r, tables, seg, **kw5))
        if q_is_inf:
            assert same(ek.cpu(), ref.quantize_dequantize_segments_plain(
                x.cpu(), None, tables.cpu(), seg.cpu(), seed=seed, **kw5))
    if q_is_inf:
        pp, npl = ref.quantize_blocks_plain(x.cpu(), None, lv.cpu(), seed=seed, **kw)
        assert torch.equal(pk.cpu(), pp) and same(nk.cpu(), npl)
        qp, mp = ref.dequant_reduce_requantize_blocks_plain(P.cpu(), N.cpu(), lv.cpu(), None,
                                                            seed=seed, **kw)
        assert torch.equal(qk.cpu(), qp) and same(mk.cpu(), mp)
    after = cuda.launch_counts()
    assert [after[k] - before[k] for k in ("quantize_blocks/prng",
                                           "dequant_reduce_requantize_blocks/prng",
                                           "quantize_dequantize_segments/prng")] == [1, 3, 2]


def test_nccl_exchange_matches_gloo(tmp_path):
    """K > 1 on cards: the exchange over NCCL with the CUDA kernels gives
    the same means as over gloo with the plain versions (the path held to
    the JAX reference by test_torch_exchange.py), from the same inputs and
    noise — bit-identical for q = inf, rtol 1e-6 for q = 2 (the L2 norm's
    summation order differs)."""
    import math

    import numpy as np

    import _torch_exchange_worker

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs at least two CUDA GPUs")
    cuda.build()  # once, before the workers load it
    K = min(4, torch.cuda.device_count())
    cases = [("two_phase", 8, math.inf, 512), ("two_phase", 4, 2.0, 512),
             ("gather", 8, 2.0, 512), ("gather", 4, math.inf, 512)]
    rng = np.random.RandomState(0)
    n = 100_003
    inputs = {}
    for i, (mode, _, _, bucket) in enumerate(cases):
        quota = bucket if mode == "gather" else K * bucket
        rows = -(-n // quota) * quota // bucket
        for k in range(K):
            inputs[f"x_{i}_{k}"] = rng.randn(n).astype(np.float32)
            inputs[f"n1_{i}_{k}"] = rng.rand(rows, bucket).astype(np.float32)
            inputs[f"n2_{i}_{k}"] = rng.rand(rows // K, bucket).astype(np.float32)
    want, _ = _torch_exchange_worker.run_group(K, tmp_path / "gloo", inputs, cases)
    got, _ = _torch_exchange_worker.run_group(K, tmp_path / "nccl", inputs, cases,
                                              backend="nccl", device="cuda")
    for i, (mode, bits, q_norm, _) in enumerate(cases):
        for k in range(K):
            if math.isinf(q_norm):
                np.testing.assert_array_equal(got[i][k], want[i][k])
            else:
                np.testing.assert_allclose(got[i][k], want[i][k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rows", [16, 16 * 640])
@pytest.mark.parametrize("bits", [8, 4])
def test_kv_cache_kernels_at_bucket_256(dev, bits, rows):
    """Kernels 1 and 3 at the paged KV-cache's shapes (bucket 256: tinyllama's
    4 kv heads x 64; 16 decode rows a write, 16 x 640 rows a read), with a
    zero row: the writes and reads of ``repro_torch.serve.kv_cache`` on the
    card launch exactly these and equal their plain versions."""
    from repro_torch.serve import kv_cache

    s = 15 if bits == 8 else 5
    lv = uniform_levels(s, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(rows + bits)
    x = torch.randn((rows, 256), generator=gen, device=dev) * 2
    x[3] = 0
    r = torch.rand((rows, 256), generator=gen, device=dev)
    pk, nk = quantize_blocks(x, r, lv, num_symbols=s + 2, q_is_inf=True, bits=bits)
    pp, np_ = ref.quantize_blocks_plain(x, r, lv, num_symbols=s + 2, q_is_inf=True, bits=bits)
    assert torch.equal(pk, pp) and same(nk, np_) and float(nk[3]) == 0.0
    dk = dequantize_blocks(pk, nk, lv, num_symbols=s + 2, bits=bits)
    assert close(dk, ref.dequantize_blocks_plain(pk, nk, lv, bits=bits))
    assert not dk[3].any()
    # through the cache: one token write and one read of a [1, 2]-page table
    from repro_torch.configs import get_config

    pc = kv_cache.make_paged_cache_config(get_config("tinyllama-1.1b"), f"int{bits}",
                                          16, 4, 2)
    cache = kv_cache.init_paged_cache(pc, dev)
    before = cuda.launch_counts()
    k_t = x[:2].reshape(2, 4, 64)
    noise = kv_cache.KeyedNoise([1, 2], [0, 17], kv_cache.DECODE, pc.num_layers)
    kv_cache.write_token(cache, pc, 0, k_t, k_t, torch.tensor([0, -1], device=dev),
                         torch.tensor([0, 1], device=dev), noise)
    k, _ = kv_cache.read_kv(cache, pc, 0, torch.tensor([[0, -1]], device=dev))
    after = cuda.launch_counts()
    assert after["quantize_blocks"] - before["quantize_blocks"] == 2
    assert after["dequantize_blocks"] - before["dequantize_blocks"] == 2
    rr = noise.draw(0, 0, (2, 256), dev)
    pq, nq = ref.quantize_blocks_plain(k_t.reshape(2, 256), rr, lv, num_symbols=s + 2,
                                       q_is_inf=True, bits=bits)
    want = ref.dequantize_blocks_plain(pq, nq, lv, bits=bits)[0].reshape(4, 64)
    assert close(k[0, 0], want) and not k[0, 1:].any()
