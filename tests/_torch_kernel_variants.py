"""Design choices of CUDA kernels 1, 2 and 5, each undone, timed on the card.

Builds ``src/repro_torch/csrc/exchange_kernels.cu`` as it stands and once
per variant with one of its design choices undone by a source edit (with
``--baseline FILE``, also that source file as it is: an earlier version
of the kernels, the same C interface, held bit-equal at q = inf only: its
L^2 norm may sum in another order).  Times, on the tinyllama-1.1b
exchange buffer (2,148,532 rows x 512, K = 1, q = inf: the main path's
shape), kernel 1 (``qx_quantize``) and kernel 2
(``qx_dequant_reduce_requantize``), int8, and kernel 5
(``qx_segment_qdq``) with one table (qgenx int8) and with the layerwise
plan's two, each with host noise and with the device PRNG; and kernel 5's
device time a launch at the GAN path's shapes ([3 x 19, 512]: the uq8,
uq4 and layerwise arms' inputs, recorded from ``compress_tree``, and uq8
with the device PRNG), from ``torch.profiler`` over 200 launches.  Holds
every variant's outputs bit-equal to the unedited build's on that buffer
and on one with a wide dynamic range, exact zeros and denormals (q = inf
and q = 2).  Prints the card's name and power limit, each build's
registers (``-Xptxas=-v``) and times.  Needs one CUDA GPU and nvcc::

    PYTHONPATH=src python tests/_torch_kernel_variants.py [--baseline OLD.cu]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core.quantization import uniform_levels
from repro_torch.kernels import cuda

ROWS, BUCKET, SEED = 2148532, 512, 0x9E3779B97F4A7C15
# kernel 5's first draw (issued with x's loads) and the line after its norm
_DRAW0 = ("    if constexpr (STOCHASTIC) draw_chunk<VEC>(src, 0, ngroups, lane, r);"
          "  // under x's loads\n")
_FINE5 = "    const bool fine = !((s_coarse >> tt) & 1u);\n"
VARIANTS = {  # name -> (old, new) source edits, each of which must apply
    "as built": [],
    "16 coordinates a lane": [("constexpr int kLaneCols = 8;",
                               "constexpr int kLaneCols = 16;")],
    "binary search only": [("const bool fine = stage_tables(t, levels, num_symbols);",
                            "const bool fine = stage_tables(t, levels, num_symbols) && false;"),
                           (_FINE5, "    const bool fine = false;\n")],
    "zero dividends to __fdiv_rn": [(
        "  const float q = __fdiv_rn(a != 0.0f ? a : b, b);\n  return a != 0.0f ? q : 0.0f;",
        "  return __fdiv_rn(a, b);")],
    "kernel 5: linear bracket scan": [(
        "  if (fine) {\n#pragma unroll\n    for (int e = 0; e < kLaneCols; ++e) {\n"
        "      // a NaN u takes cell 0",
        "  if (true) {\n#pragma unroll\n    for (int e = 0; e < kLaneCols; ++e) {\n"
        "      tau[e] = 0;\n      for (int j = 1; j <= s; ++j) tau[e] += lv[j] <= u[e] ? 1 : 0;\n"
        "    }\n  } else if (fine) {\n#pragma unroll\n    for (int e = 0; e < kLaneCols; ++e) {\n"
        "      // a NaN u takes cell 0")],
    "kernel 5: draw after the norm": [(_DRAW0, ""), (_FINE5, _FINE5 + _DRAW0)],
    "kernel 5: x's chunk 1 re-read": [
        ("    load_chunk<VEC>(x_row, 1, ngroups, lane, w);  // zeros past the row's end\n"
         "    float part = chunk_norm(w, q_is_inf, chunk_norm(v, q_is_inf, 0.0f));\n"
         "    for (int c = 2; c < nchunks; ++c) {",
         "    float part = chunk_norm(v, q_is_inf, 0.0f);\n"
         "    for (int c = 1; c < nchunks; ++c) {"),
        ("    if (nchunks > 1) {  // chunk 1 from registers, its draw now\n"
         "      if constexpr (STOCHASTIC) draw_chunk<VEC>(src, 1, ngroups, lane, r);\n"
         "      qdq_chunk<VEC, STOCHASTIC>(w, r, norm, safe, lv, below, s, fine, out_row, 1, "
         "ngroups,\n                                 lane);\n    }\n"
         "    for (int c = 2; c < nchunks; ++c) {", "    for (int c = 1; c < nchunks; ++c) {")],
    "kernel 5: registers left to nvcc": [("__launch_bounds__(kRowThreads, 3)",
                                          "__launch_bounds__(kRowThreads)")],
}
KERNELS = {"quantize_kernelILi4ELb0ENS_11BufferNoise": "B1",
           "quantize_kernelILi4ELb0ENS_11PhiloxNoise": "B1/prng",
           "requantize_kernelILi4ELb0ENS_11BufferNoise": "B2",
           "requantize_kernelILi4ELb0ENS_11PhiloxNoise": "B2/prng",
           "segment_qdq_kernelILi4ENS_11BufferNoise": "B6",
           "segment_qdq_kernelILi4ENS_11PhiloxNoise": "B6/prng"}


def build(name: str, source: str, out_dir: Path) -> tuple:
    """Compile one variant of ``source``; returns (library path, {kernel:
    registers})."""
    src = source
    for old, new in VARIANTS.get(name, []):
        if old not in src:
            raise SystemExit(f"variant {name!r}: {old!r} is not in the source")
        src = src.replace(old, new)
    tag = re.sub(r"\W+", "_", name)
    cu, lib = out_dir / f"{tag}.cu", out_dir / f"lib{tag}.so"
    cu.write_text(src)
    proc = subprocess.run([cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name!r} does not build:\n{proc.stderr[-3000:]}")
    regs, fn = {}, ""
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        fn = m.group(1) if m else fn
        m = re.search(r"Used (\d+) registers", line)
        for key, label in KERNELS.items():
            if m and key in fn and not (label.startswith("B1") and "requantize" in fn):
                regs[label] = int(m.group(1))
    return lib, regs


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in cuda._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def run(lib, x, r, lv, q_is_inf=True) -> list:
    """Kernels 1 and 2 with host noise and with the device PRNG on x (kernel
    2 on kernel 1's payload); returns the outputs in that order."""
    dev, (rows, bucket) = x.device, x.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = []
    for prng in (False, True):
        p = torch.empty((rows, bucket), dtype=torch.int8, device=dev)
        n = torch.empty((rows,), device=dev)
        q, m = torch.empty_like(p), torch.empty_like(n)
        noise = None if prng else r.data_ptr()
        rc = lib.qx_quantize(x.data_ptr(), noise, SEED, prng, lv.data_ptr(), lv.numel(), rows,
                             bucket, q_is_inf, 8, p.data_ptr(), n.data_ptr(), 0, stream)
        rc = rc or lib.qx_dequant_reduce_requantize(
            p.data_ptr(), n.data_ptr(), noise, SEED + 1, prng, lv.data_ptr(), lv.numel(), 1,
            rows, bucket, q_is_inf, 8, 1.0, q.data_ptr(), m.data_ptr(), 0, stream)
        if rc:
            raise SystemExit(f"launch failed: cudaError {rc}")
        outs += [p, n, q, m]
    return outs


def segment_call(lib, x, r, tables, seg, ns, out, seed=None, q_is_inf=True):
    """One launch of kernel 5 (host noise ``r``, or the device PRNG with
    ``seed``) into ``out``, as the wrapper makes it."""
    rows, bucket = x.shape
    rc = lib.qx_segment_qdq(
        x.data_ptr(), None if seed is not None else r.data_ptr(), seed or 0, seed is not None,
        tables.data_ptr(), seg.data_ptr(), tables.shape[0], tables.shape[1],
        (ctypes.c_int * len(ns))(*ns), rows, bucket, q_is_inf, 1, out.data_ptr(), 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise SystemExit(f"launch failed: cudaError {rc}")
    return out


def run_segment(lib, x, r, cases, q_is_inf=True):
    """Kernel 5 on x over each (tables, table ids, symbol counts) case, with
    host noise and with the device PRNG: the outputs, one at a time."""
    for tables, seg, ns in cases:
        for seed in (None, SEED):
            yield segment_call(lib, x, r, tables, seg, ns, torch.empty_like(x), seed, q_is_inf)


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 200) -> float:
    """Device time of one launch of ``kernel`` (a substring of its name):
    ``reps`` calls under ``torch.profiler``, summed by ``key_averages()``
    over the launches it recorded (it may drop some) and divided by their
    count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
             for e in evts)
    seen = sum(e.count for e in evts)
    if seen < reps // 2 or us <= 0:
        raise SystemExit(f"the profiler saw {seen} of {reps} launches of {kernel}")
    return us / seen / 1e3


def same(a, b) -> bool:
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
    return torch.equal(a, b)


def layerwise_rows(dev) -> list:
    """Rows of the layerwise compress plan's two segments (int4 leaves above
    65536 coordinates first, the rest int8) on tinyllama-1.1b."""
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig, make_exchange
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.models.model import build as build_model

    model = build_model(get_config("tinyllama-1.1b"), device=dev)
    shapes = [tuple(p.shape) for p in model.param_leaves()]
    del model
    torch.cuda.empty_cache()
    lo = QuantConfig(num_levels=5, bits=4, bucket_size=BUCKET)
    plan = make_exchange(ExchangeConfig(compressor="layerwise", quant=lo)).plan_for(
        shapes, "compress", 1)
    rows = [seg.padded // BUCKET for seg in plan.segments]
    if sum(rows) != ROWS:
        raise SystemExit(f"layerwise plan rows {rows} do not make {ROWS}")
    return rows


class _Noise:
    """Uniform draws and 64-bit seeds from one generator on the card."""

    def __init__(self, dev):
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(3)

    def uniform(self, shape, device):
        return torch.rand(tuple(shape), generator=self.gen, device=device)

    def seed(self):
        return SEED


def gan_inputs(dev) -> dict:
    """Kernel 5's inputs on the GAN path, per arm: one ``compress_tree`` of
    random worker gradients shaped like the WGAN-GP testbed's parameters
    (3 workers), its kernel-5 call recorded."""
    import dataclasses

    from repro_torch.core import exchange_plan
    from repro_torch.core.tree import tree_map
    from repro_torch.gan import wgan
    from repro_torch.launch import train_gan

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = wgan.WGAN(wgan.GANConfig(), gen, dev)
    wrapper, calls = exchange_plan.quantize_dequantize_segments, {}

    def recorder(x2d, noise, tables, seg_ids, **kw):
        calls[arm] = (x2d.clone(), noise, tables, seg_ids, kw)
        return wrapper(x2d, noise, tables, seg_ids, **kw)

    exchange_plan.quantize_dequantize_segments = recorder
    try:
        for arm in ("uq8", "uq4", "layerwise", "uq8-prng"):
            ex_cfg = train_gan.arm_exchange(arm.split("-")[0])
            if arm.endswith("prng"):
                ex_cfg = dataclasses.replace(ex_cfg, use_device_prng=True)
            ex = wgan.GANConfig(exchange=ex_cfg).make_exchange()
            grads = tree_map(lambda p: torch.randn((3, *p.shape), generator=gen, device=dev),
                             model.param_tree())
            ex.compress_tree(grads, _Noise(dev), workers=True)
    finally:
        exchange_plan.quantize_dequantize_segments = wrapper
    return calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="another exchange_kernels.cu, built and timed beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0])
    out_dir = cuda.BUILD_DIR.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: cuda.SOURCE.read_text() for name in VARIANTS}
    if args.baseline:
        sources[f"baseline {args.baseline.name}"] = args.baseline.read_text()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda n: build(n, sources[n], out_dir), sources)))
    dev = torch.device("cuda")
    gan = gan_inputs(dev)
    seg_rows = layerwise_rows(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((ROWS, BUCKET), generator=gen, device=dev)
    r = torch.rand((ROWS, BUCKET), generator=gen, device=dev)
    wide = torch.randn((ROWS // 16, BUCKET), generator=gen, device=dev) * torch.exp2(
        torch.randint(-126, 127, (ROWS // 16, 1), generator=gen, device=dev).float()
        + torch.randint(-40, 40, (ROWS // 16, BUCKET), generator=gen, device=dev).float())
    wide[::7, ::3] = 0.0
    wide[::11, 5] = 1e-42
    lv = uniform_levels(15, dev)
    from repro_torch.core.exchange_plan import stack_level_tables

    t1, ns1 = stack_level_tables([lv])
    t2, ns2 = stack_level_tables([uniform_levels(5, dev), lv])
    seg1 = torch.zeros((ROWS,), dtype=torch.int32, device=dev)
    seg2 = torch.cat([torch.full((k,), t, dtype=torch.int32, device=dev)
                      for t, k in enumerate(seg_rows)])
    cases = [(t1, seg1, ns1), (t2, seg2, ns2)]
    wide_cases = [(t, s[: ROWS // 16], n) for t, s, n in cases]
    ref, ref5 = None, None
    print(f"{'variant':32s} registers (B1, B1/prng, B2, B2/prng, B6, B6/prng); ms at the "
          "buffer: B1  B1/prng  B2  B2/prng  B6 T=1  B6 T=2  B6/prng T=1  B6/prng T=2; "
          "device ms a launch at the GAN shape: uq8  uq4  layerwise  uq8/prng")
    for name, (path, regs) in built.items():
        lib = bind(path)
        outs = run(lib, x, r, lv) + run(lib, wide, r[: ROWS // 16], lv)
        outs += run(lib, wide, r[: ROWS // 16], lv, q_is_inf=False)
        ref = ref or outs
        if not all(same(a, b) for a, b in zip(outs, ref)):
            raise SystemExit(f"variant {name!r}: kernel 1 or 2 outputs differ from the "
                             "unedited build's")
        del outs
        # the wide buffer at q = inf and q = 2, then the full buffer (q = inf);
        # the baseline sums the L^2 norm in another order, so its q = 2
        # outputs are not compared
        seg_outs = itertools.chain(
            *(run_segment(lib, wide, r[: ROWS // 16], wide_cases, q) for q in (True, False)),
            run_segment(lib, x, r, cases))
        q2 = [False] * 4 + [True] * 4 + [False] * 4
        if ref5 is None:
            ref5 = list(seg_outs)
        elif not all(same(a, b) or (q and name.startswith("baseline"))
                     for a, b, q in zip(seg_outs, ref5, q2)):  # one output at a time
            raise SystemExit(f"variant {name!r}: kernel 5 outputs differ from the unedited "
                             "build's")
        stream = torch.cuda.current_stream(dev).cuda_stream
        p = torch.empty((ROWS, BUCKET), dtype=torch.int8, device=dev)
        n = torch.empty((ROWS,), device=dev)
        q, m = torch.empty_like(p), torch.empty_like(n)
        times = []
        for prng in (False, True):
            noise, targs = (None if prng else r.data_ptr()), (lv.data_ptr(), 17)
            times.append(time_ms(lambda: lib.qx_quantize(
                x.data_ptr(), noise, SEED, prng, *targs, ROWS, BUCKET, 1, 8, p.data_ptr(),
                n.data_ptr(), 0, stream)))
            times.append(time_ms(lambda: lib.qx_dequant_reduce_requantize(
                p.data_ptr(), n.data_ptr(), noise, SEED + 1, prng, *targs, 1, ROWS, BUCKET, 1,
                8, 1.0, q.data_ptr(), m.data_ptr(), 0, stream)))
        del p, q
        est = torch.empty_like(x)
        for seed in (None, SEED):
            for tables, seg, ns in cases:
                times.append(time_ms(lambda: segment_call(lib, x, r, tables, seg, ns, est, seed)))
        del est
        gan_ms = []
        for arm in ("uq8", "uq4", "layerwise", "uq8-prng"):
            gx, gr, gt, gs, kw = gan[arm]
            gout = torch.empty_like(gx)
            gan_ms.append(device_ms(lambda: segment_call(
                lib, gx, gr, gt, gs, kw["num_symbols"], gout, kw.get("seed")),
                "segment_qdq_kernel"))
        b1, b2, b1p, b2p, b6, b6t2, b6p, b6pt2 = times
        labels = ("B1", "B1/prng", "B2", "B2/prng", "B6", "B6/prng")
        print(f"{name:32s} {[regs.get(k) for k in labels]}; "
              f"{b1:.3f}  {b1p:.3f}  {b2:.3f}  {b2p:.3f}  {b6:.3f}  {b6t2:.3f}  {b6p:.3f}  "
              f"{b6pt2:.3f}; {'  '.join(f'{t:.5f}' for t in gan_ms)}  (outputs equal the "
              "unedited build's)", flush=True)


if __name__ == "__main__":
    sys.exit(main())
