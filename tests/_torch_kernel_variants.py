"""Design choices of CUDA kernels 1 and 2, each undone, timed on the card.

Builds ``src/repro_torch/csrc/exchange_kernels.cu`` as it stands and once
per variant with one of its design choices undone by a source edit,
times kernel 1 (``qx_quantize``) and kernel 2
(``qx_dequant_reduce_requantize``), int8, with host noise and with the
device PRNG, on the tinyllama-1.1b exchange buffer (2,148,532 rows x 512,
K = 1, q = inf: the main path's shape), and holds every variant's
payloads and norms bit-equal to the unedited build's on that buffer and
on one with a wide dynamic range, exact zeros and denormals (q = inf and
q = 2).  Prints the card's name and power limit, each build's registers
(``-Xptxas=-v``) and times.  Needs one CUDA GPU and nvcc::

    PYTHONPATH=src python tests/_torch_kernel_variants.py
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core.quantization import uniform_levels
from repro_torch.kernels import cuda

ROWS, BUCKET, SEED = 2148532, 512, 0x9E3779B97F4A7C15
VARIANTS = {  # name -> (old, new) source edits, each of which must apply
    "as built": [],
    "16 coordinates a lane": [("constexpr int kLaneCols = 8;",
                               "constexpr int kLaneCols = 16;")],
    "binary search only": [("const bool fine = stage_tables(t, levels, num_symbols);",
                            "const bool fine = stage_tables(t, levels, num_symbols) && false;")],
    "zero dividends to __fdiv_rn": [(
        "  const float q = __fdiv_rn(a != 0.0f ? a : b, b);\n  return a != 0.0f ? q : 0.0f;",
        "  return __fdiv_rn(a, b);")],
}
KERNELS = {"quantize_kernelILi4ELb0ENS_11BufferNoise": "B1",
           "quantize_kernelILi4ELb0ENS_11PhiloxNoise": "B1/prng",
           "requantize_kernelILi4ELb0ENS_11BufferNoise": "B2",
           "requantize_kernelILi4ELb0ENS_11PhiloxNoise": "B2/prng"}


def build(name: str, out_dir: Path) -> tuple:
    """Compile one variant; returns (library path, {kernel: registers})."""
    src = cuda.SOURCE.read_text()
    for old, new in VARIANTS[name]:
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


def same(a, b) -> bool:
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
    return torch.equal(a, b)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0])
    out_dir = cuda.BUILD_DIR.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda n: build(n, out_dir), VARIANTS)))
    dev = torch.device("cuda")
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
    ref = None
    print(f"{'variant':30s} registers (B1, B1/prng, B2, B2/prng); ms: B1  B1/prng  B2  B2/prng")
    for name, (path, regs) in built.items():
        lib = bind(path)
        outs = run(lib, x, r, lv) + run(lib, wide, r[: ROWS // 16], lv)
        outs += run(lib, wide, r[: ROWS // 16], lv, q_is_inf=False)
        ref = ref or outs
        if not all(same(a, b) for a, b in zip(outs, ref)):
            raise SystemExit(f"variant {name!r}: outputs differ from the unedited build's")
        stream = torch.cuda.current_stream(dev).cuda_stream
        p = torch.empty((ROWS, BUCKET), dtype=torch.int8, device=dev)
        n = torch.empty((ROWS,), device=dev)
        q, m = torch.empty_like(p), torch.empty_like(n)
        times = []
        for prng in (False, True):
            noise, args = (None if prng else r.data_ptr()), (lv.data_ptr(), 17)
            times.append(time_ms(lambda: lib.qx_quantize(
                x.data_ptr(), noise, SEED, prng, *args, ROWS, BUCKET, 1, 8, p.data_ptr(),
                n.data_ptr(), 0, stream)))
            times.append(time_ms(lambda: lib.qx_dequant_reduce_requantize(
                p.data_ptr(), n.data_ptr(), noise, SEED + 1, prng, *args, 1, ROWS, BUCKET, 1, 8,
                1.0, q.data_ptr(), m.data_ptr(), 0, stream)))
        b1, b2, b1p, b2p = times
        print(f"{name:30s} {[regs.get(k) for k in ('B1', 'B1/prng', 'B2', 'B2/prng')]}; "
              f"{b1:.3f}  {b1p:.3f}  {b2:.3f}  {b2p:.3f}  (outputs equal the unedited build's)",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
