"""Build, load and count the hand-written CUDA exchange kernels.

The kernels live in ``src/repro_torch/csrc/exchange_kernels.cu`` behind a
plain C interface.  At first use in a process, :func:`library` compiles
that file with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at
the repo root (listed in ``.gitignore``; the file name carries a hash of
the source and flags, so an edit rebuilds) and loads it with ``ctypes``.
Nothing is built at import time, and a failed build raises: there is no
fallback to the plain versions for CUDA tensors.

Every wrapper counts its launches here (:func:`count`) so a run can show
which kernels its main path went through (:func:`launch_counts`,
:func:`reset_launch_counts`); a device-PRNG launch counts under
``<kernel>/prng``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels.ref import seed_key

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "exchange_kernels.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the rounding decisions must see the same
    # products and sums as the reference (see the source's header)
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
# the launch counters: one per kernel, and one per device-PRNG variant
# ("<kernel>/prng": the same kernel drawing its noise with Philox), so a
# run shows which of the two its path took; "philox" is the test entry
# that writes raw Philox words
PRNG = "/prng"
KERNELS = ("quantize_blocks", "dequant_reduce_requantize_blocks",
           "dequantize_blocks", "dequant_reduce_blocks", "quantize_dequantize_segments",
           "quantize_blocks/prng", "dequant_reduce_requantize_blocks/prng",
           "quantize_dequantize_segments/prng", "philox")

_LAUNCHES = {name: 0 for name in KERNELS}
_LIB = None

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U64 = ctypes.c_ulonglong
_SIGNATURES = {
    # noise buffer (None with the device PRNG), seed, device_prng flag, ...
    "qx_quantize": (_P, _P, _U64, _I, _P, _I, _LL, _I, _I, _I, _P, _P, _I, _P),
    "qx_dequantize": (_P, _P, _P, _I, _LL, _I, _I, _P, _I, _P),
    "qx_dequant_reduce": (_P, _P, _P, _I, _I, _LL, _I, _I, _F, _P, _I, _P),
    "qx_dequant_reduce_requantize": (_P, _P, _P, _U64, _I, _P, _I, _I, _LL, _I, _I, _I, _F,
                                     _P, _P, _I, _P),
    "qx_segment_qdq": (_P, _P, _U64, _I, _P, _P, _I, _I, _P, _LL, _I, _I, _I, _P, _I, _P),
    "qx_philox": (_P, _P, _LL, _P, _I, _P),
}


def count(name: str) -> None:
    """Add one launch of kernel ``name`` (called by its wrapper)."""
    _LAUNCHES[name] += 1


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA exchange kernels cannot be built")


def build() -> Path:
    """Compile the kernels (once per source/flags hash); returns the .so path.

    The compiler's ``-Xptxas=-v`` report (registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.log``.
    """
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libqx_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent ranks never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call in this process)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build_log() -> str:
    """The compiler's resource report for the current build."""
    return build().with_suffix(".log").read_text()


def call(fn_name: str, kernel: str, device: torch.device, *args) -> None:
    """Launch ``fn_name`` on ``device`` and PyTorch's current stream; raise
    on a refused launch, count it otherwise."""
    stream = torch.cuda.current_stream(device).cuda_stream
    index = device.index if device.index is not None else torch.cuda.current_device()
    rc = getattr(library(), fn_name)(*args, index, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")
    count(kernel)


def rounding(noise, seed, rows: int, bucket: int):
    """Check a kernel's rounding arguments: exactly one of the ``[rows,
    bucket]`` uniform noise buffer and the device PRNG's 64-bit ``seed``.
    Returns the launch counter's suffix (``PRNG`` with a seed)."""
    if (noise is None) == (seed is None):
        raise ValueError("pass exactly one of the noise buffer and the device-PRNG seed")
    if seed is not None:
        seed_key(seed)  # raises unless a 64-bit unsigned integer
        return PRNG
    if tuple(noise.shape) != (rows, bucket):
        raise ValueError(f"noise shape {tuple(noise.shape)} != {(rows, bucket)}")
    return ""


def prepare(t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Contiguous, 16-byte aligned ``dtype`` tensor on ``device`` (a view
    with an unaligned storage offset is copied: the kernels use 16-byte
    accesses)."""
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, kernel launched on {device}")
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t
