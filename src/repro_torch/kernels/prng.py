"""The device PRNG on its own: raw Philox4x32-10 words from the card.

The device-PRNG variants of kernels 1, 2 and 5 (the port of TPU kernel
B5, ``repro/kernels/common.py::prng_uniform``) compute Philox inside the
kernels (``csrc/exchange_kernels.cu::philox4x32_10``).  This test entry
launches that device function alone (``qx_philox``) on n (counter, key)
pairs, so the known-answer vectors can be held on the card; the exchange
never calls it.  CPU tensors take the plain version
:func:`repro_torch.kernels.ref.philox4x32_10`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda, ref


def philox_words(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of each row: ``ctr`` [n, 4] and ``key`` [n, 2] hold
    32-bit words (any integer dtype, values in [0, 2^32)); returns the
    [n, 4] output words as int64."""
    n = ctr.shape[0]
    if tuple(ctr.shape) != (n, 4) or tuple(key.shape) != (n, 2):
        raise ValueError(f"ctr must be [n, 4] and key [n, 2], got {tuple(ctr.shape)}, "
                         f"{tuple(key.shape)}")
    if ctr.device.type != "cuda":
        c = ctr.to(torch.int64)
        k = key.to(torch.int64)
        out = ref.philox4x32_10([c[:, 0], c[:, 1], c[:, 2], c[:, 3]], (k[:, 0], k[:, 1]))
        return torch.stack(out, dim=1)
    dev = ctr.device
    # 32-bit words as int32 bit patterns (the int64 -> int32 cast wraps)
    c = cuda.prepare(ctr.to(torch.int64).to(torch.int32), torch.int32, dev)
    k = cuda.prepare(key.to(torch.int64).to(torch.int32), torch.int32, dev)
    out = torch.empty((n, 4), dtype=torch.int32, device=dev)
    cuda.call("qx_philox", "philox", dev, c.data_ptr(), k.data_ptr(), n, out.data_ptr())
    return out.to(torch.int64) & 0xFFFFFFFF
