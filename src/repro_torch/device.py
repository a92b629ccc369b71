"""Device selection for the port's entry points.

The default device is ``cuda``.  Asking for ``cuda`` on a machine without a
GPU raises instead of carrying on on the CPU: the CPU is only used when the
caller asks for it by name (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` | ``"cuda:N"`` | ``"cpu"`` -> ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
