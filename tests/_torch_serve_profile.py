"""Where a decode wave's time goes on the card: the serving engine at the
full width of tinyllama-1.1b (f32, random weights from seed 0; 16 slots,
16 requests of 512-token prompts, a page of 16 tokens), one run per
``--kv-bits`` policy.

Every wave's host time comes from the engine's own clock (``timing``:
the wave ends with the fetch of its tokens, so it includes the device's
work).  Waves 8-11 (all 16 slots decoding, no prefill between them) run
under ``torch.profiler``: the device's busy time a wave (the sum of its
kernels' device time), the kernel launches a wave, and the kernels that
take the most device time, kernels 1 and 3 among them.

    PYTHONPATH=src python tests/_torch_serve_profile.py [--kv-bits 8 4 32]

Needs one CUDA card (exits 1 without one).
"""

import argparse
import dataclasses
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models.model import build
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request

PROFILED = range(8, 12)


def profile_policy(model, bits: str) -> dict:
    policy = {"32": "fp32", "8": "int8", "4": "int4"}[bits]
    eng = ServeEngine(model.cfg, model, policy=policy, page_size=16, n_slots=16, max_len=640,
                      seed=0)
    reqs = [Request(r, np.random.default_rng([0, r]).integers(0, model.cfg.vocab_size,
                                                                512).tolist(), 24)
            for r in range(16)]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    orig = eng._decode_wave
    host = {}

    def wave(packable, events=None):
        step = eng.sched.decode_steps
        if step == PROFILED.start:
            torch.cuda.synchronize()
            prof.start()
        t0 = time.perf_counter()
        out = orig(packable, events)
        host[step] = time.perf_counter() - t0
        if step == PROFILED.stop - 1:
            torch.cuda.synchronize()
            prof.stop()
        return out

    eng._decode_wave = wave
    eng.run(reqs)
    n = len(PROFILED)
    kernels = [e for e in prof.key_averages()
               if (getattr(e, "device_time_total", 0) or 0) > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    unprofiled = [host[s] for s in host if s not in PROFILED and s > 0]
    out = {"kv_bits": bits, "host_ms": 1e3 * statistics.median(unprofiled),
           "profiled_host_ms": 1e3 * statistics.median(host[s] for s in PROFILED),
           "device_busy_ms": busy_us / n / 1e3, "launches": launches / n, "kernels": {}}
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:12]:
        out["kernels"][e.key[:90]] = (e.device_time_total / n / 1e3, e.count / n)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-bits", nargs="+", default=["8", "4", "32"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), dtype="float32")
    model = build(cfg, seed=0, device="cuda")
    for p in model.parameters():
        p.requires_grad_(False)
    print(torch.cuda.get_device_name(0))
    for bits in args.kv_bits:
        r = profile_policy(model, bits)
        print(f"[profile] kv-bits {bits}: host {r['host_ms']:.2f} ms a wave (median, "
              f"unprofiled; {r['profiled_host_ms']:.2f} profiled), device busy "
              f"{r['device_busy_ms']:.3f} ms a wave ({100 * r['device_busy_ms'] / r['host_ms']:.1f} "
              f"%), {r['launches']:.0f} kernel launches a wave")
        for name, (ms, count) in r["kernels"].items():
            print(f"[profile]   {ms:8.4f} ms  {count:6.0f} x  {name}")


if __name__ == "__main__":
    main()
