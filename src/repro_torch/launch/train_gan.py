"""The paper's experiment (Section 5): WGAN-GP with distributed ExtraAdam on
K simulated workers, fp32 against compressed exchanges
(``python -m repro_torch.launch.train_gan``; counterpart of
``examples/train_gan.py``)::

    python -m repro_torch.launch.train_gan                 # on cuda
    python -m repro_torch.launch.train_gan --device cpu --steps 50

Arms: fp32 (no exchange), uq8 (qgenx, s = 15, 8 bit, bucket 512, q = inf),
uq4 (s = 5, 4 bit), randk25 (unbiased rand-k keeping a quarter of each
leaf's coordinates, scaled by n/k: ``python -m
repro_torch.launch.train_gan --arms randk25``) and layerwise (uq4 for
leaves above 2048 coordinates, so the 64 x 64 hidden matrices take the
low-bit path; uq8 for the rest).  Prints energy distance, median ms/step
and bytes per step per worker for each arm.  No flag selects the device-PRNG exchange (the
reference has none): it is ``GANConfig(exchange=ExchangeConfig(...,
use_device_prng=True))`` passed to :func:`repro_torch.gan.wgan.train`.
"""

from __future__ import annotations

import argparse
import math

from repro_torch.core.exchange import ExchangeConfig
from repro_torch.core.quantization import QuantConfig
from repro_torch.gan.wgan import GANConfig, train

UQ8 = QuantConfig(num_levels=15, bits=8, bucket_size=512, q_norm=math.inf)
UQ4 = QuantConfig(num_levels=5, bits=4, bucket_size=512, q_norm=math.inf)
ARMS = ("fp32", "uq8", "uq4", "randk25", "layerwise")


def arm_exchange(tag: str):
    """The exchange of one arm (None: the exact fp32 mean)."""
    if tag == "fp32":
        return None
    if tag == "uq8":
        return ExchangeConfig(compressor="qgenx", quant=UQ8)
    if tag == "uq4":
        return ExchangeConfig(compressor="qgenx", quant=UQ4)
    if tag == "layerwise":
        # threshold below the 64x64 = 4096 hidden matrices so the big
        # leaves take the low-bit path (the policy is strict >)
        return ExchangeConfig(compressor="layerwise", quant=UQ4, layerwise_threshold=2048)
    if tag == "randk25":
        return ExchangeConfig(compressor="randk", rand_frac=0.25)
    raise ValueError(f"unknown arm {tag!r}; one of {ARMS}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train_gan")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--arms", nargs="+", choices=ARMS, default=list(ARMS))
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return ap


def run(args, log=print) -> dict:
    """Train every arm; returns ``{arm: train()'s result}``."""
    log(f"{'mode':>9} | {'energy_dist':>11} | {'ms/step':>8} | bytes/step/worker")
    results = {}
    for tag in args.arms:
        cfg = GANConfig(num_workers=args.workers, exchange=arm_exchange(tag))
        out = train(cfg, steps=args.steps, device=args.device)
        log(f"{tag:>9} | {out['energy_distance']:11.4f} | "
            f"{out['median_step_ms']:8.1f} | {out['bytes_per_step_per_worker']:.3e}")
        results[tag] = out
    return results


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
