"""End-to-end training entry point of the port (``python -m repro_torch.launch.train``).

Trains a dense decoder with ExtraAdam (the default, as in the reference
CLI), Adam, optimistic Adam or the paper's adaptive Q-GenX optimizer, and
the quantized gradient exchange (``--compressor qgenx | layerwise |
none``), on ``cuda`` (default) or, when asked, ``--device cpu``.  One process is one worker; for K > 1 workers launch it
under ``torchrun`` (NCCL on the card, gloo on the CPU), which sets the
rank and world size read here::

    python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced \\
        --steps 20 --batch 8 --seq 128 --compression int8
    python -m repro_torch.launch.train --reduced --optimizer qgenx --method optda \\
        --compression int8
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduced --compression int4 --compressor layerwise

Unlike the reference CLI, the exchange runs at K = 1 too whenever there is
something to compress (the world-size-1 communicator), so one card drives
every exchange kernel.  As in the reference, no flag selects the
device-PRNG exchange: a caller of :func:`run` passes
``exchange=ExchangeConfig(..., use_device_prng=True)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.exchange import (
    COMPRESSORS,
    ExchangeConfig,
    ProcessGroupComm,
    SingleWorker,
    make_exchange,
)
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import optimizers as opt
from repro_torch.optim.optimizers import OPTIMIZERS, OptimizerConfig


def build_exchange_config(args) -> ExchangeConfig:
    """CLI flags -> ExchangeConfig.  ``--compression`` int8 / int4 is the
    reference's quantizer (bucket 512, s = 15 for int8 and s = 5 for int4,
    uniform levels): qgenx's, or layerwise's low-bit one for large leaves.
    qgenx with ``--compression none`` is the exact f32 control (compressor
    none).  A pair that contradicts itself raises ``ValueError``:
    ``--compressor none`` with a quantizer, or layerwise without one."""
    if args.compressor == "none" and args.compression != "none":
        raise ValueError(f"--compressor none sends f32: drop --compression "
                         f"{args.compression}")
    if args.compressor == "layerwise" and args.compression == "none":
        raise ValueError("--compressor layerwise needs --compression int8 or int4 "
                         "(its quantizer for leaves above the threshold)")
    if args.compression == "none":
        return ExchangeConfig(compressor="none", mode=args.compress_mode)
    bits = 8 if args.compression == "int8" else 4
    quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=512)
    return ExchangeConfig(compressor=args.compressor, quant=quant, mode=args.compress_mode)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", help="smoke-size model")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="parameter dtype of the layer stack (embeddings stay f32)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8, help="global batch (all workers)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4, help="adam family learning rate")
    ap.add_argument("--optimizer", default="extra_adam", choices=OPTIMIZERS)
    ap.add_argument("--method", default="de", choices=("de", "optda"),
                    help="qgenx oracle schedule")
    ap.add_argument("--gamma-scale", type=float, default=0.02)
    ap.add_argument("--compression", default="none", choices=("none", "int8", "int4"))
    ap.add_argument("--compressor", default="qgenx", choices=COMPRESSORS)
    ap.add_argument("--compress-mode", default="two_phase", choices=("two_phase", "gather"))
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    return ap


def _init_distributed(device: torch.device):
    """(comm, rank, world, device) — torchrun's env when WORLD_SIZE > 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return SingleWorker(), 0, 1, device
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=rank, world_size=world)
    return ProcessGroupComm(), rank, world, device


def run(args, log=print, exchange: Optional[ExchangeConfig] = None) -> dict:
    """Train per ``args``; returns ``{"loss": [...], "wire_bytes": [...],
    "step_s": [...]}`` (one entry per step, replicated over workers).
    ``exchange`` replaces the exchange config the flags give (for fields
    that have no flag, such as ``use_device_prng``)."""
    device = resolve_device(args.device)
    comm, rank, world, device = _init_distributed(device)
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
        if args.batch % world:
            raise ValueError(f"--batch {args.batch} does not split over {world} workers")
        model = build(cfg, seed=args.seed, device=device)
        opt_cfg = OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  gamma_scale=args.gamma_scale, method=args.method)
        opt_state = opt.init_state(opt_cfg, model.param_leaves())
        ex = make_exchange(exchange or build_exchange_config(args), comm)
        ex_state = ex.init_state(device)
        step_fn = make_train_step(model, opt_cfg, ex)
        noise = GeneratorNoise.seeded((args.seed << 16) + rank, device)
        pipe = make_pipeline(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
        rows = slice(rank * args.batch // world, (rank + 1) * args.batch // world)
        if rank == 0:
            log(f"[train] arch={cfg.name} params={cfg.param_count()} dtype={cfg.dtype} "
                f"device={device} workers={world} optimizer={args.optimizer} "
                + (f"method={args.method} " if args.optimizer == "qgenx" else "")
                + f"compressor={ex.cfg.compressor} compression={args.compression} "
                f"mode={ex.cfg.mode}")
        out = {"loss": [], "wire_bytes": [], "step_s": []}
        for step in range(args.steps):
            batch = to_device(next(pipe), device, rows)
            t0 = time.perf_counter()
            opt_state, ex_state, metrics = step_fn(opt_state, ex_state, batch, noise)
            loss = float(metrics["loss"])  # waits for the step's device work
            dt = time.perf_counter() - t0
            out["loss"].append(loss)
            out["wire_bytes"].append(float(metrics["wire_bytes"]))
            out["step_s"].append(dt)
            if rank == 0 and (step % args.log_every == 0 or step == args.steps - 1):
                log(f"[train] step={step} loss={loss:.4f} dt={dt * 1e3:.0f}ms "
                    f"wire={metrics['wire_bytes']:.3e}B")
        return out
    finally:
        if world > 1:
            dist.destroy_process_group()


def main(argv=None):
    out = run(parser().parse_args(argv))
    print(f"[train] done. final_loss={out['loss'][-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
