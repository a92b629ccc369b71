"""End-to-end training entry point of the port (``python -m repro_torch.launch.train``).

Trains a decoder (``--arch`` tinyllama-1.1b, gemma-2b, qwen3-4b,
gemma3-27b, the mixture-of-experts llama4-maverick-400b-a17b or the VLM
internvl2-26b, whose batches carry the stubbed image embeddings of
:func:`~repro_torch.data.pipeline.add_modality_stubs`, seeded with
``--seed``) with ExtraAdam (the default, as in the reference
CLI), Adam, optimistic Adam or the paper's adaptive Q-GenX optimizer, and
the gradient exchange (``--compressor`` any name of the registry: qgenx,
layerwise, none, randk, ef21-topk, ef-randk; ``--rand-frac`` /
``--ef-topk-frac`` set the sparse ones' share), on ``cuda`` (default)
or, when asked, ``--device cpu``.  One process is one worker; for K > 1
workers launch it under ``torchrun`` (NCCL on the card, gloo on the
CPU), which sets the rank and world size read here::

    python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced \\
        --steps 20 --batch 8 --seq 128 --compression int8
    python -m repro_torch.launch.train --reduced --optimizer qgenx --method optda \\
        --compression int8
    python -m repro_torch.launch.train --arch qwen3-4b --reduced --device cpu \\
        --optimizer qgenx --compression int8
    python -m repro_torch.launch.train --arch llama4-maverick-400b-a17b --reduced \\
        --device cpu --optimizer qgenx --compression int8
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduced --compression int4 --compressor layerwise
    python -m repro_torch.launch.train --reduced --optimizer qgenx \\
        --compressor ef21-topk --ef-topk-frac 0.25

Unlike the reference CLI, the exchange runs at K = 1 too whenever there is
something to compress (the world-size-1 communicator), so one card drives
every exchange kernel.  As in the reference, no flag selects the
device-PRNG exchange: a caller of :func:`run` passes
``exchange=ExchangeConfig(..., use_device_prng=True)``.

``--compress-mode leafwise`` quantizes each gradient leaf in rows over its
trailing dim (``allreduce_fallback`` is config-only, as in the
reference), ``--no-exchange-plan`` takes the per-call layout, and
``--num-buckets B --overlap bucketed|defer_tail`` the bucketed exchange
(:mod:`repro_torch.core.exchange`); the exchange line prints ``plan=
num_buckets= overlap=``::

    python -m repro_torch.launch.train --reduced --device cpu --optimizer qgenx \
        --compression int8 --num-buckets 3 --overlap defer_tail

``--sync-every`` / ``--recenter-every`` set the local-update regime
(:mod:`repro_torch.launch.steps`); step lines then add ``drift=`` and,
for qgenx, ``coded_bits=`` (the Theorem 2 estimate).
``--level-schedule qada --level-update-every N`` refreshes the level
tables by QAda every N exchange calls (a period is required); the run
ends by printing the final table, and :func:`run` returns it.  ``--checkpoint-dir``
with ``--checkpoint-every`` saves every N steps and at the end, in the
reference's format (:mod:`repro_torch.checkpoint.checkpointing`: a
checkpoint of either package resumes in the other); a run whose
directory holds a checkpoint resumes from the newest intact one, and
exits 2 with a diagnosis when none is intact or its trees do not match
this run (``--allow-ckpt-reset`` keeps a fresh ``ex_state`` instead).  At
K > 1 rank 0 writes behind a barrier and every rank reads.  Each step's
noise comes from a generator seeded from (seed, rank, step), so a resumed
run draws the noise the uninterrupted run draws.  ``--repeat-batch``
trains every step on the first batch the run draws.

``--guard`` arms the non-finite step guard (:mod:`repro_torch.launch.steps`)
and a :class:`~repro_torch.core.faults.Watchdog`: after each good step it
keeps a host snapshot of the state, and after ``--rollback-after``
consecutive rejected steps (or half of a trailing window of 4 x that)
it rolls the run back to it.  ``--fault-spec`` schedules faults
(:mod:`repro_torch.core.faults`, scope ``train``: ``nan_grad``, ``drop``,
``wire_corrupt`` inside the step, keyed on the loop's step, and the
``ckpt_*`` kinds applied to the checkpoint saved at a step); a bad spec
exits 2.  Rejected steps log `` REJECTED``, steps with a dropped worker
`` alive=a/K``, and a guarded run ends with ``[train] guard: ...``::

    python -m repro_torch.launch.train --reduced --device cpu --optimizer qgenx \
        --compression int8 --steps 6 --guard --rollback-after 2 \
        --fault-spec "nan_grad@1;wire_corrupt@3-4"
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import checkpointing
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core import faults
from repro_torch.core.exchange import (
    ExchangeConfig,
    ProcessGroupComm,
    SingleWorker,
    make_exchange,
    registered_compressors,
)
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.tree import tree_flatten
from repro_torch.data.pipeline import add_modality_stubs, make_pipeline, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import optimizers as opt
from repro_torch.optim import qgenx as qgenx_opt
from repro_torch.optim.optimizers import OPTIMIZERS, OptimizerConfig


def build_exchange_config(args) -> ExchangeConfig:
    """CLI flags -> ExchangeConfig.  ``--compression`` int8 / int4 is the
    reference's quantizer (bucket 512, s = 15 for int8 and s = 5 for int4,
    uniform levels): qgenx's, or layerwise's low-bit one for large leaves.
    qgenx with ``--compression none`` is the exact f32 control (compressor
    none).  The sparse compressors (randk, ef21-topk, ef-randk) send f32
    values and take ``--rand-frac`` / ``--ef-topk-frac``; a quantizer,
    when given, rides along unused, as in the reference.  A pair that
    contradicts itself raises ``ValueError``: ``--compressor none`` with
    a quantizer, or layerwise without one."""
    if args.compressor == "none" and args.compression != "none":
        raise ValueError(f"--compressor none sends f32: drop --compression "
                         f"{args.compression}")
    if args.compressor == "layerwise" and args.compression == "none":
        raise ValueError("--compressor layerwise needs --compression int8 or int4 "
                         "(its quantizer for leaves above the threshold)")
    quant = None
    if args.compression != "none":
        bits = 8 if args.compression == "int8" else 4
        quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=512)
    compressor = "none" if args.compressor == "qgenx" and quant is None else args.compressor
    return ExchangeConfig(compressor=compressor, quant=quant, mode=args.compress_mode,
                          sync_every=args.sync_every, recenter_every=args.recenter_every,
                          level_schedule=args.level_schedule,
                          level_update_every=args.level_update_every,
                          rand_frac=args.rand_frac, ef_topk_frac=args.ef_topk_frac,
                          use_plan=not args.no_exchange_plan,
                          num_buckets=args.num_buckets, overlap=args.overlap)


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
    ap.add_argument("--compressor", default="qgenx", choices=registered_compressors())
    ap.add_argument("--compress-mode", default="two_phase",
                    choices=("two_phase", "gather", "leafwise"))
    ap.add_argument("--no-exchange-plan", action="store_true",
                    help="escape hatch: per-call exchange layout instead of the static "
                         "ExchangePlan flat buffer (bit-exact for qgenx/layerwise pmean "
                         "either way)")
    ap.add_argument("--num-buckets", type=int, default=1,
                    help="bucketed overlapped exchange: split the gradient into this many "
                         "contiguous layer-ordered buckets, each an independent "
                         "quantize+collective chain whose last collectives overlap the next "
                         "bucket's kernels (1 = monolithic; requires --overlap)")
    ap.add_argument("--overlap", default="off", choices=("off", "bucketed", "defer_tail"),
                    help="off = monolithic exchange; bucketed = per-bucket chains issued in "
                         "backprop order within the step; defer_tail = additionally "
                         "double-buffer the tail bucket (first layers): its mean is carried "
                         "in ExchangeState.pending and applied one sync late")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="local-update regime: K local steps between exchanges "
                         "(1 = exchange every step)")
    ap.add_argument("--recenter-every", type=int, default=0,
                    help="re-center the iterates through the exchange every R-th "
                         "step (0 = never)")
    ap.add_argument("--level-schedule", default="fixed", choices=("fixed", "qada"))
    ap.add_argument("--level-update-every", type=int, default=0,
                    help="QAda refresh period in exchange calls (qada schedule)")
    ap.add_argument("--rand-frac", type=float, default=0.25,
                    help="randk / ef-randk: fraction of coordinates kept per worker")
    ap.add_argument("--ef-topk-frac", type=float, default=0.25,
                    help="ef21-topk: fraction of innovation coordinates each worker ships")
    ap.add_argument("--guard", action="store_true",
                    help="arm the non-finite step guard (a rejected step leaves the "
                         "state as it was) and a watchdog that rolls back to the last "
                         "good snapshot")
    ap.add_argument("--rollback-after", type=int, default=3,
                    help="watchdog: roll back after this many CONSECUTIVE rejected steps "
                         "(a >=50%% rejection rate over a 4x window also triggers)")
    faults.add_fault_spec_flag(ap, scope="train")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--allow-ckpt-reset", action="store_true",
                    help="on restore, reset an incompatible ex_state to fresh init "
                         "instead of exiting; params/opt_state mismatches always exit")
    ap.add_argument("--repeat-batch", action="store_true",
                    help="train on one repeated batch (fast-convergence tests)")
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


def step_noise(seed: int, rank: int, step: int, device) -> GeneratorNoise:
    """The noise source of one step of one worker: a generator seeded from
    (seed, rank, step), so a run resumed at any step draws what the
    uninterrupted run draws."""
    s = np.random.SeedSequence([seed, rank, step]).generate_state(1, np.uint64)[0]
    return GeneratorNoise.seeded(int(s), device)


def state_trees(model, opt_state, ex_state) -> dict:
    """The run's state as the named trees a checkpoint holds, in the
    reference's structure (the tensors themselves)."""
    return {"params": convert.params_tree(model),
            "opt_state": convert.opt_state_tree(opt_state, model),
            "ex_state": ex_state}


def _save(path: str, step: int, model, opt_state, ex_state, rank: int, world: int,
          spec: faults.FaultSpec, log) -> dict:
    """Rank 0 writes (then applies the checkpoint faults ``spec`` names for
    ``step``), the others wait at a barrier; ``{"step", "bytes",
    "seconds"}`` (bytes 0 on the other ranks)."""
    t0 = time.perf_counter()
    info = {"bytes": 0}
    if rank == 0:
        info = checkpointing.save(path, step, state_trees(model, opt_state, ex_state))
    if world > 1:
        dist.barrier()
    out = {"step": step, "bytes": info["bytes"], "seconds": time.perf_counter() - t0}
    if rank == 0:
        for kind in spec.ckpt_faults_at(step):
            faults.inject_ckpt_fault(path, step, kind)
            log(f"[train] fault: injected {kind} into checkpoint {step}")
    return out


@torch.no_grad()
def restore_checkpoint(args, model, opt_state, ex_state, device, log=print):
    """Restore the newest intact checkpoint of ``args.checkpoint_dir`` into
    ``model``; returns ``(opt_state, ex_state, {"step", "bytes",
    "seconds"})``.  Exits 2 with a diagnosis when no checkpoint is intact
    or its trees do not match this run's."""
    t0 = time.perf_counter()
    templates = state_trees(model, opt_state, ex_state)
    allow = ("ex_state",) if args.allow_ckpt_reset else ()
    try:
        step, trees, reset = checkpointing.restore_with_fallback(
            args.checkpoint_dir, templates, allow_reset=allow)
    except checkpointing.CheckpointStructureError as e:
        print(f"[train] checkpoint tree {e.tree!r} does not match this run's state: "
              f"{e.detail}", file=sys.stderr)
        print("[train] pass --allow-ckpt-reset to reset incompatible auxiliary state "
              "(ex_state), or fix the run config to match the checkpoint", file=sys.stderr)
        raise SystemExit(2)
    except checkpointing.CheckpointCorruptError as e:
        print(f"[train] no intact checkpoint at {args.checkpoint_dir}: {e}", file=sys.stderr)
        raise SystemExit(2)
    for p, v in zip(tree_flatten(templates["params"])[0], tree_flatten(trees["params"])[0]):
        p.copy_(v)
    opt_state = convert.opt_state_from_jax(trees["opt_state"], type(opt_state), device)
    if "ex_state" in trees:
        ex_state = convert.ex_state_from_jax(trees["ex_state"], device)
    for name in reset:
        log(f"[train] checkpoint {name} incompatible with this run's config; reset to "
            f"fresh init (--allow-ckpt-reset)")
    nbytes = sum(os.path.getsize(os.path.join(args.checkpoint_dir, f"ckpt_{step}.{ext}"))
                 for ext in ("npz", "meta"))
    info = {"step": step, "bytes": nbytes, "seconds": time.perf_counter() - t0}
    log(f"[train] restored step {step}")
    return opt_state, ex_state, info


def _rollback(watchdog: faults.Watchdog, model, device):
    """Restore the watchdog's snapshot: the params in place, the optimizer
    and exchange states as new device copies; ``(snapshot step, opt_state,
    ex_state)``."""
    snap_step, trees = watchdog.rollback(device)
    with torch.no_grad():
        for p, v in zip(model.param_leaves(), trees["params"]):
            p.copy_(v)
    return snap_step, trees["opt_state"], trees["ex_state"]


def run(args, log=print, exchange: Optional[ExchangeConfig] = None,
        config: Optional[ModelConfig] = None, on_step=None) -> dict:
    """Train per ``args``; returns, one entry per step run (replicated over
    workers), ``loss``, ``wire_bytes``, ``param_drift``,
    ``coded_bits_est``, ``rejected``, ``nonfinite``, ``alive`` and
    ``step_s``, with ``start_step`` (the restored
    step, else 0), ``restored`` (the restore's step, checkpoint bytes and
    seconds, or None), ``saves`` (each save's step, bytes and
    seconds), ``levels`` (the final primary level table as a list,
    None for a compressor without one), ``ex_state`` (the final
    exchange state, with the contractive tier's error memory) and, under
    ``--guard``, ``guard`` (the watchdog's ``nonfinite_steps``,
    ``rejected`` and ``rollbacks`` counts), ``snapshots`` (each
    snapshot's step, bytes and seconds) and ``rollbacks`` (each
    rollback's loop step, the snapshot's step and seconds).
    ``exchange`` replaces the exchange config the flags give
    (for fields that have no flag, such as ``use_device_prng``);
    ``config`` replaces the model config of ``--arch`` / ``--reduced``
    (``--dtype`` still applies); ``on_step(step, model, opt_state,
    ex_state, metrics)``, when given, is called after each step once the
    watchdog has acted."""
    device = resolve_device(args.device)
    spec = faults.parse_fault_spec_arg(args.fault_spec, scope="train")
    comm, rank, world, device = _init_distributed(device)
    try:
        cfg = config or get_config(args.arch)
        if args.reduced and config is None:
            cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
        if args.batch % world:
            raise ValueError(f"--batch {args.batch} does not split over {world} workers")
        model = build(cfg, seed=args.seed, device=device)
        opt_cfg = OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  gamma_scale=args.gamma_scale, method=args.method)
        opt_state = opt.init_state(opt_cfg, model.param_leaves())
        ex = make_exchange(exchange or build_exchange_config(args), comm)
        # the template and K size a contractive compressor's error memory
        ex_state = ex.init_state(device, template=model.param_leaves(), num_workers=world)
        step_fn = make_train_step(model, opt_cfg, ex, guard=args.guard,
                                  fault_spec=spec if spec.events else None)
        watchdog = faults.Watchdog(args.rollback_after) if args.guard else None
        say = log if rank == 0 else (lambda m: None)
        pipe = make_pipeline(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
        rows = slice(rank * args.batch // world, (rank + 1) * args.batch // world)
        say(f"[train] arch={cfg.name} params={cfg.param_count()} dtype={cfg.dtype} "
            f"device={device} workers={world} optimizer={args.optimizer} "
            + (f"method={args.method} " if args.optimizer == "qgenx" else "")
            + f"compressor={ex.cfg.compressor} compression={args.compression} "
            f"mode={ex.cfg.mode} sync_every={ex.cfg.sync_every} "
            f"recenter_every={ex.cfg.recenter_every} "
            f"level_schedule={ex.cfg.level_schedule} plan={ex.cfg.use_plan} "
            f"num_buckets={ex.cfg.num_buckets} overlap={ex.cfg.overlap}")
        if spec.events:
            say(f"[train] fault schedule: {args.fault_spec}")
            if spec.has_device_events and not args.guard:
                say("[train] WARNING: device faults scheduled without --guard "
                    "— non-finite steps will NOT be rejected")
        out = {"loss": [], "wire_bytes": [], "param_drift": [], "coded_bits_est": [],
               "rejected": [], "nonfinite": [], "alive": [],
               "step_s": [], "start_step": 0, "restored": None, "saves": [],
               "guard": None, "snapshots": [], "rollbacks": []}
        ckpt = args.checkpoint_dir
        if ckpt and (checkpointing.latest_step(ckpt) is not None
                     or checkpointing.available_steps(ckpt)):
            opt_state, ex_state, out["restored"] = restore_checkpoint(
                args, model, opt_state, ex_state, device, say)
            out["start_step"] = out["restored"]["step"]
            pipe.restore({"step": out["start_step"], "seed": args.seed})
        def next_batch():
            # a VLM's image embeddings: the same seeded draw every step, as
            # in the reference
            return to_device(add_modality_stubs(next(pipe), cfg, seed=args.seed), device, rows)

        fixed = next_batch() if args.repeat_batch else None
        for step in range(out["start_step"], args.steps):
            batch = fixed if fixed is not None else next_batch()
            noise = step_noise(args.seed, rank, step, device)
            t0 = time.perf_counter()
            # the fault schedule is keyed on the loop's step, not the optimizer's
            # count (a rejected step does not advance it)
            opt_state, ex_state, metrics = step_fn(opt_state, ex_state, batch, noise,
                                                   fault_step=step)
            loss = float(metrics["loss"])  # waits for the step's device work
            dt = time.perf_counter() - t0
            drift = float(metrics["param_drift"])
            coded = float(metrics["coded_bits_est"])
            rejected = bool(metrics["rejected"])
            out["loss"].append(loss)
            out["wire_bytes"].append(float(metrics["wire_bytes"]))
            out["param_drift"].append(drift)
            out["coded_bits_est"].append(coded)
            for k in ("rejected", "nonfinite", "alive"):
                out[k].append(metrics[k])
            out["step_s"].append(dt)
            if watchdog is not None:
                if watchdog.observe(step, rejected, bool(metrics["nonfinite"])):
                    if isinstance(opt_state, qgenx_opt.QGenXOptState):
                        say(f"[train] watchdog: optimizer stats at rollback "
                            f"{qgenx_opt.state_norms(opt_state)}")
                    t1 = time.perf_counter()
                    opt_state = ex_state = None  # free the device state first
                    snap, opt_state, ex_state = _rollback(watchdog, model, device)
                    out["rollbacks"].append({"step": step, "to_step": snap,
                                             "seconds": time.perf_counter() - t1})
                    say(f"[train] watchdog: rolled back to the step-{snap} snapshot "
                        f"({watchdog.summary()})")
                elif not rejected:
                    t1 = time.perf_counter()
                    watchdog.record_good(step + 1, {"params": model.param_leaves(),
                                                    "opt_state": opt_state,
                                                    "ex_state": ex_state})
                    out["snapshots"].append({"step": step + 1,
                                             "bytes": watchdog.snapshot_bytes,
                                             "seconds": time.perf_counter() - t1})
            if step % args.log_every == 0 or step == args.steps - 1:
                tail = f" drift={drift:.3e}" if ex.cfg.sync_every > 1 else ""
                if coded:
                    tail += f" coded_bits={coded:.3e}"
                if rejected:
                    tail += " REJECTED"
                if metrics["alive"] != world:
                    tail += f" alive={metrics['alive']:.0f}/{world}"
                say(f"[train] step={step} loss={loss:.4f} dt={dt * 1e3:.0f}ms "
                    f"wire={metrics['wire_bytes']:.3e}B{tail}")
            if on_step is not None:
                on_step(step, model, opt_state, ex_state, metrics)
            if ckpt and args.checkpoint_every and (step + 1) % args.checkpoint_every == 0:
                out["saves"].append(_save(ckpt, step + 1, model, opt_state, ex_state,
                                          rank, world, spec, say))
        # no step ran (restored at or past --steps): save nothing, or the
        # 'latest' pointer would move below the restored step
        if ckpt and out["step_s"]:
            out["saves"].append(_save(ckpt, args.steps, model, opt_state, ex_state,
                                      rank, world, spec, say))
        if watchdog is not None:
            out["guard"] = {"nonfinite_steps": watchdog.nonfinite_steps,
                            "rejected": watchdog.rejected_steps,
                            "rollbacks": watchdog.rollbacks}
            say(f"[train] guard: {watchdog.summary()}")
        out["levels"] = ex_state.levels.tolist() if ex.compressor.has_levels else None
        out["ex_state"] = ex_state
        if ex.cfg.level_schedule == "qada" and out["levels"] is not None:
            say(f"[train] qada levels={np.round(np.asarray(out['levels']), 4)}")
        return out
    finally:
        if world > 1:
            dist.destroy_process_group()


def main(argv=None):
    args = parser().parse_args(argv)
    out = run(args)
    times = out["step_s"]
    if not times:
        print(f"[train] done. no steps run (restored step {out['start_step']} >= "
              f"--steps {args.steps})")
        return out
    rest = sorted(times[1:])
    med = rest[len(rest) // 2] if rest else times[0]
    print(f"[train] done. final_loss={out['loss'][-1]:.4f} median_step={med * 1e3:.0f}ms")
    return out


if __name__ == "__main__":
    main()
