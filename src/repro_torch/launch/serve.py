"""Serving entry point of the port (``python -m repro_torch.launch.serve``): the
paged quantized KV-cache and continuous batching
(:class:`repro_torch.serve.engine.ServeEngine`), printing the reference
CLI's lines.

A paged arena stores K/V through the paper's unbiased quantizer
(``--kv-bits 8|4|32|mixed``; every write launches kernel 1, every read
kernel 3 on the card), the scheduler admits requests into freed slots
mid-decode and retires them when their budget is spent, and one decode
step runs over the packed batch::

    python -m repro_torch.launch.serve --reduced --kv-bits 8 --device cpu
    python -m repro_torch.launch.serve --reduced --kv-bits 4 --batch 4 \\
        --requests 12 --prompt-len 16 --gen 16 --device cpu
    python -m repro_torch.launch.serve --arch gemma3-27b --reduced --kv-bits mixed \\
        --device cpu
    python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b --reduced \\
        --kv-bits mixed --device cpu
    # serve the params of a checkpoint written by either train CLI
    python -m repro_torch.launch.serve --reduced --restore /tmp/ckpt --device cpu
    # hardened: decode guard + quarantine, deadlines, crash-safe snapshots
    python -m repro_torch.launch.serve --reduced --guard --deadline-ms 5000 \\
        --snapshot-dir /tmp/serve_snap --snapshot-every 4 --device cpu
    # deterministic fault drill (the train CLI's grammar, serve kinds)
    python -m repro_torch.launch.serve --reduced --guard \\
        --fault-spec 'nan_logits@5:slot=2;slot_drop@8' --device cpu
    # K = 2 ranks: per-rank quantization noise, logits averaged through the
    # Exchange (wire accounting on)
    torchrun --nproc-per-node 2 --master-addr 127.0.0.1 --master-port 29533 \\
        -m repro_torch.launch.serve --reduced --device cpu --logit-exchange int8

How it differs from the reference CLI:

* ``--arch`` offers the ported configs only (tinyllama-1.1b, gemma-2b,
  qwen3-4b, gemma3-27b, llama4-maverick-400b-a17b, internvl2-26b) and
  defaults to tinyllama-1.1b, where the reference defaults to gemma-2b;
  ``--device`` picks the device (cuda by default; ``cpu`` when asked).
  ``--kv-bits mixed`` stores gemma3's local-window layers and llama4's
  chunk-local layers int4 and their global layers int8.  internvl2 is
  served by its tokens alone (no image prefix), as the reference's
  ``prefill_paged`` serves it.
* ``--host-devices`` and ``--compilation-cache-dir`` are XLA-only and
  unknown here.  K > 1 runs as one process per rank under ``torchrun``;
  the logit exchange is built only when the process group has more than
  one rank, as the reference builds it only with more than one device.
* The dense ``decode_step`` fallback (``_serve_dense``) serves only
  architectures the port does not have yet; a config without a paged
  cache raises ``ValueError``, as ``ServeEngine`` does.
* Weights and the synthetic workload come from the port's own seeded
  generators (``torch.Generator``, numpy), not ``jax.random``: the lines
  are the reference's, the token values are not.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import checkpointing
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core import faults
from repro_torch.core.exchange import ExchangeConfig, make_exchange
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.retry import BackoffPolicy
from repro_torch.core.tree import tree_flatten
from repro_torch.device import resolve_device
from repro_torch.launch.train import _init_distributed
from repro_torch.models import transformer
from repro_torch.models.model import build
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request


@torch.no_grad()
def _restore_params(model, cfg, args):
    """Copy the params of ``--restore`` (a checkpoint of either train CLI)
    into ``model``; exits 2 on a structure mismatch or no intact step."""
    if not args.restore:
        return model
    template = {"params": convert.params_tree(model)}
    try:
        step, trees, _ = checkpointing.restore_with_fallback(args.restore, template)
    except checkpointing.CheckpointStructureError as e:
        print(f"[serve] checkpoint params do not match arch {cfg.name!r}: {e.detail}",
              file=sys.stderr)
        raise SystemExit(2)
    except checkpointing.CheckpointCorruptError as e:
        print(f"[serve] no intact checkpoint at {args.restore}: {e}", file=sys.stderr)
        raise SystemExit(2)
    for dst, src in zip(tree_flatten(template["params"])[0],
                        tree_flatten(trees["params"])[0]):
        dst.copy_(src)
    print(f"[serve] restored params from {args.restore} @ step {step}")
    return model


def _parse_workload_file(path, cfg):
    """One request per line, ``TOKEN[,TOKEN...]|MAX_NEW[|DEADLINE]`` (blank
    lines and ``#`` comments skipped).  A malformed line exits 2 with a
    message naming it."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        print(f"[serve] cannot read workload file {path}: {e}", file=sys.stderr)
        raise SystemExit(2)
    reqs = []
    for ln, raw in enumerate(lines, 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue

        def die(msg):
            print(f"[serve] bad request line {ln} in {path}: {msg} "
                  f"(got {raw!r}; expected 'TOKEN[,TOKEN...]|MAX_NEW"
                  f"[|DEADLINE]')", file=sys.stderr)
            raise SystemExit(2)

        parts = line.split("|")
        if len(parts) not in (2, 3):
            die(f"expected 2 or 3 '|'-separated fields, got {len(parts)}")
        try:
            prompt = [int(t) for t in parts[0].replace(",", " ").split()]
        except ValueError:
            die("prompt tokens must be integers")
        if not prompt:
            die("empty prompt")
        bad = [t for t in prompt if not 0 <= t < cfg.vocab_size]
        if bad:
            die(f"token {bad[0]} outside vocab [0, {cfg.vocab_size})")
        try:
            max_new = int(parts[1])
        except ValueError:
            die(f"max_new {parts[1]!r} must be an integer")
        if max_new < 1:
            die(f"max_new must be >= 1, got {max_new}")
        deadline = None
        if len(parts) == 3 and parts[2].strip():
            try:
                deadline = float(parts[2])
            except ValueError:
                die(f"deadline {parts[2]!r} must be a number")
        reqs.append(Request(rid=len(reqs), prompt=prompt, max_new=max_new,
                            deadline=deadline))
    if not reqs:
        print(f"[serve] workload file {path} contains no requests", file=sys.stderr)
        raise SystemExit(2)
    return reqs


def _workload(args, cfg):
    """Staggered request mix (budgets differ so sequences retire at
    different waves, opening slots for mid-decode admission); prompts from
    ``numpy.random.default_rng([seed, rid])``.  ``--requests`` also takes
    a workload FILE (:func:`_parse_workload_file`)."""
    spec = args.requests.strip()
    if spec and not spec.lstrip("-").isdigit():
        return _parse_workload_file(spec, cfg)
    n = int(spec) if spec else 0
    if n < 0:
        print(f"[serve] --requests must be >= 0 or a workload file, got {n}",
              file=sys.stderr)
        raise SystemExit(2)
    n = n or 2 * args.batch
    reqs = []
    for r in range(n):
        plen = max(1, args.prompt_len - (r % 3))
        prompt = np.random.default_rng([args.seed, r]).integers(
            0, cfg.vocab_size, plen).tolist()
        reqs.append(Request(rid=r, prompt=prompt, max_new=max(1, args.gen - 2 * (r % 3))))
    return reqs


def _print_resume(info):
    print(f"[serve] resumed from snapshot step {info['step']}: "
          f"in_flight={info['in_flight']} waiting={info['waiting']} "
          f"done={info['done']}", flush=True)
    for rid, n in sorted(info["committed"].items()):
        print(f"[serve]   resume rid={rid} committed={n}", flush=True)


def _run_with_recovery(eng, reqs, args, events):
    """Host watchdog around the decode loop: on an engine failure, roll the
    engine back to the last intact snapshot (every in-flight request
    resubmitted from its last committed token) and continue, with bounded
    jittered backoff between restarts.  Without ``--snapshot-dir`` the
    failure propagates."""
    pending = reqs
    if args.snapshot_dir and checkpointing.available_steps(args.snapshot_dir):
        try:
            info = eng.restore_serve(args.snapshot_dir)
        except checkpointing.CheckpointStructureError as e:
            print(f"[serve] snapshot at {args.snapshot_dir} does not match this engine: {e}",
                  file=sys.stderr)
            raise SystemExit(2)
        except checkpointing.CheckpointCorruptError as e:
            print(f"[serve] no intact snapshot at {args.snapshot_dir} ({e}); "
                  "starting fresh", flush=True)
        else:
            _print_resume(info)
            pending = []  # the snapshot is authoritative over the workload
    policy = BackoffPolicy(base=0.2, factor=2.0, cap=2.0,
                           max_attempts=args.restart_retries, jitter=0.5)
    attempt = 0
    while True:
        try:
            return eng.run(pending, events=events)
        except (SystemExit, KeyboardInterrupt):
            raise
        except Exception as e:
            can_restart = bool(args.snapshot_dir
                               and checkpointing.available_steps(args.snapshot_dir))
            if not can_restart or attempt >= policy.max_attempts:
                raise
            delay = policy.delay(attempt, token=args.seed)
            attempt += 1
            print(f"[serve] watchdog: engine failed ({type(e).__name__}: {e}); restart "
                  f"{attempt}/{policy.max_attempts} from last snapshot in {delay:.2f}s",
                  flush=True)
            time.sleep(delay)
            info = eng.restore_serve(args.snapshot_dir)
            _print_resume(info)
            pending = []


def logit_exchange_config(name: str):
    """The logit exchange of ``--logit-exchange`` (None for ``off``)."""
    if name == "off":
        return None
    if name == "fp32":
        return ExchangeConfig(compressor="none")
    bits = int(name.replace("int", ""))
    return ExchangeConfig(
        compressor="qgenx",
        quant=QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=512),
        mode="two_phase")


def _serve_paged(args, cfg, model, comm, say=print) -> dict:
    """Serve the workload; returns {"out", "engine", "events", "wall_s"}."""
    max_len = args.prompt_len + args.gen
    policy = {"32": "fp32", "8": "int8", "4": "int4"}.get(args.kv_bits, args.kv_bits)
    exchange = None
    if comm.size > 1:
        cfg_ex = logit_exchange_config(args.logit_exchange)
        if cfg_ex is not None:
            exchange = make_exchange(cfg_ex, comm)
    spec = faults.parse_fault_spec_arg(args.fault_spec, scope="serve")
    if spec.events:
        say(f"[serve] fault schedule: {args.fault_spec}")
        if spec.has_serve_device_events and not args.guard:
            say("[serve] WARNING: nan_logits scheduled without --guard "
                "— poisoned slots will NOT be rejected")
    robust = bool(args.guard or spec.events or args.snapshot_dir
                  or args.deadline_ms or args.max_queue)
    # with wall-clock deadlines the scheduler clock (and the deadline /
    # backoff units) switch from decode-wave index to monotonic ms
    clock = (lambda: time.monotonic() * 1e3) if args.deadline_ms else None
    eng = ServeEngine(
        cfg, model, policy=policy, page_size=args.page_size,
        n_slots=args.batch, max_len=max_len, num_pages=args.num_pages,
        seed=args.seed, exchange=exchange,
        guard=args.guard, guard_retries=args.guard_retries,
        fault_spec=spec if spec.events else None,
        snapshot_dir=args.snapshot_dir, snapshot_every=args.snapshot_every,
        max_queue=args.max_queue, low_watermark=args.shed_watermark,
        deadline_default=args.deadline_ms or None, clock=clock,
    )
    reqs = _workload(args, cfg)
    say(f"[serve] arch={cfg.name} slots={args.batch} requests={len(reqs)} "
        f"kv={policy} {eng.pc.describe()}"
        + (f" guard=on retries={args.guard_retries}" if args.guard else ""))

    events: list = []
    t0 = time.time()
    out = _run_with_recovery(eng, reqs, args, events)
    wall = time.time() - t0

    for kind, rid, slot, step in events:
        where = f"slot {slot}" if kind != "retire" else "freed pages"
        say(f"[serve]   step {step:3d} {kind:18s} request {rid} ({where})")
    st = eng.sched.stats
    n_tok = sum(len(v) for v in out.values())
    say(f"[serve] admitted={st['admitted']} retired={st['retired']} "
        f"mid_decode_admits={st['mid_decode_admits']} "
        f"max_concurrent={st['max_concurrent']}")
    say(f"[serve] {n_tok} tokens in {wall*1e3:.0f}ms "
        f"({n_tok/max(wall, 1e-9):.1f} tok/s, "
        f"{eng.sched.decode_steps} packed decode steps)")
    ratio = eng.fp32_cache_bytes / eng.cache_bytes
    say(f"[serve] cache {eng.cache_bytes} B vs fp32 {eng.fp32_cache_bytes} B "
        f"({ratio:.2f}x smaller)")
    if exchange is not None:
        say(f"[serve] logit exchange over {eng.K} devices: "
            f"wire={eng.wire_bytes:.0f} B "
            f"({eng.wire_per_step:.0f} B/step), "
            f"coded_bits_est={eng.coded_bits:.0f}")
    if robust:
        for rr in sorted(eng.results().values(), key=lambda r: r.rid):
            say(f"[serve] result rid={rr.rid} kind={rr.kind} tokens={len(rr.tokens)}")
        say(f"[serve] guard_retries={st.get('guard_retries', 0)} "
            f"evicted={st.get('evicted', 0)} "
            f"shed_transient={st.get('shed_transient', 0)} "
            f"page_pressure={eng.sched.page_pressure:.2f}")
        say(f"[serve] pages free={eng.allocator.n_free}/{eng.allocator.num_pages}")
    if out:
        sample = out[min(out)]
        say(f"[serve] sample tokens: {sample[:12]}")
    return {"out": out, "engine": eng, "events": events, "wall_s": wall}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="packed decode slots")
    ap.add_argument("--requests", default="0",
                    help="requests to serve: a count (default 2x --batch) "
                         "or a workload file, one request per line "
                         "'TOKEN[,TOKEN...]|MAX_NEW[|DEADLINE]'")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-bits", choices=("32", "8", "4", "mixed"), default="8",
                    help="KV-cache storage policy (mixed: int8 global "
                         "layers, int4 local-window layers)")
    ap.add_argument("--page-size", type=int, default=8, help="tokens per cache page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="arena pages (0 = provision every slot fully; "
                         "smaller forces admission waits)")
    ap.add_argument("--logit-exchange", choices=("off", "fp32", "int8", "int4"),
                    default="int8",
                    help="cross-rank logit aggregation policy (active when "
                         "the process group has >1 rank)")
    ap.add_argument("--restore", default="",
                    help="checkpoint dir: serve trained params (restore_with_fallback)")
    ap.add_argument("--guard", action="store_true",
                    help="decode guard: per-slot finiteness flag (all-reduced "
                         "across the ranks), bounded re-keyed retries, "
                         "quarantine + typed eviction")
    ap.add_argument("--guard-retries", type=int, default=2,
                    help="re-keyed retries before a failing slot is quarantined")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request TTL in wall-clock ms (queued past it: "
                         "queue_timeout; active past it: deadline eviction); "
                         "switches the scheduler clock to monotonic ms")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="shed queue overflow from the tail into jittered "
                         "exponential-backoff re-admission (0 = unbounded)")
    ap.add_argument("--shed-watermark", type=float, default=0.0,
                    help="free-page fraction below which shed requests are "
                         "NOT re-admitted (overload protection)")
    ap.add_argument("--snapshot-dir", default="",
                    help="engine snapshot dir: crash-safe periodic state "
                         "(resume happens automatically when intact "
                         "snapshots exist here)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot the engine every N decode waves (0 = off)")
    ap.add_argument("--restart-retries", type=int, default=3,
                    help="watchdog: in-process engine restarts from the last "
                         "intact snapshot before giving up")
    faults.add_fault_spec_flag(ap, scope="serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return ap


def run(args, say=print, config=None) -> dict:
    """Build the model (random from ``--seed``, or ``--restore``'s params)
    and serve; returns :func:`_serve_paged`'s dict.  ``config`` replaces
    the model config of ``--arch`` / ``--reduced`` (served in f32 all the
    same), as in :func:`repro_torch.launch.train.run`."""
    comm, rank, world, device = _init_distributed(resolve_device(args.device))
    try:
        log = say if rank == 0 else (lambda m: None)
        cfg = config or get_config(args.arch)
        if args.reduced and config is None:
            cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, dtype="float32")
        model = build(cfg, seed=args.seed, device=device)
        for p in model.parameters():
            p.requires_grad_(False)
        _restore_params(model, cfg, args)
        if not transformer.paged_eligible(cfg):
            raise ValueError(f"arch {cfg.name!r} ({cfg.arch_type}) has no paged cache; "
                             "the dense decode_step fallback is not ported")
        return _serve_paged(args, cfg, model, comm, say=log)
    finally:
        if world > 1:
            dist.destroy_process_group()


def main(argv=None):
    args = parser().parse_args(argv)
    return run(args)["out"]


if __name__ == "__main__":
    main()
