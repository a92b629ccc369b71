"""Time the port's bucketed exchange with its buckets pipelined (each
bucket's last collectives in flight while the next bucket's kernels run)
against the same buckets run one after another.

    PYTHONPATH=src python tests/_torch_overlap_timing.py --device cpu --world 2 \\
        --leaves 8 --leaf-size 2000000 --mode gather --threads 1
    PYTHONPATH=src python tests/_torch_overlap_timing.py --device cuda --world 4 \\
        --leaves 22 --leaf-size 50000000 --mode two_phase

Spawns ``--world`` workers (gloo on the CPU, NCCL with a card each on
cuda), each holding a random f32 tree of ``--leaves`` leaves of
``--leaf-size`` coordinates, and runs ``Exchange.pmean_tree`` with qgenx
int8 at ``--buckets`` buckets (``overlap="bucketed"``), ``--reps`` times
per arm in alternating order after one warm-up each.  The serial arm
swaps ``exchange._pipeline`` for a driver that runs each bucket's chain to
its end before the next starts; the numbers of both arms are the same bit
for bit (checked).  Each call is timed between barriers (and, on cuda,
device synchronisations).  Prints one line per arm and a JSON object
with every time; with ``--out FILE`` writes the JSON there too.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def _serial(items, start, scope=lambda item: contextlib.nullcontext()):
    """``exchange._pipeline``'s contract, one chain at a time."""
    from repro_torch.core import exchange as ex

    for item in items:
        with scope(item):
            result = ex._run(start(item))
        yield item, result


def _worker(rank, args, store):
    import torch
    import torch.distributed as dist

    from repro_torch.core import exchange as ex
    from repro_torch.core.noise import GeneratorNoise
    from repro_torch.core.quantization import QuantConfig

    torch.set_num_threads(args.threads)
    cuda = args.device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.FileStore(store, args.world), rank=rank,
                            world_size=args.world)
    try:
        gen = torch.Generator(device=dev).manual_seed(rank)
        tree = {f"l{i:03d}": torch.randn(args.leaf_size, generator=gen, device=dev)
                for i in range(args.leaves)}
        cfg = ex.ExchangeConfig(quant=QuantConfig(num_levels=15, bits=8, bucket_size=512),
                                mode=args.mode, num_buckets=args.buckets, overlap="bucketed")
        xc = ex.Exchange(cfg, ex.ProcessGroupComm())
        state = xc.init_state(dev)
        arms = {"pipelined": ex._pipeline, "serial": _serial}

        def sync():
            if cuda:
                torch.cuda.synchronize()
            dist.barrier()

        def call(arm, seed):
            ex._pipeline = arms[arm]
            try:
                sync()
                t0 = time.perf_counter()
                mean, _ = xc.pmean_tree(tree, state, GeneratorNoise.seeded(seed, dev))
                sync()
                return time.perf_counter() - t0, mean
            finally:
                ex._pipeline = arms["pipelined"]

        _, a = call("pipelined", 1)
        _, b = call("serial", 1)
        same = all(torch.equal(a[k], b[k]) for k in a)
        del a, b
        times = {arm: [] for arm in arms}
        for r in range(args.reps):
            order = ("serial", "pipelined") if r % 2 else ("pipelined", "serial")
            for arm in order:
                dt, mean = call(arm, 2 + r)
                del mean
                times[arm].append(dt)
        if rank == 0:
            Path(args.result).write_text(json.dumps({"times": times, "same": same}))
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--leaves", type=int, default=8)
    ap.add_argument("--leaf-size", type=int, default=2_000_000)
    ap.add_argument("--buckets", type=int, default=4)
    ap.add_argument("--mode", choices=("gather", "two_phase"), default="gather")
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--threads", type=int, default=1, help="torch threads a worker")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import statistics

    import torch.multiprocessing as mp

    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < args.world:
            sys.exit(f"--world {args.world} needs as many cards, found "
                     f"{torch.cuda.device_count()}")
        from repro_torch.kernels import cuda as kcuda

        kcuda.build()  # once, before the workers load it
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()
    else:
        card = ["cpu"]
    with tempfile.TemporaryDirectory() as tmp:
        args.result = os.path.join(tmp, "result.json")
        mp.spawn(_worker, args=(args, os.path.join(tmp, "store")), nprocs=args.world)
        res = json.loads(Path(args.result).read_text())
    res["config"] = {k: v for k, v in vars(args).items() if k not in ("out", "result")}
    res["card"] = card
    for arm, ts in res["times"].items():
        print(f"{arm}: median {statistics.median(ts):.6f} s, min {min(ts):.6f} s, "
              f"n {len(ts)}")
    print(f"same means in both arms: {res['same']}; card: {card}")
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    if not res["same"]:
        sys.exit("the two arms' means differ")


if __name__ == "__main__":
    main()
