"""The cost of ``Exchange.coded_bits_tree`` (the train step's
``coded_bits_est``) at the full tinyllama-1.1b gradient on one GPU, and
of other ways to sum the same expected index masses in plain PyTorch.

    PYTHONPATH=src python tests/_torch_coded_cost.py

Builds a random gradient with the model's leaf shapes and dtypes (bf16
layers, f32 embeddings: 1,100,048,384 coordinates), then times, with
CUDA events (a warm-up call, then ``--reps`` calls), each variant's
estimate under the int8 qgenx exchange (s = 15, bucket 512) and holds it
to ``coded_bits_tree``'s within rtol 1e-6:

* ``port``: ``Exchange.coded_bits_tree`` as the port computes it: per
  bracket j the count C_j and the sum U_j of the normalized magnitudes,
  from two ``bincount``s keyed by (bucket row, bracket), so a bin takes
  ~30 adds (f32 within a row, then f64 over rows); the mass rounded up is
  X_j = (U_j - C_j l_j) / (l_{j+1} - l_j) and symbol j gets
  C_j - X_j + X_{j-1}.  No per-coordinate xi, so no gathers of the table;
* ``row_xi``: the same keyed ``bincount``s over a per-coordinate xi
  (two gathers of the table and three more passes);
* ``global_f64``: the port's first design, two f64-weighted ``bincount``s
  over the whole chunk (1 - xi into tau, xi into tau + 1): 17 bins that
  every thread adds into;
* ``count_x``: C_j from an unweighted ``bincount`` and X_j from one
  f64-weighted ``bincount``, both over the whole chunk;
* ``masked``: one masked sum per symbol and direction, as the
  reference's traced twin sums.

Then profiles one ``port`` call (``torch.profiler``: device time by
kernel).  Prints the card's name and power limit first.
"""

import argparse
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.core import exchange as xmod
from repro_torch.core.exchange import ExchangeConfig, make_exchange
from repro_torch.core.quantization import QuantConfig
from repro_torch.models.model import build


def _prep(plan, leaves, r0, r1, b, levels):
    v = plan.pack_range(leaves, r0 * b, r1 * b).view(-1, b)
    a = v.abs_()
    norms = a.amax(dim=1)
    u = a.div_(torch.where(norms > 0, norms, 1.0)[:, None]).clamp_(0.0, 1.0).view(-1)
    lv = levels.float()
    tau = torch.searchsorted(lv[1:-1].contiguous(), u, right=True)
    lo = lv[tau]
    xi = u.sub_(lo).div_((lv[1:] - lv[:-1])[tau]).clamp_(0.0, 1.0)
    return tau, xi, lv.shape[0]


def _count_x(tau, xi, s, rows, b):
    c = torch.bincount(tau, minlength=s).double()
    x = torch.bincount(tau, weights=xi.double(), minlength=s)
    return c, x


def _row_xi(tau, xi, s, rows, b):
    key = (tau.view(rows, b) + torch.arange(rows, device=tau.device)[:, None] * s).view(-1)
    x = torch.bincount(key, weights=xi, minlength=rows * s).view(rows, s).double().sum(0)
    c = torch.bincount(key, minlength=rows * s).view(rows, s).sum(0).double()
    return c, x


def _global_f64(tau, xi, s, rows, b):
    xi = xi.double()
    down = torch.bincount(tau, weights=1.0 - xi, minlength=s)
    up = torch.bincount(tau + 1, weights=xi, minlength=s)
    # as (C, X): C_j - X_j + X_{j-1} = down_j + up_j
    x = torch.zeros_like(up)
    x[:-1] = up[1:]
    return down + x, x


def _masked(tau, xi, s, rows, b):
    c = torch.stack([(tau == j).sum() for j in range(s)]).double()
    x = torch.stack([torch.where(tau == j, xi, 0.0).sum(dtype=torch.float64)
                     for j in range(s)])
    return c, x


def variant(sums):
    def coded(ex, tree, state):
        q = ex.cfg.quant
        leaves = list(tree)
        plan = ex.plan_for(leaves, "compress", 1)
        b = q.bucket_size
        rows = plan.total // b
        mass = None
        for r0 in range(0, rows, xmod.CODED_CHUNK_ROWS):
            r1 = min(rows, r0 + xmod.CODED_CHUNK_ROWS)
            tau, xi, s = _prep(plan, leaves, r0, r1, b, state.levels)
            c, x = sums(tau, xi, s, r1 - r0, b)
            m = c - x
            m[1:] += x[:-1]
            mass = m if mass is None else mass + m
        pmf = (mass / (rows * b)).float()
        return xmod.theorem2_bits_traced(pmf, rows * b, rows)

    return coded


def _time(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, float(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0])
    cfg = get_config("tinyllama-1.1b")
    import dataclasses

    model = build(dataclasses.replace(cfg, dtype="bfloat16"), device="cuda")
    g = [torch.randn(p.shape, device="cuda").to(p.dtype) for p in model.param_leaves()]
    del model
    torch.cuda.empty_cache()
    ex = make_exchange(ExchangeConfig(quant=QuantConfig(num_levels=15, bits=8,
                                                        bucket_size=512)))
    st = ex.init_state("cuda")
    want = None
    variants = {"port": lambda e, t, s: e.coded_bits_tree(t, s),
                "row_xi": variant(_row_xi), "global_f64": variant(_global_f64),
                "count_x": variant(_count_x),
                "masked": variant(_masked)}
    for name, fn in variants.items():
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms, val = _time(lambda: fn(ex, g, st), args.reps)
        extra = torch.cuda.max_memory_allocated() - base
        want = val if want is None else want
        rel = abs(val - want) / want
        print(f"{name}: {ms:.2f} ms a call, {val:.9e} bits (rel diff {rel:.2e} to port), "
              f"{extra} bytes of temporaries at the peak")
        if rel > 1e-6:
            raise SystemExit(f"{name} disagrees with coded_bits_tree")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ex.coded_bits_tree(g, st)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))


if __name__ == "__main__":
    main()
