"""Seed spread of the WGAN-GP testbed's final energy distance, reference
against port, on the CPU.

The port draws its initial weights and every random batch from
``torch.Generator`` streams, the reference from ``jax.random`` keys, so one
seed gives the two different runs.  This script trains every ported arm
for ``--steps`` steps (default 300, the paper's run) from each of
``--seeds`` seeds in both, and prints the energy distances side by side
with each side's min / median / max: a difference in the training loop
would show as two spreads that do not overlap.

It then trains the fp32 arm once more in both from the reference's seed-0
weights with every reference draw (real batches, latent samples, penalty
weights) replayed into the port, and prints the two energy distances on
the same metric points every 50 steps: there the runs differ only by f32
rounding.  Run from the repo root::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_gan_spread.py --seeds 5
"""

import argparse
import json
import statistics

ARMS = ("fp32", "uq8", "uq4", "layerwise")


def reference_exchange(arm):
    import math

    from repro.core.exchange import ExchangeConfig
    from repro.core.quantization import QuantConfig

    uq8 = QuantConfig(num_levels=15, bits=8, bucket_size=512, q_norm=math.inf)
    uq4 = QuantConfig(num_levels=5, bits=4, bucket_size=512, q_norm=math.inf)
    return {"fp32": None,
            "uq8": ExchangeConfig(compressor="qgenx", quant=uq8),
            "uq4": ExchangeConfig(compressor="qgenx", quant=uq4),
            "layerwise": ExchangeConfig(compressor="layerwise", quant=uq4,
                                        layerwise_threshold=2048)}[arm]


def replayed_fp32(steps, every=50):
    """[(step, reference ED, port ED)] of the fp32 arm, both from the
    reference's seed-0 weights, the port replaying every reference draw."""
    import jax
    import numpy as np
    import torch

    from repro.gan import wgan as jgan
    from repro.optim import optimizers as jopt
    from repro_torch.convert import gan_params_from_jax
    from repro_torch.core.noise import ReplayNoise
    from repro_torch.core.tree import tree_map
    from repro_torch.gan import wgan
    from repro_torch.optim import optimizers as opt

    jcfg, cfg = jgan.GANConfig(), wgan.GANConfig()
    K, B = cfg.num_workers, cfg.batch_per_worker
    key = jax.random.PRNGKey(0)
    jparams = jgan.init_gan(key, jcfg)
    model = wgan.WGAN(cfg, torch.Generator(), "cpu")
    gan_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), model)
    params = tree_map(lambda p: p.detach().clone(), model.param_tree())
    jopt_cfg = jopt.OptimizerConfig(name="extra_adam", lr=jcfg.lr, grad_clip=0.0)
    opt_cfg = opt.OptimizerConfig(name="extra_adam", lr=cfg.lr, grad_clip=0.0)
    jstate, state = jopt.init_state(jopt_cfg, jparams), opt.init_state(opt_cfg, params)
    jstep, step = jgan.make_step(jcfg, jopt_cfg), wgan.make_step(cfg, opt_cfg)

    def worker_draws(k):
        zs, es = [], []
        for kk in jax.random.split(k, K):
            kz, kgp = jax.random.split(kk)
            zs.append(np.asarray(jax.random.normal(kz, (B, cfg.latent_dim))))
            es.append(np.asarray(jax.random.uniform(kgp, (B, 1))))
        return [np.stack(zs), np.stack(es)]

    def both_eds():
        mkey = jax.random.PRNGKey(999)
        k1, k2 = jax.random.split(mkey)
        real = torch.from_numpy(np.array(jgan.eight_gaussians(k1, 1024)))
        z = torch.from_numpy(np.array(jax.random.normal(k2, (1024, cfg.latent_dim))))
        return (jgan.energy_distance(mkey, jparams, jcfg),
                wgan.energy_distance(params, cfg, real=real, z=z))

    rows = []
    for i in range(steps):
        kd, ks = jax.random.split(jax.random.fold_in(key, i))
        real = jgan.eight_gaussians(kd, K * B).reshape(K, B, 2)
        jparams, jstate = jstep(jparams, jstate, real, ks)
        k1, _, k3, _ = jax.random.split(ks, 4)
        rng = ReplayNoise(worker_draws(k1) + worker_draws(k3))
        params, state = step(params, state, torch.from_numpy(np.array(real)), rng,
                             ReplayNoise([]))
        if (i + 1) % every == 0 or i + 1 == steps:
            rows.append((i + 1, *both_eds()))
            print(f"replayed fp32 step {i + 1}: reference {rows[-1][1]:.4f} "
                  f"port {rows[-1][2]:.4f}", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--arms", nargs="+", choices=ARMS, default=list(ARMS))
    args = ap.parse_args()

    from repro.gan import wgan as jgan
    from repro_torch.gan import wgan
    from repro_torch.launch.train_gan import arm_exchange

    out = {}
    for arm in args.arms:
        ref = [float(jgan.train(jgan.GANConfig(exchange=reference_exchange(arm)),
                                steps=args.steps, seed=s)["energy_distance"])
               for s in range(args.seeds)]
        port = [wgan.train(wgan.GANConfig(exchange=arm_exchange(arm)), steps=args.steps,
                           seed=s, device="cpu")["energy_distance"]
                for s in range(args.seeds)]
        out[arm] = {"reference": ref, "port": port}
        for side, v in (("reference", ref), ("port", port)):
            print(f"{arm:>9} {side:>9}: min {min(v):.4f} median {statistics.median(v):.4f} "
                  f"max {max(v):.4f}  {[round(x, 4) for x in v]}", flush=True)
    replay = replayed_fp32(args.steps)
    print(json.dumps({"steps": args.steps, "seeds": args.seeds, "energy_distance": out,
                      "replayed_fp32": replay}))


if __name__ == "__main__":
    main()
