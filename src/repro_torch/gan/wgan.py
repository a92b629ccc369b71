"""WGAN-GP on synthetic 2-D data — the paper's experimental testbed
(Section 5); port of ``repro/gan/wgan.py``.

K simulated workers on one device each compute the dual vector (the
generator's and the critic's gradients) on a private minibatch, compress
it per Algorithm 1 with the exchange's ``compress_tree`` (or send it
exactly: the fp32 arm), the estimates are averaged, and ExtraAdam steps.
Quality metric: the energy distance between real and generated points.

The reference ``vmap``s over workers; here the worker dimension is written
out.  Each step replicates the parameters ``[K, ...]``, so one backward
pass gives every worker's own gradient, and all K workers' buffers go
through one launch of the segment-fused quantize∘dequantize kernel per
exchange (each worker with its own noise rows).

Random draws go through explicit sources so each can be injected for
parity: the real batch is an argument of the step, the latent samples z
and the gradient-penalty interpolation weights eps come from ``rng``
(``normal`` / ``uniform``), the quantizer noise from ``noise``
(:mod:`repro_torch.core.noise`); with
``GANConfig(exchange=ExchangeConfig(..., use_device_prng=True))`` the
exchange asks ``noise`` for one seed per exchange and kernel 5 draws the
noise itself.  Parameter trees have the reference's
structure ``{"critic": [{"b", "w"}, ...], "gen": [...]}``, flattened in
JAX order (critic before gen, b before w), which fixes the plan layout and
every noise draw.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch
from torch import nn

from repro_torch.core.exchange import Exchange, ExchangeConfig, make_exchange
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.optim import optimizers as opt


@dataclasses.dataclass(frozen=True)
class GANConfig:
    latent_dim: int = 8
    hidden: int = 64
    gp_weight: float = 1.0
    lr: float = 1e-3
    num_workers: int = 3  # paper: 3 nodes
    batch_per_worker: int = 256
    exchange: Optional[ExchangeConfig] = None  # None: the exact fp32 mean

    def make_exchange(self) -> Optional[Exchange]:
        return make_exchange(self.exchange) if self.exchange is not None else None


class Dense(nn.Module):
    """``x @ w + b`` with the reference's ``w [in, out]`` layout and He
    init (``normal * sqrt(2 / in)``, zero bias)."""

    def __init__(self, fan_in: int, fan_out: int, generator: torch.Generator, device):
        super().__init__()
        self.b = nn.Parameter(torch.zeros((fan_out,), device=device))
        self.w = nn.Parameter(torch.randn((fan_in, fan_out), generator=generator,
                                          device=device) * (2.0 / fan_in) ** 0.5)


class MLP(nn.Module):
    """Dense layers with leaky ReLU (0.2) between them."""

    def __init__(self, sizes, generator: torch.Generator, device):
        super().__init__()
        self.layers = nn.ModuleList(Dense(a, b, generator, device)
                                    for a, b in zip(sizes[:-1], sizes[1:]))

    def tree(self) -> list:
        return [{"b": layer.b, "w": layer.w} for layer in self.layers]


class WGAN(nn.Module):
    """The generator (latent -> 2) and the critic (2 -> 1)."""

    def __init__(self, cfg: GANConfig, generator: torch.Generator, device):
        super().__init__()
        h = cfg.hidden
        self.gen = MLP((cfg.latent_dim, h, h, 2), generator, device)
        self.critic = MLP((2, h, h, 1), generator, device)

    def param_tree(self) -> dict:
        """The parameters as the reference's params tree (the live tensors)."""
        return {"critic": self.critic.tree(), "gen": self.gen.tree()}


def mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """The MLP on ``x [..., in]``; with per-worker parameters (leaves
    ``[K, ...]``) ``x`` is ``[K, B, in]``."""
    for i, layer in enumerate(layers):
        x = torch.matmul(x, layer["w"]) + layer["b"].unsqueeze(-2)
        if i < len(layers) - 1:
            x = torch.where(x >= 0, x, 0.2 * x)  # jax.nn.leaky_relu(x, 0.2)
    return x


def eight_gaussians(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """The classic 2-D mixture: 8 centers on a radius-2 circle, std 0.1."""
    centers = torch.tensor([(math.cos(t), math.sin(t))
                            for t in (2 * math.pi * i / 8 for i in range(8))],
                           dtype=torch.float32, device=device) * 2.0
    idx = torch.randint(0, 8, (n,), generator=generator, device=device)
    return centers[idx] + 0.1 * torch.randn((n, 2), generator=generator, device=device)


def critic_loss(critic, real, fake, eps, gp_weight: float) -> torch.Tensor:
    """Per-worker WGAN-GP critic loss ``d_fake - d_real + gp_weight * gp``
    (real, fake ``[K, B, 2]``, eps ``[K, B, 1]``) -> ``[K]``.  The penalty
    differentiates the critic at the interpolates with ``create_graph``."""
    d_real = mlp_apply(critic, real).mean(dim=(-2, -1))
    d_fake = mlp_apply(critic, fake).mean(dim=(-2, -1))
    inter = (eps * real + (1 - eps) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(mlp_apply(critic, inter).sum(), inter,
                                   create_graph=True)
    gp = ((torch.linalg.vector_norm(grads, dim=-1) - 1.0) ** 2).mean(dim=-1)
    return d_fake - d_real + gp_weight * gp


def gen_loss(critic, gen, z) -> torch.Tensor:
    """Per-worker generator loss ``-mean critic(gen(z))`` -> ``[K]``."""
    return -mlp_apply(critic, mlp_apply(gen, z)).mean(dim=(-2, -1))


def _game_grads(params, real, z, eps, gp_weight: float) -> dict:
    """The VI dual vector of every worker: the critic's gradient of its
    loss and the generator's of its own.  ``params`` leaves are ``[K, ...]``
    per-worker copies; the returned leaves are ``[K, ...]`` too."""
    critic = tree_map(lambda p: p.detach().requires_grad_(True), params["critic"])
    gen = tree_map(lambda p: p.detach().requires_grad_(True), params["gen"])
    fake = mlp_apply(gen, z)
    crit = critic_loss(critic, real, fake.detach(), eps, gp_weight).sum()
    crit_leaves, crit_spec = tree_flatten(critic)
    g_crit = torch.autograd.grad(crit, crit_leaves)
    frozen = tree_map(lambda p: p.detach(), critic)
    gl = (-mlp_apply(frozen, fake).mean(dim=(-2, -1))).sum()
    gen_leaves, gen_spec = tree_flatten(gen)
    g_gen = torch.autograd.grad(gl, gen_leaves)
    return {"critic": tree_unflatten(crit_spec, list(g_crit)),
            "gen": tree_unflatten(gen_spec, list(g_gen))}


def make_step(cfg: GANConfig, opt_cfg: opt.OptimizerConfig):
    """One distributed ExtraAdam step with per-worker compression:
    ``step(params, state, real_all, rng, noise) -> (params, state)`` with
    ``real_all [K, B, 2]`` the workers' private batches."""
    ex = cfg.make_exchange()
    K = cfg.num_workers

    def worker_grads(params, real_all, rng):
        dev = real_all.device
        B = real_all.shape[1]
        z = rng.normal((K, B, cfg.latent_dim), dev)
        eps = rng.uniform((K, B, 1), dev)
        stacked = tree_map(lambda p: p.detach().unsqueeze(0).expand(K, *p.shape).contiguous(),
                           params)
        return _game_grads(stacked, real_all, z, eps, cfg.gp_weight)

    def exchange(grads_k, noise):
        if ex is not None:
            grads_k = ex.compress_tree(grads_k, noise, workers=True)
        return tree_map(lambda g: g.mean(0), grads_k)

    def step(params, state, real_all, rng, noise):
        g1 = exchange(worker_grads(params, real_all, rng), noise)
        half = opt.extrapolate(opt_cfg, params, state, g1)
        g2 = exchange(worker_grads(half, real_all, rng), noise)
        return opt.commit(opt_cfg, params, state, g2)

    return step


def _pdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((a[:, None] - b[None]) ** 2).sum(-1) + 1e-12).mean()


@torch.no_grad()
def energy_distance(params, cfg: GANConfig, n: int = 1024, *, generator=None,
                    real: Optional[torch.Tensor] = None,
                    z: Optional[torch.Tensor] = None) -> float:
    """2-D quality metric (FID analogue): energy distance real vs fake.
    ``real`` [n, 2] and ``z`` [n, latent] are drawn from ``generator``
    unless given."""
    dev = tree_leaves(params)[0].device
    if real is None:
        real = eight_gaussians(generator, n, dev)
    if z is None:
        z = torch.randn((n, cfg.latent_dim), generator=generator, device=dev)
    fake = mlp_apply(params["gen"], z)
    return float(2 * _pdist(real, fake) - _pdist(real, real) - _pdist(fake, fake))


def grad_bytes(params, ex: Optional[Exchange]) -> float:
    """Per-worker broadcast bytes of one compressed dual vector: the flat
    payload for qgenx, the plan's segments for layerwise, 8 B a kept
    coordinate of each leaf for randk (``compress_wire_bytes_tree``), 4 B
    per coordinate without an exchange."""
    n = sum(l.numel() for l in tree_leaves(params))
    if ex is None:
        return 4.0 * n
    if ex.cfg.compressor == "qgenx":
        return ex.compress_wire_bytes(n)
    return ex.compress_wire_bytes_tree(params)


def _metric_generator(device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(999)
    return g


def train(cfg: GANConfig, steps: int = 300, seed: int = 0, device="cuda") -> dict:
    """Train from seed ``seed``; returns the final energy distance, the
    median step time (ms, host clock around each synchronized step), the
    total time, the bytes per step per worker and the params."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = tree_map(lambda p: p.detach(), WGAN(cfg, gen, dev).param_tree())
    opt_cfg = opt.OptimizerConfig(name="extra_adam", lr=cfg.lr, grad_clip=0.0)
    state = opt.init_state(opt_cfg, params)
    step = make_step(cfg, opt_cfg)
    per_exchange = grad_bytes(params, cfg.make_exchange())
    draws = GeneratorNoise(gen)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_steps = []
    for _ in range(steps):
        real_all = eight_gaussians(gen, cfg.num_workers * cfg.batch_per_worker, dev).reshape(
            cfg.num_workers, cfg.batch_per_worker, 2)
        sync()
        t0 = time.perf_counter()
        params, state = step(params, state, real_all, draws, draws)
        sync()
        t_steps.append(time.perf_counter() - t0)
    ed = energy_distance(params, cfg, generator=_metric_generator(dev))
    steady = t_steps[1:] or t_steps
    return {
        "energy_distance": ed,
        "median_step_ms": sorted(steady)[len(steady) // 2] * 1e3,
        "total_s": sum(t_steps),
        # 2 exchanges per extra-gradient step, per worker
        "bytes_per_step_per_worker": 2 * per_exchange,
        "params": params,
    }
