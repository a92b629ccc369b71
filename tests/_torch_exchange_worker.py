"""Worker body for the port's multi-worker exchange tests.

Imported by ``torch.multiprocessing`` ``spawn`` children (never fork), so
it imports torch and the port only.  Each worker joins a process group on
a ``FileStore``, runs every case's quantized mean on its own vector with
the noise it was handed, or with the device-PRNG exchange where it was
handed seeds instead (:func:`run`; :func:`run_layerwise` takes the
layerwise ``Exchange.pmean_tree`` of a small pytree instead,
:func:`run_sparse` the sparse compressors' chained ``pmean_tree`` with
their support draws replayed, :func:`run_sparse_step` the train step
under them, :func:`run_masked` ``pmean_tree`` with a liveness mask,
:func:`run_layouts` the bucketed, per-call and leafwise layouts,
:func:`run_layout_step` the train step under them), saves the result
and destroys the group.  :func:`run_group` starts the
workers, joins them under a hard timeout and returns their outputs.
"""

import dataclasses

import numpy as np
import torch.distributed as dist

JOIN_TIMEOUT_S = 120


def run(rank, world, store_path, in_path, out_dir, cases, backend, device):
    import torch

    from repro_torch.core.exchange import ProcessGroupComm, qgenx_pmean
    from repro_torch.core.noise import ReplayNoise
    from repro_torch.core.quantization import QuantConfig, uniform_levels

    dev = torch.device(device, rank) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    data = np.load(in_path)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        comm = ProcessGroupComm()
        for i, (mode, bits, q_norm, bucket) in enumerate(cases):
            s = 15 if bits == 8 else 5
            cfg = QuantConfig(num_levels=s, bits=bits, bucket_size=bucket, q_norm=q_norm)
            # seeds s1_/s2_ in place of the noise n1_/n2_: the device PRNG
            prng = f"s1_{i}_{rank}" in data.files
            tag = "s" if prng else "n"
            draws = [data[f"{tag}1_{i}_{rank}"]]
            if mode == "two_phase":
                draws.append(data[f"{tag}2_{i}_{rank}"])
            noise = ReplayNoise([int(d) for d in draws] if prng else draws)
            x = torch.from_numpy(data[f"x_{i}_{rank}"]).to(dev)
            out = qgenx_pmean(x, comm, uniform_levels(s, dev), noise, cfg, mode,
                              use_device_prng=prng)
            if noise.remaining:
                raise RuntimeError("not every noise draw was used")
            np.save(f"{out_dir}/out_{i}_{rank}.npy", out.cpu().numpy())
    finally:
        dist.destroy_process_group()


LAYERWISE_TREE = {"a": (40, 50), "b": (300,), "c": (30, 70), "d": (7, 11)}
LAYERWISE_THRESHOLD = 1000  # a and c take the low-bit quantizer, b and d int8


def layerwise_config(mode, bits):
    """The layerwise exchange of a case: int4 (s = 5) or int8 (s = 15) at
    bucket 256 for the leaves above the threshold, the default int8 at
    bucket 512 for the rest."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.quantization import QuantConfig

    quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=256)
    return ExchangeConfig(compressor="layerwise", quant=quant, mode=mode,
                          layerwise_threshold=LAYERWISE_THRESHOLD)


def run_layerwise(rank, world, store_path, in_path, out_dir, cases, backend, device):
    """Each case ``(mode, bits)``: the layerwise ``pmean_tree`` of this
    worker's tree (keys ``{leaf}_{case}_{rank}``), with its noise draws
    ``noise_{case}_{rank}_{j}`` in the order the exchange asks for them;
    saves the mean's leaves concatenated in tree order."""
    import torch

    from repro_torch.core.exchange import ProcessGroupComm, make_exchange
    from repro_torch.core.noise import ReplayNoise

    dev = torch.device(device)
    data = np.load(in_path)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for i, case in enumerate(cases):
            ex = make_exchange(layerwise_config(*case), ProcessGroupComm())
            tree = {name: torch.from_numpy(data[f"{name}_{i}_{rank}"]).to(dev)
                    for name in LAYERWISE_TREE}
            draws = sorted((k for k in data.files if k.startswith(f"noise_{i}_{rank}_")),
                           key=lambda k: int(k.rsplit("_", 1)[1]))
            noise = ReplayNoise([data[k] for k in draws])
            mean, _ = ex.pmean_tree(tree, ex.init_state(dev), noise)
            if noise.remaining:
                raise RuntimeError("not every noise draw was used")
            np.save(f"{out_dir}/out_{i}_{rank}.npy",
                    np.concatenate([mean[k].cpu().numpy().ravel() for k in sorted(mean)]))
    finally:
        dist.destroy_process_group()


def _load_out(workdir, i, k):
    """A worker's output: ``out_{i}_{k}.npy`` (an array) or ``.npz`` (a dict)."""
    npy = workdir / f"out_{i}_{k}.npy"
    if npy.exists():
        return np.load(npy)
    with np.load(workdir / f"out_{i}_{k}.npz") as z:
        return dict(z)


def _one_thread(target, *args):
    """A spawned worker: ``target(*args)`` on one torch thread (small
    tensors; the suite's pytest workers share the cores)."""
    import torch

    torch.set_num_threads(1)
    target(*args)


def run_group(K, workdir, inputs, cases, backend="gloo", device="cpu", while_running=None,
              target=run):
    """Run K workers of ``target`` over ``inputs`` (for :func:`run`, keys
    ``x_/n1_/n2_{case}_{rank}``, or ``s1_/s2_`` seeds for the device
    PRNG); returns ``outs[case][rank]`` (an array, or the dict of a
    target that writes npz) and
    ``while_running()``'s result (called in this process while the
    workers run)."""
    import torch.multiprocessing as mp

    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inputs)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_one_thread, args=(target, r, K, str(workdir / "store"),
                                                str(workdir / "inputs.npz"), str(workdir),
                                                cases, backend, device))
             for r in range(K)]
    for p in procs:
        p.start()
    try:
        extra = while_running() if while_running is not None else None
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        assert not any(p.is_alive() for p in procs), "exchange workers hung"
        assert [p.exitcode for p in procs] == [0] * K
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    outs = [[_load_out(workdir, i, k) for k in range(K)] for i in range(len(cases))]
    return outs, extra


def run_step(rank, world, store_path, in_path, out_dir, cases, backend, device):
    """Each case ``(name, method, bits, mode, sync_every, recenter_every,
    steps, level_update_every[, fault spec[, arch]])`` of ``_torch_step_k2_reference.CASES``
    (a ``FAULT_CASES`` case with its spec appended: the step is then
    guarded and takes the step index as ``fault_step``; an ``ARCH_CASES``
    case with ``None`` and its model appended, the batch's ``embeds_{t}``
    sliced by rows as its tokens are): the port's train step on
    reduced tinyllama-1.1b (or ``arch``) from the reference's initial params
    (``p0_{j}``), on this worker's rows of each step's batch, with this
    worker's noise draws replayed (``noise_{rank}_{i}``).  Saves
    ``out_{case}_{rank}.npz``: the per-step metrics, the final params
    (``p_{j}``) and the wire recorder's ``(name, nbytes)`` list of the first
    step that exchanged, the optimizer state's ``count`` (and qgenx's
    ``sum_sq``) as the reference's numpy tree holds them, and each step's
    level table and QAda histogram (``levels_{t}``, ``hist_{t}``).  Where
    the inputs hold the reference's ``levels_{t}``, the state's table is
    set to it after step t, so later steps are held given the reference's
    levels."""
    import torch

    import _torch_step_k2_reference as ref_k2  # its configs (it imports jax only in main)
    from repro_torch.configs import get_config
    from repro_torch.convert import opt_state_to_jax, params_from_jax
    from repro_torch.core import exchange as xmod
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.noise import ReplayNoise
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build
    from repro_torch.optim import optimizers as opt
    from repro_torch.optim.optimizers import OptimizerConfig

    dev = torch.device(device)
    data = np.load(in_path)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for i, case in enumerate(cases):
            name, method, bits, mode, sync_every, recenter_every, steps, every = case[:8]
            spec = FaultSpec.parse(case[8]) if len(case) > 8 and case[8] else None
            arch = case[9] if len(case) > 9 else "tinyllama-1.1b"
            n_leaves = sum(1 for k in data.files if k.startswith("p0_"))
            model = params_from_jax([data[f"p0_{j}"] for j in range(n_leaves)],
                                    build(ref_k2.arch_config(arch, get_config), device=dev))
            quant = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=256)
            ex = xmod.make_exchange(
                xmod.ExchangeConfig(compressor="qgenx", quant=quant, mode=mode,
                                    sync_every=sync_every, recenter_every=recenter_every,
                                    level_schedule="qada" if every else "fixed",
                                    level_update_every=every),
                xmod.ProcessGroupComm())
            opt_cfg = OptimizerConfig(name=name, gamma_scale=0.02, method=method)
            step = make_train_step(model, opt_cfg, ex, guard=spec is not None,
                                   fault_spec=spec)
            opt_state = opt.init_state(opt_cfg, model.param_leaves())
            ex_state = ex.init_state(dev)
            draws = sorted((k for k in data.files if k.startswith(f"noise_{rank}_")),
                           key=lambda k: int(k.rsplit("_", 1)[1]))
            noise = ReplayNoise([data[k] for k in draws])
            rows = slice(rank * 2, rank * 2 + 2)
            out = {k: [] for k in ("loss", "wire_bytes", "param_drift", "coded_bits_est",
                                   "rejected", "nonfinite", "alive")}
            levels = {}
            trace = None
            for t in range(steps):
                batch = {"tokens": data[f"tokens_{t}"], "labels": data[f"labels_{t}"]}
                if f"embeds_{t}" in data.files:
                    batch["embeds"] = data[f"embeds_{t}"]
                batch = to_device(batch, dev, rows)
                recording = trace is None
                if recording:
                    xmod.wire_trace_start()
                kw = {"fault_step": t} if spec is not None else {}
                opt_state, ex_state, m = step(opt_state, ex_state, batch, noise, **kw)
                if recording:
                    rec = xmod.wire_trace_stop()
                    trace = rec or None
                for k in out:
                    out[k].append(float(m[k]))
                levels[f"levels_{t}"] = ex_state.levels.cpu().numpy()
                levels[f"hist_{t}"] = ex_state.hist.cpu().numpy()
                if f"levels_{t}" in data.files:  # hold later steps given the reference's
                    ex_state.levels = torch.from_numpy(data[f"levels_{t}"]).to(dev)
            if noise.remaining:
                raise RuntimeError("not every noise draw was used")
            res = {k: np.asarray(v, np.float64) for k, v in out.items()}
            res.update(levels)
            for j, p in enumerate(model.param_leaves()):
                res[f"p_{j}"] = p.detach().cpu().numpy()
            state = opt_state_to_jax(opt_state, model)
            res["opt_count"] = state.count
            if name == "qgenx":
                res["opt_sum_sq"] = state.sum_sq
            res["wire_names"] = np.asarray([nm for nm, _ in trace or []], dtype=str)
            res["wire_nbytes"] = np.asarray([nb for _, nb in trace or []], np.int64)
            np.savez(f"{out_dir}/out_{i}_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


SPARSE_TREE = {"a": (3, 5), "b": (7,), "c": (40, 50)}  # 2022 coordinates


def sparse_config(compressor, frac):
    from repro_torch.core.exchange import ExchangeConfig

    return ExchangeConfig(compressor=compressor, rand_frac=frac, ef_topk_frac=frac)


def run_sparse(rank, world, store_path, in_path, out_dir, cases, backend, device):
    """Each case ``(compressor, frac, calls)``: ``calls`` chained
    ``Exchange.pmean_tree`` calls of this worker's trees (keys
    ``{leaf}_{case}_{call}_{rank}``), the state (and so a contractive
    compressor's ``[K, n]`` error memory, zero at first) threaded through,
    each call's support draw replayed from ``sup_{case}_{call}_{rank}``
    where one is given; then ``compress_tree`` of call 0's tree with the
    draws ``csup_{case}_{leaf}_{rank}``.  Saves per call the mean's leaves
    concatenated in tree order (``mean_{call}``), the final error memory,
    the compressed tree (``compressed``) and the wire recorder's list."""
    import torch

    from repro_torch.core import exchange as xmod
    from repro_torch.core.noise import ReplayNoise

    dev = torch.device(device)
    data = np.load(in_path)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for i, (compressor, frac, calls) in enumerate(cases):
            ex = xmod.make_exchange(sparse_config(compressor, frac), xmod.ProcessGroupComm())
            trees = [{name: torch.from_numpy(data[f"{name}_{i}_{c}_{rank}"]).to(dev)
                      for name in SPARSE_TREE} for c in range(calls)]
            state = ex.init_state(dev, template=trees[0], num_workers=world)
            draws = [data[f"sup_{i}_{c}_{rank}"] for c in range(calls)
                     if f"sup_{i}_{c}_{rank}" in data.files]
            noise = ReplayNoise(draws)
            res = {}
            xmod.wire_trace_start()
            for c, tree in enumerate(trees):
                mean, state = ex.pmean_tree(tree, state, noise)
                res[f"mean_{c}"] = np.concatenate([mean[k].cpu().numpy().ravel()
                                                   for k in sorted(mean)])
            trace = xmod.wire_trace_stop()
            cdraws = [data[f"csup_{i}_{k}_{rank}"] for k in sorted(SPARSE_TREE)
                      if f"csup_{i}_{k}_{rank}" in data.files]
            cnoise = ReplayNoise(cdraws)
            out = ex.compress_tree(trees[0], cnoise)
            if noise.remaining or cnoise.remaining:
                raise RuntimeError("not every support draw was used")
            res["compressed"] = np.concatenate([out[k].cpu().numpy().ravel()
                                                for k in sorted(out)])
            res["error"] = state.error.cpu().numpy()
            res["steps"] = np.asarray(state.step)
            res["wire_names"] = np.asarray([nm for nm, _ in trace], dtype=str)
            res["wire_nbytes"] = np.asarray([nb for _, nb in trace], np.int64)
            np.savez(f"{out_dir}/out_{i}_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def run_sparse_step(rank, world, store_path, in_path, out_dir, cases, backend, device):
    """Each case ``(name, compressor, method, frac, steps)`` of
    ``_torch_sparse_step_k2_reference.CASES``: the port's qgenx train step
    on reduced tinyllama-1.1b from the reference's initial params, on this
    worker's rows of each step's batch, the error memory from
    ``init_state(template=params, num_workers=world)`` and this worker's
    support draws replayed (``{name}_sup_{rank}_{i}``).  Saves per case the
    metrics, the final params (``p_{j}``), the optimizer's ``count`` and
    ``sum_sq``, the final error memory and the wire recorder's list of
    the first step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import opt_state_to_jax, params_from_jax
    from repro_torch.core import exchange as xmod
    from repro_torch.core.noise import ReplayNoise
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build
    from repro_torch.optim import optimizers as opt
    from repro_torch.optim.optimizers import OptimizerConfig

    dev = torch.device(device)
    data = np.load(in_path)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for i, (name, compressor, method, frac, steps) in enumerate(cases):
            n_leaves = sum(1 for k in data.files if k.startswith("p0_"))
            model = params_from_jax([data[f"p0_{j}"] for j in range(n_leaves)],
                                    build(get_config("tinyllama-1.1b").reduced(), device=dev))
            ex = xmod.make_exchange(sparse_config(compressor, frac), xmod.ProcessGroupComm())
            opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=0.02, method=method)
            step = make_train_step(model, opt_cfg, ex)
            opt_state = opt.init_state(opt_cfg, model.param_leaves())
            ex_state = ex.init_state(dev, template=model.param_leaves(), num_workers=world)
            draws = sorted((k for k in data.files if k.startswith(f"{name}_sup_{rank}_")),
                           key=lambda k: int(k.rsplit("_", 1)[1]))
            noise = ReplayNoise([data[k] for k in draws])
            rows = slice(rank * 2, rank * 2 + 2)
            loss, wire, trace = [], [], None
            for t in range(steps):
                batch = {"tokens": data[f"tokens_{t}"], "labels": data[f"labels_{t}"]}
                if f"embeds_{t}" in data.files:
                    batch["embeds"] = data[f"embeds_{t}"]
                batch = to_device(batch, dev, rows)
                if t == 0:
                    xmod.wire_trace_start()
                opt_state, ex_state, m = step(opt_state, ex_state, batch, noise)
                if t == 0:
                    trace = xmod.wire_trace_stop()
                loss.append(float(m["loss"]))
                wire.append(float(m["wire_bytes"]))
            if noise.remaining:
                raise RuntimeError("not every support draw was used")
            res = {"loss": np.asarray(loss, np.float64), "wire_bytes": np.asarray(wire, np.float64),
                   "error": ex_state.error.cpu().numpy()}
            for j, p in enumerate(model.param_leaves()):
                res[f"p_{j}"] = p.detach().cpu().numpy()
            state = opt_state_to_jax(opt_state, model)
            res["opt_count"] = state.count
            res["opt_sum_sq"] = state.sum_sq
            res["wire_names"] = np.asarray([nm for nm, _ in trace], dtype=str)
            res["wire_nbytes"] = np.asarray([nb for _, nb in trace], np.int64)
            np.savez(f"{out_dir}/out_{i}_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


MASK_FRAC = 0.25
MASK_QADA_EVERY = 1000  # no refresh inside the test: the merged histogram is held


def mask_config(compressor, mode, bits, qada):
    """The exchange of a masked case: qgenx / layerwise at bucket 256
    (layerwise's threshold that of :data:`LAYERWISE_TREE`), none, randk or
    the contractive tier at :data:`MASK_FRAC`; ``qada`` adds the QAda
    schedule (its histogram merged, never refreshed)."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.quantization import QuantConfig

    kw = dict(compressor=compressor, mode=mode, rand_frac=MASK_FRAC, ef_topk_frac=MASK_FRAC)
    if compressor == "layerwise":
        return dataclasses.replace(layerwise_config(mode, bits), **(
            dict(level_schedule="qada", level_update_every=MASK_QADA_EVERY) if qada else {}))
    if bits:
        kw["quant"] = QuantConfig(num_levels=15 if bits == 8 else 5, bits=bits, bucket_size=256)
    if qada:
        kw.update(level_schedule="qada", level_update_every=MASK_QADA_EVERY)
    return ExchangeConfig(**kw)


def run_masked(rank, world, store_path, in_path, out_dir, cases, backend, device):
    """Each case ``(compressor, mode, bits, qada)``: ``Exchange.pmean_tree``
    of this worker's tree (``{leaf}_{case}_{rank}``) with this worker's
    liveness mask (``mask_{case}_{rank}``), then the same exchange with no
    mask, each with the noise ``noise_{case}_{rank}_{j}`` replayed.  Saves
    the means' leaves concatenated in tree order (``mean``,
    ``mean_nomask``) and the new states' histograms and call counts."""
    import torch

    from repro_torch.core import exchange as xmod
    from repro_torch.core.noise import ReplayNoise

    dev = torch.device(device)
    data = np.load(in_path)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for i, case in enumerate(cases):
            ex = xmod.make_exchange(mask_config(*case), xmod.ProcessGroupComm())
            tree = {name: torch.from_numpy(data[f"{name}_{i}_{rank}"]).to(dev)
                    for name in LAYERWISE_TREE}
            mask = torch.tensor(float(data[f"mask_{i}_{rank}"]), dtype=torch.float32,
                                device=dev)
            draws = sorted((k for k in data.files if k.startswith(f"noise_{i}_{rank}_")),
                           key=lambda k: int(k.rsplit("_", 1)[1]))
            res = {}
            for tag, m in (("", mask), ("_nomask", None)):
                noise = ReplayNoise([data[k] for k in draws])
                mean, state = ex.pmean_tree(tree, ex.init_state(dev), noise, mask=m)
                if noise.remaining:
                    raise RuntimeError("not every noise draw was used")
                res[f"mean{tag}"] = np.concatenate([mean[k].cpu().numpy().ravel()
                                                    for k in sorted(mean)])
                res[f"hist{tag}"] = state.hist.cpu().numpy()
                res[f"step{tag}"] = np.asarray(state.step)
            np.savez(f"{out_dir}/out_{i}_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def run_layouts(rank, world, store_path, in_path, out_dir, cases, backend, device):
    """Each case ``(config kwargs, calls)`` (``_torch_layouts.port_config``):
    ``calls`` chained ``Exchange.pmean_tree`` calls of this worker's trees
    (``x_{case}_{call}_{rank}_{leaf}``, leaves of ``_torch_layouts.TREE``),
    the state from ``init_state(template=, num_workers=)`` threaded
    through, the noise ``noise_{case}_{rank}_{j}`` replayed.  Saves per call
    the mean's leaves concatenated in leaf order (``mean_{call}``), the
    final ``pending`` and the wire recorder's list."""
    import torch

    import _torch_layouts as lay
    from repro_torch.core import exchange as xmod
    from repro_torch.core.noise import ReplayNoise

    dev = torch.device(device)
    data = np.load(in_path)
    n_leaves = len(lay.tree_paths())
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for i, (kw, calls) in enumerate(cases):
            ex = xmod.make_exchange(lay.port_config(**kw), xmod.ProcessGroupComm())
            trees = [lay.as_tree([torch.from_numpy(data[f"x_{i}_{c}_{rank}_{j}"]).to(dev)
                                  for j in range(n_leaves)]) for c in range(calls)]
            state = ex.init_state(dev, template=trees[0], num_workers=world)
            draws = sorted((k for k in data.files if k.startswith(f"noise_{i}_{rank}_")),
                           key=lambda k: int(k.rsplit("_", 1)[1]))
            noise = ReplayNoise([data[k] for k in draws])
            res = {}
            xmod.wire_trace_start()
            for c, tree in enumerate(trees):
                mean, state = ex.pmean_tree(tree, state, noise)
                res[f"mean_{c}"] = np.concatenate([m.cpu().numpy().ravel()
                                                   for m in xmod.tree_flatten(mean)[0]])
            trace = xmod.wire_trace_stop()
            if noise.remaining:
                raise RuntimeError("not every noise draw was used")
            res["pending"] = state.pending.cpu().numpy()
            res["wire_names"] = np.asarray([nm for nm, _ in trace], dtype=str)
            res["wire_nbytes"] = np.asarray([nb for _, nb in trace], np.int64)
            np.savez(f"{out_dir}/out_{i}_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def run_layout_step(rank, world, store_path, in_path, out_dir, cases, backend, device):
    """Each case name of ``_torch_layouts.STEP_CASES``: the port's qgenx
    ``de`` train step on reduced tinyllama-1.1b from the reference's
    initial params (``{case}_p0_{j}``), on this worker's rows of each
    step's batch, with this worker's draws replayed
    (``{case}_noise_{rank}_{i}``).  Saves ``out_{i}_{rank}.npz``: the
    losses and ``wire_bytes``, the final params (``p_{j}``) and the wire
    recorder's list of the first step."""
    import torch

    import _torch_layouts as lay
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core import exchange as xmod
    from repro_torch.core.noise import ReplayNoise
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build
    from repro_torch.optim import optimizers as opt
    from repro_torch.optim.optimizers import OptimizerConfig

    dev = torch.device(device)
    data = np.load(in_path)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for i, case in enumerate(cases):
            n_leaves = sum(1 for k in data.files if k.startswith(f"{case}_p0_"))
            model = params_from_jax([data[f"{case}_p0_{j}"] for j in range(n_leaves)],
                                    build(get_config("tinyllama-1.1b").reduced(), device=dev))
            ex = xmod.make_exchange(lay.step_config(case), xmod.ProcessGroupComm())
            opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=0.02, method="de")
            step = make_train_step(model, opt_cfg, ex)
            opt_state = opt.init_state(opt_cfg, model.param_leaves())
            ex_state = ex.init_state(dev, template=model.param_leaves(), num_workers=world)
            draws = sorted((k for k in data.files if k.startswith(f"{case}_noise_{rank}_")),
                           key=lambda k: int(k.rsplit("_", 1)[1]))
            noise = ReplayNoise([data[k] for k in draws])
            half = lay.STEP_BATCH // world
            rows = slice(rank * half, (rank + 1) * half)
            loss, wire, trace = [], [], None
            for t in range(lay.STEP_COUNT):
                batch = to_device({"tokens": data[f"{case}_tokens_{t}"],
                                   "labels": data[f"{case}_labels_{t}"]}, dev, rows)
                if t == 0:
                    xmod.wire_trace_start()
                opt_state, ex_state, m = step(opt_state, ex_state, batch, noise)
                if t == 0:
                    trace = xmod.wire_trace_stop()
                loss.append(float(m["loss"]))
                wire.append(float(m["wire_bytes"]))
            if noise.remaining:
                raise RuntimeError("not every noise draw was used")
            res = {"loss": np.asarray(loss, np.float64), "wire_bytes": np.asarray(wire, np.float64)}
            for j, p in enumerate(model.param_leaves()):
                res[f"p_{j}"] = p.detach().cpu().numpy()
            res["wire_names"] = np.asarray([nm for nm, _ in trace], dtype=str)
            res["wire_nbytes"] = np.asarray([nb for _, nb in trace], np.int64)
            np.savez(f"{out_dir}/out_{i}_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()
