"""The port's guarded train step (``make_train_step(..., guard=True,
fault_spec=...)``) against the reference's at K = 1 (reduced
tinyllama-1.1b, f32, the ``shard_map`` shim of ``tests/test_torch_step.py``),
every exchange's noise replayed.

* Fault-free (qgenx ``de`` int8 under QAda, ``optda`` under
  ``ef21-topk``): a guarded step, and one whose spec has only inactive
  ``drop`` events (an all-ones mask), is bit-equal to the unguarded step
  (params, optimizer and exchange state, metrics); ``ef21-topk`` refuses
  the mask with the reference's ``ValueError``.
* One case per optimizer branch and per ported compressor, 2 steps with a
  fault at step 1 (``nan_grad`` or ``wire_corrupt``): step 1 is rejected
  with ``nonfinite`` 1 in both packages, and the port's carried state
  after it (the params written in place, every optimizer state field with
  its ``count``, every ``ExchangeState`` field with the in-place EF memory
  ``error``) is bit-equal to the state before it.  ``rejected``,
  ``nonfinite``, ``alive`` and ``wire_bytes`` (not zeroed on a rejected
  step) equal the reference's exactly, ``coded_bits_est`` rtol 1e-5 (0 on
  the rejected step in both), the losses rtol 1e-5 (NaN in the same
  places), and the final params to the bars of ``test_torch_step.py``
  (quantized qgenx: rtol 1e-5 / atol 1e-6 on all but 1e-5 of the
  coordinates; the adam family: all but 1e-4, each within 2 lr; exact
  exchanges: rtol 1e-5 / atol 1e-6 everywhere).  The reference runs its
  jnp path (``use_pallas=False``), which at K = 1 computes what its Pallas
  path does (they differ only in the K-mean's last ulp, C2 in
  ROADMAP.md).
* QAda: a refresh that falls on a poisoned exchange call.  Guarded, both
  packages reject the step and keep the pre-step tables, and the port
  raises nothing; unguarded, the port raises ``ValueError`` on the
  non-finite histogram while the reference solves it into a finite,
  degenerate table (every interior level crowded at 0) and carries on.
* The CLI: ``--guard --rollback-after 2 --fault-spec
  "nan_grad@1;wire_corrupt@3-4"`` gives the reference CLI's ``REJECTED``
  tails, rollback line and ``[train] guard:`` summary.
"""

import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import repro.launch.steps as jax_steps
from repro.configs.registry import get_config as jax_get_config
from repro.core import adaptive_levels as jqada
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.exchange import make_exchange as jax_make_exchange
from repro.core.faults import FaultSpec as JaxFaultSpec
from repro.core.quantization import QuantConfig as JaxQuant
from repro.models.model import build as jax_build
from repro.optim import optimizers as jax_opt
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.exchange import ExchangeConfig, make_exchange
from repro_torch.core.faults import FaultSpec
from repro_torch.core.noise import ReplayNoise
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim.optimizers import OptimizerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BATCH, SEQ, GAMMA, BUCKET, FRAC = 4, 16, 0.02, 512, 0.25
LR = OptimizerConfig().lr


def _shard_map_shim(f, *, mesh, in_specs, out_specs, check_rep=False, auto=frozenset()):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         axis_names=set(mesh.axis_names) - set(auto), check_vma=check_rep)


@pytest.fixture
def reference(monkeypatch):
    monkeypatch.setattr(jax_steps, "shard_map", _shard_map_shim)
    model = jax_build(jax_get_config("tinyllama-1.1b").reduced())
    params = model.init(jax.random.PRNGKey(0))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _batches(n):
    pipe = make_pipeline(512, BATCH, SEQ, seed=0)
    return [next(pipe) for _ in range(n)]


def _keys(n, seed=11):
    return [jax.random.fold_in(jax.random.PRNGKey(seed), t) for t in range(n)]


@dataclasses.dataclass(frozen=True)
class Case:
    name: str  # optimizer
    method: str
    compressor: str
    bits: int = 0  # 0: no quantizer
    mode: str = "two_phase"
    spec: str = ""
    qada_every: int = 0

    def ex_kw(self):
        kw = dict(compressor=self.compressor, mode=self.mode, rand_frac=FRAC,
                  ef_topk_frac=FRAC)
        if self.qada_every:
            kw.update(level_schedule="qada", level_update_every=self.qada_every)
        return kw

    def quant(self, cls):
        if not self.bits:
            return None
        return cls(num_levels=15 if self.bits == 8 else 5, bits=self.bits, bucket_size=BUCKET)

    def jax_cfg(self):
        return JaxExchangeConfig(quant=self.quant(JaxQuant), use_pallas=False, **self.ex_kw())

    def port_cfg(self):
        return ExchangeConfig(quant=self.quant(QuantConfig), **self.ex_kw())

    def exchange_keys(self, key):
        k1, k2 = jax.random.split(key)
        one = self.name in ("adam", "optimistic_adam") or (
            self.name == "qgenx" and self.method == "optda")
        return [k2] if one else [k1, k2]


def _draws(case, key, leaves):
    """The reference's noise draws of one step at K = 1, in the order the
    port's exchanges ask for them."""
    n = sum(a.size for a in leaves)
    draws = []
    for ek in case.exchange_keys(key):
        if case.compressor in ("qgenx",):
            a, b = jax.random.split(jax.random.fold_in(ek, 0))
            rows = -(-n // BUCKET)
            draws.append(np.asarray(jax.random.uniform(a, (rows, BUCKET))))
            if case.mode == "two_phase":
                draws.append(np.asarray(jax.random.uniform(b, (rows, BUCKET))))
        elif case.compressor == "layerwise":
            plan = make_exchange(case.port_cfg()).plan_for(
                [torch.from_numpy(np.asarray(a)) for a in leaves])
            for seg in plan.segments:
                rows = seg.padded // seg.quant.bucket_size
                a, b = jax.random.split(jax.random.fold_in(jax.random.fold_in(ek, seg.key_tag),
                                                           0))
                draws += [np.asarray(jax.random.uniform(a, (rows, seg.quant.bucket_size))),
                          np.asarray(jax.random.uniform(b, (rows, seg.quant.bucket_size)))]
        elif case.compressor == "randk":
            k = max(1, round(FRAC * n))
            draws.append(np.asarray(jax.random.permutation(jax.random.fold_in(ek, 0), n)[:k]))
    return draws


METRICS = ("loss", "wire_bytes", "coded_bits_est", "rejected", "nonfinite", "alive")


def _run_reference(model, params_np, case, batches, keys, guard=True):
    """Per step: the metrics, the params (leaves in JAX order), the
    optimizer state and exchange state (numpy trees)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    opt_cfg = jax_opt.OptimizerConfig(name=case.name, gamma_scale=GAMMA, method=case.method)
    # the step's outputs are replicated over the mesh: so are its first
    # inputs, or the second call compiles the step again
    repl = NamedSharding(mesh, P())
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params_np), repl)
    opt_state = jax.device_put(jax_opt.init_state(opt_cfg, params), repl)
    ex = jax_make_exchange(case.jax_cfg())
    ex_state = jax.device_put(ex.init_state(template=params, num_workers=1), repl)
    spec = JaxFaultSpec.parse(case.spec)
    fn = jax_steps.make_train_step(model, opt_cfg, exchange=ex, mesh=mesh, guard=guard,
                                   fault_spec=spec if spec.events else None)
    step = jax.jit(fn)
    out = []
    with mesh:
        for t, (b, key) in enumerate(zip(batches, keys)):
            batch = {k: jnp.asarray(v) for k, v in b.items()}
            args = [params, opt_state, ex_state, batch, key]
            if spec.has_device_events:
                args.append(jnp.int32(t))
            params, opt_state, ex_state, m = step(*args)
            out.append({"metrics": {k: float(m[k]) for k in METRICS},
                        "params": [np.asarray(l) for l in jax.tree_util.tree_leaves(params)],
                        "opt": jax.tree_util.tree_map(np.asarray, opt_state),
                        "ex": jax.tree_util.tree_map(np.asarray, ex_state)})
    return out


def _run_port(params_np, case, batches, keys, guard=True, spec=None):
    model = params_from_jax(params_np, build(get_config("tinyllama-1.1b").reduced(),
                                             device="cpu"))
    opt_cfg = OptimizerConfig(name=case.name, gamma_scale=GAMMA, method=case.method)
    ex = make_exchange(case.port_cfg())
    spec = FaultSpec.parse(case.spec if spec is None else spec)
    step = make_train_step(model, opt_cfg, ex, guard=guard,
                           fault_spec=spec if spec.events else None)
    opt_state = port_opt.init_state(opt_cfg, model.param_leaves())
    ex_state = ex.init_state("cpu", template=model.param_leaves(), num_workers=1)
    leaves = jax.tree_util.tree_leaves(params_np)
    noise = ReplayNoise([d for key in keys for d in _draws(case, key, leaves)])
    out = []
    for t, b in enumerate(batches):
        kw = {"fault_step": t} if spec.has_device_events else {}
        opt_state, ex_state, m = step(opt_state, ex_state, to_device(b, "cpu"), noise, **kw)
        out.append({"metrics": {k: float(m[k]) for k in METRICS},
                    "params": [p.detach().numpy().copy() for p in model.param_leaves()],
                    # copies: .numpy() of a CPU tensor shares its memory, and
                    # the step writes the EF memory in place
                    "opt": copy.deepcopy(convert.opt_state_to_jax(opt_state, model)),
                    "ex": copy.deepcopy(convert.ex_state_to_jax(ex_state))})
    assert noise.remaining == 0
    return out


def _leaves(tree) -> list:
    """Leaves of a numpy state tree; the port's ExchangeState (not a JAX
    pytree) by its fields."""
    if dataclasses.is_dataclass(tree):
        return [np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return jax.tree_util.tree_leaves(tree)


def _state_equal(a, b) -> bool:
    """Bitwise equality of two snapshots' params, optimizer and exchange
    state (every leaf, the counters included)."""
    pairs = list(zip(a["params"], b["params"]))
    for name in ("opt", "ex"):
        la, lb = _leaves(a[name]), _leaves(b[name])
        if len(la) != len(lb):
            return False
        pairs += list(zip(la, lb))
    return all(np.asarray(x).shape == np.asarray(y).shape
               and np.array_equal(np.asarray(x), np.asarray(y)) for x, y in pairs)


def _assert_params_close(case, tp, jp):
    total = sum(a.size for a in jp)
    off = sum(int((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).sum()) for a, b in zip(tp, jp))
    if case.name != "qgenx":
        allowed = 1e-4 * total
        for a, b in zip(tp, jp):
            assert np.abs(a - b).max() <= 2 * LR
    else:
        allowed = 1e-5 * total if (case.bits or case.compressor == "ef21-topk") else 0
        for a, b in zip(tp, jp):
            assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1.0)
    assert off <= allowed, f"{off} of {total} coordinates off"


FAULT_CASES = [
    Case("qgenx", "de", "qgenx", 8, "two_phase", "nan_grad@1"),
    Case("qgenx", "optda", "qgenx", 4, "gather", "wire_corrupt@1"),
    Case("extra_adam", "de", "layerwise", 4, "two_phase", "nan_grad@1"),
    Case("optimistic_adam", "de", "none", 0, "two_phase", "wire_corrupt@1"),
    Case("adam", "de", "randk", 0, "two_phase", "nan_grad@1"),
    Case("qgenx", "de", "ef21-topk", 0, "two_phase", "nan_grad@1"),
]


@pytest.mark.parametrize("case", FAULT_CASES, ids=lambda c: f"{c.name}-{c.method}-"
                         f"{c.compressor}{c.bits or ''}-{c.spec.split('@')[0]}")
def test_rejected_step_carries_the_state(reference, case):
    model, params_np = reference
    batches, keys = _batches(2), _keys(2)
    want = _run_reference(model, params_np, case, batches, keys)
    got = _run_port(params_np, case, batches, keys)
    flags = [[s["metrics"][k] for s in got] for k in ("rejected", "nonfinite", "alive")]
    assert flags == [[0.0, 1.0], [0.0, 1.0], [1.0, 1.0]]
    assert flags == [[s["metrics"][k] for s in want] for k in ("rejected", "nonfinite", "alive")]
    assert _state_equal(got[1], got[0]), "the rejected step moved the port's state"
    assert _state_equal(want[1], want[0])
    assert got[1]["ex"].step == got[0]["ex"].step and got[1]["opt"].count == 1
    wires = [s["metrics"]["wire_bytes"] for s in got]
    assert wires == [s["metrics"]["wire_bytes"] for s in want]
    assert wires[1] == wires[0] > 0 or case.compressor == "none"  # not zeroed
    coded = [s["metrics"]["coded_bits_est"] for s in got]
    assert coded[1] == want[1]["metrics"]["coded_bits_est"] == 0.0
    np.testing.assert_allclose(coded, [s["metrics"]["coded_bits_est"] for s in want],
                               rtol=1e-5)
    np.testing.assert_allclose([s["metrics"]["loss"] for s in got],
                               [s["metrics"]["loss"] for s in want], rtol=1e-5)
    _assert_params_close(case, got[-1]["params"], want[-1]["params"])
    if case.compressor == "ef21-topk":
        err = np.asarray(got[-1]["ex"].error)
        assert err.shape == np.asarray(want[-1]["ex"].error).shape and np.abs(err).max() > 0


CLEAN_CASES = [
    Case("qgenx", "de", "qgenx", 8, "two_phase", qada_every=1),
    Case("qgenx", "optda", "ef21-topk"),
]


@pytest.mark.parametrize("case", CLEAN_CASES, ids=lambda c: f"{c.name}-{c.method}-"
                         f"{c.compressor}{c.bits or ''}{'-qada' if c.qada_every else ''}")
def test_fault_free_guarded_steps_are_bit_equal_to_unguarded(reference, case):
    _, params_np = reference
    batches, keys = _batches(2), _keys(2, seed=5)
    plain = _run_port(params_np, case, batches, keys, guard=False)
    for spec in ("", "drop@7:worker=0"):  # an inactive drop: an all-ones mask
        if spec and case.compressor == "ef21-topk":  # refuses any mask, as the reference
            with pytest.raises(ValueError, match="partial-participation masks"):
                _run_port(params_np, case, batches, keys, guard=True, spec=spec)
            continue
        guarded = _run_port(params_np, case, batches, keys, guard=True, spec=spec)
        for a, b in zip(guarded, plain):
            assert _state_equal(a, b)
            assert a["metrics"] == b["metrics"]


def test_qada_refresh_on_a_poisoned_call(reference):
    """level_update_every=3 under de: calls 0 and 1 at step 0, call 2 (a
    refresh) at step 1, where the gradient is NaN."""
    model, params_np = reference
    case = Case("qgenx", "de", "qgenx", 8, "two_phase", "nan_grad@1", qada_every=3)
    batches, keys = _batches(3), _keys(3, seed=7)
    want = _run_reference(model, params_np, case, batches, keys)
    got = _run_port(params_np, case, batches, keys)
    assert [s["metrics"]["rejected"] for s in got] == \
        [s["metrics"]["rejected"] for s in want] == [0.0, 1.0, 0.0]
    for run in (got, want):
        assert _state_equal(run[1], run[0])
        assert int(run[1]["ex"].step) == 2 and int(run[2]["ex"].step) == 4
    # step 2 refreshes from a finite histogram at its first call
    np.testing.assert_allclose(got[2]["ex"].levels, want[2]["ex"].levels, atol=5e-4)
    assert not np.array_equal(got[2]["ex"].levels, got[0]["ex"].levels)

    # unguarded: the port raises; the reference's solve (what its unguarded
    # step runs on that call) turns the NaN histogram into a finite,
    # degenerate table and carries on
    with pytest.raises(ValueError, match="QAda histogram is not finite"):
        _run_port(params_np, case, batches[:2], keys[:2], guard=False)
    levels = np.asarray(jqada.optimize_levels(jnp.asarray(want[0]["ex"].levels),
                                              jnp.full((512,), jnp.nan), sweeps=2,
                                              bisect_iters=20))
    assert np.isfinite(levels).all() and levels[-2] < 1e-3 and levels[-1] == 1.0


def _cli_lines(text):
    """The step lines' step number and tail (loss and times dropped), the
    fault, rollback and guard lines."""
    out = []
    for line in text.splitlines():
        m = re.match(r"\[train\] step=(\d+) .* wire=\S+B(.*)$", line)
        if m:
            out.append(("step", int(m.group(1)), m.group(2).strip()))
        elif "rolled back" in line or "guard:" in line or "WARNING" in line:
            out.append(("line", line.strip()))
    return out


def test_cli_guard_tails_and_summary_match_the_reference(capsys):
    """The reference CLI runs no exchange at one device, so a
    ``wire_corrupt`` event never fires there: the comparison schedules
    ``nan_grad`` at the same steps; the port alone runs the mixed spec."""
    from repro.launch import train as jax_train

    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "6", "--batch", "4",
            "--seq", "16", "--optimizer", "adam", "--guard", "--rollback-after", "2"]
    port_argv = argv + ["--device", "cpu", "--compressor", "none"]
    want = [("step", 0, ""), ("step", 1, "REJECTED"), ("step", 2, ""),
            ("step", 3, "REJECTED"),
            ("line", "[train] watchdog: rolled back to the step-3 snapshot "
                     "(nonfinite_steps=3 rejected=3 rollbacks=1)"),
            ("step", 4, "REJECTED"), ("step", 5, ""),
            ("line", "[train] guard: nonfinite_steps=3 rejected=3 rollbacks=1")]
    train.main(port_argv + ["--fault-spec", "nan_grad@1;wire_corrupt@3-4"])
    assert _cli_lines(capsys.readouterr().out) == want
    train.main(port_argv + ["--fault-spec", "nan_grad@1;nan_grad@3-4"])
    port = _cli_lines(capsys.readouterr().out)
    jax_train.main(argv + ["--fault-spec", "nan_grad@1;nan_grad@3-4"])
    assert port == _cli_lines(capsys.readouterr().out) == want


def test_cli_warns_without_guard_and_injects_ckpt_faults(tmp_path, capsys):
    from repro_torch.checkpoint import checkpointing

    argv = ["--reduced", "--steps", "3", "--batch", "4", "--seq", "16", "--device", "cpu",
            "--optimizer", "adam", "--fault-spec", "wire_corrupt@1;ckpt_truncate@2",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "1"]
    out = train.run(train.parser().parse_args(argv))
    log = capsys.readouterr().out
    assert "[train] WARNING: device faults scheduled without --guard" in log
    assert "[train] fault: injected ckpt_truncate into checkpoint 2" in log
    assert out["rejected"] == [0.0, 0.0, 0.0] and out["guard"] is None
    assert np.isnan(out["loss"][2])  # unguarded, the corrupt mean reached the params
    assert checkpointing.latest_step(str(tmp_path)) == 3
    template = {"params": convert.params_tree(build(get_config("tinyllama-1.1b").reduced(),
                                                    device="cpu"))}
    with pytest.raises(checkpointing.CheckpointCorruptError):
        checkpointing.restore(str(tmp_path), template, step=2)
