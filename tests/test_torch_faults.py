"""The port's fault layer (``repro_torch.core.faults``, ``BackoffPolicy``)
against the reference's ``repro.core.faults`` / ``repro.core.retry``.

Held bit for bit: the grammar and its error messages in both scopes; each
injector on the same numpy inputs (f32 and bf16 leaves, ``-0.0``
included: an inactive event still adds ``+0.0``, which turns ``-0.0``
into ``+0.0``); ``tree_all_finite``; the watchdog's verdicts on the same
sequences; ``BackoffPolicy`` delays.  ``inject_ckpt_fault`` of either
package leaves the same bytes on disk, and both packages' restores walk
back to the same step.
"""

import argparse
import filecmp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jax_ckpt
from repro.core import faults as jf
from repro.core import retry as jretry
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.core import faults as tf
from repro_torch.core import retry as tretry
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SPECS = [
    "",
    "nan_grad@5:worker=2; drop@8-10:worker=3 ;wire_corrupt@6;ckpt_truncate@12",
    "nan_grad@1;wire_corrupt@3-4",
    "nan_grad@1:worker=0;drop@2:worker=1",
    "drop@0-3;ckpt_drop_meta@2-4;ckpt_garbage_latest@4",
    "nan_logits@5:slot=2;slot_drop@8;page_corrupt@6:slot=1;request_stall@4:slot=0;crash@7",
    "nan_logits@2-3;crash@1-2;;",
]

BAD_SPECS = ["nan_grad", "meteor_strike@5", "nan_grad@x", "drop@9-5", "drop@1:rank=2",
             "drop@1:worker=x", "nan_grad@1-y", "nan_logits@3:slot=", " @4"]


def _events(spec):
    return [(e.kind, e.start, e.end, e.worker, e.slot) for e in spec.events]


def test_constants_match():
    for name in ("DEVICE_KINDS", "HOST_KINDS", "SERVE_KINDS", "ALL_KINDS", "TRAIN_SCOPE",
                 "SERVE_SCOPE", "CRASH_EXIT_CODE"):
        assert getattr(tf, name) == getattr(jf, name), name


@pytest.mark.parametrize("text", SPECS)
def test_grammar_and_queries_match(text):
    j, t = jf.FaultSpec.parse(text), tf.FaultSpec.parse(text)
    assert _events(t) == _events(j)
    assert t.has_device_events == j.has_device_events
    assert t.has_serve_device_events == j.has_serve_device_events
    for kind in tf.ALL_KINDS:
        assert t.has(kind) == j.has(kind)
        assert [(e.start, e.end) for e in t.of_kind(kind)] == \
            [(e.start, e.end) for e in j.of_kind(kind)]
    for step in range(14):
        assert t.ckpt_faults_at(step) == j.ckpt_faults_at(step)
        assert t.crash_at(step) == j.crash_at(step)
        for kind in tf.SERVE_KINDS:
            assert t.slots_hit(kind, step) == j.slots_hit(kind, step)
    assert tf.FaultSpec.parse(None).events == ()


def _raises(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("text", BAD_SPECS)
def test_bad_specs_raise_the_same_message(text):
    assert _raises(tf.FaultSpec.parse, text) == _raises(jf.FaultSpec.parse, text)


@pytest.mark.parametrize("text,scope", [
    ("nan_logits@1", "train"), ("crash@3", "train"), ("nan_grad@1", "serve"),
    ("drop@2:worker=1", "serve"), ("nan_grad@1", "bogus"),
])
def test_scopes_reject_the_other_scopes_kinds(text, scope, capsys):
    assert _raises(tf.FaultSpec.parse_cli, text, scope) == \
        _raises(jf.FaultSpec.parse_cli, text, scope)
    if scope == "bogus":
        return
    errs = []
    for mod in (tf, jf):
        with pytest.raises(SystemExit) as e:
            mod.parse_fault_spec_arg(text, scope)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "bad --fault-spec" in errs[0]


@pytest.mark.parametrize("scope", ["train", "serve"])
def test_flag_help_matches(scope):
    helps = []
    for mod in (tf, jf):
        ap = argparse.ArgumentParser(prog="x")
        mod.add_fault_spec_flag(ap, scope)
        helps.append(ap.format_help())
        assert ap.parse_args(["--fault-spec", "drop@1"]).fault_spec == "drop@1"
    assert helps[0] == helps[1]
    kept = tf.parse_fault_spec_arg("ckpt_truncate@2", scope)
    assert _events(kept) == [("ckpt_truncate", 2, 2, None, None)]


def _bits(x):
    """(NaN mask, the non-NaN coordinates' bit patterns) of a numpy or
    torch array (f32 or bf16)."""
    if torch.is_tensor(x):
        isnan = torch.isnan(x).numpy()
        raw = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    else:
        x = np.asarray(x)
        isnan = np.isnan(x.astype(np.float32))
        raw = x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)
    return isnan, np.where(isnan, 0, raw)


def _assert_bits_equal(got, want):
    gn, gb = _bits(got)
    wn, wb = _bits(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gb, wb)


def _tree_np(rng):
    """f32 and bf16 leaves with signed zeros, infinities and a NaN."""
    a = rng.randn(5, 3).astype(np.float32)
    a[0, 0], a[1, 1], a[2, 2] = -0.0, 0.0, -np.inf
    b = rng.randn(7).astype(np.float32)
    b[3] = -0.0
    c = rng.randn(4).astype(np.float32)
    c[1] = np.nan
    return {"a": a, "b": b, "c": c}


def _to_jax(tree, bf16=("b",)):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
            for k, v in tree.items()}


def _to_torch(tree, bf16=("b",)):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf16 else torch.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("text", ["nan_grad@2:worker=1;wire_corrupt@3-4",
                                  "nan_grad@1-2;wire_corrupt@4:worker=1",
                                  "drop@1:worker=0;nan_grad@9"])
def test_injectors_match_bit_for_bit(text):
    rng = np.random.RandomState(0)
    j, t = jf.FaultSpec.parse(text), tf.FaultSpec.parse(text)
    for step in range(6):
        for worker in range(3):
            tree = _tree_np(rng)
            want = j.poison_grads(_to_jax(tree), jnp.int32(step), jnp.int32(worker))
            got = t.poison_grads(_to_torch(tree), step, worker)
            for k in tree:
                _assert_bits_equal(got[k], want[k])
            jl = j.liveness(jnp.int32(step), jnp.int32(worker))
            tl = t.liveness(step, worker, "cpu")
            assert (tl is None) == (jl is None)
            if tl is not None:
                assert tl.dtype == torch.float32 and float(tl) == float(jl)
        tree = _tree_np(rng)
        want = j.corrupt_mean(_to_jax(tree), jnp.int32(step))
        got = t.corrupt_mean(_to_torch(tree), step)
        for k in tree:
            _assert_bits_equal(got[k], want[k])


def test_injectors_without_events_return_their_input():
    spec = tf.FaultSpec.parse("ckpt_truncate@1;crash@2")
    tree = _to_torch(_tree_np(np.random.RandomState(1)))
    assert spec.poison_grads(tree, 1, 0) is tree
    assert spec.corrupt_mean(tree, 1) is tree
    assert spec.liveness(1, 0, "cpu") is None
    logits = torch.randn(3, 4)
    assert spec.poison_logits(logits, 1) is logits


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_poison_logits_matches(dtype):
    rng = np.random.RandomState(2)
    j = jf.FaultSpec.parse("nan_logits@2:slot=1;nan_logits@4-5;nan_logits@5:slot=3")
    t = tf.FaultSpec.parse("nan_logits@2:slot=1;nan_logits@4-5;nan_logits@5:slot=3")
    for step in range(7):
        x = rng.randn(4, 6).astype(np.float32)
        x[0, 0] = -0.0
        if dtype == "bfloat16":
            want = j.poison_logits(jnp.asarray(x, jnp.bfloat16), jnp.int32(step))
            got = t.poison_logits(torch.from_numpy(x).to(torch.bfloat16), step)
        else:
            want = j.poison_logits(jnp.asarray(x), jnp.int32(step))
            got = t.poison_logits(torch.from_numpy(x), step)
        _assert_bits_equal(got, want)


@pytest.mark.parametrize("case", range(6))
def test_tree_all_finite_matches(case, monkeypatch):
    monkeypatch.setattr(tf, "FINITE_CHUNK", 4)  # several chunks a leaf
    rng = np.random.RandomState(case)
    leaves = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(9).astype(np.float32),
              "n": np.arange(4, dtype=np.int32)}
    bad = [None, ("a", (4, 2), np.nan), ("b", 8, np.inf), ("b", 0, -np.inf),
           ("n", 0, 7), None][case]
    if bad is not None:
        leaves[bad[0]][bad[1]] = bad[2]
    jt = {k: jnp.asarray(v) for k, v in leaves.items()}
    tt = {k: torch.from_numpy(v) for k, v in leaves.items()}
    want = bool(jf.tree_all_finite(jt, {"s": jnp.float32(1.0)}))
    got = tf.tree_all_finite(tt, [torch.tensor(1.0)], None, 3)
    assert got.dtype == torch.bool and bool(got) == want
    assert bool(tf.tree_all_finite({"i": torch.tensor(7)})) == \
        bool(jf.tree_all_finite({"i": jnp.int32(7)})) is True
    assert bool(tf.tree_all_finite(torch.zeros((0,)))) is True


def _verdicts(seed, n):
    rng = np.random.RandomState(seed)
    return [(bool(r), bool(r) or bool(f)) for r, f in
            zip(rng.rand(n) < 0.45, rng.rand(n) < 0.2)]


@pytest.mark.parametrize("kw,seed", [
    (dict(rollback_after=3), 0), (dict(rollback_after=2), 1),
    (dict(rollback_after=3, divergence_rate=0.5, window=6), 2),
    (dict(rollback_after=1), 3), (dict(rollback_after=4, divergence_rate=0.25), 4),
])
def test_watchdog_verdicts_match(kw, seed):
    j, t = jf.Watchdog(**kw), tf.Watchdog(**kw)
    for step, (rejected, nonfinite) in enumerate(_verdicts(seed, 40)):
        fire_j = j.observe(step, rejected, nonfinite)
        fire_t = t.observe(step, rejected, nonfinite)
        assert fire_t == fire_j, step
        if fire_j:
            sj, _ = j.rollback()
            st, _ = t.rollback()
            assert st == sj
        elif not rejected and step % 3 == 0:
            j.record_good(step + 1, {"x": jnp.full((2,), step, jnp.float32)})
            t.record_good(step + 1, {"x": torch.full((2,), float(step))})
        assert (t.consecutive, t.rejected_steps, t.nonfinite_steps, t.rollbacks) == \
            (j.consecutive, j.rejected_steps, j.nonfinite_steps, j.rollbacks)
        assert t.summary() == j.summary()
        assert t.snapshot_step == j.snapshot_step


def test_watchdog_snapshot_is_a_copy_and_reuses_its_buffers():
    import dataclasses

    from repro_torch.core.exchange import ExchangeState
    from repro_torch.optim.optimizers import AdamState

    params = [torch.randn(3, 4), torch.randn(5).to(torch.bfloat16)]
    opt_state = AdamState(mu=[torch.zeros(3, 4)], nu=[torch.ones(3, 4)], count=4,
                          prev_half_grad=None)
    ex_state = ExchangeState(levels=torch.linspace(0, 1, 5), levels_lo=torch.zeros(3),
                             hist=torch.zeros(1), step=7, error=torch.randn(1, 12),
                             pending=torch.zeros(1))
    wd = tf.Watchdog(rollback_after=1)
    wd.record_good(3, {"params": params, "opt_state": opt_state, "ex_state": ex_state})
    want = [p.clone() for p in params], ex_state.error.clone()
    buffers = [t.data_ptr() for t in tf._tensors(wd._snapshot[1])]
    assert wd.snapshot_bytes == sum(t.numel() * t.element_size()
                                    for t in tf._tensors(wd._snapshot[1]))
    for p in params:  # the step writes in place
        p.add_(1.0)
    ex_state.error.mul_(2.0)
    assert wd.observe(3, True, True)
    step, trees = wd.rollback("cpu")
    assert step == 3 and wd.rollbacks == 1
    for got, w in zip(trees["params"], want[0]):
        assert got.dtype == w.dtype and torch.equal(got, w)
    assert torch.equal(trees["ex_state"].error, want[1])
    assert trees["ex_state"].step == 7 and trees["opt_state"].count == 4
    assert trees["opt_state"].prev_half_grad is None
    assert isinstance(trees["ex_state"], ExchangeState)
    trees["params"][0].zero_()  # the rollback's tensors are copies too
    wd.record_good(5, {"params": params, "opt_state": opt_state,
                       "ex_state": dataclasses.replace(ex_state, step=8)})
    assert [t.data_ptr() for t in tf._tensors(wd._snapshot[1])] == buffers
    _, again = wd.rollback()
    assert torch.equal(again["params"][0], params[0]) and again["ex_state"].step == 8


def test_watchdog_validates_args_as_the_reference():
    for kw in (dict(rollback_after=0), dict(divergence_rate=1.5), dict(divergence_rate=0.0)):
        with pytest.raises(ValueError) as a:
            tf.Watchdog(**kw)
        with pytest.raises(ValueError) as b:
            jf.Watchdog(**kw)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("kw", [dict(), dict(base=0.5, factor=3.0, cap=7.0, jitter=0.25),
                                dict(jitter=0.0, max_attempts=5), dict(base=0.0)])
def test_backoff_delays_match(kw):
    j, t = jretry.BackoffPolicy(**kw), tretry.BackoffPolicy(**kw)
    for attempt in range(8):
        for token in (0, 17, "req-3", (1, 2)):
            assert t.delay(attempt, token) == j.delay(attempt, token)
        assert t.exhausted(attempt) == j.exhausted(attempt)
    assert t.delay(2) == j.delay(2)


@pytest.mark.parametrize("kw", [dict(max_attempts=0), dict(base=-1.0), dict(factor=0.5),
                                dict(cap=-2.0), dict(jitter=1.0)])
def test_backoff_validation_matches(kw):
    with pytest.raises(ValueError) as a:
        tretry.BackoffPolicy(**kw)
    with pytest.raises(ValueError) as b:
        jretry.BackoffPolicy(**kw)
    assert str(a.value) == str(b.value)
    assert _raises(tretry.BackoffPolicy().delay, -1) == _raises(jretry.BackoffPolicy().delay, -1)


def _save_steps(d, steps):
    for s in steps:
        ckpt.save(str(d), s, {"params": {"w": torch.full((4, 3), float(s))},
                              "opt_state": {"m": torch.full((2,), s / 2.0)}})


@pytest.mark.parametrize("kind,want_step", [("ckpt_truncate", 2), ("ckpt_drop_meta", 2),
                                            ("ckpt_garbage_latest", 3)])
def test_ckpt_faults_walk_back_in_both_packages(kind, want_step, tmp_path):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    _save_steps(port_dir, (1, 2, 3))
    shutil.copytree(port_dir, ref_dir)
    tf.inject_ckpt_fault(str(port_dir), 3, kind)
    jf.inject_ckpt_fault(str(ref_dir), 3, kind)
    same = filecmp.cmpfiles(port_dir, ref_dir, sorted(p.name for p in ref_dir.iterdir()),
                            shallow=False)
    assert not same[1] and not same[2]
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in ref_dir.iterdir())
    templates = {"params": {"w": torch.zeros(4, 3)}, "opt_state": {"m": torch.zeros(2)}}
    step, trees, reset = ckpt.restore_with_fallback(str(port_dir), templates)
    jtemplates = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), templates)
    jstep, jtrees, jreset = jax_ckpt.restore_with_fallback(str(port_dir), jtemplates)
    assert step == jstep == want_step and reset == jreset == ()
    assert torch.equal(trees["params"]["w"], torch.full((4, 3), float(want_step)))
    np.testing.assert_array_equal(np.asarray(jtrees["params"]["w"]),
                                  trees["params"]["w"].numpy())


def test_unknown_ckpt_fault_raises_the_same_message(tmp_path):
    assert _raises(tf.inject_ckpt_fault, str(tmp_path), 1, "ckpt_melt") == \
        _raises(jf.inject_ckpt_fault, str(tmp_path), 1, "ckpt_melt")
