"""The port's serving engine (``repro_torch.serve.engine.ServeEngine``)
against the reference's (``repro.serve.engine.ServeEngine``), reduced
tinyllama-1.1b (f32), the same params, page size 4, 3 slots.

Both engines run the same requests; the port's cache draws are the
reference's ``jax.random`` draws recomputed per request, position, layer
and K/V (``_torch_serve_common.JaxCacheNoise``), and with a logit
exchange its exchange draws too.  Held equal: every request's typed
result, the event list (admissions, retirements, evictions, faults, each
at its wave and slot), the scheduler's stats, the free pages, the wire
bytes.  Tokens are equal except where the port's logits put the top two
within ``GAP_TOL`` of each other at the first token that differs (the
frameworks' logits agree to rtol 1e-5, ``test_torch_serve_model.py``; a
request is compared up to that token).

Cases: int8 / int4 / fp32 continuous batching on a tight arena; the
guard and each fault drill (``nan_logits``, ``page_corrupt``,
``request_stall``, ``slot_drop``); the int8 two_phase logit exchange at
K = 1 (the reference on a 1-device mesh, in this process) under a drill
of three faults.  The reference's eager ``corrupt_page`` on a mesh-
sharded arena raises on this jax (an ``.at[].set`` needs an
``out_sharding``); the test gathers the arena to the host for it and
puts it back with its sharding (no JAX file changes).

Port-only: the guard bit-equal to no guard without faults, a transient
rejection recovered by one re-keyed retry, a request's tokens equal alone
and packed with the native keyed draw, snapshots (resume from committed
tokens, the reference engine restoring the port's snapshot, a torn write
walked back, a fingerprint refused), the workload-file parser against the
reference's, and the CLI (the reference CLI's lines; serving a checkpoint
of the port's train CLI; a mismatched checkpoint exits 2).
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as jax_engine
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig
from repro.core.faults import FaultSpec as JaxFaultSpec
from repro.core.quantization import QuantConfig as JaxQuant
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.checkpoint import checkpointing
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.core.faults import FaultSpec
from repro_torch.core.quantization import QuantConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request

from _torch_serve_common import JaxCacheNoise, jax_exchange_noise, port_model, reference_params
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GAP_TOL = 1e-4
BASE = dict(page_size=4, n_slots=3, max_len=32, seed=0)


@pytest.fixture(scope="module")
def setup():
    cfg, params = reference_params()
    return cfg, params, port_model(params)


def _spec(n=7):
    rng = np.random.RandomState(0)
    return [(r, rng.randint(0, 512, size=5 + r % 3).tolist(), 6 - (r % 3) * 2)
            for r in range(n)]


def _logged(monkeypatch, eng):
    """Record the port's logits per (rid, position of the token they give)
    and count the engine's decode invocations."""
    log = {"invocations": 0}
    prefill, decode = T.prefill_paged, T.decode_step_paged

    def pre(model, pc, cache, tokens, pages, noise):
        logits, cache = prefill(model, pc, cache, tokens, pages, noise)
        log["_last"] = logits[0]
        return logits, cache

    def dec(model, pc, cache, token, pos, pt, noise):
        logits, cache = decode(model, pc, cache, token, pos, pt, noise)
        log["_last"] = logits
        return logits, cache

    monkeypatch.setattr(T, "prefill_paged", pre)
    monkeypatch.setattr(T, "decode_step_paged", dec)
    orig_prefill, orig_invoke = eng._prefill_slot, eng._invoke_decode

    def prefill_slot(slot):
        orig_prefill(slot)
        log[(slot.req.rid, len(slot.req.prompt) - 1)] = log["_last"][len(slot.req.prompt) - 1]

    def invoke(token, pos, pt, rows, attempt=0):
        out = orig_invoke(token, pos, pt, rows, attempt)
        log["invocations"] += 1
        for i, row in enumerate(rows):
            if row is not None:
                log[(row[0], row[2])] = log["_last"][i]
        return out

    eng._prefill_slot, eng._invoke_decode = prefill_slot, invoke
    return log


def _gap(row: torch.Tensor) -> float:
    top = torch.topk(row, 2).values
    return float(top[0] - top[1])


def _twin(setup, monkeypatch, requests, *, exchange=False, **kw):
    """Run both engines; assert results, events, stats, pages and wire
    equal; tokens equal up to a near-tie (see the module docstring)."""
    jcfg, params, model = setup
    kw = {**BASE, **kw}
    jkw, pkw = dict(kw), dict(kw)
    if "fault_spec" in kw:
        jkw["fault_spec"] = JaxFaultSpec.parse(kw["fault_spec"])
        pkw["fault_spec"] = FaultSpec.parse(kw["fault_spec"])
    ix = -1
    if exchange:
        q = dict(num_levels=15, bits=8, bucket_size=512)
        jkw.update(exchange=JaxExchangeConfig(compressor="qgenx", quant=JaxQuant(**q),
                                              mode="two_phase", axis_name="data"),
                   mesh=jax.make_mesh((1,), ("data",)))
        pkw.update(exchange=ExchangeConfig(quant=QuantConfig(**q), mode="two_phase"),
                   exchange_noise=jax_exchange_noise(kw["seed"], kw["n_slots"], 512))
        ix = 0
    jeng = jax_engine.ServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params), **jkw)
    jev = []
    jout = jeng.run([JaxRequest(r, p, m) for r, p, m in requests], events=jev)
    peng = ServeEngine(model.cfg, model,
                       cache_noise=JaxCacheNoise(kw["seed"], model.cfg.num_layers,
                                                 model.cfg.num_kv_heads
                                                 * model.cfg.resolved_head_dim, ix=ix),
                       **pkw)
    log = _logged(monkeypatch, peng)
    pev = []
    pout = peng.run([Request(r, p, m) for r, p, m in requests], events=pev)
    jres, pres = jeng.results(), peng.results()
    assert {r: v.kind for r, v in pres.items()} == {r: v.kind for r, v in jres.items()}
    assert pev == jev
    assert peng.sched.stats == jeng.sched.stats
    assert peng.allocator.n_free == jeng.allocator.n_free == peng.pc.num_pages
    if exchange:
        # C3: the port holds the analytic count, wire_per_step an invocation
        assert peng.wire_bytes == jeng.wire_bytes == peng.wire_per_step * log["invocations"]
    plen = {r: len(p) for r, p, _ in requests}
    for rid, jr in jres.items():
        got, want = list(pres[rid].tokens), list(jr.tokens)
        if got == want:
            continue
        k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        row = log[(rid, plen[rid] + k - 1)]  # the logits that gave token k
        assert _gap(row) < GAP_TOL, (rid, k, got, want)
    return jeng, jout, peng, pout, pev


@pytest.mark.parametrize("policy", ["int8", "int4", "fp32"])
def test_engine_matches_reference(setup, monkeypatch, policy):
    _, _, peng, out, events = _twin(setup, monkeypatch, _spec(), policy=policy, num_pages=9)
    st = peng.sched.stats
    assert st["admitted"] == st["retired"] == 7 and st["mid_decode_admits"] > 0
    assert any(e[0] == "admit" and e[3] > 0 for e in events)
    assert all(len(out[r]) == m for r, _, m in _spec())


DRILLS = {
    "clean": ("", {}),
    "nan_logits": ("nan_logits@2:slot=1", {}),
    "page_corrupt": ("page_corrupt@2:slot=0", {}),
    "request_stall": ("request_stall@1:slot=1", {"stall_patience": 2}),
    "slot_drop": ("slot_drop@2", {}),
}


@pytest.mark.parametrize("drill", list(DRILLS))
def test_guard_and_fault_drills_match_reference(setup, monkeypatch, drill):
    spec, extra = DRILLS[drill]
    kw = dict(policy="int8", guard=True, max_len=16, **extra)
    if spec:
        kw["fault_spec"] = spec
    reqs = [(r, [(r * 7 + j) % 40 + 1 for j in range(4)], 6) for r in range(5)]
    _, _, peng, out, events = _twin(setup, monkeypatch, reqs, **kw)
    res = peng.results()
    kinds = {rid: rr.kind for rid, rr in res.items()}
    want = {"clean": {}, "nan_logits": {1: "quarantined"}, "page_corrupt": {0: "quarantined"},
            "request_stall": {1: "stalled"},
            "slot_drop": {0: "dropped", 1: "dropped", 2: "dropped"}}[drill]
    bad = {r: k for r, k in kinds.items() if k != "ok"}
    if drill == "page_corrupt":
        # the quarantined slot's retries wrote non-finite K/V at its decode
        # position; a later owner of that freed page reads the stale V at a
        # masked position (0 x NaN) and is quarantined too, in both packages
        assert bad[0] == "quarantined" and set(bad.values()) == {"quarantined"}
    else:
        assert bad == want
    if drill == "nan_logits":
        assert len(res[1].tokens) == 3 and peng.sched.stats["guard_retries"] == 2
        assert ("evict:quarantined", 1, 1, 2) in events
    # healthy requests: the tokens of the fault-free guarded run
    clean = ServeEngine(peng.cfg, peng.model, **{**BASE, "max_len": 16}, guard=True,
                        cache_noise=peng.cache_noise).run(
        [Request(r, p, m) for r, p, m in reqs])
    for rid, toks in out.items():
        assert toks == clean[rid]


@pytest.mark.parametrize("faults", ["", "nan_logits@2:slot=1;page_corrupt@3:slot=0;"
                                        "slot_drop@4:slot=2"], ids=["clean", "drill"])
def test_logit_exchange_at_one_worker_matches_reference(setup, monkeypatch, faults):
    orig = jax_engine.KVC.corrupt_page

    def corrupt_on_host(cache, pc, page, lead=False, device=None):
        sharding = {k: v.sharding for k, v in cache.items()}
        out = orig({k: jnp.asarray(jax.device_get(v)) for k, v in cache.items()}, pc, page,
                   lead=lead, device=device)
        return {k: jax.device_put(v, sharding[k]) for k, v in out.items()}

    monkeypatch.setattr(jax_engine.KVC, "corrupt_page", corrupt_on_host)
    kw = dict(fault_spec=faults) if faults else {}
    jeng, _, peng, _, _ = _twin(setup, monkeypatch, _spec(), exchange=True, policy="int8",
                                num_pages=9, guard=True, **kw)
    kinds = sorted(rr.kind for rr in peng.results().values())
    assert peng.wire_per_step == jeng.wire_per_step > 0
    if faults:
        assert kinds.count("quarantined") == 2 and "dropped" in kinds
        assert np.isnan(peng.coded_bits) and np.isnan(jeng.coded_bits)
    else:
        assert kinds == ["ok"] * 7
        np.testing.assert_allclose(peng.coded_bits, jeng.coded_bits, rtol=1e-5)


def test_guard_is_bit_equal_without_faults_and_recovers_a_transient(setup):
    _, _, model = setup
    reqs = [(r, [(r * 7 + j) % 40 + 1 for j in range(4)], 6) for r in range(5)]
    kw = {**BASE, "max_len": 16}
    base = ServeEngine(model.cfg, model, **kw).run([Request(*r) for r in reqs])
    eng = ServeEngine(model.cfg, model, guard=True, **kw)
    assert eng.run([Request(*r) for r in reqs]) == base
    assert eng.sched.stats.get("guard_retries", 0) == 0
    eng = ServeEngine(model.cfg, model, guard=True, **kw)
    orig, fired = eng._invoke_decode, []

    def flaky(token, pos, pt, rows, attempt=0):
        nxt, ok = orig(token, pos, pt, rows, attempt)
        if eng.sched.decode_steps == 2 and attempt == 0 and not fired:
            fired.append(1)
            ok = np.array(ok)
            ok[1] = False  # one transient rejection for slot 1
        return nxt, ok

    eng._invoke_decode = flaky
    out = eng.run([Request(*r) for r in reqs[:3]])
    assert fired and eng.sched.stats["guard_retries"] == 1
    assert all(rr.ok for rr in eng.results().values()) and all(len(t) == 6 for t in out.values())


def _written(eng, rid):
    """The stored K/V of request ``rid`` (every layer, every position it
    wrote), from the pages it held in its table's order."""
    slot = next(s for s in eng.sched.finished if s.req.rid == rid)
    n = len(slot.req.prompt) + slot.req.max_new - 1
    return {name: t[:, slot.pages].flatten(1, 2)[:, :n] for name, t in eng.cache.items()}


def test_native_draw_gives_the_same_tokens_alone_and_packed(setup):
    _, _, model = setup
    reqs = _spec()

    def run(requests, n_slots, num_pages=0, seed=0):
        eng = ServeEngine(model.cfg, model, policy="int8", page_size=4, n_slots=n_slots,
                          max_len=32, num_pages=num_pages, seed=seed)
        events = []
        return eng.run([Request(*r) for r in requests], events=events), eng, events

    packed, eng, events = run(reqs, 3, 9)
    assert eng.sched.stats["mid_decode_admits"] > 0
    reordered, _, _ = run(list(reversed(reqs)), 2, 6)
    assert all(reordered[r] == packed[r] for r, _, _ in reqs)
    # a request none of whose pages a later admission took, packed in
    # another slot than the 0 it takes alone: its stored payloads and norms
    # are bit-equal in the two runs
    held = {s.req.rid: set(s.pages) for s in eng.sched.finished}
    slot_of = {rid: s for kind, rid, s, _ in events if kind == "admit"}

    def kept(rid):
        done = next(i for i, e in enumerate(events) if e[:2] == ("retire", rid))
        return not any(held[e[1]] & held[rid] for e in events[done:] if e[0] == "admit")

    last = next(rid for rid in sorted(held) if slot_of[rid] != 0 and kept(rid))
    alone, eng_a, _ = run([reqs[last]], 3)
    assert alone[last] == packed[last]
    want = _written(eng, last)
    assert all(torch.equal(_written(eng_a, last)[k], want[k]) for k in want)
    # another seed draws otherwise: the stored payloads differ
    _, eng_s, _ = run([reqs[last]], 3, seed=1)
    assert not torch.equal(_written(eng_s, last)["seg0_k_payload"], want["seg0_k_payload"])


def _mk(model, **kw):
    return ServeEngine(model.cfg, model, **{**BASE, "max_len": 16, "policy": "int8", **kw})


def _reqs(n=5):
    return [Request(r, [(r * 7 + j) % 40 + 1 for j in range(4)], 6) for r in range(n)]


def test_snapshot_restore_resumes_from_committed(setup, tmp_path):
    jcfg, params, model = setup
    d = str(tmp_path / "snap")
    full = _mk(model, guard=True).run(_reqs())
    _mk(model, guard=True, snapshot_dir=d, snapshot_every=2).run(_reqs(), _stop_after=4)
    assert checkpointing.available_steps(d) == [2, 4]
    meta = checkpointing.read_meta(d, 4)
    committed = {s["rid"]: list(s["out"]) for s in meta["extra"]["slots"] if s is not None}
    assert committed and all(len(c) == 5 for c in committed.values())
    eng = _mk(model, guard=True)
    info = eng.restore_serve(d)
    assert info["step"] == 4 and info["in_flight"] == len(committed)
    out = eng.run([])
    assert set(out) == set(range(5)) and all(len(t) == 6 for t in out.values())
    for rid, toks in out.items():
        assert toks[:len(committed.get(rid, []))] == committed.get(rid, [])
    assert out == full  # the draws are keyed by request and position
    assert eng.allocator.n_free == eng.pc.num_pages
    # the reference engine reads the port's snapshot the same way
    jeng = jax_engine.ServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                                  policy="int8", page_size=4, n_slots=3, max_len=16, seed=0)
    assert jeng.restore_serve(d) == info


def test_snapshot_walks_back_and_refuses_a_fingerprint(setup, tmp_path):
    _, _, model = setup
    d = str(tmp_path / "snap")
    _mk(model, guard=True, snapshot_dir=d, snapshot_every=2,
        fault_spec=FaultSpec.parse("ckpt_truncate@4")).run(_reqs(), _stop_after=4)
    eng = _mk(model)
    assert eng.restore_serve(d)["step"] == 2  # torn step-4 npz: back to step 2
    out = eng.run([])
    assert set(out) == set(range(5)) and all(len(t) == 6 for t in out.values())
    with pytest.raises(checkpointing.CheckpointStructureError, match="fingerprint"):
        _mk(model, seed=7).restore_serve(d)
    d2 = str(tmp_path / "train_ckpt")
    checkpointing.save(d2, 0, {"params": {"w": np.zeros((2,), np.float32)}})
    with pytest.raises(checkpointing.CheckpointError):
        _mk(model).restore_serve(d2)


def test_workload_file_parser_matches_reference(tmp_path, capsys):
    from repro.launch.serve import _parse_workload_file as jax_parse

    cfg = types.SimpleNamespace(vocab_size=100)
    path = tmp_path / "wl.txt"
    path.write_text("# comment\n1,2,3|4\n\n5 6|2|30\n")
    got = serve_cli._parse_workload_file(str(path), cfg)
    want = jax_parse(str(path), cfg)
    assert [(r.rid, r.prompt, r.max_new, r.deadline) for r in got] == \
        [(r.rid, r.prompt, r.max_new, r.deadline) for r in want] == \
        [(0, [1, 2, 3], 4, None), (1, [5, 6], 2, 30.0)]
    for bad in ("no pipes here", "1,foo|3", "|3", "999|3", "1,2|zero", "1,2|0", "1|2|soon",
                ""):
        path.write_text(bad + "\n")
        errs = []
        for parse in (serve_cli._parse_workload_file, jax_parse):
            with pytest.raises(SystemExit) as e:
                parse(str(path), cfg)
            assert e.value.code == 2
            errs.append(capsys.readouterr().err)
        assert errs[0] == errs[1], bad


def _shape(lines):
    """Lines with every number masked (the two packages' weights and
    prompts differ; the schedule and the line formats do not)."""
    return [re.sub(r"-?\d+(\.\d+)?", "N", ln) for ln in lines if ln.startswith("[serve]")]


@pytest.mark.parametrize("kv_bits", ["8", "4", "32"])
def test_cli_prints_the_reference_lines(kv_bits, capsys):
    from repro.launch import serve as jax_serve_cli

    argv = ["--reduced", "--kv-bits", kv_bits, "--batch", "2", "--requests", "5",
            "--prompt-len", "6", "--gen", "5"]
    out = serve_cli.main(argv + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    jax_serve_cli.main(argv + ["--arch", "tinyllama-1.1b"])
    ref_lines = capsys.readouterr().out.splitlines()
    assert _shape(port_lines) == _shape(ref_lines)
    assert set(out) == set(range(5)) and all(0 <= t < 512 for v in out.values() for t in v)


def test_cli_serves_a_checkpoint_of_the_train_cli(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    train.main(["--reduced", "--steps", "1", "--batch", "2", "--seq", "8", "--device", "cpu",
                "--checkpoint-dir", ckpt, "--checkpoint-every", "1", "--compression", "none"])
    capsys.readouterr()
    out = serve_cli.main(["--reduced", "--device", "cpu", "--restore", ckpt, "--batch", "2",
                          "--requests", "2", "--prompt-len", "8", "--gen", "4", "--seed", "3"])
    assert "[serve] restored params from" in capsys.readouterr().out
    assert set(out) == {0, 1} and all(0 <= t < 512 for v in out.values() for t in v)
    bad = str(tmp_path / "bad")
    checkpointing.save(bad, 1, {"params": {"embed": np.zeros((3, 3), np.float32)}})
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--reduced", "--device", "cpu", "--restore", bad, "--batch", "1",
                        "--requests", "1", "--prompt-len", "4", "--gen", "2"])
    assert e.value.code == 2
    assert "do not match" in capsys.readouterr().err
