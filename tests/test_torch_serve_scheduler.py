"""The port's continuous-batching scheduler and page allocator
(``repro_torch.serve.scheduler`` / ``kv_cache.PageAllocator``) against the
reference's (``repro.serve.scheduler`` / ``repro.serve.kv_cache``, host
logic with no jax in it).

Each scenario is one function of the two modules it drives; it runs once
over the reference's and once over the port's, asserts the reference
tests' expectations on both, and returns a trace (the admitted
``(slot, rid)`` pairs, the queues, the terminal results, the stats and
the free-page count after every operation) that must be equal.  The
liveness property of ``tests/test_serve_robustness.py`` (random arrival,
progress and failure schedules) runs the same way under hypothesis: the
two traces equal, every request terminal, the arena refilled, FIFO order
among never-shed requests.
"""

import numpy as np
import pytest

import repro.core.retry as jax_retry
import repro.serve.kv_cache as jax_kvc
import repro.serve.scheduler as jax_sched
import repro_torch.core.retry as port_retry
import repro_torch.serve.kv_cache as port_kvc
import repro_torch.serve.scheduler as port_sched
from _hypothesis_compat import given, settings, st
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODULES = {"reference": (jax_sched, jax_kvc, jax_retry),
           "port": (port_sched, port_kvc, port_retry)}


def _state(sched, al) -> tuple:
    return (
        tuple(None if s is None else (s.req.rid, tuple(s.pages), s.pos, tuple(s.out))
              for s in sched.slots),
        tuple(q.req.rid for q in sched.waiting),
        tuple(sorted((q.req.rid, q.attempt) for q in sched.backoff)),
        tuple(sorted((rid, rr.kind, rr.tokens) for rid, rr in sched.results.items())),
        tuple(sorted(sched.stats.items())),
        al.n_free,
    )


def _twin(scenario, *args):
    traces = {name: scenario(*mods, *args) for name, mods in MODULES.items()}
    assert traces["port"] == traces["reference"]
    return traces["port"]


def _allocator(S, K, R):
    al = K.PageAllocator(8)
    a, b = al.alloc(3), al.alloc(5)
    assert len(a) == 3 and len(b) == 5 and al.n_free == 0 and set(a).isdisjoint(b)
    assert al.alloc(1) is None  # all-or-nothing
    al.free(a)
    with pytest.raises(ValueError):
        al.free(a)  # double free
    with pytest.raises(ValueError):
        al.free([b[0], b[0]])  # duplicate within one call
    al.free(b[1:])
    c = al.alloc(7)
    with pytest.raises(ValueError):
        al.alloc(0)
    return [a, b, c, al.n_free]


def _admit_retire(S, K, R):
    al = K.PageAllocator(6)
    sched = S.Scheduler(n_slots=2, page_size=4, blocks_per_seq=3, allocator=al)
    with pytest.raises(ValueError):  # needs 4 pages > table width 3
        sched.submit(S.Request(9, prompt=[1] * 10, max_new=6))
    with pytest.raises(ValueError):
        sched.submit(S.Request(9, prompt=[], max_new=1))
    for r in range(4):
        sched.submit(S.Request(r, prompt=[1, 2, 3], max_new=5))
    trace = [[(i, s.req.rid) for i, s in sched.admit()], _state(sched, al)]
    assert sched.admit() == []
    sched.decode_steps = 3
    sched.slots[0].out = [7] * 5
    trace.append([s.req.rid for s in sched.retire_finished()])
    trace.append([(i, s.req.rid) for i, s in sched.admit()])
    assert sched.stats["mid_decode_admits"] == 1 and sched.stats["max_concurrent"] == 2
    sched.slots[1].out = [7] * 5
    sched.retire_finished()
    sched.admit()
    assert {s.req.rid for _, s in sched.active()} == {2, 3}
    return trace + [_state(sched, al)]


def _mk(S, K, num_pages=12, n_slots=2, **kw):
    al = K.PageAllocator(num_pages)
    return S.Scheduler(n_slots, page_size=4, blocks_per_seq=3, allocator=al, **kw), al


def _deadlines(S, K, R):
    clock = {"t": 0.0}
    sched, al = _mk(S, K, num_pages=3, clock=lambda: clock["t"])
    sched.submit(S.Request(0, prompt=[1] * 4, max_new=8, deadline=100.0))
    sched.submit(S.Request(1, prompt=[1] * 4, max_new=8, deadline=5.0))
    trace = [[s.req.rid for _, s in sched.admit()]]
    clock["t"] = 6.0
    sched.admit()
    assert sched.results[1].kind == "queue_timeout"
    trace.append(_state(sched, al))
    clock["t"] = 101.0
    trace.append([(i, k) for i, _, k in sched.expire_active()])
    assert sched.results[0].kind == "deadline" and al.n_free == 3 and not sched.has_work()
    return trace + [_state(sched, al)]


def _stall(S, K, R):
    sched, al = _mk(S, K)
    sched.submit(S.Request(0, prompt=[1] * 4, max_new=4))
    sched.admit()
    sched.slots[0].last_progress = 0
    sched.decode_steps = 3
    assert sched.expire_active(stall_patience=4) == []
    sched.decode_steps = 5
    ev = [k for _, _, k in sched.expire_active(stall_patience=4)]
    assert ev == ["stalled"] and al.n_free == 12
    return [ev, _state(sched, al)]


def _shed(S, K, R):
    clock = {"t": 0.0}
    policy = R.BackoffPolicy(base=4.0, factor=2.0, cap=32.0, max_attempts=2, jitter=0.0)
    sched, al = _mk(S, K, num_pages=3, n_slots=1, clock=lambda: clock["t"], max_queue=1,
                    backoff=policy)
    for r in range(4):
        sched.submit(S.Request(r, prompt=[1] * 4, max_new=8))
    trace = []
    for t in (0.0, 0.0, 5.0, 40.0):
        clock["t"] = t
        sched.admit()
        trace.append(_state(sched, al))
    assert {rr.rid for rr in sched.results.values() if rr.kind == "shed"} == {2, 3}
    assert sched.stats["shed_transient"] == 4 and sched.stats["readmitted"] >= 2
    return trace


def _watermark(S, K, R):
    clock = {"t": 0.0}
    sched, al = _mk(S, K, num_pages=4, n_slots=2, clock=lambda: clock["t"],
                    low_watermark=0.5)
    sched.max_queue = 1
    for r in range(3):
        sched.submit(S.Request(r, prompt=[1] * 4, max_new=8))
    sched.admit()
    trace = [_state(sched, al)]
    clock["t"] = 100.0
    sched.admit()
    assert [q.req.rid for q in sched.backoff] == [2] and sched.page_pressure == 0.75
    sched.evict(0, "dropped")
    sched.admit()
    assert not sched.backoff and not sched.force_readmit()
    return trace + [_state(sched, al)]


@pytest.mark.parametrize("scenario", [_allocator, _admit_retire, _deadlines, _stall, _shed,
                                      _watermark],
                         ids=["allocator", "admit_retire", "deadlines", "stall_patience",
                              "shed_backoff_readmit", "watermark"])
def test_scheduler_trace_matches_reference(scenario):
    _twin(scenario)


def _liveness(S, K, R, seed, n_slots, num_pages, nreq, max_queue):
    rng = np.random.RandomState(seed)
    al = K.PageAllocator(num_pages)
    clock = {"t": 0.0}
    sched = S.Scheduler(n_slots, page_size=4, blocks_per_seq=3, allocator=al,
                        clock=lambda: clock["t"], max_queue=max_queue,
                        backoff=R.BackoffPolicy(base=2.0, factor=2.0, cap=8.0,
                                                max_attempts=2, jitter=0.5))
    pending = []
    for r in range(nreq):
        plen = int(rng.randint(1, 7))
        gen = int(rng.randint(1, 13 - plen))
        dl = float(rng.randint(8, 40)) if rng.rand() < 0.3 else None
        pending.append(S.Request(rid=r, prompt=[1] * plen, max_new=gen, deadline=dl))
    admit_order, shed_rids, trace = [], set(), []
    steps = 0
    while pending or sched.has_work():
        while pending and rng.rand() < 0.7:
            sched.submit(pending.pop(0))
        for _i, s in sched.admit():
            admit_order.append(s.req.rid)
        shed_rids |= {q.req.rid for q in sched.backoff}
        sched.expire_active(stall_patience=6)
        for i, slot in sched.active():
            if rng.rand() < 0.08:
                sched.evict(i, "quarantined")
            elif rng.rand() < 0.8:
                slot.out.append(0)
                slot.last_progress = sched.decode_steps + 1
        sched.decode_steps += 1
        clock["t"] = float(sched.decode_steps)
        sched.retire_finished()
        if not sched.active() and not sched.waiting and sched.backoff:
            sched.force_readmit()
        trace.append(_state(sched, al))
        steps += 1
        assert steps < 200 + 60 * nreq, "liveness violated"
    assert set(sched.results) == set(range(nreq))
    assert al.n_free == num_pages
    fifo = [r for r in admit_order if r not in shed_rids]
    assert fifo == sorted(fifo)
    return trace


@settings(deadline=None, max_examples=12)
@given(seed=st.integers(0, 9999), n_slots=st.integers(1, 3),
       num_pages=st.integers(4, 12), nreq=st.integers(1, 10),
       max_queue=st.integers(0, 3))
def test_scheduler_liveness_property_matches_reference(seed, n_slots, num_pages, nreq,
                                                       max_queue):
    _twin(_liveness, seed, n_slots, num_pages, nreq, max_queue)
