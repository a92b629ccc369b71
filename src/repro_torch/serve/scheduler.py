"""Continuous-batching request scheduler (host-side state machine; the
port's copy of ``repro/serve/scheduler.py``, stdlib only).

Slots are positions in the packed decode batch; pages come from the
shared :class:`repro_torch.serve.kv_cache.PageAllocator` arena.  Request
lifecycle::

                        ┌──────── backoff pool ◀──shed (tail,──┐
                        ▼          (jittered exp.   overload)  │
    submitted ──▶ waiting ──admit──▶ active(slot) ──retire──▶ finished
                     │ ▲                  │                    (ok)
       deadline ─────┘ └── (stays queued  │ deadline/stall/quarantine/
       expired:            while pages    ▼ slot_drop: evict — pages
       queue_timeout       are scarce)   typed result, pages freed

Admission is all-or-nothing per request (every page a request will ever
touch — prompt AND generation — is reserved at admit time, so an active
request can never stall mid-decode on arena exhaustion) and greedy in
FIFO order: a request admits the moment a slot AND its pages are both
available, including between decode steps of other requests — that is
the continuous-batching property the tests pin down.  The engine calls
``admit`` after every ``retire_finished``.

Robustness layer (every terminal outcome is a typed
:class:`RequestResult`, never a silent drop):

* **Deadlines.**  ``Request.deadline`` is a TTL in clock units from
  submission (the clock is injectable: decode-wave index by default,
  wall-clock ms from the CLI's ``--deadline-ms``).  A request that
  expires while queued is rejected ``queue_timeout``; while active, it
  is evicted ``deadline`` and its pages return to the arena.
* **Load shedding.**  With ``max_queue`` set, overflow is shed from the
  TAIL of the queue (the head — the oldest request — is never shed, so
  FIFO order among survivors is preserved) into a backoff pool.  Shed
  requests re-admit after a jittered exponential delay
  (:class:`repro_torch.core.retry.BackoffPolicy`, deterministic per-rid
  jitter), gated on the arena's free-page watermark so re-admission
  cannot pile onto an already-starved arena; after ``max_attempts``
  sheds the rejection becomes permanent (``shed``).
* **Liveness.**  Admission never deadlocks: the queue head blocks only
  on pages held by ACTIVE slots, every active slot either progresses,
  retires, or is evicted by deadline/stall/quarantine (freeing its
  pages), and an idle engine force-readmits the backoff pool rather
  than waiting out a delay nobody is contending for.  The property
  tests in ``tests/test_torch_serve_scheduler.py`` drive random
  arrival/completion/failure schedules against exactly this invariant.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

from repro_torch.core.retry import BackoffPolicy

#: terminal outcomes a request can reach (RequestResult.kind)
RESULT_KINDS = (
    "ok",             # budget spent, tokens complete
    "quarantined",    # decode guard: K re-keyed retries all non-finite
    "dropped",        # slot_drop fault / forced eviction
    "stalled",        # no decode progress for stall_patience waves
    "deadline",       # TTL expired while active
    "queue_timeout",  # TTL expired while queued
    "shed",           # overload: max_queue + backoff attempts exhausted
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list  # token ids
    max_new: int  # generation budget (greedy decode stops here)
    deadline: Optional[float] = None  # TTL in clock units from submit


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Terminal outcome of one request: ``kind`` from RESULT_KINDS plus
    whatever tokens were committed before the outcome (empty for
    requests that never reached a slot)."""

    rid: int
    kind: str
    tokens: tuple = ()

    @property
    def ok(self) -> bool:
        return self.kind == "ok"


@dataclasses.dataclass
class Slot:
    req: Request
    pages: list  # arena pages backing positions [0, len(prompt)+max_new)
    pos: int  # next decode position (== tokens already in the cache)
    last_token: int  # token the next decode step consumes
    out: list  # generated token ids
    submit_at: float = 0.0  # clock reading when the request was submitted
    last_progress: int = 0  # decode_steps at the last committed token


@dataclasses.dataclass
class _Queued:
    req: Request
    submit_at: float
    attempt: int = 0  # times shed so far
    seq: int = 0  # submission order (FIFO tiebreak in the backoff pool)


class Scheduler:
    """FIFO admission over ``n_slots`` packed-batch slots."""

    def __init__(self, n_slots: int, page_size: int, blocks_per_seq: int,
                 allocator, *, clock: Optional[Callable[[], float]] = None,
                 max_queue: int = 0, low_watermark: float = 0.0,
                 backoff: Optional[BackoffPolicy] = None,
                 deadline_default: Optional[float] = None):
        self.n_slots = n_slots
        self.page_size = page_size
        self.blocks_per_seq = blocks_per_seq
        self.allocator = allocator
        self.clock = clock if clock is not None else (
            lambda: float(self.decode_steps)
        )
        self.max_queue = max_queue  # 0 = unbounded (no shedding)
        self.low_watermark = low_watermark
        self.backoff_policy = backoff if backoff is not None else BackoffPolicy(
            base=2.0, factor=2.0, cap=32.0, max_attempts=3, jitter=0.5
        )
        self.deadline_default = deadline_default
        self.waiting: deque = deque()  # of _Queued
        self.backoff: list[_Queued] = []  # shed requests, with eligible_at
        self._eligible_at: dict[int, float] = {}  # rid -> earliest re-admit
        self._seq = 0
        self.slots: list[Optional[Slot]] = [None] * n_slots
        self.finished: list[Slot] = []
        self.results: dict[int, RequestResult] = {}
        self.decode_steps = 0  # bumped by the engine; >0 marks mid-decode
        self.stats = {
            "admitted": 0,
            "retired": 0,
            "mid_decode_admits": 0,
            "max_concurrent": 0,
            "evicted": 0,
            "shed_transient": 0,
            "readmitted": 0,
        }

    def _blocks_for(self, req: Request) -> int:
        total = len(req.prompt) + req.max_new
        return -(-total // self.page_size)

    # -- metrics ---------------------------------------------------------

    @property
    def page_pressure(self) -> float:
        """Fraction of the arena in use (1.0 = exhausted) — the overload
        signal the shedding watermark reads."""
        return 1.0 - self.allocator.n_free / self.allocator.num_pages

    def _readmission_open(self) -> bool:
        free_frac = self.allocator.n_free / self.allocator.num_pages
        return free_frac >= self.low_watermark

    # -- request intake --------------------------------------------------

    def submit(self, req: Request) -> None:
        if not req.prompt or req.max_new < 1:
            raise ValueError(f"request {req.rid}: empty prompt or max_new < 1")
        if self._blocks_for(req) > self.blocks_per_seq:
            raise ValueError(
                f"request {req.rid}: {len(req.prompt)}+{req.max_new} tokens "
                f"needs {self._blocks_for(req)} pages > page-table width "
                f"{self.blocks_per_seq}"
            )
        if req.deadline is None and self.deadline_default is not None:
            req.deadline = self.deadline_default
        q = _Queued(req=req, submit_at=self.clock(), seq=self._seq)
        self._seq += 1
        self.waiting.append(q)

    def _finish(self, req: Request, kind: str, tokens=()) -> RequestResult:
        rr = RequestResult(rid=req.rid, kind=kind, tokens=tuple(tokens))
        self.results[req.rid] = rr
        if kind != "ok":
            self.stats["evicted"] += 1
        self.stats[kind] = self.stats.get(kind, 0) + 1
        return rr

    # -- queue maintenance ----------------------------------------------

    def _expired(self, q: _Queued, now: float) -> bool:
        d = q.req.deadline
        return d is not None and now - q.submit_at > d

    def _expire_queued(self, now: float) -> list:
        timed_out = []
        for pool in (self.waiting, self.backoff):
            for q in [q for q in pool if self._expired(q, now)]:
                pool.remove(q)
                timed_out.append(self._finish(q.req, "queue_timeout"))
        return timed_out

    def _readmit_backoff(self, now: float) -> None:
        if not self.backoff or not self._readmission_open():
            return
        ready = [q for q in self.backoff
                 if self._eligible_at.get(q.req.rid, 0.0) <= now]
        for q in sorted(ready, key=lambda q: q.seq):
            self.backoff.remove(q)
            self._eligible_at.pop(q.req.rid, None)
            self.waiting.append(q)
            self.stats["readmitted"] += 1

    def _shed_overflow(self, now: float) -> list:
        """Shed queue overflow from the TAIL into the backoff pool;
        permanently reject once the backoff budget is spent."""
        rejected = []
        if not self.max_queue:
            return rejected
        while len(self.waiting) > self.max_queue:
            q = self.waiting.pop()  # tail: the head is never shed
            if self.backoff_policy.exhausted(q.attempt):
                rejected.append(self._finish(q.req, "shed"))
                continue
            delay = self.backoff_policy.delay(q.attempt, token=q.req.rid)
            q.attempt += 1
            self._eligible_at[q.req.rid] = now + delay
            self.backoff.append(q)
            self.stats["shed_transient"] += 1
        return rejected

    def force_readmit(self) -> bool:
        """Idle override: the engine has nothing active and nothing
        admissible — pull the earliest shed request back in regardless of
        its backoff delay (waiting out a delay nobody contends with would
        stall the whole engine).  True if anything moved."""
        if not self.backoff:
            return False
        q = min(self.backoff, key=lambda q: q.seq)
        self.backoff.remove(q)
        self._eligible_at.pop(q.req.rid, None)
        self.waiting.append(q)
        self.stats["readmitted"] += 1
        return True

    # -- admission -------------------------------------------------------

    def admit(self) -> list:
        """Queue maintenance (expiry, re-admission, shedding) then fill
        free slots FIFO; returns the newly admitted [(slot_index, Slot)]
        for the engine to prefill."""
        now = self.clock()
        self._expire_queued(now)
        self._readmit_backoff(now)
        new = []
        for i in range(self.n_slots):
            if self.slots[i] is not None or not self.waiting:
                continue
            q = self.waiting[0]
            pages = self.allocator.alloc(self._blocks_for(q.req))
            if pages is None:
                break  # FIFO: don't let a small request starve the head
            self.waiting.popleft()
            slot = Slot(req=q.req, pages=pages, pos=0, last_token=0, out=[],
                        submit_at=q.submit_at,
                        last_progress=self.decode_steps)
            self.slots[i] = slot
            new.append((i, slot))
            self.stats["admitted"] += 1
            if self.decode_steps > 0:
                self.stats["mid_decode_admits"] += 1
        # shed AFTER slot fill so a request admitted this round does not
        # count against the queue bound it is already vacating
        self._shed_overflow(now)
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"],
            sum(s is not None for s in self.slots),
        )
        return new

    # -- retirement / eviction -------------------------------------------

    def retire_finished(self) -> list:
        """Free every slot whose generation budget is spent."""
        done = []
        for i, slot in enumerate(self.slots):
            if slot is not None and len(slot.out) >= slot.req.max_new:
                self.allocator.free(slot.pages)
                self.slots[i] = None
                self.finished.append(slot)
                self._finish(slot.req, "ok", slot.out)
                done.append(slot)
                self.stats["retired"] += 1
        return done

    def evict(self, i: int, kind: str) -> Slot:
        """Forcibly terminate the request in slot ``i`` with a typed
        result; its pages return to the arena (quarantine must not leak —
        the property tests assert the arena refills completely)."""
        slot = self.slots[i]
        assert slot is not None, f"evict on empty slot {i}"
        if kind not in RESULT_KINDS or kind == "ok":
            raise ValueError(f"bad eviction kind {kind!r}")
        self.allocator.free(slot.pages)
        self.slots[i] = None
        self._finish(slot.req, kind, slot.out)
        return slot

    def expire_active(self, stall_patience: int = 0) -> list:
        """Evict active slots past their deadline (kind ``deadline``) or
        without progress for ``stall_patience`` decode waves (kind
        ``stalled``); returns [(slot_index, Slot, kind)]."""
        now = self.clock()
        evicted = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            d = slot.req.deadline
            if d is not None and now - slot.submit_at > d:
                evicted.append((i, self.evict(i, "deadline"), "deadline"))
            elif (stall_patience
                  and self.decode_steps - slot.last_progress > stall_patience):
                evicted.append((i, self.evict(i, "stalled"), "stalled"))
        return evicted

    # -- views ------------------------------------------------------------

    def active(self) -> list:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def has_work(self) -> bool:
        return (bool(self.waiting) or bool(self.backoff)
                or any(s is not None for s in self.slots))
