"""Serving engine: continuous batching over a paged quantized KV-cache
(port of ``repro/serve/engine.py``).

One :class:`ServeEngine` owns the arena, the scheduler and the model:

* **prefill** — per request, one full-sequence forward of the prompt
  padded to whole pages (:func:`repro_torch.models.transformer.prefill_paged`):
  the whole prompt's K/V lands in the arena (kernel 1 per layer for K and
  for V), and the last position's logits give the first token.
* **decode** — one step over the packed slot batch
  (:func:`~repro_torch.models.transformer.decode_step_paged`): per-slot
  positions and page tables, greedy argmax; every layer reads its
  history through kernel 3 and writes the new token through kernel 1.
  Empty slots are inert (page-table rows of -1: writes drop, outputs
  ignored).  PyTorch runs eagerly: there is no per-length compile cache.

Quantizer noise: each write's rounding draw is keyed by the request, the
position, the layer and K/V (:class:`repro_torch.serve.kv_cache.KeyedCacheNoise`),
never by the slot, so a request's greedy tokens are bit-identical alone
or packed.  ``cache_noise=`` replaces that source (tests replay the
reference's ``jax.random`` draws through it); it is asked
``prefill(rid, length)`` per prefill and ``decode(rows)`` per decode
invocation, ``rows[i]`` = ``(rid, attempt, pos)`` of slot i or None.

Logit exchange (``exchange=``: an :class:`~repro_torch.core.exchange.Exchange`
or an ``ExchangeConfig``, built over the default process group when it
has more than one rank): each rank keeps its own arena, its writes keyed
with its rank, so K ranks hold K independently quantized caches of the
same sequences, and each decode wave averages the logits through
``Exchange.pmean_tree`` (``wire_bytes`` adds the analytic
``wire_per_step``; ``coded_bits_tree`` under qgenx).  At world size 1 the
exchange still quantizes (kernels 1-3 run on the ``[slots, vocab]``
logits).  Its noise comes from ``exchange_noise(step, attempt)``
(default: a generator seeded from (seed, rank, step, attempt)).

Hardened runtime (``guard=True``):

* **Decode guard.**  Each wave takes a per-slot finiteness flag over the
  logits the argmax consumes; with an exchange the flag is all-reduced,
  so one rank's non-finite row vetoes the slot on every rank.  A
  rejected slot keeps its token and position; the retry overwrites the
  one cache position the wave wrote.  Healthy slots commit from attempt
  0, the clean run's invocation.
* **Bounded re-keyed retry.**  A rejected slot retries up to
  ``guard_retries`` times with a re-salted request key (a fresh rounding
  draw), healthy slots riding along inert; the exchange state advances
  only on attempt 0.  After the budget: ``quarantined`` (typed
  eviction, pages freed).
* **Fault injection** through :class:`repro_torch.core.faults.FaultSpec`:
  ``nan_logits`` poisons rows of the logits at the guard's consumption
  point; ``slot_drop``, ``page_corrupt``, ``request_stall`` and
  ``crash`` are host events between waves; ``ckpt_*`` corrupt the
  engine's snapshots.  A fault's step is the decode-wave index.
* **Crash-safe snapshots** every ``snapshot_every`` waves (page tables,
  occupancy, the scheduler's queues, committed tokens) through
  :mod:`repro_torch.checkpoint.checkpointing` (tmp + fsync + rename);
  :meth:`restore_serve` walks back to the newest intact snapshot, refuses
  a fingerprint mismatch, and resubmits every in-flight request from its
  last committed token.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointing
from repro_torch.configs.base import ModelConfig
from repro_torch.core import faults as faults_mod
from repro_torch.core.exchange import (
    Exchange,
    ExchangeConfig,
    ProcessGroupComm,
    SingleWorker,
    make_exchange,
)
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.retry import BackoffPolicy
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as KVC
from repro_torch.serve.scheduler import Request, RequestResult, Scheduler

#: snapshot schema version (restore refuses versions it does not know)
SNAPSHOT_VERSION = 1


def _default_comm():
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return ProcessGroupComm()
    return SingleWorker()


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        model,
        *,
        policy: str = "int8",
        page_size: int = 8,
        n_slots: int = 4,
        max_len: int = 64,
        num_pages: int = 0,  # 0 = fully provision every slot
        seed: int = 0,
        exchange=None,  # ExchangeConfig | Exchange | None
        guard: bool = False,
        guard_retries: int = 2,
        fault_spec=None,  # faults.FaultSpec | None
        snapshot_dir: str = "",
        snapshot_every: int = 0,
        stall_patience: int = 8,
        max_queue: int = 0,
        low_watermark: float = 0.0,
        backoff: BackoffPolicy | None = None,
        deadline_default: float | None = None,
        clock=None,
        cache_noise=None,
        exchange_noise=None,
    ):
        if not T.paged_eligible(cfg):
            raise ValueError(
                f"arch {cfg.name!r} ({cfg.arch_type}) has no paged cache; "
                "the dense decode_step fallback is not ported")
        blocks_per_seq = -(-max_len // page_size)
        if not num_pages:
            num_pages = n_slots * blocks_per_seq
        self.cfg = cfg
        self.model = model
        self.device = model.embed.device
        self.seed = seed
        self.pc = KVC.make_paged_cache_config(cfg, policy, page_size, num_pages,
                                              blocks_per_seq)
        self.guard = guard
        if guard_retries < 0:
            raise ValueError(f"guard_retries must be >= 0, got {guard_retries}")
        self.guard_retries = guard_retries
        if fault_spec is not None and not fault_spec.events:
            fault_spec = None
        if fault_spec is not None:
            for e in fault_spec.events:
                if e.kind not in faults_mod.SERVE_SCOPE:
                    raise ValueError(
                        f"fault kind {e.kind!r} is not a serve fault; "
                        f"serve accepts: {faults_mod.SERVE_SCOPE}")
        self.fault_spec = fault_spec
        self._inject_logits = fault_spec is not None and fault_spec.has_serve_device_events
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.stall_patience = stall_patience
        self._sched_opts = dict(max_queue=max_queue, low_watermark=low_watermark,
                                backoff=backoff, deadline_default=deadline_default,
                                clock=clock)
        self.allocator = KVC.PageAllocator(num_pages)
        self.sched = Scheduler(n_slots, page_size, blocks_per_seq, self.allocator,
                               **self._sched_opts)
        self.n_slots = n_slots
        self.ex: Exchange | None = (make_exchange(exchange, _default_comm())
                                    if isinstance(exchange, ExchangeConfig) else exchange)
        self.K = 1 if self.ex is None else self.ex.comm.size
        self.rank = 0 if self.ex is None else self.ex.comm.rank
        self.cache_noise = cache_noise if cache_noise is not None else KVC.KeyedCacheNoise(
            seed, self.rank if self.ex is not None else 0, cfg.num_layers)
        self.exchange_noise = exchange_noise or self._step_noise
        self.wire_bytes = 0.0
        self.coded_bits = 0.0
        self._stalled_rids: set = set()
        self._committed: dict[int, list] = {}  # rid -> pre-restart tokens
        self.timing = {"prefill_s": [], "wave_s": []}
        self.cache = KVC.init_paged_cache(self.pc, self.device)
        if self.ex is not None:
            self.ex_state = self.ex.init_state(self.device)
            # analytic operand bytes of the per-wave logit exchange
            logits_like = {"logits": torch.zeros((n_slots, cfg.vocab_size))}
            self.wire_per_step = float(self.ex.wire_bytes_tree(logits_like, self.K))

    # -- the model calls ---------------------------------------------------

    def _step_noise(self, step: int, attempt: int) -> GeneratorNoise:
        s = np.random.SeedSequence([self.seed, self.rank, step, attempt])
        return GeneratorNoise.seeded(int(s.generate_state(1, np.uint64)[0]), self.device)

    def _decode(self, token, pos, pt, rows, attempt: int):
        """One decode invocation -> (next tokens [B], ok [B] or None) on the
        device; the exchange state advances only on attempt 0."""
        step = self.sched.decode_steps
        logits, _ = T.decode_step_paged(self.model, self.pc, self.cache, token, pos, pt,
                                        self.cache_noise.decode(rows))
        agg = logits
        if self.ex is not None:
            out, new_state = self.ex.pmean_tree({"logits": logits}, self.ex_state,
                                                self.exchange_noise(step, attempt))
            agg = out["logits"]
            if self.ex.cfg.compressor == "qgenx":
                self.coded_bits += float(self.ex.coded_bits_tree({"logits": logits},
                                                                 new_state))
            if attempt == 0:
                self.ex_state = new_state
            self.wire_bytes += self.wire_per_step
        if self._inject_logits:
            agg = self.fault_spec.poison_logits(agg, step)
        if not self.guard:
            return torch.argmax(agg, dim=-1), None
        ok = torch.isfinite(agg).all(dim=-1)
        if self.ex is not None:
            # one non-finite row on ONE rank vetoes the slot everywhere
            ok = ok & torch.isfinite(logits).all(dim=-1)
            ok = self.ex.comm.all_reduce_sum((~ok).float()) == 0
        return torch.where(ok, torch.argmax(agg, dim=-1), token.long()), ok

    @torch.no_grad()
    def _prefill_slot(self, slot) -> None:
        t0 = time.perf_counter()
        plen = len(slot.req.prompt)
        ps = self.pc.page_size
        nblk = -(-plen // ps)
        s_pad = nblk * ps
        tokens = np.zeros((1, s_pad), np.int64)
        tokens[0, :plen] = slot.req.prompt
        pages = np.asarray(slot.pages[:nblk], np.int64)[None]
        logits, _ = T.prefill_paged(
            self.model, self.pc, self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pages).to(self.device),
            self.cache_noise.prefill(slot.req.rid, s_pad))
        first = int(torch.argmax(logits[0, plen - 1]))
        slot.pos = plen
        slot.last_token = first
        slot.out.append(first)
        self.timing["prefill_s"].append(time.perf_counter() - t0)

    def _admit_and_prefill(self, events=None) -> None:
        # retire/admit until a fixed point: a prefilled request whose budget
        # is a single token retires at once, freeing pages mid-wave
        while True:
            for i, slot in self.sched.admit():
                self._prefill_slot(slot)
                if events is not None:
                    events.append(("admit", slot.req.rid, i, self.sched.decode_steps))
            done = self.sched.retire_finished()
            if events is not None:
                for slot in done:
                    events.append(("retire", slot.req.rid, -1, self.sched.decode_steps))
            if not done:
                return

    def _pack(self, active, attempt: int = 0):
        B = self.n_slots
        token = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        pt = np.full((B, self.pc.blocks_per_seq), -1, np.int64)
        rows = [None] * B
        for i, slot in active:
            token[i] = slot.last_token
            pos[i] = slot.pos
            pt[i, : len(slot.pages)] = slot.pages
            rows[i] = (slot.req.rid, attempt, slot.pos)
        dev = self.device
        return (torch.from_numpy(token).to(dev), torch.from_numpy(pos).to(dev),
                torch.from_numpy(pt).to(dev), rows)

    @torch.no_grad()
    def _invoke_decode(self, token, pos, pt, rows, attempt: int = 0):
        """One decode invocation; returns host (next_tokens, ok), ok None
        when the guard is off."""
        nxt, ok = self._decode(token, pos, pt, rows, attempt)
        nxt = nxt.cpu().numpy()
        return nxt, (None if ok is None else ok.cpu().numpy())

    def _decode_wave(self, packable, events=None) -> dict:
        """One decode wave with the guard's bounded re-keyed retry;
        returns {slot index: committed token}.  Slots still failing after
        ``guard_retries`` retries are quarantined."""
        t0 = time.perf_counter()
        committed: dict = {}
        pending = list(packable)
        attempt = 0
        while pending:
            token, pos, pt, rows = self._pack(pending, attempt=attempt)
            nxt, ok = self._invoke_decode(token, pos, pt, rows, attempt)
            if ok is None:  # guard off: every packed slot commits
                for i, _slot in pending:
                    committed[i] = int(nxt[i])
                break
            still = []
            for i, slot in pending:
                if ok[i]:
                    committed[i] = int(nxt[i])
                else:
                    still.append((i, slot))
            if not still:
                break
            if attempt >= self.guard_retries:
                for i, slot in still:
                    self.sched.evict(i, "quarantined")
                    self._stalled_rids.discard(slot.req.rid)
                    if events is not None:
                        events.append(("evict:quarantined", slot.req.rid, i,
                                       self.sched.decode_steps))
                break
            attempt += 1
            self.sched.stats["guard_retries"] = (
                self.sched.stats.get("guard_retries", 0) + len(still))
            pending = still
        self.timing["wave_s"].append(time.perf_counter() - t0)
        return committed

    # -- host fault application (between decode waves) ---------------------

    def _targets(self, hits) -> list:
        if None in hits:
            return sorted({i for i, _ in self.sched.active()})
        return sorted({i for i in hits if self.sched.slots[i] is not None})

    def _apply_host_faults(self, events=None) -> None:
        spec, step = self.fault_spec, self.sched.decode_steps
        if spec is None:
            return
        if spec.crash_at(step):
            # die the way a real kill does: no cleanup, no final snapshot
            print(f"[serve] fault: crash before decode wave {step}", flush=True)
            os._exit(faults_mod.CRASH_EXIT_CODE)
        hits = spec.slots_hit("slot_drop", step)
        if hits:
            for i in self._targets(hits):
                slot = self.sched.evict(i, "dropped")
                self._stalled_rids.discard(slot.req.rid)
                if events is not None:
                    events.append(("evict:dropped", slot.req.rid, i, step))
        hits = spec.slots_hit("page_corrupt", step)
        if hits:
            for i in self._targets(hits):
                slot = self.sched.slots[i]
                # ensemble mode: rank 0's arena only, the all-reduced flag
                # must veto the slot though the other ranks are clean
                if self.rank == 0:
                    KVC.corrupt_page(self.cache, self.pc, slot.pages[0])
                if events is not None:
                    events.append(("fault:page_corrupt", slot.req.rid, i, step))
        hits = spec.slots_hit("request_stall", step)
        if hits:
            for i in self._targets(hits):
                slot = self.sched.slots[i]
                if slot.req.rid not in self._stalled_rids:
                    self._stalled_rids.add(slot.req.rid)
                    if events is not None:
                        events.append(("fault:stall", slot.req.rid, i, step))

    # -- crash-safe snapshots ----------------------------------------------

    def _fingerprint(self) -> dict:
        return {
            "arch": self.cfg.name,
            "cache": self.pc.describe(),
            "page_size": self.pc.page_size,
            "num_pages": self.pc.num_pages,
            "blocks_per_seq": self.pc.blocks_per_seq,
            "n_slots": self.n_slots,
            "seed": self.seed,
            "devices": int(self.K) if self.ex is not None else 1,
        }

    def _snapshot_trees(self) -> dict:
        bps = self.pc.blocks_per_seq
        pt = np.full((self.n_slots, bps), -1, np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        occupancy = np.zeros((self.pc.num_pages,), np.int8)
        for i, slot in self.sched.active():
            pt[i, : len(slot.pages)] = slot.pages
            pos[i] = slot.pos
            occupancy[np.asarray(slot.pages, np.int64)] = 1
        return {"serve": {"page_table": pt, "pos": pos, "occupancy": occupancy}}

    def results(self) -> dict:
        """{rid: RequestResult} with pre-restart committed tokens merged in
        front (a resumed request's scheduler-side tokens start at its last
        committed token)."""
        out = {}
        for rid, rr in self.sched.results.items():
            pre = self._committed.get(rid)
            if pre:
                rr = dataclasses.replace(rr, tokens=tuple(pre) + tuple(rr.tokens))
            out[rid] = rr
        return out

    def snapshot(self, path: str) -> int:
        """Write one atomic engine snapshot (npz -> meta -> latest) with
        everything a restart needs: page tables and arena occupancy
        (diagnostics), both scheduler queues, terminal results and each
        request's committed tokens.  Rank 0 writes; returns the step."""
        sched = self.sched
        now = sched.clock()

        def _ttl_left(deadline, submit_at):
            return None if deadline is None else deadline - (now - submit_at)

        slots_state = []
        for slot in sched.slots:
            if slot is None:
                slots_state.append(None)
                continue
            slots_state.append({
                "rid": slot.req.rid,
                "prompt": [int(t) for t in slot.req.prompt],
                "max_new": int(slot.req.max_new),
                "ttl_left": _ttl_left(slot.req.deadline, slot.submit_at),
                "out": [int(t) for t in slot.out],
                "stalled": slot.req.rid in self._stalled_rids,
            })

        def q_state(q):
            return {
                "rid": q.req.rid,
                "prompt": [int(t) for t in q.req.prompt],
                "max_new": int(q.req.max_new),
                "ttl_left": _ttl_left(q.req.deadline, q.submit_at),
                "attempt": int(q.attempt),
            }

        extra = {
            "serve_snapshot": SNAPSHOT_VERSION,
            "fingerprint": self._fingerprint(),
            "decode_steps": int(sched.decode_steps),
            "slots": slots_state,
            "waiting": [q_state(q) for q in sched.waiting],
            "backoff": [q_state(q) for q in sched.backoff],
            "results": [
                {"rid": int(rr.rid), "kind": rr.kind, "tokens": [int(t) for t in rr.tokens]}
                for rr in self.results().values()
            ],
        }
        step = int(sched.decode_steps)
        if self.rank == 0:
            checkpointing.save(path, step, self._snapshot_trees(), extra=extra)
            if self.fault_spec is not None:
                for kind in self.fault_spec.ckpt_faults_at(step):
                    faults_mod.inject_ckpt_fault(path, step, kind)
        if self.K > 1:
            dist.barrier()
        return step

    def restore_serve(self, path: str) -> dict:
        """Resume from the newest intact snapshot at ``path``.

        The arena is rebuilt (device state died with the process): every
        non-terminal request is resubmitted with ``prompt + committed`` as
        its prompt and the remaining budget, in-flight requests ahead of
        queued ones.  Returns {"step", "in_flight", "waiting", "done",
        "committed"}."""
        bps = self.pc.blocks_per_seq
        template = {"serve": {
            "page_table": np.zeros((self.n_slots, bps), np.int32),
            "pos": np.zeros((self.n_slots,), np.int32),
            "occupancy": np.zeros((self.pc.num_pages,), np.int8),
        }}
        step, _trees, _ = checkpointing.restore_with_fallback(path, template)
        meta = checkpointing.read_meta(path, step)
        extra = meta.get("extra", {})
        if extra.get("serve_snapshot") != SNAPSHOT_VERSION:
            raise checkpointing.CheckpointStructureError(
                "serve", f"not a v{SNAPSHOT_VERSION} serve snapshot "
                         f"(got {extra.get('serve_snapshot')!r})")
        fp = extra["fingerprint"]
        if fp != self._fingerprint():
            diff = {k: (fp.get(k), v) for k, v in self._fingerprint().items()
                    if fp.get(k) != v}
            raise checkpointing.CheckpointStructureError(
                "serve", f"snapshot fingerprint mismatch: {diff}")
        self.reset()
        sched = self.sched
        sched.decode_steps = int(extra["decode_steps"])
        for r in extra["results"]:
            rr = RequestResult(rid=int(r["rid"]), kind=r["kind"],
                               tokens=tuple(int(t) for t in r["tokens"]))
            sched.results[rr.rid] = rr
            sched.stats[rr.kind] = sched.stats.get(rr.kind, 0) + 1
        in_flight = done = 0
        resumed: list[Request] = []

        def _revive(st, was_active: bool):
            nonlocal in_flight, done
            rid = int(st["rid"])
            committed = [int(t) for t in st["out"]] if was_active else []
            remaining = int(st["max_new"]) - len(committed)
            if committed:
                self._committed[rid] = committed
            if was_active and remaining <= 0:
                # budget already spent: terminal, nothing to decode
                sched.results[rid] = RequestResult(rid=rid, kind="ok",
                                                   tokens=tuple(committed))
                sched.stats["ok"] = sched.stats.get("ok", 0) + 1
                done += 1
                return
            prompt = [int(t) for t in st["prompt"]] + committed
            resumed.append(Request(rid=rid, prompt=prompt, max_new=remaining,
                                   deadline=st["ttl_left"]))
            if was_active:
                in_flight += 1
                if st.get("stalled"):
                    self._stalled_rids.add(rid)

        for st in extra["slots"]:
            if st is not None:
                _revive(st, was_active=True)
        for st in list(extra["waiting"]) + list(extra["backoff"]):
            _revive(dict(st, out=[]), was_active=False)
        for req in resumed:
            sched.submit(req)
        return {"step": step, "in_flight": in_flight,
                "waiting": len(extra["waiting"]) + len(extra["backoff"]),
                "done": done,
                "committed": {r: len(t) for r, t in self._committed.items()}}

    # -- the decode loop ---------------------------------------------------

    def run(self, requests, events=None, _stop_after=None) -> dict:
        """Drive every request to a terminal outcome; returns {rid: out
        tokens} of the requests that finished ``ok`` (the typed picture is
        :meth:`results`).  ``events`` (a list) collects ("admit" |
        "retire" | "evict:KIND" | "fault:KIND", rid, slot, decode_step)
        tuples.  ``_stop_after`` (a test hook) abandons the loop after that
        many waves, as a kill would."""
        for r in requests:
            self.sched.submit(r)
        self._admit_and_prefill(events)
        idle_spins = 0
        while self.sched.has_work():
            self._apply_host_faults(events)
            for i, slot, kind in self.sched.expire_active(self.stall_patience):
                self._stalled_rids.discard(slot.req.rid)
                if events is not None:
                    events.append((f"evict:{kind}", slot.req.rid, i, self.sched.decode_steps))
            self._admit_and_prefill(events)
            if not self.sched.has_work():
                break
            packable = [(i, s) for i, s in self.sched.active()
                        if s.req.rid not in self._stalled_rids]
            if not packable:
                if self.sched.active():
                    # every active slot is stalled: let the wave clock tick
                    # so stall_patience / deadlines can evict them
                    self.sched.decode_steps += 1
                    continue
                # nothing active: only backoff-delayed work is left
                if self.sched.force_readmit():
                    idle_spins += 1
                    if idle_spins <= self.n_slots + len(self.sched.backoff) + 1:
                        continue
                raise RuntimeError(
                    "scheduler stalled: queued requests but nothing active "
                    f"(waiting={len(self.sched.waiting)} "
                    f"backoff={len(self.sched.backoff)} "
                    f"free_pages={self.allocator.n_free})")
            idle_spins = 0
            committed = self._decode_wave(packable, events)
            self.sched.decode_steps += 1
            for i, t in committed.items():
                slot = self.sched.slots[i]
                if slot is None:
                    continue  # evicted between commit and here
                slot.out.append(t)
                slot.last_token = t
                slot.pos += 1
                slot.last_progress = self.sched.decode_steps
            if (self.snapshot_dir and self.snapshot_every
                    and self.sched.decode_steps % self.snapshot_every == 0):
                self.snapshot(self.snapshot_dir)
            if _stop_after is not None and self.sched.decode_steps >= _stop_after:
                break
            self._admit_and_prefill(events)
        return {rid: list(rr.tokens) for rid, rr in self.results().items() if rr.ok}

    def reset(self) -> None:
        """Empty the engine (fresh scheduler and page bookkeeping).  The
        arena is not cleared: a slot reads only positions below its own
        ``pos`` through its own page table, and prefill overwrites every
        page it is granted."""
        self.allocator = KVC.PageAllocator(self.pc.num_pages)
        self.sched = Scheduler(self.n_slots, self.pc.page_size, self.pc.blocks_per_seq,
                               self.allocator, **self._sched_opts)
        self.wire_bytes = 0.0
        self.coded_bits = 0.0
        self._stalled_rids = set()
        self._committed = {}
        self.timing = {"prefill_s": [], "wave_s": []}
        if self.ex is not None:
            self.ex_state = self.ex.init_state(self.device)

    @property
    def cache_bytes(self) -> int:
        """Arena bytes per rank (the quantization win the CLI reports)."""
        return KVC.cache_bytes(self.pc)

    @property
    def fp32_cache_bytes(self) -> int:
        return KVC.fp32_cache_bytes(self.pc)
