"""Fault injection and the host-side guard runtime (port of
``repro/core/faults.py``).

* :class:`FaultSpec` — a deterministic, seed-free fault schedule parsed
  from one string (the train CLI's ``--fault-spec``).  The device kinds
  (NaN-poisoned gradients, dropped workers, corrupted wire buffers) are
  predicates of ``(step, worker)``; the step is the train loop's host
  int, so each predicate is decided on the host, but the injectors keep
  the reference's arithmetic: while a spec holds events of a kind, every
  leaf gets ``+ nan`` / ``+ inf`` where the event is active and ``+ 0.0``
  where it is not (which turns a ``-0.0`` into ``+0.0``, as the
  reference's ``where(active, nan, 0.0)`` does).  A spec with no events of
  a kind returns its input unchanged.  Host faults (truncated / torn
  checkpoint files) are applied by :func:`inject_ckpt_fault` between
  steps.
* :func:`tree_all_finite` — the all-leaves finiteness flag the step guard
  all-reduces across workers (:mod:`repro_torch.launch.steps`,
  ``guard=True``).
* :class:`Watchdog` — keeps a last-known-good host snapshot of the carried
  state and decides when K consecutive rejections (or a high rejection
  rate over a trailing window) warrant rolling the run back to it.

Grammar of a fault spec (events joined by ``;``)::

    kind@STEP[-END][:worker=I | :slot=I]

    nan_grad@5:worker=2        NaN-poison worker 2's local gradients at step 5
    drop@8-10:worker=3         worker 3 drops out of the exchange, steps 8-10
    wire_corrupt@6             corrupt the exchanged aggregate at step 6
    ckpt_truncate@12           truncate the npz written for step 12 (torn write)
    ckpt_drop_meta@12          delete the meta written for step 12
    ckpt_garbage_latest@12     scribble garbage over the ``latest`` pointer

    nan_logits@5:slot=2        NaN-poison decode slot 2's logits at step 5
    slot_drop@8                forcibly evict every active request at step 8
    page_corrupt@6:slot=1      scribble NaN over a cache page of slot 1
    request_stall@4:slot=0     slot 0's request stops making progress
    crash@7                    the serve process dies (os._exit) before step 7

The serve kinds (``SERVE_KINDS``) belong to a decode loop, the train kinds
to the train step; both scopes share :func:`add_fault_spec_flag` and
:meth:`FaultSpec.parse_cli`, which rejects kinds outside the caller's
scope.  Step indices are the wall-clock loop step the caller passes as
``fault_step`` (not the optimizer's ``count``: a rejected step does not
advance ``count``, and a schedule keyed on it would re-fire forever).
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Optional

import torch

# device-side kinds act inside the train step; host-side (ckpt_*) kinds are
# applied between steps by inject_ckpt_fault
DEVICE_KINDS = ("nan_grad", "drop", "wire_corrupt")
HOST_KINDS = ("ckpt_truncate", "ckpt_drop_meta", "ckpt_garbage_latest")
# serve-loop kinds: nan_logits acts inside the decode step; the rest are
# host events applied between decode waves
SERVE_KINDS = ("nan_logits", "slot_drop", "page_corrupt", "request_stall",
               "crash")
ALL_KINDS = DEVICE_KINDS + HOST_KINDS + SERVE_KINDS

# what each CLI accepts: the ckpt_* kinds are shared
TRAIN_SCOPE = DEVICE_KINDS + HOST_KINDS
SERVE_SCOPE = SERVE_KINDS + HOST_KINDS

#: exit code of a process killed by a scheduled ``crash`` event
CRASH_EXIT_CODE = 13

#: coordinates :func:`tree_all_finite` checks at a time (bounds its bool
#: temporary to 64 MB for the largest leaf, the error-feedback memory)
FINITE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` active for steps [start, end],
    optionally scoped to one worker or one decode slot (None = all)."""

    kind: str
    start: int
    end: int
    worker: Optional[int] = None
    slot: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A static (frozen, hashable) fault schedule.

    Build with :meth:`parse`; hand to ``make_train_step(...,
    fault_spec=spec)``.  Every injector returns its input unchanged when
    the spec holds no events of its kind."""

    events: tuple = ()

    @classmethod
    def parse(cls, text: Optional[str]) -> "FaultSpec":
        """``"nan_grad@5:worker=2;nan_logits@5:slot=2"`` -> FaultSpec.

        Unknown kinds, malformed steps, or a missing ``@`` raise
        ValueError naming the offending event."""
        if not text:
            return cls(())
        events = []
        for raw in text.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if "@" not in raw:
                raise ValueError(f"fault event {raw!r} has no '@STEP'")
            kind, _, rest = raw.partition("@")
            kind = kind.strip()
            if kind not in ALL_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; known: {ALL_KINDS}"
                )
            steps, _, opts = rest.partition(":")
            worker = slot = None
            if opts:
                k, _, v = opts.partition("=")
                k = k.strip()
                if k not in ("worker", "slot"):
                    raise ValueError(f"unknown fault option {opts!r} in {raw!r}")
                try:
                    val = int(v)
                except ValueError:
                    raise ValueError(
                        f"bad {k} index {v!r} in {raw!r}"
                    ) from None
                if k == "worker":
                    worker = val
                else:
                    slot = val
            lo, _, hi = steps.partition("-")
            try:
                start = int(lo)
                end = int(hi) if hi else start
            except ValueError:
                raise ValueError(f"bad step range {steps!r} in {raw!r}") from None
            if end < start:
                raise ValueError(f"empty step range {steps!r} in {raw!r}")
            events.append(FaultEvent(kind, start, end, worker, slot))
        return cls(tuple(events))

    @classmethod
    def parse_cli(cls, text: Optional[str], scope: str) -> "FaultSpec":
        """Parse a CLI ``--fault-spec`` value and enforce the caller's
        scope: ``"train"`` accepts train + checkpoint kinds, ``"serve"``
        serve + checkpoint kinds; a kind of the other scope raises."""
        allowed = {"train": TRAIN_SCOPE, "serve": SERVE_SCOPE}.get(scope)
        if allowed is None:
            raise ValueError(f"unknown fault scope {scope!r}")
        spec = cls.parse(text)
        for e in spec.events:
            if e.kind not in allowed:
                raise ValueError(
                    f"fault kind {e.kind!r} is not a {scope} fault; "
                    f"{scope} accepts: {allowed}"
                )
        return spec

    # -- queries ---------------------------------------------------------

    def of_kind(self, kind: str) -> tuple:
        return tuple(e for e in self.events if e.kind == kind)

    def has(self, kind: str) -> bool:
        return any(e.kind == kind for e in self.events)

    @property
    def has_device_events(self) -> bool:
        """True when the train step needs the ``fault_step`` argument."""
        return any(e.kind in DEVICE_KINDS for e in self.events)

    def ckpt_faults_at(self, step: int) -> tuple:
        """Host-side fault kinds scheduled for the checkpoint at ``step``."""
        return tuple(
            e.kind for e in self.events
            if e.kind in HOST_KINDS and e.start <= step <= e.end
        )

    # -- serve-loop queries (host side, exact wall-clock step) -----------

    @property
    def has_serve_device_events(self) -> bool:
        """True when a decode step needs the ``fault_step`` argument."""
        return self.has("nan_logits")

    def slots_hit(self, kind: str, step: int) -> Optional[list]:
        """Slot indices a host serve fault targets at ``step``; ``[None]``
        entries mean every active slot; ``None`` = no event active."""
        hits = [
            e.slot for e in self.events
            if e.kind == kind and e.start <= step <= e.end
        ]
        return hits or None

    def crash_at(self, step: int) -> bool:
        """True when a scheduled ``crash`` kills the process before the
        decode wave at ``step`` runs."""
        return any(
            e.kind == "crash" and e.start <= step <= e.end
            for e in self.events
        )

    # -- injectors -------------------------------------------------------

    @staticmethod
    def _active(events, step: int, worker_ix: Optional[int] = None) -> bool:
        """Any of ``events`` active at (step, worker); a worker-scoped
        event with no worker given is read at worker 0."""
        wix = 0 if worker_ix is None else int(worker_ix)
        return any(e.start <= step <= e.end and (e.worker is None or wix == e.worker)
                   for e in events)

    def liveness(self, step: int, worker_ix: int, device) -> Optional[torch.Tensor]:
        """f32 scalar on ``device``: 0.0 while this worker is dropped, 1.0
        otherwise; None when the spec has no ``drop`` events (the exchange
        then takes no mask at all)."""
        events = self.of_kind("drop")
        if not events:
            return None
        dead = self._active(events, step, worker_ix)
        return torch.tensor(0.0 if dead else 1.0, dtype=torch.float32, device=device)

    def poison_grads(self, tree, step: int, worker_ix: int):
        """Add NaN to every gradient leaf while a ``nan_grad`` event is
        active for this (step, worker), 0.0 otherwise (a new tree)."""
        events = self.of_kind("nan_grad")
        if not events:
            return tree
        poison = float("nan") if self._active(events, step, worker_ix) else 0.0
        return _map(lambda g: g + poison, tree)

    def poison_logits(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        """Add NaN to the rows (decode slots) of ``logits`` that an active
        ``nan_logits`` event names (every row for an event without
        ``slot=``), 0.0 to the others."""
        events = self.of_kind("nan_logits")
        if not events:
            return logits
        n = logits.shape[0]
        bad = [False] * n
        for e in events:
            if e.start <= step <= e.end:
                for row in range(n):
                    bad[row] = bad[row] or e.slot is None or row == e.slot
        poison = torch.tensor([float("nan") if b else 0.0 for b in bad],
                              dtype=torch.float32, device=logits.device)
        return logits + poison[:, None].to(logits.dtype)

    def corrupt_mean(self, tree, step: int):
        """Add Inf to every leaf of the exchanged mean while a
        ``wire_corrupt`` event is active (un-scoped to a worker: a corrupt
        wire buffer poisons every worker's copy of the mean), 0.0
        otherwise (a new tree)."""
        events = self.of_kind("wire_corrupt")
        if not events:
            return tree
        poison = float("inf") if self._active(events, step) else 0.0
        return _map(lambda g: g + poison, tree)


# ---------------------------------------------------------------------------
# Trees of state (dicts, lists, tuples, named tuples, dataclasses, tensors)
# ---------------------------------------------------------------------------


def _children(node):
    """(kind, [(key, child), ...]) of a container node; kind None for a leaf."""
    if isinstance(node, dict):
        return "dict", list(node.items())
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return "dataclass", [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, (list, tuple)):
        return "seq", list(enumerate(node))
    return None, []


def _rebuild(node, kind, values: dict):
    if kind == "dict":
        return dict(values)
    if kind == "dataclass":
        return dataclasses.replace(node, **values)
    items = [values[i] for i in range(len(node))]
    if hasattr(node, "_fields"):  # a named tuple
        return type(node)(*items)
    return type(node)(items)


def _map(fn, tree, prev=None, *, with_prev: bool = False):
    """``fn`` applied to every tensor of ``tree`` (other leaves kept).  With
    ``with_prev``, ``fn(t, p)`` also gets the tensor at the same place of
    ``prev`` (None where ``prev`` has no such place)."""
    if torch.is_tensor(tree):
        return fn(tree, prev if torch.is_tensor(prev) else None) if with_prev else fn(tree)
    kind, items = _children(tree)
    if kind is None:
        return tree
    pkind, pitems = _children(prev)
    pmap = dict(pitems) if pkind == kind else {}
    return _rebuild(tree, kind, {k: _map(fn, v, pmap.get(k), with_prev=with_prev)
                                 for k, v in items})


def _tensors(tree) -> list:
    out = []
    _map(lambda t: out.append(t) or t, tree)
    return out


def tree_all_finite(*trees) -> torch.Tensor:
    """0-dim bool tensor: every floating-point tensor of every tree is
    finite (integer tensors and host ints, the step counters, are
    skipped; True when there is no float tensor).  The local flag the step
    guard all-reduces: one non-finite coordinate on one alive worker
    rejects the step for every worker.  Each leaf is read in chunks of
    :data:`FINITE_CHUNK` coordinates; the flags stay on the device."""
    flags = []
    for tree in trees:
        for leaf in _tensors(tree):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            flat = leaf.detach().reshape(-1)
            if flat.numel() <= FINITE_CHUNK:
                flags.append(torch.isfinite(flat).all())
            else:
                flags += [torch.isfinite(c).all() for c in flat.split(FINITE_CHUNK)]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


# ---------------------------------------------------------------------------
# Host-side checkpoint fault injection (simulated crashes / torn writes)
# ---------------------------------------------------------------------------


def inject_ckpt_fault(path: str, step: int, kind: str) -> None:
    """Corrupt the on-disk checkpoint for ``step`` the way a crash would.

    ``ckpt_truncate``: chop the npz in half (a torn write, which the
    per-array crc32 in the meta must catch).  ``ckpt_drop_meta``: delete
    the meta (the npz landed but the process died before the meta).
    ``ckpt_garbage_latest``: scribble over the ``latest`` pointer
    (``latest_step`` must answer None, not raise).
    """
    if kind == "ckpt_truncate":
        p = os.path.join(path, f"ckpt_{step}.npz")
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif kind == "ckpt_drop_meta":
        os.remove(os.path.join(path, f"ckpt_{step}.meta"))
    elif kind == "ckpt_garbage_latest":
        with open(os.path.join(path, "latest"), "w") as f:
            f.write("not-a-step\n")
    else:
        raise ValueError(f"unknown checkpoint fault {kind!r}; known: {HOST_KINDS}")


# ---------------------------------------------------------------------------
# The one --fault-spec CLI entry point
# ---------------------------------------------------------------------------


def add_fault_spec_flag(ap, scope: str) -> None:
    """Register ``--fault-spec`` on an argparse parser with the shared
    grammar help (``scope`` "train" or "serve"); parse its value with
    :func:`parse_fault_spec_arg`."""
    allowed = {"train": TRAIN_SCOPE, "serve": SERVE_SCOPE}[scope]
    ap.add_argument(
        "--fault-spec", default="",
        help=(
            "deterministic fault schedule, events joined by ';': "
            "kind@STEP[-END][:worker=I|:slot=I].  "
            f"{scope} kinds: {', '.join(allowed)}"
        ),
    )


def parse_fault_spec_arg(text: Optional[str], scope: str) -> FaultSpec:
    """Parse a CLI ``--fault-spec`` value; exits with code 2 (argparse's
    usage error) and a pointed message on a bad grammar or an
    out-of-scope kind."""
    import sys

    try:
        return FaultSpec.parse_cli(text, scope)
    except ValueError as e:
        print(f"[{scope}] bad --fault-spec: {e}", file=sys.stderr)
        raise SystemExit(2)


# ---------------------------------------------------------------------------
# Host-side watchdog (rollback policy for the step guard)
# ---------------------------------------------------------------------------


def _host_copy(x: torch.Tensor, into: Optional[torch.Tensor]) -> torch.Tensor:
    """A host copy of ``x``, written into ``into`` when it has x's shape and
    dtype (the previous snapshot's buffer), else into a new buffer, pinned
    when ``x`` is on the card."""
    if into is None or into.shape != x.shape or into.dtype != x.dtype:
        into = torch.empty(x.shape, dtype=x.dtype, device="cpu", pin_memory=x.is_cuda)
    return into.copy_(x.detach())


class Watchdog:
    """Keeps a last-known-good snapshot; decides when to roll back.

    The step guard (``make_train_step(..., guard=True)``) rejects single
    non-finite steps, carrying the state through unchanged.  The watchdog
    handles a run that keeps rejecting: it is rolled back to the newest
    snapshot taken while the run was healthy.

    Triggers (either): ``rollback_after`` consecutive rejected steps, or at
    least ``divergence_rate`` of the last ``window`` steps rejected
    (default window: 4 x rollback_after).

    The snapshot is a host copy (pinned for tensors on the card), because
    the port's step writes the parameters and the error-feedback memory in
    place: a reference to a live tensor would move with it.  A new
    snapshot is written into the previous one's buffers where the shapes
    match, so the host memory is allocated once::

        wd = Watchdog(rollback_after=3)
        wd.record_good(0, {"params": params, ...})
        ...
        if wd.observe(step, rejected, nonfinite):
            snap_step, trees = wd.rollback(device)
    """

    def __init__(self, rollback_after: int = 3, divergence_rate: float = 0.5,
                 window: Optional[int] = None):
        if rollback_after < 1:
            raise ValueError(f"rollback_after must be >= 1, got {rollback_after}")
        if not (0.0 < divergence_rate <= 1.0):
            raise ValueError(
                f"divergence_rate must be in (0, 1], got {divergence_rate}"
            )
        self.rollback_after = rollback_after
        self.divergence_rate = divergence_rate
        self.window = window if window is not None else 4 * rollback_after
        self._recent: collections.deque = collections.deque(maxlen=self.window)
        self._snapshot = None  # (step, {name: host tree})
        self.consecutive = 0
        self.rejected_steps = 0
        self.nonfinite_steps = 0
        self.rollbacks = 0

    @property
    def has_snapshot(self) -> bool:
        return self._snapshot is not None

    @property
    def snapshot_step(self) -> Optional[int]:
        return self._snapshot[0] if self._snapshot else None

    @property
    def snapshot_bytes(self) -> int:
        """Bytes of the host snapshot's tensors (0 without a snapshot)."""
        if self._snapshot is None:
            return 0
        return sum(t.numel() * t.element_size() for t in _tensors(self._snapshot[1]))

    def record_good(self, step: int, trees: dict) -> None:
        """Snapshot the carried state (host copies) as last-known-good."""
        prev = self._snapshot[1] if self._snapshot is not None else None
        self._snapshot = (int(step), _map(_host_copy, trees, prev, with_prev=True))

    def observe(self, step: int, rejected: bool, nonfinite: bool) -> bool:
        """Record one step's guard verdict; True = the caller should roll
        back now (and a snapshot exists to roll back to)."""
        self._recent.append(bool(rejected))
        if nonfinite:
            self.nonfinite_steps += 1
        if rejected:
            self.rejected_steps += 1
            self.consecutive += 1
        else:
            self.consecutive = 0
        if not self.has_snapshot:
            return False
        if self.consecutive >= self.rollback_after:
            return True
        if (len(self._recent) == self.window
                and sum(self._recent) / self.window >= self.divergence_rate):
            return True
        return False

    def rollback(self, device=None):
        """Return (snapshot_step, trees) and reset the triggers; the trees'
        tensors are fresh copies on ``device`` (default: the host), so the
        snapshot stays intact for a later rollback."""
        assert self._snapshot is not None, "no snapshot to roll back to"
        self.rollbacks += 1
        self.consecutive = 0
        self._recent.clear()
        step, host_trees = self._snapshot
        return step, _map(lambda t: t.to(device if device is not None else t.device,
                                         copy=True), host_trees)

    def summary(self) -> str:
        return (f"nonfinite_steps={self.nonfinite_steps} "
                f"rejected={self.rejected_steps} rollbacks={self.rollbacks}")
