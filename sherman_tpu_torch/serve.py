"""Serving front door: continuous batching with SLO-adaptive step width
(counterpart of ``sherman_tpu/serve.py``; host Python over the port's
engine, no kernel of its own).

The request path that clients sit behind: independent client requests
(read / insert / delete / scan) coalesce into device steps, and the step
width is picked against a per-class p99 target instead of a fixed batch.
One dispatcher thread drives the card; clients only enqueue.

- **Admission** (:meth:`ShermanServer.submit`, any thread): typed,
  synchronous backpressure.  A full queue, or a tenant past its weighted
  max-min fair share of it, raises :class:`ServeOverloadError`; writes
  are shed first under pressure (brownout, with hysteresis); on the
  engine's degraded entry, write admissions and queued writes fail with
  the typed :class:`~sherman_tpu_torch.models.batched.DegradedError`
  while reads keep serving.  Admission does no device work.
- **Continuous batching** (the dispatcher): queued reads coalesce,
  round-robin across tenants and FIFO within one, into a step of the
  width the :class:`WidthController` picks, dispatched through
  :func:`~sherman_tpu_torch.workload.device_prep.make_ingress_step`,
  whose serve is the engine's own fan-out function.  With
  ``fusion="pipelined"`` (default) one batch stays in flight: batch k's
  prep and dispatch overlap batch k-1's serve; ``"aligned"`` completes
  each batch before the next.  The port's dispatch syncs the host once
  per straggler round of the serve, so the overlap is smaller than the
  reference's.
- **Adaptive width**: a calibration sweep over the ladder (the
  closed-loop wall of each rung; every rung is built and warmed here,
  which is what lets the loop seal) seeds the controller; each completed
  step's wall refines it, and a measured window p99 past the target
  steps the cap down when the service, not the queue, owns the tail.
- **Sealed serving loop**: after warm-up the program ledger is sealed,
  so a new call signature in steady state is a counted
  ``compile.retrace``.
- **Journaled by construction**: a write is acked only after the engine
  op returns, and a journaled engine appends the op's record (fsync'd,
  group-committed under ``Journal(group_commit_ms=...)``) before it
  returns, so no ack outruns a covering fsync; one batch record covers
  every client write a flush coalesced.
- **Client contract**: ``rid`` on a write arms exactly-once (a per-tenant
  dedup window re-acks an acked rid's ORIGINAL result, an in-flight rid
  joins the same future, ``J_ACK`` records journal the window post-apply
  pre-ack, and :meth:`ShermanServer.seed_dedup` adopts a recovered one);
  ``deadline_ms`` sheds a still-queued request typed
  (:class:`DeadlineExceededError`); :meth:`ShermanServer.drain` serves
  what was admitted and pushes a final fsync; :class:`RetryPolicy` /
  :class:`RetryingClient` retry typed backpressure with jittered backoff,
  hedge reads and retry writes only under a rid; an attached
  :class:`~sherman_tpu_torch.audit.Auditor` checks the acked history
  linearizable per key in the background.
- **Telemetry**: per-request end-to-end latency in a dedicated
  :class:`~sherman_tpu_torch.obs.slo.SloTracker`, published as the
  ``serve.`` pull collector with the admission counters; ``serve.*``
  flight events (start, sealed, width changes, brownout, dispatch
  errors, drain, stop).

Knobs: ``SHERMAN_SERVE_WIDTHS``, ``SHERMAN_SERVE_P99_MS``,
``SHERMAN_SERVE_QUEUE_OPS``, ``SHERMAN_SERVE_GROUP_COMMIT_MS``,
``SHERMAN_SERVE_WEIGHTS``, ``SHERMAN_SERVE_DEDUP``,
``SHERMAN_SERVE_WRITE_LANE`` (off) and ``SHERMAN_ACK_QUORUM`` (1).
Quorum acks past the primary (``ack_quorum`` K > 1) gate every write ack
on K-1 follower watermarks of the replica group attached with
:meth:`ShermanServer.attach_replica_group` (``replica.py``).

Not promised: cross-request ordering.  A read admitted after a write may
be served from the pre-write state; per-key read-your-write holds once
the write's future resolved before the read was submitted.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
import weakref
from collections import OrderedDict, deque

import numpy as np

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ConfigError, KeyRangeError, \
    ShermanError, StateError
from sherman_tpu_torch.models.batched import DegradedError
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.obs import recorder as FR
from sherman_tpu_torch.obs import slo as SLO
from sherman_tpu_torch.replica import QuorumTimeoutError
from sherman_tpu_torch.utils import journal as J
from sherman_tpu_torch.workload.device_prep import make_ingress_step

__all__ = [
    "ServeOverloadError", "DeadlineExceededError", "ServeConfig",
    "ServeFuture", "WidthController", "ShermanServer", "RetryPolicy",
    "RetryingClient", "READ_CLASSES", "WRITE_CLASSES", "OP_CLASSES",
]

READ_CLASSES = ("read", "scan")
WRITE_CLASSES = ("insert", "delete")
OP_CLASSES = READ_CLASSES + WRITE_CLASSES


class ServeOverloadError(ShermanError, RuntimeError):
    """Typed admission backpressure: the front door refused this request
    at submit time — queue full, tenant over its fair share, or write
    shed under brownout.  Sits beside the engine's ``ST_LOCK_TIMEOUT``
    and :class:`~sherman_tpu_torch.models.batched.DegradedError` typed
    rejects; clients back off and retry, they never see a silent
    drop."""


class DeadlineExceededError(ShermanError, RuntimeError):
    """Typed deadline shed: the request's budget expired while it was
    still QUEUED, so it was removed before dispatch — a deadline the
    front door cannot meet is reported, never silently served late.
    (Requests already dispatched when the budget expires complete
    normally; in-flight device work is not cancelled.)"""


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


def _env_weights() -> dict:
    """``SHERMAN_SERVE_WEIGHTS``: weighted per-tenant admission shares,
    ``tenant:weight`` pairs (``gold:2,free:1``).  Unlisted tenants
    weigh 1.0 — the max-min fair share generalizes to weighted max-min
    (a 2:1 split holds 2/3 vs 1/3 of the queue under contention)."""
    v = os.environ.get("SHERMAN_SERVE_WEIGHTS", "")
    out: dict[str, float] = {}
    if not v.strip():
        return out
    try:
        for part in v.split(","):
            name, w = part.split(":")
            out[name.strip()] = float(w)
    except ValueError:
        raise ConfigError(
            f"SHERMAN_SERVE_WEIGHTS={v!r}: want tenant:weight pairs")
    for name, w in out.items():
        if w <= 0:
            raise ConfigError(
                f"SHERMAN_SERVE_WEIGHTS tenant {name!r}: want a "
                "positive weight")
    return out

def _env_widths() -> tuple[int, ...]:
    """``SHERMAN_SERVE_WIDTHS``: comma-separated step-width ladder of
    the front door's read path (ascending; every rung is warmed before
    the loop seals).  The default suits small trees; deployments on the
    card ladder toward the bench's 4 M-op width."""
    v = os.environ.get("SHERMAN_SERVE_WIDTHS", "1024,4096,16384,65536")
    try:
        widths = tuple(sorted({int(w) for w in v.split(",") if w.strip()}))
    except ValueError:
        raise ConfigError(
            f"SHERMAN_SERVE_WIDTHS={v!r}: want comma-separated ints")
    if not widths or widths[0] <= 0:
        raise ConfigError(
            f"SHERMAN_SERVE_WIDTHS={v!r}: want positive widths")
    return widths


def _env_p99_targets() -> dict[str, float]:
    """``SHERMAN_SERVE_P99_MS``: per-class end-to-end p99 targets in
    ms — a bare number applies to every class, or
    ``read:20,insert:200`` per class."""
    v = os.environ.get("SHERMAN_SERVE_P99_MS", "50")
    out: dict[str, float] = {}
    try:
        if ":" in v:
            for part in v.split(","):
                cls, ms = part.split(":")
                out[cls.strip()] = float(ms)
        else:
            out = {cls: float(v) for cls in OP_CLASSES}
    except ValueError:
        raise ConfigError(
            f"SHERMAN_SERVE_P99_MS={v!r}: want a float or "
            "class:float pairs")
    for cls in out:
        if cls not in OP_CLASSES:
            raise ConfigError(
                f"SHERMAN_SERVE_P99_MS class {cls!r}: want one of "
                f"{OP_CLASSES}")
    for cls in OP_CLASSES:
        out.setdefault(cls, 50.0)
    return out


@dataclasses.dataclass
class ServeConfig:
    """Front-door knobs.  ``from_env`` reads the ``SHERMAN_SERVE_*``
    family; tests construct directly."""

    #: read-path step-width ladder (ascending; each rung one compiled
    #: shape, warmed before seal)
    widths: tuple = dataclasses.field(default_factory=_env_widths)
    #: per-class end-to-end p99 targets (ms)
    p99_targets_ms: dict = dataclasses.field(
        default_factory=_env_p99_targets)
    #: admission capacity in queued OPS (not requests); 0 = derive
    #: 4x the widest rung
    max_queue_ops: int = 0
    #: write-shed brownout thresholds as queue-occupancy fractions
    brownout_hi: float = 0.75
    brownout_lo: float = 0.50
    #: write coalescing: dispatch a write batch at this many ops ...
    write_width: int = 16384
    #: ... or when the oldest pending write has lingered this long
    write_linger_ms: float = 2.0
    #: journal group-commit window for the attached write-ahead journal
    #: (``Journal(group_commit_ms=...)``); RPO stays 0 by construction
    group_commit_ms: float = 2.0
    #: serve-tracker sliding window (the published p99's horizon)
    window_s: float = 10.0
    #: "pipelined" keeps one read batch in flight (two-deep, default);
    #: "aligned" completes each batch before the next dispatch
    fusion: str = "pipelined"
    #: second journaled lane (the write-path SLO story): run the write
    #: flush — engine op + journal append + fsync/group-commit window —
    #: on a DEDICATED thread so the read dispatcher never parks behind
    #: a commit.  The journal's single-writer contract holds (all
    #: writes still issue from ONE thread); device steps stay
    #: serialized by the engine's step mutex.  OFF is the default, as
    #: in the reference.
    write_lane: bool = False
    #: weighted per-tenant admission shares (tenant -> weight; unlisted
    #: tenants weigh 1.0) — weighted max-min fair share
    tenant_weights: dict = dataclasses.field(default_factory=_env_weights)
    #: exactly-once dedup window per tenant, in write REQUESTS (rids);
    #: 0 disables the contract plane entirely
    dedup_window: int = 4096
    #: quorum acks (``SHERMAN_ACK_QUORUM``): the durable copies a write
    #: needs before its ack resolves, the primary counting as one.  1
    #: (the default) is primary durability only: the front door is
    #: bit-identical to one without the gate.  More copies need an
    #: attached group (:meth:`ShermanServer.attach_replica_group`)
    ack_quorum: int = dataclasses.field(default_factory=C.ack_quorum)
    #: bounded quorum wait per flushed write lane; expiry fails the
    #: lane's futures with the typed ``QuorumTimeoutError`` (the rid is
    #: already in the dedup window, so a retry re-acks)
    quorum_timeout_ms: float = 5000.0
    #: p99 model: est_p99(W) = model_mult x measured wall(W) (formation
    #: wait + service; the open-loop 1.5x-span model plus slack)
    model_mult: float = 2.0
    #: closed-loop steps per ladder rung during calibration
    calib_steps: int = 3
    #: seal the compile ledger after warmup (the zero-retrace contract)
    seal: bool = True

    def __post_init__(self):
        self.widths = tuple(sorted(int(w) for w in self.widths))
        if not self.widths or self.widths[0] <= 0:
            raise ConfigError("ServeConfig.widths: want positive rungs")
        if self.max_queue_ops <= 0:
            self.max_queue_ops = 4 * self.widths[-1]
        if not (0.0 < self.brownout_lo <= self.brownout_hi <= 1.0):
            raise ConfigError(
                "ServeConfig brownout: want 0 < lo <= hi <= 1")
        if self.fusion not in ("aligned", "pipelined"):
            raise ConfigError(
                f"ServeConfig.fusion={self.fusion!r}: want "
                "aligned|pipelined")
        if int(self.ack_quorum) < 1:
            raise ConfigError(
                f"ServeConfig.ack_quorum={self.ack_quorum}: want a "
                "copy count >= 1 (1 = primary durability only)")
        if self.quorum_timeout_ms <= 0:
            raise ConfigError(
                f"ServeConfig.quorum_timeout_ms="
                f"{self.quorum_timeout_ms}: want > 0")

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        gc = os.environ.get("SHERMAN_SERVE_GROUP_COMMIT_MS")
        q = os.environ.get("SHERMAN_SERVE_QUEUE_OPS")
        wl = os.environ.get("SHERMAN_SERVE_WRITE_LANE")
        dd = os.environ.get("SHERMAN_SERVE_DEDUP")
        kw: dict = {}
        if gc is not None:
            kw["group_commit_ms"] = float(gc)
        if q is not None:
            kw["max_queue_ops"] = int(q)
        if wl is not None:
            kw["write_lane"] = wl.strip().lower() not in (
                "", "0", "false", "off", "no")
        if dd is not None:
            kw["dedup_window"] = int(dd)
        kw.update(overrides)
        return cls(**kw)


# ---------------------------------------------------------------------------
# Futures + requests
# ---------------------------------------------------------------------------

class ServeFuture:
    """Completion handle for one submitted request.  ``result()``
    blocks until the ack and re-raises the typed error when the
    request failed in flight (degraded write shed, deadline shed,
    dispatcher failure).  ``deduped`` marks a result re-acked from the
    exactly-once window (the original ack, not a re-apply)."""

    __slots__ = ("op", "tenant", "n_ops", "t_submit", "rid", "deadline",
                 "deduped", "_ev", "_result", "_error")

    def __init__(self, op: str, tenant: str, n_ops: int,
                 rid=None, deadline: float | None = None):
        self.op = op
        self.tenant = tenant
        self.n_ops = n_ops
        self.t_submit = time.perf_counter()
        self.rid = rid
        self.deadline = deadline
        self.deduped = False
        self._ev = threading.Event()
        self._result = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise StateError("serve request still in flight")
        if self._error is not None:
            raise self._error
        return self._result

    def _set(self, result) -> None:
        self._result = result
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._ev.set()


class _Request:
    __slots__ = ("fut", "keys", "values", "ranges", "payloads",
                 "resolve_payloads")

    def __init__(self, fut, keys=None, values=None, ranges=None,
                 payloads=None, resolve_payloads=False):
        self.fut = fut
        self.keys = keys
        self.values = values
        self.ranges = ranges
        self.payloads = payloads
        self.resolve_payloads = resolve_payloads


# ---------------------------------------------------------------------------
# Width controller
# ---------------------------------------------------------------------------

class WidthController:
    """SLO-adaptive step-width selection over a fixed ladder.

    State per rung: an EWMA of measured step walls (seeded by the
    calibration sweep, refined by every completed step).  The model
    ``est_p99(W) = model_mult * wall(W)`` is the open-loop
    formation-wait + service shape (latency_bench's 1.5x-span p50
    model, with slack for the tail); the pick is

    - the LARGEST rung whose modeled p99 meets the target (throughput
      inside the SLO), clamped by ``cap`` (below),
    - but never a rung wider than the backlog needs — serving 500
      queued ops through a 65 K-wide program pays the wide program's
      wall for nothing (descent cost is per ROW of the compiled
      shape), so the smallest feasible rung covering the backlog wins
      when the queue is shallow.

    ``note_window_p99`` is the measured-truth override: when the
    tracker's observed window p99 breaches the target, the cap steps
    DOWN one rung (multiplicative decrease) and holds for
    ``hold_steps`` completions before probing back up — the model
    proposes, the measurement disposes.
    """

    def __init__(self, widths, target_p99_ms: float, *,
                 model_mult: float = 2.0, ewma: float = 0.3,
                 hold_steps: int = 50):
        self.widths = tuple(sorted(int(w) for w in widths))
        if not self.widths:
            raise ConfigError("WidthController: empty width ladder")
        self.target_p99_ms = float(target_p99_ms)
        self.model_mult = float(model_mult)
        self.ewma = float(ewma)
        self.hold_steps = int(hold_steps)
        self.wall_ms: dict[int, float | None] = {w: None
                                                 for w in self.widths}
        self.cap_idx = len(self.widths) - 1
        self._hold = 0
        self._last = self.widths[0]
        self.picks: dict[int, int] = {w: 0 for w in self.widths}
        self.downshifts = 0

    def seed(self, width: int, wall_ms: float) -> None:
        self.wall_ms[width] = float(wall_ms)

    def update(self, width: int, wall_ms: float) -> None:
        prev = self.wall_ms.get(width)
        self.wall_ms[width] = (float(wall_ms) if prev is None else
                               (1 - self.ewma) * prev
                               + self.ewma * float(wall_ms))
        if self._hold > 0:
            self._hold -= 1
            if self._hold == 0 and self.cap_idx < len(self.widths) - 1:
                self.cap_idx += 1  # probe back up, one rung at a time

    def est_p99_ms(self, width: int) -> float | None:
        w = self.wall_ms.get(width)
        return None if w is None else self.model_mult * w

    def note_window_p99(self, p99_ms: float, *,
                        queue_dominated: bool = False) -> None:
        """Feed the MEASURED window p99 (serve tracker / slo_window);
        a SERVICE-dominated breach steps the cap down one rung and
        holds.  ``queue_dominated`` breaches (batch-formation wait
        exceeds the service wall — the offered load outruns capacity)
        must NOT downshift: a narrower step lowers throughput and
        deepens the very queue that caused the breach; overload relief
        is admission control's job (typed rejects), the width's job is
        to keep the SERVICE share of the latency inside the target."""
        if p99_ms > self.target_p99_ms and not queue_dominated \
                and self.cap_idx > 0 and self._hold == 0:
            self.cap_idx -= 1
            self._hold = self.hold_steps
            self.downshifts += 1

    def feasible(self) -> list[int]:
        out = []
        for w in self.widths[: self.cap_idx + 1]:
            est = self.est_p99_ms(w)
            if est is not None and est <= self.target_p99_ms:
                out.append(w)
        return out

    def pick(self, backlog_ops: int, min_ops: int = 0) -> int:
        """Choose a rung for a step serving ``backlog_ops`` of queued
        work whose largest indivisible request is ``min_ops`` wide.
        Requests never split across steps, so rungs below ``min_ops``
        are structurally unusable — when no rung inside the target can
        carry the head request, the narrowest rung that CAN wins over
        never serving it (its latency is then the queue's honest
        cost, visible in the tracker)."""
        usable = [w for w in self.widths if w >= min_ops] \
            or [self.widths[-1]]
        feas = [w for w in self.feasible() if w >= min_ops]
        if not feas:
            if backlog_ops > usable[0] and self._last in usable:
                # OVERLOAD STABILITY: a deep queue with no rung inside
                # the target means the tail is lost either way — hold
                # the current width instead of collapsing to the
                # narrowest rung, whose lower drain rate would deepen
                # the queue further (the cap-512 death spiral)
                w = self._last
            else:
                # idle/unmeasured: the narrowest structurally-usable
                # rung — lowest latency, and the measured path keeps
                # it honest
                w = usable[0]
        else:
            w = feas[-1]
            for cand in feas:
                if cand >= backlog_ops:
                    w = cand
                    break
        self.picks[w] += 1
        self._last = w
        return w

    def settled_width(self) -> int:
        """The rung this controller has used most — the receipt's
        'settled on' width."""
        return max(self.picks.items(), key=lambda kv: kv[1])[0]

    def snapshot(self) -> dict:
        return {
            "target_p99_ms": self.target_p99_ms,
            "wall_ms": {w: (round(v, 3) if v is not None else None)
                        for w, v in self.wall_ms.items()},
            "cap_width": self.widths[self.cap_idx],
            "picks": dict(self.picks),
            "downshifts": self.downshifts,
            "settled_width": self.settled_width(),
        }


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class _TenantState:
    __slots__ = ("queues", "queued_ops", "admitted_ops", "served_ops",
                 "rejected_overload", "rejected_degraded", "weight",
                 "reserve", "dedup", "pending", "dedup_hits",
                 "deadline_shed")

    def __init__(self, weight: float = 1.0, reserve: float = 2.0):
        self.queues = {cls: deque() for cls in OP_CLASSES}
        self.queued_ops = 0
        self.admitted_ops = 0
        self.served_ops = 0
        self.rejected_overload = 0
        self.rejected_degraded = 0
        #: weighted max-min share inputs: this tenant's weight, and the
        #: floor denominator (own weight + the heaviest OTHER tenant's
        #: weight — a lone flooder must always leave a newcomer's share
        #: free, the un-weighted rule's `max(2, active)` generalized)
        self.weight = weight
        self.reserve = reserve
        #: exactly-once plane: acked results keyed by rid (bounded
        #: ring) + in-flight rids (a retry joins the SAME future)
        self.dedup: OrderedDict = OrderedDict()
        self.pending: dict = {}
        self.dedup_hits = 0
        self.deadline_shed = 0


class ShermanServer:
    """The continuous-batching front door over a
    :class:`~sherman_tpu_torch.models.batched.BatchedEngine` (see the module
    docstring for the architecture).

    Lifecycle::

        srv = ShermanServer(eng, config, journal=Journal(...))
        srv.start(calib_keys=some_real_keys)   # warmup + SEAL
        fut = srv.submit("read", keys, tenant="t0")
        vals, found = fut.result()
        srv.stop()                             # drain + unseal

    Single-dispatcher contract: one thread drives every engine step
    (the journaled engine's record-order == apply-order contract);
    ``submit`` is safe from any number of client threads.
    """

    def __init__(self, eng, config: ServeConfig | None = None, *,
                 journal=None, value_heap=None, auditor=None,
                 host_id: int | None = None):
        self.eng = eng
        self.cfg = config or ServeConfig.from_env()
        #: this server's host tag in a multihost service plane (its
        #: stats carry it); ``None`` (the default) = no plane
        self.host_id = host_id
        #: optional sampling history auditor (audit.py):
        #: fed on the completion paths, checked in the background
        self.auditor = auditor
        if eng.router is None:
            raise ConfigError("ShermanServer: attach_router() first")
        self.journal = journal
        if journal is not None:
            eng.attach_journal(journal)
        self.leaf_cache = eng.leaf_cache
        # variable-size records (models/value_heap.py): payload-bearing
        # inserts allocate slabs + install handles; reads submitted with
        # resolve_payloads gather them behind the same ingress step
        self.value_heap = value_heap if value_heap is not None \
            else getattr(eng, "value_heap", None)
        # one ingress step per ladder rung — every compiled shape the
        # sealed loop can dispatch exists up front
        self._steps = {w: make_ingress_step(eng, width=w,
                                            leaf_cache=self.leaf_cache)
                       for w in self.cfg.widths}
        self.controller = WidthController(
            self.cfg.widths, self.cfg.p99_targets_ms["read"],
            model_mult=self.cfg.model_mult)
        self.tracker = SLO.SloTracker(window_s=self.cfg.window_s)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._tenants: dict[str, _TenantState] = {}
        self._rr: deque[str] = deque()  # round-robin tenant order
        self._queued_ops = 0
        self._queued_write_ops = 0
        self._queued_read_ops = 0
        # queue-vs-service latency attribution of the last completed
        # steps (EWMA of formation-wait / service-wall ratio): the
        # controller's breach handler needs to know WHO owns the tail
        self._qwait_ratio = 0.0
        self._running = False
        self._draining = False
        self._thread: threading.Thread | None = None
        self._wthread: threading.Thread | None = None
        self._sealed = False
        self._retrace0 = 0
        self._brownout = False
        self._was_degraded = False
        self._depth = 2 if self.cfg.fusion == "pipelined" else 1
        self._cur_width = self.cfg.widths[0]
        self._completions = 0
        self._last_complete_t = 0.0
        # receipt counters (plain adds on the hot paths — SL006)
        self.admitted_ops = 0
        self.served_ops = 0
        self.acked_writes = 0  # write REQUESTS acked (after the fsync)
        self.rejected_overload = 0
        self.rejected_degraded = 0
        self.dispatch_errors = 0
        # client-contract counters
        self.dedup_hits = 0        # retries re-acked from the window
        self.deadline_shed = 0     # queued requests shed typed at expiry
        self.duplicate_applies = 0  # window misses that re-applied an
        # already-acked rid (the exactly-once invariant: must stay 0 —
        # both guards would have to fail for it to move)
        # quorum-ack counters (all zero with ack_quorum=1)
        self.quorum_acks = 0        # write lanes released by a quorum
        self.quorum_timeouts = 0    # bounded waits that expired typed
        self.quorum_wait_ms = 0.0   # summed quorum wait
        self.replica_group = None   # the ReplicaGroup quorum waits ride
        self.calibration: dict[int, dict] = {}
        ref = weakref.ref(self)

        def _collect():
            s = ref()
            return s._collect() if s is not None else {}

        obs.register_collector("serve", _collect)

    # -- hot accounting (registered SL006 scopes: plain adds only) -----------

    def _note_admit(self, st: _TenantState, n: int) -> None:
        st.queued_ops += n
        st.admitted_ops += n
        self._queued_ops += n
        self.admitted_ops += n

    def _note_reject_overload(self, st: _TenantState) -> None:
        st.rejected_overload += 1
        self.rejected_overload += 1

    def _note_reject_degraded(self, st: _TenantState) -> None:
        st.rejected_degraded += 1
        self.rejected_degraded += 1

    def _note_served(self, st: _TenantState, n: int) -> None:
        st.served_ops += n
        self.served_ops += n

    def _note_dedup_hit(self, st: _TenantState) -> None:
        st.dedup_hits += 1
        self.dedup_hits += 1

    def _note_deadline_shed(self, st: _TenantState) -> None:
        st.deadline_shed += 1
        self.deadline_shed += 1

    def _note_quorum(self, ms: float) -> None:
        self.quorum_acks += 1
        self.quorum_wait_ms += ms

    # -- admission -----------------------------------------------------------

    def _tenant(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            w = float(self.cfg.tenant_weights.get(tenant, 1.0))
            others = [float(v) for k, v in self.cfg.tenant_weights.items()
                      if k != tenant]
            st = _TenantState(weight=w, reserve=w + max(others + [1.0]))
            self._tenants[tenant] = st
            self._rr.append(tenant)
        return st

    def submit(self, op: str, keys=None, values=None, *,
               tenant: str = "default", ranges=None, payloads=None,
               resolve_payloads: bool = False, rid=None,
               deadline_ms: float | None = None) -> ServeFuture:
        """Admit one request (typed backpressure; see the module
        docstring).  ``keys`` uint64 for read/insert/delete (+
        ``values`` for insert); ``ranges`` [(lo, hi), ...] for scan.
        Returns a :class:`ServeFuture` whose ``result()`` is
        ``(values, found)`` for reads, an ok-per-key bool array for
        inserts, a found-per-key bool array for deletes, and
        ``range_query_many``'s list for scans.

        Variable-size records (value heap attached): an insert with
        ``payloads`` (list of bytes, one per key) allocates heap slabs
        and installs handles; a read with ``resolve_payloads=True``
        resolves its answers' handles behind the same ingress step and
        its ``result()`` is ``(payloads list[bytes|None], found)``; a
        scan with ``resolve_payloads=True`` returns
        ``[(keys, payloads)]`` per range.

        Client contract: ``rid`` (a client-assigned u64 request id on a
        WRITE) arms exactly-once — an already-acked rid returns a
        resolved future carrying the ORIGINAL result (``fut.deduped``),
        an in-flight rid returns the same future, and the dedup check
        runs BEFORE every backpressure gate (a retrying client must be
        able to learn its write landed even under brownout/degraded).
        ``deadline_ms`` attaches a budget; a request still queued past
        it fails typed with :class:`DeadlineExceededError` instead of
        being served late."""
        if op not in OP_CLASSES:
            raise ConfigError(f"submit op {op!r}: want one of "
                              f"{OP_CLASSES}")
        if (payloads is not None or resolve_payloads) \
                and self.value_heap is None:
            raise ConfigError(
                "variable-size records need a value heap "
                "(ShermanServer(..., value_heap=) / "
                "eng.attach_value_heap(); SHERMAN_VALUE_HEAP)")
        if payloads is not None and op != "insert":
            raise ConfigError("payloads only ride insert requests")
        if not self._running:
            raise StateError("server not running (call start())")
        if op == "scan":
            if not ranges:
                raise ConfigError("scan submit needs ranges")
            n = len(ranges)
            if n > self.cfg.widths[-1]:
                raise ConfigError(
                    f"scan of {n} ranges exceeds the flush budget "
                    f"{self.cfg.widths[-1]}; chunk client-side")
        else:
            keys = np.ascontiguousarray(keys, np.uint64)
            n = int(keys.size)
            if n == 0:
                raise ConfigError("empty request")
            # per-class admit cap = the LARGEST batch the class's
            # flush path can actually take (admitting a request no
            # dispatcher budget can pop would hang its future forever
            # at the head of the tenant's FIFO)
            cap = self.cfg.write_width if op in WRITE_CLASSES \
                else self.cfg.widths[-1]
            if n > cap:
                raise ConfigError(
                    f"{op} request of {n} ops exceeds the "
                    f"{cap}-op dispatch budget; chunk client-side")
            if int(keys.min()) < C.KEY_MIN or int(keys.max()) > C.KEY_MAX:
                raise KeyRangeError("keys outside [KEY_MIN, KEY_MAX]")
            if op == "insert":
                if payloads is not None:
                    if len(payloads) != n:
                        raise ConfigError(
                            "insert needs one payload per key")
                    payloads = [bytes(b) for b in payloads]
                    # size-class validation at the DOOR: an oversized
                    # record must reject THIS request typed, not fail
                    # every co-batched tenant's insert at flush time
                    from sherman_tpu_torch.models.value_heap import \
                        class_for_bytes
                    for b in payloads:
                        class_for_bytes(len(b))  # raises ConfigError
                else:
                    values = np.ascontiguousarray(values, np.uint64)
                    if values.shape != keys.shape:
                        raise ConfigError(
                            "insert needs one value per key")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ConfigError(
                f"deadline_ms={deadline_ms}: want a positive budget")
        if rid is not None:
            rid = int(rid)
        deadline = (time.perf_counter() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        fut = ServeFuture(op, tenant, n, rid=rid, deadline=deadline)
        with self._lock:
            if not self._running:
                # re-check under the lock: a stop() racing the
                # unlocked fast-path check above may already have run
                # its final _fail_queued — a request appended now
                # would never be served OR failed
                raise StateError("server not running (call start())")
            st = self._tenant(tenant)
            # exactly-once: the dedup check runs BEFORE every
            # backpressure gate — a retry of an acked write must learn
            # its result even when a fresh write would be shed
            if rid is not None and op in WRITE_CLASSES \
                    and self.cfg.dedup_window > 0:
                cached = st.dedup.get(rid)
                if cached is not None:
                    self._note_dedup_hit(st)
                    fut.deduped = True
                    fut._set(np.array(cached[1]))
                    return fut
                pend = st.pending.get(rid)
                if pend is not None:
                    # the original is still in flight: the retry joins
                    # it (one apply, one ack, shared by both callers)
                    self._note_dedup_hit(st)
                    return pend
            if op in WRITE_CLASSES:
                reason = self.eng.degraded_reason
                if reason is not None:
                    # degraded brownout: writes reject typed at the
                    # DOOR (fail fast — queueing a write the engine
                    # will refuse only adds latency to the refusal)
                    self._note_reject_degraded(st)
                    raise DegradedError(reason)
                if self._brownout:
                    self._note_reject_overload(st)
                    raise ServeOverloadError(
                        "write shed (brownout): queue at "
                        f"{self._queued_ops}/{self.cfg.max_queue_ops} "
                        "ops; retry with backoff")
            # WEIGHTED max-min fair share: a tenant may hold at most
            # capacity * w / W queued ops, W = the total weight of
            # active tenants (so a greedy tenant saturates its own
            # share and gets typed rejects while polite tenants keep
            # admitting into theirs, proportionally to their weights).
            # The denominator floors at this tenant's weight + the
            # heaviest other's (st.reserve) — a lone flooder must never
            # hold the WHOLE queue, or a newcomer's first request
            # bounces off the total cap before fair sharing can even
            # engage (the un-weighted rule's `max(2, active)`,
            # generalized; identical shares when every weight is 1)
            active_w = sum(t.weight for t in self._tenants.values()
                           if t.queued_ops > 0)
            if st.queued_ops == 0:
                active_w += st.weight
            share = max(1, int(self.cfg.max_queue_ops * st.weight
                               / max(st.reserve, active_w)))
            if self._queued_ops + n > self.cfg.max_queue_ops \
                    or st.queued_ops + n > share:
                self._note_reject_overload(st)
                raise ServeOverloadError(
                    f"queue full (tenant {tenant!r}: "
                    f"{st.queued_ops}+{n} of fair share {share} "
                    f"at weight {st.weight}; "
                    f"total {self._queued_ops}/"
                    f"{self.cfg.max_queue_ops} ops)")
            st.queues[op].append(
                _Request(fut, keys=keys, values=values, ranges=ranges,
                         payloads=payloads,
                         resolve_payloads=resolve_payloads))
            if rid is not None and op in WRITE_CLASSES \
                    and self.cfg.dedup_window > 0:
                st.pending[rid] = fut
            self._note_admit(st, n)
            if op in WRITE_CLASSES:
                self._queued_write_ops += n
            elif op == "read":
                self._queued_read_ops += n
            # write-shed brownout entry (checked on the admission path
            # so pressure reacts at wire speed; exit is checked on the
            # dispatch path as the queue drains)
            if not self._brownout and self._queued_ops \
                    > self.cfg.brownout_hi * self.cfg.max_queue_ops:
                self._brownout = True
                FR.record_event("serve.brownout_enter",
                                queued_ops=self._queued_ops,
                                cap=self.cfg.max_queue_ops)
            self._cv.notify()
        return fut

    # -- lifecycle -----------------------------------------------------------

    def start(self, calib_keys=None, *, calib_writes=None,
              calib_delete_keys=None) -> dict:
        """Warm + calibrate every ladder rung, SEAL the compile ledger,
        and start the dispatcher.

        ``calib_keys`` (uint64, real/loaded keys) drives the read-path
        calibration sweep — closed-loop walls per rung seed the width
        controller and are returned (and kept as ``self.calibration``)
        as the ``{width: {wall_ms, ops_s}}`` frontier receipt.
        ``calib_writes`` (keys, values — value-preserving pairs, e.g.
        the loaded values) warms the insert path; ``calib_delete_keys``
        (keys known ABSENT) warms the delete descent without mutating.
        Skipping calibration (all None) skips the seal too: an unwarmed
        loop would count its own first-dispatch compiles as
        retraces."""
        if self._running:
            raise StateError("server already running")
        if int(self.cfg.ack_quorum) > 1 and self.replica_group is None:
            raise ConfigError(
                f"ack_quorum={self.cfg.ack_quorum} promises multi-copy "
                "durability but no replica group is attached "
                "(attach_replica_group): acking K copies without K-1 "
                "followers would be a lie")
        ledger = DEV.get_ledger()
        FR.record_event("serve.start", widths=list(self.cfg.widths),
                        fusion=self.cfg.fusion)
        if calib_keys is not None:
            self._calibrate(np.ascontiguousarray(calib_keys, np.uint64),
                            calib_writes, calib_delete_keys)
        self._retrace0 = ledger.retraces
        if calib_keys is not None and self.cfg.seal:
            ledger.seal()
            self._sealed = True
            FR.record_event(
                "serve.sealed",
                walls={str(w): round(c["wall_ms"], 3)
                       for w, c in self.calibration.items()})
        self._running = True
        self._draining = False
        if self.auditor is not None:
            self.auditor.start()
        self._thread = threading.Thread(target=self._loop,
                                        name="sherman-serve",
                                        daemon=True)
        self._thread.start()
        if self.cfg.write_lane:
            # the second journaled lane: write flushes (engine op +
            # journal fsync) run here so the read dispatcher never
            # stalls behind a commit window (the YCSB-A read-p99 story)
            self._wthread = threading.Thread(target=self._write_loop,
                                             name="sherman-serve-write",
                                             daemon=True)
            self._wthread.start()
        return dict(self.calibration)

    def _calibrate(self, keys_pool, calib_writes, calib_delete_keys):
        """Closed-loop sweep over the ladder: compile + warm every
        rung's programs (ingress serve, cache probe, straggler rescue,
        write paths) and measure each rung's pipelined wall — the
        width x latency frontier seed."""
        rng = np.random.default_rng(17)
        K = max(1, self.cfg.calib_steps)
        for w, step in self._steps.items():
            kidx = rng.integers(0, keys_pool.size, (K + 1, w))
            # warm (compile) outside the timing, then a short two-deep
            # closed loop — the pipelined wall the serving loop pays
            step(keys_pool[kidx[0]])
            t0 = time.perf_counter()
            h = step.dispatch(keys_pool[kidx[1]])
            for i in range(1, K):
                h2 = step.dispatch(keys_pool[kidx[i + 1]])
                step.complete(h)
                h = h2
            step.complete(h)
            wall_ms = (time.perf_counter() - t0) / K * 1e3
            self.controller.seed(w, wall_ms)
            self.calibration[w] = {
                "wall_ms": wall_ms,
                "ops_s": w / (wall_ms / 1e3),
            }
        # straggler rescue path (root descent at the engine width)
        self.eng.search(keys_pool[rng.integers(0, keys_pool.size, 64)])
        # value-heap resolve programs: warm the width-bucket ladder the
        # payload reads can dispatch (pow2 node multiples up to the
        # widest rung) plus the put/free write paths, twice each for
        # the threaded-carry variants — a payload read mid-window must
        # not be the resolve program's first compile
        if self.value_heap is not None:
            vh = self.value_heap
            wmax = self.cfg.widths[-1]
            w = 256 * vh.N
            probe = keys_pool[rng.integers(0, keys_pool.size, 8)]
            pv, pf = self.eng.search(probe)
            while True:
                pad = np.zeros(w, np.uint64)
                pad[: probe.size] = pv
                fnd = np.zeros(w, bool)
                fnd[: probe.size] = pf
                vh.resolve_u64(pad[:w], fnd[:w])
                vh.resolve_u64(pad[:w], fnd[:w])
                if w >= wmax:
                    break
                w *= 2
            wk = np.unique(keys_pool[rng.integers(0, keys_pool.size, 32)])
            try:
                # value-preserving warm: read the payloads back and
                # re-put them (compiles the slab-scatter + insert
                # shapes without changing a record)
                pays, pfound = vh.get(wk)
                keep = [p if p is not None else b"\x00" for p in pays]
                vh.put(wk, keep)
                vh.put(wk, keep)
            except ShermanError as e:
                # a tree whose values were never migrated to handles
                # cannot warm the payload write path — serve it, but
                # payload classes stay cold (first dispatch compiles)
                FR.record_event("serve.heap_warm_skipped", error=repr(e))
        # scan path (range_query_many compiles its leaf-walk lazily;
        # twice for the threaded-carry variant, like the writes below)
        lo = int(keys_pool.min())
        self.eng.range_query_many([(lo, lo + 64)])
        self.eng.range_query_many([(lo, lo + 64)])
        # sketch-admission fill program (a fill mid-window must not be
        # the first compile of engine.cache_fill)
        if self.leaf_cache is not None and self.leaf_cache.admit_every:
            seed_keys = self.leaf_cache.cached_keys()
            if seed_keys.size == 0:
                seed_keys = np.unique(keys_pool[rng.integers(
                    0, keys_pool.size, 256)])
            self.leaf_cache.fill(seed_keys)
        # write paths warm TWICE, as the reference's do (there the
        # first call's outputs are a distinct jit signature for the
        # second; here it costs one more idempotent write)
        if calib_writes is not None:
            wk, wv = calib_writes
            wk = np.ascontiguousarray(wk, np.uint64)
            wv = np.ascontiguousarray(wv, np.uint64)
            self.eng.insert(wk, wv)
            self.eng.insert(wk, wv)
        if calib_delete_keys is not None:
            dk = np.ascontiguousarray(calib_delete_keys, np.uint64)
            self.eng.delete(dk)
            self.eng.delete(dk)

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop serving.  ``drain=True`` serves everything already
        admitted first; ``drain=False`` fails queued requests with the
        typed :class:`~sherman_tpu_torch.errors.StateError` (the crash-drill
        shape keeps the journal UNCLOSED — durable records need no
        goodbye)."""
        with self._lock:
            if not self._running:
                return
            self._running = False
            self._draining = bool(drain)
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._wthread is not None:
            self._wthread.join(timeout)
        if self.auditor is not None:
            self.auditor.stop()  # final drain-all checker tick
        if self._sealed:
            DEV.get_ledger().unseal()
            self._sealed = False
        FR.record_event("serve.stop", served_ops=self.served_ops,
                        acked_writes=self.acked_writes)

    def drain(self, timeout: float = 60.0) -> None:
        """Graceful drain: stop admitting, serve everything already
        admitted (futures resolve or fail typed), push one final
        covering fsync on the attached journal, then stop.  After
        ``drain()`` returns, acked-but-unflushed is impossible by
        construction: every write ack already gated on a covering
        fsync, and the epilogue fsync closes the ``sync=False``
        window too."""
        self.stop(drain=True, timeout=timeout)
        jrn = self.journal if self.journal is not None \
            else getattr(self.eng, "journal", None)
        if jrn is not None:
            jrn.sync_now()  # no-op on a closed journal (its own guard)
        FR.record_event("serve.drain", served_ops=self.served_ops,
                        acked_writes=self.acked_writes)

    def kill(self) -> None:
        """Crash-drill stop: abandon the dispatcher without draining
        and WITHOUT closing the journal — exactly what a process crash
        leaves behind.  Every acked write is already covered by an
        fsync (the ack gate), so recovery replays to RPO 0."""
        self.stop(drain=False, timeout=5.0)

    def attach_auditor(self, auditor) -> None:
        """Attach (or detach, with None) the sampling history auditor;
        started/stopped with the server when attached before
        :meth:`start`."""
        self.auditor = auditor

    def attach_replica_group(self, group) -> None:
        """Attach (or detach, with None) the replica group whose follower
        watermarks quorum acks resolve against (``cfg.ack_quorum`` > 1).
        With the default ``ack_quorum=1`` the write path ignores it."""
        self.replica_group = group

    def _quorum_gate(self) -> None:
        """The quorum-ack gate: with ``ack_quorum`` K > 1 and a group
        attached, block until K-1 non-quarantined follower watermarks
        cover the durable journal frontier (captured now, after the lane's
        engine op and ack record returned, so it bounds both), raising
        the typed ``QuorumTimeoutError`` at the bounded deadline (the rids
        are already durable in the dedup window, so a retry re-acks).
        Never entered with K = 1, the default: no added work and
        bit-identical acks."""
        g = self.replica_group
        need = int(self.cfg.ack_quorum) - 1
        if g is None or need <= 0:
            return
        try:
            rc = g.wait_quorum(
                need, timeout_s=self.cfg.quorum_timeout_ms / 1e3)
        except QuorumTimeoutError:
            self.quorum_timeouts += 1
            raise
        self._note_quorum(rc["waited_ms"])

    def seed_dedup(self, window, rejournal: bool = True) -> int:
        """Adopt a recovered exactly-once window
        (``RecoveryPlane.recover``'s ``plane.dedup_window``:
        ``{(tenant, rid): (op_kind, ok array)}``, in ack order) — a
        write retried across the cold crash then re-acks its ORIGINAL
        result instead of re-applying.  ``rejournal`` (default) writes
        the adopted window back into the live journal segment as one
        J_ACK record: recovery re-bases onto a fresh chain (the old
        segments' ack records are swept), so without it a SECOND crash
        would forget the window.  Returns entries adopted."""
        n = 0
        acks = []
        with self._lock:
            for (tenant, rid), entry in window.items():
                # entries are (op, ok) or (op, ok, handles) — heap
                # writes carry payload provenance; both the
                # adopted window and the re-journaled record keep it
                opcode, ok = entry[0], entry[1]
                prov = entry[2:] if len(entry) > 2 else ()
                st = self._tenant(tenant)
                st.dedup[int(rid)] = (int(opcode), np.array(ok), *prov)
                st.dedup.move_to_end(int(rid))
                while len(st.dedup) > max(1, self.cfg.dedup_window):
                    st.dedup.popitem(last=False)
                acks.append((int(rid), tenant, int(opcode),
                             np.array(ok), *prov))
                n += 1
        if rejournal and acks:
            jrn = self.journal if self.journal is not None \
                else getattr(self.eng, "journal", None)
            if jrn is not None:
                jrn.append_acks(acks)
        return n

    @property
    def retraces(self) -> int:
        """Steady-state retraces observed since this server sealed."""
        return DEV.get_ledger().retraces - self._retrace0

    def retarget(self, op_class: str, p99_ms: float) -> None:
        """Re-aim one class's end-to-end p99 target at runtime (SLOs
        are operator policy, not a rebuild) — the adaptive controller
        follows on its next pick."""
        if op_class not in OP_CLASSES:
            raise ConfigError(f"retarget class {op_class!r}: want one "
                              f"of {OP_CLASSES}")
        self.cfg.p99_targets_ms[op_class] = float(p99_ms)
        if op_class == "read":
            self.controller.target_p99_ms = float(p99_ms)

    # -- dispatcher ----------------------------------------------------------

    def _loop(self) -> None:
        pend: deque = deque()  # in-flight read slots (two-deep pipeline)
        while True:
            with self._lock:
                if not self._running and (not self._draining
                                          or self._queued_ops == 0):
                    break
                has_work = self._queued_ops > 0
                if not has_work and not pend:
                    self._cv.wait(0.002)
                    has_work = self._queued_ops > 0
                    if not has_work and not pend:
                        continue
            try:
                self._check_degraded_transition()
                # write flushes ride the dedicated lane when enabled —
                # the dispatcher's read loop must never stall behind a
                # journal fsync
                did = False if self.cfg.write_lane \
                    else self._maybe_flush_writes()
                did = self._maybe_flush_scans() or did
                slot = self._dispatch_reads()
                if slot is not None:
                    pend.append(slot)
                    did = True
                while len(pend) >= (self._depth if slot is not None
                                    else 1):
                    self._complete_read(pend.popleft())
                    did = True
                    if not pend:
                        break
                if not did:
                    # admitted work exists but none of it is due yet
                    # (write linger): sleep a beat instead of spinning
                    # the GIL out from under the client threads
                    with self._lock:
                        self._cv.wait(0.0005)
            except BaseException as e:  # noqa: BLE001 — serving loop
                # must survive a bad batch: the batch's futures carry
                # the error, the loop keeps serving everyone else
                self.dispatch_errors += 1
                FR.record_event("serve.dispatch_error", error=repr(e))
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
        # shutdown: drain the pipeline, wait out the write lane (its
        # own drain loop exits on the same flags), then fail the rest.
        # A graceful drain completes in-flight slots with full
        # semantics; a kill() abandons them through the ingress step's
        # drain hook (materialize-and-answer WITHOUT straggler rescue —
        # a crashing teardown must not launch fresh root descents)
        for slot in pend:
            try:
                if self._draining:
                    self._complete_read(slot)
                else:
                    width, reqs, handle, _t0, tok = slot
                    self._fail_batch(reqs, StateError(
                        "server killed with the batch in flight"))
                    self._steps[width].drain(handle)
                    if tok is not None and self.auditor is not None:
                        self.auditor.end_ops(tok)
            except BaseException:  # noqa: BLE001
                pass
        if self._wthread is not None and self._wthread.is_alive() \
                and self._wthread is not threading.current_thread():
            self._wthread.join(10.0)
        self._fail_queued(StateError("server stopped"))

    def _write_loop(self) -> None:
        """The second journaled lane: pops write requests and runs the
        engine op + journal append/fsync off the read dispatcher's hot
        loop.  Single-writer journal contract preserved — every write
        still issues from THIS one thread."""
        while True:
            with self._lock:
                if not self._running and (not self._draining
                                          or self._queued_write_ops == 0):
                    break
                if self._queued_write_ops == 0:
                    self._cv.wait(0.002)
                    continue
            try:
                if not self._maybe_flush_writes():
                    with self._lock:
                        self._cv.wait(0.0005)
            except BaseException as e:  # noqa: BLE001 — the lane must
                # survive a bad batch like the dispatcher does
                self.dispatch_errors += 1
                FR.record_event("serve.dispatch_error", error=repr(e),
                                lane="write")
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise

    def _fail_queued(self, err: BaseException) -> None:
        with self._lock:
            for st in self._tenants.values():
                for q in st.queues.values():
                    while q:
                        req = q.popleft()
                        n = req.fut.n_ops
                        st.queued_ops -= n
                        self._queued_ops -= n
                        if req.fut.op in WRITE_CLASSES:
                            self._queued_write_ops -= n
                        elif req.fut.op == "read":
                            self._queued_read_ops -= n
                        if req.fut.rid is not None:
                            st.pending.pop(req.fut.rid, None)
                        req.fut._fail(err)

    def _check_degraded_transition(self) -> None:
        deg = self.eng.degraded
        if deg and not self._was_degraded:
            # shed queued writes typed; reads keep serving (the
            # degraded read path is the brownout's whole premise)
            reason = self.eng.degraded_reason or "degraded"
            with self._lock:
                for st in self._tenants.values():
                    for cls in WRITE_CLASSES:
                        q = st.queues[cls]
                        while q:
                            req = q.popleft()
                            n = req.fut.n_ops
                            st.queued_ops -= n
                            self._queued_ops -= n
                            self._queued_write_ops -= n
                            st.rejected_degraded += 1
                            self.rejected_degraded += 1
                            if req.fut.rid is not None:
                                st.pending.pop(req.fut.rid, None)
                            req.fut._fail(DegradedError(reason))
            FR.record_event("serve.brownout_enter", degraded=True,
                            reason=reason)
        elif not deg and self._was_degraded:
            FR.record_event("serve.brownout_exit", degraded=True)
        self._was_degraded = deg

    def _shed_expired(self, st: _TenantState, q, now: float) -> None:
        """Deadline shed at the queue head: a request whose budget
        expired while queued fails typed BEFORE dispatch — the
        contract's 'never silently served late' half.  Runs inside the
        admission lock on the dispatch path (registered SL001 scope:
        plain pops and adds, no device work)."""
        while q and q[0].fut.deadline is not None \
                and q[0].fut.deadline < now:
            req = q.popleft()
            n = req.fut.n_ops
            st.queued_ops -= n
            self._queued_ops -= n
            if req.fut.op in WRITE_CLASSES:
                self._queued_write_ops -= n
            elif req.fut.op == "read":
                self._queued_read_ops -= n
            if req.fut.rid is not None:
                st.pending.pop(req.fut.rid, None)
            self._note_deadline_shed(st)
            req.fut._fail(DeadlineExceededError(
                "deadline expired while queued; shed before dispatch"))

    def _take(self, classes, budget_ops: int) -> list[_Request]:
        """Pop up to ``budget_ops`` ops of the given classes —
        round-robin across tenants (max-min fair service), FIFO within
        a tenant, whole requests only (no mid-request splits).
        Expired heads are deadline-shed typed as they surface."""
        out: list[_Request] = []
        now = time.perf_counter()
        with self._lock:
            if not self._rr:
                return out
            took = budget_ops
            idle_rounds = 0
            while took > 0 and idle_rounds < len(self._rr):
                tenant = self._rr[0]
                self._rr.rotate(-1)
                st = self._tenants[tenant]
                got = False
                for cls in classes:
                    q = st.queues[cls]
                    self._shed_expired(st, q, now)
                    if q and q[0].fut.n_ops <= took:
                        req = q.popleft()
                        n = req.fut.n_ops
                        st.queued_ops -= n
                        self._queued_ops -= n
                        if cls in WRITE_CLASSES:
                            self._queued_write_ops -= n
                        elif cls == "read":
                            self._queued_read_ops -= n
                        took -= n
                        out.append(req)
                        got = True
                        break
                idle_rounds = 0 if got else idle_rounds + 1
            if self._brownout and self._queued_ops \
                    < self.cfg.brownout_lo * self.cfg.max_queue_ops:
                self._brownout = False
                FR.record_event("serve.brownout_exit",
                                queued_ops=self._queued_ops)
        return out

    def _read_backlog(self) -> tuple[int, int]:
        """(queued read ops, widest head-of-queue request) — the
        controller's pick inputs; head size matters because requests
        never split across steps."""
        with self._lock:
            head = 0
            for st in self._tenants.values():
                q = st.queues["read"]
                if q and q[0].fut.n_ops > head:
                    head = q[0].fut.n_ops
            return self._queued_read_ops, head

    def _dispatch_reads(self):
        """Form one read step at the controller's width and launch it
        (async).  Returns the in-flight slot or None."""
        backlog, head = self._read_backlog()
        if backlog == 0:
            return None
        width = self.controller.pick(backlog, head)
        if width != self._cur_width:
            FR.record_event("serve.width_change", frm=self._cur_width,
                            to=width)
            self._cur_width = width
        reqs = self._take(("read",), width)
        if not reqs:
            return None
        keys = np.concatenate([r.keys for r in reqs]) \
            if len(reqs) > 1 else reqs[0].keys
        # auditor intent for the whole flight: a pipelined read records
        # its events a full iteration after dispatch — the checker's
        # cut must not close a window over it meanwhile
        tok = self.auditor.begin_ops(
            min(r.fut.t_submit for r in reqs)) \
            if self.auditor is not None else None
        t0 = time.perf_counter()
        try:
            handle = self._steps[width].dispatch(keys)
        except BaseException as e:  # noqa: BLE001 — the batch's futures
            # must carry the failure; the loop keeps serving
            self._fail_batch(reqs, e)
            if tok is not None:
                self.auditor.end_ops(tok)
            return None
        return (width, reqs, handle, t0, tok)

    def _fail_batch(self, reqs, e: BaseException) -> None:
        self.dispatch_errors += 1
        err = e if isinstance(e, ShermanError) \
            else StateError(f"serve dispatch failed: {e!r}")
        FR.record_event("serve.dispatch_error", error=repr(e))
        for r in reqs:
            if r.fut.rid is not None:
                with self._lock:
                    st = self._tenants.get(r.fut.tenant)
                    if st is not None:
                        st.pending.pop(r.fut.rid, None)
            if not r.fut.done():  # a deduped re-ack already resolved
                r.fut._fail(err)
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise e

    def _complete_read(self, slot) -> None:
        width, reqs, handle, t0, tok = slot
        try:
            self._complete_read_inner(width, reqs, handle, t0)
        finally:
            if tok is not None and self.auditor is not None:
                self.auditor.end_ops(tok)

    def _complete_read_inner(self, width, reqs, handle, t0) -> None:
        try:
            vals, found = self._steps[width].complete(handle)
        except BaseException as e:  # noqa: BLE001
            self._fail_batch(reqs, e)
            return
        t1 = time.perf_counter()
        wall = t1 - t0
        n = vals.shape[0]
        # service-side refinement: the MARGINAL completion interval
        # feeds the controller — under the two-deep pipeline a step's
        # dispatch-to-complete wall includes its predecessor's device
        # time, so attributing the raw wall would double-count the
        # pipeline and talk the controller out of perfectly feasible
        # rungs (est = model x 2 x true service).  The marginal
        # interval is exactly what the closed-loop calibration
        # measured (elapsed / K over an overlapped chain).
        svc = t1 - max(t0, self._last_complete_t)
        self._last_complete_t = t1
        self.controller.update(width, svc * 1e3)
        SLO.observe("read", n, wall)
        # variable-size records: one batched handle-resolve gather for
        # every payload-requesting request in this step (stale handles
        # fall back to the heap's revalidate-and-retry read per slice)
        pay = nb = vok = None
        side = cache = None
        if self.value_heap is not None \
                and any(r.resolve_payloads for r in reqs):
            # payload sidecar: positions whose pinned bytes are
            # certified by the LIVE handle (the tree value just read —
            # a rewrite always changes it) skip the resolve gather;
            # with every position pinned the gather is skipped whole
            gather_found = found
            cache = self.eng.leaf_cache
            if cache is not None:
                side, gather_found = self._sidecar_hits(
                    reqs, vals, found, cache)
            try:
                if bool(np.asarray(gather_found).any()):
                    pay, nb, vok = self.value_heap.resolve_u64(
                        vals, gather_found)
            except BaseException as e:  # noqa: BLE001 — every future in
                # the slot must resolve; a hung client is worse than a
                # failed batch
                self._fail_batch(reqs, e)
                return
        off = 0
        oldest = t1
        # auditor feed: u64-register reads only (handle-bearing heap
        # reads are outside the register model — see audit.py)
        aud = self.auditor if self.value_heap is None else None
        for req in reqs:
            m = req.fut.n_ops
            try:
                if req.resolve_payloads:
                    req.fut._set(self._payload_result(
                        req, vals, found, pay, nb, vok, off, m,
                        side=side, cache=cache))
                else:
                    req.fut._set((vals[off:off + m],
                                  found[off:off + m]))
            except BaseException as e:  # noqa: BLE001 — a raising
                # per-request payload resolve (HeapCorruptError on a
                # torn slab) must fail THAT future typed, not leave it
                # (and every later request in the batch) unset forever
                self.dispatch_errors += 1
                FR.record_event("serve.dispatch_error", error=repr(e))
                req.fut._fail(e if isinstance(e, ShermanError)
                              else StateError(
                                  f"payload resolve failed: {e!r}"))
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
            # end-to-end (submit -> ack) latency — the SLO the target
            # governs, attributed per REQUEST (the client's unit of
            # experience) weighted by its ops
            self.tracker.observe("read", m, t1 - req.fut.t_submit)
            if aud is not None:
                aud.observe_read(req.keys, vals[off:off + m],
                                 found[off:off + m],
                                 req.fut.t_submit, t1)
            if req.fut.t_submit < oldest:
                oldest = req.fut.t_submit
            st = self._tenants[req.fut.tenant]
            self._note_served(st, m)
            off += m
        # queue-vs-service attribution: formation wait of the batch's
        # OLDEST request vs the service wall — when waiting dominates,
        # the tail belongs to the offered load, not the width
        qwait = max(0.0, t0 - oldest)
        ratio = qwait / wall if wall > 0 else 0.0
        self._qwait_ratio = 0.7 * self._qwait_ratio + 0.3 * ratio
        self._completions += 1
        if self._completions % 16 == 0:
            # measured-truth override: the window p99 disposes what the
            # wall model proposed (queue-dominated breaches excluded —
            # see WidthController.note_window_p99)
            w = self.tracker.window().get("read")
            if w and w["window_ops"]:
                self.controller.note_window_p99(
                    w["p99_ms"],
                    queue_dominated=self._qwait_ratio > 1.0)

    def _sidecar_hits(self, reqs, vals, found, cache):
        """Probe the leaf cache's payload sidecar for every found
        payload position in the slot.  -> (side, gather_found):
        ``side[p]`` holds certified pinned bytes (the pin's handle
        equals the live tree value at ``p``), and those positions are
        masked OUT of the resolve gather — all-hit slots skip the
        fused gather entirely."""
        side = [None] * int(np.asarray(vals).shape[0])
        pk, ph, pp = [], [], []
        off = 0
        for r in reqs:
            m = r.fut.n_ops
            if r.resolve_payloads:
                for j in range(m):
                    if found[off + j]:
                        pk.append(r.keys[j])
                        ph.append(vals[off + j])
                        pp.append(off + j)
            off += m
        if not pk:
            return side, found
        blobs = cache.payload_hits(pk, ph)
        gf = None
        for b, p in zip(blobs, pp):
            if b is not None:
                side[p] = b
                if gf is None:
                    gf = np.array(found)
                gf[p] = False
        return side, (found if gf is None else gf)

    def _payload_result(self, req, vals, found, pay, nb, vok,
                        off: int, m: int, side=None, cache=None):
        """Assemble one payload-read request's result slice from the
        sidecar pins + the batch's resolve gather; stale handles
        revalidate through the heap's bounded-retry read.  Fresh
        gather results are pinned (key + live handle) so the next
        read of the key serves bytes without a gather."""
        vh = self.value_heap
        sl_found = np.array(found[off:off + m])
        out: list = [None] * m
        stale = []
        fresh_k, fresh_h, fresh_b = [], [], []
        for j in range(m):
            if not sl_found[j]:
                continue
            if side is not None and side[off + j] is not None:
                out[j] = side[off + j]
            elif vok is not None and vok[off + j]:
                b = vh._words_to_bytes(pay[off + j], int(nb[off + j]))
                out[j] = b
                if cache is not None:
                    fresh_k.append(req.keys[j])
                    fresh_h.append(vals[off + j])
                    fresh_b.append(b)
            else:
                stale.append(j)
        if stale:
            p2, f2 = vh.get(req.keys[np.asarray(stale)])
            for k, j in enumerate(stale):
                out[j] = p2[k]
                sl_found[j] = bool(f2[k])
        if fresh_k:
            cache.pin_payloads(fresh_k, fresh_h, fresh_b)
        return out, sl_found

    def _write_due(self) -> bool:
        with self._lock:
            if self._queued_write_ops >= self.cfg.write_width:
                return True
            if self._queued_write_ops == 0:
                return False
            if not self._running:  # draining
                return True
            oldest = None
            for st in self._tenants.values():
                for cls in WRITE_CLASSES:
                    q = st.queues[cls]
                    if q:
                        t = q[0].fut.t_submit
                        oldest = t if oldest is None else min(oldest, t)
            return oldest is not None and \
                (time.perf_counter() - oldest) * 1e3 \
                >= self.cfg.write_linger_ms

    def _split_deduped(self, reqs):
        """Dispatch-side exactly-once guard: re-ack any popped request
        whose rid already sits in the window (a retry admitted before
        :meth:`seed_dedup` ran, or a racing duplicate) and return the
        remainder.  Applying such a request would be a duplicate apply
        — the exact bug the contract plane exists to kill — so it is
        counted ``duplicate_applies``-adjacent only if BOTH guards
        miss (which this one makes structurally impossible)."""
        if self.cfg.dedup_window <= 0:
            return reqs
        out = []
        hits = []
        for r in reqs:
            rid = r.fut.rid
            if rid is not None:
                with self._lock:
                    st = self._tenant(r.fut.tenant)
                    cached = st.dedup.get(rid)
                    if cached is not None:
                        self._note_dedup_hit(st)
                        st.pending.pop(rid, None)
                        hits.append((r, cached))
                        continue
            out.append(r)
        if hits:
            # a re-ack honors the same quorum promise as the original
            # ack: the retry path across a QuorumTimeoutError lands
            # HERE, and resolving before coverage would let a K-copy
            # ack outrun its K copies (no-op with ack_quorum=1)
            try:
                self._quorum_gate()
            except QuorumTimeoutError as e:
                for r, _ in hits:
                    r.fut._fail(e)
            else:
                for r, cached in hits:
                    r.fut.deduped = True
                    r.fut._set(np.array(cached[1]))
        return out

    def _ack_batch(self, reqs, results, opcode: int,
                   provenance=None) -> None:
        """Journal + cache a write batch's exactly-once results —
        post-apply, PRE-ack: called before any of the batch's futures
        resolve, under the same durability gate as the engine record
        (one ``J_ACK`` frame covers every rid the flush coalesced; a
        raising append fails the whole batch, so no ack can outrun its
        record).  ``provenance`` (heap writes): per-request u64
        handle arrays aligned with ``results`` — journaled into the
        ack entries so a recovered window attests where each acked
        payload lives (slab address + version), not just its bits."""
        if self.cfg.dedup_window <= 0:
            return
        if provenance is None:
            acks = [(r.fut.rid, r.fut.tenant, opcode, res)
                    for r, res in zip(reqs, results)
                    if r.fut.rid is not None]
        else:
            acks = [(r.fut.rid, r.fut.tenant, opcode, res, prov)
                    for r, res, prov in zip(reqs, results, provenance)
                    if r.fut.rid is not None]
        if not acks:
            return
        jrn = self.journal if self.journal is not None \
            else getattr(self.eng, "journal", None)
        if jrn is not None:
            try:
                jrn.append_acks(acks)
            except StateError:
                # a checkpoint rotation swapped the engine's journal
                # between this flush's engine record and its ack
                # record: re-read once and land the acks in the fresh
                # segment (same durability gate)
                jrn2 = self.journal if self.journal is not None \
                    else getattr(self.eng, "journal", None)
                if jrn2 is None or jrn2 is jrn:
                    raise
                jrn2.append_acks(acks)
        with self._lock:
            for i, (r, res) in enumerate(zip(reqs, results)):
                rid = r.fut.rid
                if rid is None:
                    continue
                st = self._tenant(r.fut.tenant)
                st.dedup[rid] = (opcode, np.array(res)) \
                    if provenance is None \
                    else (opcode, np.array(res),
                          np.array(provenance[i]))
                st.dedup.move_to_end(rid)
                while len(st.dedup) > self.cfg.dedup_window:
                    st.dedup.popitem(last=False)
                st.pending.pop(rid, None)

    def _audit_writes(self, op: int, reqs, results, t1: float,
                      with_values: bool) -> None:
        """Feed the attached auditor one completed write batch (sampled
        per-key events; u64-value writes only — payload writes are
        outside the auditor's register model)."""
        aud = self.auditor
        if aud is None:
            return
        for r, res in zip(reqs, results):
            aud.observe_write(op, r.keys, r.fut.t_submit, t1,
                              values=r.values if with_values else None,
                              ok=res if with_values else None)

    def _maybe_flush_writes(self) -> bool:
        if not self._write_due():
            return False
        reqs = self._split_deduped(
            self._take(WRITE_CLASSES, self.cfg.write_width))
        if not reqs:
            return False
        # auditor intent: the flush is about to APPLY writes whose
        # events only land in the ring after the ack (journal fsync in
        # between) — the intent pins the checker's drain cut so reads
        # observing these writes are never judged without them
        tok = self.auditor.begin_ops(
            min(r.fut.t_submit for r in reqs)) \
            if self.auditor is not None else None
        try:
            return self._flush_writes(reqs)
        finally:
            if tok is not None:
                self.auditor.end_ops(tok)

    def _flush_writes(self, reqs) -> bool:
        hins = [r for r in reqs
                if r.fut.op == "insert" and r.payloads is not None]
        ins = [r for r in reqs
               if r.fut.op == "insert" and r.payloads is None]
        dels = [r for r in reqs if r.fut.op == "delete"]
        if hins:
            # variable-size records: heap slab writes + handle installs
            # (journaled pre-ack inside put(), same gate as insert)
            keys = np.concatenate([r.keys for r in hins]) \
                if len(hins) > 1 else hins[0].keys
            payloads = [b for r in hins for b in r.payloads]
            try:
                hst = self.value_heap.put(keys, payloads)
                t1 = time.perf_counter()
                hto = np.asarray(hst["lock_timeout_keys"], np.uint64) \
                    if hst["lock_timeouts"] else None
                results = [np.ones(r.fut.n_ops, bool) if hto is None
                           else ~np.isin(r.keys, hto) for r in hins]
                # payload provenance: the handle each acked
                # payload landed at rides the J_ACK entry (0 for keys
                # that timed out or were superseded within the batch)
                hmap = hst.get("handle_map") or {}
                provenance = [np.asarray(
                    [hmap.get(int(k), 0) for k in r.keys], np.uint64)
                    for r in hins]
                self._ack_batch(hins, results, J.J_HEAP_PUT,
                                provenance=provenance)
                self._quorum_gate()
                for r, ok in zip(hins, results):
                    r.fut._set(ok)
                    self.tracker.observe("insert", r.fut.n_ops,
                                         t1 - r.fut.t_submit)
                    self._note_served(self._tenants[r.fut.tenant],
                                      r.fut.n_ops)
                    self.acked_writes += 1
            except BaseException as e:  # noqa: BLE001
                self._fail_batch(hins, e)
        if ins:
            keys = np.concatenate([r.keys for r in ins]) \
                if len(ins) > 1 else ins[0].keys
            values = np.concatenate([r.values for r in ins]) \
                if len(ins) > 1 else ins[0].values
            try:
                # the ack gate: insert() returns only after the journal
                # record covering these rows is DURABLE (fsync'd /
                # group-committed) — resolving the futures after this
                # call is what "journaled by construction" means
                stats = self.eng.insert(keys, values)
                t1 = time.perf_counter()
                to = np.asarray(stats["lock_timeout_keys"], np.uint64) \
                    if stats["lock_timeouts"] else None
                results = [np.ones(r.fut.n_ops, bool) if to is None
                           else ~np.isin(r.keys, to) for r in ins]
                self._ack_batch(ins, results, J.J_UPSERT)
                # quorum acks: the futures below resolve only
                # after K-1 followers cover this flush's frontier
                self._quorum_gate()
                for r, ok in zip(ins, results):
                    r.fut._set(ok)
                    self.tracker.observe("insert", r.fut.n_ops,
                                         t1 - r.fut.t_submit)
                    self._note_served(self._tenants[r.fut.tenant],
                                      r.fut.n_ops)
                    self.acked_writes += 1
                self._audit_writes(1, ins, results, t1, True)
            except BaseException as e:  # noqa: BLE001 — a popped
                # request's future must resolve even on non-Sherman
                # failures (CUDA runtime errors, OOM): _fail_batch
                # wraps, records, and re-raises KeyboardInterrupt
                self._fail_batch(ins, e)
        if dels:
            keys = np.concatenate([r.keys for r in dels]) \
                if len(dels) > 1 else dels[0].keys
            try:
                # a heap-backed tree frees slabs with the delete (the
                # reclaim path), else the plain engine delete
                found = self.value_heap.remove(keys) \
                    if self.value_heap is not None \
                    else self.eng.delete(keys)
                t1 = time.perf_counter()
                results = [np.asarray(found[off:off + r.fut.n_ops])
                           for off, r in zip(
                               np.cumsum([0] + [r.fut.n_ops
                                                for r in dels])[:-1],
                               dels)]
                self._ack_batch(dels, results, J.J_DELETE)
                self._quorum_gate()
                for r, fnd in zip(dels, results):
                    r.fut._set(fnd)
                    self.tracker.observe("delete", r.fut.n_ops,
                                         t1 - r.fut.t_submit)
                    self._note_served(self._tenants[r.fut.tenant],
                                      r.fut.n_ops)
                    self.acked_writes += 1
                self._audit_writes(2, dels, results, t1, False)
            except BaseException as e:  # noqa: BLE001
                self._fail_batch(dels, e)
        return True

    def _maybe_flush_scans(self) -> bool:
        reqs = self._take(("scan",), self.cfg.widths[-1])
        for r in reqs:
            try:
                res = self.value_heap.scan(r.ranges) \
                    if (r.resolve_payloads
                        and self.value_heap is not None) \
                    else self.eng.range_query_many(r.ranges)
                r.fut._set(res)
                self.tracker.observe(
                    "scan", r.fut.n_ops,
                    time.perf_counter() - r.fut.t_submit)
                self._note_served(self._tenants[r.fut.tenant],
                                  r.fut.n_ops)
            except BaseException as e:  # noqa: BLE001
                self._fail_batch([r], e)
        return bool(reqs)

    # -- telemetry -----------------------------------------------------------

    def _collect(self) -> dict:
        """The ``serve.`` pull collector (flat numbers, the ``slo.``
        shape): per-class end-to-end window stats + admission state."""
        flat = dict(self.tracker.collect())
        flat.update({
            "width": float(self._cur_width),
            "queued_ops": float(self._queued_ops),
            "admitted_ops": float(self.admitted_ops),
            "served_ops": float(self.served_ops),
            "acked_writes": float(self.acked_writes),
            "rejected_overload": float(self.rejected_overload),
            "rejected_degraded": float(self.rejected_degraded),
            "brownout": 1.0 if self._brownout else 0.0,
            "retraces": float(self.retraces),
            "prep_impl_device": 1.0 if any(
                getattr(s, "prep_impl", "host") == "device"
                for s in self._steps.values()) else 0.0,
            "write_combine": 1.0 if getattr(
                self.eng, "_write_combine", False) else 0.0,
            "dedup_hits": float(self.dedup_hits),
            "deadline_shed": float(self.deadline_shed),
            "duplicate_applies": float(self.duplicate_applies),
            "ack_quorum": float(self.cfg.ack_quorum),
            "quorum_acks": float(self.quorum_acks),
            "quorum_timeouts": float(self.quorum_timeouts),
            "quorum_wait_ms": round(float(self.quorum_wait_ms), 3),
        })
        return flat

    def stats(self) -> dict:
        """Receipt-grade nested stats (serve_bench's ``serve`` block):
        controller state, per-tenant shares, rejects, journal
        coalescing, cache sketch."""
        with self._lock:
            tenants = {
                name: {
                    "admitted_ops": st.admitted_ops,
                    "served_ops": st.served_ops,
                    "queued_ops": st.queued_ops,
                    "rejected_overload": st.rejected_overload,
                    "rejected_degraded": st.rejected_degraded,
                    "weight": st.weight,
                    "dedup_hits": st.dedup_hits,
                    "deadline_shed": st.deadline_shed,
                }
                for name, st in self._tenants.items()
            }
            contract = {
                "dedup_window": self.cfg.dedup_window,
                "dedup_hits": self.dedup_hits,
                "deadline_shed": self.deadline_shed,
                "duplicate_applies": self.duplicate_applies,
                "cached_rids": sum(len(st.dedup)
                                   for st in self._tenants.values()),
                "pending_rids": sum(len(st.pending)
                                    for st in self._tenants.values()),
            }
        total_served = max(1, self.served_ops)
        for t in tenants.values():
            t["share"] = round(t["served_ops"] / total_served, 4)
        out = {
            "fusion": self.cfg.fusion,
            "widths": list(self.cfg.widths),
            "p99_targets_ms": dict(self.cfg.p99_targets_ms),
            "max_queue_ops": self.cfg.max_queue_ops,
            "controller": self.controller.snapshot(),
            "calibration": {str(w): {k: round(v, 3)
                                     for k, v in c.items()}
                            for w, c in self.calibration.items()},
            "window": self.tracker.window(),
            "tenants": tenants,
            "admitted_ops": self.admitted_ops,
            "served_ops": self.served_ops,
            "acked_writes": self.acked_writes,
            "rejects": {"overload": self.rejected_overload,
                        "degraded": self.rejected_degraded},
            "dispatch_errors": self.dispatch_errors,
            "sealed": self._sealed,
            "retraces": self.retraces,
            "contract": contract,
            "quorum": {
                "ack_quorum": int(self.cfg.ack_quorum),
                "acks": self.quorum_acks,
                "timeouts": self.quorum_timeouts,
                "wait_ms": round(self.quorum_wait_ms, 3),
            },
            "request_plane": {
                "prep_impl": {str(w): getattr(s, "prep_impl", "host")
                              for w, s in self._steps.items()},
                "write_combine": bool(getattr(self.eng, "_write_combine",
                                              False)),
            },
        }
        if self.auditor is not None:
            out["audit"] = self.auditor.stats()
        if self.journal is not None:
            js = self.journal.stats()
            js["acks_per_fsync"] = (self.acked_writes / js["fsyncs"]
                                    if js["fsyncs"] else None)
            out["journal"] = js
        out["write_lane"] = self.cfg.write_lane
        if self.host_id is not None:
            # host attribution only under a multihost plane — hosts=1
            # receipts stay byte-identical to pre-plane builds
            out["host_id"] = int(self.host_id)
        if self.leaf_cache is not None:
            out["cache"] = {**self.leaf_cache.stats(),
                            "sketch": self.leaf_cache.sketch_stats()}
        if self.value_heap is not None:
            out["value_heap"] = self.value_heap.stats()
        return out


# ---------------------------------------------------------------------------
# Client-side retry policy + hedging
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RetryPolicy:
    """Client retry discipline against the front door's TYPED
    backpressure (:class:`ServeOverloadError` — the only retryable
    class by default; degraded/deadline rejects are policy decisions,
    not transient congestion).

    - capped exponential backoff with full jitter:
      ``sleep ~ U(0, min(cap, base * 2^attempt))`` — the classic
      thundering-herd antidote;
    - **writes retry ONLY with a request id**: a blind write retry can
      double-apply (the lost-update bug the dedup window kills), so a
      rid-less write gets exactly one attempt;
    - **read hedging**: after the tracker's observed p99 (times
      ``hedge_mult``) with no answer, a duplicate read is submitted
      and the first ack wins — tail-latency insurance that is safe
      precisely because reads are idempotent.  Never applied to
      writes.
    """

    max_attempts: int = 5
    base_backoff_ms: float = 2.0
    backoff_cap_ms: float = 200.0
    hedge_reads: bool = True
    hedge_mult: float = 3.0
    #: hedge trigger floor when the tracker has no p99 yet
    hedge_floor_ms: float = 25.0

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        cap = min(self.backoff_cap_ms,
                  self.base_backoff_ms * (2.0 ** attempt))
        return rng.uniform(0.0, cap) / 1e3


class RetryingClient:
    """One tenant's well-behaved client over a :class:`ShermanServer`:
    assigns request ids to writes, applies :class:`RetryPolicy`, and
    carries its own deadline default.  The contract drill's client
    threads (and any embedding application) use this instead of raw
    ``submit`` so retries are exactly-once by construction."""

    def __init__(self, srv: ShermanServer, tenant: str = "default",
                 policy: RetryPolicy | None = None, seed: int = 0,
                 deadline_ms: float | None = None):
        self.srv = srv
        self.tenant = tenant
        self.policy = policy or RetryPolicy()
        self.deadline_ms = deadline_ms
        self._rng = random.Random(seed)
        # client-assigned request ids: unique per (client seed, op) —
        # the exactly-once join key across retries AND across crashes
        self._rid = (seed & 0xFFFF) << 48
        self.retries = 0
        self.hedges = 0
        self.rejects = 0

    def next_rid(self) -> int:
        self._rid += 1
        return self._rid

    # -- reads ----------------------------------------------------------------

    def _hedge_after_s(self) -> float:
        w = self.srv.tracker.window().get("read") or {}
        p99 = w.get("p99_ms") or 0.0
        return max(self.policy.hedge_floor_ms,
                   self.policy.hedge_mult * p99) / 1e3

    def read(self, keys, deadline_ms=None):
        """Submit-with-retry + hedging; returns ``(values, found)``.
        Raises the last typed error when every attempt was rejected."""
        pol = self.policy
        deadline_ms = deadline_ms if deadline_ms is not None \
            else self.deadline_ms
        last: BaseException | None = None
        for attempt in range(pol.max_attempts):
            try:
                fut = self.srv.submit("read", keys, tenant=self.tenant,
                                      deadline_ms=deadline_ms)
            except (ServeOverloadError, DegradedError) as e:
                self.rejects += 1
                last = e
                self.retries += 1
                time.sleep(pol.backoff_s(attempt, self._rng))
                continue
            if not pol.hedge_reads:
                return fut.result(timeout=60)
            try:
                return fut.result(timeout=self._hedge_after_s())
            except StateError:
                pass  # primary still in flight past p99: hedge it
            except DeadlineExceededError as e:
                last = e
                self.retries += 1
                continue  # shed while queued: re-submit is safe
            hedge = None
            try:
                hedge = self.srv.submit("read", keys,
                                        tenant=self.tenant,
                                        deadline_ms=deadline_ms)
                self.hedges += 1
            except (ServeOverloadError, DegradedError):
                pass  # overloaded: the primary remains the only horse
            # first ack wins (both are the same idempotent read)
            while True:
                for f in (fut, hedge):
                    if f is not None and f.done():
                        try:
                            return f.result()
                        except DeadlineExceededError as e:
                            # shed copy: fall through to the other
                            if f is fut:
                                fut = None
                            else:
                                hedge = None
                            last = e
                            break
                if fut is None and hedge is None:
                    break
                time.sleep(0.0005)
            self.retries += 1
        raise last if last is not None else StateError(
            "read retries exhausted")

    # -- writes (exactly-once: rid-gated retry) -------------------------------

    def _write(self, op: str, keys, values=None, rid=None,
               deadline_ms=None):
        pol = self.policy
        deadline_ms = deadline_ms if deadline_ms is not None \
            else self.deadline_ms
        if rid is None:
            # no request id = no retry budget: a blind write retry can
            # double-apply, which the client refuses to risk
            fut = self.srv.submit(op, keys, values, tenant=self.tenant,
                                  deadline_ms=deadline_ms)
            return fut.result(timeout=60)
        last: BaseException | None = None
        for attempt in range(pol.max_attempts):
            try:
                fut = self.srv.submit(op, keys, values,
                                      tenant=self.tenant, rid=rid,
                                      deadline_ms=deadline_ms)
                return fut.result(timeout=60)
            except (ServeOverloadError, DeadlineExceededError) as e:
                # both mean "never applied": the rid makes the
                # re-submit exactly-once even if that ever changed
                last = e
                self.retries += 1
                time.sleep(pol.backoff_s(attempt, self._rng))
        raise last if last is not None else StateError(
            f"{op} retries exhausted")

    def insert(self, keys, values, rid=None, deadline_ms=None):
        """Exactly-once insert: ``rid`` defaults to a fresh
        client-assigned id (pass an explicit one to RETRY a prior
        attempt across a timeout or a crash)."""
        return self._write("insert", keys, values,
                           rid=self.next_rid() if rid is None else rid,
                           deadline_ms=deadline_ms)

    def delete(self, keys, rid=None, deadline_ms=None):
        return self._write("delete", keys,
                           rid=self.next_rid() if rid is None else rid,
                           deadline_ms=deadline_ms)

    def stats(self) -> dict:
        return {"retries": self.retries, "hedges": self.hedges,
                "rejects": self.rejects}
