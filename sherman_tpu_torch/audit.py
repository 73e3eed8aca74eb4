"""Client-contract auditor — bounded history recorder + per-key
linearizability checker for the serving front door (a copy of
``sherman_tpu/audit.py``: host-only, no device work).

Every robustness receipt so far pinned STATE ("no acked write lost",
"pool bit-identical"); none pinned ORDER.  This module closes that gap
with a Jepsen-lineage history checker (PAPERS.md: Knossos, Porcupine):
the front door's completion path records *invocation/response* events
per key, and a checker decides whether the acked history is
**linearizable per key** over the repo's single-key read/insert/delete
model (no CAS) — the strongest client-visible correctness claim the
serving plane can publish, and the one that catches the bugs state
audits cannot see (a duplicate apply that resurrects a superseded
value, a stale read served after a newer write's ack).

The model (what "linearizable per key" does and does NOT claim):

- **P-composition**: linearizability is checked per key and composes
  (Herlihy/Wing locality) — a history is linearizable iff every
  per-key sub-history is.  Cross-key ordering is NOT judged (the front
  door promises none; see the serve module docstring).
- **Ops**: ``insert`` (an upsert: the register's write), ``delete``
  (writes "absent"), ``read`` (returns ``(found, value)``).  Acked-ok
  ops only: a typed-rejected op did not happen by contract and is
  never recorded.
- **Windows**: invocation = the request's submit time, response = its
  ack time — the widest (most conservative) window, so a legal
  linearization point always lies inside it.
- **Soundness polarity**: the checker NEVER false-alarms on a
  linearizable history (every flagged read provably observed a value
  no legal linearization could produce), but it can ACCEPT
  non-linearizable histories when distinct writes wrote equal values
  (reads-from ambiguity) or when sampling/ring bounds dropped events.
  An auditor that cries wolf gets turned off; one that stays quiet
  until it is RIGHT gets trusted.

The per-key check, for each read R (interval ``[inv, resp]``):

- a write W is a *legal source* iff ``W.inv < R.resp`` (W may
  linearize before R) and W is not *superseded* — no write W' lies
  entirely between them (``W.resp < W'.inv`` and ``W'.resp < R.inv``);
- the *initial state* is legal iff no write responded entirely before
  R began; an UNKNOWN initial (recorder attached mid-stream) makes
  such reads pass vacuously rather than guess;
- R must match some legal source's outcome (insert v -> ``(True,
  v)``; delete -> ``(False, ·)``), else it is flagged — ``stale_read``
  when it matches a superseded source (the duplicate-apply signature),
  ``phantom_read`` when it matches nothing ever written.

Deployment shapes:

- **inline** (:class:`Auditor`): a sampling recorder hooked into the
  serve completion path (keys sampled by hash, so ALL ops on a sampled
  key are seen — per-op sampling would fabricate missing-write
  violations) plus a background checker thread; violations count under
  ``audit.violations``, flight-record (``audit.violation``) and
  auto-dump the black box.  Inline cost is self-timed
  (:meth:`Auditor.cost_frac`) and pinned < 2% of the serve wall in CI
  (the obs-cost-pin pattern).
- **offline** (:func:`check_events` / :func:`check_jsonl`): a drill
  records its full client-side history and re-checks it after crash,
  recovery and a live migration (``contract_drill.py``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

import numpy as np

from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.ops import bits

__all__ = ["OP_READ", "OP_INSERT", "OP_DELETE", "HistoryRecorder",
           "Auditor", "check_events", "check_key_history", "check_jsonl",
           "dump_jsonl"]

OP_READ = 0
OP_INSERT = 1
OP_DELETE = 2
_OP_NAMES = {OP_READ: "read", OP_INSERT: "insert", OP_DELETE: "delete"}

_OBS_EVENTS = obs.counter("audit.events")
_OBS_READS = obs.counter("audit.reads_checked")
_OBS_HIST = obs.counter("audit.histories_checked")
_OBS_VIOL = obs.counter("audit.violations")
_OBS_WINDOWS = obs.counter("audit.windows")
_OBS_RESETS = obs.counter("audit.carry_resets")


# ---------------------------------------------------------------------------
# The checker (pure functions over event tuples)
# ---------------------------------------------------------------------------
# An event is (key, op, t_inv, t_resp, value, found):
#   read:   value/found = the observed result (value meaningful iff found)
#   insert: value = the written value (found unused)
#   delete: value unused

def check_key_history(events, initial=None, open_writes=()):
    """Check one key's events (see the module docstring's rule).

    ``initial``: ``(found0, value0)`` when the pre-history state is
    known (e.g. the bulk-loaded value), else None = UNKNOWN — reads
    with the initial state legal then pass vacuously.  ``open_writes``:
    outcomes ``(found, value)`` of writes known in flight beyond this
    window (the incremental checker's retained tail) — always legal,
    never superseding.  Returns a list of violation dicts.
    """
    writes = sorted((e for e in events if e[1] != OP_READ),
                    key=lambda e: e[2])
    reads = [e for e in events if e[1] == OP_READ]
    out = []
    open_set = set(open_writes)
    for r in reads:
        _, _, r_inv, r_resp, r_val, r_found = r
        observed = (bool(r_found), int(r_val) if r_found else None)
        if observed in open_set:
            continue
        # T = latest invocation among writes ENTIRELY before this read:
        # any write responding before T is superseded for this read
        t_super = None
        for w in writes:
            if w[3] < r_inv and (t_super is None or w[2] > t_super):
                t_super = w[2]
        legal = set()
        stale = set()
        none_before = True
        for w in writes:
            if w[3] < r_inv:
                none_before = False
            if w[2] >= r_resp:
                continue  # cannot linearize before the read
            outcome = (True, int(w[4])) if w[1] == OP_INSERT \
                else (False, None)
            if t_super is not None and w[3] < t_super:
                stale.add(outcome)  # superseded: illegal, but a match
                continue            # here names the failure class
            legal.add(outcome)
        if none_before:
            if initial is None:
                continue  # unknown initial state still legal: vacuous
            legal.add((bool(initial[0]),
                       int(initial[1]) if initial[0] else None))
        if observed in legal:
            continue
        out.append({
            "key": int(r[0]),
            "kind": "stale_read" if observed in stale else "phantom_read",
            "observed": {"found": observed[0], "value": observed[1]},
            "legal": sorted(
                {"absent" if not f else v for f, v in legal},
                key=str),
            "read": {"t_inv": r_inv, "t_resp": r_resp},
        })
    return out


def check_events(events, initial=None, open_writes=None):
    """Group events by key, check each sub-history (P-composition).

    ``initial``: {key: (found0, value0)} or None.  ``open_writes``:
    {key: [(found, value), ...]} of in-flight write outcomes per key.
    -> {"keys", "events", "reads", "violations": [...],
    "linearizable": bool}.
    """
    by_key: dict = {}
    for e in events:
        by_key.setdefault(int(e[0]), []).append(e)
    violations = []
    reads = 0
    for k, evs in by_key.items():
        reads += sum(1 for e in evs if e[1] == OP_READ)
        violations.extend(check_key_history(
            evs,
            initial=(initial or {}).get(k),
            open_writes=(open_writes or {}).get(k, ())))
    return {"keys": len(by_key), "events": len(events), "reads": reads,
            "violations": violations,
            "linearizable": not violations}


def dump_jsonl(events, path: str) -> int:
    """Persist events as grep-able JSONL (one object per line) — the
    drill's offline-recheck artifact."""
    n = 0
    with open(path, "w") as f:
        for k, op, t_inv, t_resp, val, found in events:
            f.write(json.dumps({
                "key": int(k), "op": _OP_NAMES[op],
                "t_inv": t_inv, "t_resp": t_resp,
                "value": int(val) if val is not None else None,
                "found": bool(found)}) + "\n")
            n += 1
    return n


def check_jsonl(path: str, initial=None) -> dict:
    """Offline check over a :func:`dump_jsonl` artifact (drill
    receipts re-audited after the fact)."""
    names = {v: k for k, v in _OP_NAMES.items()}
    events = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            events.append((d["key"], names[d["op"]], d["t_inv"],
                           d["t_resp"], d["value"], d["found"]))
    return check_events(events, initial=initial)


def check_fenced_rejected(read_fn, fenced) -> dict:
    """Prove fenced acks never merged (the split-brain pin).

    ``fenced``: iterable of ``(key, value)`` pairs a STALE primary
    acked after its lease epoch was bumped — writes that landed past
    the promotion fence point and must never become visible.
    ``read_fn``: ``keys ndarray -> (values, found)`` against the
    promoted primary's live state.  A fenced pair counts as MERGED
    only when the key is found AND carries the fenced value — a
    found key with a different value is the re-driven client's own
    legitimate write through the new primary's dedup window, which
    is exactly the contract (typed rejection then re-drive), not a
    merge.  -> ``{"fenced", "merged", "violations": [...]}`` with
    ``merged`` the drill's ``fenced_acks_merged`` receipt field.
    """
    pairs = [(int(k), int(v)) for k, v in fenced]
    if not pairs:
        return {"fenced": 0, "merged": 0, "violations": []}
    keys = np.asarray([k for k, _ in pairs], np.uint64)
    vals, found = read_fn(keys)
    vals = np.asarray(vals)
    found = np.asarray(found, bool)
    violations = []
    for i, (k, v) in enumerate(pairs):
        if bool(found[i]) and int(vals[i]) == v:
            violations.append({"key": k, "fenced_value": v,
                               "kind": "fenced_ack_merged"})
    return {"fenced": len(pairs), "merged": len(violations),
            "violations": violations}


# ---------------------------------------------------------------------------
# Bounded recorder
# ---------------------------------------------------------------------------

class HistoryRecorder:
    """Bounded, thread-safe ring of per-key invocation/response events.

    ``sample_mod``: record only keys with ``mix64(key) % sample_mod ==
    0`` — sampling is BY KEY (every op on a sampled key is seen), the
    only shape under which a missing event cannot fabricate a
    violation.  1 = record everything (the drill's client-side
    ledger).  Ring overflow drops oldest and counts ``dropped`` — the
    incremental checker resets its carried state when it sees drops
    (bounded memory over false alarms).
    """

    def __init__(self, capacity: int = 1 << 16, sample_mod: int = 1):
        if capacity <= 0 or sample_mod <= 0:
            raise ConfigError(
                "HistoryRecorder wants positive capacity/sample_mod")
        self.capacity = int(capacity)  # bound in EVENTS, not batches
        self.sample_mod = int(sample_mod)
        self._lock = threading.Lock()
        self._ring: deque = deque()  # batch entries; _size sums events
        self._size = 0
        self.events = 0
        self.dropped = 0

    def sample_mask(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized per-key sampling decision (hash, not modulo of
        the raw key: sequential keyspaces must not alias the stride)."""
        if self.sample_mod == 1:
            return np.ones(keys.shape, bool)
        return bits.mix64_np(np.ascontiguousarray(keys, np.uint64)) \
            % np.uint64(self.sample_mod) == 0

    def observe(self, op: int, keys, t_inv: float, t_resp: float,
                values=None, found=None, ok=None) -> int:
        """Record one completed batch's per-key events (sampled).

        ``values``: written/read values (insert/read); ``found``: read
        results; ``ok``: write apply mask (False rows did not happen —
        typed-rejected, never recorded).  Returns events recorded.

        HOT PATH (the < 2% pin's numerator): the batch is stored as
        ONE ring entry of numpy arrays — a vectorized mask + slice and
        an append, no per-key Python loop; expansion to per-key event
        tuples happens at :meth:`drain`, on the checker's clock.
        """
        keys = np.ascontiguousarray(keys, np.uint64)
        if self.sample_mod == 1 and ok is None:
            # full-recording fast path: reference the caller's batch
            # arrays as-is (serve hands completed, no-longer-mutated
            # slices) — no mask, no index, no copy
            n = int(keys.size)
            if n == 0:
                return 0
            ks = keys
            vs = np.ascontiguousarray(values, np.uint64) \
                if values is not None else None
            fs = np.ascontiguousarray(found, bool) \
                if found is not None else None
        else:
            mask = self.sample_mask(keys)
            if ok is not None:
                mask = mask & np.ascontiguousarray(ok, bool)
            idx = np.nonzero(mask)[0]
            n = int(idx.size)
            if n == 0:
                return 0
            ks = keys[idx]
            vs = np.ascontiguousarray(values, np.uint64)[idx] \
                if values is not None else None
            fs = np.ascontiguousarray(found, bool)[idx] \
                if found is not None else None
        if n > self.capacity:
            self.dropped += n - self.capacity
            ks = ks[-self.capacity:]
            vs = vs[-self.capacity:] if vs is not None else None
            fs = fs[-self.capacity:] if fs is not None else None
        with self._lock:
            self._size += min(n, self.capacity)
            self._ring.append((op, ks, t_inv, t_resp, vs, fs))
            while self._size > self.capacity and len(self._ring) > 1:
                old = self._ring.popleft()
                self._size -= int(old[1].size)
                self.dropped += int(old[1].size)
            self.events += n
        _OBS_EVENTS.inc(n)
        return n

    @staticmethod
    def _expand(batch) -> list:
        """One ring batch -> per-key event tuples (checker-side)."""
        op, ks, t_inv, t_resp, vs, fs = batch
        kl = ks.tolist()
        vl = vs.tolist() if vs is not None else None
        fl = fs.tolist() if fs is not None else None
        return [(kl[i], op, t_inv, t_resp,
                 vl[i] if vl is not None else None,
                 fl[i] if fl is not None else True)
                for i in range(len(kl))]

    def drain(self, before: float | None = None,
              floor: float | None = None):
        """Pop a SETTLED window of events (all, when ``before`` is
        None) -> (drained, retained_writes, dropped_since_last).

        The cut is ``min(before, floor, oldest retained invocation)``:
        an event whose window reaches back past the candidate cut pins
        the cut at its invocation, so no retained event ever overlaps
        a drained one — the incremental checker then never judges a
        read in one window against a carry that overwrote a write the
        read was actually concurrent with (the window-split false
        positive; the checker's no-false-alarms polarity).  ``floor``
        is the oldest still-UNRECORDED operation's start (the serve
        layer's write-flush intents): an op the ring cannot see yet
        must also never be split from the reads that observed it.
        Retained writes are still handed back as the ``open_writes``
        belt for the checker."""
        with self._lock:
            if before is None:
                db = list(self._ring)
                self._ring.clear()
                self._size = 0
                kb = []
            else:
                # fixpoint cut: the largest c <= min(before, floor)
                # such that NO batch spans it (inv < c <= resp).  A
                # single pass over resp >= before is not enough — a
                # batch retained only because ANOTHER batch lowered
                # the cut must still contribute its own invocation,
                # or its source writes drain out from under it.  One
                # descending-resp sweep reaches the fixpoint: once a
                # batch's resp falls below the running cut, no later
                # (smaller-resp) batch can be retained either.
                cut = before if floor is None else min(before, floor)
                for b in sorted(self._ring, key=lambda b: -b[3]):
                    if b[3] < cut:
                        break
                    if b[2] < cut:
                        cut = b[2]
                db, kb = [], []
                for b in self._ring:
                    (db if b[3] < cut else kb).append(b)
                self._ring.clear()
                self._ring.extend(kb)
                self._size = sum(int(b[1].size) for b in kb)
            dropped, self.dropped = self.dropped, 0
        drained = [e for b in db for e in self._expand(b)]
        retained = [e for b in kb if b[0] != OP_READ
                    for e in self._expand(b)]
        return drained, retained, dropped

    def snapshot(self) -> list:
        with self._lock:
            batches = list(self._ring)
        return [e for b in batches for e in self._expand(b)]


# ---------------------------------------------------------------------------
# The inline sampling auditor
# ---------------------------------------------------------------------------

class Auditor:
    """Sampling background auditor over the serve completion stream.

    The serve hooks call :meth:`observe_read` / :meth:`observe_write`
    inline (vectorized mask + ring append — the self-timed cost the
    < 2% CI pin measures); :meth:`tick` runs the checker over a
    settled window (events older than ``horizon_s``, so cross-thread
    recording lag cannot split a read from the write it observed) and
    carries each key's last unambiguous write forward as the next
    window's initial state.  ``start()`` runs ticks on a daemon
    thread; drills call :meth:`tick` directly for determinism.

    On violation: ``audit.violations`` counts, an ``audit.violation``
    flight event records the first few, and the black box auto-dumps
    (env-gated + debounced — the degraded-entry contract).
    """

    def __init__(self, sample_mod: int = 8, capacity: int = 1 << 16,
                 interval_s: float = 0.25, horizon_s: float = 0.05):
        self.rec = HistoryRecorder(capacity=capacity,
                                   sample_mod=sample_mod)
        self.interval_s = float(interval_s)
        self.horizon_s = float(horizon_s)
        self._carry: dict = {}   # key -> (found, value) settled initial
        # _lock guards carry/intents/counters and is taken by the
        # serve hot path (begin_ops/end_ops) — the expensive checker
        # pass must NEVER run under it; _tick_lock serializes whole
        # ticks (background thread vs drills calling tick() directly)
        self._lock = threading.Lock()
        self._tick_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.cost_ns = 0         # inline observe cost (self-timed)
        # in-flight write-flush intents: registered BEFORE a flush
        # applies, released after its events are recorded — the drain
        # floor (an applied-but-unrecorded write, e.g. parked behind a
        # group-commit fsync past the horizon, must never be split
        # from the reads that already observed it)
        self._intents: dict = {}
        self._intent_seq = 0
        self.windows = 0
        self.histories_checked = 0
        self.reads_checked = 0
        self.violations = 0
        self.carry_resets = 0
        self.last_violations: list = []
        import weakref
        ref = weakref.ref(self)

        def _collect():
            a = ref()
            return a._collect() if a is not None else {}

        obs.register_collector("audit", _collect)

    # -- inline hooks (self-timed; the < 2% pin's numerator) -----------------

    def observe_read(self, keys, values, found, t_inv: float,
                     t_resp: float) -> None:
        t0 = time.perf_counter_ns()
        self.rec.observe(OP_READ, keys, t_inv, t_resp,
                         values=values, found=found)
        self._note_cost(time.perf_counter_ns() - t0)

    def observe_write(self, op: int, keys, t_inv: float, t_resp: float,
                      values=None, ok=None) -> None:
        t0 = time.perf_counter_ns()
        self.rec.observe(op, keys, t_inv, t_resp, values=values, ok=ok)
        self._note_cost(time.perf_counter_ns() - t0)

    def _note_cost(self, ns: int) -> None:
        self.cost_ns += ns

    def begin_ops(self, t_floor: float | None = None) -> int:
        """Register an in-flight batch intent (called BEFORE a read
        dispatch / write flush); the background cut will not advance
        past ``t_floor`` (the batch's oldest invocation — defaults to
        now) until :meth:`end_ops` releases it.  This is what makes
        the incremental checker sound against RECORDING lag: an op's
        events land in the ring only after its ack (a write can park
        behind a group-commit fsync; a pipelined read completes a
        whole iteration later), and a window must never close over
        ops that observed it but have not surfaced yet."""
        with self._lock:
            self._intent_seq += 1
            tok = self._intent_seq
            self._intents[tok] = time.perf_counter() \
                if t_floor is None else float(t_floor)
        return tok

    def end_ops(self, tok: int) -> None:
        """Release a batch intent — AFTER its events were recorded
        (or the batch failed without applying)."""
        with self._lock:
            self._intents.pop(tok, None)

    def cost_frac(self, wall_s: float) -> float:
        """Inline observe cost as a fraction of ``wall_s`` — the
        obs-cost-pin receipt (< 0.02 asserted in CI and published by
        the contract drill)."""
        return (self.cost_ns / 1e9) / wall_s if wall_s > 0 else 0.0

    # -- the background check -------------------------------------------------

    def tick(self, drain_all: bool = False) -> dict:
        """One checker pass over the settled window; returns its
        :func:`check_events` verdict.

        Lock discipline: ``_tick_lock`` serializes whole ticks; the
        shared ``_lock`` (which ``begin_ops``/``end_ops`` take on the
        serve DISPATCH path) is held only for the carry/intents
        snapshots and the counter fold — never across the expensive
        ``check_events`` pass, so a long window can not stall the
        serving loop behind the checker."""
        with self._tick_lock:
            return self._tick_locked(drain_all)

    def _tick_locked(self, drain_all: bool) -> dict:
        cutoff = None if drain_all \
            else time.perf_counter() - self.horizon_s
        with self._lock:
            floor = min(self._intents.values()) if self._intents \
                else None
        events, retained, dropped = self.rec.drain(before=cutoff,
                                                   floor=floor)
        if os.environ.get("SHERMAN_AUDIT_DEBUG"):
            import sys
            print(f"AUDITTICK now={time.perf_counter():.4f} "
                  f"cutoff={cutoff} floor={floor} "
                  f"drained={len(events)} kept={len(self.rec._ring)} "
                  f"dropped={dropped}", file=sys.stderr)
        with self._lock:
            if dropped:
                # ring overflow dropped events: the carried initials
                # may name superseded writes — reset to UNKNOWN
                # (vacuous passes) rather than fabricate violations
                self._carry.clear()
                self.carry_resets += 1
                _OBS_RESETS.inc()
            carry_before = dict(self._carry)
        open_w: dict = {}
        for e in retained:
            open_w.setdefault(int(e[0]), []).append(
                (True, int(e[4])) if e[1] == OP_INSERT
                else (False, None))
        res = check_events(events, initial=carry_before,
                           open_writes=open_w)
        if res["violations"] and os.environ.get("SHERMAN_AUDIT_DEBUG"):
            import sys
            for v in res["violations"][:4]:
                k = v["key"]
                print(f"AUDITDBG key={k} carry={carry_before.get(k)}"
                      f" floor={floor} cutoff={cutoff}"
                      f" window={[e for e in events if e[0] == k]}"
                      f" retained={[e for e in retained if e[0] == k]}"
                      f" viol={v}", file=sys.stderr)
        with self._lock:
            self._update_carry(events, retained)
            self.windows += 1
            self.histories_checked += res["keys"]
            self.reads_checked += res["reads"]
            _OBS_WINDOWS.inc()
            _OBS_HIST.inc(res["keys"])
            _OBS_READS.inc(res["reads"])
            if res["violations"]:
                self.violations += len(res["violations"])
                _OBS_VIOL.inc(len(res["violations"]))
                self.last_violations = res["violations"][-8:]
        for v in res["violations"][:4]:
            obs.record_event("audit.violation", key=v["key"],
                             violation=v["kind"],
                             observed=v["observed"]["value"],
                             found=v["observed"]["found"])
        if res["violations"]:
            obs.auto_dump("audit-violation")
        return res

    def _update_carry(self, events, retained) -> None:
        """Carry each key's last write forward as the next window's
        initial state — UNAMBIGUOUS writes only: when another write
        overlaps the last one with a different outcome, the key's
        initial is unknowable and carrying a guess could fabricate a
        violation next window, so the key drops to UNKNOWN."""
        last: dict = {}
        for e in events:
            if e[1] == OP_READ:
                continue
            k = int(e[0])
            cur = last.get(k)
            if cur is None or e[3] > cur[3]:
                last[k] = e
        overlap_keys = {int(e[0]) for e in retained}
        for k, w in last.items():
            outcome = (True, int(w[4])) if w[1] == OP_INSERT \
                else (False, None)
            ambiguous = k in overlap_keys or any(
                e is not w and e[1] != OP_READ and int(e[0]) == k
                and e[3] > w[2]
                and ((True, int(e[4])) if e[1] == OP_INSERT
                     else (False, None)) != outcome
                for e in events)
            if ambiguous:
                self._carry.pop(k, None)
            else:
                self._carry[k] = outcome

    def seed_initial(self, keys, values) -> None:
        """Declare the pre-history state of ``keys`` (e.g. the
        bulk-loaded values) so reads preceding the first recorded
        write are judged instead of passing vacuously."""
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.uint64)
        with self._lock:
            for k, v in zip(keys.tolist(), values.tolist()):
                self._carry[k] = (True, v)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Auditor":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — the auditor
                    # must never take serving down; a raising checker
                    # is recorded and the loop keeps watching
                    obs.record_event("audit.checker_error",
                                     error=repr(e))

        self._thread = threading.Thread(target=_loop,
                                        name="sherman-audit",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, final_tick: bool = True) -> dict | None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            self._thread = None
        return self.tick(drain_all=True) if final_tick else None

    # -- telemetry ------------------------------------------------------------

    def _collect(self) -> dict:
        return {
            "events": float(self.rec.events),
            "dropped": float(self.rec.dropped),
            "windows": float(self.windows),
            "histories_checked": float(self.histories_checked),
            "reads_checked": float(self.reads_checked),
            "violations": float(self.violations),
            "carry_resets": float(self.carry_resets),
            "cost_ms": self.cost_ns / 1e6,
        }

    def stats(self) -> dict:
        out = {
            "sample_mod": self.rec.sample_mod,
            "events": self.rec.events,
            "windows": self.windows,
            "histories_checked": self.histories_checked,
            "reads_checked": self.reads_checked,
            "violations": self.violations,
            "carry_resets": self.carry_resets,
            "cost_ms": round(self.cost_ns / 1e6, 3),
            "linearizable": self.violations == 0,
        }
        if self.last_violations:
            out["last_violations"] = list(self.last_violations)
        return out
