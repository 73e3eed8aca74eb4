"""Replication plane: journal-shipped replica groups, lease-epoch failover
and replica-served reads (the port's copy of ``sherman_tpu/replica.py``).

Sherman keeps one copy of every page, so the recovery plane answers the
loss of the primary with a disk restore: RPO 0, but an availability gap
while the chain restores and the journal replays.  This module closes the
gap with what the port already has: the CRC-framed v2 journal
(``utils/journal.py``) is a replication log, and the cluster's lease-epoch
table names liveness.

**Topology.**  A :class:`ReplicaGroup` of N in-process follower engines on
the primary's device, each built from the primary's on-disk checkpoint
chain the way ``RecoveryPlane.recover`` builds one (restore chain -> Tree
-> BatchedEngine -> heap rebuild; the group inflates and checks the
chain's base once for all its followers and keeps the loaded base for
their re-bootstraps, ``checkpoint.shared_loads``), then fed by a
journal-shipping tail: an incremental reader
(:class:`JournalTailer`) over the primary's live segment directory.
Followers apply shipped records through
:func:`sherman_tpu_torch.utils.journal.apply_records`, the loop recovery
replays through, so a follower applies exactly what recovery would.

**Watermarks.**  Each follower publishes a durable ``(cid, link, seq)``
watermark (atomic JSON with fsync in its own directory) after every apply
batch: the promotion order and the operator's replication-lag receipt.

**The tail at the shipping boundary.**  A torn frame at the tail of the
live segment is an append in flight: the follower waits and never
truncates the primary's file.  A torn tail on a segment that has a
successor (or once the primary is declared dead) is final: skipped, as
recovery would truncate it.  A bad frame with bytes after it raises the
typed ``JournalCorruptError``.  A swept current segment (a checkpoint
retired it under the tail) or a re-based chain id re-bootstraps the
follower from the newer chain.

**Failover** rides the lease-epoch table: the group registers a lease for
the primary's write authority and fences every journal append through it
(:class:`_FencedJournal`).  :meth:`ReplicaGroup.promote` expires the lease
(``cluster.expire_client``), bumps the group epoch, catches every follower
up to the durable journal end (records are fsync'd before the ack, so the
catch-up is RPO 0) and picks the highest-watermark follower.  A stale
primary that keeps writing fails at its own durability gate with
:class:`StalePrimaryError`.  The winner's replayed J_ACK window re-seeds
the front door's exactly-once window (``ShermanServer.seed_dedup``).

**Replica reads.**  A follower serves the hot-key tier's traffic through
the leaf cache's version-revalidated probe against its own pool: a hit is
certified against the follower's pages, anything stale is a miss and
forwards to the primary.  The group serves from a follower only when it
was caught up to the durable journal end at its last pump.

**Partition plane.**
- Quorum acks (:meth:`ReplicaGroup.wait_quorum`, ridden by the front
  door's ``ServeConfig.ack_quorum``): an ack resolves only after K-1
  follower watermarks cover the durable journal frontier ``(segment,
  size)`` captured when the write returned; a bounded wait that raises
  :class:`QuorumTimeoutError`.
- Replication chaos (:meth:`ReplicaGroup.attach_chaos`): a
  ``chaos.ReplChaos`` layer perturbs tailer polls and the fence's view of
  the lease table.
- The split-brain fence point: :meth:`ReplicaGroup.promote` expires the
  lease and captures the durable frontier under the journal's append
  lock, capping every tailer at that byte; :meth:`count_fenced_suffix`
  counts what a lease-partitioned stale primary acked past it.
- Anti-entropy (:class:`AntiEntropy`): an audit (watermark freshness, the
  consumed-segment CRC, a pool compare against the primary on the device)
  that quarantines a divergent follower, re-ships it through bootstrap and
  re-admits it.

A torn live tail stuck past ``SHERMAN_TAIL_WAIT_S`` with the primary's
lease dead raises :class:`TailStalledError` instead of hanging.  An error
on the background pump or audit thread (a CUDA launch error included) is
kept and re-raised, with its own type, by the group's next ``pump`` or
``promote`` (the audit's by the next ``tick``).

Observability: the ``repl.`` collector, the ``repl.lag_ms``,
``repl.availability_gap_ms`` and ``repl.quorum_wait_ms`` gauges, the
``repl.*`` counters, and the flight events ``repl.promote``,
``repl.fenced``, ``repl.tail_torn_wait``, ``repl.rebootstrap``,
``repl.quarantine`` and ``repl.repair``.

The cross-host seam: on a multihost plane (``multihost.py``) a tailer
ships one host's ``-h<id>-`` chain namespace out of the shared directory
(``JournalTailer(dir, cid, host_id=)``), and a group built on host A's
plane tails A's namespace (``ReplicaGroup.primary_host``) wherever it is
pumped from.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import weakref
import zlib

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ConfigError, StateError
from sherman_tpu_torch.utils import checkpoint as CK
from sherman_tpu_torch.utils import journal as J

_OBS_LAG_MS = obs.gauge("repl.lag_ms")
_OBS_GAP_MS = obs.gauge("repl.availability_gap_ms")
_OBS_APPLIED = obs.counter("repl.applied_records")
_OBS_PROMOTIONS = obs.counter("repl.promotions")
_OBS_FENCED = obs.counter("repl.fenced_writes")
_OBS_QUORUM_MS = obs.gauge("repl.quorum_wait_ms")
_OBS_QUORUM_TIMEOUTS = obs.counter("repl.quorum_timeouts")
_OBS_STALLS = obs.counter("repl.tail_stalls")
_OBS_AUDITS = obs.counter("repl.anti_entropy_audits")
_OBS_QUARANTINES = obs.counter("repl.quarantines")
_OBS_REPAIRS = obs.counter("repl.repairs")


class StalePrimaryError(StateError):
    """A write reached the durability gate under an expired primary
    lease: the group promoted a follower, so appending would fork the
    journal behind the new primary's back."""


class QuorumTimeoutError(StateError):
    """A quorum-ack wait expired: fewer than ``ack_quorum - 1`` follower
    watermarks covered the write's durable journal frontier within the
    bounded wait.  The write IS durable on the primary and its rid is
    already in the exactly-once dedup window: a client retry re-acks the
    original result once the quorum recovers."""


class TailStalledError(StateError):
    """The journal-shipping tail waited ``SHERMAN_TAIL_WAIT_S`` at one
    torn-tail position and the primary's lease is no longer live: the
    append in flight will never complete.  The caller escalates, usually
    by promoting (whose final catch-up pass skips the torn tail)."""


class _ResyncRequired(StateError):
    """Internal tailer signal: the current segment was swept or the chain
    re-based; re-bootstrap the follower from the newer chain."""


# -- incremental segment reader ---------------------------------------------


class JournalTailer:
    """Incremental frame reader over one recovery directory's live journal
    segments: the shipping feed.  Tracks (segment, byte offset);
    :meth:`poll` decodes every frame fully landed since the last call and
    advances across rotations."""

    def __init__(self, directory: str, cid: str,
                 host_id: int | None = None):
        self.dir = directory
        self.cid = cid
        #: the chain namespace to tail: ``None`` is the legacy un-tagged
        #: single-host chain; an integer tails that host's ``-h<id>-``
        #: chain (the cross-host seam: a follower on host B ships host
        #: A's stream out of the shared directory)
        self.host_id = host_id
        self._cur: str | None = None   # current segment path
        self._off = 0                  # consumed bytes (past the magic)
        self._fmt = 2
        self.torn_waits = 0
        #: the replication fault layer (``chaos.ReplChaos``) and this
        #: tailer's follower index on its clock, wired by the group
        self.chaos = None
        self.follower_idx = 0
        #: the fence point ``(segment path, byte limit)``: promotion caps
        #: every poll here; bytes past it are a stale primary's suffix
        self.fence: tuple[str, int] | None = None
        #: rolling CRC32 of every byte consumed of the current segment
        #: (from byte 0), which the anti-entropy audit re-reads
        self.seg_crc = 0
        #: the stall watchdog: ``() -> bool`` probe of the primary's lease
        self.lease_probe = None
        self.tail_wait_s = C.tail_wait_s()
        self.stalls = 0
        self._torn_pos: tuple | None = None
        self._torn_since = 0.0
        self._stall_evented = False
        #: what the fault layer did to the last poll: ``pump`` classifies
        #: a refusal as transient (a perturbed view) and an empty poll as
        #: a cut feed (which certifies no freshness)
        self.last_poll_perturbed = False
        self.last_poll_cut = False
        self._perturb_next = False
        # anchor now: the tailer owes its creator every record of the
        # earliest segment alive now, so a sweep of it trips the resync
        # check instead of being skipped unseen
        segs = self._segments()
        if segs:
            self._cur = segs[0]

    def _segments(self) -> list[str]:
        from sherman_tpu_torch.recovery import RecoveryPlane
        cid, _deltas, journals = RecoveryPlane._discover(
            self.dir, host_id=self.host_id)
        if cid != self.cid:
            raise _ResyncRequired(f"chain re-based ({self.cid} -> {cid})")
        return journals

    def poll(self, final: bool = False) -> list[tuple]:
        """-> decoded records (``with_rids`` 4-tuples) newly durable since
        the last poll, across any number of rotations.  With ``final``
        (the primary is dead) a torn tail on the last segment is skipped,
        as recovery would truncate it.

        An attached fault layer perturbs this poll's view only: a drop,
        delay or partition loses the fetch (offset untouched), slow stalls
        first, reorder routes the fetched bytes through
        :meth:`chaos.ReplChaos.view` so the per-frame CRC refuses them."""
        self.last_poll_perturbed = False
        self.last_poll_cut = False
        self._perturb_next = False
        if self.chaos is not None:
            d = self.chaos.on_poll(self.follower_idx)
            if d is not None:
                if d["slow_ms"]:
                    time.sleep(d["slow_ms"] / 1e3)
                if d["partition"] or d["drop"] or d["freeze"]:
                    self.last_poll_cut = True
                    return []
                self._perturb_next = d["reorder"]
        out: list[tuple] = []
        try:
            self._poll_into(out, final)
        except J.JournalCorruptError:
            if not out:
                raise
            # records of earlier segments this round were consumed (their
            # offsets advanced): hand them on; the corrupt segment's offset
            # is untouched, so the error shows again next poll
        return out

    def _poll_into(self, out: list, final: bool) -> None:
        while True:
            segs = self._segments()
            if self.fence is not None:
                # the old chain ends at the fence: later segments (a stale
                # primary's rotations) do not exist for this tailer
                segs = [s for s in segs if s <= self.fence[0]]
            if self._cur is not None and self._cur not in segs:
                # the segment under the tail was swept: only the chain
                # holds what landed there after the last read
                raise _ResyncRequired(
                    f"segment {os.path.basename(self._cur)} swept "
                    "under the tail")
            if self._cur is None:
                if not segs:
                    return
                self._cur, self._off, self._fmt = segs[0], 0, 2
                self.seg_crc = 0
            # list, then read: a successor listed now proves the current
            # segment was closed before the read, so its torn tail is final
            recs, torn = self._poll_segment(self._cur)
            out.extend(recs)
            later = [s for s in segs if s > self._cur]
            if later:
                self._cur, self._off, self._fmt = later[0], 0, 2
                self.seg_crc = 0
                continue
            if torn and not final:
                # the live-tail rule: an append may be in flight; wait
                self.torn_waits += 1
                obs.record_event("repl.tail_torn_wait",
                                 segment=os.path.basename(self._cur),
                                 at_byte=self._off)
                self._note_torn_wait()
            return

    def _note_torn_wait(self) -> None:
        """The bounded wait: a torn tail at one position past
        ``tail_wait_s`` is a slow live appender (lease live: wait on,
        evented once) or a dead primary's torn append (lease dead, or no
        probe to ask: raise typed)."""
        now = time.monotonic()
        pos = (self._cur, self._off)
        if self._torn_pos != pos:
            self._torn_pos = pos
            self._torn_since = now
            self._stall_evented = False
            return
        waited = now - self._torn_since
        if waited < self.tail_wait_s:
            return
        if self.lease_probe is not None and self.lease_probe():
            if not self._stall_evented:
                self._stall_evented = True
                obs.record_event(
                    "repl.tail_slow", segment=os.path.basename(self._cur),
                    at_byte=self._off, waited_s=round(waited, 3))
            return
        self.stalls += 1
        _OBS_STALLS.inc()
        obs.record_event("repl.tail_stalled",
                         segment=os.path.basename(self._cur),
                         at_byte=self._off, waited_s=round(waited, 3))
        raise TailStalledError(
            f"journal tail torn at {os.path.basename(self._cur)}"
            f":{self._off} for {waited:.1f}s with the primary's lease "
            "dead: the append in flight will never land; promote (the "
            "final catch-up pass skips it) instead of waiting")

    def covers(self, path: str, size: int) -> bool:
        """True when every byte of ``path[:size]`` has been consumed (the
        quorum-ack coverage test).  Segment names sort in append order, so
        a later current segment means ``path`` was consumed or swept into
        the chain this follower restored."""
        if self._cur is None:
            return False
        if self._cur > path:
            return True
        return self._cur == path and self._off >= int(size)

    def _poll_segment(self, path: str) -> tuple[list[tuple], bool]:
        """-> (records of the complete frames past the offset, torn), torn
        when a partial frame remains at the tail.  Never writes the
        file."""
        try:
            with open(path, "rb") as f:
                f.seek(self._off)
                blob = f.read()
        except FileNotFoundError:
            raise _ResyncRequired(
                f"segment {os.path.basename(path)} swept under the tail"
            ) from None
        base = self._off
        if self.fence is not None and path == self.fence[0]:
            # cap the view at the fence point (a cut mid-frame decodes as a
            # torn tail, which the final pass skips)
            blob = blob[: max(0, self.fence[1] - base)]
        if self._perturb_next and blob:
            blob = self.chaos.view(blob)
            self.last_poll_perturbed = True
            self._perturb_next = False
        pos = 0
        if base == 0:
            if len(blob) < len(J.MAGIC):
                return [], True  # the magic is still landing
            head = blob[: len(J.MAGIC)]
            if head == J.MAGIC:
                self._fmt = 2
            elif head == J.MAGIC_V1:
                self._fmt = 1  # a pre-rid segment: dedup-disabled replay
            else:
                raise J.JournalCorruptError(
                    f"{path}: bad journal magic {head!r}")
            pos = len(J.MAGIC)
        out: list[tuple] = []
        size = len(blob)
        while pos < size:
            if pos + J._HDR.size > size:
                break  # torn header
            length, crc = J._HDR.unpack_from(blob, pos)
            end = pos + J._HDR.size + length
            if length > J.MAX_PAYLOAD:
                if end > size or end < 0:
                    break  # a torn length word: the tail rule
                raise J.JournalCorruptError(
                    f"{path}: frame at byte {base + pos} claims {length} "
                    f"bytes (> {J.MAX_PAYLOAD}) with bytes following")
            if end > size:
                break  # torn payload
            payload = blob[pos + J._HDR.size: end]
            if zlib.crc32(payload) != crc:
                if end == size:
                    break  # a torn append at the tail
                raise J.JournalCorruptError(
                    f"{path}: CRC mismatch at byte {base + pos} with "
                    f"{size - end} bytes following: content corruption, "
                    "refusing to apply")
            out.append(J._decode_payload(payload, base + pos, self._fmt))
            pos = end
        # consumed frames are CRC-clean, so the prefix equals the file's
        # bytes even under a perturbed view
        if pos:
            self.seg_crc = zlib.crc32(blob[:pos], self.seg_crc)
        self._off = base + pos
        return out, pos < size


# -- the epoch fence at the durability gate ---------------------------------


class _FencedJournal:
    """Journal proxy that checks the primary's lease epoch before every
    append; everything else delegates to the wrapped segment, so the
    recovery plane's rotation is untouched."""

    def __init__(self, inner, group: "ReplicaGroup"):
        self._inner = inner
        self._group = group

    def append(self, *a, **kw):
        self._group._check_fence()
        return self._inner.append(*a, **kw)

    def append_acks(self, *a, **kw):
        self._group._check_fence()
        return self._inner.append_acks(*a, **kw)

    def append_heap(self, *a, **kw):
        self._group._check_fence()
        return self._inner.append_heap(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# -- one follower -----------------------------------------------------------


class Follower:
    """One in-process follower engine: bootstrapped from the primary's
    on-disk chain the way ``RecoveryPlane.recover`` does it, tailed from
    its journal directory, publishing a durable applied watermark."""

    def __init__(self, group: "ReplicaGroup", idx: int):
        self.group = group
        self.idx = idx
        self.dir = os.path.join(group.dir, f"follower-{idx}")
        os.makedirs(self.dir, exist_ok=True)
        self.stats: dict = {}
        #: replayed exactly-once entries {(tenant, rid): (op, ok[,
        #: handles])}: promotion re-seeds the front door from the winner's
        self.window: dict = {}
        self.rebootstraps = -1  # the first bootstrap is not a re-
        self.caught_up = False
        #: the anti-entropy verdict: a quarantined follower serves no
        #: replica read and counts toward no quorum until repaired
        self.quarantined = False
        self.chaos_detected = 0  # perturbed views refused
        self.cluster = self.tree = self.eng = None
        self.cid = None
        self.link = 0   # delta links restored at the (re)bootstrap
        self.seq = 0    # records applied since the (re)bootstrap
        #: wall seconds of each bootstrap by part (restore: the chain's
        #: inflate and copy to the device; engine: Tree and BatchedEngine;
        #: router; heap; cache)
        self.bootstrap_s: list[dict] = []
        self._bootstrap()

    def _bootstrap(self) -> None:
        """(Re)build the engine from the primary's chain: the restore ->
        Tree -> engine -> heap-rebuild sequence of ``recover``, without
        the re-base (a follower never writes the chain it follows)."""
        from sherman_tpu_torch.models.batched import BatchedEngine
        from sherman_tpu_torch.models.btree import Tree
        from sherman_tpu_torch.recovery import RecoveryPlane, _base_name
        from sherman_tpu_torch.utils import checkpoint as CK

        g = self.group
        t0 = time.perf_counter()
        cid, deltas, _journals = RecoveryPlane._discover(
            g.primary_dir, host_id=g.primary_host)
        cluster = CK.restore_chain(
            os.path.join(g.primary_dir, _base_name(g.primary_host)),
            deltas, device=g.device)
        t1 = time.perf_counter()
        tree = Tree(cluster)
        eng = BatchedEngine(tree, batch_per_node=g.batch_per_node,
                            tcfg=g.tcfg)
        t2 = time.perf_counter()
        eng.attach_router()
        t3 = time.perf_counter()
        if cluster.cfg.heap_pages_per_node > 0:
            from sherman_tpu_torch.models.value_heap import ValueHeap
            ValueHeap(eng).rebuild()
        t4 = time.perf_counter()
        if g.cache_slots:
            eng.attach_leaf_cache(slots=g.cache_slots)
        t5 = time.perf_counter()
        self.cluster, self.tree, self.eng = cluster, tree, eng
        self.cid = cid
        self.link = len(deltas)
        self.seq = 0
        self.window.clear()
        self.caught_up = False
        self.tailer = JournalTailer(g.primary_dir, cid,
                                    host_id=g.primary_host)
        g._arm_tailer(self)
        # a checkpoint landing between the restore and the tailer's anchor
        # would sweep records into a delta this follower did not restore:
        # start over if the chain moved (one loop a checkpoint)
        cid2, deltas2, _ = RecoveryPlane._discover(
            g.primary_dir, host_id=g.primary_host)
        if cid2 != cid or len(deltas2) != len(deltas):
            self._bootstrap()
            return
        self.bootstrap_s.append({"restore": t1 - t0, "engine": t2 - t1,
                                 "router": t3 - t2, "heap": t4 - t3,
                                 "cache": t5 - t4,
                                 "total": time.perf_counter() - t0})
        self.rebootstraps += 1
        if self.rebootstraps:
            obs.record_event("repl.rebootstrap", follower=self.idx,
                             cid=cid, link=self.link)
        self._publish_watermark()

    def pump(self, final: bool = False) -> int:
        """Poll the tail and apply every newly durable record through the
        shared :func:`~sherman_tpu_torch.utils.journal.apply_records`
        core; publish the watermark.  -> records applied."""
        try:
            recs = self.tailer.poll(final=final)
        except _ResyncRequired:
            self._bootstrap()
            recs = self.tailer.poll(final=final)
        except J.JournalCorruptError:
            if not self.tailer.last_poll_perturbed:
                raise  # real mid-file corruption: refuse, typed
            # the fault layer perturbed this poll's view: the file was
            # never touched and the offset never passed the refused frame;
            # count the detection and read a clean view next poll
            if self.tailer.chaos is not None:
                self.tailer.chaos.note_detected()
            self.chaos_detected += 1
            self.caught_up = False
            return 0
        if not recs:
            if self.tailer.last_poll_perturbed:
                # the damage landed in the last frame, which decodes as a
                # torn tail: refused all the same, so one detection
                if self.tailer.chaos is not None:
                    self.tailer.chaos.note_detected()
                self.chaos_detected += 1
                self.caught_up = False
                return 0
            # an empty poll certifies freshness only when the feed was read
            self.caught_up = not self.tailer.last_poll_cut
            return 0
        sink: list = []
        J.apply_records(recs, self.eng, ack_sink=sink, stats=self.stats)
        for entry in sink:
            # later acks override earlier (the front door's last-writer
            # window); provenance rides along
            rid, tenant = entry[0], entry[1]
            self.window[(tenant, rid)] = tuple(entry[2:])
        self.seq += len(recs)
        if self.tailer.last_poll_perturbed:
            # a clean prefix applied ahead of the refused damage: still
            # one detection
            if self.tailer.chaos is not None:
                self.tailer.chaos.note_detected()
            self.chaos_detected += 1
        self.caught_up = not (self.tailer.last_poll_perturbed
                              or self.tailer.last_poll_cut)
        _OBS_APPLIED.inc(len(recs))
        self._publish_watermark()
        return len(recs)

    def watermark(self) -> tuple[str, int, int]:
        """``(cid, link, seq)``: the promotion order, compared on (link,
        seq) within one cid."""
        return (self.cid, self.link, self.seq)

    def _publish_watermark(self) -> None:
        """The durable watermark: atomic JSON (tmp, fsync, rename) in the
        follower's own directory."""
        path = os.path.join(self.dir, "watermark.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"cid": self.cid, "link": self.link,
                                "seq": self.seq}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def serve_read(self, keys):
        """Replica-served reads through the leaf cache's revalidated probe
        against this follower's own pool.  -> ``(vals, hit)``, or None
        when the follower may not serve (no cache, not caught up at its
        last pump, or quarantined)."""
        cache = self.eng.leaf_cache
        if cache is None or not self.caught_up or self.quarantined:
            return None
        from sherman_tpu_torch.ops import bits
        eng = self.eng
        keys = np.asarray(keys, np.uint64)
        n = keys.shape[0]
        total = eng.cfg.machine_nr * eng.B
        vals = np.zeros(n, np.uint64)
        hit = np.zeros(n, bool)
        for i in range(0, n, total):
            chunk = keys[i:i + total]
            khi, klo = bits.keys_to_pairs(chunk)
            khi, klo = eng._pad(khi), eng._pad(klo)
            active = eng._pad(np.ones(chunk.shape[0], bool))
            h, vhi, vlo = cache.probe(khi, klo, active)
            v = bits.pairs_to_keys(vhi, vlo)
            vals[i:i + total] = v[: chunk.shape[0]]
            hit[i:i + total] = h[: chunk.shape[0]]
        return vals, hit

    def admit(self, keys) -> dict:
        """Admit ``keys`` into the follower's leaf cache, resolved against
        its own pool: the replica read set."""
        if self.eng.leaf_cache is None:
            raise StateError("follower has no leaf cache attached "
                             "(ReplicaGroup(cache_slots=...))")
        return self.eng.leaf_cache.fill(np.asarray(keys, np.uint64))


# -- the group --------------------------------------------------------------


class ReplicaGroup:
    """N journal-shipped followers and the lease-epoch failover plane over
    one primary ``RecoveryPlane``.  Lifecycle::

        plane.checkpoint_base()          # the chain followers feed on
        group = ReplicaGroup(plane, n=2)
        group.start()                    # background tail (or pump())
        ...
        srv.kill()                       # the primary dies
        rcpt = group.promote(t_dead=t)   # fence, catch up, pick
        srv2 = ShermanServer(group.promoted.eng, cfg)
        srv2.start(...)
        srv2.seed_dedup(group.promoted_window())
        group.note_resumed()             # the availability-gap receipt
    """

    def __init__(self, plane, n: int | None = None, *,
                 poll_ms: float | None = None,
                 batch_per_node: int = 512, tcfg=None,
                 cache_slots: int | None = None,
                 directory: str | None = None):
        n = C.replica_count() if n is None else int(n)
        if n <= 0:
            raise ConfigError(
                "ReplicaGroup wants >= 1 follower (replication is off by "
                "default, SHERMAN_REPL=0; ReplicaGroup.from_env builds one "
                "from the knob)")
        if plane.cid is None:
            raise StateError("primary has no chain yet: "
                             "plane.checkpoint_base() first")
        self.plane = plane
        self.primary_dir = plane.dir
        #: the chain namespace the followers tail, the primary plane's own
        #: host tag: ``None`` on a single-host plane; on a multihost plane
        #: the owner's ``-h<id>-`` namespace, so a group built on host A's
        #: plane but pumped from host B's context ships A's stream (a
        #: primary view without a host tag is a single-host plane)
        self.primary_host = getattr(plane, "_htag", None)
        #: followers live on the primary's device
        self.device = plane.cluster.cfg.device
        self.batch_per_node = int(batch_per_node)
        self.tcfg = tcfg
        self.cache_slots = cache_slots
        self.poll_ms = C.replica_poll_ms() if poll_ms is None \
            else float(poll_ms)
        self.dir = directory or os.path.join(plane.dir, "replicas")
        os.makedirs(self.dir, exist_ok=True)
        #: the group epoch, bumped at every promotion (the fence rides the
        #: cluster's lease-epoch table; this mirrors it for receipts)
        self.epoch = 1
        # the primary's write authority as a lease on its own cluster
        self._lease = plane.cluster.register_client()
        self._install_fence(plane.eng)
        self.promoted: Follower | None = None
        self._t_dead: float | None = None
        self.availability_gap_ms: float | None = None
        self.promotions = 0
        self.fenced_writes = 0
        self.reads_served = 0
        self.reads_forwarded = 0
        self.last_pump_records = 0
        self.quorum_acks = 0
        self.quorum_timeouts = 0
        self.quorum_wait_ms = 0.0
        self.quorum_timeout_s = 5.0
        self.fenced_suffix_records = 0
        self._chaos = None                       # chaos.ReplChaos
        self._ship_chaos_off = False  # promote detaches the ship side
        self._fence: tuple[str, int] | None = None
        self.anti_entropy: "AntiEntropy | None" = None
        self._last_pump_t = 0.0
        self._rr = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: the background pump's error, re-raised by the next pump/promote
        self.tail_error: BaseException | None = None
        self._pump_lock = threading.Lock()
        #: the loaded arrays of the chain's base (``checkpoint.
        #: shared_loads``): the followers of a bootstrap pass inflate and
        #: check it once, and a re-bootstrap after a delta reuses it; held
        #: while the base is the chain's (the host copy of the pool)
        self._base_loads: dict = {}
        with self._shared_base():
            self.followers = [Follower(self, i) for i in range(n)]
        ref = weakref.ref(self)

        def _collect():
            g = ref()
            return g._collect() if g is not None else {}

        obs.register_collector("repl", _collect)

    @classmethod
    def from_env(cls, plane, **kw):
        """Knob-gated construction: None when ``SHERMAN_REPL`` is unset or
        0 (the default: no follower, no tailer)."""
        n = C.replica_count()
        return None if n == 0 else cls(plane, n, **kw)

    # -- hot accounting (plain adds only) ------------------------------------

    def _note_reads(self, served: int, forwarded: int) -> None:
        self.reads_served += served
        self.reads_forwarded += forwarded

    def _note_fenced(self) -> None:
        self.fenced_writes += 1

    def _note_quorum(self, ms: float) -> None:
        self.quorum_acks += 1
        self.quorum_wait_ms += ms

    # -- replication chaos ---------------------------------------------------

    def attach_chaos(self, layer) -> None:
        """Install a replication fault layer (``chaos.ReplChaos``): every
        tailer poll routes through its directives and the durability fence
        reads the lease table through its view.  None detaches it."""
        self._chaos = layer
        for f in self.followers:
            self._arm_tailer(f)

    def _arm_tailer(self, f: Follower) -> None:
        """(Re)wire a follower's tailer to the group's hooks, at every
        (re)bootstrap: the fault layer, the stall probe, the fence."""
        t = f.tailer
        t.follower_idx = f.idx
        t.chaos = None if self._ship_chaos_off else self._chaos
        t.lease_probe = self._lease_probe
        t.fence = self._fence

    def _lease_probe(self) -> bool:
        """Is the primary's write lease live?  Asked of the true lease
        table (only the partitioned primary's own view can be frozen)."""
        return self.plane.cluster.lease_is_live(self._lease.tag,
                                                self._lease.epoch)

    # -- quorum acks ---------------------------------------------------------

    def quorum_token(self) -> tuple[str, int]:
        """The durable journal frontier ``(segment path, size)``
        (``RecoveryPlane.journal_frontier``)."""
        return self.plane.journal_frontier()

    def wait_quorum(self, need: int, timeout_s: float | None = None,
                    token: tuple[str, int] | None = None) -> dict:
        """Block until ``need`` non-quarantined follower watermarks cover
        the durable journal frontier (``token``, default captured now),
        pumping the tail while waiting; raise :class:`QuorumTimeoutError`
        at the deadline.  -> ``{"needed", "covered", "waited_ms"}``."""
        need = int(need)
        rc = {"needed": need, "covered": 0, "waited_ms": 0.0}
        if need <= 0:
            return rc
        if need > len(self.followers):
            raise ConfigError(
                f"quorum of {need} followers wanted but the group has "
                f"{len(self.followers)}: ack_quorum counts the primary "
                "plus at most every follower")
        path, size = token if token is not None else self.quorum_token()
        t0 = time.perf_counter()
        deadline = t0 + (self.quorum_timeout_s if timeout_s is None
                         else float(timeout_s))
        while True:
            n = 0
            for f in self.followers:
                if not f.quarantined and f.tailer.covers(path, size):
                    n += 1
            if n >= need:
                break
            if time.perf_counter() >= deadline:
                self.quorum_timeouts += 1
                _OBS_QUORUM_TIMEOUTS.inc()
                obs.record_event("repl.quorum_timeout", needed=need,
                                 covered=n, segment=os.path.basename(path),
                                 size=size)
                raise QuorumTimeoutError(
                    f"quorum ack: {n}/{need} followers cover the frontier "
                    f"({os.path.basename(path)}:{size}) at the deadline: "
                    "partitioned, quarantined or slow followers; the write "
                    "IS durable on the primary and its rid stays in the "
                    "dedup window, so a retry re-acks exactly once")
            if self.pump() == 0:
                time.sleep(0.001)
        ms = (time.perf_counter() - t0) * 1e3
        self._note_quorum(ms)
        _OBS_QUORUM_MS.set(ms)
        rc["covered"] = n
        rc["waited_ms"] = ms
        return rc

    # -- fencing -------------------------------------------------------------

    def _install_fence(self, eng) -> None:
        """Wrap the primary engine's journal attachment so every segment
        (current and every later rotation) appends through the epoch
        check."""
        group = self
        orig_attach = eng.attach_journal

        def fenced_attach(journal):
            orig_attach(None if journal is None
                        else _FencedJournal(journal, group))

        eng.attach_journal = fenced_attach
        if eng.journal is not None:
            orig_attach(_FencedJournal(eng.journal, group))

    def _check_fence(self) -> None:
        cl = self.plane.cluster
        if self._chaos is not None:
            # under a lease-scope partition the primary sees a frozen
            # snapshot and keeps acking until the heal
            view = self._chaos.lease_view(cl.lease_epochs)
            live = view.get(int(self._lease.tag)) == int(self._lease.epoch)
        else:
            live = cl.lease_is_live(self._lease.tag, self._lease.epoch)
        if not live:
            self._note_fenced()
            _OBS_FENCED.inc()
            obs.record_event("repl.fenced", epoch=self.epoch,
                             owner_tag=self._lease.tag)
            raise StalePrimaryError(
                "primary lease expired (group promoted under epoch "
                f"{self.epoch}): this write is fenced; a stale primary "
                "must not fork the journal")

    # -- tailing -------------------------------------------------------------

    @contextlib.contextmanager
    def _shared_base(self):
        """Bootstraps in this context share their chain loads; afterwards
        only the current base's loads are kept."""
        from sherman_tpu_torch.recovery import _base_name
        with CK.shared_loads(self._base_loads):
            yield
        CK.keep_shared_loads(
            self._base_loads,
            os.path.join(self.primary_dir, _base_name(self.primary_host)))

    def _raise_tail_error(self) -> None:
        err, self.tail_error = self.tail_error, None
        if err is not None:
            raise err

    def pump(self, final: bool = False) -> int:
        """One synchronous shipping round: every follower polls the tail
        and applies what landed.  -> records applied (the max over the
        followers, which consume one feed)."""
        self._raise_tail_error()
        # a sweep re-bootstraps every follower from one chain: share it
        with self._pump_lock, self._shared_base():
            applied = [f.pump(final=final) for f in self.followers]
            self._last_pump_t = time.perf_counter()
        self.last_pump_records = max(applied) if applied else 0
        return self.last_pump_records

    def start(self) -> None:
        """Background shipping at ``poll_ms`` (the knob-driven mode; drills
        that want determinism call :meth:`pump`).  An error stops the
        thread and is re-raised by the next :meth:`pump`/:meth:`promote`."""
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                try:
                    self.pump()
                except Exception as e:  # noqa: BLE001 — kept for the caller
                    self.tail_error = e
                    obs.record_event("repl.tail_error", error=repr(e))
                    break
                self._stop.wait(self.poll_ms / 1e3)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="sherman-repl-tail")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def measure_lag(self) -> float:
        """The replication-lag receipt: wall ms of one synchronous pump
        (records durable in the primary's journal -> applied by every
        follower), published as ``repl.lag_ms``."""
        t0 = time.perf_counter()
        self.pump()
        ms = (time.perf_counter() - t0) * 1e3
        _OBS_LAG_MS.set(ms)
        return ms

    # -- replica reads -------------------------------------------------------

    def read(self, keys, forward=None):
        """Serve a read batch from the replica tier: pump (at the poll
        cadence), pick the next follower round-robin, serve its certified
        cache hits, forward the rest to ``forward`` (default: the primary
        engine's search)."""
        keys = np.asarray(keys, np.uint64)
        if forward is None:
            forward = self.plane.eng.search
        if time.perf_counter() - self._last_pump_t >= self.poll_ms / 1e3:
            self.pump()
        f = self.followers[self._rr % len(self.followers)]
        self._rr += 1
        res = f.serve_read(keys)
        if res is None:
            vals, found = forward(keys)
            self._note_reads(0, int(keys.size))
            return np.asarray(vals), np.asarray(found)
        vals, hit = res
        out_v = np.array(vals)
        out_f = np.array(hit)
        miss = ~hit
        if miss.any():
            fv, ff = forward(keys[miss])
            out_v[miss] = np.asarray(fv)
            out_f[miss] = np.asarray(ff)
        self._note_reads(int(hit.sum()), int(miss.sum()))
        return out_v, out_f

    # -- failover ------------------------------------------------------------

    def promote(self, t_dead: float | None = None) -> dict:
        """Fail over: expire the primary's lease, bump the group epoch,
        catch every follower up to the durable journal end (a final poll:
        the dead primary appends nothing more) and pick the
        highest-watermark follower.  -> the promotion receipt."""
        t0 = time.perf_counter()
        self._t_dead = t_dead if t_dead is not None else t0
        self.stop()
        self._raise_tail_error()
        # the fence point: expire the lease and capture the durable
        # frontier under the journal's append lock, so "before the epoch
        # bump" names an exact byte
        jrn = self.plane.eng.journal
        inner = getattr(jrn, "_inner", jrn)
        lock = getattr(inner, "_lock", None) if inner is not None else None
        fence = None
        if lock is not None:
            with lock:
                self.plane.cluster.expire_client(self._lease.tag)
                try:
                    fence = (inner.path, os.path.getsize(inner.path))
                except OSError:
                    fence = None
        else:
            self.plane.cluster.expire_client(self._lease.tag)
        old_epoch, self.epoch = self.epoch, self.epoch + 1
        self._fence = fence
        # the catch-up runs with the fault layer off the ship side (the
        # majority reaches the journal); the lease view stays routed
        self._ship_chaos_off = True
        for f in self.followers:
            self._arm_tailer(f)
            f.pump(final=True)
        self.promoted = max(self.followers, key=lambda f: (f.link, f.seq))
        self.promotions += 1
        _OBS_PROMOTIONS.inc()
        ms = (time.perf_counter() - t0) * 1e3
        receipt = {
            "winner": self.promoted.idx,
            "epoch": {"old": old_epoch, "new": self.epoch},
            "watermarks": [{"follower": f.idx, "cid": f.cid,
                            "link": f.link, "seq": f.seq}
                           for f in self.followers],
            "window": len(self.promoted.window),
            "promote_ms": round(ms, 1),
            "fence": None if fence is None else {
                "segment": os.path.basename(fence[0]), "size": fence[1]},
        }
        obs.record_event("repl.promote", winner=self.promoted.idx,
                         epoch=self.epoch, seq=self.promoted.seq,
                         promote_ms=receipt["promote_ms"])
        return receipt

    def promoted_window(self) -> dict:
        """The winner's replayed exactly-once window in ``seed_dedup``'s
        shape ``{(tenant, rid): (op, ok[, handles])}``."""
        if self.promoted is None:
            raise StateError("no promotion yet: promote() first")
        return dict(self.promoted.window)

    def note_resumed(self) -> float:
        """The availability gap: the promoted front door's first served
        request minus ``t_dead``, published as
        ``repl.availability_gap_ms``."""
        if self._t_dead is None:
            raise StateError("no failover in flight: promote() first")
        ms = (time.perf_counter() - self._t_dead) * 1e3
        self.availability_gap_ms = round(ms, 1)
        _OBS_GAP_MS.set(ms)
        return self.availability_gap_ms

    def count_fenced_suffix(self) -> int:
        """Complete CRC-valid frames past the promotion fence point: what a
        lease-partitioned stale primary durably appended (and acked) after
        the epoch bump.  Trailing torn bytes are not counted.  Call after
        the heal; updates the collector's ``fenced_suffix_records``."""
        fence = self._fence
        if fence is None:
            return 0
        path, base = fence
        try:
            with open(path, "rb") as f:
                f.seek(base)
                blob = f.read()
        except OSError:
            return 0
        n = 0
        pos = 0
        size = len(blob)
        while pos + J._HDR.size <= size:
            length, crc = J._HDR.unpack_from(blob, pos)
            end = pos + J._HDR.size + length
            if length > J.MAX_PAYLOAD or end > size:
                break
            if zlib.crc32(blob[pos + J._HDR.size: end]) != crc:
                break
            n += 1
            pos = end
        self.fenced_suffix_records = n
        return n

    # -- receipts ------------------------------------------------------------

    def _collect(self) -> dict:
        """The ``repl.`` pull collector: flat numbers only."""
        st: dict = {}
        for f in self.followers:
            for k, v in f.stats.items():
                st[k] = st.get(k, 0) + int(v)
        top = max(self.followers, key=lambda f: (f.link, f.seq))
        ae = self.anti_entropy
        return {
            "followers": len(self.followers),
            "epoch": self.epoch,
            "applied_records": st.get("records", 0),
            "applied_rows": st.get("rows", 0),
            "absorbed_acks": st.get("acks", 0),
            "torn_waits": sum(f.tailer.torn_waits for f in self.followers),
            "rebootstraps": sum(f.rebootstraps for f in self.followers),
            "watermark_link": top.link,
            "watermark_seq": top.seq,
            "promotions": self.promotions,
            "fenced_writes": self.fenced_writes,
            "reads_served": self.reads_served,
            "reads_forwarded": self.reads_forwarded,
            "last_pump_records": self.last_pump_records,
            "quorum_acks": self.quorum_acks,
            "quorum_timeouts": self.quorum_timeouts,
            "quorum_wait_ms": round(self.quorum_wait_ms, 3),
            "tail_stalls": sum(f.tailer.stalls for f in self.followers),
            "chaos_detected": sum(f.chaos_detected for f in self.followers),
            "fenced_suffix_records": self.fenced_suffix_records,
            "quarantined": sum(1 for f in self.followers if f.quarantined),
            "anti_entropy_audits": 0 if ae is None else ae.audits,
            "anti_entropy_repairs": 0 if ae is None else ae.repairs,
            "divergences": 0 if ae is None else ae.divergences,
        }

    def stats(self) -> dict:
        return self._collect()

    def close(self) -> None:
        if self.anti_entropy is not None:
            self.anti_entropy.stop()
        self.stop()


# -- anti-entropy follower repair --------------------------------------------


class AntiEntropy:
    """Periodic follower audit -> quarantine -> re-ship -> re-admit.

    Three checks a follower, under the group's pump lock with the tail
    pumped and the durable frontier stable across the compare:

    - watermark freshness: after a pump the tailer covers the durable
      frontier (a lagging follower is not divergent; it skips the compare);
    - the consumed-segment CRC: the tailer's rolling CRC must equal a
      re-read of the same byte range (``journal.crc_of_range``);
    - the pool compare: the follower's pool must equal the primary's, on
      the device (``torch.equal``): sampled rows (``sample_rows``, drawn
      in the reference's order from the same numpy RNG) or the whole pool
      (``sample_rows=0``).

    A divergent follower is quarantined (no replica read, no quorum),
    re-shipped through bootstrap and the tail, re-audited with a full
    compare and re-admitted only when clean.  ``SHERMAN_ANTI_ENTROPY_S``
    drives the background thread (0, the default, starts none); drills
    call :meth:`tick`."""

    def __init__(self, group: ReplicaGroup, *,
                 period_s: float | None = None, sample_rows: int = 128,
                 seed: int = 0):
        self.group = group
        self.period_s = C.anti_entropy_s() if period_s is None \
            else float(period_s)
        self.sample_rows = int(sample_rows)
        self._rng = np.random.default_rng(int(seed))
        self.audits = 0
        self.divergences = 0
        self.repairs = 0
        self.last_repair_ms = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: the background audit's error, re-raised by the next tick
        self.error: BaseException | None = None
        group.anti_entropy = self

    def tick(self) -> dict:
        """One audit round over every follower; a divergent follower is
        quarantined, re-shipped and (clean on the re-audit) re-admitted.
        -> the round's receipt."""
        err, self.error = self.error, None
        if err is not None:
            raise err
        g = self.group
        out = []
        with g._pump_lock:
            for f in g.followers:
                r = self._audit_one(f)
                self.audits += 1
                _OBS_AUDITS.inc()
                if r["diverged"]:
                    self.divergences += 1
                    self._quarantine(f, r)
                    r["repair"] = self._repair(f)
                out.append(r)
        return {"followers": out,
                "quarantined": sum(1 for f in g.followers if f.quarantined)}

    def unrepaired(self) -> int:
        """Divergent followers still quarantined after their repair: the
        drill's ``diverged_followers_unrepaired``."""
        return sum(1 for f in self.group.followers if f.quarantined)

    # -- the audit -----------------------------------------------------------

    def _audit_one(self, f: Follower) -> dict:
        g = self.group
        f.pump()
        tok = g.quorum_token()
        t = f.tailer
        r: dict = {"follower": f.idx, "diverged": False,
                   "watermark_ok": None, "seg_crc_ok": None,
                   "pages_ok": None}
        fresh = f.caught_up and t.covers(*tok)
        r["watermark_ok"] = bool(fresh)
        if t._cur is not None and t._off > 0:
            try:
                want = J.crc_of_range(t._cur, 0, t._off)
            except OSError:
                want = None  # the segment was swept mid-audit: next round
            if want is not None:
                ok = t.seg_crc == want
                r["seg_crc_ok"] = bool(ok)
                r["diverged"] |= not ok
        if fresh and g.quorum_token() == tok:
            # the frontier held across the compare: a mismatch is not lag
            ok = self._pages_equal(f, full=False)
            r["pages_ok"] = bool(ok)
            r["diverged"] |= not ok
        return r

    def _pages_equal(self, f: Follower, *, full: bool) -> bool:
        """The pool compare on the device: the same verdict as the
        reference's host compare, without copying either pool to the
        host."""
        pp = self.group.plane.cluster.dsm.pool
        fp = f.cluster.dsm.pool
        if pp.shape != fp.shape:
            return False
        n = pp.shape[0]
        k = self.sample_rows
        if full or not k or k >= n:
            return bool(torch.equal(pp, fp))
        rows = torch.as_tensor(np.unique(self._rng.integers(0, n, k)),
                               device=pp.device)
        return bool(torch.equal(pp[rows], fp[rows]))

    # -- quarantine / repair -------------------------------------------------

    def _quarantine(self, f: Follower, r: dict) -> None:
        f.quarantined = True
        _OBS_QUARANTINES.inc()
        obs.record_event("repl.quarantine", follower=f.idx,
                         watermark_ok=bool(r["watermark_ok"]),
                         seg_crc_ok=r["seg_crc_ok"] is not False,
                         pages_ok=r["pages_ok"] is not False)

    def _repair(self, f: Follower) -> dict:
        """Re-ship the follower through bootstrap and the tail, re-audit
        with a full compare, re-admit when clean.  -> ``{"ok",
        "catchup_ms"}``."""
        t0 = time.perf_counter()
        with self.group._shared_base():
            f._bootstrap()
            f.pump()
        ok = f.caught_up and self._pages_equal(f, full=True)
        ms = (time.perf_counter() - t0) * 1e3
        self.last_repair_ms = round(ms, 1)
        if ok:
            f.quarantined = False
            self.repairs += 1
            _OBS_REPAIRS.inc()
        obs.record_event("repl.repair", follower=f.idx, ok=bool(ok),
                         catchup_ms=self.last_repair_ms)
        return {"ok": bool(ok), "catchup_ms": self.last_repair_ms}

    # -- background cadence --------------------------------------------------

    def start(self) -> None:
        """Background audits every ``period_s`` (no thread at 0, the
        default).  An error stops the thread and is re-raised by the next
        :meth:`tick`."""
        if self.period_s <= 0 or self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                if self._stop.wait(self.period_s):
                    return
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — kept for the caller
                    self.error = e
                    obs.record_event("repl.anti_entropy_error",
                                     error=repr(e))
                    return

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="sherman-anti-entropy")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
