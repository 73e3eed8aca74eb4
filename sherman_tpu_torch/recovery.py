"""Recovery plane — checkpoint chains + op journal + targeted repair (the
port's copy of ``sherman_tpu/recovery.py``).

Three primitives, coordinated so that recovery time scales with the
*damage*, not the pool:

- **incremental checkpoints** (``utils/checkpoint.checkpoint_delta``):
  cheap frequent deltas of only the pages written since the previous
  chain link (the DSM's dirty tracking), chained by the (nonce, seq,
  crc) epochs with per-array CRCs;
- the **write-ahead op journal** (``utils/journal.py``): one CRC-framed
  batch record per acknowledged engine write op, fsync'd before the
  ack, so ``restore chain + replay journal`` loses zero acknowledged
  ops (RPO 0);
- **targeted repair**: degraded mode's real exit — restore only the
  quarantined/violating pages from the chain, re-certify with a scrub
  pass, exit degraded, and catch the repaired pages up by replaying the
  journal.  Damage that a local repair cannot mend fails TYPED
  (:class:`TargetedRepairFailed`) and the caller falls back to the
  full-restore path — never a silently wrong pool.

On-disk layout under one recovery directory, the reference's single-host
names byte for byte (a directory written by either package recovers in
the other)::

    base.npz                     full checkpoint (chain link 0)
    delta-<cid>-000001.npz ...   delta links, in order
    journal-<cid>-000001.wal ... op journal segments (segment k holds
                                 the ops acknowledged after chain link k)

``<cid>`` is the chain id (the base epoch's random nonce), so artifacts
of a superseded chain can never be mistaken for the live one: after a
crash + recover, the plane re-bases (new cid) and stale files are both
ignored by discovery and swept.

The crash contract, window by window:

- crash before a journal append completes: the op was never acked; the
  torn tail is truncated at replay;
- crash after append, before the engine returns: the op replays — "ack
  may lag apply" (at-least-once), never the reverse;
- crash mid-checkpoint: ``_savez_atomic`` leaves the previous artifact
  intact, the tmp orphan is swept at the next save;
- crash between a checkpoint and its journal rotation: the old segment
  overlaps the new link; in-order replay is convergent (upsert/delete
  idempotency), so replaying it is correct, just redundant.

Observability: ``recovery.recovers``, ``recovery.targeted_repairs``
(and ``_failures``), ``recovery.pages_repaired``,
``recovery.stale_page_repairs`` and ``recovery.resurrected_keys`` count
the plane's work; the ``recovery.rpo_ops`` and ``recovery.rto_ms`` gauges
are the drills' to set (``chip_smoke.py`` phase 21).  Every base, delta,
recover and repair step is a ``recovery.*`` flight event, and the chain's
on-disk bytes are the memory accountant's ``host_checkpoints_bytes``.

Not here: the reference's per-host chain ownership (``hosts > 1``, the
``-h<host>-`` namespaces and ``recover_union``: the multihost service
plane, ROADMAP.md item 7c-ii, refused with :class:`NotPortedError`).

With a value heap, ``recover`` attaches a ``ValueHeap`` to the rebuilt
engine and rebuilds its allocator from the restored region before the
replay; ``targeted_repair`` restarts the hot-key tier cold.
"""

from __future__ import annotations

import glob
import os
import time
import weakref

import numpy as np

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import NotPortedError, ShermanError, StateError
from sherman_tpu_torch.utils import checkpoint as CK
from sherman_tpu_torch.utils import journal as J

_BASE = "base.npz"

_OBS_RPO = obs.gauge("recovery.rpo_ops")
_OBS_RTO = obs.gauge("recovery.rto_ms")
_OBS_RECOVERS = obs.counter("recovery.recovers")
_OBS_REPAIRS = obs.counter("recovery.targeted_repairs")
_OBS_REPAIR_FAILS = obs.counter("recovery.targeted_repair_failures")
_OBS_PAGES_REPAIRED = obs.counter("recovery.pages_repaired")
_OBS_STALE_REPAIRS = obs.counter("recovery.stale_page_repairs")
_OBS_RESURRECTED = obs.counter("recovery.resurrected_keys")


class TargetedRepairFailed(ShermanError, RuntimeError):
    """Chain-based page repair could not re-certify the pool (structure
    changed since the chain tip, or damage beyond the repaired set):
    the engine STAYS degraded and the caller falls back to a full
    restore (``RecoveryPlane.recover``)."""


def _cid_of(epoch) -> str:
    return f"{int(np.asarray(epoch).ravel()[0]) & 0xFFFFFFFF:08x}"


def _refuse_hosts(host_id: int, hosts: int) -> None:
    if int(hosts) > 1:
        raise NotPortedError(
            f"hosts={hosts}: per-host chain ownership is the multihost "
            "service plane, which the port does not have yet (ROADMAP.md "
            "item 7c-ii)")
    if int(host_id) != 0:
        raise StateError(f"host_id={host_id} outside [0, hosts={hosts})")


class RecoveryPlane:
    """Durability coordinator over one (cluster, tree, engine) triple.

    Lifecycle: construct -> :meth:`checkpoint_base` (starts the chain
    and the journal; from here every engine write op is journaled) ->
    periodic :meth:`checkpoint_delta` -> on crash,
    :meth:`RecoveryPlane.recover`; on data-plane corruption caught by
    the scrubber, :meth:`targeted_repair`.
    """

    def __init__(self, cluster, tree, eng, directory: str,
                 journal_sync: bool = True,
                 group_commit_ms: float = 0.0,
                 ack_carry: int = 65536,
                 host_id: int = 0, hosts: int = 1):
        _refuse_hosts(host_id, hosts)
        #: exactly-once ack entries carried across journal rotations
        #: (most-recent wins; bounds the re-forwarded window)
        self.ack_carry = int(ack_carry)
        self.cluster = cluster
        self.tree = tree
        self.eng = eng
        self.dir = directory
        self.journal_sync = bool(journal_sync)
        #: re-base sweep gate (``recover(sweep_stale=False)`` keeps a
        #: superseded chain's artifacts on disk)
        self.sweep_stale = True
        # bounded-delay journal group commit (utils/journal.py): acks
        # still gate on a covering fsync (RPO 0 by construction), but
        # concurrent ops coalesce into one fsync per window
        self.group_commit_ms = float(group_commit_ms)
        os.makedirs(directory, exist_ok=True)
        self.base_path = os.path.join(directory, _BASE)
        self.cid: str | None = None
        self.delta_paths: list[str] = []
        self._tip_epoch = None
        self._segment = 0
        #: exactly-once window reconstructed by :meth:`recover` from the
        #: journal's J_ACK records: {(tenant, rid): (op_kind, ok[,
        #: handles])}, in ack order; a fresh front door adopts it with
        #: ``ShermanServer.seed_dedup``, which rejournals it
        self.dedup_window: dict = {}

        # the memory accountant's host source: the chain's on-disk bytes
        # (base + deltas + journals) as ``device.host_checkpoints_bytes``,
        # weakref-bound so a dropped plane reads 0
        def _chain_bytes(r=weakref.ref(self)) -> int:
            p = r()
            if p is None:
                return 0
            total = 0
            for f in glob.glob(os.path.join(p.dir, "*")):
                try:
                    total += os.path.getsize(f)
                except OSError:
                    pass  # artifact swept mid-scan
            return total

        obs.get_accountant().register("checkpoints", _chain_bytes,
                                      kind="host")

    # -- artifact naming ------------------------------------------------------

    def _delta_path(self, k: int) -> str:
        return os.path.join(self.dir, f"delta-{self.cid}-{k:06d}.npz")

    def _journal_path(self, k: int) -> str:
        return os.path.join(self.dir, f"journal-{self.cid}-{k:06d}.wal")

    @staticmethod
    def _discover(directory: str):
        """-> (cid, delta_paths, journal_paths) of the on-disk chain
        anchored at the base; stale-cid artifacts are ignored."""
        base = os.path.join(directory, _BASE)
        if not os.path.exists(base):
            raise FileNotFoundError(
                f"{directory}: no {_BASE} — nothing to recover")
        epoch = CK._load_arrays(base, keys=("epoch",)).get("epoch")
        if epoch is None:
            raise CK.CheckpointCorruptError(
                f"{base}: base carries no epoch (pre-recovery-plane "
                "artifact) — cannot anchor a chain")
        cid = _cid_of(epoch)
        deltas = sorted(glob.glob(os.path.join(directory,
                                               f"delta-{cid}-*.npz")))
        journals = sorted(glob.glob(os.path.join(directory,
                                                 f"journal-{cid}-*.wal")))
        return cid, deltas, journals

    def _sweep_stale(self) -> int:
        """Remove artifacts whose cid is not the live chain's (a
        superseded chain after a re-base).  Host-tagged chains of the
        reference's multihost plane in the same directory are never
        touched."""
        n = 0
        for f in glob.glob(os.path.join(self.dir, "delta-*.npz")) \
                + glob.glob(os.path.join(self.dir, "journal-*.wal")):
            name = os.path.basename(f)
            if name.split("-")[1].startswith("h"):
                # a host tag (a cid is 8 hex digits — it can never
                # start with 'h')
                continue
            if self.cid is not None and f"-{self.cid}-" in name:
                continue
            try:
                os.unlink(f)
                n += 1
            except OSError:
                pass
        return n

    # -- saving ---------------------------------------------------------------

    def _rotate_journal(self, k: int) -> None:
        """Start journal segment ``k`` (ops after chain link ``k``).
        The previous segment's J_ACK records are NOT state (no
        checkpoint captures them), so they are carried FORWARD into the
        fresh segment — the exactly-once window stays reconstructible
        across any number of rotations, bounded by ``ack_carry``
        most-recent entries.

        Rotation does NOT delete retired segments — that is
        :meth:`_sweep_retired_segments`, called only AFTER the chain
        artifact covering their ops is durable.  Unlinking here would
        open a crash window (rotate, crash before the save lands: the
        retired ops exist nowhere on disk), while leaving an overlapping
        segment merely replays redundantly — convergent by the module
        contract."""
        old = self.eng.journal
        fresh = J.Journal(
            self._journal_path(k), sync=self.journal_sync,
            group_commit_ms=self.group_commit_ms)
        # attach BEFORE closing the old segment: a live dispatcher's
        # appends race this rotation, and an append must always find an
        # OPEN journal (old until the swap, fresh after)
        self.eng.attach_journal(fresh)
        self._segment = k
        if old is not None:
            old.close()
            try:
                carry = J.read_acks(old.path)
                acks = list(carry.values())[-self.ack_carry:] \
                    if self.ack_carry > 0 else []
                if acks:
                    fresh.append_acks(acks)
            except (OSError, J.JournalCorruptError):
                pass  # an unreadable retiring segment loses only dedup
                # coverage (retries re-apply idempotently), never state

    def _sweep_retired_segments(self) -> None:
        """Delete every journal segment other than the live one — only
        once the chain artifact capturing their ops is DURABLE (after a
        base/delta save, never at rotation time)."""
        for f in glob.glob(os.path.join(self.dir,
                                        f"journal-{self.cid}-*.wal")):
            if f != self._journal_path(self._segment):
                try:
                    os.unlink(f)
                except OSError:
                    pass

    def journal_frontier(self) -> tuple[str, int]:
        """The durable journal frontier ``(live segment path, size)``.
        Appends fsync before returning, so a frontier captured AFTER an
        engine op returned bounds every byte of that op's records."""
        if self.cid is None:
            raise StateError("no chain yet: checkpoint_base() first")
        path = self._journal_path(self._segment)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        return (path, int(size))

    def checkpoint_base(self) -> dict:
        """Full checkpoint -> new chain (new cid); sweeps the superseded
        chain's artifacts and starts journal segment 1.  Needs a quiesced
        writer stream (the rotation needs the new chain id, which only
        exists after the save)."""
        self.eng.flush_parents()  # deferred parent entries are state
        epoch = CK.checkpoint(self.cluster, self.base_path)
        self.cid = _cid_of(epoch)
        self._tip_epoch = epoch
        self.delta_paths = []
        if self.sweep_stale:
            self._sweep_stale()
        self._rotate_journal(1)
        # the base save above is already durable: retired segments of
        # this chain (none on a fresh chain) can go now
        self._sweep_retired_segments()
        obs.record_event("recovery.checkpoint_base", cid=self.cid,
                         bytes=os.path.getsize(self.base_path))
        return {"path": self.base_path, "cid": self.cid,
                "bytes": os.path.getsize(self.base_path)}

    def checkpoint_delta(self) -> dict:
        """Delta link: journal rotation, THEN only the pages written
        since the previous link.  Falls back to :meth:`checkpoint_base`
        when no chain exists yet.

        Rotation runs FIRST: an op racing this checkpoint then lands in
        the NEW segment and replays convergently over the link
        (redundant, never wrong).  Rotating after the snapshot instead
        would let a racing op apply after the snapshot yet journal into
        the RETIRING segment — silent RPO > 0 once that segment is
        swept.  The retired segment is deleted only AFTER the delta
        artifact is durable: a crash in between leaves BOTH segments on
        disk, and recover() replays the overlap convergently."""
        if self.cid is None:
            return self.checkpoint_base()
        k = len(self.delta_paths) + 1
        self._rotate_journal(k + 1)
        self.eng.flush_parents()
        path = self._delta_path(k)
        info = CK.checkpoint_delta(self.cluster, path,
                                   parent_epoch=self._tip_epoch)
        self.delta_paths.append(path)
        self._tip_epoch = info["epoch"]
        # the delta (capturing every op in the retired segment) is
        # durable: NOW the retired segment can go
        self._sweep_retired_segments()
        info["path"] = path
        obs.record_event("recovery.checkpoint_delta", cid=self.cid,
                         link=k, pages=int(info.get("pages", -1)))
        return info

    def close(self) -> None:
        if self.eng.journal is not None:
            self.eng.journal.close()
            self.eng.attach_journal(None)

    # -- full recovery --------------------------------------------------------

    @classmethod
    def recover(cls, directory: str, device: str = "cuda",
                batch_per_node: int = 512, tcfg=None,
                journal_sync: bool = True, attach_router: bool = True,
                group_commit_ms: float = 0.0, host_id: int = 0,
                hosts: int = 1, sweep_stale: bool = True):
        """Rebuild a serving engine on ``device`` from the on-disk chain
        and journal.

        restore(base + deltas) -> replay journal segments in order ->
        re-base (a fresh chain capturing the replayed state).  Returns
        (plane, cluster, tree, eng, receipt) with the receipt carrying
        the per-phase wall times and replay counts.
        ``sweep_stale=False`` defers the re-base's stale-chain sweep."""
        from sherman_tpu_torch.models.batched import BatchedEngine
        from sherman_tpu_torch.models.btree import Tree

        _refuse_hosts(host_id, hosts)
        t0 = time.perf_counter()
        cid, deltas, journals = cls._discover(directory)
        cluster = CK.restore_chain(os.path.join(directory, _BASE), deltas,
                                   device=device)
        t_restore = time.perf_counter()
        tree = Tree(cluster)
        eng = BatchedEngine(tree, batch_per_node=batch_per_node, tcfg=tcfg)
        if attach_router:
            eng.attach_router()
        # the value heap: re-attach it and rebuild its allocator from the
        # restored region BEFORE the replay (heap records rewrite slabs
        # at their recorded addresses through the attached heap)
        if cluster.cfg.heap_pages_per_node > 0:
            from sherman_tpu_torch.models.value_heap import ValueHeap
            ValueHeap(eng).rebuild()
        replay_stats = {"records": 0, "rows": 0, "upserts": 0,
                        "deletes": 0, "segments": 0}
        # replay ALL live-chain segments ascending: in-order replay is
        # convergent, so a segment overlapping its checkpoint (crash
        # between save and rotation) is redundant, never wrong.  J_ACK
        # records ride along into the ack sink (later acks override
        # earlier, the front door's own last-writer window semantics).
        acks: list = []
        for seg in journals:
            st = J.replay(seg, eng, ack_sink=acks)
            for k2, v in st.items():
                replay_stats[k2] = replay_stats.get(k2, 0) + v
            replay_stats["segments"] += 1
        t_replay = time.perf_counter()
        plane = cls(cluster, tree, eng, directory,
                    journal_sync=journal_sync,
                    group_commit_ms=group_commit_ms)
        plane.sweep_stale = bool(sweep_stale)
        for rid, tenant, op, ok, *prov in acks:
            plane.dedup_window[(tenant, rid)] = (op, ok, *prov)
        plane.checkpoint_base()  # re-base: fresh chain, stale cid swept
        t_end = time.perf_counter()
        _OBS_RECOVERS.inc()
        obs.record_event(
            "recovery.recover", cid=cid, deltas=len(deltas),
            host=int(host_id), segments=replay_stats["segments"],
            replayed_records=replay_stats["records"],
            total_ms=round((t_end - t0) * 1e3, 1))
        receipt = {
            "chain": {"cid": cid, "deltas": len(deltas)},
            "restore_ms": round((t_restore - t0) * 1e3, 1),
            "replay_ms": round((t_replay - t_restore) * 1e3, 1),
            "rebase_ms": round((t_end - t_replay) * 1e3, 1),
            "total_ms": round((t_end - t0) * 1e3, 1),
            "replay": replay_stats,
        }
        return plane, cluster, tree, eng, receipt

    @classmethod
    def recover_union(cls, directory: str, hosts: int, **kw):
        """The reference's union recovery over every host's chain: the
        multihost service plane (ROADMAP.md item 7c-ii), not ported yet."""
        raise NotPortedError(
            "recover_union recovers the per-host chains of the multihost "
            "service plane, which the port does not have yet (ROADMAP.md "
            "item 7c-ii)")

    # -- targeted repair (degraded mode's real exit) --------------------------

    def targeted_repair(self, scrubber=None, addrs=(),
                        verify_structure: bool = True) -> dict:
        """Restore only the damaged pages from the chain, re-certify,
        exit degraded, replay the journal to catch the repaired pages
        up.  ``addrs``: extra packed page addresses beyond the
        scrubber's flagged set.  Raises :class:`TargetedRepairFailed`
        (engine stays degraded) when the scrub pass does not come back
        clean — the caller falls back to :meth:`recover`.
        """
        from sherman_tpu_torch.models.validate import scrub_pass
        from sherman_tpu_torch.ops import bits
        from sherman_tpu_torch.parallel import dsm as D

        if self.cid is None:
            raise StateError("no chain: checkpoint_base() first")
        t0 = time.perf_counter()
        damaged = sorted(set(int(a) for a in addrs)
                         | (set(scrubber.flagged) if scrubber is not None
                            else set()))
        if not damaged:
            return {"pages": 0, "ok": True, "repair_ms": 0.0}
        obs.record_event("recovery.targeted_repair_begin",
                         pages=len(damaged),
                         addrs=[hex(a) for a in damaged[:16]])
        P = self.cluster.cfg.pages_per_node
        rows = [bits.addr_node(a) * P + bits.addr_page(a) for a in damaged]
        pages = CK.read_chain_rows(self.base_path, self.delta_paths, rows)
        # PAGE-VERSION-AWARE repair: the chain's content is only valid
        # for a page whose live version still matches the chain tip.  A
        # page legally REWRITTEN since the tip (split, reclaim-reuse: its
        # front version moved past the chain's; min of the live pair,
        # because torn-version damage only raises one half) or ALLOCATED
        # after it (chain front version 0) must not be blind-restored —
        # resurrecting a pre-split image beside its live sibling corrupts
        # the chain shape in a way the local scrub pass cannot even see.
        # Such pages are repaired IN PLACE instead: heal the version
        # pair, clear the violating slots, and re-upsert any chain-tip
        # key the damage dropped — post-tip ops replay from the journal
        # afterwards, so the convergence argument is recover()'s own.
        live = self.tree.dsm.read_pages(damaged)
        restore_idx, stale_idx = [], []
        for i in range(len(damaged)):
            chain_fv = int(pages[i][C.W_FRONT_VER])
            live_ver = min(int(live[i][C.W_FRONT_VER]),
                           int(live[i][C.W_REAR_VER]))
            # the version test alone only defends against RAISING damage
            # (a zeroed/lowered version half on a since-split page would
            # read as restorable); require the page's structural identity
            # — level, fences, sibling — to still match the chain image.
            # Every legal structural rewrite changes these WITH a version
            # bump, so a mismatch means the chain image is for another
            # incarnation of the page.  (Damage to the header words
            # themselves also lands here: the in-place patch cannot mend
            # headers, so the scrub re-certify fails typed into the
            # full-restore fallback.)
            same_identity = all(
                int(pages[i][w]) == int(live[i][w])
                for w in (C.W_LEVEL, C.W_LOW_HI, C.W_LOW_LO,
                          C.W_HIGH_HI, C.W_HIGH_LO, C.W_SIBLING))
            if chain_fv != 0 and live_ver <= chain_fv and same_identity:
                restore_idx.append(i)
            else:
                stale_idx.append(i)
        write_rows = [
            {"op": D.OP_WRITE, "addr": damaged[i], "woff": 0,
             "nw": pages.shape[1], "payload": pages[i]}
            for i in restore_idx]
        candidates: dict[int, int] = {}
        for i in stale_idx:
            patched = self._patch_stale_page(live[i])
            if patched is not None:
                write_rows.append(
                    {"op": D.OP_WRITE, "addr": damaged[i], "woff": 0,
                     "nw": patched.shape[0], "payload": patched})
            # chain-tip content of EVERY stale page feeds the resurrection
            # candidate set: a cleared slot's pre-tip key may now live
            # under any damaged page's old range
            candidates.update(self._chain_leaf_entries(pages[i]))
        # raw DSM page writes: unaffected by the scrubber's quarantine
        # locks (those fence TREE writers), marked dirty for the next
        # delta at the host-step boundary
        if write_rows:
            self.tree.dsm.write_rows(write_rows)
        _OBS_PAGES_REPAIRED.inc(len(damaged))
        if stale_idx:
            _OBS_STALE_REPAIRS.inc(len(stale_idx))
        # re-certify BEFORE exiting degraded: the whole pool must scrub
        # clean — a repair that only moved the damage fails typed here
        res = scrub_pass(self.tree)
        if res["violations"]:
            _OBS_REPAIR_FAILS.inc()
            obs.record_event("recovery.targeted_repair_failed",
                             pages=len(damaged),
                             violations=int(res["violations"]))
            raise TargetedRepairFailed(
                f"scrub still reports {res['violations']} violating "
                f"page(s) after repairing {len(damaged)} "
                f"({res['classes']}); falling back to full recover() "
                "is the documented exit")
        if scrubber is not None:
            scrubber.release_quarantine()
        # the hot-key tier is volatile across a repair: the restored
        # pages' entry versions rolled back to the chain tip's (a state
        # that cached entries may match by chance), so it restarts cold
        if self.eng.leaf_cache is not None:
            self.eng.leaf_cache.flush()
        self.eng.exit_degraded()
        # content catch-up: ops acknowledged since the chain tip live in
        # the journal; replaying them (journal detached — replay must
        # not re-journal itself) rebuilds the repaired pages' lost
        # writes; untouched pages just re-apply their own values
        seg, self.eng.journal = self.eng.journal, None
        resurrected = 0
        try:
            if seg is not None:
                seg.close()
            # resurrection pass for stale-chain (version-ahead) pages: a
            # cleared slot may have dropped a PRE-tip key that no journal
            # record will replay; re-upsert every chain-tip candidate
            # absent from the live tree NOW.  Runs with the journal
            # DETACHED and BEFORE the replay: a journaled resurrection
            # would replay the stale tip value AFTER the segment's newer
            # records, while in this order post-tip ops win.  A key
            # deleted post-tip comes back briefly and the replayed delete
            # removes it again.
            if candidates:
                ck = np.asarray(sorted(candidates), np.uint64)
                _, found = self.eng.search(ck)
                miss = ck[~found]
                if miss.size:
                    st = self.eng.insert(miss, np.asarray(
                        [candidates[int(k)] for k in miss], np.uint64))
                    # a resurrection that could not apply (its leaf's lock
                    # held by a live lease past the retry budget) is a
                    # LOST pre-tip key: re-enter degraded and fail typed
                    if st["lock_timeouts"]:
                        _OBS_REPAIR_FAILS.inc()
                        self.eng.enter_degraded(
                            "targeted repair: resurrection upserts "
                            f"lock-timed-out on {st['lock_timeouts']} "
                            "key(s)")
                        raise TargetedRepairFailed(
                            f"{st['lock_timeouts']} resurrection "
                            "key(s) could not apply (page lock held by "
                            "a live lease past the retry budget); "
                            "falling back to full recover() is the "
                            "documented exit")
                    resurrected = int(miss.size)
                    _OBS_RESURRECTED.inc(resurrected)
            if os.path.exists(self._journal_path(self._segment)):
                acks: list = []
                replay_stats = J.replay(
                    self._journal_path(self._segment), self.eng,
                    ack_sink=acks)
                for rid, tenant, op, ok, *prov in acks:
                    self.dedup_window[(tenant, rid)] = (op, ok, *prov)
            else:
                replay_stats = {"records": 0, "rows": 0}
        finally:
            # reopen the segment for appends (replay only truncated torn
            # tails; the records themselves stay — recovery replays them
            # again idempotently if we crash later)
            self.eng.attach_journal(J.Journal(
                self._journal_path(self._segment),
                sync=self.journal_sync,
                group_commit_ms=self.group_commit_ms))
        out = {"pages": len(damaged), "ok": True,
               "stale_pages": len(stale_idx),
               "resurrected": resurrected,
               "replay": replay_stats,
               "repair_ms": round((time.perf_counter() - t0) * 1e3, 1)}
        if verify_structure:
            from sherman_tpu_torch.models.validate import \
                check_structure_device
            out["structure"] = check_structure_device(self.tree)
        _OBS_REPAIRS.inc()
        obs.record_event("recovery.targeted_repair", pages=len(damaged),
                         stale_pages=len(stale_idx),
                         repair_ms=out["repair_ms"],
                         replayed_records=int(
                             out["replay"].get("records", 0)))
        return out

    # -- stale-page (version-ahead) repair helpers ----------------------------

    @staticmethod
    def _patch_stale_page(live_pg: np.ndarray) -> np.ndarray | None:
        """In-place repair image for a LEAF page whose live version is
        ahead of the chain tip: heal a torn front/rear page-version pair
        (both := the max — a rewrite never lowers the version) and clear
        every violating slot (torn fver/rver halves, live slots outside
        the page fence).  Internal pages return ``None`` — entry order
        cannot be locally reconstructed, so their damage is left for the
        scrub re-certify to judge (typed fallback when it does not come
        back clean)."""
        from sherman_tpu_torch.ops import bits as _b
        pg = np.array(live_pg, np.int32)
        if int(pg[C.W_LEVEL]) != 0:
            return None
        ver = max(int(pg[C.W_FRONT_VER]), int(pg[C.W_REAR_VER]))
        pg[C.W_FRONT_VER] = pg[C.W_REAR_VER] = ver
        LC = C.LEAF_CAP
        vw = pg[C.L_VER_W:C.L_VER_W + LC].view(np.uint32)
        fver = (vw >> np.uint32(16)) & np.uint32(0xFFFF)
        rver = vw & np.uint32(0xFFFF)
        torn = fver != rver
        # live-slot fence containment (uint64 keys from the hi/lo pairs)
        skeys = _b.pairs_to_keys(pg[C.L_KHI_W:C.L_KHI_W + LC],
                                 pg[C.L_KLO_W:C.L_KLO_W + LC])
        lo = _b.pair_to_key(int(pg[C.W_LOW_HI]), int(pg[C.W_LOW_LO]))
        hi = _b.pair_to_key(int(pg[C.W_HIGH_HI]), int(pg[C.W_HIGH_LO]))
        s_live = (fver == rver) & (fver != 0)
        oob = s_live & ((skeys < np.uint64(lo)) | (skeys >= np.uint64(hi)))
        pg[C.L_VER_W:C.L_VER_W + LC][torn | oob] = 0
        return pg

    @staticmethod
    def _chain_leaf_entries(chain_pg: np.ndarray) -> dict[int, int]:
        """{key: value} of every live slot of a chain-tip LEAF image —
        the resurrection candidate pool for stale-page repair.  Empty for
        dead/internal chain rows (a page allocated after the tip has no
        chain content to resurrect)."""
        if int(chain_pg[C.W_FRONT_VER]) == 0 \
                or int(chain_pg[C.W_LEVEL]) != 0:
            return {}
        from sherman_tpu_torch.ops import layout
        return {int(k): int(v)
                for k, v, _ in layout.np_leaf_entries(
                    np.asarray(chain_pg, np.int32))}
