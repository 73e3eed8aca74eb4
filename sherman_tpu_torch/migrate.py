"""Online elastic reshard: grow or shrink the pool under traffic (the port's
counterpart of ``sherman_tpu/migrate.py``).

:mod:`sherman_tpu_torch.utils.reshard` rewrites an N-node pool onto M nodes
offline, on a checkpoint, with the cluster down for the whole transform.
A :class:`Migrator` makes that transform online: it walks the live pool in
bounded batches while the engine keeps serving, so the downtime of an N->M
resize shrinks to one brief quiesced cutover whose work is proportional to
the pages written since their copy.

The protocol, batch by batch (the scrubber's quarantine pattern):

1. **lock**: the batch's page lock words are CAS-acquired under the
   migrator's own live lease (``cluster.register_client``), one host step
   a word, so no writer touches a page mid-copy: device inserts that lose
   the race report ``ST_LOCKED`` and retry through the engine's bounded
   lock-retry budget (typed ``ST_LOCK_TIMEOUT`` at exhaustion); host
   writers spin as against the scrubber's quarantine.  A word held by a
   live foreign lease is skipped this batch (``migrate.lock_conflicts``)
   and retried later; a dead holder is revoked through the one revocation
   policy (``Tree._try_revoke_lease``).
2. **copy**: the locked pages are read in one batched host read and staged
   on the host verbatim (address rewriting waits for the cutover, so the
   staged bytes stay comparable with the live pool).
3. **journal**: the batch is persisted as a CRC-tagged artifact
   (``migbatch-<mid>-<seq>.npz``, tmp + fsync + replace) before the locks
   release: a crash keeps every completed batch, and :meth:`Migrator.resume`
   reloads them, folds every staged row into the re-verify queue (the
   crash's journal replay may have rewritten anything) and goes on.
4. **release + invalidate**: the locks are freed in one step and the
   hot-key tier scatter-invalidates the batch's pages.

Writes after a page's copy are caught by the DSM's dirty tracking: every
batch folds ``dirty_rows()`` into a conservative re-copy set, and a
registered dirty sink (``DSM.add_dirty_sink``) hands the migrator the rows
a checkpoint is about to clear.  :meth:`Migrator.finish` re-stages the
dirtied pages in a quiesced window, certifies the staged image against the
live pool row by row (one ``gather_pages`` launch over every live row),
and feeds it through ``utils.reshard.reshard_arrays``, the transform the
offline CLI runs, so the emitted M-node checkpoint is bit-identical to the
offline reshard of the final state.

Observability: the ``migrate.`` pull collector (pages_moved, batches,
retries, lock_conflicts, resume_count, epoch, ...), the events
``migrate.begin``/``batch``/``resume``/``cutover`` and a black-box dump on
abort.  Knob: ``SHERMAN_MIGRATE_BATCH_PAGES`` (pages locked and copied a
batch).  One process drives the pool: a multihost DSM is refused.
"""

from __future__ import annotations

import glob
import os
import time
import weakref

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import (ConfigError,
                                      MultiprocessUnsupportedError,
                                      ShermanError, StateError)
from sherman_tpu_torch.obs import recorder as FR
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import dsm as D
from sherman_tpu_torch.utils import checkpoint as CK
from sherman_tpu_torch.utils import reshard as RS

# CAS attempts a lock word before its pages defer to a later batch (the
# scrubber's quarantine bound: a legitimately held lock drains in a step
# or two)
_LOCK_TRIES = 8
# the cutover's convergence budget: mismatches still appearing after this
# many repair rounds mean a writer (or an unreleasable lock) is racing the
# cutover: abort typed, never emit a pool that lost writes
_FINISH_VERIFY_ROUNDS = 3


def _batch_pages_default() -> int:
    """``SHERMAN_MIGRATE_BATCH_PAGES``: pages locked and copied a batch
    (default 256).  Smaller batches bound the lock-hold window (the read
    p99 spike); larger ones finish the copy in fewer round trips."""
    v = os.environ.get("SHERMAN_MIGRATE_BATCH_PAGES", "").strip()
    if not v:
        return 256
    try:
        n = int(v)
    except ValueError:
        raise ConfigError(
            f"SHERMAN_MIGRATE_BATCH_PAGES={v!r}: want a positive int")
    if n <= 0:
        raise ConfigError(f"SHERMAN_MIGRATE_BATCH_PAGES={n}: want > 0")
    return n


class MigrationAborted(ShermanError, RuntimeError):
    """Typed migration abort: the engine degraded mid-migration, the
    cutover could not quiesce, or the migration was abandoned.  The source
    pool is untouched (the migrator only holds lock words and writes
    artifacts): serving goes on, and the artifacts stay for a later
    :meth:`Migrator.resume` or the next :meth:`Migrator.start`'s sweep."""


class Migrator:
    """Background page migration of a live N-node pool toward M nodes.

    Lifecycle: construct -> :meth:`start` -> :meth:`step` between engine
    steps until :attr:`copied_all` -> :meth:`finish` (the quiesced cutover,
    emits the M-node checkpoint) -> restore that checkpoint at M nodes.
    After a crash: ``RecoveryPlane.recover`` the source, then
    :meth:`resume` and go on; completed batches are re-verified, not
    re-done."""

    def __init__(self, cluster, tree, eng, target_nodes: int,
                 directory: str, *,
                 target_pages_per_node: int | None = None,
                 target_locks_per_node: int | None = None,
                 batch_pages: int | None = None):
        if cluster.dsm.multihost:
            raise MultiprocessUnsupportedError(
                "online migration drives one process per pool: run it "
                "inside a single host context")
        if not 1 <= int(target_nodes) <= C.MAX_MACHINE:
            raise ConfigError(f"target_nodes={target_nodes} out of range")
        self.cluster = cluster
        self.tree = tree
        self.eng = eng
        self.dsm = cluster.host_dsm
        self.cfg = cluster.cfg
        self.target_nodes = int(target_nodes)
        self.target_pages_per_node = target_pages_per_node
        self.target_locks_per_node = target_locks_per_node
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.batch_pages = (batch_pages if batch_pages is not None
                            else _batch_pages_default())
        # the migrator's locks ride its own registered (live) lease, so
        # lease recovery never revokes a mid-copy hold
        self.ctx = cluster.register_client(replicated=True)
        self.mid: str | None = None
        self.seq = 0
        self.started = False
        self.finished = False
        self.aborted: str | None = None
        # the staging store: one flat pool-shaped host array and a staged-
        # row mask (allocated at start/resume); the array IS the cutover
        # image.  _dirt: rows written since their copy (dirty polls and the
        # clear sink), re-staged by finish()'s delta pass.
        self._staged_arr: np.ndarray | None = None
        self._staged_mask: np.ndarray | None = None
        self._pending: list[int] = []
        self._dirt: set[int] = set()
        self._sink = self._on_dirty_clear
        self.pages_moved = 0
        self.batches = 0
        self.retries = 0            # re-staged (dirtied-after-copy) pages
        self.lock_conflicts = 0     # pages deferred: word held by a live lease
        self.resume_count = 0
        self.resume_verified = 0    # staged pages proven clean on resume
        self.recopies_clean = 0     # other re-copies proven clean
        ref = weakref.ref(self)

        def _collect():
            m = ref()
            if m is None:
                return {}
            return {
                "pages_moved": m.pages_moved,
                "batches": m.batches,
                "retries": m.retries,
                "lock_conflicts": m.lock_conflicts,
                "resume_count": m.resume_count,
                "resume_verified": m.resume_verified,
                "recopies_clean": m.recopies_clean,
                "epoch": m.seq,
                "staged_pages": m.staged_pages,
                "dirt_backlog": len(m._dirt),
                "in_progress": int(m.started and not m.finished
                                   and m.aborted is None),
            }

        obs.register_collector("migrate", _collect)

    # -- artifact naming ------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "migrate-manifest.npz")

    def _batch_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"migbatch-{self.mid}-{seq:06d}.npz")

    def _sweep_stale(self) -> int:
        """Remove the batch artifacts of a superseded migration id."""
        n = 0
        for f in glob.glob(os.path.join(self.dir, "migbatch-*.npz")):
            if self.mid is not None \
                    and f"-{self.mid}-" in os.path.basename(f):
                continue
            try:
                os.unlink(f)
                n += 1
            except OSError:
                pass
        return n

    # -- staging store --------------------------------------------------------

    def _ensure_staging(self) -> None:
        if self._staged_arr is None:
            rows = self.cfg.machine_nr * self.cfg.pages_per_node
            self._staged_arr = np.zeros((rows, C.PAGE_WORDS), np.int32)
            self._staged_mask = np.zeros(rows, bool)

    @property
    def staged_pages(self) -> int:
        """Pages with a staged copy (the ``migrate.staged_pages`` gauge)."""
        return int(self._staged_mask.sum()) \
            if self._staged_mask is not None else 0

    def is_staged(self, row: int) -> bool:
        return bool(self._staged_mask is not None
                    and self._staged_mask[int(row)])

    # -- planning -------------------------------------------------------------

    def _live_rows_now(self) -> np.ndarray:
        """The current live rows, by the offline transform's definition
        (``utils.reshard.live_rows``)."""
        cfg = self.cfg
        nxt = np.ones(cfg.machine_nr, np.int64)
        free = []
        for d in self.cluster.directories:
            nxt[d.node_id] = d.allocator.pages_used
            free += [bits.make_addr(d.node_id, p) & 0xFFFFFFFF
                     for p in d.allocator.free_pages_list]
        # only the W_FRONT_VER column crosses to the host
        fv = self.dsm.pool[:, C.W_FRONT_VER].cpu().numpy()
        return RS.live_rows(fv, nxt, np.asarray(sorted(free), np.int64),
                            cfg.pages_per_node, cfg.machine_nr)

    def _refresh_plan(self) -> int:
        """Recompute the pending plan: live rows not yet staged, ascending
        (the same order across resumes).  -> the pending count."""
        rows = self._live_rows_now()
        if self._staged_mask is not None and rows.size:
            rows = rows[~self._staged_mask[rows]]
        self._pending = rows.tolist()
        return len(self._pending)

    # -- dirty tracking -------------------------------------------------------

    def _fold_dirt(self, rows) -> None:
        """Add the staged ones of ``rows`` to the re-copy set."""
        mask = self._staged_mask
        if mask is None or not len(rows):
            return
        rows = np.asarray(rows, np.int64)
        self._dirt.update(rows[mask[rows]].tolist())

    def _on_dirty_clear(self, rows) -> None:
        """The DSM's dirty sink: a checkpoint is about to clear ``rows``;
        their staged ones join the re-copy set, so the clear cannot hide a
        post-copy write from the cutover."""
        self._fold_dirt(rows)

    def _poll_dirt(self) -> None:
        """Fold the DSM's cumulative dirty rows into the re-copy set."""
        if self._staged_mask is not None:
            self._fold_dirt(self.dsm.dirty_rows())

    # -- lifecycle ------------------------------------------------------------

    def _require_active(self) -> None:
        if not self.started:
            raise StateError("migration not started: call start() first")
        if self.finished:
            raise StateError("migration already finished")
        if self.aborted is not None:
            raise MigrationAborted(
                f"migration {self.mid} aborted: {self.aborted}")
        if self.eng.degraded:
            self.abort(f"engine degraded: {self.eng.degraded_reason}")
            raise MigrationAborted(
                f"migration {self.mid} aborted: engine degraded "
                f"({self.eng.degraded_reason})")

    def start(self) -> dict:
        """Begin a new migration: a fresh mid, the manifest persisted, the
        stale artifacts of superseded migrations swept, the plan made."""
        if self.started:
            raise StateError("migration already started")
        if self.eng.degraded:
            raise MigrationAborted(
                "refusing to start a migration on a degraded engine")
        n = self._refresh_plan()
        # advisory capacity check before any work is persisted (the live
        # set can still grow: reshard_arrays checks again at the cutover)
        if self.target_pages_per_node is not None:
            cap = self.target_nodes * (self.target_pages_per_node - 1)
            if n > cap:
                raise ConfigError(
                    f"{n} live pages cannot fit {self.target_nodes} "
                    f"node(s) x {self.target_pages_per_node} pages "
                    "(page 0 per node reserved): raise "
                    "target_pages_per_node before migrating")
        self.mid = f"{int(np.frombuffer(os.urandom(4), np.uint32)[0]):08x}"
        self._sweep_stale()
        man = dict(
            mid=np.frombuffer(self.mid.encode(), np.uint8).copy(),
            target=np.asarray(
                [self.target_nodes, self.target_pages_per_node or 0,
                 self.target_locks_per_node or 0], np.int64),
            src_cfg=np.frombuffer(CK.cfg_to_json(self.cfg), np.uint8),
        )
        man["integrity"] = CK._integrity(man)
        CK._savez_atomic(self._manifest_path(), 0, **man)
        self._ensure_staging()
        self.started = True
        self.cluster.dsm.add_dirty_sink(self._sink)
        obs.record_event("migrate.begin", mid=self.mid,
                         src_nodes=self.cfg.machine_nr,
                         target_nodes=self.target_nodes, live_pages=n)
        return {"mid": self.mid, "live_pages": n}

    def abort(self, reason: str) -> None:
        """Abandon the migration (typed; serving is unaffected).  The black
        box dumps: an abort is where a postmortem starts."""
        if self.aborted is None:
            self.aborted = reason
            obs.counter("migrate.aborts").inc()
            FR.record_event("migrate.abort", mid=self.mid or "",
                            reason=reason)
            FR.auto_dump("migrate_abort")
            self.cluster.dsm.remove_dirty_sink(self._sink)

    @property
    def copied_all(self) -> bool:
        """Every currently live page has a staged copy (call
        :meth:`finish`; later allocations and post-copy writes are the
        cutover's delta pass)."""
        return self.started and not self._pending

    # -- the batch protocol ---------------------------------------------------

    def _acquire_locks(self, addrs: list[int]) -> tuple[list[int], set[int]]:
        """CAS-acquire the lock words covering ``addrs`` under the
        migrator's lease, one host step a word and try.  -> (copyable
        addrs, held words).  Pages whose word stays held by a live foreign
        lease defer (``lock_conflicts``); dead holders are revoked."""
        by_word: dict[int, list[int]] = {}
        for a in addrs:
            by_word.setdefault(self.tree._lock_word_addr(a), []).append(a)
        held: set[int] = set()
        ok_addrs: list[int] = []
        for la, pages in by_word.items():
            got = False
            for _ in range(_LOCK_TRIES):
                old, won = self.dsm.cas(la, 0, 0, self.ctx.lease,
                                        space=D.SPACE_LOCK)
                if won or old == self.ctx.lease:
                    got = True
                    break
                # a dead holder (a wedged lock): revoke through the policy
                self.tree._try_revoke_lease(la, old)
            if got:
                held.add(la)
                ok_addrs.extend(pages)
            else:
                self.lock_conflicts += len(pages)
        return ok_addrs, held

    def _release_locks(self, held: set[int]) -> None:
        if held:
            self.dsm.write_rows([
                {"op": D.OP_WRITE_WORD, "addr": la, "woff": 0, "arg1": 0,
                 "space": D.SPACE_LOCK} for la in sorted(held)])

    def _stage_batch(self, rows: list[int], *, recopy: bool) -> dict:
        """One batch over ``rows``: lock -> copy -> journal -> release ->
        cache-invalidate.  Re-copies whose content is unchanged write no
        artifact (``resume_verified`` after a resume, ``recopies_clean``
        otherwise; ``retries`` counts the changed ones)."""
        P = self.cfg.pages_per_node
        addrs = [bits.make_addr(r // P, r % P) for r in rows]
        addrs, held = self._acquire_locks(addrs)
        if not addrs:
            return {"pages": 0, "deferred": len(rows)}
        try:
            got_rows = [bits.addr_node(a) * P + bits.addr_page(a)
                        for a in addrs]
            pages = self.dsm.read_pages(addrs)
            changed_rows, changed_pages = [], []
            arr, mask = self._staged_arr, self._staged_mask
            for r, pg in zip(got_rows, pages):
                if mask[r] and np.array_equal(arr[r], pg):
                    if recopy:
                        if self.resume_count:
                            self.resume_verified += 1
                        else:
                            self.recopies_clean += 1
                    continue
                arr[r] = pg
                mask[r] = True
                changed_rows.append(r)
                changed_pages.append(pg)
                if recopy:
                    self.retries += 1
            if changed_rows:
                # journal before the locks release: a crash after this keeps
                # the batch; before it, no unjournaled copy was released
                self.seq += 1
                art = dict(
                    mid=np.frombuffer(self.mid.encode(), np.uint8).copy(),
                    seq=np.asarray([self.seq], np.int64),
                    rows=np.asarray(changed_rows, np.int64),
                    pages=np.asarray(changed_pages, np.int32),
                )
                art["integrity"] = CK._integrity(art)
                CK._savez_atomic(self._batch_path(self.seq), 0, **art)
        finally:
            self._release_locks(held)
        # the batch's rows are clean as of this copy
        self._dirt.difference_update(got_rows)
        self.pages_moved += len(addrs)
        self.batches += 1
        # a migrating page's cached entries must not outlive its batch
        if self.eng.leaf_cache is not None:
            self.eng.leaf_cache.invalidate_pages(addrs)
        obs.record_event("migrate.batch", mid=self.mid, seq=self.seq,
                         pages=len(addrs), recopy=bool(recopy))
        return {"pages": len(addrs), "deferred": len(rows) - len(addrs)}

    def step(self, max_pages: int | None = None) -> dict:
        """One bounded batch between engine steps.  Copies fresh pages from
        the plan; when the plan drains, reports idle (post-copy dirt is the
        cutover's work: re-staging it under traffic would churn)."""
        self._require_active()
        n = max_pages or self.batch_pages
        if not self._pending:
            self._refresh_plan()  # splits allocate new live pages
        if not self._pending:
            return {"idle": True, "pages": 0,
                    "dirt_backlog": len(self._dirt)}
        batch, self._pending = self._pending[:n], self._pending[n:]
        # poll before the copy: dirt up to here is captured by the locked
        # read below, dirt after it by a later poll (bookkeeping that
        # bounds the cutover's re-stage work; finish() closes every hole)
        self._poll_dirt()
        out = self._stage_batch(batch, recopy=False)
        if out["deferred"]:
            self._pending.extend(r for r in batch
                                 if not self._staged_mask[r])
        return out

    def run_to_copied(self, max_batches: int = 1_000_000) -> int:
        """Drive :meth:`step` until the plan drains (no traffic between
        batches)."""
        n = 0
        while not self.copied_all and n < max_batches:
            r = self.step()
            n += 1
            if r.get("idle"):
                break
        return n

    # -- crash restart --------------------------------------------------------

    @classmethod
    def resume(cls, cluster, tree, eng, directory: str, *,
               batch_pages: int | None = None) -> "Migrator":
        """Rebuild a migrator from the on-disk state after a crash and the
        source's recovery: the manifest and every readable batch artifact
        (CRC-checked; a torn or corrupt one is dropped and its pages copy
        again).  Every staged row joins the re-verify set: the crash's
        journal replay may have rewritten any page."""
        man = CK._load_arrays(os.path.join(directory,
                                           "migrate-manifest.npz"))
        mid = bytes(np.asarray(man["mid"])).decode()
        tgt = np.asarray(man["target"]).ravel()
        m = cls(cluster, tree, eng, int(tgt[0]), directory,
                target_pages_per_node=int(tgt[1]) or None,
                target_locks_per_node=int(tgt[2]) or None,
                batch_pages=batch_pages)
        m.mid = mid
        m._ensure_staging()
        m.started = True
        cluster.dsm.add_dirty_sink(m._sink)
        arts = sorted(glob.glob(os.path.join(directory,
                                             f"migbatch-{mid}-*.npz")))
        dropped = 0
        max_seq = 0
        for path in arts:
            try:
                z = CK._load_arrays(path)
            except CK.CheckpointCorruptError:
                dropped += 1
                continue
            max_seq = max(max_seq, int(np.asarray(z["seq"]).ravel()[0]))
            rows = np.asarray(z["rows"], np.int64)
            m._staged_arr[rows] = np.asarray(z["pages"], np.int32)
            m._staged_mask[rows] = True
        m.seq = max_seq
        m._dirt.update(np.nonzero(m._staged_mask)[0].tolist())
        m.resume_count += 1
        m._refresh_plan()
        obs.counter("migrate.resumes").inc()
        obs.record_event("migrate.resume", mid=mid,
                         staged=m.staged_pages, dropped_artifacts=dropped,
                         reverify=len(m._dirt))
        return m

    # -- cutover --------------------------------------------------------------

    def _verify_rows(self) -> list[int]:
        """The certification gather: every live row whose staged copy is
        absent or differs from the live pool now.  One ``gather_pages``
        launch over the live rows (in range, so the kernel's clip is the
        identity); this sweep makes "no lost write" a measured property."""
        rows = self._live_rows_now()
        if not rows.size:
            return []
        pool = self.dsm.pool
        live = PK.gather_pages(
            pool, torch.as_tensor(rows.astype(np.int32),
                                  device=pool.device)).cpu().numpy()
        diff = ~self._staged_mask[rows] \
            | (self._staged_arr[rows] != live).any(axis=1)
        return rows[diff].tolist()

    def finish(self, dst: str, *, hosts: int = 1) -> dict:
        """The quiesced cutover: flush deferred parents, re-stage the dirt
        set (post-copy writes, resume re-verifies, late allocations),
        certify the staged image against the live pool, then run the
        offline transform (``reshard_arrays``) over it and emit the M-node
        checkpoint at ``dst``.

        The caller quiesces traffic for the call; a writer racing it (or a
        lock that never frees) shows as mismatches past the convergence
        budget and aborts typed.  ``summary["cutover_parts_ms"]`` splits
        ``cutover_ms``: flush, re-stage, certify, transform+write."""
        self._require_active()
        t0 = time.perf_counter()
        parts: dict = {}

        def lap(name: str, t: float) -> float:
            now = time.perf_counter()
            parts[name] = round((now - t) * 1e3, 1)
            return now

        self.eng.flush_parents()
        t = lap("flush_parents", t0)
        # the heap is staged first, so the certification at emit time
        # brackets the whole cutover window
        heap_image = (self.dsm.heap_snapshot()
                      if self.dsm.heap is not None else None)
        self._refresh_plan()
        self._poll_dirt()
        todo = sorted(set(self._pending) | self._dirt)
        self._pending = []
        for i in range(0, len(todo), self.batch_pages):
            self._stage_batch(todo[i:i + self.batch_pages], recopy=True)
        t = lap("restage", t)
        parts["restaged_pages"] = len(todo)
        for attempt in range(_FINISH_VERIFY_ROUNDS + 1):
            bad = self._verify_rows()
            if not bad:
                break
            if attempt == _FINISH_VERIFY_ROUNDS:
                self.abort("cutover could not quiesce: staged image "
                           f"kept diverging after {attempt} repair "
                           "rounds")
                raise MigrationAborted(
                    f"migration {self.mid}: cutover could not quiesce "
                    "(a writer or an unreleasable lock is racing "
                    "finish())")
            for i in range(0, len(bad), self.batch_pages):
                self._stage_batch(bad[i:i + self.batch_pages],
                                  recopy=True)
        self._dirt.clear()
        t = lap("certify", t)

        # the staged array IS the cutover image: live rows hold their
        # certified copies, the rest is zero as in a checkpoint; the
        # reserved meta page is read live into row 0
        cfg = self.cfg
        image = self._staged_arr
        image[0] = self.dsm.read_page(bits.make_addr(0, 0))
        man = CK._manifest(self.cluster)
        if heap_image is not None \
                and not np.array_equal(heap_image, self.dsm.heap_snapshot()):
            self.abort("cutover could not quiesce the value heap "
                       "(a heap writer is racing finish())")
            raise MigrationAborted(
                f"migration {self.mid}: heap image diverged during "
                "cutover (a writer is racing finish())")
        # counters last: nothing below runs a DSM op, so the totals equal
        # a checkpoint taken right after finish (the bit-identity pin)
        counters = self.dsm.counters_np()
        locks = np.zeros(cfg.machine_nr * cfg.locks_per_node, np.int32)
        arrays, new_cfg, summary = RS.reshard_arrays(
            man, image, locks, counters, self.target_nodes,
            pages_per_node=self.target_pages_per_node,
            locks_per_node=self.target_locks_per_node,
            heap=heap_image)
        RS.write_resharded(dst, arrays, new_cfg, hosts=hosts)
        lap("transform_write", t)
        self.finished = True
        self.cluster.dsm.remove_dirty_sink(self._sink)
        summary["mid"] = self.mid
        summary["heap_pages"] = (int(heap_image.shape[0])
                                 if heap_image is not None else 0)
        summary["pages_moved"] = self.pages_moved
        summary["batches"] = self.batches
        summary["retries"] = self.retries
        summary["lock_conflicts"] = self.lock_conflicts
        summary["resume_count"] = self.resume_count
        summary["resume_verified"] = self.resume_verified
        summary["recopies_clean"] = self.recopies_clean
        summary["cutover_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        summary["cutover_parts_ms"] = parts
        summary["dst"] = dst
        obs.record_event("migrate.cutover", mid=self.mid,
                         live_pages=summary["live_pages"],
                         target_nodes=self.target_nodes,
                         cutover_ms=summary["cutover_ms"])
        return summary

    def close(self) -> None:
        """Detach from the DSM (idempotent); the artifacts stay on disk for
        resume or the sweep."""
        self.cluster.dsm.remove_dirty_sink(self._sink)
