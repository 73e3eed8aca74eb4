"""The B-link tree client over the DSM (counterpart of
``sherman_tpu/models/btree.py``): a tree of 1 KB pages in the cluster's
pool, reached only through one-sided reads, lock CAS and coalesced
write+unlock steps.  The root and the meta page live on node 0.

This is the host path: one DSM step per page read or lock round trip.
The batched engine (:mod:`sherman_tpu_torch.models.batched`) falls back
to it for rows its device rounds could not place, and uses its lock
helpers and parent insert.

- Locking is hierarchical.  The global lock word of a page is a CAS on
  its owner node's lock table at ``hash(page_addr) % locks_per_node``.
  In front of it sits the node-local tier, the cluster's native ticket
  table (``Cluster.local_locks``, :mod:`sherman_tpu_torch.native`):
  clients of this process queue on the ticket first, and the holder hands
  the global lock down the train (at most 8 times), so a train pays one
  global CAS and one global unlock.  A held global word is ``{epoch,
  owner}`` (``bits.lease_word``); after a few failed spins the spinner
  asks the cluster's lease table whether the holder is alive and revokes
  a dead holder's lock with a masked CAS; a live holder past
  ``lock_spin_limit`` spins raises the deadlock report.  One ``Tree`` a
  thread: the local tier's held tickets are per client.
- Index cache (``enable_index_cache``): the native range -> leaf cache;
  a descent that hits starts at the leaf, a stale hit is invalidated
  (and the walk restarts from the root, or chases the sibling).
- Write-back: an insert that fits writes ONE leaf entry and the unlock in
  a single DSM step; a split writes the sibling, the rebuilt page and the
  unlock in one step, so it becomes visible atomically.
- B-link: readers chase the sibling when a key is at or past a page's
  ``highest`` fence, so a stale root or parent only costs hops.

Observability: ``btree.cache_hits`` / ``btree.cache_misses`` /
``btree.cache_invalidations`` count the index cache's descents,
``btree.sibling_chases`` and ``btree.root_refreshes`` the descent's
hops, ``lease.revoked`` / ``lease.revoke_lost`` /
``lease.deadlock_reports`` the lease recovery (each revocation also a
``lease.revoked`` flight event).
"""

from __future__ import annotations

import os
import time

import numpy as np

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.cluster import ClientContext, Cluster
from sherman_tpu_torch.errors import ProtocolError
from sherman_tpu_torch.ops import bits, layout
from sherman_tpu_torch.parallel import dsm as D

META_ADDR = bits.make_addr(0, 0)
LOCK_SPIN_LIMIT = 1_000_000  # deadlock reporter threshold
# failed spins on a held lock before the spinner consults the lease table
LEASE_PROBE_SPINS = 4

_OBS_CACHE_HITS = obs.counter("btree.cache_hits")
_OBS_CACHE_MISSES = obs.counter("btree.cache_misses")
_OBS_CACHE_INVALIDATIONS = obs.counter("btree.cache_invalidations")
_OBS_SIBLING_CHASES = obs.counter("btree.sibling_chases")
_OBS_ROOT_REFRESHES = obs.counter("btree.root_refreshes")
_OBS_LEASE_REVOKED = obs.counter("lease.revoked")
_OBS_LEASE_REVOKE_LOST = obs.counter("lease.revoke_lost")
_OBS_DEADLOCK_REPORTS = obs.counter("lease.deadlock_reports")


class Tree:
    # index cache handle (models/router.py), attached by the engine and
    # told of every host leaf split
    router = None
    # host index cache handle (native.IndexCache); see enable_index_cache
    index_cache = None

    def __init__(self, cluster: Cluster, ctx: ClientContext | None = None):
        self.cluster = cluster
        self.dsm = cluster.host_dsm
        self.cfg = cluster.cfg
        self.ctx = ctx if ctx is not None else cluster.register_client()
        # the hierarchical lock's local tier (shared by the process through
        # the cluster; None where the native library cannot load)
        self._llocks = cluster.local_locks
        self._lheld: dict[int, int] = {}   # lock addr -> local table index
        self._lpass: dict[int, bool] = {}  # lock addr -> hand-over decision
        self.lock_spin_limit = int(
            os.environ.get("SHERMAN_LOCK_SPIN_LIMIT", LOCK_SPIN_LIMIT))
        # Adopt an installed root, else build an empty root leaf and
        # CAS-install it (one winner); the pre-read avoids leaking a page
        # per client handle.
        existing = self.dsm.read_word(META_ADDR, C.META_ROOT_ADDR_W)
        if existing != 0:
            self._root_addr = existing
            self._root_level = int(self.dsm.read_page(existing)[C.W_LEVEL])
            return
        root = self.ctx.alloc.alloc()
        pg = layout.np_empty_page(level=0, lowest=C.KEY_NEG_INF,
                                  highest=C.KEY_POS_INF)
        self.dsm.write_page(root, pg)
        old, ok = self.dsm.cas(META_ADDR, C.META_ROOT_ADDR_W, 0, root)
        if ok:
            self.cluster.broadcast_new_root(root, 0)
            self._root_addr, self._root_level = root, 0
        else:
            self._root_addr = old
            self._root_level = int(self.dsm.read_page(old)[C.W_LEVEL])

    def _refresh_root(self) -> None:
        """Re-read the root pointer from the meta page and its level from
        the root page itself."""
        self._root_addr = self.dsm.read_word(META_ADDR, C.META_ROOT_ADDR_W)
        self._root_level = int(
            self.dsm.read_page(self._root_addr)[C.W_LEVEL])

    # -- locking -------------------------------------------------------------

    def _lock_word_addr(self, page_addr: int) -> int:
        node = bits.addr_node(page_addr)
        idx = bits.lock_index_host(page_addr, self.cfg.locks_per_node)
        return bits.make_addr(node, idx)

    def _acquire_local(self, la: int) -> bool:
        """Join the local ticket queue of lock word ``la``; blocks until
        this client holds the local lock.  -> True when the global lock
        was handed over with it (no global CAS to pay)."""
        if self._llocks is None:
            return False
        li = (bits.addr_node(la) * self.cfg.locks_per_node
              + bits.addr_page(la))
        self._lheld[la] = li
        return self._llocks.acquire(li)

    def _abort_local(self, la: int) -> None:
        """Drop the local ticket after a failed global acquisition (the
        deadlock report): never hand over (the global lock is not ours),
        and clear the held entry so other local clients do not wait on a
        leaked ticket."""
        li = self._lheld.pop(la, None)
        if li is not None:
            self._llocks.release(li, False)

    def _abort_held_local(self) -> None:
        """Exception clean-up: drop every held local ticket, with no
        hand-over.  The global word may stay held: contenders then reach
        the deadlock report (or revoke a dead lease) instead of waiting on
        a dead ticket."""
        for la in list(self._lheld):
            self._abort_local(la)
        self._lpass.clear()

    def _try_revoke_lease(self, la: int, observed: int) -> bool:
        """If the observed holder of lock word ``la`` is dead per the
        cluster's lease table, revoke its lock with a masked CAS on the
        lease fields.  -> True when the caller should retry at once (the
        word was freed, revoked, or changed under us); False for a live
        holder.  Sound because a step lands whole: a dead client's
        protected write landed entirely or not at all."""
        owner = bits.lease_owner(observed)
        if owner == 0:
            return True
        if self.cluster.lease_is_live(owner, bits.lease_epoch(observed)):
            return False
        _, won = self.dsm.masked_cas(la, 0, observed, 0, bits.LEASE_MASK,
                                     space=D.SPACE_LOCK)
        (_OBS_LEASE_REVOKED if won else _OBS_LEASE_REVOKE_LOST).inc()
        if won:
            obs.record_event("lease.revoked", lock_word=int(la),
                             owner=int(owner),
                             epoch=int(bits.lease_epoch(observed)))
        return True

    def _deadlock_report(self, la: int, old: int) -> RuntimeError:
        _OBS_DEADLOCK_REPORTS.inc()
        owner = bits.lease_owner(old)
        live = self.cluster.lease_is_live(owner, bits.lease_epoch(old))
        verdict = ("live lease; not revocable" if live
                   else "dead lease; revocation kept losing")
        return RuntimeError(
            f"possible deadlock on lock {la:#x}: holder tag {owner} "
            f"epoch {bits.lease_epoch(old)} ({verdict}) after "
            f"{self.lock_spin_limit} spins")

    def _lock(self, page_addr: int) -> int:
        la = self._lock_word_addr(page_addr)
        if self._acquire_local(la):
            return la
        spins = 0
        while True:
            old, ok = self.dsm.cas(la, 0, 0, self.ctx.lease,
                                   space=D.SPACE_LOCK)
            if ok:
                return la
            spins += 1
            if spins >= LEASE_PROBE_SPINS:
                self._try_revoke_lease(la, old)
            if spins > self.lock_spin_limit:
                self._abort_local(la)
                raise self._deadlock_report(la, old)

    def _lock_and_read(self, page_addr: int) -> tuple[int, np.ndarray]:
        """Take the page's global lock and fetch the page in ONE step.  On
        a local hand-over the global lock is already ours and a plain read
        suffices (the predecessor's write step landed before its
        release).  -> (lock_addr, page)."""
        la = self._lock_word_addr(page_addr)
        if self._acquire_local(la):
            return la, self.dsm.read_page(page_addr)
        spins = 0
        while True:
            old, ok, pg = self.dsm.cas_read(la, 0, 0, self.ctx.lease,
                                            page_addr)
            if ok:
                return la, pg
            spins += 1
            if spins >= LEASE_PROBE_SPINS:
                self._try_revoke_lease(la, old)
            if spins > self.lock_spin_limit:
                self._abort_local(la)
                raise self._deadlock_report(la, old)

    def _unlock_row(self, lock_addr: int) -> dict:
        """The global-unlock request row (no local tier involved)."""
        return {"op": D.OP_WRITE_WORD, "addr": lock_addr, "woff": 0,
                "arg1": 0, "space": D.SPACE_LOCK}

    def _unlock_rows(self, lock_addr: int) -> list[dict]:
        """The unlock rows to put in the protected write's step: none when
        the global lock goes to a local waiter.  The decision is taken
        before the step and is binding (waiters block on the ticket).
        :meth:`_release_local` must follow once the step has landed."""
        if lock_addr in self._lheld:
            pas = self._llocks.can_handover(self._lheld[lock_addr])
            self._lpass[lock_addr] = pas
            if pas:
                return []
        return [self._unlock_row(lock_addr)]

    def _release_local(self, lock_addr: int) -> None:
        """Release the local ticket after the protected write's step has
        landed, so the next local holder reads the state after it."""
        li = self._lheld.pop(lock_addr, None)
        if li is None:
            return
        decided = self._lpass.pop(lock_addr, False)
        passed = self._llocks.release(li, decided)
        if decided and not passed:
            # a True can_handover is binding (waiters block), so this is
            # a breach of the lock table's contract: free the global word
            # so the cluster stays usable, then report the breach
            self.dsm.write_word(lock_addr, 0, 0, space=D.SPACE_LOCK)
            raise ProtocolError(
                f"local-lock hand-over invariant violated on {lock_addr:#x}"
                ": can_handover said True but release did not pass the "
                "lock (locks.cc contract breach)")

    def _unlock(self, lock_addr: int) -> None:
        rows = self._unlock_rows(lock_addr)
        if rows:
            self.dsm.write_rows(rows)
        self._release_local(lock_addr)

    def _write_and_unlock(self, rows: list[dict], lock_addr: int) -> None:
        """The protected write and the unlock in one step (or the global
        lock handed down the local train), then the local ticket released
        before any further acquisition: a parent's lock word may map to
        the same ticket."""
        self.dsm.write_rows(rows + self._unlock_rows(lock_addr))
        self._release_local(lock_addr)

    # -- index cache (host tier) ---------------------------------------------

    def enable_index_cache(self, capacity: int = 1 << 16) -> None:
        """Attach the native range -> leaf cache: a descent that hits
        jumps straight to the leaf, skipping every internal level."""
        from sherman_tpu_torch import native
        self.index_cache = native.IndexCache(capacity)

    def _cache_level1(self, pg: np.ndarray, key: int) -> None:
        """Record the child range of a level-1 page that covers ``key``
        (only that one: caching every child would cost O(fanout) a
        miss)."""
        lo = layout.np_lowest(pg)
        prev_key, prev_child = lo, int(pg[C.W_LEFTMOST])
        for k, child in layout.np_internal_entries(pg):
            if key < k:
                break
            prev_key, prev_child = k, child
        else:
            k = layout.np_highest(pg)
        self.index_cache.add(prev_key, k, prev_child)

    # -- descent -------------------------------------------------------------

    def _descend(self, key: int, stop_level: int = 0):
        """Walk root -> ``stop_level``, one page read per level, chasing
        siblings past a ``highest`` fence.  With the index cache attached
        a hit starts the walk at the leaf; a hit on a page that is not a
        leaf or whose ``lowest`` fence is past the key is invalidated and
        the walk restarts from the root, and one whose ``highest`` fence
        the key reached is invalidated and chases the sibling.
        -> (addr, page, path{level: addr})."""
        addr = self._root_addr
        from_cache = False
        if stop_level == 0 and self.index_cache is not None:
            hit = self.index_cache.lookup(key)
            if hit:
                addr, from_cache = hit, True
                _OBS_CACHE_HITS.inc()
            else:
                _OBS_CACHE_MISSES.inc()
        path: dict[int, int] = {}
        hops = 0
        while True:
            pg = self.dsm.read_page(addr)
            lvl = int(pg[C.W_LEVEL])
            if from_cache and (lvl != 0 or key < layout.np_lowest(pg)):
                self.index_cache.invalidate(key)
                _OBS_CACHE_INVALIDATIONS.inc()
                addr, from_cache = self._root_addr, False
                continue
            if key >= layout.np_highest(pg):
                if from_cache:
                    self.index_cache.invalidate(key)
                    _OBS_CACHE_INVALIDATIONS.inc()
                sib = int(pg[C.W_SIBLING])
                if bits.addr_is_null(sib):
                    # stale root (a concurrent new root): refresh
                    self._refresh_root()
                    addr = self._root_addr
                    _OBS_ROOT_REFRESHES.inc()
                else:
                    addr = sib
                    _OBS_SIBLING_CHASES.inc()
                from_cache = False
                hops += 1
                assert hops < 1000, "sibling chase runaway"
                continue
            path[lvl] = addr
            if lvl == stop_level:
                return addr, pg, path
            if lvl == 1 and self.index_cache is not None:
                self._cache_level1(pg, key)
            addr = layout.np_pick_child(pg, key)

    # -- public API ----------------------------------------------------------

    def search(self, key: int) -> int | None:
        assert C.KEY_MIN <= key <= C.KEY_MAX
        _, pg, _ = self._descend(key, 0)
        _, val = layout.np_leaf_find(pg, key)
        return val

    def insert(self, key: int, value: int) -> None:
        assert C.KEY_MIN <= key <= C.KEY_MAX
        try:
            while True:
                addr, _, path = self._descend(key, 0)
                if self._leaf_store(addr, key, value, path):
                    return
        except BaseException:
            self._abort_held_local()
            raise

    def delete(self, key: int) -> bool:
        """Remove ``key``; -> True where it existed.  Under the page lock:
        a key outside the locked leaf's fences (a concurrent split or a
        reclaim moved it) re-descends; a present key's slot gets its
        packed version word cleared, which frees the slot."""
        assert C.KEY_MIN <= key <= C.KEY_MAX
        try:
            return self._delete(key)
        except BaseException:
            self._abort_held_local()
            raise

    def _delete(self, key: int) -> bool:
        while True:
            addr, _, _ = self._descend(key, 0)
            la, pg = self._lock_and_read(addr)
            if not (layout.np_lowest(pg) <= key < layout.np_highest(pg)):
                self._unlock(la)
                continue
            slot, _ = layout.np_leaf_find(pg, key)
            if slot < 0:
                self._unlock(la)
                return False
            wv = layout.leaf_slot_words(slot)[0]
            self._write_and_unlock([
                {"op": D.OP_WRITE, "addr": addr, "woff": wv, "nw": 1,
                 "payload": np.zeros(1, np.int32)},
            ], la)
            return True

    def range_query(self, lo: int, hi: int) -> dict[int, int]:
        """All (k, v) with lo <= k < hi: descend to the leaf of ``lo``,
        then walk the sibling chain until a ``highest`` fence reaches
        ``hi`` (one host page read a leaf)."""
        out: dict[int, int] = {}
        _, pg, _ = self._descend(lo, 0)
        while True:
            for k, v, _ in layout.np_leaf_entries(pg):
                if lo <= k < hi:
                    out[k] = v
            if layout.np_highest(pg) >= hi:
                return out
            sib = int(pg[C.W_SIBLING])
            if bits.addr_is_null(sib):
                return out
            pg = self.dsm.read_page(sib)

    # -- write path ----------------------------------------------------------

    def _leaf_store(self, addr: int, key: int, value: int,
                    path: dict[int, int]) -> bool:
        """Store into the leaf at ``addr``: update in place, insert into a
        free slot, or split.  True on success, False to re-descend (the
        fence moved under us)."""
        la, pg = self._lock_and_read(addr)
        if not (layout.np_lowest(pg) <= key < layout.np_highest(pg)):
            self._unlock(la)
            return False

        slot, _ = layout.np_leaf_find(pg, key)
        if slot < 0:
            slot = layout.np_leaf_free_slot(pg)
        if slot >= 0:
            # one entry and the unlock in one step
            words = layout.leaf_slot_words(slot)
            old_fv = (int(pg[words[0]]) >> 16) & C.ENTRY_VER_MASK
            ver = (old_fv + 1) & C.ENTRY_VER_MASK or 1
            khi_, klo_ = bits.key_to_pair(key)
            vhi_, vlo_ = bits.key_to_pair(value)
            vals = (layout.ver_pack_np(ver), khi_, klo_, vhi_, vlo_)
            rows = [
                {"op": D.OP_WRITE, "addr": addr, "woff": w, "nw": 1,
                 "payload": np.array([v], np.int32)}
                for w, v in zip(words, vals)
            ]
            self._write_and_unlock(rows, la)
            return True

        # leaf full: split at the middle of the entries plus the new one
        ents = [(k, v) for k, v, _ in layout.np_leaf_entries(pg)]
        ents.append((key, value))
        ents.sort()
        m = len(ents) // 2
        split_key = ents[m][0]
        sib_addr = self.ctx.alloc.alloc()
        old_high = layout.np_highest(pg)
        old_sib = int(pg[C.W_SIBLING])
        ver = int(pg[C.W_FRONT_VER]) + 1

        right = layout.np_empty_page(0, split_key, old_high, sibling=old_sib,
                                     version=1)
        for i, (k, v) in enumerate(ents[m:]):
            layout.np_leaf_set_entry(right, i, k, v)
        left = layout.np_empty_page(0, layout.np_lowest(pg), split_key,
                                    sibling=sib_addr, version=ver)
        for i, (k, v) in enumerate(ents[:m]):
            layout.np_leaf_set_entry(left, i, k, v)

        # sibling, rebuilt page and unlock in ONE step: an atomic split
        self._write_and_unlock([
            {"op": D.OP_WRITE, "addr": sib_addr, "woff": 0,
             "nw": C.PAGE_WORDS, "payload": right},
            {"op": D.OP_WRITE, "addr": addr, "woff": 0,
             "nw": C.PAGE_WORDS, "payload": left},
        ], la)
        if self.router is not None:
            self.router.note_split(split_key, sib_addr, old_high)
        self._insert_parent(split_key, sib_addr, 1, path)
        return True

    def _insert_parent(self, key: int, child: int, level: int,
                       path: dict[int, int]) -> None:
        """:meth:`_insert_parent_inner`, dropping held local tickets on an
        exception (the engine's parent flush calls it outside
        ``insert``'s clean-up)."""
        try:
            self._insert_parent_inner(key, child, level, path)
        except BaseException:
            self._abort_held_local()
            raise

    def _insert_parent_inner(self, key: int, child: int, level: int,
                             path: dict[int, int]) -> None:
        """Insert the entry (key -> child) at ``level``: internal page
        store, internal split and root growth.  A new root's leftmost
        pointer is always the CURRENT root: the old root is the leftmost
        page of its level (its ``lowest`` fence stays -inf), so every page
        of that level is reachable from it through the B-link chain, even
        when parent entries are inserted out of order."""
        if self._root_level < level:
            self._refresh_root()
        if self._root_level < level:
            new_root = self.ctx.alloc.alloc()
            pg = layout.np_empty_page(level, C.KEY_NEG_INF, C.KEY_POS_INF,
                                      leftmost=self._root_addr)
            layout.np_internal_set_entry(pg, 0, key, child)
            pg[C.W_NKEYS] = 1
            self.dsm.write_page(new_root, pg)
            old, ok = self.dsm.cas(META_ADDR, C.META_ROOT_ADDR_W,
                                   self._root_addr, new_root)
            if ok:
                self.cluster.broadcast_new_root(new_root, level)
                self._root_addr, self._root_level = new_root, level
                return
            # lost the race: insert into the tree that won
            self._refresh_root()

        addr = path.get(level)
        if addr is None:
            addr, _, _ = self._descend(key, level)
        while True:
            la, pg = self._lock_and_read(addr)
            if key >= layout.np_highest(pg):
                self._unlock(la)
                sib = int(pg[C.W_SIBLING])
                if bits.addr_is_null(sib):
                    addr, _, _ = self._descend(key, level)
                else:
                    addr = sib
                continue
            break

        ents = layout.np_internal_entries(pg)
        ents.append((key, child))
        ents.sort()
        if len(ents) <= C.INTERNAL_CAP:
            newpg = layout.np_internal_rebuild(pg, ents, level)
            self._write_and_unlock([
                {"op": D.OP_WRITE, "addr": addr, "woff": 0,
                 "nw": C.PAGE_WORDS, "payload": newpg},
            ], la)
            return

        # internal split: the middle entry moves up
        m = len(ents) // 2
        up_key, up_child = ents[m]
        sib_addr = self.ctx.alloc.alloc()
        old_high = layout.np_highest(pg)
        old_sib = int(pg[C.W_SIBLING])
        ver = int(pg[C.W_FRONT_VER]) + 1

        right = layout.np_empty_page(level, up_key, old_high, sibling=old_sib,
                                     leftmost=up_child)
        for i, (k, c) in enumerate(ents[m + 1:]):
            layout.np_internal_set_entry(right, i, k, c)
        right[C.W_NKEYS] = len(ents) - m - 1
        left = layout.np_empty_page(level, layout.np_lowest(pg), up_key,
                                    sibling=sib_addr,
                                    leftmost=int(pg[C.W_LEFTMOST]),
                                    version=ver)
        for i, (k, c) in enumerate(ents[:m]):
            layout.np_internal_set_entry(left, i, k, c)
        left[C.W_NKEYS] = m

        self._write_and_unlock([
            {"op": D.OP_WRITE, "addr": sib_addr, "woff": 0,
             "nw": C.PAGE_WORDS, "payload": right},
            {"op": D.OP_WRITE, "addr": addr, "woff": 0,
             "nw": C.PAGE_WORDS, "payload": left},
        ], la)
        self._insert_parent(up_key, sib_addr, level + 1, path)

    def lock_bench(self, key: int, loops: int = 100) -> float:
        """Lock and unlock round trips on the lock word of page ``key``
        of node 0 (through the local tier); -> ns a round trip."""
        pa = bits.make_addr(0, key)
        t0 = time.perf_counter_ns()
        for _ in range(loops):
            la = self._lock(pa)
            self._unlock(la)
        return (time.perf_counter_ns() - t0) / max(loops, 1)

    # -- diagnostics ---------------------------------------------------------

    def check_structure(self) -> dict:
        """Walk the leftmost spine and every level's sibling chain, then
        the leaf chain: fences contiguous, keys inside their leaf's fence,
        internal keys sorted.  One host step per page.  Returns stats;
        raises on a violated invariant."""
        self._refresh_root()
        stats = {"levels": self._root_level + 1, "leaves": 0, "keys": 0,
                 "internal_pages": 0}
        addr = self._root_addr
        for lvl in range(self._root_level, 0, -1):
            pg = self.dsm.read_page(addr)
            assert int(pg[C.W_LEVEL]) == lvl, "level mismatch on spine"
            a, n = addr, 0
            while not bits.addr_is_null(a):
                p = self.dsm.read_page(a)
                n += 1
                keys = [k for k, _ in layout.np_internal_entries(p)]
                assert keys == sorted(keys), "unsorted internal page"
                a = int(p[C.W_SIBLING])
            stats["internal_pages"] += n
            addr = int(pg[C.W_LEFTMOST])
        a = addr
        last_high = None
        while not bits.addr_is_null(a):
            p = self.dsm.read_page(a)
            assert int(p[C.W_LEVEL]) == 0
            lo, hi = layout.np_lowest(p), layout.np_highest(p)
            if last_high is not None:
                assert lo == last_high, "leaf fence gap"
            for k, _, _ in layout.np_leaf_entries(p):
                assert lo <= k < hi, "leaf key outside fence"
                stats["keys"] += 1
            stats["leaves"] += 1
            last_high = hi
            a = int(p[C.W_SIBLING])
        assert last_high == C.KEY_POS_INF
        return stats
