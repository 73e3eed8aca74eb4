"""Port parity: empty-leaf reclaim (``BatchedEngine.reclaim_empty_leaves``,
``_remove_parent_entries``), the allocators' reclaimed-page pool,
``LeafRouter.remap_addrs`` and ``validate.leaf_chain_info`` against the
JAX package, at one node and at eight.

Both packages run the same seeded numpy inputs.  After every pass the
pools, lock tables, counters, dirty sets, allocator states (bump pointers,
leases, free lists), grant caches, pending parent entries, reclaim state
(round, quarantine, pending parent removals, parked pages) and router
tables must be bit-identical, and the stats dicts equal.  Allocation
order matters: a page popped out of turn from a free pool makes every
later pool differ, so these tests compare the free lists after every
pass.  The JAX side runs as its own tests run it (``gather_impl="xla"``,
the ``eight_devices`` fixture).  Every tolerance is exact equality.
"""

import threading

import numpy as np
import pytest
import torch

from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.errors import DoubleFreeError as JDoubleFreeError
from sherman_tpu.models import batched as JB
from sherman_tpu.models import router as JR
from sherman_tpu.models import validate as JV
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.parallel import alloc as JA
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import DoubleFreeError, StateError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models import router as TR
from sherman_tpu_torch.models import validate as TV
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.parallel import alloc as TA
from sherman_tpu_torch.parallel import dsm as D

torch.set_num_threads(1)


def _pair(n, B, *, pages=512, locks=512, chunk_pages=16, split_slots=None):
    kw = dict(machine_nr=n, pages_per_node=pages, locks_per_node=locks,
              step_capacity=B, chunk_pages=chunk_pages)
    jc = JCluster(JDSMConfig(gather_impl="xla", **kw))
    jt = JTree(jc)
    je = JB.BatchedEngine(jt, batch_per_node=B, split_slots=split_slots,
                          write_combine=False)
    pc = Cluster(DSMConfig(device="cpu", **kw))
    pt = Tree(pc)
    pe = TB.BatchedEngine(pt, batch_per_node=B, split_slots=split_slots,
                          write_combine=False)
    return (jc, jt, je), (pc, pt, pe)


def _same_state(j, p, what):
    (jc, jt, je), (pc, pt, pe) = j, p
    jd, pd = jc.dsm, pc.dsm
    np.testing.assert_array_equal(pd.pool.numpy(), np.asarray(jd.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(pd.locks.numpy(), np.asarray(jd.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(pd.counters_np(), np.asarray(jd.counters),
                                  err_msg=what + " counters")
    np.testing.assert_array_equal(pd.dirty_rows(), jd.dirty_rows(),
                                  err_msg=what + " dirty")
    assert (pt._root_addr, pt._root_level) == \
        (jt._root_addr, jt._root_level), what
    for a, b in zip(pc.directories, jc.directories):
        assert a.allocator.pages_used == b.allocator.pages_used, what
        assert a.allocator.free_pages_list == b.allocator.free_pages_list, \
            what
    assert pt.ctx.alloc._cur == jt.ctx.alloc._cur, what
    assert pe._fresh_cache == je._fresh_cache, what
    assert pe._pending_parents == [t if len(t) == 3 else (*t, 1)
                                   for t in je._pending_parents], what
    assert pe._reclaim_state == je._reclaim_state, what
    if je.router is not None:
        np.testing.assert_array_equal(pe.router.table_np, je.router.table_np,
                                      err_msg=what + " router")
        assert pe.router.shift == je.router.shift, what


def _load(j, p, keys, vals, fill=0.9):
    assert JB.bulk_load(j[1], keys, vals, fill=fill) == \
        TB.bulk_load(p[1], keys, vals, fill=fill)
    j[2].attach_router()
    p[2].attach_router()


def _both(j, p, what, fn):
    """``fn(engine)`` on both engines: equal results, then equal state."""
    out_j, out_p = fn(j[2]), fn(p[2])
    if isinstance(out_p, np.ndarray):
        np.testing.assert_array_equal(out_p, out_j, err_msg=what)
    else:
        assert out_p == out_j, what
    _same_state(j, p, what)
    return out_p


def _reclaim(j, p, what, **kw):
    return _both(j, p, what, lambda e: e.reclaim_empty_leaves(**kw))


def _search_both(j, p, keys):
    got = p[2].search(keys)
    want = j[2].search(keys)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    return got


# ---------------------------------------------------------------------------
# The pieces: the reclaimed-page pool, the router remap, the chain scan.
# ---------------------------------------------------------------------------

def test_allocator_reclaim_pool_lifo_and_double_free():
    """``reclaim`` extends the pool in the given order, ``pop_free_page``
    and page-grain ``alloc`` take the last page returned first, contiguous
    allocations bypass the pool, and a double free (against the pool or
    within one call) raises, in both packages alike."""
    cfg = dict(machine_nr=2, pages_per_node=64, locks_per_node=16,
               step_capacity=8, chunk_pages=8)
    allocs = []
    for mod, cfg_cls in ((JA, JDSMConfig), (TA, DSMConfig)):
        c = cfg_cls(**cfg) if mod is JA else cfg_cls(device="cpu", **cfg)
        dirs = [mod.Directory(i, c) for i in range(2)]
        allocs.append((dirs, mod.LocalAllocator(dirs)))
    trace = []
    for (dirs, la), err in zip(allocs, (JDoubleFreeError, DoubleFreeError)):
        t = [la.alloc(node=1) for _ in range(5)]
        dirs[1].allocator.reclaim([3, 9, 4])
        t += [dirs[1].allocator.pages_free,
              dirs[1].allocator.free_pages_list]
        t += [la.alloc(node=1), la.alloc(2, node=1), la.alloc(node=1)]
        dirs[1].allocator.reclaim([20])
        t += [dirs[1].allocator.pop_free_page(), la.alloc(),
              la.alloc(), la.alloc(node=1), dirs[1].allocator.pop_free_page()]
        for bad in ([3], [7, 7]):
            dirs[0].allocator.reclaim([3])
            with pytest.raises(err):
                dirs[0].allocator.reclaim(bad)
            dirs[0].allocator.pop_free_page()
        la.free(t[0])
        t += [dirs[0].allocator.free_pages_list, la._cur,
              [d.allocator.pages_used for d in dirs]]
        trace.append(t)
    assert trace[1] == trace[0]
    assert trace[0][5:8] == [3, [3, 9, 4], (1 << 24) | 4]
    assert trace[0][9] == (1 << 24) | 9


def test_router_remap_addrs():
    """Buckets seeded at remapped pages move to their absorbers, in one
    pass; addresses of high nodes (negative as int32) remap too."""
    tables = []
    rng = np.random.default_rng(4)
    pool_addrs = np.array([(nd << 24) | pg for nd in (0, 3, 200)
                           for pg in range(1, 40)], np.int64)
    table = pool_addrs[rng.integers(0, pool_addrs.size, 4096)]
    mapping = {int(a): int(b) for a, b in zip(
        rng.choice(pool_addrs, 30, replace=False),
        rng.choice(pool_addrs, 30))}
    for mod in (JR, TR):
        class _T:
            _root_addr = 1
            router = None
        r = mod.LeafRouter(_T(), 12)
        r.table_np = (table & 0xFFFFFFFF).astype(np.uint32).view(
            np.int32).copy()
        r.remap_addrs(mapping)
        r.remap_addrs({})
        tables.append(r.table_np)
    np.testing.assert_array_equal(tables[1], tables[0])
    moved = np.isin(table, list(mapping))
    assert moved.any() and (tables[1][~moved] ==
                            (table[~moved]).astype(np.int32)).all()


@pytest.mark.parametrize("n", [1, 8])
def test_leaf_chain_info_with_retired_pages(eight_devices, n):
    """The chain scan after a reclaim pass retired pages: the active
    leaves sorted by low fence, their fences, siblings and live counts,
    and the retired leaves in row order, as JAX's scan returns them; the
    leaf directory leaves the retired pages out."""
    B = 128 if n == 1 else 32
    j, p = _pair(n, B, pages=256 if n == 1 else 128)
    keys = np.arange(1, 3000 * n + 1, dtype=np.uint64) * np.uint64(7)
    _load(j, p, keys, keys)
    dead = keys[(keys > 2000) & (keys < 9000 * n)]
    _both(j, p, "delete", lambda e: e.delete(dead))
    st = _reclaim(j, p, "reclaim")
    assert st["unlinked"] > 0
    got, want = TV.leaf_chain_info(p[1]), JV.leaf_chain_info(j[1])
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[5].size >= st["unlinked"] and got[4].sum() == \
        keys.size - dead.size
    for g, w in zip(TV.leaf_directory(p[1]), JV.leaf_directory(j[1])):
        np.testing.assert_array_equal(g, w)
    assert not np.isin(got[5], TV.leaf_directory(p[1])[0]).any()


# ---------------------------------------------------------------------------
# Reclaim passes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8])
def test_reclaim_passes(eight_devices, n):
    """Two deleted bands empty runs of leaves; four passes unlink them
    (alternate pairs, a run drains over passes), park the leftmost
    children, remove the parent entries, and release quarantined pages
    into the free pools after two more passes.  Every surviving key reads
    back, the deleted ones stay gone, the structure checks."""
    B = 128 if n == 1 else 32
    j, p = _pair(n, B, pages=256 if n == 1 else 128)
    m = 4000 if n == 1 else 8000
    keys = np.arange(1, m + 1, dtype=np.uint64) * np.uint64(7)
    _load(j, p, keys, keys + np.uint64(1))
    i = np.arange(m)
    dead = keys[((i > 100) & (i < m * 3 // 8)) | ((i > m * 5 // 7)
                                                  & (i < m * 6 // 7))]
    _both(j, p, "delete", lambda e: e.delete(dead))
    stats = [_reclaim(j, p, f"pass {i}") for i in range(4)]
    assert stats[0]["unlinked"] > 0 and stats[1]["unlinked"] > 0
    assert sum(s["freed"] for s in stats) > 0
    assert stats[-1]["parked"] > 0
    kept = np.setdiff1d(keys, dead)
    vals, found = _search_both(j, p, kept)
    assert found.all() and (vals == kept + np.uint64(1)).all()
    assert not _search_both(j, p, dead)[1].any()
    if n == 1:      # the host walk: one host step a page
        assert p[1].check_structure() == j[1].check_structure()
    assert sum(TV.leaf_chain_info(p[1])[4]) == kept.size


@pytest.mark.parametrize("n", [1, 8])
def test_freed_pages_are_reused_by_splits(eight_devices, n):
    """Once pages are freed, the split grants of later inserts come off
    the free pools (LIFO) before the bump allocator moves."""
    B = 128 if n == 1 else 32
    j, p = _pair(n, B, pages=256 if n == 1 else 128, split_slots=4)
    keys = np.arange(1, 3000 * n + 1, dtype=np.uint64) * np.uint64(10)
    _load(j, p, keys, keys)
    dead = keys[(keys > 3000) & (keys < 3000 + 14000 * n)]
    _both(j, p, "delete", lambda e: e.delete(dead))
    freed = sum(_reclaim(j, p, f"pass {i}")["freed"] for i in range(3))
    assert freed > 0
    free0 = [d.allocator.pages_free for d in p[0].directories]
    used0 = [d.allocator.pages_used for d in p[0].directories]
    hi = keys[-40 * n:]
    fresh = np.concatenate([hi + np.uint64(3), hi + np.uint64(6)])
    st = _both(j, p, "insert", lambda e: e.insert(fresh, fresh))
    assert st["device_splits"] > 0 and st["host_path"] == 0
    free1 = [d.allocator.pages_free for d in p[0].directories]
    assert sum(free1) < sum(free0)
    # a node whose pool still holds pages has not bumped
    for d, f, u in zip(p[0].directories, free1, used0):
        assert f == 0 or d.allocator.pages_used == u
    vals, found = _search_both(j, p, np.concatenate([fresh, hi]))
    assert found.all()


def test_reclaim_drains_pending_parents_first(eight_devices):
    """Deferred parent entries are flushed before the scan: a leaf still
    owed its entry would otherwise look unreferenced."""
    j, p = _pair(1, 256)
    keys = np.arange(1, 3001, dtype=np.uint64) * np.uint64(5)
    _load(j, p, keys, keys)
    fresh = np.arange(1, 2001, dtype=np.uint64) * np.uint64(5) \
        + np.uint64(20000)
    for e in (j[2], p[2]):
        e.parent_flush_threshold = 10 ** 9
        stats = {"applied": 0, "superseded": 0, "host_path": 0, "rounds": 0,
                 "st_locked": 0, "lock_timeouts": 0,
                 "lock_timeout_keys": []}
        for i in range(0, fresh.size, e.B):
            e._insert_chunk(fresh[i:i + e.B], fresh[i:i + e.B],
                            e.tcfg.insert_rounds, stats)
    dead = keys[(keys > 2000) & (keys < 9000)]
    _both(j, p, "delete", lambda e: e.delete(dead))
    assert len(p[2]._pending_parents) > 0
    st = _reclaim(j, p, "reclaim")
    assert not p[2]._pending_parents and st["unlinked"] > 0
    kept = np.setdiff1d(np.concatenate([keys, fresh]), dead)
    vals, found = _search_both(j, p, kept)
    assert found.all() and (vals == kept).all()
    assert p[1].check_structure() == j[1].check_structure()


def test_reclaim_stale_router_seed_self_heals(eight_devices):
    """A router still seeding retired pages: the retired page's
    back-sibling sends each reader to the absorber (K1 chases it)."""
    j, p = _pair(1, 256)
    keys = np.arange(1, 3001, dtype=np.uint64) * np.uint64(5)
    _load(j, p, keys, keys)
    dead = keys[(keys > 4000) & (keys < 7000)]
    _both(j, p, "delete", lambda e: e.delete(dead))
    stale = p[2].router.table_np.copy()
    assert _reclaim(j, p, "reclaim")["unlinked"] > 0
    assert not np.array_equal(stale, p[2].router.table_np)
    for e in (j[2], p[2]):
        e.router.table_np = stale.copy()
    kept = np.setdiff1d(keys, dead)
    vals, found = _search_both(j, p, kept)
    assert found.all() and (vals == kept).all()
    _same_state(j, p, "stale seeds")
    retired = set(TV.leaf_chain_info(p[1])[5].tolist())
    assert retired & set(stale.tolist())


def test_remove_parent_entries_fence_recheck(eight_devices, monkeypatch):
    """A parent split between the descent and the lock moves the entry to
    the right sibling: an item whose key the locked parent no longer
    covers retries, and no page is quarantined off the stale parent."""
    j, p = _pair(1, 256)
    keys = np.arange(1, 4001, dtype=np.uint64) * np.uint64(7)
    _load(j, p, keys, keys)
    k_lo, k_hi = int(keys[10]), int(keys[-10])
    paddrs, done = _both(j, p, "descent", lambda e: e._descend_to_level(
        np.array([k_lo, k_hi], np.uint64), 1)[0]), np.ones(2, bool)
    assert int(paddrs[0]) != int(paddrs[1])
    fake_e = 0x00AB0001
    for e in (j[2], p[2]):
        monkeypatch.setattr(e, "_descend_to_level",
                            lambda *a, **kw: (np.array([paddrs[0]]),
                                              np.array([True])))
        nxt = e._remove_parent_entries([(fake_e, k_hi, 0)],
                                       e._reclaim_state)
        assert nxt == [(fake_e, k_hi, 0)]
        assert e._reclaim_state["quarantine"] == []
    la = p[1]._lock_word_addr(int(paddrs[0]))
    assert p[0].dsm.read_word(la, 0, space=D.SPACE_LOCK) == 0
    _same_state(j, p, "fence recheck")


def test_reclaim_is_not_reentrant(eight_devices):
    """A reclaim call while another pass holds the engine's reclaim mutex
    raises ``StateError``; the state is untouched."""
    _, p = _pair(1, 64)
    before = dict(p[2]._reclaim_state)
    held = threading.Event()
    release = threading.Event()

    def hold():
        with p[2]._reclaim_mutex:
            held.set()
            release.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(10)
        with pytest.raises(StateError):
            p[2].reclaim_empty_leaves()
    finally:
        release.set()
        t.join()
    assert p[2]._reclaim_state == before
    assert p[2].reclaim_empty_leaves()["unlinked"] == 0
