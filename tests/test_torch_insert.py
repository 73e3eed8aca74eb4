"""Port parity: the insert path of ``sherman_tpu_torch`` with device leaf
splits (the raw insert step with split grants, ``BatchedEngine.insert``,
``flush_parents``, the lock-retry and lease-recovery paths, and ``mixed``
with writes that need the split path) against the JAX package, at one
node and at eight.

Both packages run the same seeded numpy inputs.  After every phase the
pools, lock tables, counters, dirty sets, allocator states, grant caches,
pending parent entries and router tables must be bit-identical, and the
statuses, split logs and ``stats`` dicts equal.  The JAX side runs as its
own tests run it (``gather_impl="xla"``, the ``eight_devices`` fixture).
Every tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.ops import bits as JBits
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import (KEY_MAX, KEY_MIN, LEAF_CAP, DSMConfig,
                                      TreeConfig)
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import dsm as D

torch.set_num_threads(1)


def _pair(n, B, *, pages=512, cap=None, split_slots=None, tree_kw=None):
    kw = dict(machine_nr=n, pages_per_node=pages, locks_per_node=256,
              step_capacity=cap or B, chunk_pages=16)
    tree_kw = tree_kw or {}
    jc = JCluster(JDSMConfig(gather_impl="xla", **kw))
    jt = JTree(jc)
    je = JB.BatchedEngine(jt, batch_per_node=B, tcfg=JTreeConfig(**tree_kw),
                          split_slots=split_slots, write_combine=False)
    pc = Cluster(DSMConfig(device="cpu", **kw))
    pt = Tree(pc)
    pe = TB.BatchedEngine(pt, batch_per_node=B, tcfg=TreeConfig(**tree_kw),
                          split_slots=split_slots)
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
    assert [d.allocator.pages_used for d in pc.directories] == \
        [d.allocator.pages_used for d in jc.directories], what
    assert pt.ctx.alloc._cur == jt.ctx.alloc._cur, what
    assert pe._fresh_cache == je._fresh_cache, what
    assert pe._pending_parents == [t if len(t) == 3 else (*t, 1)
                                   for t in je._pending_parents], what
    if je.router is not None:
        np.testing.assert_array_equal(pe.router.table_np, je.router.table_np,
                                      err_msg=what + " router")
        assert (pe.router.shift, pe.router.splits_noted) == \
            (je.router.shift, je.router.splits_noted), what


def _insert_both(j, p, keys, vals, what, **kw):
    sj = j[2].insert(keys, vals, **kw)
    sp = p[2].insert(keys, vals, **kw)
    assert sp == sj, what
    _same_state(j, p, what)
    return sp


def _read_back(j, p, keys, want):
    got = p[2].search(keys)
    np.testing.assert_array_equal(got[0], j[2].search(keys)[0])
    assert got[1].all()
    np.testing.assert_array_equal(got[0], want)
    assert p[1].check_structure() == j[1].check_structure()


# ---------------------------------------------------------------------------
# One raw insert step with grants.
# ---------------------------------------------------------------------------

def _raw_jax(eng, keys, vals, fresh, use_router):
    """One JAX insert step, the ``conftest.run_insert_kernel`` shape with
    the given grants -> (status [n], split log)."""
    n = keys.shape[0]
    khi, klo = JBits.keys_to_pairs(keys)
    vhi, vlo = JBits.keys_to_pairs(vals)
    pad = lambda x: eng._pad(x)[0]
    khi, klo, vhi, vlo = pad(khi), pad(klo), pad(vhi), pad(vlo)
    fn = eng._get_insert(eng._iters(), use_router, with_fresh=True)
    args = [eng._shard(x) for x in (khi, klo, vhi, vlo)]
    args += [np.int32(eng.tree._root_addr),
             eng._shard(pad(np.ones(n, bool)))]
    if use_router:
        args.append(eng._shard(eng.router.host_start(khi, klo)))
    args.append(eng._shard(fresh))
    dsm = eng.dsm
    dsm.pool, dsm.counters, dsm.dirty, st, log = fn(
        dsm.pool, dsm.locks, dsm.counters, dsm.dirty, *args)
    return np.asarray(st)[:n], {k: np.asarray(v) for k, v in log.items()}


def _raw_port(eng, keys, vals, fresh, use_router):
    n = keys.shape[0]
    khi, klo = bits.keys_to_pairs(keys)
    vhi, vlo = bits.keys_to_pairs(vals)
    khi, klo, vhi, vlo = (eng._pad(x) for x in (khi, klo, vhi, vlo))
    fn = eng._get_insert(eng._iters(), use_router, with_fresh=True)
    args = [eng._dev(x) for x in (khi, klo, vhi, vlo)]
    args += [eng.tree._root_addr, eng._dev(eng._pad(np.ones(n, bool)))]
    if use_router:
        args.append(eng._dev(eng.router.host_start(khi, klo)))
    args.append(eng._dev(fresh))
    dsm = eng.dsm
    st, log = fn(dsm.pool, dsm.locks, dsm.counters, dsm.dirty, *args)
    return st.numpy()[:n], {k: v.numpy() for k, v in log.items()}


@pytest.mark.parametrize("n", [1, 8])
def test_raw_insert_step_with_grants(eight_devices, n):
    """Statuses and split logs of single steps: a page that overflows (its
    splitter takes a grant, fitting inserts and updates still apply, the
    inserts past the free slots are suppressed), a same-key run, a
    splitter whose grant is 0 (ST_FULL), and a page of the slot past the
    grants (ST_FULL)."""
    B = 64
    j, p = _pair(n, B, split_slots=4)
    keys = np.arange(1, 40 * n * 44 + 1, dtype=np.uint64) * 1024
    assert JB.bulk_load(j[1], keys, keys, fill=0.9) == \
        TB.bulk_load(p[1], keys, keys, fill=0.9)      # 44 of 49 slots
    j[2].attach_router()
    p[2].attach_router()
    rng = np.random.default_rng(n)
    F = 4
    for step in range(3):
        # leaves 0..5 (44 keys each): 7 fresh keys into leaf 0 (5 fit, 1
        # splits, 1 suppressed), an update and 6 fresh into leaf 1, 6
        # fresh into each of leaves 2-5 (four more splitters than the
        # grants); a same-key run; row order shuffled
        base = keys[::44][:6 * n:n]
        fresh_k = np.concatenate(
            [base[0] + np.arange(1, 8, dtype=np.uint64)]
            + [b + np.arange(1, 7, dtype=np.uint64) * 3 + step
               for b in base[1:]])
        q = np.concatenate([fresh_k, keys[45:46], fresh_k[:2]])
        order = rng.permutation(q.size)
        q = q[order]
        v = q ^ np.uint64(0xABC + step)
        fresh = np.zeros(n * F, np.int32)
        for nd in range(n):
            for f in range(F):
                if not (step == 1 and f == 1):        # a grant of 0
                    a = j[1].ctx.alloc.alloc(node=nd)
                    assert p[1].ctx.alloc.alloc(node=nd) == a
                    fresh[nd * F + f] = a
        sj, lj = _raw_jax(j[2], q, v, fresh, True)
        sp, lp = _raw_port(p[2], q, v, fresh, True)
        np.testing.assert_array_equal(sp, sj, err_msg=f"status {step}")
        assert set(lp) == set(lj)
        for k in lj:
            np.testing.assert_array_equal(lp[k], lj[k],
                                          err_msg=f"log {k} {step}")
        _same_state(j, p, f"raw step {step}")
        if step == 0:
            have = set(np.unique(sp).tolist())
            assert {TB.ST_APPLIED, TB.ST_RETRY, TB.ST_SUPERSEDED} <= have
            assert n > 1 or TB.ST_FULL in have     # 6 splitters, 4 grants
            assert lp["valid"].sum() == F if n == 1 else lp["valid"].any()
        if step == 1:
            assert lp["valid"].sum() <= n * F - 1   # the grant of 0
        keys = np.unique(np.concatenate([keys, q[sp == TB.ST_APPLIED]]))


# ---------------------------------------------------------------------------
# BatchedEngine.insert.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8])
def test_engine_insert_single_split_and_cascade(eight_devices, n):
    j, p = _pair(n, 128 if n == 1 else 64)
    # the root leaf exactly full, KEY_MIN and KEY_MAX among its entries:
    # the split's slot sort must order them as uint64 and keep every dead
    # slot after the live ones
    base = np.array([KEY_MIN] + list(range(10, (LEAF_CAP - 1) * 10, 10))
                    + [KEY_MAX], np.uint64)
    for k in base:
        j[1].insert(int(k), int(k) * 2)
        p[1].insert(int(k), int(k) * 2)
    newk = np.array([5, 155, 555], dtype=np.uint64)
    st = _insert_both(j, p, newk, newk * np.uint64(2), "single split")
    assert st["host_path"] == 0 and st["device_splits"] >= 1
    allk = np.concatenate([base, newk])
    _read_back(j, p, allk, allk * np.uint64(2))
    assert p[1].search(KEY_MAX) == j[1].search(KEY_MAX) == \
        (KEY_MAX * 2) % 2**64
    # a cascade over the same tree: many splits per leaf, root growth
    keys = np.unique(np.random.default_rng(5).integers(
        1, 1 << 20, 300, dtype=np.uint64))
    keys = np.setdiff1d(keys, allk)
    st = _insert_both(j, p, keys, keys * np.uint64(3), "cascade")
    assert st["device_splits"] >= 4 and p[1]._root_level >= 1
    _read_back(j, p, keys, keys * np.uint64(3))


@pytest.mark.parametrize("n,fill", [(1, 0.95), (1, 0.9), (8, 0.9)])
def test_engine_insert_router_seeds_and_updates(eight_devices, n, fill):
    """Fresh keys and updates into a nearly full bulk-loaded tree with a
    warm router: retries land on the refreshed seeds."""
    B = 256 if n == 1 else 64
    j, p = _pair(n, B, pages=1024 if n == 1 else 256)
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(1, 1 << 63, 1200, dtype=np.uint64))[:1000]
    assert JB.bulk_load(j[1], keys, keys, fill=fill) == \
        TB.bulk_load(p[1], keys, keys, fill=fill)
    j[2].attach_router()
    p[2].attach_router()
    fresh = np.setdiff1d(
        np.unique(rng.integers(1, 1 << 63, 500, dtype=np.uint64)), keys)[:400]
    upd = keys[::5]
    q = np.concatenate([fresh, upd, fresh[:7]])        # duplicates too
    v = np.concatenate([fresh * np.uint64(7), upd ^ np.uint64(1),
                        fresh[:7] * np.uint64(7)])
    st = _insert_both(j, p, q, v, "router seeds")
    assert st["host_path"] == 0 and st["device_splits"] > 0
    assert st["applied"] + st["superseded"] == q.size
    want = dict(zip(keys.tolist(), keys.tolist()))
    want.update(zip(upd.tolist(), (upd ^ np.uint64(1)).tolist()))
    want.update(zip(fresh.tolist(), (fresh * np.uint64(7)).tolist()))
    allk = np.array(sorted(want), np.uint64)
    _read_back(j, p, allk, np.array([want[int(k)] for k in allk], np.uint64))


@pytest.mark.parametrize("n", [1, 8])
def test_engine_sequential_append_storm(eight_devices, n):
    """Monotone keys all land in the rightmost leaf, which splits again
    and again with suppressed writers retrying (parents flushed every
    round).  Then a key into every gap, with a router and a raised
    ``parent_flush_threshold``: the parent entries wait, and
    ``flush_parents`` inserts them, splitting internal pages."""
    j, p = _pair(n, 256 if n == 1 else 32, pages=512 if n == 1 else 64)
    base = np.uint64(1) << np.uint64(40)
    m = 1200 if n == 1 else 200
    keys = base + np.arange(1, m + 1, dtype=np.uint64) * 64
    vals = keys * np.uint64(11)
    st = _insert_both(j, p, keys, vals, "append storm")
    assert st["host_path"] == 0 and st["device_splits"] > 5
    for e in (j[2], p[2]):
        e.attach_router()
        e.parent_flush_threshold = 10**9
    more = keys + np.uint64(32)                  # into every gap
    sj, sp = dict(_STATS), dict(_STATS)
    for i in range(0, m, p[2].total):         # insert() less its flush
        j[2]._insert_chunk(more[i:i + p[2].total], more[i:i + p[2].total],
                           16, sj)
        p[2]._insert_chunk(more[i:i + p[2].total], more[i:i + p[2].total],
                           16, sp)
    assert sp == sj and sp["host_path"] == 0
    assert len(p[2]._pending_parents) > 0
    _same_state(j, p, "deferred parents")
    assert p[2].flush_parents() == j[2].flush_parents() > 0
    assert p[2].flush_parents() == j[2].flush_parents() == 0
    _same_state(j, p, "flush_parents")
    _read_back(j, p, np.concatenate([keys, more]),
               np.concatenate([vals, more]))


_STATS = {"applied": 0, "superseded": 0, "host_path": 0, "rounds": 0,
          "st_locked": 0, "lock_timeouts": 0, "lock_timeout_keys": []}


def test_engine_insert_bad_rows_take_the_host_path(eight_devices):
    """Rows whose leaf fails the sanity checks (a torn page: front and
    rear versions differ) report ST_BAD and are inserted by the host path,
    followed by a root refresh; a round budget too small for an append
    hands the rest to the host path too."""
    j, p = _pair(1, 64)
    keys = np.arange(1, 12000, 7, dtype=np.uint64)
    assert JB.bulk_load(j[1], keys, keys, fill=0.95) == \
        TB.bulk_load(p[1], keys, keys, fill=0.95)
    j[2].attach_router()
    p[2].attach_router()
    torn = int(p[1]._bulk_leaf_dir[0][2])
    for c in (j[0], p[0]):
        c.dsm.write_rows([{"op": D.OP_WRITE_WORD, "addr": torn,
                           "woff": D.PAGE_WORDS - 1, "arg1": 7}])
    lo = int(p[1]._bulk_leaf_dir[1][2])
    q = np.uint64(lo) + np.array([1, 2, 3, 5], np.uint64)
    st = _insert_both(j, p, q, q, "bad rows")
    assert st["host_path"] == 4
    # one grant a round: 16 leaves each one key over full need 16 grant
    # rounds after the first, one more than a budget of 1 allows (16x)
    for e in (j[2], p[2]):
        e.split_slots = 1
    lows = p[1]._bulk_leaf_dir[1][10:26]
    q2 = (lows[:, None] + np.arange(1, 5, dtype=np.uint64)[None, :])
    q2 = q2.reshape(-1)
    st = _insert_both(j, p, q2, q2, "small budget", max_rounds=1)
    assert st["host_path"] == 1 and st["rounds"] == 16
    _read_back(j, p, np.concatenate([q, q2]), np.concatenate([q, q2]))


# ---------------------------------------------------------------------------
# Lock paths: a held page lock, lease revocation and lock timeouts.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", [True, False])
def test_engine_insert_blocked_by_a_held_page_lock(eight_devices, dead):
    """Another client holds the lock word of a leaf while the engine
    inserts: ST_LOCKED rounds with backoff, then every
    ``lock_retry_rounds`` a lease probe.  A dead holder's lock is revoked
    and the rows apply; a live holder's rows end with the typed
    ``ST_LOCK_TIMEOUT`` rejection, in ``insert`` and in ``mixed``."""
    j, p = _pair(1, 64, tree_kw=dict(lock_retry_rounds=2))
    keys = np.arange(1, 2000, 3, dtype=np.uint64) * 1000
    assert JB.bulk_load(j[1], keys, keys) == TB.bulk_load(p[1], keys, keys)
    j[2].attach_router()
    p[2].attach_router()
    leaf = int(p[1]._bulk_leaf_dir[0][3])
    la = p[1]._lock_word_addr(leaf)
    jo, po = j[0].register_client(), p[0].register_client()
    assert p[0].dsm.cas(la, 0, 0, po.lease, space=D.SPACE_LOCK) == \
        j[0].dsm.cas(la, 0, 0, jo.lease, space=D.SPACE_LOCK) == (0, True)
    if dead:
        p[0].expire_client(po.tag)
        j[0].expire_client(jo.tag)
    lo = int(p[1]._bulk_leaf_dir[1][3])
    q = np.concatenate([np.uint64(lo) + np.arange(1, 4, dtype=np.uint64),
                        keys[400:420] + np.uint64(1)])
    st = _insert_both(j, p, q, q, "held lock", max_rounds=4)
    assert st["st_locked"] >= 2
    if dead:
        assert st["lock_timeouts"] == 0 and st["applied"] == q.size
        assert p[0].dsm.read_word(la, 0, space=D.SPACE_LOCK) == 0
        _read_back(j, p, q, q)
        return
    assert st["lock_timeouts"] == 3
    assert sorted(st["lock_timeout_keys"]) == q[:3].tolist()
    # mixed retries its locked writes through insert: typed rejections
    is_read = np.zeros(6, bool)
    is_read[5] = True
    qm = np.concatenate([q[:3], q[:1], keys[500:502]])
    vm = qm ^ np.uint64(5)
    want = j[2].mixed(qm, vm, is_read)
    got = p[2].mixed(qm, vm, is_read)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    _same_state(j, p, "mixed lock timeout")
    np.testing.assert_array_equal(
        got[2][:5], [TB.ST_LOCK_TIMEOUT] * 4 + [TB.ST_APPLIED])


# ---------------------------------------------------------------------------
# mixed with writes that need the split path.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8])
def test_mixed_writes_through_the_split_path(eight_devices, n):
    """Fresh keys into full leaves in a fused read/write step: ST_FULL and
    ST_RETRY rows retry through ``insert`` and come back APPLIED (the
    first request of a key) or SUPERSEDED, as in the reference."""
    B = 128 if n == 1 else 32
    j, p = _pair(n, B, pages=512 if n == 1 else 64)
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(1, 1 << 63, 900, dtype=np.uint64))[:800]
    assert JB.bulk_load(j[1], keys, keys, fill=0.95) == \
        TB.bulk_load(p[1], keys, keys, fill=0.95)
    j[2].attach_router()
    p[2].attach_router()
    for step in range(2):
        m = n * B - 3
        q = keys[rng.integers(0, keys.size, m)]
        fresh = np.setdiff1d(rng.integers(1, 1 << 63, m // 3,
                                          dtype=np.uint64), keys)
        q[:fresh.size] = fresh
        q[fresh.size:fresh.size + 2] = fresh[0]          # duplicates
        rng.shuffle(q)
        is_read = rng.random(m) < 0.3
        v = q ^ np.uint64(0x77 + step)
        want = j[2].mixed(q, v, is_read)
        got = p[2].mixed(q, v, is_read)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y, err_msg=f"mixed {step}")
        _same_state(j, p, f"mixed {step}")
        w = ~is_read
        assert set(np.unique(got[2][w])) <= {TB.ST_APPLIED,
                                              TB.ST_SUPERSEDED}
        assert (got[2][w] == TB.ST_APPLIED).sum() == np.unique(q[w]).size
        keys = np.union1d(keys, q[w])


def test_insert_path_counts_no_kernel_launch_on_cpu(eight_devices):
    _, p = _pair(1, 64)
    PK.reset_launches()
    keys = np.arange(1, 400, dtype=np.uint64) * 3
    p[2].insert(keys, keys)
    assert p[2].search(keys)[1].all()
    assert PK.LAUNCHES == {"descent_round": 0, "gather_pages": 0,
                           "writeback": 0}
