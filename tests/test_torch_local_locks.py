"""Port parity: the native tier wired into the port — the host Tree's
node-local lock tier and index cache, and the host-staged serving path —
against the JAX package on the CPU.

- The two cases of ``tests/test_local_locks.py`` on the port's
  ``Cluster``/``Tree`` (``Cluster.local_locks`` is a native
  ``LocalLockTable``): four threads incrementing one counter word under
  one lock word (the counter exact, global CAS and unlocks under half the
  ops), and one thread whose CAS and unlock counts equal the JAX
  package's; the deadlock report dropping its local ticket and the
  hand-over contract breach, on both packages.
- ``tests/test_tree.py::test_index_cache_descent`` and
  ``tests/test_obs.py``'s cache-counter case, port against JAX: answers,
  cache stats, ``btree.cache_*`` deltas, pools and counters equal.
- The host-staged sequence: both packages' ``BatchPrep`` feed each
  engine's ``_get_search_fanout`` at 20,000 keys (the port's through the
  bench's ``HostStager``): the prep buffers, ``done``, ``found``,
  ``vhi``, ``vlo``, the pools and the counters equal, every answer
  ``key ^ 0xDEADBEEF``.

Every tolerance is exact equality.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from sherman_tpu import native as JN
from sherman_tpu import obs as JObs
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.errors import ProtocolError as JProtocolError
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.parallel import dsm as JD
from sherman_tpu_torch import bench as TBench
from sherman_tpu_torch import native as TN
from sherman_tpu_torch import obs as TObs
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import ProtocolError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.parallel import dsm as D

torch.set_num_threads(1)

THREADS = 4
ITERS = 40
COUNTER_WOFF = 200  # a spare word of the root page
LOCK_KW = dict(machine_nr=1, pages_per_node=32, locks_per_node=8,
               step_capacity=16, chunk_pages=8)


def _same_state(jc, pc, what):
    np.testing.assert_array_equal(pc.dsm.pool.numpy(), np.asarray(jc.dsm.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(pc.dsm.locks.numpy(),
                                  np.asarray(jc.dsm.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(pc.dsm.counters_np(),
                                  np.asarray(jc.dsm.counters),
                                  err_msg=what + " counters")


# ---------------------------------------------------------------------------
# The local lock tier.
# ---------------------------------------------------------------------------

def test_cluster_has_native_local_locks():
    pc = Cluster(DSMConfig(device="cpu", **LOCK_KW))
    jc = JCluster(JDSMConfig(gather_impl="xla", **LOCK_KW))
    assert isinstance(pc.local_locks, TN.LocalLockTable)
    assert isinstance(jc.local_locks, JN.LocalLockTable)
    assert pc.local_locks.n == jc.local_locks.n == 8
    assert Tree(pc)._llocks is pc.local_locks


def test_handover_reduces_global_cas_and_unlocks():
    cluster = Cluster(DSMConfig(device="cpu", **LOCK_KW))
    trees = [Tree(cluster) for _ in range(THREADS)]
    page = trees[0]._root_addr
    c0 = cluster.dsm.counter_snapshot()
    errs = []

    def worker(tree):
        try:
            for _ in range(ITERS):
                la = tree._lock(page)
                v = tree.dsm.read_word(page, COUNTER_WOFF)
                tree._write_and_unlock(
                    [{"op": D.OP_WRITE, "addr": page,
                      "woff": COUNTER_WOFF, "nw": 1,
                      "payload": np.array([v + 1], np.int32)}], la)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t,)) for t in trees]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive(), "worker hung (local lock deadlock?)"
    assert not errs, errs
    total = THREADS * ITERS
    assert trees[0].dsm.read_word(page, COUNTER_WOFF) == total
    c1 = cluster.dsm.counter_snapshot()
    cas = c1["cas_ops"] - c0["cas_ops"]
    unlocks = c1["write_word_ops"] - c0["write_word_ops"]
    assert cas < total // 2, f"hand-over ineffective: {cas} CAS for {total}"
    assert unlocks < total // 2, (
        f"hand-over ineffective: {unlocks} unlocks for {total}")
    assert cas < total, "no hand-over happened at all"
    assert cluster.dsm.read_word(trees[0]._lock_word_addr(page), 0,
                                 space=D.SPACE_LOCK) == 0


def test_single_threaded_path_unchanged():
    """An uncontended client never hands over: one CAS and one unlock an
    op, the same counts as the JAX package's."""
    out = []
    for c, T in ((Cluster(DSMConfig(device="cpu", **LOCK_KW)), Tree),
                 (JCluster(JDSMConfig(gather_impl="xla", **LOCK_KW)),
                  JTree)):
        tree = T(c)
        page = tree._root_addr
        c0 = c.dsm.counter_snapshot()
        for _ in range(5):
            la = tree._lock(page)
            tree._unlock(la)
        ns = tree.lock_bench(3, loops=4)
        assert ns > 0
        c1 = c.dsm.counter_snapshot()
        out.append((c1["cas_ops"] - c0["cas_ops"],
                    c1["write_word_ops"] - c0["write_word_ops"]))
    assert out[0] == out[1] == (9, 9)


def test_deadlock_report_drops_the_local_ticket():
    """A live holder of the global word (a raw CAS by another client):
    the spinner reaches the deadlock report, drops its local ticket, and
    a later acquisition of the same ticket does not block."""
    for c, T, DD in ((Cluster(DSMConfig(device="cpu", **LOCK_KW)), Tree, D),
                     (JCluster(JDSMConfig(gather_impl="xla", **LOCK_KW)),
                      JTree, JD)):
        tree = T(c)
        other = c.register_client()
        page = tree._root_addr
        la = tree._lock_word_addr(page)
        assert c.dsm.cas(la, 0, 0, other.lease, space=DD.SPACE_LOCK)[1]
        tree.lock_spin_limit = 5
        with pytest.raises(RuntimeError, match="live lease"):
            tree._lock(page)
        assert tree._lheld == {}
        c.dsm.write_word(la, 0, 0, space=DD.SPACE_LOCK)
        la2 = tree._lock(page)             # the ticket is free again
        tree._unlock(la2)


class _BreachingTable:
    """A lock table that promises a hand-over and then does not give it."""

    def __init__(self, inner):
        self.inner = inner

    def acquire(self, i):
        return self.inner.acquire(i)

    def can_handover(self, i):
        return True

    def release(self, i, handover_ok=True):
        self.inner.release(i, False)
        return False


def test_handover_contract_breach_raises():
    for c, T, DD, err in (
            (Cluster(DSMConfig(device="cpu", **LOCK_KW)), Tree, D,
             ProtocolError),
            (JCluster(JDSMConfig(gather_impl="xla", **LOCK_KW)), JTree, JD,
             JProtocolError)):
        tree = T(c)
        tree._llocks = _BreachingTable(c.local_locks)
        page = tree._root_addr
        la = tree._lock(page)
        with pytest.raises(err, match="contract breach"):
            tree._unlock(la)
        # the global word was freed for diagnosis
        assert c.dsm.read_word(la, 0, space=DD.SPACE_LOCK) == 0


# ---------------------------------------------------------------------------
# The index cache.
# ---------------------------------------------------------------------------

CACHE_KW = dict(machine_nr=4, pages_per_node=1024, locks_per_node=1024,
                step_capacity=32, chunk_pages=32)
CACHE_KEYS = ("btree.cache_hits", "btree.cache_misses",
              "btree.cache_invalidations", "btree.sibling_chases",
              "btree.root_refreshes")


def _cache_deltas(mod, before):
    d = mod.delta(before, mod.snapshot())
    return {k: d.get(k, 0) for k in CACHE_KEYS}


def test_index_cache_descent(eight_devices):
    pc = Cluster(DSMConfig(device="cpu", **CACHE_KW))
    jc = JCluster(JDSMConfig(gather_impl="xla", **CACHE_KW))
    pt, jt = Tree(pc), JTree(jc)
    for t in (pt, jt):
        t.enable_index_cache(capacity=4096)
    assert isinstance(pt.index_cache, TN.IndexCache)
    base = 1_000_000
    keys = list(range(base, base + 600))
    np.random.default_rng(2).shuffle(keys)
    more = list(range(base + 600, base + 1200))
    snaps = (TObs.snapshot(), JObs.snapshot())
    for k in keys:
        pt.insert(k, k + 1)
        jt.insert(k, k + 1)
    stats = []
    for phase, ks in (("warm", keys), ("hot", keys[:200])):
        got = [(pt.search(k), jt.search(k)) for k in ks]
        assert all(a == b == k + 1 for (a, b), k in zip(got, ks)), phase
        stats.append((pt.index_cache.stats(), jt.index_cache.stats()))
        assert stats[-1][0] == stats[-1][1], phase
    assert stats[0][0]["adds"] > 0
    assert stats[1][0]["hits"] > stats[0][0]["hits"] + 100
    # splits after caching: stale entries invalidated and healed
    for k in more:
        pt.insert(k, k + 1)
        jt.insert(k, k + 1)
    for k in more:
        assert pt.search(k) == jt.search(k) == k + 1
    assert pt.index_cache.stats() == jt.index_cache.stats()
    assert pt.check_structure() == jt.check_structure()
    dp, dj = _cache_deltas(TObs, snaps[0]), _cache_deltas(JObs, snaps[1])
    assert dp == dj
    assert dp["btree.cache_hits"] > 0 and dp["btree.cache_misses"] > 0
    _same_state(jc, pc, "index cache")


def test_btree_cache_counters(eight_devices):
    kw = dict(machine_nr=2, pages_per_node=128, locks_per_node=64,
              step_capacity=64)
    pt = Tree(Cluster(DSMConfig(device="cpu", **kw)))
    jt = JTree(JCluster(JDSMConfig(gather_impl="xla", **kw)))
    out = []
    for t, mod in ((pt, TObs), (jt, JObs)):
        t.enable_index_cache(64)
        for k in range(1, 6):
            t.insert(k, k + 100)
        before = mod.snapshot()
        vals = [t.search(3), t.search(3)]
        d = _cache_deltas(mod, before)
        assert d["btree.cache_hits"] + d["btree.cache_misses"] == 2
        out.append((vals, d, t.index_cache.stats()))
    assert out[0] == out[1]
    assert out[0][0] == [103, 103]


# ---------------------------------------------------------------------------
# The host-staged fan-out.
# ---------------------------------------------------------------------------

HS_KEYS, HS_BATCH, HS_STEPS = 20_000, 4096, 4
HS_KW = dict(machine_nr=1, pages_per_node=2048, locks_per_node=256,
             step_capacity=HS_BATCH, chunk_pages=64)


def test_host_staged_fanout_matches_jax():
    salt, rank_to_key = TBench.synthetic_keys(HS_KEYS)
    jk, jr = JN.synthetic_keyspace(HS_KEYS, salt)
    np.testing.assert_array_equal(rank_to_key, jr)
    keys = np.sort(rank_to_key)
    np.testing.assert_array_equal(keys, jk)
    vals = keys ^ np.uint64(TBench.CHECK_XOR)
    jc = JCluster(JDSMConfig(gather_impl="xla", **HS_KW))
    jt = JTree(jc)
    je = JB.BatchedEngine(jt, batch_per_node=HS_BATCH,
                          tcfg=JTreeConfig(sibling_chase_budget=1))
    pc = Cluster(DSMConfig(device="cpu", **HS_KW))
    pt = Tree(pc)
    pe = TB.BatchedEngine(pt, batch_per_node=HS_BATCH,
                          tcfg=TreeConfig(sibling_chase_budget=1))
    assert JB.bulk_load(jt, keys, vals, fill=0.75) == \
        TB.bulk_load(pt, keys, vals, fill=0.75)
    jr, pr = je.attach_router(), pe.attach_router()
    np.testing.assert_array_equal(pr.table_np, jr.table_np)
    assert pr.shift == jr.shift
    _same_state(jc, pc, "bulk load")

    dev_b, n_u0 = TBench.size_host_dev_b(HS_KEYS, 0.99, salt, HS_BATCH)
    sizer = JN.BatchPrep(HS_BATCH, HS_BATCH, HS_KEYS, 0.99, seed=11,
                         salt=salt)
    sb = sizer.buffers()
    assert n_u0 == max(sizer.run_zipf(None, sb, None).n_uniq
                       for _ in range(3))
    st = TBench.HostStager(pe, HS_KEYS, 0.99, salt, HS_BATCH, dev_b)
    jprep = JN.BatchPrep(HS_BATCH, dev_b, HS_KEYS, 0.99, seed=11, salt=salt)
    jbuf = jprep.buffers(with_keys=True)
    jfn = je._get_search_fanout(je._iters())
    shard = jt.dsm.shard
    root = np.int32(jt._root_addr)
    for step in range(HS_STEPS):
        tb = st.prep(step % 2, want_keys=True)
        jb = jprep.run_zipf(None, jbuf, jr.table_np, jr.shift,
                            want_keys=True)
        assert tb.n_uniq == jb.n_uniq
        for f in ("khi", "klo", "start", "active", "inv", "keys"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f),
                                          err_msg=f"step {step} {f}")
        want = jb.keys ^ np.uint64(TBench.CHECK_XOR)
        d = st.upload(step % 2)
        p_out = [x.numpy() for x in st.serve(d)]
        assert int(st.wrong(d, st.serve(d))) == 0
        put = lambda a: jax.device_put(a, shard)
        counters, *j_out = jfn(jc.dsm.pool, jc.dsm.counters, put(jb.khi),
                               put(jb.klo), root, put(jb.active.view(bool)),
                               put(jb.start), put(jb.inv))
        jc.dsm.counters = counters
        j_out = [np.asarray(x) for x in j_out]
        n = jb.n_uniq
        np.testing.assert_array_equal(p_out[0][:n], j_out[0][:n])
        assert p_out[0][:n].all()
        for i, name in ((1, "found"), (2, "vhi"), (3, "vlo")):
            np.testing.assert_array_equal(p_out[i], j_out[i],
                                          err_msg=f"step {step} {name}")
        got = (p_out[2].view(np.uint32).astype(np.uint64) << np.uint64(32)
               | p_out[3].view(np.uint32).astype(np.uint64))
        np.testing.assert_array_equal(got, want)
        # the port served each batch twice (the receipt's own serve):
        # serve the JAX side once more so the counters stay comparable.
        # device_put may alias the prep buffer on the CPU: wait for the
        # step before the next prep overwrites it
        counters, *_ = jfn(jc.dsm.pool, jc.dsm.counters, put(jb.khi),
                           put(jb.klo), root, put(jb.active.view(bool)),
                           put(jb.start), put(jb.inv))
        jc.dsm.counters = jax.block_until_ready(counters)
    _same_state(jc, pc, "host-staged fan-out")
