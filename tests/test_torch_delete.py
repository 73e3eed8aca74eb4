"""Port parity: the delete path of ``sherman_tpu_torch`` (the raw delete
step, ``BatchedEngine.delete`` with its lock retry and host fallback, and
the host ``Tree.delete``) against the JAX package, at one node and at
eight.

Both packages run the same seeded numpy inputs.  After every phase the
pools, lock tables, counters, dirty sets and allocator states must be
bit-identical, and the statuses and found masks equal.  The JAX side runs
as its own tests run it (``gather_impl="xla"``, the ``eight_devices``
fixture).  Every tolerance is exact equality.
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
from sherman_tpu_torch.config import KEY_MAX, KEY_MIN, DSMConfig, TreeConfig
from sherman_tpu_torch.errors import KeyRangeError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import dsm as D

torch.set_num_threads(1)


def _pair(n, B, *, pages=512, cap=None, tree_kw=None):
    kw = dict(machine_nr=n, pages_per_node=pages, locks_per_node=256,
              step_capacity=cap or B, chunk_pages=16)
    tree_kw = tree_kw or {}
    jc = JCluster(JDSMConfig(gather_impl="xla", **kw))
    jt = JTree(jc)
    je = JB.BatchedEngine(jt, batch_per_node=B, tcfg=JTreeConfig(**tree_kw),
                          write_combine=False)
    pc = Cluster(DSMConfig(device="cpu", **kw))
    pt = Tree(pc)
    pe = TB.BatchedEngine(pt, batch_per_node=B, tcfg=TreeConfig(**tree_kw),
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
    assert [d.allocator.pages_used for d in pc.directories] == \
        [d.allocator.pages_used for d in jc.directories], what
    assert pt.ctx.alloc._cur == jt.ctx.alloc._cur, what


def _load(j, p, keys, vals, fill=0.9, router=True):
    assert JB.bulk_load(j[1], keys, vals, fill=fill) == \
        TB.bulk_load(p[1], keys, vals, fill=fill)
    if router:
        j[2].attach_router()
        p[2].attach_router()


def _delete_both(j, p, keys, what, **kw):
    fj = j[2].delete(keys, **kw)
    fp = p[2].delete(keys, **kw)
    np.testing.assert_array_equal(fp, fj, err_msg=what)
    _same_state(j, p, what)
    return fp


def _search_both(j, p, keys):
    got = p[2].search(keys)
    want = j[2].search(keys)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    return got


# ---------------------------------------------------------------------------
# One raw delete step.
# ---------------------------------------------------------------------------

def _raw_jax(eng, keys, use_router):
    n = keys.shape[0]
    khi, klo = JBits.keys_to_pairs(keys)
    pad = lambda x: eng._pad(x)[0]
    khi, klo = pad(khi), pad(klo)
    fn = eng._get_delete(eng._iters(), use_router)
    args = [eng._shard(khi), eng._shard(klo), np.int32(eng.tree._root_addr),
            eng._shard(pad(np.ones(n, bool)))]
    if use_router:
        args.append(eng._shard(eng.router.host_start(khi, klo)))
    dsm = eng.dsm
    dsm.pool, dsm.counters, dsm.dirty, st = fn(
        dsm.pool, dsm.locks, dsm.counters, dsm.dirty, *args)
    return np.asarray(st)[:n]


def _raw_port(eng, keys, use_router):
    n = keys.shape[0]
    khi, klo = bits.keys_to_pairs(keys)
    khi, klo = eng._pad(khi), eng._pad(klo)
    fn = eng._get_delete(eng._iters(), use_router)
    args = [eng._dev(khi), eng._dev(klo), eng.tree._root_addr,
            eng._dev(eng._pad(np.ones(n, bool)))]
    if use_router:
        args.append(eng._dev(eng.router.host_start(khi, klo)))
    dsm = eng.dsm
    return fn(dsm.pool, dsm.locks, dsm.counters, dsm.dirty, *args).numpy()[:n]


@pytest.mark.parametrize("n,use_router", [(1, True), (1, False),
                                          (8, True), (8, False)])
def test_raw_delete_step(eight_devices, n, use_router):
    """Statuses of single steps: present keys (APPLIED), same-key
    duplicates in one batch (every copy APPLIED: the clear is idempotent
    and is not deduplicated), absent keys (NOT_FOUND), and a second step
    over the same keys (all NOT_FOUND)."""
    B = 128 if n == 1 else 32
    j, p = _pair(n, B, pages=256 if n == 1 else 64)
    keys = np.arange(1, 1500 * n + 1, dtype=np.uint64) * 1000
    _load(j, p, keys, keys ^ np.uint64(0x55), router=use_router)
    rng = np.random.default_rng(n + 2 * use_router)
    present = rng.choice(keys, n * B // 2, replace=False)
    absent = present[: n * B // 8] + np.uint64(1)
    q = np.concatenate([present, present[:n * B // 8], absent])
    q = q[rng.permutation(q.size)][:n * B]
    for step in range(2):
        sj = _raw_jax(j[2], q, use_router)
        sp = _raw_port(p[2], q, use_router)
        np.testing.assert_array_equal(sp, sj, err_msg=f"status {step}")
        _same_state(j, p, f"raw delete {step}")
        want = np.where(np.isin(q, keys), TB.ST_APPLIED, TB.ST_NOT_FOUND)
        np.testing.assert_array_equal(
            sp, want if step == 0 else TB.ST_NOT_FOUND)
        keys = np.setdiff1d(keys, q)


# ---------------------------------------------------------------------------
# BatchedEngine.delete.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,use_router", [(1, True), (1, False),
                                          (8, True), (8, False)])
def test_engine_delete(eight_devices, n, use_router):
    """Deletes in chunks wider than the engine (duplicates and absent keys
    among them), then every key read back; the freed slots take fresh
    inserts again."""
    B = 128 if n == 1 else 32
    j, p = _pair(n, B, pages=256 if n == 1 else 64)
    rng = np.random.default_rng(9 + n)
    keys = np.unique(rng.integers(1, 1 << 62, 3000, dtype=np.uint64))
    _load(j, p, keys, keys * np.uint64(3), router=use_router)
    dead = rng.choice(keys, 700, replace=False)
    q = np.concatenate([dead, dead[:50], np.setdiff1d(
        rng.integers(1, 1 << 62, 80, dtype=np.uint64), keys)])
    f = _delete_both(j, p, q, "delete")
    assert f[:dead.size].all() and not f[dead.size + 50:].any()
    vals, found = _search_both(j, p, keys)
    np.testing.assert_array_equal(found, ~np.isin(keys, dead))
    np.testing.assert_array_equal(vals[found], keys[found] * np.uint64(3))
    st_j = j[2].insert(dead[:300], dead[:300])
    assert p[2].insert(dead[:300], dead[:300]) == st_j
    _same_state(j, p, "insert into freed slots")
    assert st_j["host_path"] == 0
    assert p[1].check_structure() == j[1].check_structure()


def test_delete_blocked_by_a_held_page_lock(eight_devices):
    """Another client holds a leaf's lock word (a raw CAS) and has died:
    the device rounds report ST_LOCKED and retry up to ``max_rounds``,
    then the rows go through the host ``Tree.delete``, which revokes the
    dead holder's lock and clears the slots."""
    j, p = _pair(1, 64)
    keys = np.arange(1, 2000, 3, dtype=np.uint64) * 1000
    _load(j, p, keys, keys)
    leaf = int(p[1]._bulk_leaf_dir[0][3])
    la = p[1]._lock_word_addr(leaf)
    jo, po = j[0].register_client(), p[0].register_client()
    assert p[0].dsm.cas(la, 0, 0, po.lease, space=D.SPACE_LOCK) == \
        j[0].dsm.cas(la, 0, 0, jo.lease, space=D.SPACE_LOCK) == (0, True)
    p[0].expire_client(po.tag)
    j[0].expire_client(jo.tag)
    lo = int(p[1]._bulk_leaf_dir[1][3])
    on_leaf = keys[(keys >= lo)][:4]
    q = np.concatenate([on_leaf, keys[400:420]])
    f = _delete_both(j, p, q, "held lock", max_rounds=3)
    assert f.all()
    assert p[0].dsm.read_word(la, 0, space=D.SPACE_LOCK) == 0
    _, found = _search_both(j, p, q)
    assert not found.any()


def test_delete_bad_rows_take_the_host_path(eight_devices):
    """Rows whose leaf fails the sanity checks (a torn page: front and
    rear versions differ) report ST_BAD and are deleted by the host
    ``Tree.delete``, followed by a root refresh."""
    j, p = _pair(1, 64)
    keys = np.arange(1, 12000, 7, dtype=np.uint64)
    _load(j, p, keys, keys, fill=0.95)
    torn = int(p[1]._bulk_leaf_dir[0][2])
    lo = int(p[1]._bulk_leaf_dir[1][2])
    for c in (j[0], p[0]):
        c.dsm.write_rows([{"op": D.OP_WRITE_WORD, "addr": torn,
                           "woff": D.PAGE_WORDS - 1, "arg1": 7}])
    on_torn = keys[keys >= lo][:3]
    raw = _raw_port(p[2], on_torn, True)
    np.testing.assert_array_equal(raw, _raw_jax(j[2], on_torn, True))
    np.testing.assert_array_equal(raw, TB.ST_BAD)
    q = np.concatenate([on_torn, on_torn[:1] + np.uint64(1), keys[900:905]])
    f = _delete_both(j, p, q, "bad rows")
    np.testing.assert_array_equal(f, np.isin(q, keys))


# ---------------------------------------------------------------------------
# The host Tree.delete, and key ranges.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_host_tree_delete_on_a_split_tree(eight_devices, n):
    """``Tree.delete`` alone, key by key, on a bulk-loaded tree whose full
    leaves the host path has split: found and absent keys, then keys read
    back through the host ``Tree.search`` and every key through the
    engine."""
    j, p = _pair(n, 64, pages=256)
    rng = np.random.default_rng(21 + n)
    keys = np.unique(rng.integers(1, 1 << 40, 1200, dtype=np.uint64))
    _load(j, p, keys, keys + np.uint64(1), fill=1.0, router=False)
    more = keys[:400:40] + np.uint64(1)           # into full leaves
    for k in more:
        j[1].insert(int(k), int(k) + 1)
        p[1].insert(int(k), int(k) + 1)
    _same_state(j, p, "host splits")
    keys = np.union1d(keys, more)
    dead = np.concatenate([keys[:300:7], more[::2]])
    for k in np.concatenate([dead, dead[:5] + np.uint64(1)]):
        assert p[1].delete(int(k)) == j[1].delete(int(k))
    _same_state(j, p, "host delete")
    live = set(np.setdiff1d(keys, dead).tolist())
    for k in keys[:70:3]:
        assert p[1].search(int(k)) == j[1].search(int(k)) == \
            (int(k) + 1 if int(k) in live else None)
    vals, found = _search_both(j, p, keys)
    np.testing.assert_array_equal(found, ~np.isin(keys, dead))
    np.testing.assert_array_equal(vals[found], keys[found] + np.uint64(1))
    assert p[1].check_structure() == j[1].check_structure()


def test_delete_key_range(eight_devices):
    """``KEY_MIN`` and ``KEY_MAX`` are ordinary keys; keys outside them
    (the fence sentinels) raise ``KeyRangeError``, as in JAX."""
    j, p = _pair(1, 64)
    keys = np.array([KEY_MIN, 5, 77, KEY_MAX], np.uint64)
    _load(j, p, keys, keys)
    f = _delete_both(j, p, np.array([KEY_MAX, KEY_MIN, 6], np.uint64),
                     "sentinels")
    np.testing.assert_array_equal(f, [True, True, False])
    _, found = _search_both(j, p, keys)
    np.testing.assert_array_equal(found, [False, True, True, False])
    for bad in ([0], [2**64 - 1], [5, 0]):
        with pytest.raises(KeyRangeError):
            p[2].delete(np.array(bad, np.uint64))
        with pytest.raises(ValueError):
            j[2].delete(np.array(bad, np.uint64))
    assert p[1].delete(KEY_MAX) is j[1].delete(KEY_MAX) is False


def test_delete_path_counts_no_kernel_launch_on_cpu(eight_devices):
    _, p = _pair(1, 64)
    keys = np.arange(1, 400, dtype=np.uint64) * 3
    p[2].insert(keys, keys)
    PK.reset_launches()
    assert p[2].delete(keys[::2]).all()
    assert PK.LAUNCHES == {"descent_round": 0, "gather_pages": 0,
                           "writeback": 0}
