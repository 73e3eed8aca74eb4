"""Port parity: range scans (``BatchedEngine.range_query``,
``range_query_many`` and the host ``Tree.range_query``) against the JAX
package on the same trees, at one node and at eight.

Both packages build the same tree from the same seeded numpy keys and go
through the same writes; every scan must return the same sorted (keys,
values) per range, equal to a host mirror of the live set, and leave the
pools and counters equal (the chain walks' host page reads count).  The
cases: a fresh bulk load with the router, no router, inserts that split
(the router noted), deletes and ``reclaim_empty_leaves`` with ranges over
the unlinked region (the router remapped, and stale at retired pages), a
stale router after splits, ranges past both ends of the key space and of
the router's span, empty, overlapping and whole-keyspace ranges, and the
refusal of malformed ranges.  The JAX side runs as its own tests run it
(``gather_impl="xla"``, the ``eight_devices`` fixture).  Every tolerance
is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu_torch import config as C
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits as TBits

torch.set_num_threads(1)


def _pair(n, B, *, pages=512):
    kw = dict(machine_nr=n, pages_per_node=pages, locks_per_node=512,
              step_capacity=B, chunk_pages=16)
    jc = JCluster(JDSMConfig(gather_impl="xla", **kw))
    jt = JTree(jc)
    je = JB.BatchedEngine(jt, batch_per_node=B, write_combine=False)
    pc = Cluster(DSMConfig(device="cpu", **kw))
    pt = Tree(pc)
    pe = TB.BatchedEngine(pt, batch_per_node=B, write_combine=False)
    return (jc, jt, je), (pc, pt, pe)


def _load(j, p, keys, vals, router=True):
    assert JB.bulk_load(j[1], keys, vals) == TB.bulk_load(p[1], keys, vals)
    if router:
        j[2].attach_router()
        p[2].attach_router()


def _both(j, p, fn):
    out_p, out_j = fn(p[2]), fn(j[2])
    if isinstance(out_p, np.ndarray):
        np.testing.assert_array_equal(out_p, out_j)
    else:
        assert out_p == out_j
    return out_p


def _same_state(j, p, what):
    np.testing.assert_array_equal(p[0].dsm.pool.numpy(),
                                  np.asarray(j[0].dsm.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(p[0].dsm.counters_np(),
                                  np.asarray(j[0].dsm.counters),
                                  err_msg=what + " counters")


def _scan(j, p, ranges, live: dict, what: str):
    """Both engines' ``range_query_many``: equal to each other and to the
    mirror ``live`` ({key: value}); the first ranges again one by one."""
    got = p[2].range_query_many(ranges)
    want = j[2].range_query_many(ranges)
    assert len(got) == len(want) == len(ranges)
    mk = np.array(sorted(live), np.uint64)
    for r, (gk, gv), (wk, wv) in zip(ranges, got, want):
        assert gk.dtype == gv.dtype == np.uint64, (what, r)
        np.testing.assert_array_equal(gk, wk, err_msg=f"{what} {r} keys")
        np.testing.assert_array_equal(gv, wv, err_msg=f"{what} {r} vals")
        ek = mk[(mk >= np.uint64(r[0])) & (mk < np.uint64(r[1]))]
        np.testing.assert_array_equal(gk, ek, err_msg=f"{what} {r} mirror")
        np.testing.assert_array_equal(
            gv, np.array([live[int(k)] for k in ek], np.uint64))
    for r in ranges[:3]:
        for x, y in zip(p[2].range_query(*r), j[2].range_query(*r)):
            np.testing.assert_array_equal(x, y)
    _same_state(j, p, what)
    return got


def _ranges(rng, keys, n=24):
    """Spans between random keys (some long, some crossing many leaves),
    overlapping pairs, tiny and empty ranges, and ranges past both ends
    and over the whole key space."""
    k = np.sort(keys)
    out = []
    for _ in range(n):
        i = int(rng.integers(0, k.size - 1))
        w = int(rng.choice([1, 3, 40, 300]))
        out.append((int(k[i]), int(k[min(k.size - 1, i + w)]) + 1))
    out += [out[0], (out[0][0] + 1, out[0][1] + 5),       # overlapping
            (int(k[7]) + 1, int(k[7]) + 2),                # likely empty
            (C.KEY_MIN, int(k[0]) + 1),                    # below the first
            (int(k[-1]), int(k[-1]) + 1000),               # past the last
            (int(k[-1]) + 1, C.KEY_POS_INF),               # past, to +inf
            (C.KEY_MIN, C.KEY_POS_INF)]                    # everything
    return out


def _mix_keys(n, salt=0x5E17AB1E5A17):
    return np.unique(TBits.mix64_np(np.arange(n, dtype=np.uint64)
                                    ^ np.uint64(salt)))


@pytest.mark.parametrize("n", [1, 8])
def test_scan_fresh_bulk_load_with_router(eight_devices, n):
    """Keys over the whole 64-bit space: the router's buckets span it, the
    prefetch covers every range, the start leaf is a binary search."""
    j, p = _pair(n, 64)
    keys = _mix_keys(3000 * n)
    vals = keys ^ np.uint64(0xD00D)
    _load(j, p, keys, vals)
    got = _scan(j, p, _ranges(np.random.default_rng(1), keys),
                dict(zip(keys.tolist(), vals.tolist())), "fresh")
    assert sum(len(g[0]) for g in got) > keys.size


@pytest.mark.parametrize("n", [1, 8])
def test_scan_without_router_and_narrow_keyspace(eight_devices, n):
    """No router: every range descends from the root and walks.  Then a
    router seeded on keys below 2^24: ranges far past its span clamp to
    its last bucket."""
    j, p = _pair(n, 64)
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(1, 1 << 24, 500 * n, dtype=np.uint64))
    vals = keys * np.uint64(3)
    _load(j, p, keys, vals, router=False)
    live = dict(zip(keys.tolist(), vals.tolist()))
    ranges = _ranges(rng, keys) + [(1 << 30, 1 << 40), (3, 4)]
    _scan(j, p, ranges, live, "no router")
    j[2].attach_router()
    p[2].attach_router()
    np.testing.assert_array_equal(p[2].router.table_np, j[2].router.table_np)
    _scan(j, p, ranges, live, "narrow router")


@pytest.mark.parametrize("n", [1, 8])
def test_scan_after_splits_with_router_noted_and_stale(eight_devices, n):
    """Inserts that split leaves (the router notes the splits), then the
    bulk-load router table put back: stale entries name leaves whose
    ranges moved right, so walks read chain gaps through the DSM and later
    ranges start inside those pages."""
    j, p = _pair(n, 64)
    keys = _mix_keys(400 * n)
    vals = keys ^ np.uint64(0xD00D)
    _load(j, p, keys, vals)
    stale = p[2].router.table_np.copy()
    assert np.array_equal(stale, j[2].router.table_np)
    rng = np.random.default_rng(3)
    extra = np.setdiff1d(keys + np.uint64(1), keys)
    st = _both(j, p, lambda e: e.insert(extra, extra ^ np.uint64(5)))
    assert st["device_splits"] > keys.size // 49
    live = dict(zip(keys.tolist(), vals.tolist()))
    live.update(zip(extra.tolist(), (extra ^ np.uint64(5)).tolist()))
    allk = np.array(sorted(live), np.uint64)
    ranges = _ranges(rng, allk)
    before = p[0].dsm.counters_np().sum()
    _scan(j, p, ranges, live, "splits, router noted")
    for e in (p[2], j[2]):
        e.router.table_np = stale.copy()
    _scan(j, p, ranges, live, "splits, stale router")
    assert p[0].dsm.counters_np().sum() > before   # chain-gap reads


@pytest.mark.parametrize("n", [1, 8])
def test_scan_after_reclaim_over_unlinked_leaves(eight_devices, n):
    """Deletes empty a band of leaves and reclaim unlinks them: scans over
    and across the band walk the bypass links, with the router remapped by
    the reclaim, and with the table from before the reclaim (stale entries
    at retired pages, ``highest == 0``, which no start test picks)."""
    B = 128 if n == 1 else 32
    j, p = _pair(n, B, pages=256)
    m = 2000 * n
    keys = np.arange(1, m + 1, dtype=np.uint64) * np.uint64(7)
    vals = keys + np.uint64(1)
    _load(j, p, keys, vals)
    i = np.arange(m)
    dead = keys[(i > m // 5) & (i < m // 2)]
    _both(j, p, lambda e: e.delete(dead))
    stale = p[2].router.table_np.copy()
    recl = [_both(j, p, lambda e: e.reclaim_empty_leaves())
            for _ in range(2)]
    assert recl[0]["unlinked"] > 0
    assert not np.array_equal(p[2].router.table_np, stale)
    kept = np.setdiff1d(keys, dead)
    live = dict(zip(kept.tolist(), (kept + np.uint64(1)).tolist()))
    band = [(int(dead[0]) - 20, int(dead[-1]) + 20),
            (int(dead[10]), int(dead[-10])),
            (int(dead[0]), int(dead[0]) + 7 * 60),
            (int(dead[-1]) - 100, int(kept[-1]))]
    ranges = band + _ranges(np.random.default_rng(5), kept, 12)
    _scan(j, p, ranges, live, "reclaim, router remapped")
    for e in (p[2], j[2]):
        e.router.table_np = stale.copy()
    _scan(j, p, ranges, live, "reclaim, stale router")


@pytest.mark.parametrize("n", [1, 8])
def test_scan_deletes_and_inserts_reflected(eight_devices, n):
    """The JAX package's own case: keys 10, 20, ..., 4990 with no router,
    two deletes and an insert between them; then with a router attached
    before the writes and left as it was."""
    for router in (False, True):
        j, p = _pair(n, 64)
        keys = np.arange(10, 5000, 10, dtype=np.uint64)
        _load(j, p, keys, keys, router=router)
        live = {int(k): int(k) for k in keys}
        got = _scan(j, p, [(100, 1000)], live, "before")
        np.testing.assert_array_equal(got[0][0],
                                      np.arange(100, 1000, 10, np.uint64))
        _both(j, p, lambda e: e.delete(np.array([100, 110], np.uint64)))
        _both(j, p, lambda e: e.insert(np.array([105], np.uint64),
                                       np.array([1], np.uint64)))
        del live[100], live[110]
        live[105] = 1
        got = _scan(j, p, [(100, 130), (95, 4995), (4990, C.KEY_POS_INF)],
                    live, f"after writes (router {router})")
        np.testing.assert_array_equal(got[0][0], [105, 120])
        np.testing.assert_array_equal(got[0][1], [1, 120])


@pytest.mark.parametrize("n", [1, 8])
def test_tree_range_query(eight_devices, n):
    """The host ``Tree.range_query`` (descent and chain walk, one DSM read
    a page) against JAX's on a split tree: the same dicts, the same
    counters, and the engine's scan of the same range."""
    j, p = _pair(n, 64)
    keys = _mix_keys(400 * n)
    _load(j, p, keys, keys ^ np.uint64(0xD00D))
    extra = np.setdiff1d(keys[::3] + np.uint64(2), keys)
    _both(j, p, lambda e: e.insert(extra, extra))
    rng = np.random.default_rng(11)
    for lo, hi in _ranges(rng, keys, 8):
        got, want = p[1].range_query(lo, hi), j[1].range_query(lo, hi)
        assert got == want
        ek, ev = p[2].range_query(lo, hi)
        for x, y in zip((ek, ev), j[2].range_query(lo, hi)):
            np.testing.assert_array_equal(x, y)
        assert sorted(got.items()) == list(zip(ek.tolist(), ev.tolist()))
    _same_state(j, p, "Tree.range_query")


def test_malformed_ranges_refused(eight_devices):
    """``lo < hi`` inside [KEY_MIN, KEY_POS_INF]: anything else is refused
    before any work, as the reference's scan refuses it.  (JAX's engine
    method converts the bounds to uint64 for its multihost check first,
    which raises ``OverflowError`` on ``hi > KEY_POS_INF``; the port has
    no multihost check, and its scan asserts.)"""
    j, p = _pair(1, 64)
    keys = np.arange(1, 200, dtype=np.uint64)
    _load(j, p, keys, keys)
    for bad in ((0, 5), (5, 5), (6, 5), (1, C.KEY_POS_INF + 1)):
        for scan in (p[2].range_query_many,
                     lambda r: TB.range_query_many(p[2], r),
                     lambda r: JB.range_query_many(j[2], r)):
            with pytest.raises(AssertionError):
                scan([(1, 3), bad])
    assert p[2].range_query_many([]) == j[2].range_query_many([]) == []
    _same_state(j, p, "refused")
