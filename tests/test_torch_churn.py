"""Port parity: a drifting-keyspace churn (``tools/churn_bench.py``'s
loop at a small size: insert the next key window, delete the oldest, one
``reclaim_empty_leaves`` pass an iteration) on a bounded pool, against the
JAX package at one node and at eight.

Both packages run the same seeded numpy inputs.  After every insert,
delete and reclaim pass the pools, lock tables, counters, dirty sets,
allocator states (bump pointers, leases, free lists), grant caches,
pending parent entries, reclaim state and router tables must be
bit-identical, and the stats dicts equal.  The JAX side runs as its own
tests run it (``gather_impl="xla"``, the ``eight_devices`` fixture).
Every tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models import validate as TV
from sherman_tpu_torch.models.btree import Tree

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
# A drifting-keyspace churn on a bounded pool.
# ---------------------------------------------------------------------------

def _stream_keys(i, streams):
    i = np.asarray(i, np.uint64)
    return ((i % np.uint64(streams)) << np.uint64(44)) \
        | ((i // np.uint64(streams)) + np.uint64(1))


@pytest.mark.parametrize("n", [1, 8])
def test_churn_on_a_bounded_pool(eight_devices, n):
    """``tools/churn_bench.py``'s loop at a small size: 16 append streams,
    each iteration inserts the next window in ascending shuffled chunks,
    deletes the oldest window and runs one reclaim pass.  The port matches
    JAX after every iteration, the pool never runs dry although the
    iterations allocate more pages than it holds, and at the end every
    live key reads back, no deleted key does, and the live slots count
    the live keys exactly."""
    B = 256 if n == 1 else 32
    live_n, window, iters = (1600, 400, 12) if n == 1 else (3200, 800, 12)
    pages = 210 if n == 1 else 64
    j, p = _pair(n, B, pages=pages, chunk_pages=8,
                 split_slots=B // 2)
    for e in (j[2], p[2]):
        e.parent_flush_threshold = e.split_slots
    warm = np.sort(_stream_keys(np.arange(live_n), 16))
    _load(j, p, warm, warm ^ np.uint64(0xBEEF), fill=0.5)
    spare = sum(pages - d.allocator.pages_used for d in p[0].directories)
    rng = np.random.default_rng(23)
    lo, hi = 0, live_n
    grants = 0
    for it in range(iters):
        fresh = _stream_keys(np.arange(hi, hi + window), 16)
        for i in range(0, window, B * n):
            ck = fresh[i:i + B * n].copy()
            rng.shuffle(ck)
            st = _both(j, p, f"insert {it}",
                       lambda e: e.insert(ck, ck ^ np.uint64(0xBEEF),
                                          max_rounds=24))
            assert st["host_path"] == 0
            grants += st.get("device_splits", 0)
        dead = _stream_keys(np.arange(lo, lo + window), 16)
        f = _both(j, p, f"delete {it}", lambda e: e.delete(dead))
        assert f.all()
        lo, hi = lo + window, hi + window
        _reclaim(j, p, f"reclaim {it}")
    assert grants > spare      # more pages than the pool had left
    live = _stream_keys(np.arange(lo, hi), 16)
    vals, found = _search_both(j, p, live)
    assert found.all() and (vals == live ^ np.uint64(0xBEEF)).all()
    assert not _search_both(j, p, dead)[1].any()
    assert int(TV.leaf_chain_info(p[1])[4].sum()) == live.size
    assert p[2]._reclaim_state["round"] == iters
