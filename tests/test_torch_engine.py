"""Port parity: the one-node serving path of ``sherman_tpu_torch`` (bulk
load, routed lookups, request combining, the fused read/update step)
against the JAX package with ``DSMConfig(machine_nr=1,
gather_impl="xla")``, on the same seeded numpy keys.

Both packages build and serve the same tree; after every phase the pools
must be bit-identical and the answers, statuses, counters and dirty sets
equal.  The state hand-over (``state.from_jax_arrays``), the workload
generator on its numpy and native paths, the router and the import
hygiene of the port are pinned here too.  Every tolerance is exact equality.
"""

import os
import re

import numpy as np
import pytest
import torch

from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models import router as JR
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.workload import zipf as JZ
from sherman_tpu_torch import state
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import ConfigError, KeyRangeError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models import router as TR
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.workload import zipf as TZ

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(machine_nr=1, pages_per_node=1024, locks_per_node=256,
          step_capacity=256, chunk_pages=32)
BATCH = 256
VXOR = np.uint64(0xBEEF)


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    ks = np.unique(rng.integers(1, 1 << 63, n + n // 8 + 16,
                                dtype=np.uint64))
    rng.shuffle(ks)
    return ks[:n], rng


def _pair(n_keys, seed, budget=2):
    """Both packages' engines over a bulk-loaded tree of the same keys.
    -> (jax side, port side, keys, rng); each side is (cluster, tree,
    engine)."""
    tcj, tct = (JTreeConfig(sibling_chase_budget=budget),
                TreeConfig(sibling_chase_budget=budget))
    jc = JCluster(JDSMConfig(gather_impl="xla", **KW))
    jt = JTree(jc)
    je = JB.BatchedEngine(jt, batch_per_node=BATCH, tcfg=tcj)
    pc = Cluster(DSMConfig(device="cpu", **KW))
    pt = Tree(pc)
    pe = TB.BatchedEngine(pt, batch_per_node=BATCH, tcfg=tct)
    keys, rng = _keys(seed, n_keys)
    sj = JB.bulk_load(jt, keys, keys ^ VXOR)
    st = TB.bulk_load(pt, keys, keys ^ VXOR)
    assert sj == st
    return (jc, jt, je), (pc, pt, pe), keys, rng


def _same_state(j, p, what):
    jc, pc = j[0], p[0]
    np.testing.assert_array_equal(pc.dsm.pool.numpy(),
                                  np.asarray(jc.dsm.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(pc.dsm.locks.numpy(),
                                  np.asarray(jc.dsm.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(pc.dsm.counters_np(),
                                  np.asarray(jc.dsm.counters),
                                  err_msg=what + " counters")
    np.testing.assert_array_equal(pc.dsm.dirty_rows(), jc.dsm.dirty_rows(),
                                  err_msg=what + " dirty rows")
    assert (p[1]._root_addr, p[1]._root_level) == \
        (j[1]._root_addr, j[1]._root_level), what


def _same_out(a, b, what):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} output {i}")


# ---------------------------------------------------------------------------
# Bulk load.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_keys,seed", [(1, 0), (600, 1), (5000, 2)])
def test_bulk_load_pool_bit_identical(n_keys, seed):
    j, p, keys, _ = _pair(n_keys, seed)
    _same_state(j, p, "bulk_load")
    for a, b in zip(p[1]._bulk_leaf_dir, j[1]._bulk_leaf_dir):
        np.testing.assert_array_equal(a, b)
    assert [d.allocator.pages_used for d in p[0].directories] == \
        [d.allocator.pages_used for d in j[0].directories]
    if n_keys == 5000:
        assert p[1]._root_level == 2          # two internal levels


def test_bulk_load_refuses_bad_input():
    pc = Cluster(DSMConfig(device="cpu", **KW))
    pt = Tree(pc)
    with pytest.raises(ConfigError, match="unique"):
        TB.bulk_load(pt, np.array([5, 9, 5], np.uint64),
                     np.zeros(3, np.uint64))
    TB.bulk_load(pt, np.array([5, 9], np.uint64), np.zeros(2, np.uint64))
    with pytest.raises(ConfigError, match="empty tree"):
        TB.bulk_load(pt, np.array([11], np.uint64), np.zeros(1, np.uint64))


# ---------------------------------------------------------------------------
# Lookups.
# ---------------------------------------------------------------------------

def _queries(rng, keys, n, absent_frac=0.2):
    """Zipf-skewed (duplicate-heavy) present keys plus absent keys."""
    z = TZ.ZipfGen(len(keys), 0.99, rng=rng)
    q = keys[z.sample(n)]
    k = int(n * absent_frac)
    q[:k] = rng.integers(1, 1 << 63, k, dtype=np.uint64) | np.uint64(1)
    rng.shuffle(q)
    return q


@pytest.mark.parametrize("scan", [True, False])
def test_search_and_search_combined_parity(scan):
    j, p, keys, rng = _pair(3000, 3)
    j[2].attach_router(scan=scan)
    p[2].attach_router(scan=scan)
    if not scan:  # a cold router: every start is the root
        j[1]._bulk_leaf_dir = p[1]._bulk_leaf_dir = None
        j[2].attach_router(scan=False)
        p[2].attach_router(scan=False)
        assert (p[2].router.table_np == p[1]._root_addr).all()
    for step in range(3):
        q = _queries(rng, keys, 600)
        for fn in ("search", "search_combined"):
            want = getattr(j[2], fn)(q)
            got = getattr(p[2], fn)(q)
            _same_out(got, want, f"{fn} step {step}")
            _same_state(j, p, f"{fn} step {step}")
    vals, found = got
    present = np.isin(q, keys)
    assert found[present].all() and not found[~present].any()
    np.testing.assert_array_equal(vals[present], q[present] ^ VXOR)


def test_search_without_router_and_scanned_router():
    j, p, keys, rng = _pair(2500, 4)
    q = _queries(rng, keys, 300)
    _same_out(p[2].search(q), j[2].search(q), "root descent")
    _same_out(p[2].search_combined(q), j[2].search_combined(q),
              "combined without router")
    _same_state(j, p, "no router")
    # a router seeded from a scan of the pool, not the bulk directory
    j[1]._bulk_leaf_dir = p[1]._bulk_leaf_dir = None
    j[2].attach_router()
    p[2].attach_router()
    np.testing.assert_array_equal(p[2].router.table_np, j[2].router.table_np)
    _same_out(p[2].search_combined(q), j[2].search_combined(q), "scanned")
    _same_state(j, p, "scanned router")
    with pytest.raises(KeyRangeError):
        p[2].search(np.array([0], np.uint64))


# ---------------------------------------------------------------------------
# The fused read/update step.
# ---------------------------------------------------------------------------

def _mixed_batch(rng, keys, n, step, fresh):
    q = keys[TZ.ZipfGen(len(keys), 0.99, rng=rng).sample(n)]
    q[:3] = q[3]                              # a same-key run
    if fresh is not None:
        q[-len(fresh):] = fresh
    is_read = rng.random(n) < 0.5
    is_read[:2] = False                       # duplicate writes of q[3]
    is_read[-len(fresh) if fresh is not None else n:] = False
    vals = q ^ np.uint64(0x9E3779B97F4A7C15 * (step + 1) % 2**64)
    vals[0] ^= np.uint64(1)                   # same key, other values
    return q, vals, is_read


@pytest.mark.parametrize("routed", [True, False])
def test_mixed_parity(routed):
    j, p, keys, rng = _pair(4000, 5)
    if routed:
        j[2].attach_router()
        p[2].attach_router()
    expect = dict(zip(keys.tolist(), (keys ^ VXOR).tolist()))
    for step in range(4):
        # fresh keys that fit the leaves' slack, on steps 1 and 3
        fresh = None
        if step % 2:
            fresh = rng.integers(1, 1 << 63, 8, dtype=np.uint64)
            fresh = fresh[~np.isin(fresh, keys)]
        q, v, is_read = _mixed_batch(rng, keys, BATCH, step, fresh)
        want = j[2].mixed(q, v, is_read)
        got = p[2].mixed(q, v, is_read)
        _same_out(got, want, f"mixed step {step}")
        _same_state(j, p, f"mixed step {step}")
        out, found, st = got
        w = ~is_read
        assert set(np.unique(st[w])) <= {TB.ST_APPLIED, TB.ST_SUPERSEDED}
        assert (st[w] == TB.ST_APPLIED).sum() == np.unique(q[w]).size
        # reads see the pre-step value (single-snapshot step)
        r = np.nonzero(is_read)[0]
        pre = np.array([expect.get(int(k), 0) for k in q[r]], np.uint64)
        np.testing.assert_array_equal(out[r], pre)
        # the lowest-index write of each key wins
        for i in np.nonzero(w)[0][::-1]:
            expect[int(q[i])] = int(v[i])
        if fresh is not None:
            keys = np.concatenate([keys, fresh])
    probe = np.array(list(expect), np.uint64)[:BATCH]
    _same_out(p[2].search(probe), j[2].search(probe), "final search")
    np.testing.assert_array_equal(
        p[2].search(probe)[0], np.array([expect[int(k)] for k in probe],
                                        np.uint64))


def test_mixed_refuses_writes_that_need_the_split_path():
    """Fresh keys below the first leaf's keys: that leaf cannot take them
    all, so the fused step reports ST_FULL for some.  The port once
    refused these writes; now ``mixed`` retries them through ``insert``
    (device splits) as the reference does, with the same statuses, pool
    and counters."""
    j, p, keys, rng = _pair(200, 6)
    j[2].attach_router()
    p[2].attach_router()
    leaf_lo = np.sort(keys)[0]
    fresh = np.arange(1, 40, dtype=np.uint64)   # all below the first leaf
    fresh = fresh[fresh < leaf_lo]
    q = np.concatenate([fresh, fresh[:3], keys[:5]])
    is_read = np.zeros(q.size, bool)
    is_read[-5:] = True
    want = j[2].mixed(q, q ^ VXOR, is_read)
    got = p[2].mixed(q, q ^ VXOR, is_read)
    _same_out(got, want, "mixed through the split path")
    _same_state(j, p, "mixed through the split path")
    st = got[2]
    np.testing.assert_array_equal(st[:fresh.size], TB.ST_APPLIED)
    np.testing.assert_array_equal(st[fresh.size:fresh.size + 3],
                                  TB.ST_SUPERSEDED)
    vals, found = p[2].search(fresh)
    assert found.all() and (vals == fresh ^ VXOR).all()


# ---------------------------------------------------------------------------
# State hand-over, workload, router.
# ---------------------------------------------------------------------------

def test_from_jax_arrays_serves_the_jax_tree():
    j, _, keys, rng = _pair(3000, 7)
    jc, jt, je = j
    je.attach_router()
    q = _queries(rng, keys, 400)
    je.search_combined(q)                    # counters move before export
    pc, pt, pe = state.from_jax_arrays(
        np.asarray(jc.dsm.pool), np.asarray(jc.dsm.locks),
        np.asarray(jc.dsm.counters), jt._root_addr, jt._root_level,
        jc.directories[0].allocator.pages_used, jt._bulk_leaf_dir,
        device="cpu", batch_per_node=BATCH,
        tcfg=TreeConfig(sibling_chase_budget=2), chunk_pages=32,
        step_capacity=256)
    np.testing.assert_array_equal(pc.dsm.pool.numpy(),
                                  np.asarray(jc.dsm.pool))
    np.testing.assert_array_equal(pc.dsm.counters_np(),
                                  np.asarray(jc.dsm.counters))
    assert pc.directories[0].allocator.pages_used == \
        jc.directories[0].allocator.pages_used
    pe.attach_router()
    np.testing.assert_array_equal(pe.router.table_np, je.router.table_np)
    port = (pc, pt, pe)
    _same_out(pe.search_combined(q), je.search_combined(q), "handed over")
    qm, vm, rm = _mixed_batch(rng, keys, BATCH, 0, None)
    _same_out(pe.mixed(qm, vm, rm), je.mixed(qm, vm, rm), "mixed")
    np.testing.assert_array_equal(pc.dsm.pool.numpy(),
                                  np.asarray(jc.dsm.pool))
    np.testing.assert_array_equal(pc.dsm.counters_np(),
                                  np.asarray(jc.dsm.counters))
    assert port[1]._root_addr == jt._root_addr
    with pytest.raises(ConfigError, match="meta word"):
        state.from_jax_arrays(np.asarray(jc.dsm.pool),
                              np.asarray(jc.dsm.locks),
                              np.asarray(jc.dsm.counters), 3, 0, 10,
                              device="cpu")


@pytest.mark.parametrize("n,theta,seed", [(1000, 0.99, 0), (7, 0.5, 1),
                                          (100_000, 0.99, 2)])
def test_zipf_numpy_path_matches(n, theta, seed):
    ref = JZ.ZipfGen.__new__(JZ.ZipfGen)
    ref.n, ref.theta, ref._native = n, theta, None
    ref.rng = np.random.default_rng(seed)
    ref._init_fallback()
    # the port's numpy path is the one with a generator handed in
    got = TZ.ZipfGen(n, theta, rng=np.random.default_rng(seed))
    assert got._native is None
    for size in (1, 500, 4096):
        np.testing.assert_array_equal(got.sample(size), ref.sample(size))
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(TZ.uniform_ranks(n, 100, rng_a),
                                  JZ.uniform_ranks(n, 100, rng_b))


@pytest.mark.parametrize("n,theta,seed", [(1000, 0.99, 0), (7, 0.5, 1),
                                          (100_000, 0.99, 2)])
def test_zipf_native_path_matches(n, theta, seed):
    """Without a generator both packages draw from their native samplers:
    the same ranks for the same seed."""
    ref, got = JZ.ZipfGen(n, theta, seed=seed), TZ.ZipfGen(n, theta,
                                                            seed=seed)
    assert ref._native is not None and got._native is not None
    for size in (1, 500, 4096):
        s = got.sample(size)
        assert s.dtype == np.int64
        np.testing.assert_array_equal(s, ref.sample(size))


def test_router_matches():
    j, p, keys, rng = _pair(2000, 8)
    for n in (1, 40, 10**6, 10**8):
        assert TR.default_log2_buckets(n) == JR.default_log2_buckets(n)
    jr, pr = JR.LeafRouter(j[1], 10), TR.LeafRouter(p[1], 10)
    jr.seed_from_leaves(*j[1]._bulk_leaf_dir)
    pr.seed_from_leaves(*p[1]._bulk_leaf_dir)
    np.testing.assert_array_equal(pr.table_np, jr.table_np)
    for split_key, new_addr, old_high in (
            (int(np.sort(keys)[700]), 77, int(np.sort(keys)[740])),
            (2**63 + 5, 78, 2**64 - 1),          # grows the span
            (2**62, 79, 2**62 + 2**50)):
        jr.note_split(split_key, new_addr, old_high)
        pr.note_split(split_key, new_addr, old_high)
        np.testing.assert_array_equal(pr.table_np, jr.table_np)
        assert (pr.shift, pr.span_grows) == (jr.shift, jr.span_grows)
    khi = rng.integers(-2**31, 2**31, 500, dtype=np.int64).astype(np.int32)
    klo = rng.integers(-2**31, 2**31, 500, dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(pr.host_start(khi, klo),
                                  jr.host_start(khi, klo))


def test_engine_paths_count_no_kernel_launch_on_cpu():
    _, p, keys, rng = _pair(500, 9)
    p[2].attach_router()
    PK.reset_launches()
    p[2].search_combined(keys[:100])
    p[2].mixed(keys[:50], keys[:50], np.arange(50) % 2 == 0)
    assert PK.LAUNCHES == {"descent_round": 0, "gather_pages": 0,
                           "writeback": 0}


# ---------------------------------------------------------------------------
# Import hygiene: the port stands alone.
# ---------------------------------------------------------------------------

_IMPORT = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.M)


def _imports(path):
    with open(path) as f:
        return _IMPORT.findall(f.read())


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "sherman_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 17
    obs_dir = os.path.join(REPO, "sherman_tpu_torch", "obs")
    assert {os.path.basename(f) for f in files
            if os.path.dirname(f) == obs_dir} >= {
        "__init__.py", "registry.py", "spans.py", "slo.py", "recorder.py",
        "export.py", "device.py"}
    models_dir = os.path.join(REPO, "sherman_tpu_torch", "models")
    assert {os.path.basename(f) for f in files
            if os.path.dirname(f) == models_dir} >= {
        "batched.py", "leaf_cache.py", "value_heap.py"}
    top_dir = os.path.join(REPO, "sherman_tpu_torch")
    assert {os.path.basename(f) for f in files
            if os.path.dirname(f) == top_dir} >= {
        "serve.py", "audit.py", "replica.py", "serve_bench.py", "chaos.py",
        "failover_drill.py", "partition_drill.py", "migrate.py",
        "reshard_drill.py", "contract_drill.py", "multihost.py",
        "hostlease.py", "multihost_drill.py", "hostfail_drill.py"}
    utils_dir = os.path.join(REPO, "sherman_tpu_torch", "utils")
    assert {os.path.basename(f) for f in files
            if os.path.dirname(f) == utils_dir} >= {
        "checkpoint.py", "journal.py", "reshard.py"}
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "sherman_tpu"), \
                f"{os.path.relpath(path, REPO)} imports {mod}"
        with open(path) as f:
            src = f.read()
        assert "sherman_tpu." not in src.replace("sherman_tpu_torch", ""), \
            f"{os.path.relpath(path, REPO)} names the JAX package"
