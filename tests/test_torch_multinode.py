"""Port parity: the multi-node serving path of ``sherman_tpu_torch`` (N
emulated nodes on one device) against the JAX package on 4 and 8 virtual
CPU devices.

Both packages run the same seeded numpy inputs: host DSM steps (a
cross-node CAS race, FAA prefixes, bucket overflow), bulk load, routed
and root-seeded lookups, request combining, the fused read/update step,
a step capacity small enough to overflow buckets, and the hand-over of a
4-node JAX tree.  After every phase the node-major pools, lock tables,
counters and dirty sets must be bit-identical and the replies, answers
and statuses equal.  The JAX side runs with ``exchange_impl="xla"``, and
with ``"pallas"`` (interpret mode) where the cost allows.  Every tolerance
is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.parallel import dsm as JD
from sherman_tpu_torch import state
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import dsm as D
from sherman_tpu_torch.parallel import transport_kernel as TK
from sherman_tpu_torch.workload import zipf as TZ

torch.set_num_threads(1)

B = 64                                   # batch rows per node
VXOR = np.uint64(0xC0FFEE)


def _kw(n, cap=64, **kw):
    return dict(machine_nr=n, pages_per_node=128, locks_per_node=64,
                step_capacity=cap, chunk_pages=4, **kw)


def _same_state(jd, td, what):
    np.testing.assert_array_equal(td.pool.numpy(), np.asarray(jd.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(td.locks.numpy(), np.asarray(jd.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(td.counters_np(), np.asarray(jd.counters),
                                  err_msg=what + " counters")
    assert td.counter_snapshot() == jd.counter_snapshot(), what
    np.testing.assert_array_equal(td.dirty_rows(), jd.dirty_rows(),
                                  err_msg=what + " dirty")


def _same_out(a, b, what):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{what} output {i}")


# ---------------------------------------------------------------------------
# Host DSM steps.
# ---------------------------------------------------------------------------

def _dsm_pair(n, impl):
    kw = dict(_kw(n, cap=16), host_step_capacity=12)
    return (JD.DSM(JDSMConfig(exchange_impl=impl, **kw)),
            D.DSM(DSMConfig(device="cpu", **kw)))


def _both_step(j, t, reqs, what):
    rj, rt = j.step(reqs), t.step(reqs)
    for f in ("data", "old", "ok"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f),
                                      err_msg=f"{what} {f}")
    _same_state(j, t, what)
    return rt


@pytest.mark.parametrize("n,impl", [(4, "xla"), (4, "pallas"), (8, "xla")])
def test_dsm_steps_cross_node(eight_devices, n, impl):
    rng = np.random.default_rng(n)
    j, t = _dsm_pair(n, impl)
    R = 12                                # host step rows per node
    # pages written on every node, read back from every node
    addrs = [bits.make_addr(int(d), int(p)) for d, p in
             zip(rng.integers(0, n, 10), rng.integers(1, 128, 10))]
    for a in addrs:
        pg = rng.integers(-2**31, 2**31, 256, dtype=np.int64).astype(np.int32)
        j.write_page(a, pg)
        t.write_page(a, pg)
    _same_state(j, t, "write_page")
    np.testing.assert_array_equal(t.read_pages(addrs), j.read_pages(addrs))
    # one step, every node racing CAS on one lock word of node n-1 and on
    # one pool word of node 1, and adding to one pool word of node 2: the
    # CAS winner is the lowest row of the owner's source-major buffer and
    # every FAA sees its serial prefix
    reqs = D.empty_requests(n * R)
    lock_a, cas_a, faa_a = (bits.make_addr(n - 1, 7), bits.make_addr(1, 9),
                            bits.make_addr(2, 3))
    for s in range(n):
        for k, (op, a, sp, a0, a1) in enumerate([
                (D.OP_CAS, lock_a, D.SPACE_LOCK, 0, 100 + s),
                (D.OP_CAS, cas_a, D.SPACE_POOL, 0, 200 + s),
                (D.OP_FAA, faa_a, D.SPACE_POOL, 1 + 3 * s, 0),
                (D.OP_FAA, faa_a, D.SPACE_POOL, -(2**31) + s, 0),
                (D.OP_READ, bits.make_addr(n - 1 - s, 0), D.SPACE_POOL, 0, 0),
                (D.OP_READ_WORD, lock_a, D.SPACE_LOCK, 0, 0)]):
            row = s * R + k + (s % 3)         # not aligned across nodes
            reqs["op"][row], reqs["addr"][row] = op, a
            reqs["space"][row], reqs["arg0"][row] = sp, a0
            reqs["arg1"][row] = a1
            reqs["woff"][row] = 5 if sp == D.SPACE_POOL else 0
    rt = _both_step(j, t, reqs, "cas race / faa prefix")
    cas_ok = rt.ok[reqs["op"] == D.OP_CAS]
    assert cas_ok.sum() == 2                  # one winner per word
    assert t.read_word(lock_a, 0, D.SPACE_LOCK) == 100   # node 0 wins
    # a bucket overflow: every node sends 14 rows to node 0 (capacity 12)
    reqs = D.empty_requests(n * 16)
    reqs["op"][:] = D.OP_FAA
    reqs["addr"][:] = bits.make_addr(0, 5)
    reqs["woff"][:] = np.arange(n * 16) % 200
    reqs["arg0"][:] = 1
    reqs["op"][np.arange(n) * 16 + 14] = D.OP_NOP
    reqs["addr"][np.arange(n) * 16 + 15] = bits.make_addr(n, 1)  # no node
    rt = _both_step(j, t, reqs, "overflow")
    assert not rt.ok.all()
    old_t, ok_t = t.cas(cas_a, 5, 200, 9)
    old_j, ok_j = j.cas(cas_a, 5, 200, 9)
    assert (old_t, ok_t) == (old_j, ok_j) == (200, True)
    _same_state(j, t, "cas verb")
    with pytest.raises(ConfigError, match="node blocks"):
        t.step(D.empty_requests(n * 3 + 1))


@pytest.mark.parametrize("n", [2, 4])
def test_random_raw_steps_cross_node(eight_devices, n):
    """Seeded raw steps of every op kind from every node, colliding on a
    few words of each owner (``test_torch_dsm._random_step``): replies
    and the whole state equal the reference's after each step."""
    from test_torch_dsm import _random_step
    rng = np.random.default_rng(40 + n)
    j, t = _dsm_pair(n, "xla")
    for s in range(8):
        reqs = _random_step(rng, n, n * 12, 128, 64)
        _both_step(j, t, reqs, f"{n} nodes step {s}")


# ---------------------------------------------------------------------------
# Bulk load and serving.
# ---------------------------------------------------------------------------

def _keys(seed, n):
    rng = np.random.default_rng(seed)
    ks = np.unique(rng.integers(1, 1 << 63, n + n // 8 + 16,
                                dtype=np.uint64))
    rng.shuffle(ks)
    return ks[:n], rng


def _pair(n, n_keys, seed, cap=64, impl="xla"):
    tcj, tct = (JTreeConfig(sibling_chase_budget=2),
                TreeConfig(sibling_chase_budget=2))
    jc = JCluster(JDSMConfig(exchange_impl=impl, **_kw(n, cap)))
    jt = JTree(jc)
    je = JB.BatchedEngine(jt, batch_per_node=B, tcfg=tcj)
    pc = Cluster(DSMConfig(device="cpu", **_kw(n, cap)))
    pt = Tree(pc)
    pe = TB.BatchedEngine(pt, batch_per_node=B, tcfg=tct)
    keys, rng = _keys(seed, n_keys)
    assert JB.bulk_load(jt, keys, keys ^ VXOR) == \
        TB.bulk_load(pt, keys, keys ^ VXOR)
    return (jc, jt, je), (pc, pt, pe), keys, rng


def _queries(rng, keys, m):
    q = keys[TZ.ZipfGen(len(keys), 0.99, rng=rng).sample(m)]
    k = m // 5
    q[:k] = rng.integers(1, 1 << 63, k, dtype=np.uint64) | np.uint64(1)
    rng.shuffle(q)
    return q


@pytest.mark.parametrize("n", [4, 8])
def test_bulk_load_spreads_leaves_over_every_node(eight_devices, n):
    j, p, keys, _ = _pair(n, 1500, n)
    _same_state(j[0].dsm, p[0].dsm, "bulk_load")
    for a, b in zip(p[1]._bulk_leaf_dir, j[1]._bulk_leaf_dir):
        np.testing.assert_array_equal(a, b)
    used = [d.allocator.pages_used for d in p[0].directories]
    assert used == [d.allocator.pages_used for d in j[0].directories]
    assert all(u > 1 for u in used)               # every node holds pages
    assert bits.addr_node(p[1]._root_addr) == 0 or p[1]._root_level > 0
    leaf_nodes = set(int(a) >> 24 for a in p[1]._bulk_leaf_dir[0])
    assert leaf_nodes == set(range(n))
    # a router seeded from a scan of every node's pool, not the directory
    p[1]._bulk_leaf_dir = j[1]._bulk_leaf_dir = None
    p[2].attach_router()
    j[2].attach_router()
    np.testing.assert_array_equal(p[2].router.table_np, j[2].router.table_np)


@pytest.mark.parametrize("n,impl", [(4, "xla"), (8, "xla"), (4, "pallas")])
def test_search_and_search_combined_parity(eight_devices, n, impl):
    j, p, keys, rng = _pair(n, 1500, 10 + n, impl=impl)
    # root-seeded full descents, then a cold router, then a warm one
    for phase in ("no router", "cold router", "warm router"):
        if phase == "cold router":
            j[1]._bulk_leaf_dir = p[1]._bulk_leaf_dir = None
            j[2].attach_router(scan=False)
            p[2].attach_router(scan=False)
            assert (p[2].router.table_np == p[1]._root_addr).all()
        if phase == "warm router":
            j[2].attach_router()
            p[2].attach_router()
        q = _queries(rng, keys, n * B + 37)       # chunked past N*B
        for fn in ("search", "search_combined"):
            want = getattr(j[2], fn)(q)
            got = getattr(p[2], fn)(q)
            _same_out(got, want, f"{fn} {phase}")
            _same_state(j[0].dsm, p[0].dsm, f"{fn} {phase}")
    vals, found = got
    present = np.isin(q, keys)
    assert found[present].all() and not found[~present].any()
    np.testing.assert_array_equal(vals[present], q[present] ^ VXOR)


def _mixed_batch(rng, keys, m, step):
    q = keys[TZ.ZipfGen(len(keys), 0.99, rng=rng).sample(m)]
    q[:3] = q[3]                              # a same-key run
    is_read = rng.random(m) < 0.5
    is_read[:2] = False
    vals = q ^ np.uint64(0x9E3779B97F4A7C15 * (step + 1) % 2**64)
    vals[0] ^= np.uint64(1)
    return q, vals, is_read


@pytest.mark.parametrize("n", [4, 8])
def test_mixed_parity(eight_devices, n):
    j, p, keys, rng = _pair(n, 1500, 20 + n)
    j[2].attach_router()
    p[2].attach_router()
    expect = dict(zip(keys.tolist(), (keys ^ VXOR).tolist()))
    for step in range(3):
        q, v, is_read = _mixed_batch(rng, keys, n * B - 5, step)
        want = j[2].mixed(q, v, is_read)
        got = p[2].mixed(q, v, is_read)
        _same_out(got, want, f"mixed step {step}")
        _same_state(j[0].dsm, p[0].dsm, f"mixed step {step}")
        out, found, st = got
        w = ~is_read
        assert set(np.unique(st[w])) <= {TB.ST_APPLIED, TB.ST_SUPERSEDED}
        assert (st[w] == TB.ST_APPLIED).sum() == np.unique(q[w]).size
        r = np.nonzero(is_read)[0]
        np.testing.assert_array_equal(
            out[r], np.array([expect[int(k)] for k in q[r]], np.uint64))
        for i in np.nonzero(w)[0][::-1]:      # the lowest index wins
            expect[int(q[i])] = int(v[i])
    probe = np.array(list(expect), np.uint64)
    np.testing.assert_array_equal(p[2].search(probe)[0],
                                  np.array(list(expect.values()), np.uint64))
    _same_out(p[2].search_combined(probe), j[2].search_combined(probe),
              "read back")


def test_small_step_capacity_overflows_the_same_rows(eight_devices):
    """A step capacity below the per-destination load leaves rows
    unrouted: round 1 of a routed lookup and the write exchange both
    overflow.  The raw steps of both packages give the same done flags,
    ST_RETRY rows, pools and counters."""
    n, cap = 4, 6
    j, p, keys, rng = _pair(n, 1500, 31, cap=cap)
    j[2].attach_router()
    p[2].attach_router()
    je, pe = j[2], p[2]
    q, v, is_read = _mixed_batch(rng, keys, n * B, 0)
    khi, klo = bits.keys_to_pairs(q)
    vhi, vlo = bits.keys_to_pairs(v)
    start = pe.router.host_start(khi, klo)
    np.testing.assert_array_equal(start, je.router.host_start(khi, klo))
    iters = pe._iters()
    root = p[1]._root_addr
    # -- lookups: round 1 overflows, the straggler buffer resolves ---------
    act = np.ones(n * B, bool)
    fn = je._get_search(iters, True)
    jd = j[0].dsm
    jd.counters, *want = fn(jd.pool, jd.counters, je._shard(khi),
                            je._shard(klo), np.int32(root), je._shard(act),
                            je._shard(start))
    T = torch.from_numpy
    got = TB.search_routed_spmd(
        p[0].dsm.pool, p[0].dsm.counters, T(khi), T(klo), root, T(act),
        T(start), cfg=p[0].cfg, iters=iters)
    _same_out([g.numpy() for g in got], want, "routed search")
    _same_state(jd, p[0].dsm, "routed search")
    # -- the fused step: writes past the capacity come back ST_RETRY -------
    fn = je._get_mixed(iters, True)
    (jd.pool, jd.counters, jd.dirty, *want) = fn(
        jd.pool, jd.locks, jd.counters, jd.dirty, je._shard(khi),
        je._shard(klo), je._shard(vhi), je._shard(vlo), np.int32(root),
        je._shard(is_read), je._shard(~is_read), je._shard(start))
    td = p[0].dsm
    got = TB.mixed_step_spmd(
        td.pool, td.locks, td.counters, T(khi), T(klo), T(vhi), T(vlo),
        root, T(is_read), T(~is_read), T(start), cfg=p[0].cfg, iters=iters,
        dirty=td.dirty)
    _same_out([g.numpy() for g in got], want, "mixed step")
    _same_state(jd, td, "mixed step")
    st = got[0].numpy()
    assert (st[~is_read] == TB.ST_RETRY).any()
    assert (st[~is_read] == TB.ST_APPLIED).any()


# ---------------------------------------------------------------------------
# State hand-over and dispatch.
# ---------------------------------------------------------------------------

def test_from_jax_arrays_serves_a_four_node_jax_tree(eight_devices):
    n = 4
    j, _, keys, rng = _pair(n, 1200, 41)
    jc, jt, je = j
    je.attach_router()
    q = _queries(rng, keys, 300)
    je.search_combined(q)                    # counters move before export
    pc, pt, pe = state.from_jax_arrays(
        np.asarray(jc.dsm.pool), np.asarray(jc.dsm.locks),
        np.asarray(jc.dsm.counters), jt._root_addr, jt._root_level,
        [d.allocator.pages_used for d in jc.directories], jt._bulk_leaf_dir,
        device="cpu", batch_per_node=B,
        tcfg=TreeConfig(sibling_chase_budget=2), chunk_pages=4,
        step_capacity=64)
    assert pc.cfg.machine_nr == n and pc.cfg.pages_per_node == 128
    assert [d.allocator.pages_used for d in pc.directories] == \
        [d.allocator.pages_used for d in jc.directories]
    np.testing.assert_array_equal(pc.dsm.counters_np(),
                                  np.asarray(jc.dsm.counters))
    pe.attach_router()
    np.testing.assert_array_equal(pe.router.table_np, je.router.table_np)
    _same_out(pe.search_combined(q), je.search_combined(q), "handed over")
    qm, vm, rm = _mixed_batch(rng, keys, n * B, 0)
    _same_out(pe.mixed(qm, vm, rm), je.mixed(qm, vm, rm), "mixed")
    np.testing.assert_array_equal(pc.dsm.pool.numpy(),
                                  np.asarray(jc.dsm.pool))
    np.testing.assert_array_equal(pc.dsm.counters_np(),
                                  np.asarray(jc.dsm.counters))


def test_multinode_path_counts_no_kernel_launch_on_cpu(eight_devices):
    _, p, keys, rng = _pair(4, 600, 51)
    p[2].attach_router()
    PK.reset_launches()
    TK.reset_launches()
    p[2].search_combined(keys[:200])
    p[2].search(keys[:50])
    p[2].mixed(keys[:100], keys[:100], np.arange(100) % 2 == 0)
    assert not any(PK.LAUNCHES.values())
    assert TK.LAUNCHES == {"exchange": 0}
