"""Port parity: the whole-tree structure validator and the scrub pass of
``sherman_tpu_torch/models/validate.py`` (``check_structure_device``,
``_validate_kernel``, ``scrub_pass``, ``_scrub_kernel``) against the JAX
package, at one node and at four.

Both packages grow the same tree from the same seeded numpy inputs (the
``grown_tree`` fixture of tests/test_validate.py), and every corruption is
written into both pools through the host ``write_word``/``write_rows``
verbs.  The stats dicts, the raw counts, the scrub masks and the error
messages must be equal, and the pools bit-identical.  The JAX side runs as
its own tests run it (``gather_impl="xla"``, the ``eight_devices``
fixture).  Every tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sherman_tpu import config as JC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models import validate as JV
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu_torch import config as C
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import TreeCorruptError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models import validate as TV
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits, layout
from sherman_tpu_torch.parallel import dsm as D

torch.set_num_threads(1)


def _pair(n, *, pages, locks, cap, chunk_pages, B):
    kw = dict(machine_nr=n, pages_per_node=pages, locks_per_node=locks,
              step_capacity=cap, chunk_pages=chunk_pages)
    jc = JCluster(JDSMConfig(gather_impl="xla", **kw))
    jt = JTree(jc)
    je = JB.BatchedEngine(jt, batch_per_node=B, write_combine=False)
    pc = Cluster(DSMConfig(device="cpu", **kw))
    pt = Tree(pc)
    pe = TB.BatchedEngine(pt, batch_per_node=B, write_combine=False)
    return (jc, jt, je), (pc, pt, pe)


def _same_pool(j, p):
    np.testing.assert_array_equal(p[0].dsm.pool.numpy(),
                                  np.asarray(j[0].dsm.pool))
    np.testing.assert_array_equal(p[0].dsm.locks.numpy(),
                                  np.asarray(j[0].dsm.locks))


def _check_both(j, p):
    """check_structure_device on both: equal stats, or equal errors.
    -> the stats (None when both raised)."""
    try:
        want = JV.check_structure_device(j[1])
    except RuntimeError as e:
        with pytest.raises(TreeCorruptError) as ei:
            TV.check_structure_device(p[1])
        assert str(ei.value) == str(e)
        return None
    assert TV.check_structure_device(p[1]) == want
    return want


def _scrub_both(j, p):
    want = JV.scrub_pass(j[1])
    got = TV.scrub_pass(p[1])
    assert got == want
    return got


@pytest.fixture(scope="module", params=[1, 4])
def grown_once(request):
    """tests/test_validate.py's grown tree, on both sides, with the pool
    and lock images it was built to."""
    j, p = _pair(request.param, pages=256 * 4 // request.param, locks=128,
                 cap=128, chunk_pages=16, B=64)
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 1 << 48, 2600, dtype=np.uint64))[:2400]
    for (_, t, e), mod in ((j, JB), (p, TB)):
        mod.bulk_load(t, keys[:1500], keys[:1500])
        e.attach_router()
        e.insert(keys[1500:], keys[1500:])
        e.delete(keys[::6])
    _same_pool(j, p)
    return j, p, p[0].dsm.pool.clone(), p[0].dsm.locks.clone()


@pytest.fixture()
def grown(grown_once, eight_devices):
    """The grown tree; the pool and locks of both sides are put back to
    their built images after the test, which may corrupt them."""
    j, p, pool, locks = grown_once
    yield j, p
    p[0].dsm.pool.copy_(pool)
    p[0].dsm.locks.copy_(locks)
    jd = j[0].dsm
    jd.pool = jax.device_put(jnp.asarray(pool.numpy()), jd.shard)
    jd.locks = jax.device_put(jnp.asarray(locks.numpy()), jd.shard)


def _leaf_addr(j, i):
    return int(j[1]._bulk_leaf_dir[0][i])


def _poke_both(j, p, addr, woff, value):
    j[0].dsm.write_word(addr, woff, value)
    p[0].dsm.write_word(addr, woff, value)


def test_agrees_with_jax_and_the_host_walk(grown):
    j, p = grown
    dev = _check_both(j, p)
    host = p[1].check_structure()
    for f in ("keys", "leaves", "levels", "internal_pages"):
        assert dev[f] == host[f], f
    assert dev["retired"] == 1     # the bulk load's poisoned root
    scrub = _scrub_both(j, p)
    assert scrub["violations"] == 0 and scrub["pages_checked"] > 0


def test_fresh_empty_tree(eight_devices):
    j, p = _pair(2, pages=64, locks=64, cap=32, chunk_pages=8, B=8)
    assert _check_both(j, p) == {"keys": 0, "leaves": 1,
                                 "internal_pages": 0, "levels": 1,
                                 "retired": 0}
    assert _scrub_both(j, p)["violations"] == 0


def test_detects_key_outside_fence(grown):
    j, p = grown
    addr = _leaf_addr(j, 3)
    pg = p[0].dsm.read_page(addr)
    slot = next(s for s in range(C.LEAF_CAP) if layout.np_slot_live(pg, s))
    _poke_both(j, p, addr, C.L_KHI_W + slot, 0x7FFFFFFF)
    assert _check_both(j, p) is None
    assert _scrub_both(j, p)["classes"]["bad_leaf_slot"] == 1


def test_detects_broken_sibling_link(grown):
    j, p = grown
    _poke_both(j, p, _leaf_addr(j, 5), C.W_SIBLING, bits.make_addr(0, 1))
    assert _check_both(j, p) is None
    assert _scrub_both(j, p)["classes"]["bad_sibling"] == 1


def test_detects_torn_version(grown):
    j, p = grown
    addr = _leaf_addr(j, 7)
    pg = p[0].dsm.read_page(addr)
    _poke_both(j, p, addr, C.W_FRONT_VER, int(pg[C.W_FRONT_VER]) + 1)
    assert _check_both(j, p) is None
    assert _scrub_both(j, p)["classes"]["bad_version"] == 1


def test_detects_unsorted_internal(grown):
    j, p = grown
    pool = p[0].dsm.pool.numpy()
    P = p[0].cfg.pages_per_node
    cand = np.nonzero((pool[:, C.W_LEVEL] > 0) & (pool[:, C.W_NKEYS] >= 2)
                      & (pool[:, C.W_FRONT_VER] != 0))[0]
    row = int(cand[0])
    addr = bits.make_addr(row // P, row % P)
    k0, k1 = int(pool[row, C.I_KHI_W]), int(pool[row, C.I_KHI_W + 1])
    rows = [{"op": D.OP_WRITE_WORD, "addr": addr, "woff": C.I_KHI_W,
             "arg1": k1},
            {"op": D.OP_WRITE_WORD, "addr": addr, "woff": C.I_KHI_W + 1,
             "arg1": k0}]
    j[0].dsm.write_rows(rows)
    p[0].dsm.write_rows(rows)
    assert _check_both(j, p) is None
    _scrub_both(j, p)


def _reclaimed(n, hi=2100):
    """tests/test_validate.py's dangling-entry tree: the keys in (700,
    hi) deleted, three reclaim passes, so retired and freed pages exist
    (and parked ones, once the band takes a parent's leftmost child)."""
    j, p = _pair(n, pages=2048 // n, locks=512, cap=512 // n,
                 chunk_pages=32, B=512 // n)
    keys = np.arange(1, 4001, dtype=np.uint64) * np.uint64(7)
    band = keys[(keys > 700) & (keys < hi)]
    out = []
    for t, e, mod in ((j[1], j[2], JB), (p[1], p[2], TB)):
        mod.bulk_load(t, keys, keys + np.uint64(1), fill=0.9)
        e.attach_router()
        e.delete(band)
        out.append([e.reclaim_empty_leaves() for _ in range(3)])
    assert out[0] == out[1]
    _same_pool(j, p)
    return j, p


@pytest.mark.parametrize("n", [1, 4])
def test_reclaimed_tree_parks_and_frees(eight_devices, n):
    j, p = _reclaimed(n, hi=26_000)
    stats = _check_both(j, p)
    assert stats["keys"] == 4000 - 3614
    assert any(d.allocator.free_pages_list for d in p[0].directories)
    assert p[2]._reclaim_state["parked"]
    assert stats["retired"] > 1
    assert _scrub_both(j, p)["violations"] == 0


def test_detects_dangling_entry_to_freed_page(eight_devices):
    j, p = _reclaimed(1)
    fp = p[0].directories[0].allocator.free_pages_list
    F = bits.make_addr(0, fp[0])
    lowF = layout.np_lowest(p[0].dsm.read_page(F))
    pool = p[0].dsm.pool.numpy()
    P = p[0].cfg.pages_per_node
    parents = np.nonzero((pool[:, C.W_LEVEL] == 1)
                         & (pool[:, C.W_FRONT_VER] != 0))[0]
    row = next(r for r in parents
               if layout.np_lowest(pool[r]) <= lowF
               < layout.np_highest(pool[r]))
    pa = bits.make_addr(row // P, row % P)
    ekeys = [k for k, _ in layout.np_internal_entries(pool[row])]
    e = min(int(np.searchsorted(ekeys, lowF)), len(ekeys) - 1)
    khi, klo = bits.key_to_pair(lowF)
    rows = [{"op": D.OP_WRITE_WORD, "addr": pa, "woff": C.I_KHI_W + e,
             "arg1": khi},
            {"op": D.OP_WRITE_WORD, "addr": pa, "woff": C.I_KLO_W + e,
             "arg1": klo},
            {"op": D.OP_WRITE_WORD, "addr": pa, "woff": C.I_PTR_W + e,
             "arg1": F}]
    j[0].dsm.write_rows(rows)
    p[0].dsm.write_rows(rows)
    with pytest.raises(TreeCorruptError, match="bad_child"):
        TV.check_structure_device(p[1])
    assert _check_both(j, p) is None


def _raw_both(pool_np, nxt, freed, N, P):
    """The raw validator counts and scrub masks of both packages on one
    pool image."""
    want = np.asarray(JV._validate_kernel(
        jnp.asarray(pool_np), jnp.asarray(nxt, jnp.int32),
        jnp.asarray(freed), P=P, N=N)).tolist()
    jmask, jchecked = JV._scrub_kernel(jnp.asarray(pool_np),
                                       jnp.asarray(nxt, jnp.int32), P=P, N=N)
    pool = torch.from_numpy(pool_np)
    nxt_t = torch.from_numpy(np.asarray(nxt, np.int64))
    got = TV._validate_kernel(pool, nxt_t, torch.from_numpy(freed), P, N)
    assert got == want
    mask, checked = TV._scrub_kernel(pool, nxt_t, P, N)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(checked) == int(jchecked)
    return dict(zip(TV._STATS, got)), mask.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_garbage_links_on_a_grown_pool(grown, seed):
    """Random words in the sibling, leftmost and child-pointer fields of
    a grown tree's pages (out-of-range nodes and pages, and node fields
    above the pool): the validator's counts and the scrub masks equal.
    An out-of-range sibling clips onto a pool row and counts in its
    in-degree, as the reference's scatter does."""
    j, p = grown
    pool = p[0].dsm.pool.numpy().copy()
    rng = np.random.default_rng(seed)
    # a third of the rows, and every internal page
    rows = np.union1d(
        rng.choice(pool.shape[0], pool.shape[0] // 3, replace=False),
        np.nonzero(pool[:, C.W_LEVEL] > 0)[0])
    words = lambda n: rng.integers(-2**31, 2**31, n, dtype=np.int64
                                   ).astype(np.int32)
    pool[rows, C.W_SIBLING] = words(rows.size)
    pool[rows, C.W_LEFTMOST] = words(rows.size)
    pool[rows, C.I_PTR_W:C.I_PTR_W + C.INTERNAL_CAP] = words(
        rows.size * C.INTERNAL_CAP).reshape(rows.size, -1)
    N, P = p[0].cfg.machine_nr, p[0].cfg.pages_per_node
    nxt = [d.allocator.pages_used for d in p[0].directories]
    freed = rng.random(N * P) < 0.1
    stats, mask = _raw_both(pool, nxt, freed, N, P)
    assert stats["bad_sibling"] and stats["bad_child"] and mask.any()


@pytest.mark.parametrize("seed", [3, 4])
def test_garbage_pool(eight_devices, seed):
    """A pool of random words (levels drawn from -1..3 so leaves,
    internal pages and invalid levels all occur; some highest fences
    zeroed so pages retire): counts and masks equal."""
    N, P = 2, 96
    rng = np.random.default_rng(seed)
    pool = rng.integers(-2**31, 2**31, (N * P, C.PAGE_WORDS),
                        dtype=np.int64).astype(np.int32)
    pool[:, C.W_LEVEL] = rng.integers(-1, 4, N * P)
    pool[:, C.W_NKEYS] = rng.integers(-2, C.INTERNAL_CAP + 2, N * P)
    ret = rng.random(N * P) < 0.2
    pool[ret, C.W_HIGH_HI] = 0
    pool[ret, C.W_HIGH_LO] = 0
    # some links to real rows, so the sibling and child clauses see
    # in-range targets
    tgt = rng.integers(0, N * P, N * P)
    near = rng.random(N * P) < 0.5
    pool[near, C.W_SIBLING] = [bits.make_addr(int(t) // P, int(t) % P)
                               for t in tgt[near]]
    stats, mask = _raw_both(pool, [P - 5, P], rng.random(N * P) < 0.1, N, P)
    assert stats["leaves"] and stats["internal_pages"] and mask.any()


def test_row_arithmetic_wraps_as_int32():
    """``node * P + page`` wraps as the reference's int32 arithmetic does
    before the clip (a node field above the cluster on a pool of 2^24
    pages a node)."""
    N, P = 2, 1 << 24
    addr = torch.tensor([bits.make_addr(200, 5), bits.make_addr(1, 7),
                         bits.make_addr(0, 0), bits.make_addr(255, P - 1)],
                        dtype=torch.int32)
    rows, ok = TV._rows_of(addr, N, P)
    u = jnp.asarray(addr.numpy()).astype(jnp.uint32)
    node = (u >> JC.ADDR_PAGE_BITS).astype(jnp.int32)
    page = (u & JC.ADDR_PAGE_MASK).astype(jnp.int32)
    want = np.asarray(jnp.clip(node * P + page, 0, N * P - 1))
    np.testing.assert_array_equal(rows.numpy(), want)
    assert ok.tolist() == [False, True, False, False]
