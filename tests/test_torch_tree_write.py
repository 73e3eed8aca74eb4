"""Port parity: the host write path of ``sherman_tpu_torch`` (the DSM host
verbs, the cluster's lock-lease table and the host ``Tree``: insert,
overwrite, search, leaf and internal splits, root growth,
``check_structure``) against the JAX package on the same inputs.

Both packages run every operation on the same seeded numpy keys; after
each phase the pools, lock tables, counters, dirty sets and allocator
states must be bit-identical and the replies equal.  The JAX side runs as
its own tests run it (``gather_impl="xla"``, the 8 virtual CPU devices).
Every tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.ops import bits as JBits
from sherman_tpu.ops import layout as JL
from sherman_tpu.parallel import dsm as JD
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, LEAF_CAP
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits, layout
from sherman_tpu_torch.parallel import dsm as D

torch.set_num_threads(1)


def _kw(n):
    return dict(machine_nr=n, pages_per_node=256, locks_per_node=64,
                step_capacity=32, chunk_pages=16)


def _clusters(n):
    return (JCluster(JDSMConfig(gather_impl="xla", **_kw(n))),
            Cluster(DSMConfig(device="cpu", **_kw(n))))


def _same_state(jc, pc, what):
    jd, pd = jc.dsm, pc.dsm
    np.testing.assert_array_equal(pd.pool.numpy(), np.asarray(jd.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(pd.locks.numpy(), np.asarray(jd.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(pd.counters_np(), np.asarray(jd.counters),
                                  err_msg=what + " counters")
    np.testing.assert_array_equal(pd.dirty_rows(), jd.dirty_rows(),
                                  err_msg=what + " dirty")
    assert [d.allocator.pages_used for d in pc.directories] == \
        [d.allocator.pages_used for d in jc.directories], what


# ---------------------------------------------------------------------------
# Bits and layout helpers of the write path.
# ---------------------------------------------------------------------------

def test_lease_and_layout_helpers_match():
    assert bits.LEASE_MASK == JBits.LEASE_MASK
    rng = np.random.default_rng(0)
    for w in list(rng.integers(-2**31, 2**31, 50)) + [0, -1, 2**31 - 1]:
        assert bits.lease_owner(int(w)) == JBits.lease_owner(int(w))
        assert bits.lease_epoch(int(w)) == JBits.lease_epoch(int(w))
    # an internal page and a leaf with live, dead and torn slots
    ipg = JL.np_empty_page(2, 100, 10**18, sibling=7, leftmost=3, version=9)
    ents = sorted((int(k), int(c)) for k, c in zip(
        rng.integers(100, 10**18, 30, dtype=np.uint64),
        rng.integers(1, 2**20, 30)))
    for i, (k, c) in enumerate(ents):
        JL.np_internal_set_entry(ipg, i, k, c)
    ipg[JL.C.W_NKEYS] = len(ents)
    assert layout.np_internal_entries(ipg) == JL.np_internal_entries(ipg)
    np.testing.assert_array_equal(layout.np_internal_rebuild(ipg, ents, 2),
                                  JL.np_internal_rebuild(ipg, ents, 2))
    for key in (0, 99, 100, ents[4][0], ents[4][0] + 1, 2**63):
        assert layout.np_pick_child(ipg, key) == JL.np_pick_child(ipg, key)
    leaf = JL.np_empty_page(0, 0, 2**64 - 1)
    for s in range(LEAF_CAP):
        JL.np_leaf_set_entry(leaf, s, 1000 + s, s)
    leaf[JL.C.L_VER_W + 3] = 0                     # dead
    leaf[JL.C.L_VER_W + 7] = (5 << 16) | 6          # torn pair
    for key in (1003, 1005, 1007, 5):
        assert layout.np_leaf_find(leaf, key) == JL.np_leaf_find(leaf, key)
    assert layout.np_leaf_free_slot(leaf) == JL.np_leaf_free_slot(leaf) == 3
    full = leaf.copy()
    full[JL.C.L_VER_W + 3] = full[JL.C.L_VER_W + 7] = full[JL.C.L_VER_W]
    assert layout.np_leaf_free_slot(full) == JL.np_leaf_free_slot(full) == -1
    pages = np.stack([leaf, full, ipg])
    got = layout.leaf_find_free_slot(torch.from_numpy(pages))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JL.leaf_find_free_slot(pages)))
    tv, jv = layout.leaf_slots_view(torch.from_numpy(pages)), \
        JL.leaf_slots_view(pages)
    assert set(tv) == set(jv)
    for k in jv:
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))


# ---------------------------------------------------------------------------
# DSM host verbs and the lease table.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_host_verbs_on_a_contended_word(eight_devices, n):
    jc, pc = _clusters(n)
    jd, pd = jc.dsm, pc.dsm
    word = bits.make_addr(n - 1, 5)
    lock = bits.make_addr(0, 3)
    payload = np.arange(7, dtype=np.int32) * 3 - 5
    for name, args in (
            ("faa", (word, 11, 5)),
            ("faa", (word, 11, -9)),
            ("faa", (lock, 0, 3, D.SPACE_LOCK)),
            ("cas", (word, 11, -4, 77)),
            ("cas", (word, 11, -4, 78)),                 # loses
            ("masked_cas", (word, 11, 77, 0x5000, 0xFF00)),
            ("masked_cas", (word, 11, 0x100, 1, 0xF00)),  # loses
            ("masked_faa", (word, 12, 0x30, 0xF0)),
            ("masked_faa", (word, 12, 0xF0, 0xF0)),      # carry stays in
            ("cas_read", (lock, 0, 3, 9, word)),
            ("cas_read", (lock, 0, 3, 10, word)),        # loses, reads
            ("write_cas", (word, 20, payload, lock, 0, 9, 0)),
            ("write_cas", (word, 40, payload, lock, 0, 9, 1)),   # loses
            ("write_faa", (word, 60, payload, word, 11, 100,
                           D.SPACE_POOL)),
            ("read_word", (word, 11)),
            ("read_page", (word,))):
        got, want = getattr(pd, name)(*args), getattr(jd, name)(*args)
        if name in ("cas_read", "read_page"):
            np.testing.assert_array_equal(got[-1] if name == "cas_read"
                                          else got,
                                          want[-1] if name == "cas_read"
                                          else want, err_msg=name)
            if name == "cas_read":
                assert got[:2] == want[:2], name
        else:
            assert got == want, (name, args)
        _same_state(jc, pc, name)


def test_lease_table_and_dead_holder_revocation(eight_devices):
    jc, pc = _clusters(1)
    jt, pt = JTree(jc), Tree(pc)
    # a second client takes a page's global lock word and dies holding it
    # (a raw CAS: the reference's node-local ticket tier would block this
    # thread's own insert below)
    jo, po = jc.register_client(), pc.register_client()
    assert pc.lease_epochs == jc.lease_epochs == {1: 1, 2: 1}
    page = jt._root_addr
    la = pt._lock_word_addr(page)
    assert la == jt._lock_word_addr(page)
    assert pc.dsm.cas(la, 0, 0, po.lease, space=D.SPACE_LOCK) == \
        jc.dsm.cas(la, 0, 0, jo.lease, space=JD.SPACE_LOCK) == (0, True)
    other = bits.make_addr(0, 77)                   # another lock word
    la2 = pt._lock(other)
    assert la2 == jt._lock(other) != la
    pt._unlock(la2)
    jt._unlock(la2)
    for c in (jc, pc):
        assert c.lease_is_live(2, 1) and not c.lease_is_live(2, 2)
        assert not c.lease_is_live(9, 1)
    # a live holder is not revoked
    held = pc.dsm.read_word(la, 0, space=D.SPACE_LOCK)
    assert held == jc.dsm.read_word(la, 0, space=JD.SPACE_LOCK) != 0
    assert pt._try_revoke_lease(la, held) is False
    assert jt._try_revoke_lease(la, held) is False
    assert "live lease" in str(pt._deadlock_report(la, held))
    _same_state(jc, pc, "live holder")
    pc.expire_client(2)
    jc.expire_client(2)
    assert pc.lease_epochs == jc.lease_epochs == {1: 1, 2: 2}
    assert "dead lease" in str(pt._deadlock_report(la, held))
    # the spinner probes the lease table and revokes the dead holder's
    # lock, then the insert goes through
    pt.insert(42, 4242)
    jt.insert(42, 4242)
    _same_state(jc, pc, "revoked")
    assert pt.search(42) == jt.search(42) == 4242
    assert pc.dsm.read_word(la, 0, space=D.SPACE_LOCK) == 0


# ---------------------------------------------------------------------------
# The host Tree.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_tree_insert_overwrite_split_multilevel(eight_devices, n):
    jc, pc = _clusters(n)
    jt, pt = JTree(jc), Tree(pc)
    _same_state(jc, pc, "root")
    for k in [5, 3, 9, 1]:
        jt.insert(k, k * 10)
        pt.insert(k, k * 10)
    for k in [5, 3, 9, 1, 4]:
        assert pt.search(k) == jt.search(k) == \
            ({5: 50, 3: 30, 9: 90, 1: 10}.get(k))
    jt.insert(5, 555)
    pt.insert(5, 555)
    assert pt.search(5) == jt.search(5) == 555
    _same_state(jc, pc, "overwrite")
    # leaf splits, internal splits and root growth
    keys = list(range(100, 300))
    np.random.default_rng(n).shuffle(keys)
    for k in keys:
        jt.insert(k, k + 7)
        pt.insert(k, k + 7)
    _same_state(jc, pc, "splits")
    assert (pt._root_addr, pt._root_level) == (jt._root_addr, jt._root_level)
    assert pt._root_level == 1
    for k in keys[::7]:
        assert pt.search(k) == jt.search(k) == k + 7
    big = [2**40 + 1, 2**63 - 5, 2**32, 2**33 + 17, 2**64 - 2]
    for k in big:
        jt.insert(k, k % 1000)
        pt.insert(k, k % 1000)
    for k in big:
        assert pt.search(k) == jt.search(k) == k % 1000
    assert pt.check_structure() == jt.check_structure()
    _same_state(jc, pc, "64-bit keys")


@pytest.mark.parametrize("n", [1, 4])
def test_tree_internal_split_on_a_bulk_loaded_tree(eight_devices, n):
    """Host inserts into full leaves under a full internal page: leaf
    splits, then the internal split moves its middle entry up."""
    from sherman_tpu.models import batched as JB
    from sherman_tpu_torch.models import batched as TB
    jc, pc = _clusters(n)
    jt, pt = JTree(jc), Tree(pc)
    keys = np.arange(1, 2 * 81 * 48 + 1, dtype=np.uint64) * 1000
    assert JB.bulk_load(jt, keys, keys, fill=0.99) == \
        TB.bulk_load(pt, keys, keys, fill=0.99)
    assert pt._root_level == 2
    # two new keys into each of the first leaves overflow them, and their
    # parent entries overflow the first level-1 page (80 entries)
    new = [int(k) + 1 + j for k in keys[:48 * 4:48] for j in range(2)]
    for k in new:
        jt.insert(k, 3 * k)
        pt.insert(k, 3 * k)
    _same_state(jc, pc, "internal split")
    for k in new + [int(keys[5]), int(keys[-1])]:
        assert pt.search(k) == jt.search(k) == (3 * k if k in new else k)
    st = pt.check_structure()
    assert st == jt.check_structure()
    assert st["internal_pages"] == 4 and st["keys"] == keys.size + len(new)
