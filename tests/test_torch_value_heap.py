"""Port parity: the value heap (``sherman_tpu_torch/models/value_heap.py``),
the DSM heap region and the heap's checkpoint, journal and recovery paths,
against the JAX package, case by case after tests/test_value_heap.py (the
cases that use neither the serving front door nor the reshard).

Both packages load the same tree, attach a heap and drive the same puts,
gets, removes, scans, scrubs, checkpoints and recoveries: the answers and
payloads, the handles, the heap region, the allocator's state (page
classes, slab versions, freelists in their set order, bump marks, spare
pages), the pools and the counters must be equal after every call.  A
heap checkpoint written by either package restores in the other, and
``state.from_jax_arrays(heap=)`` carries a JAX heap tree into the port.
The JAX side runs as its own tests run it (``gather_impl="xla"``).  Every
comparison is exact equality.
"""

import shutil

import numpy as np
import pytest
import torch

from sherman_tpu import obs as JOBS
from sherman_tpu import recovery as JRC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models import value_heap as JVH
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.utils import checkpoint as JCK
from sherman_tpu.utils import journal as JJ
from sherman_tpu_torch import obs as OBS
from sherman_tpu_torch import recovery as RC
from sherman_tpu_torch import state
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import ConfigError, DoubleFreeError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models import value_heap as VH
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.utils import checkpoint as CK
from sherman_tpu_torch.utils import journal as J

torch.set_num_threads(1)

SALT = 0x5E17_AB1E_5A17
N_KEYS = 800


def _eq(a, b, what=""):
    """Deep exact equality of numpy arrays, tuples, lists and dicts."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), what
        for k in a:
            _eq(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    elif isinstance(a, (np.ndarray, torch.Tensor)) or \
            isinstance(b, (np.ndarray, torch.Tensor)):
        x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(x, y, err_msg=what)
    elif isinstance(a, set):
        assert list(a) == list(b), what         # the set's pop order too
    else:
        assert a == b, (what, a, b)


def keyspace(n=N_KEYS):
    return np.unique(bits.mix64_np(np.arange(n, dtype=np.uint64)
                                   ^ np.uint64(SALT)))


def payloads_for(keys, lo=1, hi=250):
    rng = np.random.default_rng(int(keys[0]) & 0xFFFF)
    lens = rng.integers(lo, hi, keys.size)
    return [bytes(rng.integers(0, 256, int(ln), dtype=np.uint8))
            for ln in lens]


class Side:
    """One package's cluster, tree, engine and module handles."""

    def __init__(self, jax_side, nr=1, pages=1024, heap_pages=256, cap=512,
                 B=256, cluster=None, tree=None, eng=None):
        self.jax = jax_side
        self.B = JB if jax_side else TB
        self.VH = JVH if jax_side else VH
        self.CK = JCK if jax_side else CK
        self.RC = JRC if jax_side else RC
        if cluster is None:
            kw = dict(machine_nr=nr, pages_per_node=pages,
                      locks_per_node=512, step_capacity=cap, chunk_pages=32,
                      heap_pages_per_node=heap_pages)
            cfg = (JDSMConfig(gather_impl="xla", **kw) if jax_side
                   else DSMConfig(device="cpu", **kw))
            cluster = (JCluster if jax_side else Cluster)(cfg)
        self.c = cluster
        self.t = tree or (JTree if jax_side else Tree)(self.c)
        self.e = eng or self.B.BatchedEngine(self.t, batch_per_node=B)
        self.d = self.c.dsm
        self.vh = self.e.value_heap


def _heap_np(side):
    h = side.d.heap
    return np.asarray(h) if side.jax else h.numpy()


def same(j, p, what=""):
    """Pools, counters, heap regions and the allocators' state equal."""
    _eq(np.asarray(j.d.pool), p.d.pool, what + " pool")
    _eq(np.asarray(j.d.counters), p.d.counters_np(), what + " counters")
    _eq(_heap_np(j), _heap_np(p), what + " heap")
    _eq(j.d.heap_dirty_rows(), p.d.heap_dirty_rows(), what + " heap dirty")
    if p.vh is not None:
        for a in ("_page_cls", "_ver", "_next_page"):
            _eq(getattr(j.vh, a), getattr(p.vh, a), f"{what} {a}")
        _eq(j.vh._spare_pages, p.vh._spare_pages, what + " spares")
        _eq(j.vh._rr_node, p.vh._rr_node, what + " rr")
        _eq(j.vh._free, p.vh._free, what + " freelists")
        _eq(j.vh.stats(), p.vh.stats(), what + " stats")


class Pair:
    def __init__(self, **kw):
        self.j = Side(True, **kw)
        self.p = Side(False, **kw)

    def both(self, fn, what="", state=True):
        a, b = fn(self.j), fn(self.p)
        _eq(a, b, what)
        if state:
            same(self.j, self.p, what)
        return b


def loaded(nr=1, heap_pages=256, n=N_KEYS, router=True):
    P = Pair(nr=nr, heap_pages=heap_pages)
    keys = keyspace(n)
    pay = payloads_for(keys)

    def go(s):
        s.B.bulk_load(s.t, keys, keys ^ np.uint64(0xD00D))
        if router:
            s.e.attach_router()
        s.vh = s.e.attach_value_heap()
        return s.vh.put(keys, pay)
    P.both(go, "load")
    return P, keys, pay


@pytest.fixture(scope="module")
def heap_rig(eight_devices):
    """A shared loaded one-node pair (cases that mutate build their own)."""
    return loaded()


# -- handle protocol ---------------------------------------------------------

def test_handle_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1 << 30, 64)
    slabs = rng.integers(0, 31, 64)
    clss = rng.integers(0, 4, 64)
    vers = rng.integers(1, 0xFFFF, 64)
    h = VH.pack_handles(rows, slabs, clss, vers)
    _eq(h, JVH.pack_handles(rows, slabs, clss, vers))
    r2, s2, c2, v2 = VH.unpack_handles(h)
    assert (r2 == rows).all() and (s2 == slabs).all()
    assert (c2 == clss).all() and (v2 == vers).all()
    _eq(VH.unpack_handles(h), JVH.unpack_handles(h))
    for v in (0, 1, 0x7FFF, 0x8000, 0xFFFF):
        for nb in (0, 1, 28, 252):
            assert VH._header_word(v, nb) == JVH._header_word(v, nb)


def test_class_for_bytes_caps():
    for n in (0, 1, 28, 29, 60, 61, 124, 125, 252):
        assert VH.class_for_bytes(n) == JVH.class_for_bytes(n)
    assert VH.class_for_bytes(252) == len(VH.HEAP_CLASSES) - 1
    with pytest.raises(ConfigError):
        VH.class_for_bytes(253)
    assert (VH.HEAP_CLASSES, VH.TAG_W, VH.TAG_MAGIC, VH.MAX_PAYLOAD_WORDS) \
        == (JVH.HEAP_CLASSES, JVH.TAG_W, JVH.TAG_MAGIC,
            JVH.MAX_PAYLOAD_WORDS)


def test_heap_off_is_absent(tmp_path):
    s = Side(False, heap_pages=0)
    assert s.d.heap is None
    with pytest.raises(ConfigError):
        s.e.attach_value_heap()
    with pytest.raises(ConfigError):
        s.d.heap_write_cells([0], [0], [1])
    CK.checkpoint(s.c, str(tmp_path / "c.npz"))
    with np.load(str(tmp_path / "c.npz")) as z:
        assert "heap" not in z.files
    with pytest.raises(ConfigError):
        DSMConfig(device="cpu", heap_pages_per_node=(1 << 24) + 1)


# -- reads: the device resolve held to the host resolver ---------------------

def test_get_bit_identical_to_host_resolver(heap_rig):
    P, keys, pay = heap_rig
    got, found = P.both(lambda s: s.vh.get(keys), "get")
    assert found.all()
    vals, f2 = P.both(lambda s: s.e.search(keys), "search")
    ref, ok = P.both(lambda s: s.vh.resolve_host(vals, f2), "host")
    assert ok.all()
    assert got == ref == pay
    dev = P.both(lambda s: s.vh.resolve_u64(vals, f2), "resolve_u64")
    assert dev[2].all()


@pytest.mark.parametrize("nr", [4, 8])
def test_get_multinode_fused(eight_devices, nr):
    P, keys, pay = loaded(nr=nr, heap_pages=96 if nr == 4 else 48)
    got, found = P.both(lambda s: s.vh.get(keys), "get")
    assert found.all() and got == pay
    dup = np.repeat(keys[:40], 7)
    got2, f2 = P.both(lambda s: s.vh.get(dup), "dup get")
    assert f2.all()
    assert all(got2[i] == pay[int(np.searchsorted(keys, dup[i]))]
               for i in range(dup.size))


def test_get_with_leaf_cache_identical(heap_rig):
    P, keys, pay = heap_rig
    P.both(lambda s: s.e.attach_leaf_cache(slots=1024) and None, "attach")
    try:
        P.both(lambda s: s.e.leaf_cache.fill(keys[:200]), "fill")
        got, found = P.both(lambda s: s.vh.get(keys[:300]), "get")
        assert found.all() and got == pay[:300]
        _eq(P.j.e.leaf_cache.stats(), P.p.e.leaf_cache.stats())
        assert P.p.e.leaf_cache.stats()["hits"] == 200
    finally:
        P.both(lambda s: s.e.detach_leaf_cache(), "detach")


def test_missing_keys_not_found(heap_rig):
    P, keys, _ = heap_rig
    absent = np.asarray([5, 7, 11], np.uint64)
    got, found = P.both(lambda s: s.vh.get(absent), "get")
    assert not found.any() and got == [None] * 3


def test_scan_resolves_payloads(heap_rig):
    P, keys, pay = heap_rig
    lo, hi = int(keys[100]), int(keys[160])
    (ks, ps), = P.both(lambda s: s.vh.scan([(lo, hi)]), "scan")
    assert ks.size > 0
    for k, p in zip(ks, ps):
        assert p == pay[int(np.searchsorted(keys, k))]


def test_sealed_zero_retrace_reads(heap_rig):
    P, keys, _ = heap_rig
    P.p.vh.get(keys[:256])
    ledger = DEV.get_ledger()
    r0 = ledger.retraces
    ledger.seal()
    try:
        got, found = P.p.vh.get(keys[:256])
    finally:
        ledger.unseal()
    assert found.all() and ledger.retraces == r0
    labels = {e["label"] for e in ledger.summary()["entries"]}
    assert "heap.fanout_resolve" in labels
    P.j.vh.get(keys[:256])      # keep the two rigs' counters in step


# -- writes: reuse, class change, free, double free --------------------------

def test_overwrite_frees_old_slab_after_install(eight_devices):
    P, keys, pay = loaded(n=200)
    v0, _ = P.both(lambda s: s.e.search(keys[:50]), "search")
    st = P.both(lambda s: s.vh.put(
        keys[:50], [b"Z" * len(pay[i]) for i in range(50)]), "put")
    assert st["allocated"] == 50 and st["freed"] == 50
    v1, _ = P.both(lambda s: s.e.search(keys[:50]), "search 2")
    r0, s0, _, _ = VH.unpack_handles(v0)
    r1, s1, _, _ = VH.unpack_handles(v1)
    assert not ((r0 == r1) & (s0 == s1)).any()
    _, ok = P.both(lambda s: s.vh.resolve_host(v0, np.ones(50, bool)), "old")
    assert not ok.any()
    got, _ = P.both(lambda s: s.vh.get(keys[:50]), "get")
    assert all(g == b"Z" * len(pay[i]) for i, g in enumerate(got))


def test_class_change_frees_old_slab(eight_devices):
    P, keys, pay = loaded(n=200)
    P.both(lambda s: s.vh.put(keys[:30], [b"s" * 4] * 30), "small")
    v_old, _ = P.both(lambda s: s.e.search(keys[:30]), "search")
    st = P.both(lambda s: s.vh.put(keys[:30], [b"B" * 200] * 30), "big")
    assert st["freed"] == 30
    _, ok = P.both(lambda s: s.vh.resolve_host(v_old, np.ones(30, bool)),
                   "old")
    assert not ok.any()
    got, _ = P.both(lambda s: s.vh.get(keys[:30]), "get")
    assert all(g == b"B" * 200 for g in got)


def test_remove_frees_and_double_free_typed(eight_devices):
    P, keys, _ = loaded(n=200)
    hv, hf = P.both(lambda s: s.e.search(keys[:10]), "search")
    assert hf.all()
    assert P.both(lambda s: s.vh.remove(keys[:10]), "remove").all()
    _, fd = P.both(lambda s: s.vh.get(keys[:10]), "get")
    assert not fd.any()
    for s in (P.j, P.p):
        err = JVH.DoubleFreeError if s.jax else DoubleFreeError
        with pytest.raises(err):
            s.vh.free_handles(keys[:10], hv)
        with pytest.raises(err):
            s.vh.free_handles(keys[:1], np.asarray([0xFFFF_FFFF_FFFF_FFFF],
                                                   np.uint64))
    same(P.j, P.p, "after refusals")


def test_stale_handle_revalidates_through_retry(eight_devices):
    P, keys, pay = loaded(n=200)
    stale, _ = P.both(lambda s: s.e.search(keys[:20]), "search")
    P.both(lambda s: s.vh.put(keys[:20], [b"NEW"] * 20), "put")
    _, _, ver_ok = P.both(lambda s: s.vh.resolve_u64(stale,
                                                     np.ones(20, bool)),
                          "stale resolve")
    assert not ver_ok.any()
    got, found = P.both(lambda s: s.vh.get(keys[:20]), "get")
    assert found.all() and all(g == b"NEW" for g in got)


def test_torn_slab_typed_never_wrong(eight_devices):
    P, keys, pay = loaded(n=200)
    vals, _ = P.both(lambda s: s.e.search(keys[:1]), "search")
    row, slab, cls, ver = (int(x[0]) for x in VH.unpack_handles(vals))
    off = slab * VH.HEAP_CLASSES[cls]
    bad = int(np.uint32((((ver + 7) & 0xFFFF) << 16) | 1).view(np.int32))
    P.both(lambda s: s.d.heap_write_cells([row], [off], [bad]), "tear")
    for s in (P.j, P.p):
        with pytest.raises(s.VH.HeapCorruptError):
            s.vh.get(keys[:1])
    same(P.j, P.p, "after the typed refusal")
    got, found = P.both(lambda s: s.vh.get(keys[1:50]), "get")
    assert found.all() and got == pay[1:50]


def test_heap_full_typed(eight_devices):
    P = Pair(heap_pages=2)
    keys = keyspace(100)

    def go(s):
        s.B.bulk_load(s.t, keys, keys ^ np.uint64(0xD00D))
        s.e.attach_router()
        s.vh = s.e.attach_value_heap()
        with pytest.raises(s.VH.HeapFullError):
            s.vh.put(keys, [b"x" * 200 for _ in range(keys.size)])
    P.both(go, "full")


# -- scrub -------------------------------------------------------------------

def test_scrub_reclaims_leaks_counts_orphans(eight_devices):
    P, keys, _ = loaded(n=200)
    row, slab = P.both(lambda s: s.vh._alloc(0, 0, 1)[0], "alloc")
    hdr = int(np.uint32((3 << 16) | 8).view(np.int32))

    def leak(s):
        s.d.heap_write_cells([row], [slab * VH.HEAP_CLASSES[0]], [hdr])
        s.vh._ver[row, slab] = 3
    P.both(leak, "leak")
    hv, _ = P.both(lambda s: s.e.search(keys[:3]), "search")
    P.both(lambda s: s.vh.free_handles(keys[:3], hv), "orphan")
    res = P.both(lambda s: s.vh.scrub(repair=True), "scrub")
    assert res["leaked"] >= 1 and res["orphans"] == 3
    assert (row, slab) in P.p.vh._free[(0, 0)]


# -- durability planes -------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restore_bit_identity(eight_devices, tmp_path, writer):
    """A full heap checkpoint written by either package restores in both
    to the same heap, the same rebuilt allocator and the same payloads."""
    P, keys, pay = loaded(n=300)
    P.both(lambda s: s.e.flush_parents(), "flush")
    w = P.j if writer == "jax" else P.p
    path = str(tmp_path / "c.npz")
    w.CK.checkpoint(w.c, path)
    before = _heap_np(w)
    with np.load(path) as z:
        assert z["heap"].dtype == np.int32 and "heap" in z.files
    sides = []
    for jx, ck in ((True, JCK), (False, CK)):
        c2 = ck.restore(path) if jx else ck.restore(path, device="cpu")
        s2 = Side(jx, cluster=c2)
        _eq(_heap_np(s2), before, "restored heap")
        s2.e.attach_router()
        s2.vh = s2.e.attach_value_heap()
        rb = s2.vh.rebuild()
        assert rb["pages_carved"] == P.p.vh.stats()["pages_carved"]
        sides.append(s2)
    same(sides[0], sides[1], "restored")
    got = [s.vh.get(keys) for s in sides]
    _eq(got[0], got[1])
    assert got[1][1].all() and got[1][0] == pay


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_delta_chain_carries_heap_rows(eight_devices, tmp_path, writer):
    P, keys, pay = loaded(n=300)
    P.both(lambda s: s.e.flush_parents(), "flush")
    w = P.j if writer == "jax" else P.p
    names = {w.jax: ("base.npz", "d1.npz"),
             not w.jax: ("base_o.npz", "d1_o.npz")}
    epochs = {}

    def base(s):
        epochs[s.jax] = s.CK.checkpoint(
            s.c, str(tmp_path / names[s.jax][0]))
    P.both(base, "base")
    new_pay = [b"delta!" for _ in range(40)]
    P.both(lambda s: s.vh.put(keys[:40], new_pay), "put")
    P.both(lambda s: s.CK.checkpoint_delta(
        s.c, str(tmp_path / names[s.jax][1]),
        parent_epoch=epochs[s.jax])["pages"], "delta")
    base, d1 = (str(tmp_path / n) for n in names[w.jax])
    with np.load(d1) as z:
        assert z["heap_rows"].size > 0
        hrows, hpages = z["heap_rows"], z["heap_pages"]
    _eq(hpages, _heap_np(w)[hrows], "delta pages")
    sides = []
    for jx, ck in ((True, JCK), (False, CK)):
        c2 = (ck.restore_chain(base, [d1]) if jx
              else ck.restore_chain(base, [d1], device="cpu"))
        s2 = Side(jx, cluster=c2)
        s2.e.attach_router()
        s2.vh = s2.e.attach_value_heap()
        s2.vh.rebuild()
        sides.append(s2)
    same(sides[0], sides[1], "chain")
    _eq(_heap_np(sides[1]), _heap_np(w), "chain heap")
    got, found = sides[1].vh.get(keys[:60])
    assert found.all()
    for i in range(60):
        assert got[i] == (new_pay[i] if i < 40 else pay[i])


def test_recovery_replay_rpo_zero(eight_devices, tmp_path):
    """A journaled heap sequence, a crash, ``recover``: both packages'
    journals are byte-identical, and each recovers its own directory and
    the other's to the same heap, allocator and payloads."""
    P, keys, pay = loaded(n=300)
    dirs = {True: str(tmp_path / "j"), False: str(tmp_path / "p")}

    def plane(s):
        s.plane = s.RC.RecoveryPlane(s.c, s.t, s.e, dirs[s.jax])
        s.plane.checkpoint_base()
    P.both(plane, "base", state=False)
    post = [b"post-base" for _ in range(50)]
    P.both(lambda s: s.vh.put(keys[:50], post), "put")
    P.both(lambda s: s.vh.remove(keys[50:60]), "remove")
    segs = {}
    for s in (P.j, P.p):
        s.e.journal.sync_now()
        with open(s.e.journal.path, "rb") as f:
            segs[s.jax] = f.read()
    assert segs[True] == segs[False]
    kinds = [r[0] for r in J.read_records(P.p.e.journal.path)]
    assert kinds[0] == J.J_HEAP_PUT and J.J_UPSERT in kinds \
        and J.J_HEAP_FREE in kinds
    for s in (P.j, P.p):
        s.plane.close()
    out = []
    for src in (True, False):
        for jx in (True, False):
            # recover re-bases its directory: each recovery gets a copy
            rdir = str(tmp_path / f"r{int(src)}{int(jx)}")
            shutil.copytree(dirs[src], rdir)
            rc = JRC if jx else RC
            kw = {} if jx else {"device": "cpu"}
            _, c2, t2, e2, receipt = rc.RecoveryPlane.recover(
                rdir, batch_per_node=256, **kw)
            assert receipt["replay"]["heap_puts"] >= 1
            assert receipt["replay"]["heap_frees"] >= 1
            s2 = Side(jx, cluster=c2, tree=t2, eng=e2)
            got, found = s2.vh.get(keys[:70])
            assert not found[50:60].any()
            assert got[:50] == post and got[60:70] == pay[60:70]
            out.append(s2)
    same(out[0], out[1], "jax dir")
    same(out[2], out[3], "port dir")
    _eq(_heap_np(out[1]), _heap_np(out[3]), "heaps")


def test_journal_heap_record_roundtrip(tmp_path):
    keys = np.asarray([3, 5], np.uint64)
    handles = np.asarray([0x10000 | 7, 0x20000 | 9], np.uint64)
    pays = [b"abc", b"defgh"]
    blobs = []
    for jj, name in ((JJ, "j.wal"), (J, "p.wal")):
        path = str(tmp_path / name)
        with jj.Journal(path) as j:
            j.append_heap(jj.J_HEAP_PUT, keys, handles, pays)
            j.append(jj.J_HEAP_FREE, keys, handles)
        recs = J.read_records(path)
        assert recs[0][0] == J.J_HEAP_PUT and (recs[0][1] == keys).all()
        h2, p2 = recs[0][2]
        assert (h2 == handles).all() and p2 == pays
        assert recs[1][0] == J.J_HEAP_FREE and (recs[1][2] == handles).all()
        with open(path, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]


def test_from_jax_arrays_carries_the_heap(eight_devices):
    """A JAX heap tree handed over with ``heap=``: the port's heap and
    rebuilt allocator equal a JAX engine's rebuilt one, every ``get``
    equals JAX's, and the next puts allocate the same slabs."""
    P, keys, pay = loaded(n=300)
    P.both(lambda s: s.vh.put(keys[:40], [b"x" * 100] * 40), "put")
    P.both(lambda s: s.vh.remove(keys[40:50]), "remove")
    P.both(lambda s: s.e.flush_parents(), "flush")
    j = P.j
    # the hand-over carries state, not the dirty tracking (as for the pool)
    j.d.clear_dirty()
    dirs = j.c.directories
    c2, t2, e2 = state.from_jax_arrays(
        np.asarray(j.d.pool), np.asarray(j.d.locks),
        np.asarray(j.d.counters), j.t._root_addr, j.t._root_level,
        [d.allocator._next for d in dirs], device="cpu", batch_per_node=256,
        heap=np.asarray(j.d.heap), step_capacity=512, chunk_pages=32,
        free_pages=[bits.make_addr(d.node_id, p) & 0xFFFFFFFF
                    for d in dirs for p in d.allocator.free_pages_list])
    p = Side(False, cluster=c2, tree=t2, eng=e2)
    p.e.attach_router()
    # a fresh JAX heap rebuilt from its region: what the port rebuilt
    j.vh = j.e.attach_value_heap()
    j.vh.rebuild()
    same(j, p, "handed over")
    got_j, got_p = j.vh.get(keys), p.vh.get(keys)
    _eq(got_j, got_p)
    _eq(j.vh.put(keys[:20], [b"after" * 3] * 20),
        p.vh.put(keys[:20], [b"after" * 3] * 20))
    _eq(_heap_np(j), _heap_np(p))
    _eq(j.vh._free, p.vh._free)
    with pytest.raises(ConfigError):
        state.from_jax_arrays(
            np.asarray(j.d.pool), np.asarray(j.d.locks),
            np.asarray(j.d.counters), j.t._root_addr, j.t._root_level,
            [d.allocator._next for d in dirs], device="cpu",
            heap=np.zeros((3, 7), np.int32))


# -- heap collector ----------------------------------------------------------

def test_heap_collector_registered(eight_devices):
    P, keys, _ = loaded(n=100)
    P.both(lambda s: s.vh.get(keys[:10]), "get")
    snaps = (JOBS.snapshot(), OBS.snapshot())
    for snap in snaps:
        assert snap.get("heap.puts", 0) >= 100
        assert snap.get("heap.gets", 0) >= 10
    _eq({k: v for k, v in snaps[0].items() if k.startswith("heap.")},
        {k: v for k, v in snaps[1].items() if k.startswith("heap.")})
    P.p.vh.detach()
    assert P.p.e.value_heap is None
    assert "heap.free_slabs" not in OBS.snapshot()


# -- regressions of the reference --------------------------------------------

def test_replay_heals_partial_put_window(eight_devices, tmp_path):
    """A crash between a put's J_HEAP_PUT and its J_UPSERT: the replay
    installs the record's own handles, so the acked record stays
    readable; both packages recover the same state."""
    P, keys, pay = loaded(n=100)
    dirs = {True: str(tmp_path / "j"), False: str(tmp_path / "p")}

    def plane(s):
        s.plane = s.RC.RecoveryPlane(s.c, s.t, s.e, dirs[s.jax])
        s.plane.checkpoint_base()
    P.both(plane, "base", state=False)
    k = keys[:1]
    P.both(lambda s: s.vh.put(k, [b"acked-v1"]), "put")
    vals, _ = P.both(lambda s: s.e.search(k), "search")
    rows, slabs, clss, vers = VH.unpack_handles(vals)
    h2 = VH.pack_handles(rows, slabs, clss, (vers % 0xFFFF) + 1)
    for s in (P.j, P.p):
        jj = JJ if s.jax else J
        s.e.journal.append_heap(jj.J_HEAP_PUT, k, h2, [b"torn-v2"])
        s.plane.close()
    rec = []
    for jx in (True, False):
        rc = JRC if jx else RC
        kw = {} if jx else {"device": "cpu"}
        _, c2, t2, e2, _ = rc.RecoveryPlane.recover(dirs[jx],
                                                    batch_per_node=256, **kw)
        got, found = e2.value_heap.get(k)
        assert found[0] and got[0] == b"torn-v2"
        rec.append(Side(jx, cluster=c2, tree=t2, eng=e2))
    same(rec[0], rec[1], "recovered")


def test_free_wrong_class_handle_typed(eight_devices):
    P, keys, pay = loaded(n=100)
    P.both(lambda s: s.vh.put(keys[:1], [b"tiny"]), "put")
    vals, _ = P.both(lambda s: s.e.search(keys[:1]), "search")
    row, slab, cls, ver = (int(x[0]) for x in VH.unpack_handles(vals))
    assert cls == 0
    forged = VH.pack_handles([row], [3], [1], [int(P.p.vh._ver[row, 3]) or 1])
    for s in (P.j, P.p):
        err = JVH.DoubleFreeError if s.jax else DoubleFreeError
        with pytest.raises(err):
            s.vh.free_handles(keys[:1], forged)
    got, found = P.both(lambda s: s.vh.get(keys[:1]), "get")
    assert found[0] and got[0] == b"tiny"
