"""Port parity: the hot-key leaf cache (``sherman_tpu_torch/models/
leaf_cache.py``), its engine hooks and the staged loop's ``cache_probe``,
against the JAX package, case by case after tests/test_leaf_cache.py.

Both packages build the same tree, attach the same cache and drive the
same calls: the answers, the cache's host mirror (keys, values, versions,
addresses, slots, the payload sidecar and the admission sketch), its
device tables, its stats, and the pools, lock tables and counters must be
equal after every call; cached answers must also equal the uncached
ones.  The staged cases compare the drained carries at ``aligned`` and
``pipelined``, the residual cap's tightening and its overflow void.  The
JAX side runs as its own tests run it (``gather_impl="xla"``, the
``eight_devices`` fixture).  Every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu import chaos as JCH
from sherman_tpu import obs as JOBS
from sherman_tpu import recovery as JRC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models import leaf_cache as JLC
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.models.scrub import Scrubber as JScrubber
from sherman_tpu.obs import device as JDEV
from sherman_tpu.ops import bits as JBITS
from sherman_tpu.workload import device_prep as JP
from sherman_tpu.workload import zipf as JZ
from sherman_tpu_torch import chaos as CH
from sherman_tpu_torch import obs as OBS
from sherman_tpu_torch import recovery as RC
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models import leaf_cache as LC
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.models.scrub import Scrubber
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.workload import device_prep as TP
from sherman_tpu_torch.workload import zipf as TZ

torch.set_num_threads(1)

SALT = 0x5E17_AB1E_5A17
MIRROR = ("_khi", "_klo", "_vhi", "_vlo", "_ver", "_addr", "_slot", "_keys")


def _eq(a, b, what=""):
    """Deep exact equality of numpy arrays, tuples, lists and dicts."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
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
    else:
        assert a == b, (what, a, b)


class Side:
    """One package's cluster, tree, engine and module handles."""

    def __init__(self, jax_side, nr, pages, cap, B, tcfg):
        self.jax = jax_side
        self.B = JB if jax_side else TB
        self.CH = JCH if jax_side else CH
        kw = dict(machine_nr=nr, pages_per_node=pages, locks_per_node=512,
                  step_capacity=cap, chunk_pages=32)
        cfg = (JDSMConfig(gather_impl="xla", **kw) if jax_side
               else DSMConfig(device="cpu", **kw))
        self.c = (JCluster if jax_side else Cluster)(cfg)
        self.t = (JTree if jax_side else Tree)(self.c)
        tc = None
        if tcfg:
            tc = (JTreeConfig if jax_side else TreeConfig)(**tcfg)
        self.e = self.B.BatchedEngine(self.t, batch_per_node=B, tcfg=tc)
        self.d = self.c.dsm

    def fire(self, faults):
        plan = (faults if isinstance(faults, self.CH.FaultPlan)
                else self.CH.FaultPlan([dict(f) for f in faults]))
        self.d.install_chaos(plan)
        self.d.read_word(0, 0)
        self.d.install_chaos(None)
        return plan


class Pair:
    """The same cluster in both packages; ``both(fn)`` runs ``fn(side)``
    on each and asserts equal results and equal state."""

    def __init__(self, nr=1, pages=2048, cap=512, B=256, **tcfg):
        self.j = Side(True, nr, pages, cap, B, tcfg)
        self.p = Side(False, nr, pages, cap, B, tcfg)

    def both(self, fn, what="", state=True):
        a, b = fn(self.j), fn(self.p)
        _eq(a, b, what)
        if state:
            self.check(what)
        return b

    def load(self, n=3000, step=3, router=True):
        keys = np.arange(100, 100 + n * step, step, dtype=np.uint64)
        vals = keys * np.uint64(7)

        def go(s):
            s.B.bulk_load(s.t, keys, vals)
            if router:
                s.e.attach_router()
        self.both(go, "load")
        return keys, vals

    def attach(self, **kw):
        self.both(lambda s: s.e.attach_leaf_cache(**kw) and None, "attach")
        return self.j.e.leaf_cache, self.p.e.leaf_cache

    def check(self, what=""):
        jd, pd = self.j.d, self.p.d
        _eq(np.asarray(jd.pool), pd.pool, what + " pool")
        _eq(np.asarray(jd.locks), pd.locks, what + " locks")
        _eq(np.asarray(jd.counters), pd.counters_np(), what + " counters")
        jc, pc = self.j.e.leaf_cache, self.p.e.leaf_cache
        assert (jc is None) == (pc is None)
        if pc is not None:
            for a in MIRROR:
                _eq(getattr(jc, a), getattr(pc, a), f"{what} mirror {a}")
            _eq(jc.stats(), pc.stats(), what + " stats")
            _eq(jc._sidecar, pc._sidecar, what + " sidecar")
            _eq(jc._freq, pc._freq, what + " sketch")
            _eq(jc._dirty, pc._dirty, what + " dirty")
            if not pc._dirty:
                _eq([np.asarray(t) for t in jc._dev],
                    list(pc._dev), what + " device tables")


# -- hash + analytic helpers --------------------------------------------------

def test_slot_hash_np_matches_device(eight_devices):
    import jax
    rng = np.random.default_rng(3)
    khi = rng.integers(-2**31, 2**31, 257, dtype=np.int64).astype(np.int32)
    klo = rng.integers(-2**31, 2**31, 257, dtype=np.int64).astype(np.int32)
    want = np.asarray(jax.jit(JLC.slot_hash)(khi, klo))
    _eq(LC.slot_hash_np(khi, klo), want)
    _eq(LC.slot_hash(torch.from_numpy(khi), torch.from_numpy(klo)).numpy(),
        want.astype(np.int64))
    x = rng.integers(0, 2**32, 1000, dtype=np.int64).astype(np.uint32)
    _eq(bits.hash32_np(x), JBITS.hash32_np(x))


def test_expected_hit_ratio_shape():
    n, th = 100_000, 0.99
    for k in (0, 10, 100, 1000, 10_000, n // 100, n, n + 5):
        for t in (th, 0.0, 0.5):
            assert TZ.expected_hit_ratio(n, t, k) == \
                JZ.expected_hit_ratio(n, t, k)
    assert TZ.expected_hit_ratio(n, th, 0) == 0.0
    assert TZ.expected_hit_ratio(n, th, n) == pytest.approx(1.0)
    r = [TZ.expected_hit_ratio(n, th, k) for k in (10, 100, 1000, 10_000)]
    assert all(a < b for a, b in zip(r, r[1:]))
    assert TZ.expected_hit_ratio(n, th, n // 100) > 0.5
    assert TZ.expected_hit_ratio(n, 0.0, n // 4) == pytest.approx(0.25)


# -- probe correctness --------------------------------------------------------

def test_probe_hits_are_bit_identical(eight_devices):
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=1024)
    r = P.both(lambda s: s.e.leaf_cache.fill(keys[:300]), "fill")
    assert r["placed"] == 300
    # the uncached answers first (the cache detached), then cached
    caches = (P.j.e.leaf_cache, P.p.e.leaf_cache)
    P.j.e.leaf_cache = P.p.e.leaf_cache = None
    v0, f0 = P.both(lambda s: s.e.search(keys[:600]), "uncached")
    P.j.e.leaf_cache, P.p.e.leaf_cache = caches
    v1, f1 = P.both(lambda s: s.e.search(keys[:600]), "cached")
    _eq(v0, v1)
    _eq(f0, f1)
    st = caches[1].stats()
    assert st["hits"] == 300 and st["misses"] == 300
    v, f = P.both(lambda s: s.e.search(keys[:4] + np.uint64(1)), "absent")
    assert not f.any() and (v == 0).all()


@pytest.mark.parametrize("nr", [4, 8])
def test_probe_multinode_mesh(eight_devices, nr):
    P = Pair(nr=nr, B=128)
    keys, vals = P.load(n=2000)
    P.attach(slots=1024)
    assert P.both(lambda s: s.e.leaf_cache.fill(keys[:256]),
                  "fill")["placed"] == 256
    v, f = P.both(lambda s: s.e.search(keys[:512]), "search")
    assert f.all()
    _eq(v, vals[:512])
    assert P.p.e.leaf_cache.stats()["hits"] == 256
    dup = np.concatenate([keys[:64]] * 6)
    v2, f2 = P.both(lambda s: s.e.search_combined(dup), "combined")
    assert f2.all()
    _eq(v2, dup * np.uint64(7))
    # the uncached answers equal the cached ones
    P.both(lambda s: s.e.detach_leaf_cache(), "detach")
    v3, f3 = P.both(lambda s: s.e.search_combined(dup), "uncached")
    _eq(v3, v2)
    _eq(f3, f2)


def test_search_combined_merges_hits_per_client(eight_devices):
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=512)
    P.both(lambda s: s.e.leaf_cache.fill(keys[:100]), "fill")
    cli = np.concatenate([keys[:100], keys[500:550], keys[:100],
                          np.array([keys[7] + np.uint64(1)], np.uint64)])
    perm = np.random.default_rng(5).permutation(cli.size)
    v, f = P.both(lambda s: s.e.search_combined(cli[perm]), "combined")
    exp_f = np.concatenate([np.ones(250, bool), np.zeros(1, bool)])[perm]
    _eq(f, exp_f)
    _eq(v[f], (cli[perm] * np.uint64(7))[f])


def test_stale_after_write_serves_new_value(eight_devices):
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=512)
    P.both(lambda s: s.e.leaf_cache.fill(keys[:100]), "fill")
    inv0 = P.p.e.leaf_cache.invalidations
    P.both(lambda s: s.e.insert(keys[:10], keys[:10] * np.uint64(99)),
           "insert")
    assert P.p.e.leaf_cache.invalidations >= inv0 + 10
    v, f = P.both(lambda s: s.e.search(keys[:20]), "search")
    assert f.all()
    _eq(v[:10], keys[:10] * np.uint64(99))
    _eq(v[10:], vals[10:20])


def test_validation_catches_unhooked_writes(eight_devices):
    """The invalidation hook sabotaged on both sides: the pool validation
    alone keeps the answers right, and the stale probes clear their own
    device slots (the host mirror keeps them, as the reference's does)."""
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=512)
    P.both(lambda s: s.e.leaf_cache.fill(keys[:100]), "fill")
    for s in (P.j, P.p):
        s.e.leaf_cache.invalidate_keys = lambda ks: 0
    P.both(lambda s: s.e.insert(keys[:10], keys[:10] * np.uint64(55)),
           "insert")
    v, f = P.both(lambda s: s.e.search(keys[:10]), "search")
    assert f.all()
    _eq(v, keys[:10] * np.uint64(55))
    assert P.p.e.leaf_cache.invalidations > 0


def test_delete_then_reinsert_bit_identity(eight_devices):
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=512)
    P.both(lambda s: s.e.leaf_cache.fill(keys[:100]), "fill")
    assert P.both(lambda s: s.e.delete(keys[:50]), "delete").all()
    v, f = P.both(lambda s: s.e.search(keys[:100]), "search")
    assert not f[:50].any() and f[50:].all()
    P.both(lambda s: s.e.insert(keys[:50], keys[:50] * np.uint64(3)),
           "reinsert")
    P.both(lambda s: s.e.leaf_cache.fill(keys[:100]), "refill")
    v, f = P.both(lambda s: s.e.search(keys[:100]), "search 2")
    assert f.all()
    _eq(v[:50], keys[:50] * np.uint64(3))
    _eq(v[50:], vals[50:100])
    assert P.p.e.leaf_cache.stats()["hits"] > 0


def test_mixed_reads_probe_and_writes_invalidate(eight_devices):
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=512)
    P.both(lambda s: s.e.leaf_cache.fill(keys[:100]), "fill")
    n_r, n_w = 100, 60
    mk = np.concatenate([keys[:n_r], keys[200:200 + n_w]])
    mv = np.concatenate([np.zeros(n_r, np.uint64),
                         keys[200:200 + n_w] * np.uint64(13)])
    is_read = np.concatenate([np.ones(n_r, bool), np.zeros(n_w, bool)])
    h0 = P.p.e.leaf_cache.hits
    out_v, out_f, st = P.both(lambda s: s.e.mixed(mk, mv, is_read), "mixed")
    assert out_f[:n_r].all()
    _eq(out_v[:n_r], vals[:n_r])
    assert (st[n_r:] == TB.ST_APPLIED).sum() == n_w
    assert P.p.e.leaf_cache.hits > h0
    v, f = P.both(lambda s: s.e.search(keys[200:200 + n_w]), "search")
    assert f.all()
    _eq(v, keys[200:200 + n_w] * np.uint64(13))


def test_storm_bit_identity_with_splits(eight_devices):
    """Reads, writes, deletes and leaf splits with the cache on, at four
    nodes: both packages agree call by call, and with the model."""
    P = Pair(nr=4, pages=8192, cap=512, B=256)
    coarse = np.arange(1 << 20, 1 << 21, 1 << 13, dtype=np.uint64)

    def go(s):
        s.B.bulk_load(s.t, coarse, coarse)
        s.e.attach_router()
    P.both(go, "load")
    P.attach(slots=1024)
    model = {int(k): int(k) for k in coarse}
    rng = np.random.default_rng(9)
    for wave in range(2):
        fk = np.array(sorted(model)[:P.p.e.leaf_cache.capacity], np.uint64)
        P.both(lambda s: s.e.leaf_cache.fill(fk), "fill")
        dense = np.unique((coarse[:, None] + rng.integers(
            1, 1 << 13, (coarse.shape[0], 10),
            dtype=np.uint64)).reshape(-1))
        vals = dense + np.uint64(wave + 1)
        P.both(lambda s: s.e.insert(dense, vals), "insert")
        model.update(zip(dense.tolist(), vals.tolist()))
        doomed = rng.choice(dense, 40, replace=False)
        P.both(lambda s: s.e.delete(doomed), "delete")
        for k in np.unique(doomed).tolist():
            model.pop(int(k), None)
        sample = rng.choice(np.array(sorted(model), np.uint64), 600)
        v, f = P.both(lambda s: s.e.search(sample), "search")
        assert f.all()
        _eq(v, np.array([model[int(k)] for k in sample], np.uint64))
        mr = rng.choice(np.array(sorted(model), np.uint64), 200)
        mw = rng.choice(dense, 100, replace=False)
        mwv = mw + np.uint64(wave + 7)
        out_v, out_f, _ = P.both(lambda s: s.e.mixed(
            np.concatenate([mr, mw]),
            np.concatenate([np.zeros(200, np.uint64), mwv]),
            np.concatenate([np.ones(200, bool), np.zeros(100, bool)])),
            "mixed")
        assert out_f[:200].all()
        _eq(out_v[:200], np.array([model[int(k)] for k in mr], np.uint64))
        model.update(zip(mw.tolist(), mwv.tolist()))
    assert P.p.e.leaf_cache.stats()["hits"] > 0
    P.p.t.check_structure()


def test_admission_observe_warms_cache(eight_devices):
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=512, admit_every=2)
    zipf = TZ.ZipfGen(keys.size, 0.99, seed=4)
    for _ in range(4):
        batch = keys[zipf.sample(400)]
        v, f = P.both(lambda s: s.e.search(batch), "search")
        assert f.all()
        _eq(v, batch * np.uint64(7))
    st = P.p.e.leaf_cache.stats()
    assert st["fills"] >= 1 and st["cached_keys"] > 0 and st["hits"] > 0
    _eq(P.j.e.leaf_cache.sketch_stats(), P.p.e.leaf_cache.sketch_stats())


def test_reclaim_unlink_invalidates_pages(eight_devices):
    """Reclaim unlinks emptied leaves: the cached entries on either side
    of every unlinked pair drop out, as the reference's do."""
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=1024)
    P.both(lambda s: s.e.leaf_cache.fill(keys[::7][:400]), "fill")
    band = keys[300:900]
    P.both(lambda s: s.e.delete(band), "delete")
    P.both(lambda s: s.e.leaf_cache.fill(keys[::7][:400]), "refill")
    inv0 = P.p.e.leaf_cache.invalidations
    st = P.both(lambda s: s.e.reclaim_empty_leaves(), "reclaim")
    assert st["unlinked"] > 0
    assert P.p.e.leaf_cache.invalidations > inv0
    v, f = P.both(lambda s: s.e.search(keys[::3]), "search")
    live = ~np.isin(keys[::3], band)
    _eq(f, live)
    _eq(v[live], vals[::3][live])


# -- chaos: flipped entry versions must miss, never lie ----------------------

def test_chaos_flipped_entry_version_misses_not_lies(eight_devices):
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=512)
    P.both(lambda s: s.e.leaf_cache.fill(keys[:100]), "fill")
    i = 7
    c = P.p.e.leaf_cache
    j = int(np.nonzero(c._keys == keys[i])[0][0])
    victim, slot = int(c._addr[j]), int(c._slot[j])
    plans = {}

    def fire(s):
        plans[s.jax] = s.fire([{"kind": "flip_entry_ver", "step": 0,
                                "addr": victim, "slot": slot}])
    P.both(fire, "fire")
    inv0 = c.invalidations
    v, f = P.both(lambda s: s.e.search(keys[:100]), "search")
    exp = np.ones(100, bool)
    exp[i] = False
    _eq(f, exp)
    _eq(v[exp], vals[:100][exp])
    assert c.invalidations > inv0
    P.both(lambda s: plans[s.jax].undo(s.d), "undo")
    v, f = P.both(lambda s: s.e.search(keys[i:i + 1]), "search 2")
    assert f.all() and v[0] == int(vals[i])


def test_chaos_fuzz_never_wrong_answers(eight_devices):
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=512)
    for round_i in range(3):
        P.both(lambda s: s.e.leaf_cache.fill(keys[:200]), "fill")
        plans = {}

        def fire(s):
            plans[s.jax] = s.fire(s.CH.FaultPlan.random(100 + round_i,
                                                        n_faults=3))
        P.both(fire, "fire")
        v, f = P.both(lambda s: s.e.search(keys[:400]), "search")
        assert (v[f] == vals[:400][f]).all()
        P.both(lambda s: plans[s.jax].undo(s.d), "undo")


# -- flush contracts ----------------------------------------------------------

def test_degraded_entry_flushes_cache(eight_devices):
    P = Pair()
    keys, vals = P.load()
    P.attach(slots=512)
    P.both(lambda s: s.e.leaf_cache.fill(keys[:100]), "fill")
    assert P.p.e.leaf_cache.stats()["cached_keys"] == 100
    P.both(lambda s: s.e.enter_degraded("test: synthetic damage"),
           "degraded")
    assert P.p.e.leaf_cache.stats()["cached_keys"] == 0
    v, f = P.both(lambda s: s.e.search(keys[:50]), "search")
    assert f.all()
    _eq(v, vals[:50])
    P.both(lambda s: s.e.exit_degraded(), "exit")


def test_quarantine_drops_page_keys(eight_devices):
    P = Pair(nr=4, pages=1024, cap=256, B=128)
    keys, vals = P.load(n=1500)
    P.attach(slots=512)
    P.both(lambda s: s.e.leaf_cache.fill(keys[:200]), "fill")
    c = P.p.e.leaf_cache
    j = int(np.nonzero(c._keys == keys[50])[0][0])
    victim = int(c._addr[j])
    assert ((c._addr == victim) & (c._keys != 0)).sum() >= 1
    plans = {}

    def fire(s):
        plans[s.jax] = s.fire([{"kind": "flip_entry_ver", "step": 0,
                                "addr": victim, "slot": 2}])
    P.both(fire, "fire")
    scr = {}

    def scrub(s):
        scr[s.jax] = (JScrubber if s.jax else Scrubber)(s.e, interval=1)
        r = scr[s.jax].scrub()
        return (r["new_violations"], r["quarantined"], r["degraded"])
    nv, _, deg = P.both(scrub, "scrub")
    assert nv >= 1 and not deg
    assert not ((c._addr == victim) & (c._keys != 0)).any()
    P.both(lambda s: plans[s.jax].undo(s.d), "undo")
    P.both(lambda s: scr[s.jax].release_quarantine(), "release")


def test_targeted_repair_flushes_cache(eight_devices, tmp_path):
    P = Pair(nr=4, pages=1024, cap=256, B=128, sibling_chase_budget=4,
             lock_retry_rounds=2)
    keys, vals = P.load(n=1200)
    P.attach(slots=512)
    planes = {}

    def base(s):
        planes[s.jax] = (JRC if s.jax else RC).RecoveryPlane(
            s.c, s.t, s.e, str(tmp_path / ("j" if s.jax else "p")))
        planes[s.jax].checkpoint_base()
    P.both(base, "base")
    P.both(lambda s: s.e.leaf_cache.fill(keys[:100]), "fill")
    victim = int(P.p.t._descend(int(keys[600]))[0])
    assert victim == int(P.j.t._descend(int(keys[600]))[0])
    scr = {}

    def fault(s):
        scr[s.jax] = (JScrubber if s.jax else Scrubber)(s.e, interval=1)
        s.fire([{"kind": "torn_page", "step": 0, "addr": victim}])
        r = scr[s.jax].scrub()
        return r["violations"] >= 1, s.e.degraded
    assert P.both(fault, "fault") == (True, True)
    assert P.p.e.leaf_cache.stats()["cached_keys"] == 0
    P.both(lambda s: s.e.leaf_cache.fill(keys[:50]), "refill")

    def repair(s):
        rep = planes[s.jax].targeted_repair(scr[s.jax])
        return rep["ok"], s.e.degraded
    assert P.both(repair, "repair", state=False) == (True, False)
    assert P.p.e.leaf_cache.stats()["cached_keys"] == 0
    assert P.j.e.leaf_cache.stats()["cached_keys"] == 0
    v, f = P.both(lambda s: s.e.search(keys[:200]), "search", state=False)
    assert f.all()
    _eq(v, vals[:200])
    for p in planes.values():
        p.close()


# -- the staged serving loop --------------------------------------------------

def _staged_side(jax_side, nr, B, n_keys):
    s = Side(jax_side, nr, 2048, B, B, {})
    ranks = np.arange(n_keys, dtype=np.uint64)
    keys = bits.mix64_np(ranks ^ np.uint64(SALT))
    order = np.argsort(keys)
    s.B.bulk_load(s.t, keys[order], (keys ^ np.uint64(0xDEADBEEF))[order],
                  fill=0.8)
    s.e.attach_router()
    return s


def _run_staged(s, nr, B, n_keys, fusion, lc, S=4, resid=None, seal=True):
    """Two warm-up steps and ``S`` sealed steps, drained.  -> (carry as
    ints, retraces in the sealed window, step)."""
    mod = JP if s.jax else TP
    step, (new_carry, tb, rt, rk) = mod.make_staged_step(
        s.e, n_keys=n_keys, theta=0.99, salt=SALT, batch=B, dev_b=B,
        log2_bins=16, fusion=fusion, leaf_cache=lc, dev_b_resid=resid)
    carry = new_carry()
    counters = s.d.counters
    ledger = (JDEV if s.jax else DEV).get_ledger()
    for _ in range(2):
        counters, carry = step(s.d.pool, counters, tb, rt, rk, carry)
    carry = step.drain(carry)
    r0 = ledger.retraces
    if seal:
        ledger.seal()
    try:
        for _ in range(S):
            counters, carry = step(s.d.pool, counters, tb, rt, rk, carry)
        carry = step.drain(carry)
    finally:
        if seal:
            ledger.unseal()
    retr = ledger.retraces - r0
    s.d.counters = counters
    return tuple(int(np.asarray(x)) for x in carry), retr, step


@pytest.mark.parametrize("fusion", ["aligned", "pipelined"])
@pytest.mark.parametrize("nr", [1, 8])
def test_staged_cache_receipts_bit_identical(eight_devices, fusion, nr):
    """Cache-on receipts equal cache-off's and JAX's; hits > 0, the
    measured hit ratio near the zipf prediction, the sealed window free
    of retraces with the probe in it."""
    B, n_keys = (2048, 20_000) if nr == 1 else (512, 8_000)
    S = 4
    out = {}
    for jx in (True, False):
        s = _staged_side(jx, nr, B, n_keys)
        for label in ("off", "on"):
            lc = placed = None
            if label == "on":
                lc = s.e.attach_leaf_cache(slots=2048)
                hot = bits.mix64_np(np.arange(lc.capacity, dtype=np.uint64)
                                    ^ np.uint64(SALT))
                placed = lc.fill(hot)["placed"]
            vals, retr, step = _run_staged(s, nr, B, n_keys, fusion, lc, S)
            assert retr == 0
            assert vals[1] == 1 and vals[2] == (S + 2) * B * nr
            out[(jx, label)] = vals
            if lc is not None:
                assert step.phase_labels["cache_probe"] == \
                    "staged.cache_probe"
                assert step.jserve is s.e._get_search_fanout(s.e._iters())
                measured = vals[5] / ((S + 2) * B * nr)
                pred = TZ.expected_hit_ratio(n_keys, 0.99, placed)
                assert vals[5] > 0 and vals[6] > 0
                assert abs(measured - pred) < 0.05, (measured, pred)
                s.e.detach_leaf_cache()
        if not jx:
            assert list(step.programs) == ["prep", "cache_probe",
                                           "serve_fanout", "verify"]
    assert out[(False, "on")] == out[(True, "on")]
    assert out[(False, "off")] == out[(True, "off")]
    assert out[(False, "off")] == out[(False, "on")][:5]


def test_staged_cache_residual_cap_tightens_and_overflow_voids(
        eight_devices):
    """dev_b_resid: a cap sized to the measured misses keeps the receipts
    equal; a starved cap voids the run through ``ok`` (never a wrong
    answer); every carry equals JAX's."""
    B, n_keys = 2048, 20_000
    sides = [_staged_side(jx, 1, B, n_keys) for jx in (True, False)]
    for s in sides:
        lc = s.e.attach_leaf_cache(slots=2048)
        lc.fill(bits.mix64_np(np.arange(lc.capacity, dtype=np.uint64)
                              ^ np.uint64(SALT)))

    def run(resid):
        got = [_run_staged(s, 1, B, n_keys, "aligned", s.e.leaf_cache, S=1,
                           resid=resid, seal=False)[0] for s in sides]
        assert got[0] == got[1], (resid, got)
        return got[1]

    full = run(B)
    assert full[1] == 1 and full[2] == 3 * B
    resid_per_step = (full[3] - full[6]) // 3
    tight = run(min(B, int(resid_per_step * 1.3)))
    assert tight[1] == 1 and tight[:5] == full[:5]
    void = run(max(1, resid_per_step // 4))
    assert void[1] == 0


def test_staged_cache_requires_aligned_or_pipelined(eight_devices):
    s = _staged_side(False, 1, 512, 4000)
    lc = s.e.attach_leaf_cache(slots=256)
    for fusion in ("chained", "fused"):
        with pytest.raises(ConfigError):
            TP.make_staged_step(s.e, n_keys=4000, theta=0.99, salt=SALT,
                                batch=512, dev_b=512, log2_bins=14,
                                fusion=fusion, leaf_cache=lc)
    with pytest.raises(ConfigError):
        TP.make_staged_step(s.e, n_keys=4000, theta=0.99, salt=SALT,
                            batch=512, dev_b=512, log2_bins=14,
                            leaf_cache=lc, dev_b_resid=513)


def test_phase_profile_attributes_cache_probe(eight_devices):
    """The cached step's phase profile has the probe's own time, and the
    serve's runs on the compacted residual (read-only: the carry after it
    is unchanged)."""
    s = _staged_side(False, 1, 2048, 20_000)
    lc = s.e.attach_leaf_cache(slots=2048)
    lc.fill(bits.mix64_np(np.arange(lc.capacity, dtype=np.uint64)
                          ^ np.uint64(SALT)))
    step, (new_carry, tb, rt, rk) = TP.make_staged_step(
        s.e, n_keys=20_000, theta=0.99, salt=SALT, batch=2048, dev_b=2048,
        log2_bins=16, fusion="pipelined", leaf_cache=lc, dev_b_resid=1024)
    pool0 = s.d.pool.clone()
    out, _ = step.phase_profile(s.d.pool, s.d.counters, tb, rt, rk, reps=1)
    assert set(out) >= {"prep", "cache_probe", "serve_fanout", "verify",
                        "wall_ms", "bubble_ms", "overlap_efficiency"}
    assert step.dev_b_resid == 1024 and step.cache_slots == 2048
    _eq(s.d.pool, pool0)


def test_cache_collector_in_snapshot(eight_devices):
    P = Pair()
    keys, _ = P.load()
    P.attach(slots=512)
    P.both(lambda s: s.e.leaf_cache.fill(keys[:50]), "fill")
    P.both(lambda s: s.e.search(keys[:100]), "search")
    snaps = [m.snapshot() for m in (JOBS, OBS)]
    for snap in snaps:
        assert snap["cache.hits"] == 50 and snap["cache.misses"] == 50
        assert snap["cache.hit_ratio"] == pytest.approx(0.5)
        assert snap["cache.cached_keys"] == 50
    _eq({k: v for k, v in snaps[0].items() if k.startswith("cache.")},
        {k: v for k, v in snaps[1].items() if k.startswith("cache.")})
    P.both(lambda s: s.e.detach_leaf_cache(), "detach")
    assert "cache.hits" not in OBS.snapshot()


def test_fill_eviction_and_window_overflow_accounting(eight_devices):
    P = Pair()
    keys, _ = P.load()
    P.attach(slots=64)
    r1 = P.both(lambda s: s.e.leaf_cache.fill(keys[:32]), "fill 1")
    assert r1["placed"] + r1["failed"] == 32
    ev0 = P.p.e.leaf_cache.evictions
    r2 = P.both(lambda s: s.e.leaf_cache.fill(keys[100:132]), "fill 2")
    assert r2["placed"] > 0
    assert P.p.e.leaf_cache.evictions >= ev0 + r1["placed"]
    r3 = P.both(lambda s: s.e.leaf_cache.fill(keys[:8] + np.uint64(1)),
                "fill 3")
    assert r3["resolved"] == 0
    assert P.p.e.leaf_cache.stats()["cached_keys"] == 0


def test_payload_sidecar_pin_hit_stale_capacity_flush(eight_devices):
    P = Pair()
    keys, vals = P.load(n=500)
    P.attach(slots=64)
    k = [int(x) for x in keys[:4]]
    h = [11, 22, 33, 44]
    sc = lambda fn: P.both(lambda s: fn(s.e.leaf_cache), "sidecar")
    assert sc(lambda c: c.pin_payloads(k, h, [b"a", b"bb", None,
                                              b"dddd"])) == 3
    assert sc(lambda c: c.payload_hits(k, h)) == [b"a", b"bb", None, b"dddd"]
    st = P.p.e.leaf_cache.stats()
    assert st["sidecar_pins"] == 3 and st["sidecar_hits"] == 3
    assert sc(lambda c: c.payload_hits(k[:1], [12])) == [None]
    assert sc(lambda c: c.payload_hits(k[:1], [11])) == [None]
    assert P.p.e.leaf_cache.stats()["sidecar_keys"] == 2
    sc(lambda c: c.pin_payloads(k[:2], h[:2], [b"a", b"bb"]))
    P.both(lambda s: s.e.insert(keys[:1], vals[:1] ^ np.uint64(5)),
           "insert")
    assert sc(lambda c: c.payload_hits(k[:1], h[:1])) == [None]
    assert sc(lambda c: c.payload_hits(k[1:2], h[1:2])) == [b"bb"]
    cap = P.p.e.leaf_cache.capacity
    many = [int(x) for x in keys[100:100 + cap + 8]]
    sc(lambda c: c.pin_payloads(many, [7] * len(many), [b"x"] * len(many)))
    assert P.p.e.leaf_cache.stats()["sidecar_keys"] <= cap
    sc(lambda c: c.flush())
    assert P.p.e.leaf_cache.stats()["sidecar_keys"] == 0
