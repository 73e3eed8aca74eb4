"""Port parity: the multihost service plane (``sherman_tpu_torch/
multihost.py``, the per-host chain namespaces and ``recover_union`` of
``recovery.py``, the cross-host tail of ``replica.py`` and the host knobs of
``config.py``) against the JAX package.

The seven cases of ``tests/test_multihost_plane.py`` that are not perfgate
cases run through both packages (the port has no perfgate): the knobs, the
router and the split/merge front door give equal outcomes; the per-host
chain sequences write equal artifact names (chain ids, which are nonces,
taken out), byte-identical journal segments, and recover through
``recover_union`` to bit-identical pools, receipts, answers and tails.
The cross-package cases recover a directory one package wrote with the
other package's ``recover_union``, both ways.  The JAX side runs as its own
tests run it (``gather_impl="xla"``, the ``eight_devices`` fixture).  Every
comparison is exact.
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch

from sherman_tpu import config as JC
from sherman_tpu import multihost as JMH
from sherman_tpu import recovery as JRC
from sherman_tpu import replica as JRP
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models import validate as JV
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.utils import checkpoint as JCK
from sherman_tpu.utils import journal as JJ
from sherman_tpu_torch import config as C
from sherman_tpu_torch import multihost as MH
from sherman_tpu_torch import recovery as RC
from sherman_tpu_torch import replica as RP
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models import validate as TV
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.utils import checkpoint as CK
from sherman_tpu_torch.utils import journal as J

torch.set_num_threads(1)

U64 = np.uint64


def _pkg(jax_side: bool):
    """One package's module handles for the shared sequences."""
    if jax_side:
        return types.SimpleNamespace(
            jax=True, C=JC, MH=JMH, RC=JRC, RP=JRP, B=JB, V=JV, CK=JCK,
            J=JJ, TreeConfig=JTreeConfig, Tree=JTree, dev={},
            cluster=lambda **kw: JCluster(JDSMConfig(gather_impl="xla",
                                                     **kw)))
    return types.SimpleNamespace(
        jax=False, C=C, MH=MH, RC=RC, RP=RP, B=TB, V=TV, CK=CK, J=J,
        TreeConfig=TreeConfig, Tree=Tree, dev={"device": "cpu"},
        cluster=lambda **kw: Cluster(DSMConfig(device="cpu", **kw)))


PKGS = (_pkg(True), _pkg(False))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("raised", type(e).__name__)


def _eq(a, b, what=""):
    if isinstance(a, (np.ndarray, torch.Tensor)):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(b, a, err_msg=what)
    elif isinstance(a, (tuple, list)):
        assert len(b) == len(a), what
        for x, y in zip(a, b):
            _eq(x, y, what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), (what, a.keys(), b.keys())
        for k in a:
            _eq(a[k], b[k], f"{what}[{k}]")
    else:
        assert b == a, (what, a, b)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


# ---------------------------------------------------------------------------
# Knobs (tests/test_multihost_plane.py:34-69)
# ---------------------------------------------------------------------------

def _knob_outcomes(pkg, monkeypatch):
    out = []
    for off in (None, "", "0", "1", "off", "no", "false", "4", "pod", "-2"):
        if off is None:
            monkeypatch.delenv("SHERMAN_HOSTS", raising=False)
        else:
            monkeypatch.setenv("SHERMAN_HOSTS", off)
        out.append(_outcome(pkg.C.hosts))
    monkeypatch.setenv("SHERMAN_HOSTS", "2")
    for hid in (None, "1", "2", "east"):
        if hid is None:
            monkeypatch.delenv("SHERMAN_HOST_ID", raising=False)
        else:
            monkeypatch.setenv("SHERMAN_HOST_ID", hid)
        out.append(_outcome(pkg.C.host_id))
        out.append(_outcome(pkg.MH.plane_from_env))
    monkeypatch.setenv("SHERMAN_HOSTS", "1")
    monkeypatch.setenv("SHERMAN_HOST_ID", "1")
    out.append(_outcome(pkg.C.host_id))
    return out


def test_hosts_knobs(monkeypatch):
    want = _knob_outcomes(PKGS[0], monkeypatch)
    got = _knob_outcomes(PKGS[1], monkeypatch)
    assert got == want
    assert got[:7] == [("ok", 1)] * 7 and got[7] == ("ok", 4)
    assert got[8] == got[9] == ("raised", "ConfigError")
    assert got[10:14] == [("ok", 0), ("ok", (2, 0)), ("ok", 1),
                          ("ok", (2, 1))]
    assert got[14] == got[16] == got[18] == ("raised", "ConfigError")


# ---------------------------------------------------------------------------
# HostRouter (tests/test_multihost_plane.py:76-105)
# ---------------------------------------------------------------------------

def test_host_router_deterministic_split():
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(1, 1 << 60, 5000, dtype=U64))
    vals = keys ^ U64(0xC0FFEE)
    for hosts in (1, 2, 3, 5):
        a, b = JMH.HostRouter(hosts), MH.HostRouter(hosts)
        own = b.owner(keys)
        assert own.dtype == np.int32
        np.testing.assert_array_equal(own, a.owner(keys))
        _eq(a.split(keys, vals), b.split(keys, vals), f"split {hosts}")
        _eq(a.split(keys), b.split(keys), f"split {hosts} no values")
    r = MH.HostRouter(2)
    own = r.owner(keys)
    counts = np.bincount(own, minlength=2)
    assert counts.min() > 0.35 * keys.size, counts
    back = np.zeros_like(keys)
    for h, idx, k_h, v_h in r.split(keys, vals):
        np.testing.assert_array_equal(r.owner(k_h), h)
        np.testing.assert_array_equal(v_h, k_h ^ U64(0xC0FFEE))
        back[idx] = k_h
    np.testing.assert_array_equal(back, keys)
    assert (MH.HostRouter(1).owner(keys) == 0).all()
    # the adoption overlay: route/adopt/handback as the reference's
    for rt in (JMH.HostRouter(3), MH.HostRouter(3)):
        rt.adopt(0, 2)
        assert rt.route(0) == 2 and rt.route(1) == 1
        rt.handback(0)
        assert rt.overlay == {}
    for bad in ((0, 0), (3, 0), (0, -1)):
        assert _outcome(lambda: MH.HostRouter(3).adopt(*bad)) \
            == _outcome(lambda: JMH.HostRouter(3).adopt(*bad)) \
            == ("raised", "ConfigError")
    assert _outcome(lambda: MH.HostRouter(0)) \
        == _outcome(lambda: JMH.HostRouter(0)) == ("raised", "ConfigError")


# ---------------------------------------------------------------------------
# The front door's split submit and merge (transport-free fakes,
# tests/test_multihost_plane.py:112-227)
# ---------------------------------------------------------------------------

class _FakeFuture:
    def __init__(self, op, keys, values, ranges=None, host=0):
        self.op, self.keys, self.values = op, keys, values
        self.ranges, self.host = ranges, host
        self.deduped = op != "read"

    def done(self):
        return True

    def result(self, timeout=None):
        if self.op == "scan":
            # host h's shard of each range: keys congruent to h mod 2
            out = []
            for lo, hi in self.ranges:
                ks = np.arange(int(lo) + self.host, int(hi), 2, dtype=U64)
                out.append((ks, ks ^ U64(0xAB)))
            return out
        k = np.asarray(self.keys, U64)
        if self.op == "read":
            return k ^ U64(0xAB), (k % U64(3)) != 0
        return np.ones(k.size, bool)


class _FakeServer:
    def __init__(self, host=0, stats=None):
        self.host = host
        self.calls = []
        self._stats = stats or {}

    def submit(self, op, keys=None, values=None, *, tenant="default",
               ranges=None, rid=None, deadline_ms=None):
        self.calls.append((op, None if keys is None
                           else np.asarray(keys, U64), rid))
        return _FakeFuture(op, keys, values, ranges=ranges, host=self.host)

    def stats(self):
        return dict(self._stats)


def _front_door_run(mh):
    rng = np.random.default_rng(11)
    keys = rng.integers(1, 1 << 60, 257, dtype=U64)
    servers = [_FakeServer(0), _FakeServer(1)]
    svc = mh.MultihostService(servers)
    out = [svc.submit("read", keys, rid=42).result(timeout=5)]
    out.append([[(op, k, rid) for op, k, rid in s.calls] for s in servers])
    out.append(svc.submit("insert", keys, keys).result(timeout=5))
    f = svc.submit("insert", keys, keys, rid=7)
    out.append((f.deduped, f.done(), f.n_ops, f.rid))
    fs = svc.submit("scan", ranges=[(10, 20), (100, 105)])
    out.append((fs.result(timeout=5), fs.deduped, fs.n_ranges))
    out.append(svc.submit("delete", keys[:9]).result(timeout=5))
    out.append(_outcome(lambda: svc.submit("scan", ranges=[(10, 20)],
                                           cursor=b"tok")))
    out.append(_outcome(lambda: svc.submit("scan")))
    out.append(_outcome(lambda: mh.MultihostService(
        servers, router=mh.HostRouter(3))))
    out.append(_outcome(lambda: mh.MultihostService([])))
    out.append(_outcome(svc.journal_frontiers))
    lone = _FakeServer()
    f1 = mh.MultihostService([lone]).submit("read", keys[:8])
    out.append((isinstance(f1, _FakeFuture), len(lone.calls)))
    svc.adopt(1, _FakeServer(1), adopter=0)
    out.append((svc.router.overlay, svc.stats()))
    out.append(_outcome(lambda: svc.adopt(2, _FakeServer())))
    return out, keys, svc


def test_multihost_service_split_merge_order():
    want, _, _ = _front_door_run(JMH)
    got, keys, svc = _front_door_run(MH)
    _eq(want, got, "front door")
    vals, found = got[0]
    np.testing.assert_array_equal(vals, keys ^ U64(0xAB))
    np.testing.assert_array_equal(found, (keys % U64(3)) != 0)
    scans, deduped, _ = got[4]
    for (lo, hi), (ks, vs) in zip([(10, 20), (100, 105)], scans):
        np.testing.assert_array_equal(ks, np.arange(lo, hi, dtype=U64))
        np.testing.assert_array_equal(vs, ks ^ U64(0xAB))
    assert not deduped and got[3][0]
    assert got[6:11] == [("raised", "ConfigError")] * 4 \
        + [("raised", "StateError")]
    assert got[11] == (True, 1)
    assert got[12][1]["adoptions"] == 1 and got[12][1]["overlay"] == {"1": 0}


def test_merge_host_stats_one_logical_plane():
    a = {"admitted_ops": 10, "served_ops": 9, "acked_writes": 6,
         "rejects": {"overload": 1, "degraded": 0}, "dispatch_errors": 0,
         "retraces": 1, "controller": {"settled_width": 256},
         "window": {"read": {"ops_s": 100.0, "p50_ms": 1.0,
                             "p99_ms": 5.0, "window_ops": 10,
                             "ops_total": 20}},
         "contract": {"dedup_hits": 2},
         "journal": {"fsyncs": 3, "appends": 6}}
    b = {"admitted_ops": 20, "served_ops": 18, "acked_writes": 4,
         "rejects": {"overload": 0, "degraded": 2}, "dispatch_errors": 1,
         "retraces": 0, "controller": {"cap_width": 1024},
         "window": {"read": {"ops_s": 50.0, "p50_ms": 2.0,
                             "p99_ms": 9.0, "window_ops": 5,
                             "ops_total": 7},
                    "insert": {"ops_s": 5.0, "p99_ms": 3.0}},
         "contract": {"dedup_hits": 1, "cached_rids": 4},
         "journal": {"fsyncs": 2, "appends": 4}}
    for per_host in ([a, b], [b], [a, {}], [{}]):
        assert MH.merge_host_stats(per_host) \
            == JMH.merge_host_stats(per_host)
    m = MH.merge_host_stats([a, b])
    assert m["hosts"] == 2 and m["admitted_ops"] == 30
    assert m["widths"] == [256, 1024]
    assert m["window"]["read"]["p99_ms"] == 9.0
    assert m["journal"] == {"fsyncs": 5, "appends": 10,
                            "acks_per_fsync": 2.0}
    assert _outcome(lambda: MH.merge_host_stats([])) \
        == _outcome(lambda: JMH.merge_host_stats([])) \
        == ("raised", "ConfigError")


# ---------------------------------------------------------------------------
# Per-host chain namespaces (tests/test_multihost_plane.py:234-287)
# ---------------------------------------------------------------------------

def _small(pkg, pages=512, batch=128):
    cluster = pkg.cluster(machine_nr=4, pages_per_node=pages,
                          locks_per_node=256, step_capacity=256,
                          chunk_pages=64)
    tree = pkg.Tree(cluster)
    eng = pkg.B.BatchedEngine(tree, batch_per_node=batch,
                              tcfg=pkg.TreeConfig(sibling_chase_budget=1))
    return cluster, tree, eng


def _load(pkg, tree, eng, keys, salt=0xABCD):
    pkg.B.bulk_load(tree, keys, keys ^ U64(salt))
    eng.attach_router()


def _keyset(n=600, seed=5):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, 1 << 56, int(n * 1.2),
                                  dtype=U64))[:n]


def _names(rdir, cids):
    """The directory's names with each chain id replaced by its role."""
    out = []
    for n in sorted(os.listdir(rdir)):
        for role, cid in cids.items():
            if cid:
                n = n.replace(cid, role)
        out.append(n)
    return sorted(out)


def _legacy_run(pkg, rdir):
    cluster, tree, eng = _small(pkg)
    keys = _keyset(200, seed=3)
    _load(pkg, tree, eng, keys)
    plane = pkg.RC.RecoveryPlane(cluster, tree, eng, rdir)
    out = [plane._htag]
    plane.checkpoint_base()
    eng.insert(keys[:32], keys[:32])
    d = plane.checkpoint_delta()
    out.append((d["pages"], d["rows"] if "rows" in d else None))
    out.append(_names(rdir, {"CID": plane.cid}))
    out.append(open(eng.journal.path, "rb").read())
    foreign = ["base-h1.npz", "delta-h1-deadbeef-000000.npz",
               "journal-h1-deadbeef-000000.wal"]
    for n in foreign:
        open(os.path.join(rdir, n), "wb").write(b"x")
    open(os.path.join(rdir, "delta-0badcafe-000000.npz"), "wb").write(b"x")
    out.append(plane._sweep_stale())
    out.append(_names(rdir, {"CID": plane.cid}))
    plane.close()
    # recover() at hosts=1 (the sweep skips the foreign files): a receipt
    # with no host key
    for n in foreign:
        os.unlink(os.path.join(rdir, n))
    ctx = pkg.RC.RecoveryPlane.recover(
        rdir, batch_per_node=128,
        tcfg=pkg.TreeConfig(sibling_chase_budget=1), **pkg.dev)
    out.append(sorted(ctx[4]["chain"]))
    out.append(_np(ctx[1].dsm.pool))
    ctx[0].close()
    return out


def test_hosts1_legacy_names_and_sweep_skip(eight_devices, tmp_path):
    """hosts=1 writes the legacy un-tagged names and journal bytes, its
    sweep removes only the stale legacy artifact beside a host-tagged
    chain, and its recover receipt carries no host key."""
    runs = [_legacy_run(p, str(tmp_path / ("j" if p.jax else "p")))
            for p in PKGS]
    _eq(runs[0], runs[1], "hosts=1")
    got = runs[1]
    assert got[0] is None
    assert "base.npz" in got[2] and not any("-h" in n for n in got[2])
    assert any(n.startswith("delta-CID-") for n in got[2])
    assert got[4] == 1
    assert {"base-h1.npz", "delta-h1-deadbeef-000000.npz",
            "journal-h1-deadbeef-000000.wal"} <= set(got[5])
    assert "delta-0badcafe-000000.npz" not in got[5]
    assert got[6] == ["cid", "deltas"]


# ---------------------------------------------------------------------------
# Union recovery and the cross-host plane (tests/test_multihost_plane.py:
# 294-416)
# ---------------------------------------------------------------------------

def _write_chains(pkg, rdir, hk, torn=True):
    """Both hosts' chains in one directory: base, pre-delta writes, a
    delta, journal-only writes and deletes; host 0's live tail torn.
    -> ([journal bytes of each host], cids)."""
    jpaths, cids = [], {}
    for h in (0, 1):
        cluster, tree, eng = _small(pkg)
        _load(pkg, tree, eng, hk[h])
        plane = pkg.RC.RecoveryPlane(cluster, tree, eng, rdir,
                                     host_id=h, hosts=2)
        assert plane._htag == h and plane.hosts == 2
        plane.checkpoint_base()
        eng.insert(hk[h][:48], hk[h][:48] ^ U64(0x11))
        assert plane.checkpoint_delta()["pages"] > 0
        eng.insert(hk[h][56:104], hk[h][56:104] ^ U64(0x22))
        assert eng.delete(hk[h][48:56]).all()
        jpaths.append(eng.journal.path)
        cids[f"C{h}"] = plane.cid
        plane.close()
    if torn:
        rec = pkg.J.encode_record(pkg.J.J_UPSERT, np.asarray([12345], U64),
                                  np.asarray([1], U64))
        with open(jpaths[0], "ab") as f:
            f.write(rec[: len(rec) // 2])
    return [open(p, "rb").read() for p in jpaths], cids


def _strip(x, cids):
    if isinstance(x, str):
        for role, c in cids.items():
            if c:
                x = x.replace(c, role)
        return x
    if isinstance(x, dict):
        return {k: (None if k.endswith("_ms") else _strip(v, cids))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_strip(v, cids) for v in x)
    return x


def _union_state(pkg, ctxs, receipt, hk, cids):
    """The recovered union's observables: the receipt (walls and chain ids
    out), each host's answers, pool, locks and counters."""
    out = [_strip(receipt, cids)]
    for h in (0, 1):
        eng = ctxs[h][3]
        out.append([_np(x) for x in eng.search(hk[h])])
        out.append([_np(x) for x in eng.search(np.asarray([12345], U64))])
        d = ctxs[h][1].dsm
        out.append([_np(d.pool), _np(d.locks),
                    _np(d.counters_np() if hasattr(d, "counters_np")
                        else d.counters)])
        pkg.V.check_structure_device(ctxs[h][2])
    return out


def _union_run(pkg, rdir):
    keys = _keyset(420, seed=17)
    own = pkg.MH.HostRouter(2).owner(keys)
    hk = [keys[own == 0], keys[own == 1]]
    out = []
    blobs, cids = _write_chains(pkg, rdir, hk)
    out.append(blobs)
    out.append(_names(rdir, cids))
    ctxs, receipt = pkg.RC.RecoveryPlane.recover_union(
        rdir, hosts=2, batch_per_node=128,
        tcfg=pkg.TreeConfig(sibling_chase_budget=1), **pkg.dev)
    cids.update({f"R{h}": ctxs[h][0].cid for h in (0, 1)})
    out.append(_union_state(pkg, ctxs, receipt, hk, cids))
    out.append(_names(rdir, cids))
    # the host-scoped sweep: host 0 re-bases, host 1's files are untouched
    h1 = {n: open(os.path.join(rdir, n), "rb").read()
          for n in os.listdir(rdir) if "-h1" in n}
    ctxs[0][0].checkpoint_base()
    cids["S0"] = ctxs[0][0].cid
    out.append(_names(rdir, cids))
    assert {n: open(os.path.join(rdir, n), "rb").read()
            for n in os.listdir(rdir) if "-h1" in n} == h1
    _cid, deltas, journals = pkg.RC.RecoveryPlane._discover(rdir, host_id=1)
    out.append([_strip(os.path.basename(p), cids)
                for p in deltas + journals])
    # the cross-host tail: host 0's namespace only
    tailer = pkg.RP.JournalTailer(rdir, ctxs[0][0].cid, host_id=0)
    k0, k1 = hk[0][104:144], hk[1][104:144]
    ctxs[0][3].insert(k0, k0 ^ U64(0x77))
    ctxs[1][3].insert(k1, k1 ^ U64(0x88))
    recs = tailer.poll()
    out.append([[np.asarray(x) if isinstance(x, np.ndarray) else x
                 for x in r] for r in recs])
    group = pkg.RP.ReplicaGroup(ctxs[0][0], 1, cache_slots=1024)
    out.append(group.primary_host)
    ctxs[0][3].insert(k0[:8], k0[:8] ^ U64(0x99))
    group.pump()
    st = group.stats()
    out.append({k: st[k] for k in ("applied_records", "applied_rows",
                                   "rebootstraps")})
    out.append([_np(x) for x in group.followers[0].eng.search(k0)])
    out.append(_np(group.followers[0].cluster.dsm.pool))
    group.close()
    for ctx in ctxs:
        ctx[0].close()
    return out, hk


def test_union_recovery_torn_tail_one_host(eight_devices, tmp_path):
    """The plane's lifecycle on one shared directory through both
    packages: per-host chains with host 0's tail torn, ``recover_union``
    (every acked op on both hosts, the torn record nowhere), host 0's
    re-base sweeping only ``-h0-``, and a tailer and a replica group
    shipping host 0's chain only — every observable equal."""
    (want, _), (got, hk) = [_union_run(p, str(tmp_path / n))
                            for p, n in zip(PKGS, ("j", "p"))]
    _eq(want, got, "union")
    names = got[1]
    for h in (0, 1):
        assert f"base-h{h}.npz" in names
        assert any(n.startswith(f"delta-h{h}-") for n in names)
        assert any(n.startswith(f"journal-h{h}-") for n in names)
    receipt = got[2][0]
    assert receipt["hosts"] == 2 and [c["host"] for c in
                                      receipt["chains"]] == [0, 1]
    assert receipt["replay"]["records"] >= 4
    assert receipt["replay"]["deletes"] >= 2
    for h in (0, 1):
        v, f = got[2][1 + 3 * h]
        assert f[:48].all() and not f[48:56].any() and f[56:].all()
        np.testing.assert_array_equal(v[:48], hk[h][:48] ^ U64(0x11))
        np.testing.assert_array_equal(v[56:104], hk[h][56:104] ^ U64(0x22))
        np.testing.assert_array_equal(v[104:], hk[h][104:] ^ U64(0xABCD))
        assert not got[2][2 + 3 * h][1].any()     # the torn record
    assert not any("-h0-C0-" in n for n in got[4])
    assert got[5] and all("-h1-" in n for n in got[5])
    shipped = np.concatenate([np.asarray(r[1], U64) for r in got[6]])
    assert set(shipped.tolist()) <= set(hk[0][104:144].tolist())
    assert got[7] == 0 and got[8]["applied_records"] > 0
    v, f = got[9]
    assert f.all()
    np.testing.assert_array_equal(v[:8], hk[0][104:112] ^ U64(0x99))


def _missing_run(pkg, rdir):
    keys = _keyset(240, seed=23)
    own = pkg.MH.HostRouter(2).owner(keys)
    for h in (0, 1):
        cluster, tree, eng = _small(pkg)
        kh = keys[own == h]
        _load(pkg, tree, eng, kh)
        plane = pkg.RC.RecoveryPlane(cluster, tree, eng, rdir,
                                     host_id=h, hosts=2)
        plane.checkpoint_base()
        eng.insert(kh[:16], kh[:16] ^ U64(0x1))
        plane.checkpoint_delta()
        eng.insert(kh[16:32], kh[16:32] ^ U64(0x2))
        plane.checkpoint_delta()
        plane.close()
    union = lambda h=2: pkg.RC.RecoveryPlane.recover_union(
        rdir, hosts=h, batch_per_node=128, **pkg.dev)
    _cid, deltas0, _ = pkg.RC.RecoveryPlane._discover(rdir, host_id=0)
    out = [len(deltas0)]
    os.unlink(deltas0[0])
    out.append(_outcome(union))
    os.unlink(os.path.join(rdir, "base-h0.npz"))
    out.append(_outcome(union))
    out.append(_outcome(lambda: union(1)))
    out.append(_outcome(lambda: pkg.RC.RecoveryPlane(
        *_small(pkg), rdir, host_id=2, hosts=2)))
    return out


def test_union_recovery_missing_link_typed(eight_devices, tmp_path):
    """All or typed: a missing delta link or a missing base fails the
    whole union with the reference's error; a one-host directory is
    recover()'s, typed."""
    want, got = [_missing_run(p, str(tmp_path / n))
                 for p, n in zip(PKGS, ("j", "p"))]
    assert got == want
    assert got == [2, ("raised", "CheckpointCorruptError"),
                   ("raised", "FileNotFoundError"),
                   ("raised", "StateError"), ("raised", "StateError")]


# ---------------------------------------------------------------------------
# Each package recovers the other's directory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recover_union_of_the_other_package(eight_devices, tmp_path,
                                            writer):
    """Per-host chains written by one package (host 0's tail torn): the
    other package's ``recover_union`` gives the same receipt, answers and
    pools as the writer's own over a copy of the directory, and its
    re-base leaves the same names."""
    src = PKGS[0] if writer == "jax" else PKGS[1]
    keys = _keyset(420, seed=17)
    own = JMH.HostRouter(2).owner(keys)
    hk = [keys[own == 0], keys[own == 1]]
    rdir = str(tmp_path / "w")
    _blobs, cids = _write_chains(src, rdir, hk)
    copy = str(tmp_path / "c")
    shutil.copytree(rdir, copy)
    states = []
    for pkg, d in zip(PKGS, (rdir, copy) if writer == "jax"
                      else (copy, rdir)):
        ctxs, receipt = pkg.RC.RecoveryPlane.recover_union(
            d, hosts=2, batch_per_node=128,
            tcfg=pkg.TreeConfig(sibling_chase_budget=1), **pkg.dev)
        c = dict(cids, **{f"R{h}": ctxs[h][0].cid for h in (0, 1)})
        states.append((_union_state(pkg, ctxs, receipt, hk, c),
                       _names(d, c)))
        for ctx in ctxs:
            ctx[0].close()
    _eq(states[0], states[1], f"written by {writer}")
    v, f = states[1][0][1]
    assert f[:48].all() and not f[48:56].any()
    assert not any(n.startswith(("delta-h0-C0", "journal-h0-C0"))
                   for n in states[1][1])


# ---------------------------------------------------------------------------
# The smoke's phase 28a sequences, held against the JAX package
# ---------------------------------------------------------------------------

def _smoke():
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def _jax_host_mods():
    from sherman_tpu import chaos as JCH
    from sherman_tpu import hostlease as JHL
    from sherman_tpu import obs as JOBS
    return types.SimpleNamespace(
        Cluster=JCluster,
        cfg=lambda **kw: JDSMConfig(gather_impl="xla", **kw),
        TreeConfig=JTreeConfig, Tree=JTree, batched=JB, obs=JOBS, J=JJ,
        MH=JMH, HL=JHL, CH=JCH, plane=JRC.RecoveryPlane,
        Tailer=JRP.JournalTailer, Group=JRP.ReplicaGroup, dev={})


@pytest.mark.parametrize("seq", ["host_plane_run", "host_fail_run"])
def test_smoke_host_sequence_matches_jax(eight_devices, tmp_path, seq):
    """Phase 28a's sequences (``chip_smoke.host_plane_run``: the routed
    door, per-host deltas, a torn tail, ``recover_union``, the re-base
    sweep and the cross-host tail; ``chip_smoke.host_fail_run``: leases, a
    freeze, detection, the fence point, the adoption, the zombie's suffix
    and the hand-back) through both packages: every result equal (chain
    ids by role)."""
    S = _smoke()
    fn = getattr(S, seq)
    runs = []
    for name, m in (("jax", _jax_host_mods()), ("port", S.host_mods("cpu"))):
        d = tmp_path / name
        d.mkdir()
        runs.append(fn(m, str(d)))
    a, b = runs
    assert [x for x, _ in a] == [x for x, _ in b]
    for (label, x), (_, y) in zip(a, b):
        assert S._same_obj(S._hostify(x) if isinstance(x, list) else x,
                           S._hostify(y) if isinstance(y, list) else y), \
            f"{seq}: {label}: {S._diff(x, y)}"
    got = dict(b)
    if seq == "host_plane_run":
        assert got["retried rid"] is True
        assert got["group"][0] > 0 and got["group"][2] == 0
        assert got["counters"]["multihost.split_submits"] > 0
    else:
        assert got["frozen dispatch"] == ("raised", "HostDownError")
        assert got["detect"][:2] == [[], [0]]
        assert got["fenced suffix"] == 3
        assert got["zombie on heal"] == ("raised", "StaleHostError")
        assert got["register while adopted"] == ("raised",
                                                 "HostAdoptedError")
        assert got["counters"]["hostfail.adoptions"] == 1
