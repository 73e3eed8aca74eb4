"""Port parity: host failover (``sherman_tpu_torch/hostlease.py``, the host
fault layer of ``chaos.py``, the adoption seam of ``multihost.py``) against
the JAX package.

The nine cases of ``tests/test_hostfail.py`` that are not perfgate cases
run through both packages (the port has no perfgate), and so does
``test_adoption_through_routed_door``, marked ``slow`` as in the reference:
the knobs, the lease table's protocol, the renewal seam, the ownership
log's fold, the host chaos grammar and its manual zombie view give equal
outcomes; the zombie's fenced journal is byte-identical with equal suffix
counts; detection, adoption and resume give equal receipts (walls taken
out), ownership logs, lease epochs, answers and pools.  The cross-package
cases read a lease table and an ownership log written by the other
package.  The JAX side runs as its own tests run it (``gather_impl="xla"``,
the ``eight_devices`` fixture).  Every comparison is exact.
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from sherman_tpu import chaos as JCH
from sherman_tpu import config as JC
from sherman_tpu import hostlease as JHL
from sherman_tpu import multihost as JMH
from sherman_tpu import obs as JOBS
from sherman_tpu import recovery as JRC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.utils import journal as JJ
from sherman_tpu_torch import chaos as CH
from sherman_tpu_torch import config as C
from sherman_tpu_torch import hostlease as HL
from sherman_tpu_torch import multihost as MH
from sherman_tpu_torch import obs as OBS
from sherman_tpu_torch import recovery as RC
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.utils import journal as J

torch.set_num_threads(1)

U64 = np.uint64


def _pkg(jax_side: bool):
    if jax_side:
        from sherman_tpu import serve as JSV
        return types.SimpleNamespace(
            jax=True, C=JC, CH=JCH, HL=JHL, MH=JMH, RC=JRC, B=JB, J=JJ,
            obs=JOBS, SV=JSV, TreeConfig=JTreeConfig, Tree=JTree, dev={},
            cluster=lambda **kw: JCluster(JDSMConfig(gather_impl="xla",
                                                     **kw)))
    from sherman_tpu_torch import serve as SV
    return types.SimpleNamespace(
        jax=False, C=C, CH=CH, HL=HL, MH=MH, RC=RC, B=TB, J=J, obs=OBS,
        SV=SV, TreeConfig=TreeConfig, Tree=Tree, dev={"device": "cpu"},
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


def _untimed(rec):
    """A lease record without its timestamp."""
    return None if rec is None else {k: v for k, v in rec.items()
                                     if k != "timestamp"}


def _kinds(pkg):
    return [e["kind"] for e in pkg.obs.get_recorder().events()]


# ---------------------------------------------------------------------------
# Knobs (tests/test_hostfail.py:41-64)
# ---------------------------------------------------------------------------

def _knobs(pkg, monkeypatch):
    out = []
    monkeypatch.delenv("SHERMAN_HOST_LEASE_S", raising=False)
    out.append(_outcome(pkg.C.host_lease_s))
    for v in ("0.25", "0", "-1", "pod"):
        monkeypatch.setenv("SHERMAN_HOST_LEASE_S", v)
        out.append(_outcome(pkg.C.host_lease_s))
    monkeypatch.delenv("SHERMAN_HOST_PROBE_S", raising=False)
    out.append(_outcome(pkg.C.host_probe_s))
    for v in ("", "0", "off", "no", "false", "1.5", "-1", "often"):
        monkeypatch.setenv("SHERMAN_HOST_PROBE_S", v)
        out.append(_outcome(pkg.C.host_probe_s))
    return out


def test_host_lease_knobs(monkeypatch):
    want, got = [_knobs(p, monkeypatch) for p in PKGS]
    assert got == want
    assert got[:2] == [("ok", 2.0), ("ok", 0.25)]
    assert got[2:5] == [("raised", "ConfigError")] * 3
    assert got[5:11] == [("ok", 0.0)] * 6 and got[11] == ("ok", 1.5)
    assert got[12:] == [("raised", "ConfigError")] * 2


# ---------------------------------------------------------------------------
# The lease table (tests/test_hostfail.py:71-158)
# ---------------------------------------------------------------------------

def _lease_run(pkg, root):
    HLm = pkg.HL
    out = [_outcome(lambda: HLm.HostLeaseTable(root, 1))]
    tab = HLm.HostLeaseTable(root, 2, lease_s=0.2)
    out.append((tab.read(0), tab.probe(0)))
    out.append(tab.register(0, hwm=("journal-h0-abc-000001.wal", 128)))
    rec = tab.read(0)
    out.append(_untimed(rec))
    out.append((tab.probe(0), tab.is_live(0, 1), tab.is_live(0, 2)))
    out.append(sorted(os.listdir(root)))
    blob = open(os.path.join(root, "hostlease-h0.rec"), "rb").read()
    out.append(_untimed(json.loads(pkg.J.unframe_blob(blob))))
    out.append((tab.probe(0, now=rec["timestamp"] + 0.1),
                tab.probe(0, now=rec["timestamp"] + 0.3),
                tab.is_live(0, 1)))
    out.append((tab.renew(0, 1), tab.renew(0, 99)))
    out.append(tab.expire(0, adopter=1))
    out.append(_untimed(tab.read(0)))
    out.append((tab.is_live(0, 1), tab.is_live(0, 2), tab.renew(0, 1),
                tab.renew(0, 2), _untimed(tab.read(0))))
    out.append(_outcome(lambda: tab.register(0)))
    out.append((tab.handback(0), _untimed(tab.read(0)), tab.handback(0),
                tab.register(0), tab.renew(0, 2), tab.epochs()))
    out.append((tab.ensure_epoch(0, 3), tab.ensure_epoch(0, 5, adopter=1),
                _untimed(tab.read(0)), tab.handback(0)))
    out.append(_outcome(lambda: tab.handback(1)))
    tab.register(1)
    p1 = os.path.join(root, "hostlease-h1.rec")
    raw = bytearray(open(p1, "rb").read())
    raw[-1] ^= 0xFF
    open(p1, "wb").write(bytes(raw))
    out.append(_outcome(lambda: tab.read(1)))
    snap = pkg.obs.snapshot()
    out.append((snap.get("hostfail.leases_renewed", 0) >= 2,
                snap.get("hostfail.expirations", 0) >= 1))
    return out


def test_host_lease_table_protocol(tmp_path):
    want, got = [_lease_run(p, str(tmp_path / n))
                 for p, n in zip(PKGS, ("j", "p"))]
    _eq(want, got, "lease table")
    assert got[0] == ("raised", "StateError")
    assert got[2] == 1 and got[3] == {
        "host_id": 0, "epoch": 1,
        "hwm": ["journal-h0-abc-000001.wal", 128]}
    assert got[5] == ["hostlease-h0.rec"]
    assert got[7] == ("live", "expired", True)
    assert got[9] == 2 and got[10]["adopter"] == 1
    assert got[12] == ("raised", "HostAdoptedError")
    assert got[13][0] == 3 and got[13][3] == 3 and got[13][5] == {0: 3}
    assert got[15] == ("raised", "StateError")
    assert got[16] == ("raised", "HostLeaseCorruptError")
    assert got[17] == (True, True)


def _renew_run(pkg, root):
    hc = pkg.CH.HostChaos([])
    tab = pkg.HL.HostLeaseTable(root, 2, lease_s=5.0, chaos=hc)
    out = [tab.register(0), tab.renew(0, 1)]
    hc.freeze(0)
    out += [tab.renew(0, 1), tab.renew(1, 1, force=True)]
    hc.revive(0, zombie=True)
    out.append(tab.renew(0, 1))
    hc.heal()
    out.append(tab.renew(0, 1))
    out.append(hc.injected)
    return out


def test_host_lease_chaos_renewal_seam(tmp_path):
    want, got = [_renew_run(p, str(tmp_path / n))
                 for p, n in zip(PKGS, ("j", "p"))]
    assert got == want == [1, True, False, True, False, True, 2]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lease_table_written_by_the_other_package(tmp_path, writer):
    """A lease table one package writes (registers, renewals, an expiry
    with an adopter stamp, a hand-back) reads the same through the other
    package, probe verdicts, liveness and corrupt-record refusal
    included."""
    w, r = (PKGS[0], PKGS[1]) if writer == "jax" else (PKGS[1], PKGS[0])
    root = str(tmp_path / "r")
    tw = w.HL.HostLeaseTable(root, 3, lease_s=60.0)
    tw.register(0, hwm=("journal-h0-abc-000002.wal", 4096))
    tw.register(1)
    tw.register(2)
    tw.renew(1, 1, hwm=("journal-h1-def-000001.wal", 64))
    tw.expire(2, adopter=0)
    tw.handback(2)
    tw.expire(1, adopter=2)
    tr = r.HL.HostLeaseTable(root, 3, lease_s=60.0)
    for h in range(3):
        assert tr.read(h) == tw.read(h)
        assert tr.probe(h) == tw.probe(h) == "live"
        for e in (1, 2, 3):
            assert tr.is_live(h, e) == tw.is_live(h, e)
    assert tr.epochs() == tw.epochs() == {0: 1, 1: 2, 2: 3}
    assert _outcome(lambda: tr.register(1)) \
        == ("raised", "HostAdoptedError")
    # the reader renews the writer's record: the writer reads it back
    assert tr.renew(0, 1, hwm=("journal-h0-abc-000003.wal", 8))
    assert tw.read(0) == tr.read(0) and tw.read(0)["hwm"] == [
        "journal-h0-abc-000003.wal", 8]
    p = os.path.join(root, "hostlease-h2.rec")
    raw = bytearray(open(p, "rb").read())
    raw[3] ^= 0x40
    open(p, "wb").write(bytes(raw))
    assert _outcome(lambda: tr.read(2)) == _outcome(lambda: tw.read(2)) \
        == ("raised", "HostLeaseCorruptError")


# ---------------------------------------------------------------------------
# The ownership log (tests/test_hostfail.py:165-209)
# ---------------------------------------------------------------------------

def _maplog_run(pkg, root):
    log = pkg.HL.OwnershipLog(root)
    out = [log.load()]
    log.append({"version": 1, "dead": 0, "adopter": 1, "epoch": 2,
                "state": "begin",
                "fence": ["journal-h0-x-000001.wal", 512]})
    out.append(log.load())
    log.append({"version": 1, "dead": 0, "adopter": 1, "epoch": 2,
                "state": "done"})
    out.append(log.load())
    log.append({"version": 2, "dead": 0, "adopter": 2, "epoch": 3,
                "state": "begin"})
    log.append({"version": 2, "dead": 0, "adopter": 2, "epoch": 3,
                "state": "done"})
    out.append(log.load()["overlay"])
    good = open(log.path, "rb").read()
    frame = pkg.J.frame_blob(json.dumps({"version": 3, "dead": 1,
                                         "adopter": 0, "epoch": 9,
                                         "state": "begin"}).encode())
    open(log.path, "ab").write(frame[: len(frame) // 2])
    out.append(log.load())
    open(log.path, "wb").write(good)
    log.append({"version": 3, "dead": 1, "adopter": 0, "epoch": 4,
                "state": "begin"})
    out.append(log.load()["pending"])
    log.append({"version": 3, "dead": 1, "adopter": 0, "epoch": 4,
                "state": "done"})
    log.append({"version": 4, "dead": 0, "adopter": 2, "epoch": 4,
                "state": "handback"})
    out.append(log.load())
    out.append(open(log.path, "rb").read())
    return out


def test_ownership_log_fold_and_torn_tail(tmp_path):
    for n in ("j", "p"):
        os.makedirs(str(tmp_path / n))
    want, got = [_maplog_run(p, str(tmp_path / n))
                 for p, n in zip(PKGS, ("j", "p"))]
    _eq(want, got, "ownership log")
    assert got[0] == {"version": 0, "overlay": {}, "pending": [],
                      "records": []}
    assert got[1]["pending"] == [(0, 1, 2, ["journal-h0-x-000001.wal", 512])]
    assert got[2]["overlay"] == {0: 1} and got[2]["pending"] == []
    assert got[3] == {0: 2}
    assert got[4]["overlay"] == {0: 2} and got[4]["version"] == 2
    assert got[5] == [(1, 0, 4, None)]
    assert got[6]["overlay"] == {1: 0} and got[6]["version"] == 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ownership_log_written_by_the_other_package(tmp_path, writer):
    """An ownership log one package appends (adoptions begun, done,
    handed back, a torn trailing frame) folds the same in the other, and
    the reader's appends extend it for the writer."""
    w, r = (PKGS[0], PKGS[1]) if writer == "jax" else (PKGS[1], PKGS[0])
    root = str(tmp_path)
    lw = w.HL.OwnershipLog(root)
    for rec in ({"version": 1, "dead": 0, "adopter": 1, "epoch": 2,
                 "state": "begin", "fence": ["journal-h0-a-000002.wal", 77]},
                {"version": 1, "dead": 0, "adopter": 1, "epoch": 2,
                 "state": "done"},
                {"version": 2, "dead": 2, "adopter": 1, "epoch": 5,
                 "state": "begin", "fence": None},
                {"version": 3, "dead": 0, "adopter": 1, "epoch": 3,
                 "state": "handback"}):
        lw.append(rec)
    frame = w.J.frame_blob(b'{"version": 4, "dead": 1}')
    open(lw.path, "ab").write(frame[:5])
    lr = r.HL.OwnershipLog(root)
    assert lr.path == lw.path
    assert lr.load() == lw.load()
    assert lr.load()["pending"] == [(2, 1, 5, None)]
    lr.append({"version": 4, "dead": 2, "adopter": 1, "epoch": 5,
               "state": "done"})
    # the torn frame is a crashed append: the reader's frame lands after
    # it, and both packages fold the log identically (the journal's rule)
    assert lw.load() == lr.load()


# ---------------------------------------------------------------------------
# Host chaos (tests/test_hostfail.py:216-289)
# ---------------------------------------------------------------------------

def _grammar_run(pkg):
    out = [_outcome(lambda: pkg.CH.HostFault(kind="host_melt")),
           _outcome(lambda: pkg.CH.HostFault(kind="host_crash", span=0)),
           _outcome(lambda: pkg.CH.HostFault(kind="host_crash", host=-1))]
    plan = pkg.CH.FaultPlan([
        {"kind": "torn_page", "step": 1},
        {"kind": "repl_drop", "poll": 0},
        {"kind": "host_freeze", "host": 1, "at": 2, "span": 2},
    ])
    out.append((len(plan.faults), len(plan.repl_faults),
                len(plan.host_faults)))
    hc = plan.host_layer()
    out.append((hc is plan.host_layer(), plan.describe()))
    seq = [hc.on_dispatch(1), hc.tick(), hc.on_dispatch(1), hc.tick(),
           hc.on_dispatch(0), hc.on_dispatch(1), hc.tick(),
           hc.allow_renew(1), hc.on_dispatch(1), hc.tick(),
           hc.on_dispatch(1), hc.allow_renew(1), hc.exhausted,
           hc.injected, hc.describe()]
    out.append(seq)
    out.append(pkg.CH.FaultPlan([{"kind": "torn_page"}]).host_layer())
    spec = ('[{"kind": "wedge_lock", "step": 1, "addr": 5},'
            ' {"kind": "host_zombie", "host": 0, "at": 3},'
            ' {"kind": "host_crash", "host": 2, "span": 4}]')
    p2 = pkg.CH.FaultPlan.parse(spec)
    out.append((len(p2.faults), p2.describe()))
    for kind in ("host_crash", "host_freeze", "host_zombie"):
        out.append(_outcome(lambda k=kind: pkg.CH.Fault(kind=k)))
        out.append(_outcome(lambda k=kind: pkg.CH.ReplFault(kind=k)))
    return out


def test_host_chaos_grammar_and_layers():
    """``host_*`` kinds parse as the reference's: the host layer built
    once, its dispatch clock ticking once a dispatch, a data-plane or
    replication fault of a host kind refused typed."""
    snaps = [p.obs.snapshot() for p in PKGS]
    want, got = [_grammar_run(p) for p in PKGS]
    _eq(want, got, "host chaos grammar")
    assert got[:3] == [("raised", "ConfigError")] * 3
    assert got[3] == (1, 1, 1) and got[4][0]
    seq = got[5]
    assert seq[0] is None and seq[2] is None and seq[4] is None
    assert seq[5] == seq[8] == {"down": True, "state": "freeze"}
    assert seq[7] is False and seq[10] is None and seq[11] and seq[12]
    assert got[6] is None
    assert got[8:] == [("raised", "ConfigError")] * 6
    deltas = [p.obs.delta(s, p.obs.snapshot()) for p, s in zip(PKGS, snaps)]
    for k in ("chaos.host_faults_injected", "chaos.host_freeze"):
        assert deltas[1].get(k) == deltas[0].get(k) == 1


def _manual_run(pkg):
    hc = pkg.CH.HostChaos([])
    rec1 = {"host_id": 0, "epoch": 1, "timestamp": 1.0}
    rec2 = {"host_id": 0, "epoch": 2, "timestamp": 2.0}
    out = [hc.lease_view(0, rec1) is rec1]
    hc.crash(0)
    out += [hc.on_dispatch(0), hc.on_dispatch(1), hc.allow_renew(0)]
    hc.revive(0, zombie=True)
    out += [hc.on_dispatch(0), hc.lease_view(0, rec1),
            hc.lease_view(0, rec2), hc.allow_renew(0), hc.exhausted]
    hc.heal()
    out += [hc.lease_view(0, rec2) is rec2, hc.on_dispatch(0),
            hc.exhausted]
    hc.freeze(1)
    out.append(hc.lease_view(1, rec1))
    hc.revive(1, zombie=False)
    out += [hc.lease_view(1, rec2) is rec2, hc.injected, hc._clock]
    return out


def test_host_chaos_manual_and_zombie_view():
    want, got = [_manual_run(p) for p in PKGS]
    assert got == want
    assert got[1] == {"down": True, "state": "crash"} and got[2] is None
    assert got[4] == {"down": False, "state": "zombie"}
    assert got[5] == got[6] == {"host_id": 0, "epoch": 1, "timestamp": 1.0}
    assert got[9] and got[10] is None and got[11]
    assert got[13] and got[14] == 3


# ---------------------------------------------------------------------------
# The host fence (tests/test_hostfail.py:296-379)
# ---------------------------------------------------------------------------

def _small(pkg, pages=512, batch=128):
    cluster = pkg.cluster(machine_nr=4, pages_per_node=pages,
                          locks_per_node=256, step_capacity=256,
                          chunk_pages=64)
    tree = pkg.Tree(cluster)
    eng = pkg.B.BatchedEngine(tree, batch_per_node=batch,
                              tcfg=pkg.TreeConfig(sibling_chase_budget=1))
    return cluster, tree, eng


def _keyset(n=600, seed=5):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, 1 << 56, int(n * 1.2),
                                  dtype=U64))[:n]


def _fence_run(pkg, root):
    cluster, tree, eng = _small(pkg)
    keys = _keyset(160, seed=3)
    pkg.B.bulk_load(tree, keys, keys ^ U64(0xABCD))
    eng.attach_router()
    plane = pkg.RC.RecoveryPlane(cluster, tree, eng, root, host_id=0,
                                 hosts=2)
    plane.checkpoint_base()
    hc = pkg.CH.HostChaos([])
    tab = pkg.HL.HostLeaseTable(root, 2, lease_s=60.0, chaos=hc)
    epoch = tab.register(0)
    snap0 = pkg.obs.snapshot()
    fence = pkg.HL.HostFence(tab, 0, epoch)
    fence.install(eng)
    k = np.asarray([keys[0]], U64)
    v = np.asarray([1], U64)
    eng.journal.append(pkg.J.J_UPSERT, k, v)
    plane._rotate_journal(2)
    eng.journal.append(pkg.J.J_UPSERT, k, v)
    hc.freeze(0)
    eng.journal.append(pkg.J.J_UPSERT, k, v)
    inner = getattr(eng.journal, "_inner", eng.journal)
    fence_pt = (inner.path, os.path.getsize(inner.path))
    out = [epoch, tab.expire(0, adopter=1)]
    hc.revive(0, zombie=True)
    eng.journal.append(pkg.J.J_UPSERT, k, np.asarray([2], U64))
    eng.journal.append(pkg.J.J_UPSERT, k, np.asarray([3], U64))
    out.append(pkg.HL.count_fenced_suffix(fence_pt))
    with open(inner.path, "ab") as f:
        rec = pkg.J.encode_record(pkg.J.J_UPSERT, k, v)
        f.write(rec[: len(rec) // 2])
    out.append(pkg.HL.count_fenced_suffix(fence_pt))
    hc.heal()
    out.append(_outcome(lambda: eng.journal.append(pkg.J.J_UPSERT, k, v)))
    out.append(_outcome(lambda: eng.journal.append_acks(
        [(7, "t", 1, True)])))
    out.append(fence.fenced)
    d = pkg.obs.delta(snap0, pkg.obs.snapshot())
    out.append(d.get("hostfail.fenced_host_acks", 0))
    out.append("host.zombie_fenced" in _kinds(pkg))
    out.append(pkg.HL.count_fenced_suffix(None))
    out.append(pkg.HL.count_fenced_suffix((inner.path + ".gone", 0)))
    out.append(open(inner.path, "rb").read())
    out.append(fence_pt[1])
    plane.close()
    return out


def test_host_fence_zombie_suffix(eight_devices, tmp_path):
    """The zombie arc at the journal gate through both packages: the
    fenced journal byte-identical, the suffix counts, the typed refusals
    and the fence counters equal."""
    want, got = [_fence_run(p, str(tmp_path / n))
                 for p, n in zip(PKGS, ("j", "p"))]
    _eq(want, got, "host fence")
    assert got[:4] == [1, 2, 2, 2]
    assert got[4] == got[5] == ("raised", "StaleHostError")
    assert got[6] == 2 and got[7] == 2 and got[8]
    assert got[9] == got[10] == 0


# ---------------------------------------------------------------------------
# Detection, adoption and resume (tests/test_hostfail.py:386-510)
# ---------------------------------------------------------------------------

def _seed_host_chain(pkg, root, host_id, keys, rids=()):
    cluster, tree, eng = _small(pkg)
    pkg.B.bulk_load(tree, keys, keys ^ U64(0xABCD))
    eng.attach_router()
    plane = pkg.RC.RecoveryPlane(cluster, tree, eng, root,
                                 host_id=host_id, hosts=2)
    plane.checkpoint_base()
    eng.insert(keys[:24], keys[:24] ^ U64(0x11))
    for rid in rids:
        eng.journal.append_acks([(rid, "default", 1, True)])
    path = eng.journal.path
    cid = plane.cid
    plane.close()
    return path, cid


def _receipt(r, cids):
    """An adoption receipt without its walls, contexts and chain ids."""
    out = {k: v for k, v in r.items()
           if k not in ("adoption_ms", "context", "server", "recover")}
    if out["fence"] is not None:
        seg = out["fence"]["segment"]
        for role, c in cids.items():
            seg = seg.replace(c, role)
        out["fence"] = dict(out["fence"], segment=seg)
    rec = r["recover"]
    out["recover"] = {"chain": {k: v for k, v in rec["chain"].items()
                                if k != "cid"},
                      "replay": rec["replay"]}
    return out


def _adopt_run(pkg, root):
    keys = _keyset(300, seed=11)
    own = pkg.MH.HostRouter(2).owner(keys)
    hk = [keys[own == 0], keys[own == 1]]
    jpath0, cid0 = _seed_host_chain(pkg, root, 0, hk[0], rids=(41, 42))
    _jp1, cid1 = _seed_host_chain(pkg, root, 1, hk[1])
    cids = {"C0": cid0, "C1": cid1}
    tab = pkg.HL.HostLeaseTable(root, 2, lease_s=0.15)
    tab.register(0)
    tab.register(1)
    snap0 = pkg.obs.snapshot()
    fo = pkg.HL.HostFailover(root, tab, 2, recover_kw=dict(
        batch_per_node=128, tcfg=pkg.TreeConfig(sibling_chase_budget=1),
        **pkg.dev))
    out = [fo.detect(), fo.unadopted_dead_hosts()]
    deadline = time.time() + 5.0
    while fo.detect() != [0] and time.time() < deadline:
        tab.renew(1, 1)
        time.sleep(0.03)
    out += [fo.detect(), fo.unadopted_dead_hosts(),
            "host.lease_expired" in _kinds(pkg)]
    rec = pkg.J.encode_record(pkg.J.J_UPSERT, np.asarray([12345], U64),
                              np.asarray([1], U64))
    open(jpath0, "ab").write(rec[: len(rec) // 2])
    out.append(fo.fence_point(0)[1])
    r = fo.adopt(0, 1)
    out.append(_receipt(r, cids))
    plane0, cl0, _tr0, eng0 = r["context"]
    out.append([_np(x) for x in eng0.search(hk[0])])
    out.append(_np(eng0.search(np.asarray([12345], U64))[1]))
    out.append(sorted(plane0.dedup_window))
    st = fo.log.load()
    out.append({k: st[k] for k in ("version", "overlay", "pending")})
    out.append([dict(x, fence=None if x.get("fence") is None
                     else [x["fence"][0].replace(cid0, "C0"),
                           x["fence"][1]])
                for x in st["records"]])
    out.append(tab.epochs())
    tab.renew(1, 1)
    out.append(fo.unadopted_dead_hosts())
    kinds = _kinds(pkg)
    out.append(("host.adopt_begin" in kinds, "host.adopt_done" in kinds))
    out.append(_np(cl0.dsm.pool))
    # the adopter crashed mid-adoption of host 1, before the epoch bump
    tab2 = pkg.HL.HostLeaseTable(root, 2, lease_s=60.0)
    fo2 = pkg.HL.HostFailover(root, tab2, 2, recover_kw=fo.recover_kw)
    e_old = int(tab2.read(1)["epoch"])
    fo2.log.append({"version": st["version"] + 1, "dead": 1,
                    "adopter": 0, "epoch": e_old + 1, "state": "begin",
                    "fence": None})
    out.append(fo2.log.load()["pending"])
    done = fo2.resume()
    out.append([_receipt(d, cids) for d in done])
    out.append((int(tab2.read(1)["epoch"]), tab2.read(1)["adopter"],
                tab2.renew(1, e_old), tab2.ensure_epoch(1, e_old + 1)))
    st2 = fo2.log.load()
    out.append({k: st2[k] for k in ("version", "overlay", "pending")})
    eng1 = done[0]["context"][-1]
    out.append([_np(x) for x in eng1.search(hk[1])])
    out.append(_np(done[0]["context"][1].dsm.pool))
    d = pkg.obs.delta(snap0, pkg.obs.snapshot())
    out.append({k: d.get(k, 0) for k in ("hostfail.adoptions",
                                         "hostfail.expirations")})
    plane0.close()
    done[0]["context"][0].close()
    return out, hk


def test_host_failover_detect_adopt_resume(eight_devices, tmp_path):
    """Detection by lease expiry, the adoption of a dead host's chain (its
    torn tail cut, its window in the plane), the durable ownership map,
    and the resume of an adoption whose adopter crashed before the epoch
    bump, through both packages: receipts, logs, epochs, answers and
    pools equal."""
    (want, _), (got, hk) = [_adopt_run(p, str(tmp_path / n))
                            for p, n in zip(PKGS, ("j", "p"))]
    _eq(want, got, "adopt")
    assert got[:2] == [[], 0] and got[2:5] == [[0], 1, True]
    r = got[6]
    assert r["dead"] == 0 and r["adopter"] == 1 and r["epoch"] == 2
    assert r["fence"] is not None and r["fence"]["size"] == got[5]
    v, f = got[7]
    assert f[:24].all()
    np.testing.assert_array_equal(v[:24], hk[0][:24] ^ U64(0x11))
    assert not got[8].any()
    assert ("default", 41) in got[9]
    assert got[10]["overlay"] == {0: 1} and got[10]["pending"] == []
    assert got[12][0] == 2 and got[13] == 0 and got[14] == (True, True)
    assert len(got[17]) == 1 and got[17][0]["dead"] == 1
    assert got[17][0]["fence"] is None
    assert got[18][0] == got[18][3] and got[18][1] == 0 \
        and got[18][2] is False
    assert got[19]["overlay"] == {0: 1, 1: 0}
    assert got[20][1][:24].all()
    assert got[22]["hostfail.adoptions"] == 2


def _handback_run(pkg, root):
    tab = pkg.HL.HostLeaseTable(root, 2, lease_s=60.0)
    tab.register(0)
    tab.register(1)
    fo = pkg.HL.HostFailover(root, tab, 2)
    fo.log.append({"version": 1, "dead": 0, "adopter": 1, "epoch": 2,
                   "state": "begin", "fence": None})
    tab.expire(0, adopter=1)
    fo.log.append({"version": 1, "dead": 0, "adopter": 1, "epoch": 2,
                   "state": "done"})
    router = pkg.MH.HostRouter(2)
    router.adopt(0, 1)
    out = [_outcome(lambda: tab.register(0))]
    out.append(fo.handback(0, router=router))
    out += [router.overlay, fo.log.load()["overlay"], tab.register(0),
            tab.renew(0, 3), tab.renew(0, 2),
            "host.handback" in _kinds(pkg)]
    out.append(_outcome(lambda: fo.handback(1)))
    tab.expire(0, adopter=1)
    out += [fo.handback(0), "adopter" in tab.read(0), tab.register(0)]
    out.append(fo.log.load()["records"])
    return out


def test_host_register_refused_while_adopted_and_handback(tmp_path):
    want, got = [_handback_run(p, str(tmp_path / n))
                 for p, n in zip(PKGS, ("j", "p"))]
    _eq(want, got, "handback")
    assert got[:8] == [("raised", "HostAdoptedError"), 3, {}, {}, 3, True,
                       False, True]
    assert got[8] == ("raised", "StateError")
    assert got[9:12] == [5, False, 5]


# ---------------------------------------------------------------------------
# The routed front door under host loss (tests/test_hostfail.py:516-630)
# ---------------------------------------------------------------------------

def _front_door(pkg, eng, host_id, calib):
    cfg = pkg.SV.ServeConfig(widths=(128, 512),
                             p99_targets_ms={c: 1e9 for c in
                                             ("read", "scan", "insert",
                                              "delete")},
                             write_linger_ms=0.5)
    srv = pkg.SV.ShermanServer(eng, cfg, host_id=host_id)
    ck = calib[:64]
    cv, cf = eng.search(ck)
    srv.start(calib_keys=calib,
              calib_writes=(ck[cf], np.asarray(cv)[cf]),
              calib_delete_keys=np.asarray([1 << 60], U64))
    return srv


def _routed_run(pkg, root):
    keys = _keyset(360, seed=29)
    router = pkg.MH.HostRouter(2)
    own = router.owner(keys)
    hk = [keys[own == 0], keys[own == 1]]
    hc = pkg.CH.HostChaos([])
    tab = pkg.HL.HostLeaseTable(root, 2, lease_s=0.2, chaos=hc)
    tcfg = pkg.TreeConfig(sibling_chase_budget=1)
    hosts = []
    out = []
    r = None
    try:
        for h in (0, 1):
            cluster, tree, eng = _small(pkg)
            pkg.B.bulk_load(tree, hk[h], hk[h] ^ U64(0xABCD))
            eng.attach_router()
            plane = pkg.RC.RecoveryPlane(cluster, tree, eng, root,
                                         host_id=h, hosts=2)
            plane.checkpoint_base()
            epoch = tab.register(h)
            pkg.HL.HostFence(tab, h, epoch).install(eng)
            srv = _front_door(pkg, eng, h, hk[h])
            hosts.append((cluster, tree, eng, plane, srv))
        svc = pkg.MH.MultihostService([x[4] for x in hosts], router,
                                      planes=[x[3] for x in hosts])
        svc.attach_chaos(hc)
        wk = keys[:64]
        wv = wk ^ U64(0x5151)
        out.append(svc.submit("insert", wk, wv, rid=7001).result(timeout=30))
        lo, hi = int(keys.min()), int(keys[:80].max()) + 1
        out.append(svc.submit("scan", ranges=[(lo, hi)]).result(timeout=30))
        hc.freeze(0)
        out.append(_outcome(lambda: svc.submit("read", wk)))
        out.append(_outcome(lambda: svc.submit("scan", ranges=[(lo, hi)])))
        fo = pkg.HL.HostFailover(root, tab, 2, recover_kw=dict(
            batch_per_node=128, tcfg=tcfg, **pkg.dev))
        deadline = time.time() + 5.0
        while fo.detect() != [0] and time.time() < deadline:
            tab.renew(1, tab.read(1)["epoch"])
            time.sleep(0.03)
        out.append(fo.detect())

        def door(plane, cluster, tree, eng):
            return _front_door(pkg, eng, 1, hk[0])

        r = fo.adopt(0, 1, door_factory=door, service=svc)
        out.append((r["seeded"], svc.router.overlay,
                    svc.router.owner(hk[0][:4]).tolist()))
        hc.heal(0)
        out.append(svc.submit("read", wk).result(timeout=30))
        f = svc.submit("insert", wk, wv, rid=7001)
        out.append((f.result(timeout=30), f.deduped))
        nk = keys[64:96]
        out.append(svc.submit("insert", nk, nk, rid=7002).result(timeout=30))
        out.append(svc.submit("scan", ranges=[(lo, hi)]).result(timeout=30))
        st = svc.stats()
        out.append((st["adoptions"], st["overlay"]))
        out.append(_np(r["context"][1].dsm.pool))
    finally:
        if r is not None and r["server"] is not None:
            r["server"].stop()
        for _cl, _tr, _en, pl, srv in hosts:
            try:
                srv.kill()
            except Exception:  # noqa: BLE001 — the frozen door may be dead
                pass
            pl.close()
        if r is not None:
            r["context"][0].close()
    return out, keys


@pytest.mark.slow
def test_adoption_through_routed_door(eight_devices, tmp_path):
    """Freeze, expire, adopt, serve, through both packages: the dead
    host's keys served through the adopter, a retried rid re-acked from
    the seeded window, fan-out scans before and after — equal results and
    the adopted pool bit-identical."""
    (want, _), (got, keys) = [_routed_run(p, str(tmp_path / n))
                              for p, n in zip(PKGS, ("j", "p"))]
    _eq(want, got, "routed door")
    assert got[0].all()
    assert got[2] == got[3] == ("raised", "HostDownError")
    assert got[4] == [0]
    assert got[5][0] > 0 and got[5][1] == {0: 1} and got[5][2] == [0] * 4
    np.testing.assert_array_equal(got[6][0], keys[:64] ^ U64(0x5151))
    assert got[7][0].all() and got[7][1]
    assert got[10] == (1, {"0": 1})
    np.testing.assert_array_equal(got[9][0][0], got[1][0][0])
