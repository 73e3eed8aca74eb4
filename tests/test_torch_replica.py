"""Port parity: the replication plane (``sherman_tpu_torch/replica.py``:
the journal tailer, followers, the replica group's fence, quorum waits and
promotion, anti-entropy) against the JAX package, case by case after
tests/test_replica.py, at one node and at eight where the JAX test takes
the ``eight_devices`` fixture.

Both packages run one sequence from the same seeded keys.  Their journal
segments are byte-identical, so the followers must end with equal pools,
watermarks (link, seq), exactly-once windows, tailer positions and rolling
CRCs, ``repl.`` counters, promotion receipts and fenced-suffix counts.
Chain ids are random nonces and are compared by role (each watermark names
its own plane's chain); wall times (``promote_ms``, ``quorum_wait_ms``,
``waited_ms``, ``catchup_ms``) by presence.  This file holds the knobs,
shipping, the tailer's contract, promotion and fencing, replica reads and
ack provenance; tests/test_torch_replica_partition.py the partition plane
and the cross-package tail.  The JAX side runs as its own tests run it
(``gather_impl="xla"``).
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from sherman_tpu import chaos as JCH
from sherman_tpu import config as JC
from sherman_tpu import recovery as JRC
from sherman_tpu import replica as JRP
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.utils import journal as JJ
from sherman_tpu_torch import chaos as CH
from sherman_tpu_torch import config as C
from sherman_tpu_torch import recovery as RC
from sherman_tpu_torch import replica as RP
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.utils import journal as J

torch.set_num_threads(1)

SALT = 0xAB5E_11E5
NODES = [1, 8]
WALL = ("promote_ms", "quorum_wait_ms", "waited_ms", "catchup_ms")


class Side:
    """One package's primary (tests/test_replica.py's ``make``/``load``)
    and its module handles."""

    def __init__(self, jax_side: bool, n: int = 1, heap_pages: int = 0):
        self.jax = jax_side
        self.B, self.RC, self.RP, self.J, self.CH = (
            (JB, JRC, JRP, JJ, JCH) if jax_side else (TB, RC, RP, J, CH))
        kw = dict(machine_nr=n, pages_per_node=1024 if n == 1 else 256,
                  locks_per_node=256, step_capacity=512, chunk_pages=32,
                  heap_pages_per_node=heap_pages)
        self.cluster = (JCluster(JDSMConfig(gather_impl="xla", **kw))
                        if jax_side else Cluster(DSMConfig(device="cpu",
                                                           **kw)))
        self.tree = (JTree if jax_side else Tree)(self.cluster)
        self.tcfg = (JTreeConfig if jax_side else TreeConfig)(
            sibling_chase_budget=1)
        self.eng = self.B.BatchedEngine(self.tree, batch_per_node=128,
                                        tcfg=self.tcfg)
        self.plane = None

    def load(self, n=500, seed=5):
        rng = np.random.default_rng(seed)
        keys = np.unique(rng.integers(1, 1 << 56, int(n * 1.2),
                                      dtype=np.uint64))[:n]
        vals = keys ^ np.uint64(SALT)
        self.B.bulk_load(self.tree, keys, vals)
        self.eng.attach_router()
        return keys, vals

    def primary(self, d, n=500):
        keys, vals = self.load(n=n)
        self.plane = self.RC.RecoveryPlane(self.cluster, self.tree,
                                           self.eng, str(d / "chain"))
        self.plane.checkpoint_base()
        return keys, vals


def npool(side_jax, cluster) -> np.ndarray:
    p = cluster.dsm.pool
    return np.array(p) if side_jax else p.numpy().copy()


def _norm(x, cids):
    """Chain ids out of names: every cid of ``cids`` becomes CID."""
    if isinstance(x, str):
        for c in cids:
            if c:
                x = x.replace(c, "CID")
        return x
    if isinstance(x, dict):
        return {k: (None if k in WALL and v is not None else
                    _norm(v, cids)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v, cids) for v in x)
    return x


def follower_state(s, f) -> dict:
    """A follower's observables: pool, watermark file, window, tail."""
    wm = json.load(open(os.path.join(f.dir, "watermark.json")))
    assert wm["cid"] == f.cid
    t = f.tailer
    return {
        "pool": npool(s.jax, f.cluster),
        "watermark": (wm["link"], wm["seq"]),
        "mark": (f.link, f.seq, f.rebootstraps, f.caught_up,
                 f.quarantined, f.chaos_detected),
        "window": {k: tuple(np.asarray(x) for x in v)
                   for k, v in f.window.items()},
        "stats": dict(f.stats),
        "tail": (None if t._cur is None else os.path.basename(t._cur)
                 .replace(f.cid, "CID"), t._off, t.seg_crc, t.torn_waits,
                 t.stalls),
    }


def group_state(s, g) -> dict:
    st = dict(g.stats())
    st.pop("quorum_wait_ms")
    return {"stats": st,
            "followers": [follower_state(s, f) for f in g.followers]}


def same(a, b, what=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            (what, sorted(a), sorted(b))
        for k in a:
            same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), (what, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=what)
    else:
        assert a == b, (what, a, b)


def both(fn, tmp_path, n=1, **kw):
    """Run ``fn(side, dir)`` on each package -> (JAX's, the port's)."""
    out = []
    for jax_side in (True, False):
        d = tmp_path / ("jax" if jax_side else "port")
        d.mkdir()
        out.append(fn(Side(jax_side, n=n, **kw), d))
    return out


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the type is the outcome
        return ("raised", type(e).__name__)


# ---------------------------------------------------------------------------
# Knobs and the off default.
# ---------------------------------------------------------------------------

def test_replica_knobs(monkeypatch):
    for name, knob in (("SHERMAN_REPL", "replica_count"),
                       ("SHERMAN_REPL_POLL_MS", "replica_poll_ms")):
        monkeypatch.delenv(name, raising=False)
        assert getattr(C, knob)() == getattr(JC, knob)()
        for v in ("", "0", "false", "off", "no", "1", "true", "on", "yes",
                  "3", "5.5", "lots", "-1"):
            monkeypatch.setenv(name, v)
            assert outcome(getattr(C, knob)) \
                == outcome(getattr(JC, knob)), (name, v)
    monkeypatch.delenv("SHERMAN_REPL", raising=False)
    assert C.replica_count() == 0


def _off(s, d, monkeypatch):
    monkeypatch.delenv("SHERMAN_REPL", raising=False)
    s.primary(d, n=200)
    out = [s.RP.ReplicaGroup.from_env(s.plane) is None,
           type(s.eng.journal) is s.J.Journal,
           outcome(lambda: s.RP.ReplicaGroup(s.plane))]
    s.plane.close()
    s2 = Side(s.jax, n=s.cluster.cfg.machine_nr)
    s2.load(n=200)
    p2 = s.RC.RecoveryPlane(s2.cluster, s2.tree, s2.eng, str(d / "c2"))
    out.append(outcome(lambda: s.RP.ReplicaGroup(p2, 1)))
    p2.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_replica_off_by_default(eight_devices, tmp_path, monkeypatch, n):
    j, p = both(lambda s, d: _off(s, d, monkeypatch), tmp_path, n=n)
    assert p == j == [True, True, ("raised", "ConfigError"),
                      ("raised", "StateError")]


def _bit_identity(s, d):
    pools = []
    for with_group in (False, True):
        side = Side(s.jax, n=s.cluster.cfg.machine_nr)
        (d / str(with_group)).mkdir()
        keys, vals = side.primary(d / str(with_group), n=300)
        group = side.RP.ReplicaGroup(side.plane, 1) if with_group else None
        side.eng.insert(keys[:64], vals[:64] ^ np.uint64(0x77))
        side.eng.delete(keys[64:80])
        if group is not None:
            assert group.pump() > 0
            gv, gf = group.followers[0].eng.search(keys[:64])
            assert gf.all()
            np.testing.assert_array_equal(gv, vals[:64] ^ np.uint64(0x77))
            fstate = group_state(side, group)
            group.close()
        pools.append(npool(side.jax, side.cluster))
        side.plane.close()
    np.testing.assert_array_equal(pools[0], pools[1])
    return pools[0], fstate


@pytest.mark.parametrize("n", NODES)
def test_replica_on_primary_bit_identity(eight_devices, tmp_path, n):
    """A tailing group leaves the primary's pool bit-identical to a build
    without it, in both packages, and the pools and followers agree."""
    j, p = both(_bit_identity, tmp_path, n=n)
    same(j, p)


# ---------------------------------------------------------------------------
# Shipping, watermarks, promotion, fencing.
# ---------------------------------------------------------------------------

def _ship(s, d):
    keys, vals = s.primary(d)
    plane, eng = s.plane, s.eng
    group = s.RP.ReplicaGroup(plane, 1)
    f = group.followers[0]
    out = {"wm0": json.load(open(os.path.join(f.dir, "watermark.json")))}
    assert out["wm0"]["cid"] == plane.cid
    out["wm0"].pop("cid")
    eng.insert(keys[:48], vals[:48] ^ np.uint64(0x99))
    eng.delete(keys[48:56])
    out["pump1"] = group.pump()
    out["search1"] = f.eng.search(keys[:56])
    okv = np.asarray([True, False, True])
    prov = np.asarray([11, 0, 13], np.uint64)
    eng.journal.append_acks([(7, "t", s.J.J_UPSERT, okv),
                             (8, "t", s.J.J_HEAP_PUT, okv, prov)])
    out["pump2"] = group.pump()
    out["state1"] = group_state(s, group)
    rcpt = group.promote()
    assert group.promoted is f
    out["receipt"] = _norm(rcpt, (plane.cid,))
    out["window"] = {k: tuple(np.asarray(x) for x in v)
                     for k, v in group.promoted_window().items()}
    out["fence"] = outcome(lambda: eng.insert(keys[:4], vals[:4]))
    out["fenced"] = group.fenced_writes
    out["search2"] = f.eng.search(keys[:48])
    out["state2"] = group_state(s, group)
    plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_ship_watermark_promote_fence(eight_devices, tmp_path, n):
    j, p = both(_ship, tmp_path, n=n)
    same(j, p)
    assert p["pump1"] == 2 and p["state1"]["followers"][0]["watermark"] \
        == (0, 3)
    assert p["receipt"]["epoch"] == {"old": 1, "new": 2}
    assert p["fence"] == ("raised", "StalePrimaryError") and p["fenced"] >= 1
    op, ok, h = p["window"][("t", 8)]
    assert op == J.J_HEAP_PUT
    np.testing.assert_array_equal(h, [11, 0, 13])


# ---------------------------------------------------------------------------
# The tailer's shipping-boundary contract.
# ---------------------------------------------------------------------------

def _torn(s, d):
    keys, vals = s.primary(d, n=300)
    group = s.RP.ReplicaGroup(s.plane, 1)
    f = group.followers[0]
    s.eng.insert(keys[:16], vals[:16])
    out = [group.pump()]
    rec = s.J.encode_record(s.J.J_UPSERT, np.asarray([1 << 40], np.uint64),
                            np.asarray([7], np.uint64), rid=0xDEAD)
    jpath = s.eng.journal.path
    size0 = os.path.getsize(jpath)
    with open(jpath, "ab") as fh:
        fh.write(rec[: len(rec) // 2])
    out += [group.pump(), f.tailer.torn_waits,
            os.path.getsize(jpath) - size0, group.pump(),
            f.tailer.torn_waits, f.pump(final=True), f.seq]
    out.append(group_state(s, group))
    s.plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_tailer_waits_on_live_torn_tail(eight_devices, tmp_path, n):
    """A torn frame at the live tail: the follower waits (the primary's
    file untouched); with ``final`` it is skipped, as recovery would."""
    j, p = both(_torn, tmp_path, n=n)
    same(j, p)
    assert p[:8] == [1, 0, 1, len(J.encode_record(
        J.J_UPSERT, np.asarray([1 << 40], np.uint64),
        np.asarray([7], np.uint64), rid=0xDEAD)) // 2, 0, 2, 0, 1]


def _midfile(s, d):
    keys, vals = s.primary(d, n=300)
    s.eng.insert(keys[:16], vals[:16])
    s.eng.insert(keys[16:32], vals[16:32])
    jpath = s.eng.journal.path
    blob = bytearray(open(jpath, "rb").read())
    blob[len(s.J.MAGIC) + s.J._HDR.size + 2] ^= 0x40
    open(jpath, "wb").write(bytes(blob))
    t = s.RP.JournalTailer(s.plane.dir, s.plane.cid)
    out = outcome(t.poll)
    s.plane.close()
    return out, t._off


@pytest.mark.parametrize("n", NODES)
def test_tailer_midfile_corruption_is_typed(eight_devices, tmp_path, n):
    j, p = both(_midfile, tmp_path, n=n)
    assert p == j == (("raised", "JournalCorruptError"), 0)


def _rotation(s, d):
    keys, vals = s.primary(d, n=300)
    group = s.RP.ReplicaGroup(s.plane, 1)
    f = group.followers[0]
    s.eng.insert(keys[:16], vals[:16] ^ np.uint64(1))
    s.plane._rotate_journal(s.plane._segment + 1)  # no sweep
    s.eng.insert(keys[:16], vals[:16] ^ np.uint64(2))
    out = [f.rebootstraps, group.pump(), f.rebootstraps,
           f.eng.search(keys[:16]), group_state(s, group)]
    s.plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_tailer_mid_rotation_order(eight_devices, tmp_path, n):
    """A rotation without a sweep: the tailer finishes the retired segment
    and advances, in order, with no re-bootstrap."""
    j, p = both(_rotation, tmp_path, n=n)
    same(j, p)
    assert p[0] == p[2] == 0
    assert p[3][1].all()


def _sweep(s, d):
    keys, vals = s.primary(d)
    group = s.RP.ReplicaGroup(s.plane, 1)
    f = group.followers[0]
    s.eng.insert(keys[:64], vals[:64] ^ np.uint64(0x31))
    s.plane.checkpoint_delta()  # rotate -> save -> sweep, unpumped
    s.eng.insert(keys[64:96], vals[64:96] ^ np.uint64(0x32))
    out = [group.pump(), f.rebootstraps, f.link, f.eng.search(keys[:96]),
           group_state(s, group)]
    s.plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_sweep_rebootstrap_converges(eight_devices, tmp_path, n):
    """A checkpoint sweeps the segment under the tail: the follower
    re-bootstraps from the chain and converges."""
    j, p = both(_sweep, tmp_path, n=n)
    same(j, p)
    assert p[1] == 1 and p[2] == 1 and p[3][1].all()


def _v1(s, d):
    keys, vals = s.primary(d, n=300)
    group = s.RP.ReplicaGroup(s.plane, 1)
    f = group.followers[0]
    s.eng.insert(keys[:8], vals[:8])
    group.pump()
    v1 = os.path.join(s.plane.dir, f"journal-{s.plane.cid}-000099.wal")
    nk = np.asarray([3 << 40], np.uint64)
    nv = np.asarray([123], np.uint64)
    pay = struct.pack("<BxxxI", J.J_UPSERT, 1) + nk.tobytes() + nv.tobytes()
    with open(v1, "wb") as fh:
        fh.write(J.MAGIC_V1)
        fh.write(struct.pack("<II", len(pay), zlib.crc32(pay)) + pay)
    out = [group.pump(), f.eng.search(nk), group_state(s, group)]
    s.plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_v1_segment_follower(eight_devices, tmp_path, n):
    """A v1 (pre-rid) successor segment ships: decoded with flags 0."""
    j, p = both(_v1, tmp_path, n=n)
    same(j, p)
    assert p[0] == 1 and p[1][1].all() and int(p[1][0][0]) == 123


# ---------------------------------------------------------------------------
# Replica-served reads: certified, caught-up only.
# ---------------------------------------------------------------------------

def _reads(s, d):
    keys, vals = s.primary(d)
    group = s.RP.ReplicaGroup(s.plane, 1, cache_slots=256, poll_ms=1e9)
    f = group.followers[0]
    group.pump()
    out = [f.admit(keys[:64]), group.read(keys[:64]),
           group.read(keys[100:140])]
    f.caught_up = False
    out.append(f.serve_read(keys[:8]))
    out.append(group.read(keys[:8]))
    f.caught_up = True
    out.append(f.serve_read(keys[60:70]))
    out.append((group.reads_served, group.reads_forwarded))
    out.append(group_state(s, group))
    s.plane.close()
    return out, vals


@pytest.mark.parametrize("n", NODES)
def test_replica_reads_certified_and_forwarded(eight_devices, tmp_path, n):
    """Admitted keys are served certified by the follower, the rest
    forward to the primary, and a follower that is not caught up serves
    nothing; every answer and count equals JAX's."""
    (j, vals), (p, _) = both(_reads, tmp_path, n=n)
    same(j, p)
    np.testing.assert_array_equal(p[1][0], vals[:64])
    np.testing.assert_array_equal(p[2][0], vals[100:140])
    assert p[3] is None and p[6][0] > 0 and p[6][1] > 0


# ---------------------------------------------------------------------------
# Ack provenance: journal encode/decode.
# ---------------------------------------------------------------------------

def test_ack_provenance_roundtrip(tmp_path):
    """The port's ack records with provenance are the JAX package's bytes
    and decode to its tuples; a handle count that is not one an op is
    refused typed in both."""
    okv = np.asarray([True, False, True])
    prov = np.asarray([0x11, 0, 0x33], np.uint64)
    blobs, recs = [], []
    for mod, tag in ((JJ, "jax"), (J, "port")):
        path = str(tmp_path / f"{tag}.wal")
        with mod.Journal(path) as j:
            j.append_acks([(1, "t", mod.J_UPSERT, okv),
                           (2, "t", mod.J_HEAP_PUT, okv, prov)])
            with pytest.raises(Exception) as ei:
                j.append_acks([(3, "t", mod.J_HEAP_PUT, okv,
                                np.asarray([1], np.uint64))])
            assert type(ei.value).__name__ == "ConfigError"
        blobs.append(open(path, "rb").read())
        recs.append(mod.read_records(path, with_rids=True))
    assert blobs[1] == blobs[0]
    same(recs[0], recs[1])
    (kind, _keys, acks, _rid), = recs[1]
    assert kind == J.J_ACK and len(acks[0]) == 4 and len(acks[1]) == 5


def test_followers_share_one_chain_load(tmp_path, monkeypatch):
    """The group inflates and checks the chain's base once for all its
    followers (``checkpoint.shared_loads``) and keeps it for their
    re-bootstraps after a delta; it drops it when the chain re-bases.
    The followers' pools equal those of a follower that loads alone."""
    from sherman_tpu_torch.utils import checkpoint as CK
    loads = []
    once = CK._load_arrays_once

    def counted(path, keys=None):
        loads.append((os.path.basename(path), keys))
        return once(path, keys)

    monkeypatch.setattr(CK, "_load_arrays_once", counted)
    s = Side(False)
    keys, vals = s.primary(tmp_path)
    group = RP.ReplicaGroup(s.plane, 3)
    assert loads.count(("base.npz", None)) == 1
    s.eng.insert(keys[:64], vals[:64] ^ np.uint64(0x51))
    s.plane.checkpoint_delta()
    del loads[:]
    assert group.pump() == 0
    assert all(f.rebootstraps == 1 for f in group.followers)
    assert loads.count(("base.npz", None)) == 0     # kept from the first
    assert sum(1 for n, k in loads if n.startswith("delta-")) == 1
    assert [k[0] for k in group._base_loads] \
        == [os.path.join(s.plane.dir, "base.npz")] * len(group._base_loads)
    alone = RP.Follower(group, 3)        # a follower bootstrapped by itself
    for f in group.followers:
        assert torch.equal(f.cluster.dsm.pool, alone.cluster.dsm.pool)
        assert torch.equal(f.cluster.dsm.pool, s.cluster.dsm.pool)
    s.plane.checkpoint_base()            # a new chain: the old base goes
    del loads[:]
    group.pump()
    assert loads.count(("base.npz", None)) == 1
    assert all(f.rebootstraps == 2 for f in group.followers)
    group.close()
    s.plane.close()
