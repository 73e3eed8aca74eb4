"""Port parity: the serving front door's client contract, journal and
sealed loop (``sherman_tpu_torch/serve.py``) against the JAX package, case
by case after tests/test_serve.py: exactly-once writes and the dedup
window, ``seed_dedup``, ``J_ACK`` records before the ack, deadlines, the
retrying client, drain, the journal's v2 records, the sealed zero-retrace
loop, the cache sketch fed by the front door, the journaled-ack crash
drill, and the quorum acks (``ack_quorum > 1`` over an attached replica
group, ``replica.py``).

After a serial sequence (each future resolves before the next submit)
both packages must leave the same answers, pools, journal segment bytes
and dedup windows.  A journal written by the JAX front door (upserts and
``J_ACK`` records) recovers in the port, and the port's ``seed_dedup``
re-acks the original results; the port's crash-drill journal replays in
JAX with RPO 0.  Threaded cases hold the port to the truth.  Every
comparison is exact equality; every server stops in a ``finally`` and
every ``result()`` takes a timeout.
"""

import contextlib
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from sherman_tpu import audit as JA
from sherman_tpu import chaos as JCH
from sherman_tpu import recovery as JRC
from sherman_tpu import replica as JRP
from sherman_tpu import serve as JS
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.utils import journal as JJ
from sherman_tpu_torch import audit as A
from sherman_tpu_torch import chaos as CH
from sherman_tpu_torch import recovery as RC
from sherman_tpu_torch import replica as RP
from sherman_tpu_torch import serve as PS
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import ConfigError, StateError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.utils import journal as J

torch.set_num_threads(1)


class Side:
    """One package's tree (keys ``100 + 3i``, values ``7 * key``), engine
    and module handles."""

    def __init__(self, jax_side, n=3000, B=256, pages=2048, cap=1024):
        self.jax = jax_side
        self.S = JS if jax_side else PS
        self.B = JB if jax_side else TB
        self.J = JJ if jax_side else J
        self.A = JA if jax_side else A
        self.RC = JRC if jax_side else RC
        self.RP = JRP if jax_side else RP
        self.CH = JCH if jax_side else CH
        kw = dict(machine_nr=1, pages_per_node=pages, locks_per_node=512,
                  step_capacity=cap, chunk_pages=32)
        cfg = (JDSMConfig(gather_impl="xla", **kw) if jax_side
               else DSMConfig(device="cpu", **kw))
        self.cluster = (JCluster if jax_side else Cluster)(cfg)
        self.tree = (JTree if jax_side else Tree)(self.cluster)
        self.keys = np.arange(100, 100 + n * 3, 3, dtype=np.uint64)
        self.vals = self.keys * np.uint64(7)
        self.B.bulk_load(self.tree, self.keys, self.vals)
        tcfg = (JTreeConfig if jax_side else TreeConfig)(
            sibling_chase_budget=2)
        self.eng = self.B.BatchedEngine(self.tree, batch_per_node=B,
                                        tcfg=tcfg)
        self.eng.attach_router()

    def pool(self) -> np.ndarray:
        p = self.tree.cluster.dsm.pool
        return np.asarray(p) if self.jax else p.numpy()


def pair(**kw):
    return Side(True, **kw), Side(False, **kw)


def targets(ms=10_000.0):
    return {c: ms for c in ("read", "scan", "insert", "delete")}


@contextlib.contextmanager
def serving(side, *, widths=(128, 512), journal=None, auditor=None,
            **cfgkw):
    cfg = side.S.ServeConfig(widths=widths, p99_targets_ms=targets(),
                             **cfgkw)
    srv = side.S.ShermanServer(side.eng, cfg, journal=journal,
                               auditor=auditor)
    try:
        srv.start(calib_keys=side.keys,
                  calib_writes=(side.keys[:64], side.vals[:64]),
                  calib_delete_keys=np.asarray([5], np.uint64))
        yield srv
    finally:
        srv.stop()


def admission_only(side, **cfgkw):
    cfg = side.S.ServeConfig(widths=(128, 512), p99_targets_ms=targets(),
                             **cfgkw)
    srv = side.S.ShermanServer(side.eng, cfg)
    srv._running = True
    return srv


def close(srv):
    srv._running = False
    srv._fail_queued(StateError("test done"))


def same(a, b, what=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
    else:
        assert a == b, (what, a, b)


def window(srv) -> dict:
    """The dedup windows in their order: tenant -> [(rid, entry)]."""
    return {t: [(rid, tuple(np.asarray(x) for x in e))
                for rid, e in st.dedup.items()]
            for t, st in srv._tenants.items()}


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def both(fn, tmp_path=None):
    """Run ``fn(side, dir)`` on each package; -> (JAX's, the port's)."""
    out = []
    for s in pair():
        d = None
        if tmp_path is not None:
            d = tmp_path / ("jax" if s.jax else "port")
            d.mkdir()
        out.append(fn(s, d))
    return out


# -- exactly-once, the dedup window ------------------------------------------

def _exactly_once(s, _d):
    keys = s.keys
    with serving(s) as srv:
        k8 = keys[:8]
        v1 = k8 ^ np.uint64(0xA1)
        ok1 = srv.submit("insert", k8, v1, rid=77,
                         tenant="t").result(timeout=60)
        assert ok1.all()
        v2 = k8 ^ np.uint64(0xB2)
        srv.submit("insert", k8, v2, rid=78, tenant="t").result(timeout=60)
        fut = srv.submit("insert", k8, v1, rid=77, tenant="t")
        okr = fut.result(timeout=60)
        assert fut.deduped and np.array_equal(okr, ok1)
        got, found = srv.submit("read", k8).result(timeout=60)
        assert found.all()
        np.testing.assert_array_equal(got, v2)   # v1 NOT re-applied
        fnd = srv.submit("delete", k8[:2], rid=79,
                         tenant="t").result(timeout=60)
        f2 = srv.submit("delete", k8[:2], rid=79, tenant="t")
        assert f2.deduped and np.array_equal(f2.result(timeout=60), fnd)
        st = srv.stats()["contract"]
        assert st["dedup_hits"] == 2 and st["duplicate_applies"] == 0
        assert st["cached_rids"] == 3 and st["pending_rids"] == 0
        f3 = srv.submit("insert", k8, v1, rid=77, tenant="other")
        assert not f3.deduped
        f3.result(timeout=60)
        srv.submit("insert", k8, v2, rid=80, tenant="t").result(timeout=60)
        return (ok1, okr, got, fnd, st, window(srv)), s.pool()


def test_exactly_once_retry_reacks_never_reapplies(eight_devices):
    (jr, jp), (pr, pp) = both(_exactly_once)
    same(jr, pr)
    np.testing.assert_array_equal(jp, pp, err_msg="pools")


def _bounded(s, _d):
    keys, vals = s.keys, s.vals
    with serving(s, dedup_window=2) as srv:
        for rid in (1, 2, 3):
            srv.submit("insert", keys[:2], vals[:2], rid=rid,
                       tenant="t").result(timeout=60)
        f = srv.submit("insert", keys[:2], vals[:2], rid=1, tenant="t")
        f.result(timeout=60)
        assert not f.deduped       # rid 1 evicted: re-applied (idempotent)
        f3 = srv.submit("insert", keys[:2], vals[:2], rid=3, tenant="t")
        f3.result(timeout=60)
        assert f3.deduped
        return window(srv), srv.stats()["contract"]


def test_dedup_window_is_bounded_and_evicts_oldest(eight_devices):
    j, p = both(_bounded)
    same(j, p)


def _inflight(s, _d):
    keys, vals = s.keys, s.vals
    srv = admission_only(s)
    f1 = srv.submit("insert", keys[:4], vals[:4], rid=5, tenant="t")
    f2 = srv.submit("insert", keys[:4], vals[:4], rid=5, tenant="t")
    assert f1 is f2  # one apply, one ack, shared
    a = srv.stats()["contract"]
    assert a["pending_rids"] == 1
    close(srv)
    b = srv.stats()["contract"]
    assert b["pending_rids"] == 0
    return a, b


def test_dedup_inflight_retry_joins_same_future(eight_devices):
    j, p = both(_inflight)
    same(j, p)


def _seed(s, d):
    keys, vals = s.keys, s.vals
    jpath = str(d / "seed-j.bin")
    journal = s.J.Journal(jpath, sync=True)
    win = {("t", 42): (s.J.J_UPSERT, np.asarray([True, False]))}
    try:
        with serving(s, journal=journal) as srv:
            assert srv.seed_dedup(win) == 1
            f = srv.submit("insert", keys[:2], vals[:2], rid=42,
                           tenant="t")
            ok = f.result(timeout=60)
            assert f.deduped and list(ok) == [True, False]
            w = window(srv)
    finally:
        journal.close()
    acks = [a for kind, _k, aux in s.J.read_records(jpath)
            if kind == s.J.J_ACK for a in aux]
    assert any(rid == 42 and tenant == "t"
               for rid, tenant, _o, _ok in acks)
    return w, read_bytes(jpath)


def test_seed_dedup_adopts_and_rejournals(eight_devices, tmp_path):
    j, p = both(_seed, tmp_path)
    same(j, p)


def _ack_records(s, d):
    keys, vals = s.keys, s.vals
    jpath = str(d / "ack-rec.bin")
    journal = s.J.Journal(jpath, sync=True, group_commit_ms=1.0)
    try:
        with serving(s, journal=journal) as srv:
            srv.submit("insert", keys[:16], vals[:16], rid=9,
                       tenant="w").result(timeout=60)
            # the moment result() returned, the J_ACK record parses
            recs = s.J.read_records(jpath, with_rids=True)
            acks = [aux for kind, _k, aux, _r in recs
                    if kind == s.J.J_ACK]
            assert acks and acks[0][0][0] == 9
            assert acks[0][0][1] == "w"
            assert acks[0][0][3].all() and acks[0][0][3].size == 16
    finally:
        journal.close()
    return read_bytes(jpath), s.pool()


def test_ack_records_reach_journal_before_ack(eight_devices, tmp_path):
    (jb, jp), (pb, pp) = both(_ack_records, tmp_path)
    assert jb == pb, "journal segment bytes differ"
    np.testing.assert_array_equal(jp, pp)


# -- deadlines ----------------------------------------------------------------

def _deadline(s, _d):
    keys, vals = s.keys, s.vals
    srv = admission_only(s)
    fut = srv.submit("read", keys[:8], deadline_ms=0.01, tenant="t")
    rid_fut = srv.submit("insert", keys[:4], vals[:4], rid=3,
                         deadline_ms=0.01, tenant="t")
    time.sleep(0.01)
    assert srv._take(("read",), 512) == []            # shed, not served
    assert srv._take(("insert", "delete"), 512) == []
    with pytest.raises(s.S.DeadlineExceededError):
        fut.result(timeout=1)
    with pytest.raises(s.S.DeadlineExceededError):
        rid_fut.result(timeout=1)
    assert srv.deadline_shed == 2
    assert srv.stats()["contract"]["pending_rids"] == 0
    f2 = srv.submit("read", keys[:8], deadline_ms=60_000.0, tenant="t")
    assert len(srv._take(("read",), 512)) == 1
    f2._fail(StateError("test done"))
    with pytest.raises(Exception) as ei:
        srv.submit("read", keys[:8], deadline_ms=-1.0)
    assert type(ei.value).__name__ == "ConfigError"
    st = srv.stats()
    close(srv)
    return st["contract"], st["tenants"]


def test_deadline_shed_typed_before_dispatch(eight_devices):
    j, p = both(_deadline)
    same(j, p)


def test_deadline_live_served_or_typed():
    s = Side(False)
    keys = s.keys
    with serving(s) as srv:
        outcomes = {"served": 0, "shed": 0}
        for i in range(20):
            try:
                got, found = srv.submit(
                    "read", keys[i::307],
                    deadline_ms=0.02 if i % 2 else 5000.0
                ).result(timeout=30)
                outcomes["served"] += 1
                assert found.all()
                np.testing.assert_array_equal(got, keys[i::307]
                                              * np.uint64(7))
            except PS.DeadlineExceededError:
                outcomes["shed"] += 1
        assert outcomes["served"] >= 10   # generous budgets all served


# -- the retrying client, drain -----------------------------------------------

def _retry(s, _d):
    import random as _random
    pol = s.S.RetryPolicy(base_backoff_ms=2.0, backoff_cap_ms=10.0)
    rng = _random.Random(0)
    backoffs = [pol.backoff_s(a, rng) for a in range(8)]
    assert all(0.0 <= b <= 0.010 + 1e-9 for b in backoffs)
    keys = s.keys
    with serving(s) as srv:
        cl = s.S.RetryingClient(srv, tenant="c", seed=3)
        got, found = cl.read(keys[:32])
        assert found.all()
        np.testing.assert_array_equal(got, keys[:32] * np.uint64(7))
        ok = cl.insert(keys[:4], keys[:4] ^ np.uint64(1))
        assert ok.all()
        rid = cl._rid
        ok2 = cl.insert(keys[:4], keys[:4] ^ np.uint64(1), rid=rid)
        assert ok2.all() and srv.dedup_hits >= 1
        assert cl.next_rid() != rid
        fnd = cl.delete(np.asarray([5], np.uint64))
        assert not fnd.any()
        return backoffs, rid, ok, ok2, fnd, window(srv), s.pool()


def test_retry_policy_and_client(eight_devices):
    j, p = both(_retry)
    same(j, p)


def _drain(s, d):
    keys, vals = s.keys, s.vals
    jpath = str(d / "drain-j.bin")
    journal = s.J.Journal(jpath, sync=True, group_commit_ms=1.0)
    cfg = s.S.ServeConfig(widths=(128, 512), p99_targets_ms=targets(),
                          write_linger_ms=50.0)       # writes pend
    srv = s.S.ShermanServer(s.eng, cfg, journal=journal)
    try:
        srv.start(calib_keys=keys, calib_writes=(keys[:64], vals[:64]))
        futs = [srv.submit("read", keys[:64])]
        futs.append(srv.submit("insert", keys[:8],
                               keys[:8] ^ np.uint64(0xD1), rid=1))
        fsyncs0 = journal.fsyncs
        srv.drain()
        res = [f.result(timeout=1) for f in futs]  # all admitted: served
        assert journal.fsyncs > fsyncs0          # the epilogue fsync
        with pytest.raises(Exception) as ei:
            srv.submit("read", keys[:4])
        assert type(ei.value).__name__ == "StateError"
    finally:
        srv.stop()
        journal.close()
    return res, read_bytes(jpath), s.pool()


def test_drain_serves_admitted_and_fsyncs(eight_devices, tmp_path):
    j, p = both(_drain, tmp_path)
    same(j, p)


# -- the journal's v2 records ----------------------------------------------------

def _v2(s, d):
    jp = str(d / "v2.bin")
    j = s.J.Journal(jp, sync=True)
    assert j.format == 2
    j.append(s.J.J_UPSERT, np.asarray([1, 2], np.uint64),
             np.asarray([3, 4], np.uint64), rid=0xABCD)
    j.append(s.J.J_DELETE, np.asarray([9], np.uint64))
    j.append_acks([(7, "tenant-x", s.J.J_UPSERT,
                    np.asarray([True, False, True])),
                   (8, "y", s.J.J_DELETE, np.asarray([True] * 9))])
    j.close()
    recs = s.J.read_records(jp, with_rids=True)
    assert recs[0][3] == 0xABCD and recs[1][3] is None
    kind, keys_, acks, _ = recs[2]
    assert kind == s.J.J_ACK and len(acks) == 2 and keys_ is None
    rid, tenant, op, ok = acks[0]
    assert (rid, tenant, op) == (7, "tenant-x", s.J.J_UPSERT)
    assert list(ok) == [True, False, True]
    assert list(acks[1][3]) == [True] * 9
    assert len(s.J.read_records(jp)[0]) == 3
    return read_bytes(jp), recs


def test_journal_v2_rid_round_trip(eight_devices, tmp_path):
    j, p = both(_v2, tmp_path)
    same(j, p)


def test_journal_v1_backcompat_missing_field(tmp_path):
    """An old (v1) journal replays with rid None everywhere, and appends
    to it stay v1 (acks refused) — in both packages alike."""
    import struct
    import zlib
    out = []
    for mod, tag in ((JJ, "jax"), (J, "port")):
        jp = str(tmp_path / f"v1-{tag}.bin")
        with open(jp, "wb") as f:
            f.write(mod.MAGIC_V1)
            pay = struct.pack("<BxxxI", mod.J_UPSERT, 2) \
                + np.asarray([9, 10], np.uint64).tobytes() \
                + np.asarray([11, 12], np.uint64).tobytes()
            f.write(struct.pack("<II", len(pay), zlib.crc32(pay)) + pay)
        recs = mod.read_records(jp, with_rids=True)
        assert recs[0][3] is None
        np.testing.assert_array_equal(recs[0][1],
                                      np.asarray([9, 10], np.uint64))
        j = mod.Journal(jp, sync=True)
        assert j.format == 1
        j.append(mod.J_UPSERT, np.asarray([13], np.uint64),
                 np.asarray([14], np.uint64), rid=99)   # rid dropped
        assert j.append_acks([(1, "t", mod.J_UPSERT,
                               np.asarray([True]))]) == 0
        j.close()
        recs = mod.read_records(jp, with_rids=True)
        assert len(recs) == 2 and recs[1][3] is None
        out.append((read_bytes(jp), recs))
    same(out[0], out[1])


def test_journal_replay_collects_acks(eight_devices, tmp_path):
    """A journal written by JAX's journal replays in the port (the ack
    sink collects its J_ACK entries) and leaves the pool JAX's replay
    leaves."""
    jp = str(tmp_path / "rp.bin")
    s0 = Side(True)
    keys = s0.keys
    j = JJ.Journal(jp, sync=True)
    j.append(JJ.J_UPSERT, keys[:4], keys[:4] ^ np.uint64(0xE1))
    j.append_acks([(5, "t", JJ.J_UPSERT, np.asarray([True] * 4))])
    j.close()
    out = []
    for s in (s0, Side(False)):
        sink: list = []
        stats = s.J.replay(jp, s.eng, ack_sink=sink)
        assert stats["acks"] == 1 and stats["upserts"] == 1
        assert sink[0][0] == 5 and sink[0][1] == "t"
        got, found = s.eng.search(keys[:4])
        assert found.all()
        np.testing.assert_array_equal(got, keys[:4] ^ np.uint64(0xE1))
        out.append((stats, sink, s.pool()))
    same(out[0], out[1])


def _jstats(s, d):
    jp = str(d / "j.bin")
    j = s.J.Journal(jp, sync=True)
    a = j.stats()
    assert a == {"appends": 0, "rows": 0, "fsyncs": 0,
                 "appends_per_fsync": None}
    j.append(s.J.J_UPSERT, np.asarray([1, 2], np.uint64),
             np.asarray([3, 4], np.uint64))
    j.append(s.J.J_DELETE, np.asarray([1], np.uint64))
    b = j.stats()
    assert b["appends"] == 2 and b["rows"] == 3 and b["fsyncs"] == 2
    assert b["appends_per_fsync"] == 1.0
    j.close()
    return a, b, read_bytes(jp)


def test_journal_instance_stats(tmp_path):
    j, p = both(_jstats, tmp_path)
    same(j, p)


# -- sealed zero-retrace serving loop ----------------------------------------

@pytest.mark.parametrize("fusion", ["aligned", "pipelined"])
@pytest.mark.parametrize("cache", [False, True])
def test_sealed_serving_loop_zero_retrace(fusion, cache):
    """The sealed loop stays zero-retrace with the client contract armed:
    exactly-once dedup, deadlines and the sampling auditor are host-side
    machinery."""
    s = Side(False)
    keys = s.keys
    if cache:
        s.eng.attach_leaf_cache(slots=1024, admit_every=4)
    aud = A.Auditor(sample_mod=4, interval_s=0.05)
    try:
        with serving(s, fusion=fusion, max_queue_ops=16384,
                     auditor=aud) as srv:
            assert srv._sealed
            rng = np.random.default_rng(1)
            futs = []
            for i in range(24):
                idx = rng.integers(0, 50 if i % 2 else keys.size, 120)
                kreq = keys[idx]
                futs.append((srv.submit(
                    "read", kreq,
                    deadline_ms=60_000.0 if i % 3 else None), kreq))
            for f, kreq in futs:
                got, found = f.result(timeout=60)
                assert found.all()
                np.testing.assert_array_equal(got, kreq * np.uint64(7))
            srv.submit("insert", keys[:8], keys[:8] ^ np.uint64(2),
                       rid=501).result(timeout=60)
            f = srv.submit("insert", keys[:8], keys[:8] ^ np.uint64(2),
                           rid=501)
            assert f.result(timeout=60).all() and f.deduped
            srv.submit("delete", np.asarray([5], np.uint64),
                       rid=502).result(timeout=60)
            srv.submit("scan", ranges=[(int(keys[0]), int(keys[9]))]
                       ).result(timeout=60)
            assert srv.retraces == 0, "a new signature in the sealed loop"
            if cache:
                assert srv.stats()["cache"]["sketch"][
                    "observed_batches"] > 0
        assert aud.violations == 0
        assert aud.rec.events > 0
    finally:
        if cache:
            s.eng.detach_leaf_cache()


def _sketch(s, _d):
    keys = s.keys
    lc = s.eng.attach_leaf_cache(slots=1024, admit_every=2)
    out = []
    try:
        with serving(s) as srv:
            hot = keys[:64]
            for _ in range(8):
                got, found = srv.submit(
                    "read", np.tile(hot, 3)).result(timeout=60)
                assert found.all()
                out.append(got)
            assert lc.sketch_stats()["observed_batches"] >= 8
            assert lc.fills > 0, "sketch admission never fired"
            assert lc.hits > 0, "admitted hot keys never hit"
            got, found = srv.submit("read", hot).result(timeout=60)
            np.testing.assert_array_equal(got, hot * np.uint64(7))
            out.append(got)
        return out, sorted(lc.cached_keys().tolist())
    finally:
        s.eng.detach_leaf_cache()


def test_serve_cache_sketch_admission_hits(eight_devices):
    j, p = both(_sketch)
    same(j, p)


# -- journaled acks, the crash drill -------------------------------------------

def test_journaled_ack_crash_drill_rpo0(eight_devices, tmp_path):
    """Concurrent writers through the port's front door, a kill with the
    journal left open, then replay onto the base image — in the port and
    in JAX: every acked write is there (RPO 0), and acks per fsync > 1."""
    s = Side(False)
    keys = s.keys
    jpath = str(tmp_path / "serve-journal.bin")
    journal = J.Journal(jpath, sync=True, group_commit_ms=2.0)
    acked: dict[int, int] = {}
    lock = threading.Lock()
    with serving(s, journal=journal, write_linger_ms=20.0) as srv:
        jstats0 = journal.stats()

        def writer(w):
            my = keys[w * 500:(w + 1) * 500]
            for gen in range(1, 4):
                kreq = my[:128]
                vreq = kreq ^ np.uint64(0xBEEF) ^ np.uint64(gen)
                ok = srv.submit("insert", kreq, vreq,
                                tenant=f"w{w}").result(timeout=60)
                with lock:
                    for k, v, o in zip(kreq.tolist(), vreq.tolist(),
                                       ok.tolist()):
                        if o:
                            acked[k] = v

        ths = [threading.Thread(target=writer, args=(w,), daemon=True)
               for w in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        jstats = journal.stats()
        fsyncs = jstats["fsyncs"] - jstats0["fsyncs"]
        assert fsyncs > 0
        assert srv.acked_writes / fsyncs > 1.0, (srv.acked_writes, fsyncs)
        srv.kill()
    assert acked
    ak = np.fromiter(acked.keys(), np.uint64, len(acked))
    av = np.fromiter(acked.values(), np.uint64, len(acked))
    pools = []
    for side in (Side(False), Side(True)):
        stats = side.J.replay(jpath, side.eng)
        assert stats["records"] > 0
        got, found = side.eng.search(ak)
        rpo = int(np.sum(~(found & (got == av))))
        assert rpo == 0, f"{rpo} acked writes lost"
        pools.append(side.pool())
    np.testing.assert_array_equal(pools[0], pools[1])


def _durable(s, d):
    keys = s.keys
    jpath = str(d / "ack-journal.bin")
    journal = s.J.Journal(jpath, sync=True, group_commit_ms=1.0)
    try:
        with serving(s, journal=journal) as srv:
            kreq = keys[:32]
            vreq = kreq ^ np.uint64(0xACED)
            srv.submit("insert", kreq, vreq).result(timeout=60)
            recs = s.J.read_records(jpath)
            rows = {int(k): int(v) for kind, ks, vs in recs
                    if vs is not None for k, v in zip(ks, vs)}
            assert all(rows.get(int(k)) == int(v)
                       for k, v in zip(kreq, vreq))
    finally:
        journal.close()
    return read_bytes(jpath), s.pool()


def test_write_ack_implies_durable_record(eight_devices, tmp_path):
    j, p = both(_durable, tmp_path)
    same(j, p)


# -- exactly-once across a crash, across packages -------------------------------

def _front_door_crash(s, rdir, cfg_kw):
    """Acked writes with rids through ``s``'s front door over a recovery
    plane, then a crash (the journal left open)."""
    plane = s.RC.RecoveryPlane(s.cluster, s.tree, s.eng, rdir)
    plane.checkpoint_base()
    cfg = s.S.ServeConfig(widths=(128,), p99_targets_ms=targets(),
                          **cfg_kw)
    srv = s.S.ShermanServer(s.eng, cfg)
    srv.start()
    try:
        keys = s.keys
        oks = [srv.submit("insert", keys[i * 8:(i + 1) * 8],
                          keys[i * 8:(i + 1) * 8] ^ np.uint64(0x51 + i),
                          rid=100 + i, tenant="t").result(timeout=60)
               for i in range(3)]
        oks.append(srv.submit("delete", keys[40:44], rid=103,
                              tenant="u").result(timeout=60))
    finally:
        srv.kill()
    return oks


def test_front_door_acks_recover_across_packages(eight_devices, tmp_path):
    """A journal of upserts and J_ACK records written by JAX's front door
    recovers in the port: the recovered dedup window equals JAX's, a
    fresh port server adopts it through ``seed_dedup`` (which rejournals
    it), and a write retried across the crash re-acks its original
    result instead of re-applying — as JAX's server does."""
    s0 = Side(True)
    src = str(tmp_path / "jax-rec")
    cfg_kw = dict(write_linger_ms=0.0)
    oks = _front_door_crash(s0, src, cfg_kw)
    out = []
    for mod, dev in ((JRC, None), (RC, "cpu")):
        rdir = str(tmp_path / f"rec-{'port' if dev else 'jax'}")
        shutil.copytree(src, rdir)         # recover re-bases the directory
        kw = dict(batch_per_node=256)
        if dev:
            kw["device"] = dev
        plane, cl, tr, eng, receipt = mod.RecoveryPlane.recover(rdir, **kw)
        win = dict(plane.dedup_window)
        S = JS if dev is None else PS
        cfg = S.ServeConfig(widths=(128,), p99_targets_ms=targets(),
                            **cfg_kw)
        srv = S.ShermanServer(eng, cfg)
        srv.start()
        try:
            assert srv.seed_dedup(win) == 4
            keys = s0.keys
            f = srv.submit("insert", keys[:8], keys[:8] ^ np.uint64(0x99),
                           rid=100, tenant="t")
            okr = f.result(timeout=60)
            assert f.deduped
            np.testing.assert_array_equal(okr, oks[0])
            got, found = srv.submit("read", keys[:8]).result(timeout=60)
            np.testing.assert_array_equal(got, keys[:8] ^ np.uint64(0x51))
            g = srv.submit("delete", keys[40:44], rid=103, tenant="u")
            np.testing.assert_array_equal(g.result(timeout=60), oks[3])
            assert g.deduped
            ws = window(srv)
        finally:
            srv.kill()
        acks = [a for kind, _k, aux in J.read_records(eng.journal.path)
                if kind == J.J_ACK for a in aux]
        assert {(a[0], a[1]) for a in acks} >= {(100, "t"), (103, "u")}
        pool = np.asarray(cl.dsm.pool) if dev is None \
            else cl.dsm.pool.numpy()
        out.append(({k: tuple(np.asarray(x) for x in v)
                     for k, v in win.items()}, ws, got, pool))
        plane.close()
    same(out[0], out[1])


# -- quorum acks (replica.py) ---------------------------------------------------

def test_quorum_config_validation():
    """The quorum knobs refuse bad values typed, ``ack_quorum=2`` is
    accepted, ``attach_replica_group`` stores the group, and
    ``ack_quorum > 1`` without a group is a start()-time ConfigError (as
    in tests/test_serve.py::test_quorum_config_validation)."""
    with pytest.raises(ConfigError):
        PS.ServeConfig(widths=(128,), p99_targets_ms=targets(),
                       ack_quorum=0)
    with pytest.raises(ConfigError):
        PS.ServeConfig(widths=(128,), p99_targets_ms=targets(),
                       quorum_timeout_ms=0.0)
    cfg = PS.ServeConfig(widths=(128,), p99_targets_ms=targets(),
                         ack_quorum=2)
    assert cfg.ack_quorum == 2
    s = Side(False, n=900, pages=1024, B=128, cap=512)
    srv = PS.ShermanServer(s.eng, cfg)
    with pytest.raises(ConfigError):
        srv.start()
    group = object()
    srv.attach_replica_group(group)
    assert srv.replica_group is group
    srv.attach_replica_group(None)
    assert srv.replica_group is None


def _quorum_off(s, d):
    plane = s.RC.RecoveryPlane(s.cluster, s.tree, s.eng, str(d / "rec"))
    plane.checkpoint_base()
    cfg = s.S.ServeConfig(widths=(128,), p99_targets_ms=targets(),
                          write_linger_ms=0.0)
    assert cfg.ack_quorum == 1
    srv = s.S.ShermanServer(s.eng, cfg)
    srv.start()
    try:
        keys = s.keys
        kreq = keys[:256]
        srv.submit("insert", kreq, kreq ^ np.uint64(0xC0DE)).result(
            timeout=60)
        srv.submit("delete", keys[300:316]).result(timeout=60)
        srv.drain()
        assert srv.quorum_acks == 0          # the gate never ran
        q = srv.stats()["quorum"]
    finally:
        srv.stop()
        plane.close()
    return q, s.pool()


def test_quorum_off_bit_identity(eight_devices, tmp_path):
    """ack_quorum=1 (the default) takes the write path of a build without
    the quorum gate: the pool equals JAX's."""
    j, p = both(_quorum_off, tmp_path)
    same(j, p)


def _quorum_off_group(s, d):
    """The default ``ack_quorum=1`` with a replica group attached: the gate
    never runs, and the pool and the journal's bytes equal a front door's
    without a group."""
    out = []
    for tag, attach in (("off", False), ("on", True)):
        side = Side(s.jax, n=900, pages=1024, B=128, cap=512)
        plane = s.RC.RecoveryPlane(side.cluster, side.tree, side.eng,
                                   str(d / tag))
        plane.checkpoint_base()
        cfg = s.S.ServeConfig(widths=(128,), p99_targets_ms=targets(),
                              write_linger_ms=0.0)
        srv = s.S.ShermanServer(side.eng, cfg)
        group = None
        if attach:
            group = s.RP.ReplicaGroup(plane, 1)
            srv.attach_replica_group(group)
        srv.start()
        try:
            kreq = side.keys[:256]
            ok1 = srv.submit("insert", kreq, kreq ^ np.uint64(0xC0DE),
                             rid=5).result(timeout=60)
            ok2 = srv.submit("delete", side.keys[300:316]).result(timeout=60)
            srv.drain()
            assert srv.quorum_acks == 0          # the gate never ran
        finally:
            srv.stop()
        jbytes = read_bytes(side.eng.journal.path)
        if group is not None:
            group.close()
        plane.close()
        out.append((np.asarray(ok1), np.asarray(ok2), side.pool(), jbytes))
    same(out[0][:3], out[1][:3], "group on vs off")
    assert out[0][3] == out[1][3], "journal bytes moved with a group"
    return out[1][:3], len(out[1][3])


def test_quorum_off_with_group_bit_identity(eight_devices, tmp_path):
    """tests/test_serve.py::test_quorum_off_bit_identity: with a group
    attached and ``ack_quorum=1`` the acks, pool and journal bytes are
    those of a front door without one, in both packages, and equal."""
    j, p = both(_quorum_off_group, tmp_path)
    same(j, p)


def _quorum_gate(s, d):
    """tests/test_serve.py::test_quorum_gate_end_to_end's sequence."""
    plane = s.RC.RecoveryPlane(s.cluster, s.tree, s.eng, str(d / "rec"))
    plane.checkpoint_base()
    group = s.RP.ReplicaGroup(plane, 1)
    chaos = s.CH.ReplChaos([], seed=0)
    group.attach_chaos(chaos)
    cfg = s.S.ServeConfig(widths=(128,), p99_targets_ms=targets(),
                          write_linger_ms=0.0, ack_quorum=2,
                          quorum_timeout_ms=400.0)
    srv = s.S.ShermanServer(s.eng, cfg)
    srv.attach_replica_group(group)
    srv.start()
    try:
        keys = s.keys
        kreq = keys[:48]
        ok = srv.submit("insert", kreq, kreq ^ np.uint64(0xACDC),
                        tenant="q").result(timeout=60)
        assert int(np.sum(ok)) > 0 and srv.quorum_acks >= 1
        q1 = {k: v for k, v in srv.stats()["quorum"].items()
              if k != "wait_ms"}
        assert group.followers[0].tailer.covers(*group.quorum_token())
        # a full ship partition: the bounded wait expires typed
        chaos.hold("ship")
        rid = (0x77 << 32) | 3
        k2 = keys[64:80]
        v2 = k2 ^ np.uint64(0xD1CE)
        t0 = time.perf_counter()
        with pytest.raises(Exception) as ei:
            srv.submit("insert", k2, v2, tenant="q",
                       rid=rid).result(timeout=30)
        tip = ei.value
        while tip is not None and not isinstance(
                tip, s.RP.QuorumTimeoutError):
            tip = tip.__cause__
        assert tip is not None, f"untyped quorum expiry: {ei.value!r}"
        assert time.perf_counter() - t0 < 5.0, "wait was not bounded"
        timeouts = srv.quorum_timeouts
        # the heal: the same rid re-acks its original result (dedup)
        chaos.heal()
        fut = srv.submit("insert", k2, v2, tenant="q", rid=rid)
        ok2 = fut.result(timeout=60)
        assert fut.deduped, "quorum retry re-applied, not re-acked"
        assert srv.duplicate_applies == 0
        srv.drain()
        group.pump()
        st = {k: v for k, v in group.stats().items()
              if k not in ("quorum_wait_ms",)}
        fpool = group.followers[0].cluster.dsm.pool
        fpool = np.asarray(fpool) if s.jax else fpool.numpy()
    finally:
        srv.stop()
        group.close()
        plane.close()
    return (np.asarray(ok), q1, timeouts, np.asarray(ok2), st, window(srv),
            s.pool(), fpool)


def test_quorum_gate_end_to_end(eight_devices, tmp_path):
    """ack_quorum=2 through the front door: acks resolve after a follower
    covers them, a full ship partition expires the wait typed, and the
    same-rid retry after the heal re-acks; acks, counters, dedup windows
    and both pools equal JAX's."""
    j, p = both(_quorum_gate, tmp_path)
    same(j, p)
