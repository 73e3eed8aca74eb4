"""Port parity: the serving front door (``sherman_tpu_torch/serve.py``,
``make_ingress_step``, ``serve_bench.AdmissionPacer``) against the JAX
package, case by case after tests/test_serve.py: the width controller,
the admission pacer, the ingress step, serving basics, fair-share
admission, brownout and degraded shedding, and the config parsing.  The
client contract, the journal and the sealed loop are in
tests/test_torch_serve_contract.py.

Where the outcome does not depend on timing, both packages run the same
sequence and must agree exactly: the controller's picks on the same
walls, admission decisions and tenant stats, answers, and — after a
serial sequence, where each future resolves before the next submit — the
pools.  Threaded cases (the greedy tenant) hold the port to the truth.
The JAX side runs as its own tests run it (``gather_impl="xla"``, the
``eight_devices`` fixture).  Every server stops in a ``finally`` and
every ``result()`` takes a timeout.
"""

import contextlib
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sherman_tpu import obs as JOBS
from sherman_tpu import serve as JS
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.errors import ConfigError as JConfigError
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.workload import device_prep as JP
from sherman_tpu_torch import obs as OBS
from sherman_tpu_torch import serve as PS
from sherman_tpu_torch import serve_bench as SB
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import (ConfigError, KeyRangeError,
                                      StateError)
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.workload import device_prep as TP

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

torch.set_num_threads(1)


class Side:
    """One package's tree (keys ``100 + 3i``, values ``7 * key``), engine
    and module handles, as tests/test_serve.py's ``make`` builds it."""

    def __init__(self, jax_side, nr=1, n=3000, B=256, pages=2048,
                 cap=1024):
        self.jax = jax_side
        self.S = JS if jax_side else PS
        self.B = JB if jax_side else TB
        self.P = JP if jax_side else TP
        self.OBS = JOBS if jax_side else OBS
        kw = dict(machine_nr=nr, pages_per_node=pages, locks_per_node=512,
                  step_capacity=cap, chunk_pages=32)
        cfg = (JDSMConfig(gather_impl="xla", **kw) if jax_side
               else DSMConfig(device="cpu", **kw))
        self.tree = (JTree if jax_side else Tree)(
            (JCluster if jax_side else Cluster)(cfg))
        self.keys = np.arange(100, 100 + n * 3, 3, dtype=np.uint64)
        self.vals = self.keys * np.uint64(7)
        self.B.bulk_load(self.tree, self.keys, self.vals)
        tcfg = (JTreeConfig if jax_side else TreeConfig)(
            sibling_chase_budget=2)
        self.eng = self.B.BatchedEngine(self.tree, batch_per_node=B // nr,
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
def serving(side, *, widths=(128, 512), journal=None, calibrate=True,
            auditor=None, **cfgkw):
    cfg = side.S.ServeConfig(widths=widths,
                             p99_targets_ms=cfgkw.pop("p99_targets_ms",
                                                      targets()),
                             **cfgkw)
    srv = side.S.ShermanServer(side.eng, cfg, journal=journal,
                               auditor=auditor)
    try:
        if calibrate:
            srv.start(calib_keys=side.keys,
                      calib_writes=(side.keys[:64], side.vals[:64]),
                      calib_delete_keys=np.asarray([5], np.uint64))
        else:
            srv.start()
        yield srv
    finally:
        srv.stop()


def admission_only(side, **cfgkw):
    """Admission open, no dispatcher thread: nothing drains."""
    cfg = side.S.ServeConfig(widths=cfgkw.pop("widths", (128, 512)),
                             p99_targets_ms=targets(), **cfgkw)
    srv = side.S.ShermanServer(side.eng, cfg)
    srv._running = True
    return srv


def close(srv):
    srv._running = False
    srv._fail_queued(StateError("test done"))


def same(a, b, what=""):
    """Exact equality of nested results (arrays, tuples, lists, dicts)."""
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


# -- width controller (pure units) --------------------------------------------

def _frontier(mod):
    out = []
    c = mod.WidthController((128, 512, 2048), target_p99_ms=10.0,
                            model_mult=2.0)
    c.seed(128, 1.0)    # est p99 2 ms
    c.seed(512, 3.0)    # est 6 ms
    c.seed(2048, 9.0)   # est 18 ms — infeasible
    out += [c.pick(10**9), c.pick(100)]
    c2 = mod.WidthController((128, 512), target_p99_ms=0.5)
    c2.seed(128, 1.0)
    c2.seed(512, 2.0)
    out.append(c2.pick(10**9))
    c3 = mod.WidthController((128, 512), target_p99_ms=10.0)
    out.append(c3.pick(10**9))
    out.append(c.pick(700, min_ops=600))     # head wider than a rung
    return out, c.snapshot()


def test_controller_pick_frontier():
    got, snap = _frontier(PS)
    assert got[:4] == [512, 128, 128, 128]
    same((got, snap), _frontier(JS))


def _breach(mod):
    c = mod.WidthController((128, 512, 2048), target_p99_ms=10.0,
                            model_mult=2.0, hold_steps=4)
    for w in (128, 512, 2048):
        c.seed(w, 1.0)
    out = [c.pick(10**9)]
    c.note_window_p99(100.0, queue_dominated=True)
    out += [c.downshifts, c.pick(10**9)]
    c.note_window_p99(100.0, queue_dominated=False)
    out += [c.downshifts, c.pick(10**9)]
    for _ in range(5):
        c.update(512, 1.0)
    out += [c.pick(10**9), c.settled_width()]
    return out, c.snapshot()


def test_controller_breach_queue_attribution():
    got, snap = _breach(PS)
    assert got[:5] == [2048, 0, 2048, 1, 512] and got[5] == 2048
    assert snap["downshifts"] == 1 and snap["target_p99_ms"] == 10.0
    same((got, snap), _breach(JS))


def test_controller_ewma_update():
    walls = []
    for mod in (PS, JS):
        c = mod.WidthController((128,), target_p99_ms=10.0, ewma=0.5)
        c.seed(128, 2.0)
        c.update(128, 4.0)
        walls.append(c.wall_ms[128])
    assert walls[0] == pytest.approx(3.0) and walls[0] == walls[1]


# -- the admission pacer ------------------------------------------------------

def test_admission_pacer_receipt():
    from common import AdmissionPacer as JPacer
    p = SB.AdmissionPacer(0.002, spin_ms=0.5)
    p.start(lead_periods=1)
    for i in range(20):
        assert p.wait_turn(i) >= 0
    r = p.jitter_receipt()
    assert r["pacing"] == "sleep+spin"
    assert r["adm_jitter_p99_ms"] >= r["adm_jitter_p50_ms"] >= 0
    assert p.spin_ns <= 0.5 * p.period_ns
    p2 = SB.AdmissionPacer(0.002)
    p2.start()
    p2.wait_turn(0)
    n0 = len(p.errors_ns)
    p.merge_errors(p2)
    assert len(p.errors_ns) == n0 + 1
    # the same receipt fields and spin budget as the reference's pacer
    j = JPacer(0.002, spin_ms=0.5)
    assert (j.period_ns, j.spin_ns) == (p.period_ns, p.spin_ns)
    j.start()
    j.wait_turn(0)
    assert j.jitter_receipt().keys() == r.keys()


def test_pacer_absorb_stall_is_capped():
    p = SB.AdmissionPacer(0.001)
    p.start(lead_periods=0)
    base0 = p._t_base
    time.sleep(0.02)  # fall far behind
    p.absorb_stall(1, cap_ns=2_000_000)  # forgive at most 2 ms
    assert 0 < p._t_base - base0 <= 2_000_000


def test_serve_bench_has_one_pacer():
    """The open-loop bench paces through the one pacer class, not a
    copy of its spin loop."""
    import inspect
    src = inspect.getsource(SB)
    assert src.count("class AdmissionPacer") == 1
    assert src.count("now = self._clock()") == 2     # wait_turn only
    assert "AdmissionPacer(period" in inspect.getsource(SB.run_serve)


# -- ingress step -------------------------------------------------------------

@pytest.mark.parametrize("nr", [1, 8])
def test_ingress_step_combines_and_answers(eight_devices, nr):
    outs = []
    for s in pair(nr=nr):
        keys = s.keys
        step = s.P.make_ingress_step(s.eng, width=256)
        rng = np.random.default_rng(3)
        kreq = keys[rng.integers(0, keys.size, 200)]
        got, found = step(kreq)
        assert found.all()
        np.testing.assert_array_equal(got, kreq * np.uint64(7))
        miss = np.asarray([7, 11], np.uint64)
        got2, found2 = step(np.concatenate([kreq[:10], miss]))
        assert found2[:10].all() and not found2[10:].any()
        h = step.dispatch(kreq[:50])
        got3, found3 = step.complete(h)
        assert found3.all() and got3.shape == (50,)
        outs.append((got, found, got2, found2, got3, found3))
    same(outs[0], outs[1])


@pytest.mark.parametrize("nr", [1, 8])
def test_ingress_step_cache_bit_identical(eight_devices, nr):
    outs = []
    for s in pair(nr=nr):
        keys = s.keys
        kreq = np.concatenate([keys[:100], keys[:100], keys[500:600]])
        base = s.P.make_ingress_step(s.eng, width=512)(kreq)
        lc = s.eng.attach_leaf_cache(slots=1024)
        lc.fill(keys[:200])
        cached = s.P.make_ingress_step(s.eng, width=512, leaf_cache=lc)(kreq)
        same(base, cached, "cached vs uncached")
        assert lc.hits > 0
        outs.append((cached, lc.stats()))
        s.eng.detach_leaf_cache()
    same(outs[0], outs[1])


@pytest.mark.parametrize("nr", [1, 8])
def test_ingress_matches_engine_search_combined(eight_devices, nr):
    """The ingress step and ``search_combined`` implement one
    combine/probe/fan-out/rescue/merge protocol: equal answers, with and
    without the cache, and equal to JAX's."""
    outs = []
    for s in pair(nr=nr):
        keys = s.keys
        rng = np.random.default_rng(9)
        kreq = np.concatenate([keys[rng.integers(0, keys.size, 300)],
                               np.asarray([7, 11], np.uint64)])
        got = []
        for cached in (False, True):
            if cached:
                lc = s.eng.attach_leaf_cache(slots=1024)
                lc.fill(keys[:200])
            step = s.P.make_ingress_step(s.eng, width=512,
                                         leaf_cache=s.eng.leaf_cache)
            got_i, found_i = step(kreq)
            got_e, found_e = s.eng.search_combined(kreq)
            np.testing.assert_array_equal(found_i, found_e)
            np.testing.assert_array_equal(got_i, got_e)
            got.append((got_i, found_i))
            if cached:
                s.eng.detach_leaf_cache()
        outs.append(got)
    same(outs[0], outs[1])


def test_ingress_step_validates_width():
    s = Side(False)
    with pytest.raises(ConfigError):
        TP.make_ingress_step(s.eng, width=0)
    eng2 = TB.BatchedEngine(s.tree, batch_per_node=64)
    with pytest.raises(ConfigError):
        TP.make_ingress_step(eng2, width=128)  # no router attached
    s8 = Side(False, nr=8, pages=1024, cap=256)
    with pytest.raises(ConfigError):
        TP.make_ingress_step(s8.eng, width=100)  # not a multiple of 8


# -- serving basics -----------------------------------------------------------

def _basics(s):
    keys = s.keys
    out = []
    with serving(s) as srv:
        rng = np.random.default_rng(0)
        for i in range(12):
            kreq = keys[rng.integers(0, keys.size, 100)]
            got, found = srv.submit("read", kreq,
                                    tenant=f"t{i % 3}").result(timeout=60)
            assert found.all()
            np.testing.assert_array_equal(got, kreq * np.uint64(7))
            out.append(got)
        ok = srv.submit("insert", keys[:8],
                        keys[:8] ^ np.uint64(0xAB)).result(timeout=60)
        assert ok.all()
        got, found = srv.submit("read", keys[:8]).result(timeout=60)
        assert found.all()
        np.testing.assert_array_equal(got, keys[:8] ^ np.uint64(0xAB))
        fnd = srv.submit("delete", keys[:4]).result(timeout=60)
        assert fnd.all()
        got2, found2 = srv.submit("read", keys[:4]).result(timeout=60)
        assert not found2.any()
        res = srv.submit("scan", ranges=[(int(keys[10]), int(keys[20]))]
                         ).result(timeout=60)
        assert len(res) == 1 and len(res[0][0]) == 10  # [lo, hi)
        snap = s.OBS.snapshot()
        assert "serve.read.p99_ms" in snap
        assert snap["serve.served_ops"] > 0
        st = srv.stats()
        out += [ok, got, found, fnd, got2, found2, res,
                {k: st[k] for k in ("admitted_ops", "served_ops",
                                    "acked_writes", "rejects", "sealed",
                                    "retraces", "tenants")}]
    with pytest.raises(Exception) as ei:
        srv.submit("read", keys[:4])
    assert type(ei.value).__name__ == "StateError"
    return out, s.pool()


@pytest.mark.parametrize("nr", [1, 8])
def test_serve_reads_writes_scans(eight_devices, nr):
    kw = dict(nr=nr) if nr == 1 else dict(nr=nr, pages=1024, cap=256)
    (jo, jp), (po, pp) = (_basics(s) for s in pair(**kw))
    same(jo, po, "results")
    np.testing.assert_array_equal(jp, pp, err_msg="pools")


def test_serve_validates_requests():
    s = Side(False)
    keys = s.keys
    with serving(s) as srv:
        with pytest.raises(ConfigError):
            srv.submit("bogus", keys[:4])
        with pytest.raises(KeyRangeError):
            srv.submit("read", np.asarray([0], np.uint64))
        with pytest.raises(ConfigError):
            srv.submit("read", np.zeros(0, np.uint64))
        with pytest.raises(ConfigError):
            srv.submit("read", keys[: 513])  # wider than the ladder
        with pytest.raises(ConfigError):
            srv.submit("scan")
        with pytest.raises(ConfigError):
            srv.submit("insert", keys[:4], keys[:3])
        with pytest.raises(ConfigError):   # payloads need a value heap
            srv.submit("insert", keys[:1], payloads=[b"x"])


# -- admission: fair share, overload, brownout --------------------------------

def _fair(s):
    keys = s.keys
    srv = admission_only(s, max_queue_ops=1000)
    err = s.S.ServeOverloadError
    for _ in range(5):
        srv.submit("read", keys[:100], tenant="A")
    with pytest.raises(err):
        srv.submit("read", keys[:100], tenant="A")
    for _ in range(4):
        srv.submit("read", keys[:100], tenant="B")
    with pytest.raises(err):
        srv.submit("read", keys[:100], tenant="A")
    srv.submit("read", keys[:100], tenant="B")
    st = srv.stats()["tenants"]
    assert st["A"]["rejected_overload"] == 2
    assert st["B"]["rejected_overload"] == 0
    assert st["A"]["queued_ops"] == st["B"]["queued_ops"] == 500
    with pytest.raises(err):
        srv.submit("read", keys[:500], tenant="C")
    st = srv.stats()
    close(srv)
    return st["tenants"], st["rejects"], st["admitted_ops"]


def test_fair_share_admission_deterministic(eight_devices):
    j, p = pair()
    same(_fair(j), _fair(p))


def _brownout(s):
    keys, vals = s.keys, s.vals
    srv = admission_only(s, max_queue_ops=1000, brownout_hi=0.5,
                         brownout_lo=0.2)
    for t in ("A", "B"):
        for _ in range(3):
            srv.submit("read", keys[:100], tenant=t)
    assert srv._brownout
    with pytest.raises(s.S.ServeOverloadError):
        srv.submit("insert", keys[:10], vals[:10], tenant="C")
    srv.submit("read", keys[:100], tenant="A")
    took = []
    while srv._queued_ops > 100:
        got = srv._take(("read",), 200)
        took.append([(r.fut.tenant, r.fut.n_ops) for r in got])
        for r in got:
            r.fut._fail(StateError("drained by test"))
    assert not srv._brownout
    srv.submit("insert", keys[:10], vals[:10], tenant="C")
    st = srv.stats()
    close(srv)
    return took, st["tenants"], st["rejects"]


def test_brownout_sheds_writes_first(eight_devices):
    j, p = pair()
    same(_brownout(j), _brownout(p))


def _degraded_queued(s):
    keys, vals = s.keys, s.vals
    srv = admission_only(s)
    wfut = srv.submit("insert", keys[:10], vals[:10], tenant="A")
    rfut = srv.submit("read", keys[:10], tenant="A")
    s.eng.enter_degraded("test damage")
    try:
        srv._check_degraded_transition()
        with pytest.raises(s.B.DegradedError):
            wfut.result(timeout=5)
        assert not rfut.done()
        with pytest.raises(s.B.DegradedError):
            srv.submit("delete", keys[:5], tenant="A")
        srv.submit("read", keys[:5], tenant="A")
        st = srv.stats()
        assert st["rejects"]["degraded"] >= 2
    finally:
        s.eng.exit_degraded()
    close(srv)
    return st["tenants"], st["rejects"]


def test_degraded_sheds_queued_writes_keeps_reads(eight_devices):
    j, p = pair()
    same(_degraded_queued(j), _degraded_queued(p))


def _degraded_live(s):
    keys, vals = s.keys, s.vals
    with serving(s) as srv:
        s.eng.enter_degraded("live test damage")
        try:
            with pytest.raises(s.B.DegradedError):
                srv.submit("insert", keys[:4], vals[:4])
            got, found = srv.submit("read", keys[:20]).result(timeout=60)
            assert found.all()
            np.testing.assert_array_equal(got, keys[:20] * np.uint64(7))
        finally:
            s.eng.exit_degraded()
        return got, found, srv.stats()["rejects"]


def test_degraded_live_reads_still_serve(eight_devices):
    j, p = pair()
    same(_degraded_live(j), _degraded_live(p))


def test_greedy_tenant_capped_live():
    s = Side(False)
    keys = s.keys
    with serving(s, max_queue_ops=2048) as srv:
        stop = threading.Event()
        greedy_rejects = [0]

        def greedy():
            futs = []
            while not stop.is_set():
                try:
                    futs.append(srv.submit("read", keys[:256],
                                           tenant="greedy"))
                except PS.ServeOverloadError:
                    greedy_rejects[0] += 1
                    # yield the GIL a beat: the port's dispatcher makes
                    # many short torch calls a step, each of which takes
                    # the GIL back, so a client spinning on rejects in
                    # pure Python can stall it for whole scheduler slices
                    # on a loaded host
                    time.sleep(0.001)
                while len(futs) > 32:
                    futs.pop(0).result(timeout=60)
            for f in futs:
                f.result(timeout=60)

        th = threading.Thread(target=greedy, daemon=True)
        th.start()
        try:
            for _ in range(30):
                got, found = srv.submit("read", keys[:64],
                                        tenant="polite").result(timeout=60)
                assert found.all()
                np.testing.assert_array_equal(got, keys[:64]
                                              * np.uint64(7))
                time.sleep(0.002)
        finally:
            stop.set()
            th.join(timeout=60)
        st = srv.stats()["tenants"]
        assert greedy_rejects[0] > 0
        assert st["polite"]["rejected_overload"] == 0
        assert st["polite"]["served_ops"] == 30 * 64


def _weighted(s):
    keys = s.keys
    srv = admission_only(s, max_queue_ops=900,
                         tenant_weights={"gold": 2.0, "free": 1.0})
    err = s.S.ServeOverloadError
    for _ in range(6):
        srv.submit("read", keys[:100], tenant="gold")
    with pytest.raises(err):
        srv.submit("read", keys[:100], tenant="gold")
    for _ in range(3):
        srv.submit("read", keys[:100], tenant="free")
    with pytest.raises(err):
        srv.submit("read", keys[:100], tenant="free")
    st = srv.stats()["tenants"]
    assert st["gold"]["queued_ops"] == 600
    assert st["free"]["queued_ops"] == 300
    assert st["gold"]["weight"] == 2.0
    close(srv)
    return st


def test_weighted_fair_share_admission_2to1(eight_devices):
    j, p = pair()
    same(_weighted(j), _weighted(p))


# -- config parsing -----------------------------------------------------------

def _cfg_fields(c):
    return (c.widths, c.p99_targets_ms, c.max_queue_ops, c.group_commit_ms,
            c.write_lane, c.dedup_window, c.tenant_weights, c.ack_quorum,
            c.fusion, c.brownout_hi, c.brownout_lo, c.write_width)


def test_weighted_env_parsing(monkeypatch):
    monkeypatch.setenv("SHERMAN_SERVE_WEIGHTS", "gold:2,free:0.5")
    monkeypatch.setenv("SHERMAN_SERVE_DEDUP", "128")
    cfg = PS.ServeConfig.from_env()
    assert cfg.tenant_weights == {"gold": 2.0, "free": 0.5}
    assert cfg.dedup_window == 128
    same(_cfg_fields(cfg), _cfg_fields(JS.ServeConfig.from_env()))
    for bad in ("gold:-1", "nonsense"):
        monkeypatch.setenv("SHERMAN_SERVE_WEIGHTS", bad)
        with pytest.raises(ConfigError):
            PS.ServeConfig.from_env()
        with pytest.raises(JConfigError):
            JS.ServeConfig.from_env()


def test_serve_config_env_parsing(monkeypatch):
    monkeypatch.setenv("SHERMAN_SERVE_WIDTHS", "256,64,1024")
    monkeypatch.setenv("SHERMAN_SERVE_P99_MS", "read:5,insert:200")
    monkeypatch.setenv("SHERMAN_SERVE_QUEUE_OPS", "9999")
    monkeypatch.setenv("SHERMAN_SERVE_GROUP_COMMIT_MS", "3.5")
    monkeypatch.setenv("SHERMAN_SERVE_WRITE_LANE", "on")
    cfg = PS.ServeConfig.from_env()
    assert cfg.widths == (64, 256, 1024)
    assert cfg.p99_targets_ms["read"] == 5.0
    assert cfg.p99_targets_ms["insert"] == 200.0
    assert cfg.p99_targets_ms["delete"] == 50.0  # default fill-in
    assert cfg.max_queue_ops == 9999
    assert cfg.group_commit_ms == 3.5 and cfg.write_lane is True
    same(_cfg_fields(cfg), _cfg_fields(JS.ServeConfig.from_env()))
    monkeypatch.setenv("SHERMAN_SERVE_WIDTHS", "banana")
    with pytest.raises(ConfigError):
        PS.ServeConfig.from_env()
    monkeypatch.setenv("SHERMAN_SERVE_WIDTHS", "256")
    monkeypatch.setenv("SHERMAN_SERVE_P99_MS", "bogus:5")
    with pytest.raises(ConfigError):
        PS.ServeConfig.from_env()


def test_serve_config_defaults_match(monkeypatch):
    for v in ("SHERMAN_SERVE_WIDTHS", "SHERMAN_SERVE_P99_MS",
              "SHERMAN_SERVE_QUEUE_OPS", "SHERMAN_SERVE_GROUP_COMMIT_MS",
              "SHERMAN_SERVE_WEIGHTS", "SHERMAN_SERVE_DEDUP",
              "SHERMAN_SERVE_WRITE_LANE", "SHERMAN_ACK_QUORUM"):
        monkeypatch.delenv(v, raising=False)
    cfg = PS.ServeConfig.from_env()
    assert cfg.write_lane is False and cfg.ack_quorum == 1
    assert cfg.widths == (1024, 4096, 16384, 65536)
    same(_cfg_fields(cfg), _cfg_fields(JS.ServeConfig.from_env()))
    for bad in (dict(fusion="fused"), dict(brownout_lo=0.9,
                                           brownout_hi=0.5),
                dict(widths=(0,)), dict(quorum_timeout_ms=0.0),
                dict(ack_quorum=0)):
        with pytest.raises(ConfigError):
            PS.ServeConfig(**bad)


def test_serve_future_contract():
    f = PS.ServeFuture("read", "t", 4)
    assert not f.done()
    with pytest.raises(StateError):
        f.result(timeout=0.01)
    f._set(("x", "y"))
    assert f.done() and f.result() == ("x", "y")
    f2 = PS.ServeFuture("insert", "t", 1)
    f2._fail(PS.ServeOverloadError("nope"))
    with pytest.raises(PS.ServeOverloadError):
        f2.result()
    assert issubclass(PS.DeadlineExceededError, RuntimeError)
    assert PS.OP_CLASSES == JS.OP_CLASSES
    assert PS.__all__ == JS.__all__
