"""Port parity: the client-contract auditor (``sherman_tpu_torch/audit.py``)
against the JAX package, case by case after tests/test_audit.py: the
per-key linearizability checker (legal histories pass; duplicate-apply,
stale and phantom reads flag), the initial-state and open-write rules,
the recorder (sampling by key, the ring bound, the fixpoint cut, the
floor), the inline auditor (windows, carry, intents, drops, seeded
initial state, the ``audit.*`` collector), the JSONL artifact, the
fenced-ack check, and the end-to-end serve hooks on the port's engine
(a stomp behind the front door's back is flagged, a clean run is not,
and the inline cost stays under 2% of the serve wall).

Each unit case runs the same histories through both packages' modules
and their verdicts, violation lists, recorder drains and stats must be
equal (``JSONL`` artifacts byte for byte).  Every comparison is exact.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from sherman_tpu import audit as JA
from sherman_tpu import obs as JOBS
from sherman_tpu_torch import audit as A
from sherman_tpu_torch import obs as OBS
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.models import batched
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.serve import ServeConfig, ShermanServer

torch.set_num_threads(1)

R, I, D = A.OP_READ, A.OP_INSERT, A.OP_DELETE
MODS = ((JA, JOBS), (A, OBS))


def ev(key, op, t0, t1, val=None, found=True):
    return (key, op, t0, t1, val, found)


def both(fn):
    """``fn(audit module, obs module)`` on each package; the results must
    be equal.  -> the port's."""
    j, p = (fn(m, o) for m, o in MODS)
    assert j == p, (j, p)
    return p


def test_module_surface_matches():
    assert A.__all__ == JA.__all__
    assert (A.OP_READ, A.OP_INSERT, A.OP_DELETE) == \
        (JA.OP_READ, JA.OP_INSERT, JA.OP_DELETE)


# -- checker units -------------------------------------------------------------

def test_checker_legal_history_passes():
    evs = [
        ev(5, I, 0.0, 1.0, 100),
        ev(5, R, 0.5, 1.5, 100),        # concurrent with the write: ok
        ev(5, I, 2.0, 3.0, 200),
        ev(5, R, 3.5, 4.0, 200),
        ev(5, D, 5.0, 6.0),
        ev(5, R, 6.5, 7.0, None, found=False),
        ev(9, I, 0.0, 1.0, 7),          # second key: P-composition
        ev(9, R, 2.0, 3.0, 7),
    ]
    res = both(lambda m, o: m.check_events(evs))
    assert res["linearizable"] and res["keys"] == 2 and res["reads"] == 4


def test_checker_flags_duplicate_apply_as_stale_read():
    evs = [ev(5, I, 0.0, 1.0, 100), ev(5, I, 2.0, 3.0, 200),
           ev(5, R, 4.0, 5.0, 100)]
    res = both(lambda m, o: m.check_events(evs))
    assert not res["linearizable"]
    assert res["violations"][0]["kind"] == "stale_read"


def test_checker_flags_stale_and_phantom_reads():
    res = both(lambda m, o: m.check_events(
        [ev(5, I, 0.0, 1.0, 100), ev(5, R, 2.0, 3.0, None, found=False)]))
    assert not res["linearizable"]
    res2 = both(lambda m, o: m.check_events(
        [ev(5, I, 0.0, 1.0, 100), ev(5, R, 2.0, 3.0, 999)]))
    assert not res2["linearizable"]
    assert res2["violations"][0]["kind"] == "phantom_read"


@pytest.mark.parametrize("seen", [100, 200])
def test_checker_concurrent_write_read_both_legal(seen):
    base = [ev(5, I, 0.0, 1.0, 100), ev(5, I, 2.0, 4.0, 200)]
    res = both(lambda m, o: m.check_events(
        base + [ev(5, R, 3.0, 5.0, seen)]))
    assert res["linearizable"], (seen, res["violations"])
    res = both(lambda m, o: m.check_events(
        [ev(5, I, 0.0, 1.0, 100), ev(5, I, 2.0, 3.0, 200),
         ev(5, R, 3.5, 4.0, 100)]))
    assert not res["linearizable"]


def test_checker_initial_state_rules():
    assert both(lambda m, o: m.check_events(
        [ev(5, R, 0.0, 1.0, 42)]))["linearizable"]
    res = both(lambda m, o: m.check_events([ev(5, R, 0.0, 1.0, 42)],
                                           initial={5: (True, 41)}))
    assert not res["linearizable"]
    assert both(lambda m, o: m.check_events(
        [ev(5, R, 0.0, 1.0, 41)], initial={5: (True, 41)}))["linearizable"]
    res = both(lambda m, o: m.check_events(
        [ev(5, I, 0.0, 1.0, 100), ev(5, R, 2.0, 3.0, 41)],
        initial={5: (True, 41)}))
    assert not res["linearizable"]


def test_checker_open_writes_always_legal():
    evs = [ev(5, I, 0.0, 1.0, 100), ev(5, R, 2.0, 3.0, 777)]
    assert not both(lambda m, o: m.check_events(evs))["linearizable"]
    assert both(lambda m, o: m.check_events(
        evs, open_writes={5: [(True, 777)]}))["linearizable"]


def test_checker_fuzzed_histories_agree():
    """Random single-key histories (overlapping windows, deletes, equal
    values, a known or unknown initial state): the same verdicts and
    violation lists in both packages, key by key and composed."""
    rng = np.random.default_rng(11)
    for trial in range(60):
        evs = []
        for _ in range(int(rng.integers(2, 14))):
            k = int(rng.integers(1, 4))
            op = int(rng.choice([R, R, I, D]))
            t0 = float(rng.integers(0, 40))
            t1 = t0 + float(rng.integers(1, 8))
            val = int(rng.integers(1, 5))
            evs.append(ev(k, op, t0, t1, val if op != D else None,
                          bool(rng.random() < 0.8)))
        init = {1: (True, 1)} if trial % 2 else None
        both(lambda m, o: m.check_events(evs, initial=init))
        both(lambda m, o: m.check_key_history(
            [e for e in evs if e[0] == 1],
            initial=(True, 2) if trial % 3 else None,
            open_writes=[(True, 3)] if trial % 4 == 0 else ()))


def test_check_fenced_rejected():
    vals = {10: 1, 11: 2, 12: 3}

    def read_fn(keys):
        return (np.asarray([vals.get(int(k), 0) for k in keys], np.uint64),
                np.asarray([int(k) in vals for k in keys]))

    res = both(lambda m, o: m.check_fenced_rejected(
        read_fn, [(10, 1), (11, 9), (13, 4)]))
    assert res["fenced"] == 3 and res["merged"] == 1
    assert both(lambda m, o: m.check_fenced_rejected(read_fn, []))[
        "merged"] == 0


# -- recorder ------------------------------------------------------------------

def _sampling(m, o):
    rec = m.HistoryRecorder(capacity=1 << 12, sample_mod=4)
    keys = np.arange(1, 4097, dtype=np.uint64)
    m1 = rec.sample_mask(keys)
    np.testing.assert_array_equal(m1, rec.sample_mask(keys))
    assert 0.15 < m1.mean() < 0.35
    rec.observe(m.OP_INSERT, keys, 0.0, 1.0, values=keys)
    assert rec.events == int(m1.sum())
    return m1.tolist(), rec.events, rec.snapshot()


def test_recorder_sampling_is_by_key():
    both(_sampling)


def _ring(m, o):
    rec = m.HistoryRecorder(capacity=8, sample_mod=1)
    keys = np.arange(1, 13, dtype=np.uint64)
    ok = np.ones(12, bool)
    ok[0] = False
    rec.observe(m.OP_INSERT, keys, 0.0, 1.0, values=keys, ok=ok)
    assert rec.events == 11 and rec.dropped == 3
    drained, retained, dropped = rec.drain()
    assert len(drained) == 8 and dropped == 3
    return drained, retained, dropped


def test_recorder_ring_bound_and_ok_mask():
    both(_ring)
    with pytest.raises(ConfigError):
        A.HistoryRecorder(capacity=0)


def _fixpoint(m, o):
    rec = m.HistoryRecorder(sample_mod=1)
    k = np.asarray([5], np.uint64)
    rec.observe(m.OP_INSERT, k, 1.0, 2.0, values=np.asarray([100],
                                                          np.uint64))
    rec.observe(m.OP_READ, k, 3.0, 4.0, values=np.asarray([200], np.uint64),
                found=np.asarray([True]))
    rec.observe(m.OP_INSERT, k, 3.5, 6.0,
                values=np.asarray([200], np.uint64))
    rec.observe(m.OP_READ, k, 3.8, 7.0, values=np.asarray([200], np.uint64),
                found=np.asarray([True]))
    drained, retained, _ = rec.drain(before=5.0)
    assert [e[3] for e in drained] == [2.0]
    assert len(rec.snapshot()) == 3
    return drained, retained, rec.snapshot()


def test_recorder_fixpoint_cut_never_splits_overlap():
    both(_fixpoint)


def _floor(m, o):
    rec = m.HistoryRecorder(sample_mod=1)
    rec.observe(m.OP_INSERT, np.asarray([5], np.uint64), 1.0, 2.0,
                values=np.asarray([100], np.uint64))
    d1, _, _ = rec.drain(before=10.0, floor=1.5)
    assert d1 == []
    d2, _, _ = rec.drain(before=10.0)
    assert len(d2) == 1
    return d1, d2


def test_recorder_floor_holds_unrecorded_ops():
    both(_floor)


# -- the inline auditor --------------------------------------------------------

def _windows(m, o):
    aud = m.Auditor(sample_mod=1, interval_s=60.0)
    k = np.asarray([5], np.uint64)
    aud.observe_write(m.OP_INSERT, k, 0.0, 1.0,
                      values=np.asarray([100], np.uint64),
                      ok=np.asarray([True]))
    r1 = aud.tick(drain_all=True)
    assert r1["linearizable"] and aud.windows == 1
    aud.observe_read(k, np.asarray([100], np.uint64), np.asarray([True]),
                     2.0, 3.0)
    r2 = aud.tick(drain_all=True)
    assert r2["linearizable"]
    aud.observe_read(k, np.asarray([999], np.uint64), np.asarray([True]),
                     4.0, 5.0)
    r3 = aud.tick(drain_all=True)
    assert not r3["linearizable"] and aud.violations == 1
    snap = o.snapshot()
    assert snap.get("audit.violations", 0) >= 1
    assert snap.get("audit.windows", 0) >= 3
    st = aud.stats()
    assert st["linearizable"] is False
    drop = ("tick_ms", "cost_ms", "inline_cost_ms")
    return r1, r2, r3, {k: v for k, v in st.items() if k not in drop}


def test_auditor_windows_carry_and_collector():
    both(_windows)


def _intents(m, o):
    aud = m.Auditor(sample_mod=1, interval_s=60.0, horizon_s=0.0)
    k = np.asarray([5], np.uint64)
    t = time.perf_counter()
    tok = aud.begin_ops(t - 10.0)
    aud.observe_write(m.OP_INSERT, k, t - 9.0, t - 8.0,
                      values=np.asarray([100], np.uint64),
                      ok=np.asarray([True]))
    res = aud.tick()
    assert res["events"] == 0
    aud.end_ops(tok)
    res2 = aud.tick()
    assert res2["events"] == 1 and res2["linearizable"]
    return res["events"], res2["events"], res2["linearizable"]


def test_auditor_intents_pin_the_cut():
    both(_intents)


def _drops(m, o):
    aud = m.Auditor(sample_mod=1, capacity=4, interval_s=60.0)
    k = np.asarray([5], np.uint64)
    aud.observe_write(m.OP_INSERT, k, 0.0, 1.0,
                      values=np.asarray([100], np.uint64),
                      ok=np.asarray([True]))
    aud.tick(drain_all=True)
    keys = np.arange(10, 20, dtype=np.uint64)
    aud.observe_write(m.OP_INSERT, keys, 2.0, 3.0, values=keys,
                      ok=np.ones(10, bool))
    aud.tick(drain_all=True)
    assert aud.carry_resets == 1
    aud.observe_read(k, np.asarray([999], np.uint64), np.asarray([True]),
                     4.0, 5.0)
    res = aud.tick(drain_all=True)
    assert res["linearizable"]
    return aud.carry_resets, res


def test_auditor_drop_resets_carry():
    both(_drops)


def _seeded(m, o):
    aud = m.Auditor(sample_mod=1, interval_s=60.0)
    keys = np.asarray([5, 6], np.uint64)
    aud.seed_initial(keys, np.asarray([50, 60], np.uint64))
    aud.observe_read(keys, np.asarray([50, 61], np.uint64),
                     np.asarray([True, True]), 0.0, 1.0)
    res = aud.tick(drain_all=True)
    assert not res["linearizable"]
    assert res["violations"][0]["key"] == 6
    return res


def test_auditor_seed_initial_judges_prehistory_reads():
    both(_seeded)


def test_jsonl_round_trip(tmp_path):
    evs = [ev(5, I, 0.0, 1.0, 100), ev(5, R, 2.0, 3.0, 100),
           ev(5, D, 4.0, 5.0), ev(5, R, 6.0, 7.0, None, found=False)]
    arts = []
    for m, tag in ((JA, "jax"), (A, "port")):
        p = str(tmp_path / f"hist-{tag}.jsonl")
        assert m.dump_jsonl(evs, p) == 4
        with open(p, "rb") as f:
            arts.append(f.read())
        arts.append(p)
    assert arts[0] == arts[2], "JSONL artifacts differ"
    for m in (JA, A):            # each package reads both artifacts
        for p in (arts[1], arts[3]):
            res = m.check_jsonl(p)
            assert res["linearizable"] and res["events"] == 4
    p = str(tmp_path / "bad.jsonl")
    A.dump_jsonl(evs + [ev(5, R, 8.0, 9.0, 100)], p)
    assert not A.check_jsonl(p)["linearizable"]
    assert not JA.check_jsonl(p)["linearizable"]


# -- end to end through the port's front door ----------------------------------

def make_serving_stack(n=3000):
    cfg = DSMConfig(machine_nr=1, pages_per_node=2048, locks_per_node=512,
                    step_capacity=1024, chunk_pages=32, device="cpu")
    tree = Tree(Cluster(cfg))
    keys = np.arange(100, 100 + n * 3, 3, dtype=np.uint64)
    vals = keys * np.uint64(7)
    batched.bulk_load(tree, keys, vals)
    eng = batched.BatchedEngine(tree, batch_per_node=256,
                                tcfg=TreeConfig(sibling_chase_budget=2))
    eng.attach_router()
    return tree, eng, keys, vals


@contextlib.contextmanager
def serving(eng, keys, vals, auditor=None, **cfgkw):
    cfg = ServeConfig(widths=(128, 512),
                      p99_targets_ms={c: 10_000.0 for c in
                                      ("read", "scan", "insert",
                                       "delete")},
                      **cfgkw)
    srv = ShermanServer(eng, cfg, auditor=auditor)
    try:
        srv.start(calib_keys=keys, calib_writes=(keys[:64], vals[:64]),
                  calib_delete_keys=np.asarray([5], np.uint64))
        yield srv
    finally:
        srv.stop()


def test_auditor_end_to_end_clean_and_stomp_flagged():
    """A clean serving run checks clean; a duplicate apply injected
    behind the front door's back (an older value re-applied through the
    raw engine) flags the next read's history."""
    tree, eng, keys, vals = make_serving_stack()
    aud = A.Auditor(sample_mod=1, interval_s=60.0)
    aud.seed_initial(keys, vals)
    with serving(eng, keys, vals, auditor=aud) as srv:
        k8 = keys[:8]
        srv.submit("insert", k8, k8 ^ np.uint64(0xA1),
                   rid=1).result(timeout=60)
        got, found = srv.submit("read", k8).result(timeout=60)
        assert found.all()
        res = aud.tick(drain_all=True)
        assert res["linearizable"], res["violations"][:2]
        v0 = aud.violations
        srv.submit("insert", k8, k8 ^ np.uint64(0xB2),
                   rid=2).result(timeout=60)
        eng.insert(k8, k8 ^ np.uint64(0xA1))  # the seeded fault
        got, found = srv.submit("read", k8).result(timeout=60)
        np.testing.assert_array_equal(got, k8 ^ np.uint64(0xA1))
        res = aud.tick(drain_all=True)
        assert not res["linearizable"], \
            "auditor missed a seeded duplicate apply"
        assert aud.violations > v0
        kinds = {v["kind"] for v in res["violations"]}
        assert kinds <= {"stale_read", "phantom_read"}
        assert srv.stats()["audit"]["violations"] == aud.violations


def test_auditor_inline_cost_under_2pct():
    """The auditor's self-timed inline observe cost stays under 2% of
    the serve wall with full (sample_mod=1) recording."""
    tree, eng, keys, vals = make_serving_stack()
    aud = A.Auditor(sample_mod=1, interval_s=60.0)
    with serving(eng, keys, vals, auditor=aud,
                 max_queue_ops=16384) as srv:
        rng = np.random.default_rng(5)
        t0 = time.perf_counter()
        futs = []
        for i in range(24):
            futs.append(srv.submit("read",
                                   keys[rng.integers(0, keys.size, 128)]))
            if i % 6 == 0:
                futs.append(srv.submit(
                    "insert", keys[i * 16:(i + 1) * 16],
                    keys[i * 16:(i + 1) * 16] ^ np.uint64(3),
                    rid=100 + i))
        for f in futs:
            f.result(timeout=60)
        wall = time.perf_counter() - t0
    assert aud.rec.events > 0
    frac = aud.cost_frac(wall)
    assert frac < 0.02, f"inline auditor cost {frac:.4f} of serve wall"
