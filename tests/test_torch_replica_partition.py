"""Port parity, continued from tests/test_torch_replica.py: the partition
plane of ``sherman_tpu_torch/replica.py`` (quorum waits, the stall
watchdog, the replication fault layer through the pump, anti-entropy with
its full and sampled compares, the split-brain fence point and its
suffix), the fenced-merge probe, and a port group tailing a JAX primary's
live directory, at one node and at eight, against the JAX package.
Errors of the background threads reach the caller with their own type.
The helpers and the comparison rules are test_torch_replica.py's.
"""

import os
import time

import numpy as np
import pytest
import torch

from sherman_tpu import audit as JA
from sherman_tpu import config as JC
from sherman_tpu import replica as JRP
from sherman_tpu.utils import journal as JJ
from sherman_tpu_torch import audit as A
from sherman_tpu_torch import config as C
from sherman_tpu_torch import replica as RP

from test_torch_replica import (NODES, SALT, Side, _norm, both, group_state,
                                npool, outcome, same)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The partition plane: quorum acks, the stall watchdog, the replication
# fault layer, anti-entropy, split-brain fencing.
# ---------------------------------------------------------------------------

def test_partition_knobs(monkeypatch):
    for name, knob in (("SHERMAN_ACK_QUORUM", "ack_quorum"),
                       ("SHERMAN_TAIL_WAIT_S", "tail_wait_s"),
                       ("SHERMAN_ANTI_ENTROPY_S", "anti_entropy_s")):
        monkeypatch.delenv(name, raising=False)
        assert getattr(C, knob)() == getattr(JC, knob)()
        for v in ("", "0", "1", "false", "off", "no", "3", "0.25", "2.5",
                  "lots", "soon", "-1", "-2"):
            monkeypatch.setenv(name, v)
            assert outcome(getattr(C, knob)) \
                == outcome(getattr(JC, knob)), (name, v)
    for name in ("SHERMAN_ACK_QUORUM", "SHERMAN_TAIL_WAIT_S",
                 "SHERMAN_ANTI_ENTROPY_S"):
        monkeypatch.delenv(name)
    assert (C.ack_quorum(), C.tail_wait_s(), C.anti_entropy_s()) \
        == (1, 5.0, 0.0)


def _quorum(s, d):
    keys, vals = s.primary(d, n=300)
    group = s.RP.ReplicaGroup(s.plane, 1)
    f = group.followers[0]
    s.eng.insert(keys[:32], vals[:32] ^ np.uint64(0x5))
    tok = group.quorum_token()
    out = [os.path.basename(tok[0]).replace(s.plane.cid, "CID"), tok[1],
           f.tailer.covers(*tok)]
    rc = group.wait_quorum(1, timeout_s=30.0, token=tok)
    assert rc["waited_ms"] >= 0.0
    out += [rc["needed"], rc["covered"], f.tailer.covers(*tok),
            f.tailer.covers(tok[0], tok[1] + 10),
            f.tailer.covers(tok[0].replace("-000001", "-000000"), 1),
            group.quorum_acks,
            outcome(lambda: group.wait_quorum(2)),
            group.wait_quorum(0)["covered"]]
    chaos = s.CH.ReplChaos([], seed=0)
    group.attach_chaos(chaos)
    chaos.hold("ship")
    s.eng.insert(keys[32:48], vals[32:48])
    out += [outcome(lambda: group.wait_quorum(1, timeout_s=0.2)),
            group.quorum_timeouts]
    chaos.heal()
    out.append(group.wait_quorum(1, timeout_s=30.0)["covered"])
    f.quarantined = True
    out.append(outcome(lambda: group.wait_quorum(1, timeout_s=0.2)))
    f.quarantined = False
    out.append(group_state(s, group))
    s.plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_quorum_covers_and_wait(eight_devices, tmp_path, n):
    j, p = both(_quorum, tmp_path, n=n)
    same(j, p)
    assert p[2] is False and p[4] == 1 and p[5] is True and p[6] is False
    assert p[9] == ("raised", "ConfigError")
    assert p[11] == ("raised", "QuorumTimeoutError") and p[12] == 1
    assert p[14] == ("raised", "QuorumTimeoutError")


def _watchdog(s, d):
    keys, vals = s.primary(d, n=300)
    s.eng.insert(keys[:16], vals[:16])
    rec = s.J.encode_record(s.J.J_UPSERT, np.asarray([1 << 40], np.uint64),
                            np.asarray([7], np.uint64), rid=0xDEAD)
    with open(s.eng.journal.path, "ab") as fh:
        fh.write(rec[: len(rec) // 2])
    t = s.RP.JournalTailer(s.plane.dir, s.plane.cid)
    t.tail_wait_s = 0.05
    out = [len(t.poll())]
    time.sleep(0.1)
    out += [outcome(t.poll), t.stalls]
    t2 = s.RP.JournalTailer(s.plane.dir, s.plane.cid)
    t2.tail_wait_s = 0.05
    t2.lease_probe = lambda: True
    t2.poll()
    time.sleep(0.1)
    t2.poll()
    t2.poll()
    out += [t2.stalls, t2._stall_evented, t2.torn_waits]
    s.plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_tail_watchdog_stalled_typed(eight_devices, tmp_path, n):
    """A torn tail stuck past the watchdog budget: with no live lease a
    typed TailStalledError; with one the wait goes on, evented once."""
    j, p = both(_watchdog, tmp_path, n=n)
    assert p == j
    assert p[:3] == [1, ("raised", "TailStalledError"), 1]
    assert p[3] == 0 and p[4] is True


def _chaos_pump(s, d):
    keys, vals = s.primary(d, n=300)
    group = s.RP.ReplicaGroup(s.plane, 1)
    f = group.followers[0]
    chaos = s.CH.ReplChaos([
        s.CH.ReplFault(kind="repl_drop", poll=0, span=1),
        s.CH.ReplFault(kind="repl_reorder", poll=1, span=1),
    ], seed=3)
    group.attach_chaos(chaos)
    s.eng.insert(keys[:48], vals[:48] ^ np.uint64(0x11))
    out = [group.pump(), f.caught_up, f.tailer.last_poll_cut,
           group.pump(), f.chaos_detected, chaos.detected, f.caught_up,
           group.pump(), f.caught_up, chaos.exhausted,
           f.eng.search(keys[:48]), group_state(s, group)]
    s.plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_repl_chaos_detection_through_pump(eight_devices, tmp_path, n):
    """A dropped poll loses the fetch, a reordered view is refused by the
    CRC and counted, the clean retry converges; equal to JAX's."""
    j, p = both(_chaos_pump, tmp_path, n=n)
    same(j, p)
    assert p[:10] == [0, False, True, 0, 1, 1, False, 1, True, True]


def _ae(s, d):
    keys, vals = s.primary(d, n=300)
    group = s.RP.ReplicaGroup(s.plane, 2, cache_slots=256)
    s.eng.insert(keys[:64], vals[:64] ^ np.uint64(0x21))
    group.pump()
    ae = s.RP.AntiEntropy(group, period_s=0, sample_rows=0)
    assert group.anti_entropy is ae
    out = [_norm(ae.tick(), ())]
    victim = group.followers[1]
    if s.jax:
        import jax
        fdsm = victim.cluster.dsm
        fdsm.pool = jax.device_put(
            fdsm.pool.at[5, 3].set(np.int32(0x0BAD)), fdsm.shard)
    else:
        victim.cluster.dsm.pool[5, 3] = 0x0BAD
    rc = ae.tick()
    assert rc["followers"][1]["repair"]["catchup_ms"] > 0
    out += [_norm(rc, ()), (ae.audits, ae.divergences, ae.repairs,
                            ae.unrepaired(), victim.quarantined)]
    np.testing.assert_array_equal(npool(s.jax, s.cluster),
                                  npool(s.jax, victim.cluster))
    victim.pump()
    victim.quarantined = True
    out.append(victim.serve_read(keys[:8]))
    victim.quarantined = False
    out.append(victim.serve_read(keys[:8]) is not None)
    out.append(group_state(s, group))
    s.plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_anti_entropy_detect_quarantine_repair(eight_devices, tmp_path, n):
    """A corrupted follower pool: the audit (the full compare, on the
    device in the port) detects it, quarantines the follower, re-ships it
    and re-admits it; verdicts, counters and pools equal JAX's."""
    j, p = both(_ae, tmp_path, n=n)
    same(j, p)
    assert not p[0]["followers"][0]["diverged"]
    assert p[1]["followers"][1]["diverged"]
    assert p[1]["followers"][1]["repair"]["ok"]
    assert p[2] == (4, 1, 1, 0, False) and p[3] is None and p[4]


def _sampled(s, d):
    """The sampled compare draws its rows from the reference's RNG in its
    order: the verdicts over a corrupted row match round by round."""
    keys, vals = s.primary(d, n=300)
    group = s.RP.ReplicaGroup(s.plane, 1)
    f = group.followers[0]
    group.pump()
    rows = f.cluster.dsm.pool.shape[0]
    out = []
    for k in (0, 4, 64, rows):
        ae = s.RP.AntiEntropy(group, period_s=0, sample_rows=k, seed=9)
        out.append([ae._pages_equal(f, full=False) for _ in range(3)])
    if s.jax:
        import jax
        fdsm = f.cluster.dsm
        fdsm.pool = jax.device_put(
            fdsm.pool.at[rows // 3, 7].set(np.int32(0x5A5A)), fdsm.shard)
    else:
        f.cluster.dsm.pool[rows // 3, 7] = 0x5A5A
    for k in (0, 4, 64, rows):
        ae = s.RP.AntiEntropy(group, period_s=0, sample_rows=k, seed=9)
        out.append([ae._pages_equal(f, full=False) for _ in range(40)]
                   + [ae._pages_equal(f, full=True)])
    s.plane.close()
    return out


@pytest.mark.parametrize("n", NODES)
def test_anti_entropy_sampled_compare_matches_jax(eight_devices, tmp_path,
                                                  n):
    j, p = both(_sampled, tmp_path, n=n)
    assert p == j
    assert all(all(r) for r in p[:4])
    assert not any(p[4]) and not any(p[7])


@pytest.mark.parametrize("n", NODES)
def test_anti_entropy_background_cadence(eight_devices, tmp_path, n):
    s = Side(False, n=n)
    s.primary(tmp_path, n=200)
    group = RP.ReplicaGroup(s.plane, 1)
    ae = RP.AntiEntropy(group, period_s=0.05, sample_rows=8)
    ae.start()
    deadline = time.monotonic() + 10.0
    while ae.audits == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    ae.stop()
    assert ae.audits >= 1 and ae.divergences == 0
    ae2 = RP.AntiEntropy(group, period_s=0)
    ae2.start()
    assert ae2._thread is None
    group.close()
    s.plane.close()


def test_background_errors_reach_the_caller(tmp_path, monkeypatch):
    """An error on the pump thread or the audit thread stops it and is
    raised, with its own type, by the next ``pump``/``promote`` or
    ``tick`` (a CUDA launch error on a worker thread is not lost)."""
    s = Side(False)
    keys, vals = s.primary(tmp_path, n=200)
    group = RP.ReplicaGroup(s.plane, 1, poll_ms=1.0)
    f = group.followers[0]

    class Boom(RuntimeError):
        pass

    def boom(final=False):
        raise Boom("launch failed")

    monkeypatch.setattr(f, "pump", boom)
    group.start()
    deadline = time.monotonic() + 10.0
    while group.tail_error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    group.stop()
    with pytest.raises(Boom):
        group.pump()
    monkeypatch.undo()
    assert group.pump() == 0            # raised once, then clear
    ae = RP.AntiEntropy(group, period_s=0.02)
    monkeypatch.setattr(ae, "_audit_one", lambda f: (_ for _ in ()).throw(
        Boom("audit failed")))
    ae.start()
    deadline = time.monotonic() + 10.0
    while ae.error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    ae.stop()
    monkeypatch.undo()
    with pytest.raises(Boom):
        ae.tick()
    assert ae.tick()["quarantined"] == 0
    group.close()
    s.plane.close()


def _split_brain(s, d):
    keys, vals = s.primary(d, n=300)
    group = s.RP.ReplicaGroup(s.plane, 1)
    chaos = s.CH.ReplChaos([], seed=0)
    group.attach_chaos(chaos)
    s.eng.insert(keys[:32], vals[:32] ^ np.uint64(0x31))
    group.pump()
    chaos.hold("lease")
    s.eng.insert(keys[32:40], vals[32:40] ^ np.uint64(0x32))
    rcpt = group.promote()
    s.eng.insert(keys[40:48], vals[40:48] ^ np.uint64(0xFE))
    s.eng.insert(keys[48:56], vals[48:56] ^ np.uint64(0xFE))
    win = group.promoted
    out = [_norm(rcpt, (s.plane.cid,)), group.fenced_writes,
           win.eng.search(keys[32:40]), win.eng.search(keys[40:56])]
    chaos.heal()
    out += [outcome(lambda: s.eng.insert(keys[56:58], vals[56:58])),
            group.fenced_writes, group.count_fenced_suffix(),
            group_state(s, group), npool(s.jax, s.cluster)]
    s.plane.close()
    return out, keys


@pytest.mark.parametrize("n", NODES)
def test_split_brain_fence_point_and_suffix(eight_devices, tmp_path, n):
    """A lease-scope partition: the promotion's fence point, the stale
    primary acking past it (never shipped), the typed fence after the
    heal and the suffix count, all equal to JAX's."""
    (j, keys), (p, _) = both(_split_brain, tmp_path, n=n)
    same(j, p)
    assert p[0]["fence"] is not None and p[1] == 0
    got, found = p[3]
    np.testing.assert_array_equal(
        got[found], (keys[40:56] ^ np.uint64(SALT))[found])
    assert p[4] == ("raised", "StalePrimaryError") and p[5] >= 1
    assert p[6] > 0 and p[7]["stats"]["fenced_suffix_records"] == p[6]


def test_fenced_probe_counts_merges():
    """audit.check_fenced_rejected: a fenced pair counts as merged only
    when visible verbatim; equal to the JAX auditor's verdicts."""
    state = {10: 111, 11: 222}

    def read_fn(ks):
        vals = np.asarray([state.get(int(k), 0) for k in ks], np.uint64)
        found = np.asarray([int(k) in state for k in ks], bool)
        return vals, found

    for fenced in ([], [(10, 999), (11, 222), (12, 5)],
                   [(10, 111), (11, 222)]):
        r = A.check_fenced_rejected(read_fn, fenced)
        assert r == JA.check_fenced_rejected(read_fn, fenced)
    r = A.check_fenced_rejected(read_fn, [(10, 999), (11, 222), (12, 5)])
    assert r["fenced"] == 3 and r["merged"] == 1
    assert r["violations"] == [{"key": 11, "fenced_value": 222,
                                "kind": "fenced_ack_merged"}]


# ---------------------------------------------------------------------------
# Across packages: a port group tails a JAX primary's live directory.
# ---------------------------------------------------------------------------

class _PortView:
    """The port's handle on a JAX primary's recovery directory: the chain
    the group discovers and tails, the frontier it reads, and a port
    cluster and engine for the lease and the (unused) fence."""

    def __init__(self, jplane, cluster, eng):
        self._j = jplane
        self.dir = jplane.dir
        self.cluster = cluster
        self.eng = eng

    @property
    def cid(self):
        return self._j.cid

    def journal_frontier(self):
        return self._j.journal_frontier()


@pytest.mark.parametrize("n", NODES)
def test_port_group_tails_a_jax_primary(eight_devices, tmp_path, n):
    """A JAX primary writes upserts, deletes, acks, a sweeping delta and a
    rotation; a port ReplicaGroup over its live directory and a JAX
    group over the same directory pump in lockstep and end with equal
    follower pools, windows, watermarks and counters (the journal and the
    chain are byte-compatible)."""
    js = Side(True, n=n)
    keys, vals = js.primary(tmp_path, n=400)
    shadow = Side(False, n=n)
    view = _PortView(js.plane, shadow.cluster, shadow.eng)
    jg = JRP.ReplicaGroup(js.plane, 2, cache_slots=256,
                          directory=str(tmp_path / "jreplicas"))
    pg = RP.ReplicaGroup(view, 2, cache_slots=256,
                         directory=str(tmp_path / "preplicas"))
    jside = Side.__new__(Side)
    jside.jax = True
    pside = Side.__new__(Side)
    pside.jax = False

    def step(tag):
        a, b = jg.pump(), pg.pump()
        assert a == b, tag
        same(group_state(jside, jg), group_state(pside, pg), tag)

    step("bootstrap")
    js.eng.insert(keys[:64], vals[:64] ^ np.uint64(0x41))
    js.eng.delete(keys[64:72])
    okv = np.asarray([True, True, False])
    js.eng.journal.append_acks([(5, "t", JJ.J_UPSERT, okv),
                                (5, "u", JJ.J_DELETE, okv)])
    step("ship")
    js.plane.checkpoint_delta()
    js.eng.insert(keys[140:160], vals[140:160] ^ np.uint64(0x43))
    step("sweep")
    assert all(f.rebootstraps == 1 for f in pg.followers)
    js.plane._rotate_journal(js.plane._segment + 1)
    js.eng.insert(keys[100:140], vals[100:140] ^ np.uint64(0x42))
    step("rotation")
    assert all(f.rebootstraps == 1 for f in pg.followers)
    np.testing.assert_array_equal(pg.followers[0].cluster.dsm.pool.numpy(),
                                  np.asarray(js.cluster.dsm.pool))
    for f in pg.followers:
        f.admit(keys[:32])
    for f in jg.followers:
        f.admit(keys[:32])
    same(jg.read(keys[:48]), pg.read(keys[:48], forward=js.eng.search))
    assert pg.reads_served == jg.reads_served > 0
    jg.close()
    pg.close()
    js.plane.close()
