"""Partition drill: replication chaos, quorum acks, split-brain fencing
and anti-entropy repair (the port's counterpart of
``tools/partition_drill.py``; run it as ``python -m sherman_tpu_torch.bench
--partition-drill [--keys --nodes --replicas --seed --rounds --dir]``).

  phase 1  build and bulk-load the tree, arm the recovery plane, attach a
           ReplicaGroup of R followers and a seeded replication fault
           layer out of the ``FaultPlan`` grammar: drop, delay, reorder
           and slow windows at the shipping tail fire during the quorum
           rounds.
  phase A  primary-only acks (``ack_quorum=1``): exactly-once write rounds
           and a concurrent reader build the client ledger; the rounds'
           ack latency is the quorum comparison's baseline.
  quorum   a front door with ``ack_quorum=2``: every write ack waits for
           one follower watermark to cover its journal frontier; the
           latency delta is published.  Then a manual ship partition: the
           quorum wait expires bounded and typed (``QuorumTimeoutError``),
           and after the heal the same rid re-acks its original result
           (``fut.deduped``).
  repair   one follower's pool is corrupted by hand; an anti-entropy tick
           (full compare) detects it, quarantines the follower, re-ships
           it and re-admits it: ``diverged_followers_unrepaired == 0``.
  fence    split-brain: a lease-scope partition freezes the primary's view
           of the lease table, the group promotes (the fence point), and
           the stale primary keeps acking writes that land past the fence
           and never ship.  The heal fires the fence: its next write
           fails with ``StalePrimaryError``.
  resume   a new front door on the winner adopts the replayed window; the
           fenced suffix is counted and ``audit.check_fenced_rejected``
           pins ``fenced_acks_merged == 0``; the client re-drives the
           fenced writes with fresh rids.
  audit    every pre-fence ack is served (``lost_acks == 0``), pre-fence
           rids retried re-ack (``duplicate_acks == 0``), and the history
           checks linearizable.

Prints one JSON line ``{"metric": "partition_drill", "ok": true,
"lost_acks": 0, "duplicate_acks": 0, "linearizable": true,
"fenced_acks_merged": 0, "diverged_followers_unrepaired": 0, ...}`` and
mirrors it to ``SHERMAN_PARTITION_RECEIPT`` when set.  Runs on the card by
default; ``--device cpu`` rehearses it.  The keyspace and the audit's
initial state follow ``failover_drill.py`` (equal at small sizes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from sherman_tpu_torch.failover_drill import (Threads, build_cluster,
                                              drill_keyspace, initial_state)

SALT = 0xFA110FEB      # the bulk load's value stamp (key ^ SALT)
FENCE_STAMP = 0x0F3A   # the fenced writes' value generation
ROUND_KEYS = 48        # keys a write round


def _median_ms(samples: list) -> float:
    return round(float(np.median(np.asarray(samples))) * 1e3, 3) \
        if samples else 0.0


def _unwrap(e, cls):
    """Walk the cause chain for a typed error (lanes may wrap)."""
    tip = e
    while tip is not None:
        if isinstance(tip, cls):
            return tip
        tip = tip.__cause__
    return None


def run(a) -> dict:
    """The drill (module docstring); raises AssertionError on a failed
    pin.  -> the receipt."""
    from sherman_tpu_torch import audit as A
    from sherman_tpu_torch.chaos import FaultPlan
    from sherman_tpu_torch.errors import ShermanError
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.replica import (AntiEntropy, QuorumTimeoutError,
                                           ReplicaGroup, StalePrimaryError)
    from sherman_tpu_torch.serve import (RetryingClient, RetryPolicy,
                                         ServeConfig, ShermanServer)
    from sherman_tpu_torch.ycsb_bench import pages_for_keys

    t_start = time.time()
    walls: dict = {}
    out: dict = {"metric": "partition_drill", "seed": a.seed, "ok": False,
                 "nodes": a.nodes, "replicas": a.replicas, "keys": a.keys,
                 "rounds": a.rounds}
    root = a.dir or tempfile.mkdtemp(prefix="sherman_partition_")
    out["dir"] = root

    def lap(name: str, t: float) -> float:
        now = time.perf_counter()
        walls[name] = round(now - t, 3)
        return now

    # -- phase 1: primary, replica group, replication fault layer ----------
    t = time.perf_counter()
    ppn = pages_for_keys(a.keys)
    cluster, tree, eng = build_cluster(
        a.nodes, ppn, batch_per_node=512, device=a.device,
        locks_per_node=1024, chunk_pages=64)
    keys = drill_keyspace(a.keys)
    vals = keys ^ np.uint64(SALT)
    batched.bulk_load(tree, keys, vals)
    eng.attach_router()
    t = lap("build", t)
    plane = RecoveryPlane(cluster, tree, eng, os.path.join(root, "primary"),
                          group_commit_ms=2.0)
    plane.checkpoint_base()
    t = lap("base", t)
    group = ReplicaGroup(plane, a.replicas, cache_slots=2048)
    t = lap("group", t)

    # the ship-side windows fire during the quorum rounds (the
    # pump-while-waiting loop ticks replication time fast)
    plan = FaultPlan([
        {"kind": "repl_drop", "poll": 2, "span": 3},
        {"kind": "repl_delay", "poll": 8, "span": 2, "follower": 0},
        {"kind": "repl_reorder", "poll": 12, "span": 6},
        {"kind": "repl_slow", "poll": 20, "span": 2, "ms": 2.0},
    ], seed=a.seed)
    chaos = plan.repl_layer()
    group.attach_chaos(chaos)

    widths = (256 * a.nodes, 1024 * a.nodes)
    big = {c: 1e9 for c in ("read", "scan", "insert", "delete")}

    def front_door(engine, *, ack_quorum=1, with_group=False):
        cfg = ServeConfig(widths=widths, p99_targets_ms=dict(big),
                          write_linger_ms=0.5, write_width=2048,
                          group_commit_ms=2.0, ack_quorum=ack_quorum,
                          quorum_timeout_ms=1500.0)
        srv = ShermanServer(engine, cfg)
        if with_group:
            srv.attach_replica_group(group)
        absent = np.asarray([1 << 60], np.uint64)
        ck = keys[:256]
        cv, cf = engine.search(ck)
        srv.start(calib_keys=keys,
                  calib_writes=(ck[cf], np.asarray(cv)[cf]),
                  calib_delete_keys=absent)
        return srv

    # reserved slices: writers never collide, and the fenced slice is
    # untouched before the split-brain phase
    per = a.keys // 6
    w_slices = [keys[0:per], keys[per:2 * per]]       # phase A
    q_slice = keys[2 * per:3 * per]                   # quorum rounds
    f_slice = keys[3 * per:3 * per + 16]              # fenced writes
    untouched = keys[4 * per:]

    acked: dict = {}                 # key -> the last acked value (owed)
    rid_ledger: dict = {}            # rid -> (tenant, kreq, vreq, ok)
    events: list = []
    ev_lock = threading.Lock()

    def write_rounds(srv, tenant: str, my: np.ndarray, rounds: int,
                     gen0: int) -> list:
        """Paced exactly-once write rounds -> each round's ack seconds."""
        cl = RetryingClient(srv, tenant=tenant,
                            policy=RetryPolicy(max_attempts=6), seed=gen0)
        wrng = np.random.default_rng(gen0)
        lat = []
        for g in range(rounds):
            kreq = np.unique(my[wrng.integers(0, my.size, ROUND_KEYS)])
            vreq = kreq ^ np.uint64(SALT) ^ np.uint64((gen0 + g) << 8)
            rid = cl.next_rid()
            t_inv = time.perf_counter()
            ok = cl.insert(kreq, vreq, rid=rid)
            t_resp = time.perf_counter()
            lat.append(t_resp - t_inv)
            rid_ledger[rid] = (tenant, kreq, vreq, np.array(ok))
            with ev_lock:
                for k, v, o in zip(kreq.tolist(), vreq.tolist(),
                                   ok.tolist()):
                    if o:
                        acked[k] = v
                        events.append((k, A.OP_INSERT, t_inv, t_resp, v,
                                       True))
            group.pump()
        return lat

    # -- phase A: primary-only acks (the latency baseline) ------------------
    srv1 = front_door(eng)
    stop = threading.Event()

    def reader():
        cl = RetryingClient(srv1, tenant="reader",
                            policy=RetryPolicy(max_attempts=4),
                            seed=200, deadline_ms=5000.0)
        rrng = np.random.default_rng(50)
        pool = np.concatenate([w_slices[0], w_slices[1], untouched])
        while not stop.is_set():
            kreq = np.unique(pool[rrng.integers(0, pool.size, 64)])
            t_inv = time.perf_counter()
            try:
                got, found = cl.read(kreq)
            except ShermanError:
                continue
            t_resp = time.perf_counter()
            with ev_lock:
                for k, g, f in zip(kreq.tolist(), got.tolist(),
                                   found.tolist()):
                    events.append((k, A.OP_READ, t_inv, t_resp,
                                   g if f else None, bool(f)))
            time.sleep(0.002)

    pool = Threads()
    rd = pool.start(reader)
    lat_base = []
    for w, my in enumerate(w_slices):
        lat_base += write_rounds(srv1, f"writer{w}", my, a.rounds,
                                 gen0=1 + 100 * w)
    stop.set()
    pool.join([rd], timeout=60)
    srv1.drain()
    t = lap("primary_only", t)

    # -- quorum: ack_quorum=2 over the same ledger --------------------------
    srv_q = front_door(eng, ack_quorum=2, with_group=True)
    lat_q = write_rounds(srv_q, "writerq", q_slice, a.rounds, gen0=500)
    st = group.stats()
    assert st["quorum_acks"] > 0, "no write waited on a quorum"
    out["quorum_latency"] = {
        "p50_ms_primary_only": _median_ms(lat_base),
        "p50_ms_quorum": _median_ms(lat_q),
        "delta_ms": round(_median_ms(lat_q) - _median_ms(lat_base), 3),
    }

    # the bounded wait: a full ship partition expires the quorum, typed;
    # the heal and a same-rid retry re-ack through the dedup window
    chaos.hold("ship")
    kq = q_slice[:8]
    vq = kq ^ np.uint64(SALT) ^ np.uint64(0x9999 << 8)
    rid_q = (0x51 << 32) | 0x0001
    t0 = time.perf_counter()
    try:
        srv_q.submit("insert", kq, vq, tenant="writerq",
                     rid=rid_q).result(timeout=60)
        raise AssertionError("quorum wait under a full partition never "
                             "expired")
    except ShermanError as e:
        assert _unwrap(e, QuorumTimeoutError) is not None, \
            f"quorum expiry raised untyped {type(e).__name__}: {e}"
    waited_s = time.perf_counter() - t0
    assert waited_s < 10.0, "quorum wait was not bounded"
    out["quorum_timeout"] = {"typed": True,
                             "waited_ms": round(waited_s * 1e3, 1)}
    chaos.heal()
    fut = srv_q.submit("insert", kq, vq, tenant="writerq", rid=rid_q)
    ok_r = fut.result(timeout=60)
    assert fut.deduped, "quorum retry re-applied instead of re-acking"
    out["quorum_retry_deduped"] = True
    with ev_lock:
        t_now = time.perf_counter()
        for k, v, o in zip(kq.tolist(), vq.tolist(),
                           np.asarray(ok_r).tolist()):
            if o:
                acked[k] = v
                events.append((k, A.OP_INSERT, t0, t_now, v, True))
    group.pump()
    srv_q.drain()
    t = lap("quorum", t)

    # -- repair: detect -> quarantine -> re-ship -> re-admit ----------------
    victim = group.followers[-1]
    victim.cluster.dsm.pool[3, 5] = 0x7EA5
    ae = AntiEntropy(group, period_s=0, sample_rows=0, seed=a.seed)
    rc = ae.tick()
    out["anti_entropy"] = {
        "audits": ae.audits,
        "divergences": ae.divergences,
        "repairs": ae.repairs,
        "rejoin_catchup_ms": ae.last_repair_ms,
        "unrepaired": ae.unrepaired(),
        "round": rc,
    }
    assert ae.divergences >= 1, \
        "anti-entropy missed an injected follower divergence"
    assert ae.repairs >= 1 and ae.unrepaired() == 0, \
        "a diverged follower was not repaired and re-admitted"
    t = lap("repair", t)

    # -- fence: split-brain under a lease-scope partition -------------------
    srv3 = front_door(eng)
    chaos.hold("lease")
    # one write under the cut, before the promotion: the fence reads the
    # frozen lease view from here on (it is pre-fence: shipped, owed)
    k0 = f_slice[:4]
    v0 = k0 ^ np.uint64(SALT) ^ np.uint64(1 << 8)
    t_inv = time.perf_counter()
    ok0 = srv3.submit("insert", k0, v0, tenant="stale",
                      rid=(0xFE << 32) | 1).result(timeout=60)
    t_resp = time.perf_counter()
    with ev_lock:
        for k, v, o in zip(k0.tolist(), v0.tolist(),
                           np.asarray(ok0).tolist()):
            if o:
                acked[k] = v
                events.append((k, A.OP_INSERT, t_inv, t_resp, v, True))
    t_part = time.perf_counter()
    rcpt = group.promote(t_dead=t_part)
    out["promote"] = rcpt
    assert rcpt["fence"] is not None, "promotion captured no fence"

    # the stale primary keeps acking past the fence point
    fenced_pairs = []
    for j in range(4):
        kf = f_slice[4 + 3 * j: 7 + 3 * j]
        vf = kf ^ np.uint64(SALT) ^ np.uint64(FENCE_STAMP << 8)
        okf = srv3.submit("insert", kf, vf, tenant="stale",
                          rid=(0xFE << 32) | (10 + j)).result(timeout=60)
        for k, v, o in zip(kf.tolist(), vf.tolist(),
                           np.asarray(okf).tolist()):
            if o:
                fenced_pairs.append((k, v))
    assert fenced_pairs, "the stale primary acked nothing post-fence"
    out["stale_acks_post_fence"] = len(fenced_pairs)

    # the heal: the next fence check sees the live table
    chaos.heal()
    try:
        srv3.submit("insert", f_slice[:2], f_slice[:2] ^ np.uint64(1),
                    tenant="stale", rid=(0xFE << 32) | 99).result(timeout=60)
        raise AssertionError("stale-primary write after the heal was NOT "
                             "fenced")
    except ShermanError as e:
        assert _unwrap(e, StalePrimaryError) is not None, \
            f"fence raised untyped {type(e).__name__}: {e}"
    out["stale_rejected_typed"] = True
    srv3.kill()
    fenced_n = group.count_fenced_suffix()
    assert fenced_n > 0, "no fenced suffix behind the fence point"
    out["fenced_suffix_records"] = fenced_n
    t = lap("fence", t)

    # -- resume: the promoted front door and the fenced-merge probe ---------
    win = group.promoted
    plane2 = RecoveryPlane(win.cluster, win.tree, win.eng,
                           os.path.join(root, "promoted"),
                           group_commit_ms=2.0)
    plane2.checkpoint_base()
    t = lap("base2", t)
    srv2 = front_door(win.eng)
    adopted = srv2.seed_dedup(group.promoted_window())
    _g0, f0 = srv2.submit("read", keys[:64]).result(timeout=60)
    assert np.asarray(f0).all()
    out["availability_gap_ms"] = group.note_resumed()
    out["dedup"] = {"adopted": adopted}
    assert adopted > 0, "promotion adopted an empty dedup window"

    def read_all(ks: np.ndarray):
        wmax = max(widths)
        parts = [srv2.submit("read", ks[i:i + wmax]).result(timeout=120)
                 for i in range(0, ks.size, wmax)]
        return (np.concatenate([np.asarray(g) for g, _ in parts]),
                np.concatenate([np.asarray(f) for _, f in parts]))

    # no fenced (key, value) pair is visible before the re-drive
    probe = A.check_fenced_rejected(read_all, fenced_pairs)
    out["fenced_acks_merged"] = probe["merged"]
    assert probe["merged"] == 0, \
        f"fenced acks merged: {probe['violations'][:3]}"

    # the contract's second half: re-drive the fenced writes through the
    # new primary's window with fresh rids
    cl2 = RetryingClient(srv2, tenant="stale",
                         policy=RetryPolicy(max_attempts=6), seed=77)
    kf = np.asarray([k for k, _ in fenced_pairs], np.uint64)
    vf = np.asarray([v for _, v in fenced_pairs], np.uint64)
    t_inv = time.perf_counter()
    okr = cl2.insert(kf, vf, rid=cl2.next_rid())
    t_resp = time.perf_counter()
    with ev_lock:
        for k, v, o in zip(kf.tolist(), vf.tolist(),
                           np.asarray(okr).tolist()):
            if o:
                acked[k] = v
                events.append((k, A.OP_INSERT, t_inv, t_resp, v, True))
    out["redriven"] = int(np.asarray(okr).sum())
    assert out["redriven"] == len(fenced_pairs), \
        "re-drive through the new primary dropped writes"

    # -- lost acks: every owed ack served by the promoted primary -----------
    ak = np.asarray(sorted(acked), np.uint64)
    av = np.asarray([acked[int(k)] for k in ak], np.uint64)
    t_inv = time.perf_counter()
    got, found = read_all(ak)
    t_resp = time.perf_counter()
    lost = int((~found).sum()) + int((got[found] != av[found]).sum())
    with ev_lock:
        for k, g, f in zip(ak.tolist(), got.tolist(), found.tolist()):
            events.append((int(k), A.OP_READ, t_inv, t_resp,
                           int(g) if f else None, bool(f)))
    pr = untouched[:: max(1, untouched.size // 256)]
    gotp, foundp = read_all(pr)
    lost += int((~foundp).sum()) + int(
        (gotp[foundp] != (pr ^ np.uint64(SALT))[foundp]).sum())
    out["lost_acks"] = lost
    assert lost == 0, f"{lost} acked ops lost across the partition"

    # -- duplicate acks: pre-fence rids retried re-ack, never re-apply ------
    duplicate_acks = 0
    retried = 0
    for rid, (tenant, kreq, vreq, okl) in list(rid_ledger.items())[-6:]:
        if not okl.any():
            continue
        retried += 1
        fut = srv2.submit("insert", kreq, vreq, tenant=tenant, rid=rid)
        okr = fut.result(timeout=60)
        if not fut.deduped or not np.array_equal(okr, okl):
            duplicate_acks += 1
            continue
        got, found = srv2.submit("read", kreq).result(timeout=60)
        stomped = sum(
            1 for k, g, f in zip(kreq.tolist(), np.asarray(got).tolist(),
                                 np.asarray(found).tolist())
            if int(k) in acked and f and int(g) != acked[int(k)])
        if stomped:
            duplicate_acks += 1
    out["retried"] = retried
    out["duplicate_acks"] = duplicate_acks
    assert retried > 0, "drill retried nothing across the partition"
    assert duplicate_acks == 0, \
        f"{duplicate_acks} retried writes re-applied"
    srv2.drain()
    plane2.close()

    # -- offline linearizability over the surviving history -----------------
    verdict = A.check_events(events, initial=initial_state(events, SALT))
    out["audit"] = {
        "events": verdict["events"], "keys": verdict["keys"],
        "reads_checked": verdict["reads"],
        "violations": len(verdict["violations"]),
    }
    out["linearizable"] = bool(verdict["linearizable"])
    assert verdict["linearizable"], \
        f"history not linearizable: {verdict['violations'][:3]}"
    assert verdict["reads"] > 0, "audit checked no reads"
    jsonl = os.path.join(root, "history.jsonl")
    A.dump_jsonl(events, jsonl)
    out["history_jsonl"] = jsonl
    t = lap("audit", t)

    # -- the partition receipt ----------------------------------------------
    st = group.stats()
    out["repl"] = {
        "followers": st["followers"],
        "applied_records": st["applied_records"],
        "epoch": st["epoch"],
        "tail_stalls": st["tail_stalls"],
        "chaos_detected": st["chaos_detected"],
        "quarantined": st["quarantined"],
        "divergences": st["divergences"],
        "quorum": {
            "ack_quorum": 2,
            "acks": st["quorum_acks"],
            "timeouts": st["quorum_timeouts"],
            "wait_ms": st["quorum_wait_ms"],
            "p50_ms_primary_only":
                out["quorum_latency"]["p50_ms_primary_only"],
            "p50_ms_quorum": out["quorum_latency"]["p50_ms_quorum"],
            "delta_ms": out["quorum_latency"]["delta_ms"],
        },
    }
    out["diverged_followers_unrepaired"] = ae.unrepaired()
    out["chaos"] = {"injected": chaos.injected, "detected": chaos.detected,
                    "faults": chaos.describe()}
    assert chaos.injected >= 3, "the fault layer fired almost nothing"
    out["bootstrap_s"] = [f.bootstrap_s for f in group.followers]
    out["phase_s"] = walls
    out["elapsed_s"] = round(time.time() - t_start, 1)
    out["ok"] = True
    group.close()
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="partition drill of the PyTorch/CUDA port")
    p.add_argument("--keys", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_KEYS", 3000)))
    p.add_argument("--nodes", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_NODES", 1)))
    p.add_argument("--replicas", type=int,
                   default=int(os.environ.get("SHERMAN_REPL", 0) or 2))
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("SHERMAN_CHAOS_SEED", 11)))
    p.add_argument("--rounds", type=int, default=20,
                   help="write rounds a latency phase")
    p.add_argument("--dir", default=None,
                   help="drill directory (default: a temporary one)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for a rehearsal at a "
                        "small size")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    if torch.device(a.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("sherman_tpu_torch partition drill: no CUDA device; it runs "
              "on the GPU (--device cpu rehearses it)", file=sys.stderr)
        return 2
    out = run(a)
    line = json.dumps(out)
    print(line, flush=True)
    receipt = os.environ.get("SHERMAN_PARTITION_RECEIPT")
    if receipt:
        with open(receipt, "w") as f:
            f.write(line + "\n")
    print("PARTITION-DRILL PASS", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
