"""Client-contract drill: exactly-once, deadlines and linearizability across
chaos, a cold crash, recovery and a migration (the port's counterpart of
``tools/contract_drill.py``; run it as ``python -m sherman_tpu_torch.bench
--contract-drill [--keys --nodes --target-nodes --seed --secs --dir
--device]``).

  phase 1  build and bulk-load an N-node cluster, arm the recovery plane
           (base checkpoint + journal with request ids), start the front
           door with the exactly-once window, deadlines and the inline
           sampling auditor (``audit.py``), sealed after calibration.
  phase A  ``serve.RetryingClient`` writers and readers drive reads and
           exactly-once inserts through the absorbable chaos storm
           (wedged locks and dropped CAS winners, revoked or retried,
           never a wrong answer), a delta checkpoint mid-stream (the
           rotation carries the ack window forward) and a deadline burst
           (every shed request fails typed).  Every client records its
           (key, op, invoke, respond) history.  Zero retraces in the clean
           window.
  crash    the server is killed mid-traffic (no drain) and the journal's
           tail is torn (half a record).
  recover  ``RecoveryPlane.recover`` rebuilds the state (RPO 0) and the
           exactly-once window (``plane.dedup_window``), adopted by a
           fresh front door through ``seed_dedup``.
  retry    sampled pre-crash rids: the keys are first re-written with
           fresh rids, then the old rids are retried with their original
           payloads: the window re-acks the original result and the state
           keeps the new values (``duplicate_acks == 0``).
  migrate  a live migration to M nodes under fresh traffic, its cutover
           image restored: every acked write is served (``lost_acks ==
           0``).
  audit    the combined client history is checked offline per key
           (``linearizable``), and the inline auditor's cost fraction is
           held under 2% of the serve wall.

Prints one JSON line ``{"metric": "contract_drill", "ok": true,
"duplicate_acks": 0, "lost_acks": 0, "rpo_ops": 0, "linearizable": true,
...}`` and mirrors it to ``SHERMAN_CONTRACT_RECEIPT`` when set.  Runs on
the card by default; ``--device cpu`` rehearses it at a small size.

Differences from the reference that only size forces (equal at its
default sizes): the keyspace is the reference's draw deduplicated by one
sort, the untouched-key probe masks by ``searchsorted``, and the audit's
initial state covers the keys the history touches.
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

from sherman_tpu_torch.failover_drill import (Threads, _mem, build_cluster,
                                              drill_keyspace, in_sorted,
                                              initial_state)
from sherman_tpu_torch.reshard_drill import BatchMeter

SALT = 0xC0117AC7  # the bulk load's value stamp (key ^ SALT)


def run(a) -> dict:
    """The drill (module docstring); raises AssertionError on a failed
    pin.  -> the receipt."""
    from sherman_tpu_torch import audit as A
    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.config import TreeConfig
    from sherman_tpu_torch.errors import ShermanError
    from sherman_tpu_torch.migrate import Migrator
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.batched import DegradedError
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.models.validate import check_structure_device
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.serve import (DeadlineExceededError,
                                         RetryingClient, RetryPolicy,
                                         ServeConfig, ShermanServer)
    from sherman_tpu_torch.utils import checkpoint as CK
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.ycsb_bench import pages_for_keys

    t_start = time.time()
    walls: dict = {}
    out: dict = {"metric": "contract_drill", "seed": a.seed, "ok": False,
                 "nodes": a.nodes, "target_nodes": a.target_nodes,
                 "keys": a.keys, "secs": a.secs}
    root = a.dir or tempfile.mkdtemp(prefix="sherman_contract_")
    rdir = os.path.join(root, "recovery")
    mdir = os.path.join(root, "migration")
    out["dir"] = root

    def lap(name: str, t: float) -> float:
        now = time.perf_counter()
        walls[name] = round(now - t, 3)
        return now

    # -- phase 1: build, the recovery plane, the audited front door ---------
    t = time.perf_counter()
    ppn = pages_for_keys(a.keys)
    cluster, tree, eng = build_cluster(
        a.nodes, ppn, batch_per_node=512, device=a.device,
        locks_per_node=1024, chunk_pages=64)
    keys = drill_keyspace(a.keys)
    vals = keys ^ np.uint64(SALT)
    batched.bulk_load(tree, keys, vals)
    eng.attach_router()
    check_structure_device(tree)
    t = lap("build", t)
    mem = {"built": _mem(a.device)}
    plane = RecoveryPlane(cluster, tree, eng, rdir, group_commit_ms=2.0)
    plane.checkpoint_base()
    t = lap("base", t)

    widths = (256 * a.nodes, 1024 * a.nodes)
    big = {c: 1e9 for c in ("read", "scan", "insert", "delete")}

    def front_door(engine, auditor=None):
        cfg = ServeConfig(widths=widths, p99_targets_ms=dict(big),
                          write_linger_ms=0.5, write_width=2048,
                          group_commit_ms=2.0)
        srv = ShermanServer(engine, cfg, auditor=auditor)
        absent = np.asarray([1 << 60], np.uint64)
        # value-preserving calibration writes: a recovered engine already
        # holds acked post-bulk writes
        ck = keys[:256]
        cv, cf = engine.search(ck)
        srv.start(calib_keys=keys,
                  calib_writes=(ck[cf], np.asarray(cv)[cf]),
                  calib_delete_keys=absent)
        return srv

    aud = A.Auditor(sample_mod=4, interval_s=0.1)
    aud.seed_initial(keys, vals)
    srv = front_door(eng, auditor=aud)
    snap0 = obs.snapshot()
    t = lap("front_door", t)

    n_writers, n_readers = 2, 2
    per = a.keys // (n_writers + 1)
    acked: list[dict] = [dict() for _ in range(n_writers)]
    # submitted but unacked (in flight at the crash): legal values for the
    # offline check's open writes
    unacked: list[dict] = [dict() for _ in range(n_writers)]
    rid_ledger: list[dict] = [dict() for _ in range(n_writers)]
    events: list[list] = [[] for _ in range(n_writers + n_readers)]
    cstats = {"read_reqs": 0, "write_reqs": 0, "rejects": 0,
              "hedges": 0, "retries": 0, "inflight_failures": 0}
    stats_lock = threading.Lock()
    stop = threading.Event()

    def writer(w: int):
        my = keys[w * per:(w + 1) * per]
        cl = RetryingClient(srv, tenant=f"writer{w}",
                            policy=RetryPolicy(max_attempts=6),
                            seed=100 + w)
        ev = events[w]
        wrng = np.random.default_rng(w)
        gen = 0
        while not stop.is_set():
            gen += 1
            kreq = np.unique(my[wrng.integers(0, my.size, 96)])
            vreq = kreq ^ np.uint64(SALT) ^ np.uint64(gen << 8)
            rid = cl.next_rid()
            t_inv = time.perf_counter()
            try:
                ok = cl.insert(kreq, vreq, rid=rid)
            except ShermanError:
                for k, v in zip(kreq.tolist(), vreq.tolist()):
                    unacked[w].setdefault(k, []).append((True, v))
                continue
            t_resp = time.perf_counter()
            rid_ledger[w][rid] = (kreq, vreq, np.array(ok))
            for k, v, o in zip(kreq.tolist(), vreq.tolist(), ok.tolist()):
                if o:
                    acked[w][k] = v
                    ev.append((k, A.OP_INSERT, t_inv, t_resp, v, True))
        with stats_lock:
            cstats["write_reqs"] += len(rid_ledger[w])
            cstats["retries"] += cl.retries
            cstats["rejects"] += cl.rejects

    def reader(r: int):
        cl = RetryingClient(srv, tenant=f"reader{r}",
                            policy=RetryPolicy(max_attempts=4),
                            seed=200 + r, deadline_ms=5000.0)
        ev = events[n_writers + r]
        rrng = np.random.default_rng(50 + r)
        local_fail = 0
        while not stop.is_set():
            kreq = np.unique(keys[rrng.integers(0, keys.size, 64)])
            t_inv = time.perf_counter()
            try:
                got, found = cl.read(kreq)
            except ShermanError:
                local_fail += 1
                continue
            t_resp = time.perf_counter()
            for k, g, f in zip(kreq.tolist(), got.tolist(), found.tolist()):
                ev.append((k, A.OP_READ, t_inv, t_resp,
                           g if f else None, bool(f)))
            time.sleep(0.001)
        with stats_lock:
            cstats["read_reqs"] += cl.retries + 1
            cstats["hedges"] += cl.hedges
            cstats["inflight_failures"] += local_fail

    pool = Threads()
    tA = time.perf_counter()
    threads = [pool.start(writer, w) for w in range(n_writers)] \
        + [pool.start(reader, r) for r in range(n_readers)]

    # the clean window: dedup, deadlines and auditor sampling on, a sealed
    # loop, no storm yet: the contract plane must compile nothing
    time.sleep(a.secs / 3)
    retraces_clean = srv.retraces
    assert retraces_clean == 0, \
        f"sealed serving loop retraced {retraces_clean}x with the " \
        "contract plane on (clean window)"

    # the absorbable chaos storm under live clients; the chaos hook fires
    # at the host-step boundary, which the ingress path never crosses:
    # drive the due steps so the wedges land while the clients run
    plan = CH.FaultPlan.random(a.seed, n_faults=4, step_hi=6,
                               kinds=("wedge_lock", "drop_cas"))
    cluster.dsm.install_chaos(plan)
    for _ in range(8):
        cluster.dsm.read_word(0, 0)
        time.sleep(a.secs / 24)
    time.sleep(a.secs / 3)
    cluster.dsm.install_chaos(None)
    out["chaos"] = {"faults_fired": plan.injected,
                    "plan": plan.describe()}
    assert plan.injected > 0, "chaos storm never fired"

    # a delta mid-stream: the rotation carries the ack window forward
    d1 = plane.checkpoint_delta()
    out["delta1"] = {"pages": int(d1["pages"])}

    # the deadline burst: tiny budgets under load fail typed, never late
    shed_typed = shed_other = served_in_time = 0
    for i in range(60):
        t0 = time.perf_counter()
        try:
            fut = srv.submit("read", keys[(i * 61) % a.keys::997],
                             tenant="deadline", deadline_ms=0.01)
            fut.result(timeout=30)
            served_in_time += 1
            assert time.perf_counter() - t0 < 30.0
        except DeadlineExceededError:
            shed_typed += 1
        except ShermanError:
            shed_other += 1  # an overload reject: typed, but not shed
    time.sleep(a.secs / 3)
    stop.set()
    pool.join(threads, timeout=120)
    wallA = time.perf_counter() - tA
    retraces = srv.retraces
    audit_cost_frac = aud.cost_frac(wallA)
    out["deadline"] = {"shed_typed": shed_typed,
                       "served_in_time": served_in_time,
                       "other_typed": shed_other,
                       "server_shed": srv.deadline_shed}
    assert shed_typed + served_in_time + shed_other == 60
    assert shed_typed > 0, "10us budgets under load never shed"
    out["phase_a"] = {"secs": round(wallA, 2),
                      "write_reqs": cstats["write_reqs"],
                      "retries": cstats["retries"],
                      "hedges": cstats["hedges"],
                      "rejects": cstats["rejects"],
                      "inflight_failures": cstats["inflight_failures"],
                      "retraces_clean_window": retraces_clean,
                      # first-use builds of the lock-recovery and
                      # checkpoint paths under the storm
                      "rescue_retraces": retraces - retraces_clean,
                      "audit_cost_frac": round(audit_cost_frac, 5)}
    out["retraces"] = retraces_clean
    assert cstats["write_reqs"] > 0 and sum(len(d) for d in acked) > 0
    t = lap("phase_a", t)

    # -- crash: kill the server mid-ack-stream, tear the journal tail -------
    live_rids = {w: dict(rid_ledger[w]) for w in range(n_writers)}
    srv.kill()
    inline_verdict = aud.stats()
    jpath = eng.journal.path
    plane.close()
    with open(jpath, "ab") as f:  # a crash mid-append: half a record
        rec = J.encode_record(J.J_UPSERT, np.asarray([1 << 40], np.uint64),
                              np.asarray([7], np.uint64), rid=0xDEAD)
        f.write(rec[: len(rec) // 2])
    del cluster, tree, eng, srv

    # -- recover: the state and the exactly-once window ---------------------
    t0 = time.perf_counter()
    plane, cluster, tree, eng, rec = RecoveryPlane.recover(
        rdir, device=a.device, batch_per_node=512,
        tcfg=TreeConfig(sibling_chase_budget=1), group_commit_ms=2.0)
    out["recover"] = {"total_ms": rec["total_ms"],
                      "replayed": rec["replay"]["records"],
                      "replayed_acks": rec["replay"]["acks"],
                      "window": len(plane.dedup_window)}
    assert rec["replay"]["acks"] > 0 and plane.dedup_window, \
        "recovery reconstructed no exactly-once window"

    merged_acked: dict = {}
    for d in acked:
        merged_acked.update(d)
    ak = np.asarray(sorted(merged_acked), np.uint64)
    av = np.asarray([merged_acked[int(k)] for k in ak], np.uint64)
    got, found = eng.search(ak)
    rpo = int((~found).sum()) + int((got[found] != av[found]).sum())
    out["rpo_ops"] = rpo
    assert rpo == 0, f"RPO violated: {rpo} acked ops lost"
    out["rto_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    t = lap("crash_recover", t)

    # -- retry across the crash: re-ack, never re-apply ---------------------
    aud2 = A.Auditor(sample_mod=4, interval_s=0.1)
    srv2 = front_door(eng, auditor=aud2)
    adopted = srv2.seed_dedup(plane.dedup_window)
    out["dedup"] = {"adopted": adopted}
    duplicate_acks = 0
    retried = 0
    post_events: list = []
    for w in range(n_writers):
        sample = list(live_rids[w].items())[-4:]
        for rid, (kreq, vreq, ok0) in sample:
            if not ok0.any():
                continue
            retried += 1
            # 1) move the keys past the old write (a fresh rid)
            vnew = kreq ^ np.uint64(SALT) ^ np.uint64(0x7777_0000)
            t_inv = time.perf_counter()
            ok2 = srv2.submit("insert", kreq, vnew, tenant=f"writer{w}",
                              rid=(0x7777 << 32) | (rid & 0xFFFFFFFF)
                              ).result(timeout=60)
            t_resp = time.perf_counter()
            for k, v, o in zip(kreq.tolist(), vnew.tolist(), ok2.tolist()):
                if o:
                    merged_acked[k] = v
                    post_events.append((k, A.OP_INSERT, t_inv, t_resp, v,
                                        True))
            # 2) retry the pre-crash rid with its payload: the window
            # re-acks the original result
            fut = srv2.submit("insert", kreq, vreq, tenant=f"writer{w}",
                              rid=rid)
            okr = fut.result(timeout=60)
            if not fut.deduped or not np.array_equal(okr, ok0):
                duplicate_acks += 1
                continue
            got, found = srv2.submit("read", kreq).result(timeout=60)
            stomped = int(np.sum(found & ok2 & (got == vreq)
                                 & (vreq != vnew)))
            if stomped:
                duplicate_acks += 1
    out["retry_across_crash"] = {"retried": retried,
                                 "dedup_hits": srv2.dedup_hits}
    out["duplicate_acks"] = duplicate_acks
    assert retried > 0, "drill retried nothing across the crash"
    assert duplicate_acks == 0, \
        f"{duplicate_acks} retried writes re-applied (lost updates)"
    t = lap("retry", t)

    # -- migration under traffic, then the final lost-acks audit ------------
    mig = Migrator(cluster, tree, eng, a.target_nodes, mdir,
                   target_pages_per_node=ppn, batch_pages=64)
    mig.start()
    meter = BatchMeter()
    mrounds = 0
    gen = 0x5109
    wrng = np.random.default_rng(99)
    while not mig.copied_all and mrounds < 10_000:
        meter.step(mig)
        mrounds += 1
        if mrounds % 4 == 0:
            kreq = np.unique(keys[wrng.integers(0, per, 48)])
            vreq = kreq ^ np.uint64(SALT) ^ np.uint64(gen + mrounds)
            t_inv = time.perf_counter()
            try:
                ok = srv2.submit("insert", kreq, vreq, tenant="mig",
                                 rid=(0x3333 << 32) | mrounds
                                 ).result(timeout=60)
            except (ShermanError, DegradedError):
                continue
            t_resp = time.perf_counter()
            for k, v, o in zip(kreq.tolist(), vreq.tolist(), ok.tolist()):
                if o:
                    merged_acked[k] = v
                    post_events.append((k, A.OP_INSERT, t_inv, t_resp, v,
                                        True))
            got, found = srv2.submit("read", kreq, tenant="mig"
                                     ).result(timeout=60)
            t2 = time.perf_counter()
            for k, g, f in zip(kreq.tolist(), got.tolist(), found.tolist()):
                post_events.append((k, A.OP_READ, t_resp, t2,
                                    g if f else None, bool(f)))
    srv2.drain()
    inline2 = aud2.stats()
    t = lap("migrate", t)
    dst = os.path.join(mdir, "cutover.npz")
    summary = mig.finish(dst)
    out["migration"] = {"live_pages": int(summary["live_pages"]),
                        "pages_moved": int(summary["pages_moved"]),
                        "batches": int(summary["batches"]),
                        "rounds": mrounds,
                        "cutover_ms": summary["cutover_ms"],
                        "cutover_parts_ms": summary["cutover_parts_ms"],
                        "batch": meter.receipt()}
    pages_moved = obs.snapshot().get("migrate.pages_moved")
    srv2.stop()
    plane.close()
    mem["source"] = _mem(a.device)
    del plane, cluster, tree, eng, mig, srv2
    t = lap("cutover", t)

    # the M-node cluster serves every acked write
    c3 = CK.restore(dst, device=a.device)
    t3 = Tree(c3)
    e3 = batched.BatchedEngine(t3, batch_per_node=512,
                               tcfg=TreeConfig(sibling_chase_budget=1))
    e3.attach_router()
    check_structure_device(t3)
    ak = np.asarray(sorted(merged_acked), np.uint64)
    av = np.asarray([merged_acked[int(k)] for k in ak], np.uint64)
    got, found = e3.search(ak)
    lost = int((~found).sum()) + int((got[found] != av[found]).sum())
    probe = keys[~in_sorted(keys, ak)][:: max(1, a.keys // 512)]
    got, found = e3.search(probe)
    lost += int((~found).sum()) + int(
        (got[found] != (probe ^ np.uint64(SALT))[found]).sum())
    out["lost_acks"] = lost
    assert lost == 0, f"{lost} acked ops lost across crash + migration"
    t = lap("restore_audit", t)

    # -- offline linearizability over the whole client history --------------
    all_events = [e for ev in events for e in ev] + post_events
    initial = initial_state(all_events, SALT)
    open_w: dict = {}
    for d in unacked:
        for k, outs in d.items():
            open_w.setdefault(k, []).extend(outs)
    verdict = A.check_events(all_events, initial=initial,
                             open_writes=open_w)
    out["audit"] = {
        "events": verdict["events"],
        "keys": verdict["keys"],
        "reads_checked": verdict["reads"],
        "violations": len(verdict["violations"]),
        "linearizable": bool(verdict["linearizable"]),
        "inline_phase_a": inline_verdict,
        "inline_phase_m": inline2,
    }
    out["linearizable"] = bool(verdict["linearizable"])
    if verdict["violations"]:
        out["audit"]["first_violations"] = verdict["violations"][:3]
    assert verdict["linearizable"], \
        f"history not linearizable: {verdict['violations'][:3]}"
    assert verdict["reads"] > 0, "audit checked no reads"
    # the offline artifact and its re-check (receipts stay re-auditable)
    jsonl = os.path.join(root, "history.jsonl")
    A.dump_jsonl(all_events, jsonl)
    re_verdict = A.check_jsonl(jsonl, initial=initial)
    assert re_verdict["events"] == verdict["events"]
    if not open_w:  # the JSONL artifact has no open-writes channel
        assert re_verdict["linearizable"]
    out["history_jsonl"] = jsonl
    assert audit_cost_frac < 0.02, \
        f"inline auditor cost {audit_cost_frac:.4f} of the serve wall"
    t = lap("audit", t)

    d = obs.delta(snap0, obs.snapshot())
    out["obs"] = {k: int(d[k]) for k in sorted(d)
                  if k in ("audit.events", "audit.violations",
                           "audit.windows", "chaos.faults_injected",
                           "journal.truncated_tails", "lease.revoked")}
    out["obs"]["migrate.pages_moved"] = pages_moved
    mem["end"] = _mem(a.device)
    out["device_bytes"] = mem
    out["phase_s"] = walls
    out["elapsed_s"] = round(time.time() - t_start, 1)
    out["ok"] = True
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="client-contract drill of the PyTorch/CUDA port")
    p.add_argument("--keys", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_KEYS", 4000)))
    p.add_argument("--nodes", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_NODES", 2)))
    p.add_argument("--target-nodes", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_TARGET_NODES",
                                              3)))
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("SHERMAN_CHAOS_SEED", 7)))
    p.add_argument("--secs", type=float,
                   default=float(os.environ.get("SHERMAN_DRILL_SECS", 3.0)))
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
        print("sherman_tpu_torch contract drill: no CUDA device; it runs on "
              "the GPU (--device cpu rehearses it)", file=sys.stderr)
        return 2
    out = run(a)
    line = json.dumps(out)
    print(line, flush=True)
    receipt = os.environ.get("SHERMAN_CONTRACT_RECEIPT")
    if receipt:
        with open(receipt, "w") as f:
            f.write(line + "\n")
    print("CONTRACT-DRILL PASS", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
