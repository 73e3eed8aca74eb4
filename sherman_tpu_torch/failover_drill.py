"""Failover drill: journal-shipped replicas, lease-epoch promotion and the
client contract held across the failover (the port's counterpart of
``tools/failover_drill.py``; run it as ``python -m sherman_tpu_torch.bench
--failover-drill [--keys --nodes --replicas --seed --secs --dir]``).

  phase 1  build and bulk-load the tree, arm the recovery plane (base
           checkpoint + v2 journal), start the front door with
           exactly-once dedup, and attach a ReplicaGroup of R followers,
           each bootstrapped from the chain as ``recover()`` does it.
  phase A  exactly-once writers and a reader drive the primary while the
           group tails the live journal; a slice of reads is served by the
           replicas through the leaf cache's certified probe.  A delta
           checkpoint mid-stream sweeps the shipped segment under the
           tail: every follower re-bootstraps from the chain.  The
           replication lag is measured (``repl.lag_ms``).
  kill     the front door is killed mid-traffic (no drain) and the
           journal's tail is torn (half a frame, never acked).
  promote  ``group.promote``: the primary's lease expires, every follower
           catches up to the durable journal end, the highest watermark
           wins; the dead primary's next write is fenced
           (``StalePrimaryError``).
  resume   a new front door on the promoted engine (with its own recovery
           plane) adopts the winner's replayed J_ACK window and serves;
           kill -> first serve is the availability gap.
  retry    pre-kill rids retried against the new primary re-ack their
           original result (``fut.deduped``): ``duplicate_acks == 0``.
  audit    every acked write is served by the promoted primary
           (``lost_acks == 0``, with an untouched-key probe) and the merged
           client history checks linearizable (``audit.py``).

Prints one JSON line ``{"metric": "failover_drill", "ok": true,
"lost_acks": 0, "duplicate_acks": 0, "linearizable": true, ...}`` and
mirrors it to ``SHERMAN_FAILOVER_RECEIPT`` when set.  Runs on the card by
default; ``--device cpu`` rehearses it at a small size.

Differences from the reference that only size forces (equal at its
default sizes): the keyspace is the reference's numpy draw deduplicated by
one sort (``np.unique``'s hash path is slow at 10^8 keys), the untouched-
key probe masks by ``searchsorted``, the audit's initial state covers the
keys the history touches, and the replica reader draws from the keys the
followers' caches admitted (the reference draws from the whole untouched
slice, which at 10^8 keys is 33 M keys against a cache of 1,024).
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

from sherman_tpu_torch.tools_common import (build_cluster, drill_keyspace,
                                            in_sorted)

SALT = 0xFA110FEB  # the bulk load's value stamp (key ^ SALT)


def initial_state(events, salt: int) -> dict:
    """The bulk-loaded state of every key the history touches."""
    ks = {int(e[0]) for e in events}
    return {k: (True, k ^ salt) for k in ks}


class Threads:
    """The drill's client threads: an error a thread does not expect (a
    CUDA launch error, say) is kept and raised, with its own type, by
    :meth:`join` in the caller instead of ending the thread silently."""

    def __init__(self):
        self.errors: list = []

    def start(self, fn, *args) -> threading.Thread:
        def run():
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 — raised in join
                self.errors.append(e)
        th = threading.Thread(target=run, daemon=True)
        th.start()
        return th

    def join(self, threads, timeout: float) -> None:
        for th in threads:
            th.join(timeout=timeout)
        if self.errors:
            raise self.errors[0]


def _mem(device: str) -> int | None:
    return torch.cuda.memory_allocated() \
        if torch.device(device).type == "cuda" else None


def run(a) -> dict:
    """The drill (module docstring); raises AssertionError on a failed
    pin.  -> the receipt."""
    from sherman_tpu_torch import audit as A
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.errors import ShermanError
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.validate import check_structure_device
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.replica import ReplicaGroup, StalePrimaryError
    from sherman_tpu_torch.serve import (RetryingClient, RetryPolicy,
                                         ServeConfig, ShermanServer)
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.ycsb_bench import pages_for_keys

    t_start = time.time()
    walls: dict = {}
    out: dict = {"metric": "failover_drill", "seed": a.seed, "ok": False,
                 "nodes": a.nodes, "replicas": a.replicas, "keys": a.keys,
                 "secs": a.secs}
    root = a.dir or tempfile.mkdtemp(prefix="sherman_failover_")
    rdir = os.path.join(root, "primary")
    rdir2 = os.path.join(root, "promoted")
    out["dir"] = root

    def lap(name: str, t: float) -> float:
        now = time.perf_counter()
        walls[name] = round(now - t, 3)
        return now

    # -- phase 1: primary + replica group -----------------------------------
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
    group = ReplicaGroup(plane, a.replicas, cache_slots=2048)
    t = lap("group", t)
    mem["group"] = _mem(a.device)

    widths = (256 * a.nodes, 1024 * a.nodes)
    big = {c: 1e9 for c in ("read", "scan", "insert", "delete")}

    def front_door(engine):
        cfg = ServeConfig(widths=widths, p99_targets_ms=dict(big),
                          write_linger_ms=0.5, write_width=2048,
                          group_commit_ms=2.0)
        srv = ShermanServer(engine, cfg)
        absent = np.asarray([1 << 60], np.uint64)
        # value-preserving calibration: a promoted engine already holds
        # acked writes
        ck = keys[:256]
        cv, cf = engine.search(ck)
        srv.start(calib_keys=keys,
                  calib_writes=(ck[cf], np.asarray(cv)[cf]),
                  calib_delete_keys=absent)
        return srv

    srv = front_door(eng)
    snap0 = obs.snapshot()

    # the writers' slices cover the first n_writers * per keys; the last
    # slice is never written: the set replica reads serve from
    n_writers, n_readers = 2, 1
    per = a.keys // (n_writers + 1)
    imm = keys[n_writers * per:]
    acked: list[dict] = [dict() for _ in range(n_writers)]
    unacked: list[dict] = [dict() for _ in range(n_writers)]
    rid_ledger: list[dict] = [dict() for _ in range(n_writers)]
    events: list[list] = [[] for _ in range(n_writers + n_readers + 1)]
    stop = threading.Event()
    gens = [0] * n_writers

    def writer(w: int, n_reqs: int):
        # bounded rounds of paced exactly-once writes (``n_reqs == 0``
        # runs until the stop flag: the round in flight at the kill)
        my = keys[w * per:(w + 1) * per]
        cl = RetryingClient(srv, tenant=f"writer{w}",
                            policy=RetryPolicy(max_attempts=6),
                            seed=100 + w + gens[w])
        ev = events[w]
        wrng = np.random.default_rng(1000 * w + gens[w])
        done = 0
        while not stop.is_set() and (n_reqs == 0 or done < n_reqs):
            gens[w] += 1
            done += 1
            time.sleep(0.005)
            kreq = np.unique(my[wrng.integers(0, my.size, 48)])
            vreq = kreq ^ np.uint64(SALT) ^ np.uint64(gens[w] << 8)
            rid = cl.next_rid()
            t_inv = time.perf_counter()
            try:
                ok = cl.insert(kreq, vreq, rid=rid)
            except ShermanError:
                # in flight at the kill: unknown, not owed
                for k, v in zip(kreq.tolist(), vreq.tolist()):
                    unacked[w].setdefault(k, []).append((True, v))
                continue
            t_resp = time.perf_counter()
            rid_ledger[w][rid] = (kreq, vreq, np.array(ok))
            for k, v, o in zip(kreq.tolist(), vreq.tolist(), ok.tolist()):
                if o:
                    acked[w][k] = v
                    ev.append((k, A.OP_INSERT, t_inv, t_resp, v, True))

    def reader(r: int):
        cl = RetryingClient(srv, tenant=f"reader{r}",
                            policy=RetryPolicy(max_attempts=4),
                            seed=200 + r, deadline_ms=5000.0)
        ev = events[n_writers + r]
        rrng = np.random.default_rng(50 + r)
        while not stop.is_set():
            kreq = np.unique(keys[rrng.integers(0, keys.size, 64)])
            t_inv = time.perf_counter()
            try:
                got, found = cl.read(kreq)
            except ShermanError:
                continue
            t_resp = time.perf_counter()
            for k, g, f in zip(kreq.tolist(), got.tolist(), found.tolist()):
                ev.append((k, A.OP_READ, t_inv, t_resp,
                           g if f else None, bool(f)))
            time.sleep(0.001)

    repl_read_fail = [0]
    # the replica read set: the untouched keys the followers' caches hold
    hot = imm[:group.followers[0].eng.leaf_cache.capacity]

    def replica_reader():
        ev = events[n_writers + n_readers]
        rrng = np.random.default_rng(77)
        while not stop.is_set():
            kreq = np.unique(hot[rrng.integers(0, hot.size, 48)])
            t_inv = time.perf_counter()
            try:
                got, found = group.read(kreq)
            except ShermanError:
                repl_read_fail[0] += 1
                continue
            t_resp = time.perf_counter()
            for k, g, f in zip(kreq.tolist(), np.asarray(got).tolist(),
                               np.asarray(found).tolist()):
                ev.append((k, A.OP_READ, t_inv, t_resp,
                           g if f else None, bool(f)))
            time.sleep(0.002)

    for f in group.followers:
        f.admit(hot)
    pool = Threads()
    readers = [pool.start(reader, r) for r in range(n_readers)] \
        + [pool.start(replica_reader)]
    n_round = max(4, int(a.secs * 5))
    t = time.perf_counter()

    # round 1: bounded write load under the live tail
    pool.join([pool.start(writer, w, n_round) for w in range(n_writers)],
              timeout=300)
    group.pump()
    t = lap("round1", t)

    # a delta mid-stream sweeps the shipped segment under the tail; the
    # pump lock keeps a pump from slipping through rotate -> sweep
    with group._pump_lock:
        d1 = plane.checkpoint_delta()
    out["delta1"] = {"pages": int(d1["pages"])}
    t = lap("delta", t)
    # absorb the re-bootstrap here, so the lag below is a shipping round
    group.pump()
    t = lap("rebootstrap", t)

    # round 2: more acked writes on the fresh segment
    pool.join([pool.start(writer, w, n_round) for w in range(n_writers)],
              timeout=300)
    lag_ms = group.measure_lag()

    # round 3: open-ended writers, in flight at the kill
    ws = [pool.start(writer, w, 0) for w in range(n_writers)]
    time.sleep(min(0.5, a.secs / 4))

    # -- kill: no drain, a torn tail at the shipping boundary ---------------
    t_kill = time.perf_counter()
    srv.kill()
    stop.set()
    pool.join(ws + readers, timeout=120)
    t = lap("round2_kill", t)
    live_rids = {w: dict(rid_ledger[w]) for w in range(n_writers)}
    jpath = eng.journal.path
    with open(jpath, "ab") as fh:  # a crash mid-append: half a frame
        rec = J.encode_record(J.J_UPSERT, np.asarray([1 << 40], np.uint64),
                              np.asarray([7], np.uint64), rid=0xDEAD)
        fh.write(rec[: len(rec) // 2])

    # -- promote: fence, catch up, the highest watermark --------------------
    rcpt = group.promote(t_dead=t_kill)
    out["promote"] = rcpt
    t = lap("promote", t)
    try:
        eng.insert(np.asarray([1 << 41], np.uint64),
                   np.asarray([1], np.uint64))
        raise AssertionError("stale-primary write was NOT fenced")
    except ShermanError as e:
        tip = e
        while tip is not None and not isinstance(tip, StalePrimaryError):
            tip = tip.__cause__
        assert isinstance(tip, StalePrimaryError) \
            or isinstance(e, StalePrimaryError), \
            f"fence raised untyped {type(e).__name__}: {e}"
    out["fenced_writes"] = group.fenced_writes
    assert group.fenced_writes >= 1

    # -- resume: a new front door on the promoted engine --------------------
    win = group.promoted
    eng2 = win.eng
    plane2 = RecoveryPlane(win.cluster, win.tree, eng2, rdir2,
                           group_commit_ms=2.0)
    plane2.checkpoint_base()  # the new primary is itself recoverable
    t = lap("base2", t)
    srv2 = front_door(eng2)
    adopted = srv2.seed_dedup(group.promoted_window())
    _g0, f0 = srv2.submit("read", keys[:64]).result(timeout=60)
    assert np.asarray(f0).all()
    gap_ms = group.note_resumed()
    out["availability_gap_ms"] = gap_ms
    out["dedup"] = {"adopted": adopted}
    assert adopted > 0, "promotion adopted an empty exactly-once window"
    t = lap("resume", t)

    # -- RPO: every acked write served by the promoted primary --------------
    merged_acked: dict = {}
    for d in acked:
        merged_acked.update(d)
    assert merged_acked, "drill acked no writes before the kill"
    ak = np.asarray(sorted(merged_acked), np.uint64)
    av = np.asarray([merged_acked[int(k)] for k in ak], np.uint64)
    t_inv = time.perf_counter()
    wmax = max(widths)
    parts = [srv2.submit("read", ak[i:i + wmax]).result(timeout=120)
             for i in range(0, ak.size, wmax)]
    got = np.concatenate([np.asarray(g) for g, _ in parts])
    found = np.concatenate([np.asarray(f) for _, f in parts])
    t_resp = time.perf_counter()
    lost = int((~found).sum()) + int((got[found] != av[found]).sum())
    post_events = [(int(k), A.OP_READ, t_inv, t_resp,
                    int(g) if f else None, bool(f))
                   for k, g, f in zip(ak.tolist(), got.tolist(),
                                      found.tolist())]
    # the untouched-key probe: bulk values served verbatim
    probe = keys[~in_sorted(keys, ak)][:: max(1, a.keys // 512)]
    got, found = srv2.submit("read", probe).result(timeout=120)
    lost += int((~found).sum()) + int(
        (got[found] != (probe ^ np.uint64(SALT))[found]).sum())
    out["lost_acks"] = lost
    assert lost == 0, f"{lost} acked ops lost across the failover"

    # -- retry across the failover: re-ack, never re-apply ------------------
    duplicate_acks = 0
    retried = 0
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
            # 2) retry the pre-kill rid with its payload: the promoted
            # window re-acks the original result
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
    out["retry_across_failover"] = {"retried": retried,
                                    "dedup_hits": srv2.dedup_hits}
    out["duplicate_acks"] = duplicate_acks
    assert retried > 0, "drill retried nothing across the failover"
    assert duplicate_acks == 0, \
        f"{duplicate_acks} retried writes re-applied (lost updates)"
    srv2.drain()
    plane2.close()

    # -- offline linearizability over both sides of the failover ------------
    all_events = [e for ev in events for e in ev] + post_events
    open_w: dict = {}
    for d in unacked:
        for k, outs in d.items():
            open_w.setdefault(k, []).extend(outs)
    verdict = A.check_events(all_events,
                             initial=initial_state(all_events, SALT),
                             open_writes=open_w)
    out["audit"] = {
        "events": verdict["events"],
        "keys": verdict["keys"],
        "reads_checked": verdict["reads"],
        "violations": len(verdict["violations"]),
        "linearizable": bool(verdict["linearizable"]),
    }
    out["linearizable"] = bool(verdict["linearizable"])
    if verdict["violations"]:
        out["audit"]["first_violations"] = verdict["violations"][:3]
    assert verdict["linearizable"], \
        f"history not linearizable: {verdict['violations'][:3]}"
    assert verdict["reads"] > 0, "audit checked no reads"
    jsonl = os.path.join(root, "history.jsonl")
    A.dump_jsonl(all_events, jsonl)
    out["history_jsonl"] = jsonl
    t = lap("audit", t)

    # -- the replication receipt --------------------------------------------
    st = group.stats()
    out["repl"] = {
        "followers": st["followers"],
        "applied_records": st["applied_records"],
        "applied_rows": st["applied_rows"],
        "absorbed_acks": st["absorbed_acks"],
        "rebootstraps": st["rebootstraps"],
        "torn_waits": st["torn_waits"],
        "lag_ms": round(lag_ms, 2),
        "reads_served": st["reads_served"],
        "reads_forwarded": st["reads_forwarded"],
        "read_failures": repl_read_fail[0],
        "epoch": st["epoch"],
        "watermark": {"link": st["watermark_link"],
                      "seq": st["watermark_seq"]},
    }
    assert st["applied_records"] > 0, "the tail shipped nothing"
    assert st["rebootstraps"] >= a.replicas, \
        "the mid-stream sweep never forced a re-bootstrap"
    assert st["reads_served"] > 0, "no replica-served reads"

    d = obs.delta(snap0, obs.snapshot())
    out["obs"] = {k: round(float(d[k]), 2) for k in sorted(d)
                  if k in ("repl.applied_records", "repl.promotions",
                           "repl.fenced_writes", "repl.lag_ms",
                           "repl.availability_gap_ms")}
    out["bootstrap_s"] = [f.bootstrap_s for f in group.followers]
    mem["end"] = _mem(a.device)
    out["device_bytes"] = mem
    out["phase_s"] = walls
    out["elapsed_s"] = round(time.time() - t_start, 1)
    out["ok"] = True
    group.close()
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="failover drill of the PyTorch/CUDA port")
    p.add_argument("--keys", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_KEYS", 4000)))
    p.add_argument("--nodes", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_NODES", 1)))
    p.add_argument("--replicas", type=int,
                   default=int(os.environ.get("SHERMAN_REPL", 0) or 2))
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
        print("sherman_tpu_torch failover drill: no CUDA device; it runs "
              "on the GPU (--device cpu rehearses it)", file=sys.stderr)
        return 2
    out = run(a)
    line = json.dumps(out)
    print(line, flush=True)
    receipt = os.environ.get("SHERMAN_FAILOVER_RECEIPT")
    if receipt:
        with open(receipt, "w") as f:
            f.write(line + "\n")
    print("FAILOVER-DRILL PASS", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
