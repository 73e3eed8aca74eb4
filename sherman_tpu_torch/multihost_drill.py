"""Multihost drill: per-host chain ownership, the cross-host front door,
union recovery and the cross-host tail (the port's counterpart of
``tools/multihost_drill.py``; run it as ``python -m sherman_tpu_torch.bench
--multihost-drill [--keys --hosts --seed --secs --dir --device]``).

  build    N emulated host contexts in one process: each host its own
           cluster, tree and engine on the device, its own recovery plane
           in one shared directory (chain namespaces ``-h0-`` / ``-h1-``)
           and its own front door, behind one ``MultihostService`` whose
           ``HostRouter`` partitions the keys.  Bulk values land on their
           owner host only.
  traffic  writers and a deleter (exactly-once rids) and a reader drive
           the routed front door: every batch splits by owner, each
           sub-batch is acked by its owner's journal only, and the merged
           future puts the batch back in order.  A delta checkpoint runs
           mid-stream on every chain.
  crash    every front door is killed mid-traffic (no drain) and host 0's
           live journal tail is torn (half a frame); host 1's chain stays
           clean.  The killed contexts are dropped.
  recover  ``RecoveryPlane.recover_union``: every host's chain restored
           and replayed on its own; the merged ledger of acked ops
           (inserts and deletes, every host) is read back from the
           recovered engines (``rpo_ops == 0``, ``lost_acks == 0``, with
           an untouched-key probe).
  tail     a follower group on host 0's recovered plane ships host 0's
           ``-h0-`` chain out of the shared directory (host 1's files sit
           beside it), applies a fresh acked round, converges, and serves
           certified replica reads.  The whole client history checks
           linearizable offline.
  a/b      journal ack bandwidth: the hosts' concurrent write streams
           through one shared journal against one journal each, both with
           the front door's group commit; per-host streams must clear
           >= 1.5x the shared stream's acks/s.

Prints one JSON line ``{"metric": "multihost_drill", "ok": true,
"rpo_ops": 0, "lost_acks": 0, "linearizable": true, "ack_bandwidth":
{...}, ...}`` and mirrors it to ``SHERMAN_MULTIHOST_RECEIPT`` when set.
Runs on the card by default; ``--device cpu`` rehearses it at a small size.

Differences from the reference that only size forces (equal at its default
sizes): the keyspace is deduplicated by one sort, the untouched-key probe
masks by ``searchsorted``, the audit's initial state covers the keys the
history touches, and the follower's cache admits the first keys of host
0's untouched slice up to its capacity.  The reader sleeps 5 ms on a
refused read (the reference's spins), so it does not starve the threads
that serve and recover.

One difference is not of size: the RPO count takes the outcome of a write
in flight at the kill (its result unknown to the client) as a legal last
state of its key, as the reference's hostfail drill and the audit do, and
publishes those keys as ``superseded_by_inflight``; the untouched-key probe
leaves such keys out, as the hostfail drill's does.  Acks may lag the
apply, so such a write can be durable though never acked; the reference's
multihost drill counts its key as a lost ack, and fails on it in about
half of its runs on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from sherman_tpu_torch.failover_drill import (Threads, build_cluster,
                                              drill_keyspace, in_sorted,
                                              initial_state)

SALT = 0x30057FEB  # the bulk load's value stamp (key ^ SALT)


def chunked_search(eng, keys: np.ndarray, width: int = 512):
    """Engine point reads in dispatch-sized chunks -> (values, found)."""
    vs, fs = [], []
    for i in range(0, keys.size, width):
        v, f = eng.search(keys[i:i + width])
        vs.append(np.asarray(v, np.uint64))
        fs.append(np.asarray(f, bool))
    if not vs:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    return np.concatenate(vs), np.concatenate(fs)


def ledger_misses(keys: np.ndarray, got, found, merged: dict,
                  open_w: dict) -> tuple[int, int]:
    """The acked-op ledger read back -> (missed, superseded).  A key's
    state must be the outcome of its last acked op, or of a write in
    flight at the crash (its result unknown to the client: ack may lag
    apply, so it may have landed after the last ack); ``missed`` counts
    the keys whose state is neither, ``superseded`` those whose state is
    such an in-flight write's."""
    missed = superseded = 0
    for k, g, f in zip(np.asarray(keys).tolist(), np.asarray(got).tolist(),
                       np.asarray(found).tolist()):
        pres, v = merged[k]
        if f == pres and (not pres or g == v):
            continue
        if any(p == f and (not p or int(w) == g)
               for p, w in open_w.get(k, [])):
            superseded += 1
        else:
            missed += 1
    return missed, superseded


def ack_bandwidth_ab(root: str, n_hosts: int, total: int,
                     gc_ms: float = 2.0) -> dict:
    """``n_hosts`` concurrent closed-loop write streams acking ``total``
    durable appends through one shared journal against one journal each,
    both with the front door's ``group_commit_ms``.  The shared journal
    coalesces the streams' acks through the bounded group-commit window;
    a journal a host has one writer, which skips the window and acks at
    the fsync's speed, the streams' disk waits running side by side.
    ``shared_percommit_acks_s`` (the shared stream with the window off) is
    published beside it and never gated."""
    from sherman_tpu_torch.utils import journal as J

    def run(journals, n_thr: int) -> tuple[float, int]:
        per_thr = total // n_thr
        barrier = threading.Barrier(n_thr + 1)

        def writer(t: int):
            jr = journals[t % len(journals)]
            k = np.asarray([t + 1], np.uint64)
            v = np.asarray([t + 1], np.uint64)
            barrier.wait()
            for i in range(per_thr):
                jr.append(J.J_UPSERT, k, v, rid=(t << 32) | i)

        ths = [threading.Thread(target=writer, args=(t,), daemon=True)
               for t in range(n_thr)]
        for th in ths:
            th.start()
        barrier.wait()
        t0 = time.perf_counter()
        for th in ths:
            th.join(timeout=600)
        dt = time.perf_counter() - t0
        fsyncs = sum(jr.fsyncs for jr in journals)
        for jr in journals:
            jr.close()
        return (n_thr * per_thr) / max(dt, 1e-9), fsyncs

    shared, sh_fs = run([J.Journal(
        os.path.join(root, "ab-shared.wal"), sync=True,
        group_commit_ms=gc_ms)], n_hosts)
    percommit, _pc_fs = run([J.Journal(
        os.path.join(root, "ab-percommit.wal"), sync=True)], n_hosts)
    perhost, ph_fs = run([J.Journal(
        os.path.join(root, f"ab-h{t}.wal"), sync=True,
        group_commit_ms=gc_ms) for t in range(n_hosts)], n_hosts)
    return {
        "hosts": n_hosts, "acks_total": total,
        "group_commit_ms": gc_ms,
        "shared_acks_s": round(shared, 1),
        "shared_acks_per_fsync": round(total / max(sh_fs, 1), 2),
        "shared_percommit_acks_s": round(percommit, 1),
        "perhost_acks_s": round(perhost, 1),
        "perhost_acks_per_fsync": round(total / max(ph_fs, 1), 2),
        "speedup": round(perhost / max(shared, 1e-9), 3),
        "speedup_vs_percommit": round(perhost / max(percommit, 1e-9), 3),
    }


def memory(device: str) -> dict:
    """The device's allocated bytes now and at their peak, and the
    process's peak resident set."""
    out = {"host_rss_peak": resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024}
    if torch.device(device).type == "cuda":
        out["device"] = torch.cuda.memory_allocated()
        out["device_peak"] = torch.cuda.max_memory_allocated()
    return out


def front_door(engine, host_id: int, calib: np.ndarray, widths,
               write_width: int = 2048):
    """A host's ``ShermanServer`` as the reference drills build it, with a
    value-preserving calibration against ``calib`` (this host's keys)."""
    from sherman_tpu_torch.serve import ServeConfig, ShermanServer
    big = {c: 1e9 for c in ("read", "scan", "insert", "delete")}
    cfg = ServeConfig(widths=widths, p99_targets_ms=dict(big),
                      write_linger_ms=0.5, write_width=write_width,
                      group_commit_ms=2.0)
    srv = ShermanServer(engine, cfg, host_id=host_id)
    ck = calib[:256]
    cv, cf = engine.search(ck)
    srv.start(calib_keys=calib,
              calib_writes=(ck[cf], np.asarray(cv)[cf]),
              calib_delete_keys=np.asarray([1 << 60], np.uint64))
    return srv


class Traffic:
    """The drills' exactly-once writers, deleter and reader over a routed
    front door, with the merged acked-op ledger (key -> (present, value)
    after the last acked op; the slices are disjoint a thread) and the
    client history for the audit."""

    def __init__(self, svc, keys: np.ndarray, n_writers: int = 2,
                 n_readers: int = 1):
        from sherman_tpu_torch.serve import RetryPolicy
        self.svc = svc
        self.keys = keys
        self.n_writers = n_writers
        self.per = keys.size // (n_writers + 2)
        self.del_slice = keys[n_writers * self.per:
                              (n_writers + 1) * self.per]
        self.imm = keys[(n_writers + 1) * self.per:]
        self.acked = [dict() for _ in range(n_writers + 1)]
        self.unacked = [dict() for _ in range(n_writers + 1)]
        self.events = [[] for _ in range(n_writers + 1 + n_readers)]
        self.stop = threading.Event()
        self.gens = [0] * n_writers
        self.pol = RetryPolicy(max_attempts=6, hedge_reads=False)
        self.pool = Threads()
        self.readers = [self.pool.start(self.reader, r)
                        for r in range(n_readers)]

    def writer(self, w: int, n_reqs: int):
        from sherman_tpu_torch import audit as A
        from sherman_tpu_torch.errors import ShermanError
        from sherman_tpu_torch.serve import RetryingClient
        my = self.keys[w * self.per:(w + 1) * self.per]
        cl = RetryingClient(self.svc, tenant=f"writer{w}", policy=self.pol,
                            seed=100 + w + self.gens[w])
        ev = self.events[w]
        wrng = np.random.default_rng(1000 * w + self.gens[w])
        done = 0
        while not self.stop.is_set() and (n_reqs == 0 or done < n_reqs):
            self.gens[w] += 1
            done += 1
            time.sleep(0.005)
            kreq = np.unique(my[wrng.integers(0, my.size, 48)])
            vreq = kreq ^ np.uint64(SALT) ^ np.uint64(self.gens[w] << 8)
            t_inv = time.perf_counter()
            try:
                ok = cl.insert(kreq, vreq)
            except ShermanError:
                # in flight at the kill or the outage: unknown, not owed
                for k, v in zip(kreq.tolist(), vreq.tolist()):
                    self.unacked[w].setdefault(k, []).append((True, v))
                continue
            t_resp = time.perf_counter()
            for k, v, o in zip(kreq.tolist(), vreq.tolist(), ok.tolist()):
                if o:
                    self.acked[w][k] = (True, v)
                    ev.append((k, A.OP_INSERT, t_inv, t_resp, v, True))

    def deleter(self, n_reqs: int):
        from sherman_tpu_torch import audit as A
        from sherman_tpu_torch.errors import ShermanError
        from sherman_tpu_torch.serve import RetryingClient
        nw = self.n_writers
        cl = RetryingClient(self.svc, tenant="deleter", policy=self.pol,
                            seed=300)
        ev = self.events[nw]
        drng = np.random.default_rng(4000)
        done = 0
        while not self.stop.is_set() and (n_reqs == 0 or done < n_reqs):
            done += 1
            time.sleep(0.011)
            kreq = np.unique(
                self.del_slice[drng.integers(0, self.del_slice.size, 24)])
            t_inv = time.perf_counter()
            try:
                found = cl.delete(kreq)
            except ShermanError:
                for k in kreq.tolist():
                    self.unacked[nw].setdefault(k, []).append((False, None))
                continue
            t_resp = time.perf_counter()
            for k, f in zip(kreq.tolist(), found.tolist()):
                # an acked delete leaves the key absent, found or not
                self.acked[nw][k] = (False, None)
                ev.append((k, A.OP_DELETE, t_inv, t_resp, None, bool(f)))

    def reader(self, r: int):
        from sherman_tpu_torch import audit as A
        from sherman_tpu_torch.errors import ShermanError
        from sherman_tpu_torch.serve import RetryingClient
        cl = RetryingClient(self.svc, tenant=f"reader{r}", policy=self.pol,
                            seed=200 + r, deadline_ms=5000.0)
        ev = self.events[self.n_writers + 1 + r]
        rrng = np.random.default_rng(50 + r)
        while not self.stop.is_set():
            kreq = np.unique(self.keys[rrng.integers(0, self.keys.size,
                                                     64)])
            t_inv = time.perf_counter()
            try:
                got, found = cl.read(kreq)
            except ShermanError:
                # a refused read (a host down) sleeps a beat: a client
                # spinning on refusals in pure Python starves the serving
                # and recovering threads of the interpreter
                time.sleep(0.005)
                continue
            t_resp = time.perf_counter()
            for k, g, f in zip(kreq.tolist(), got.tolist(), found.tolist()):
                ev.append((k, A.OP_READ, t_inv, t_resp,
                           g if f else None, bool(f)))
            time.sleep(0.001)

    def round(self, n_reqs: int) -> list:
        """Start the writers and the deleter for ``n_reqs`` requests each
        (0: until :attr:`stop`) -> their threads."""
        ws = [self.pool.start(self.writer, w, n_reqs)
              for w in range(self.n_writers)]
        ws.append(self.pool.start(self.deleter, n_reqs))
        return ws

    def merged(self) -> dict:
        out: dict = {}
        for d in self.acked:
            out.update(d)
        return out

    def open_writes(self) -> dict:
        out: dict = {}
        for d in self.unacked:
            for k, outs in d.items():
                out.setdefault(k, []).extend(outs)
        return out


def run(a) -> dict:
    """The drill (module docstring); raises AssertionError on a failed
    pin.  -> the receipt."""
    import gc

    from sherman_tpu_torch import audit as A
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.validate import check_structure_device
    from sherman_tpu_torch.multihost import HostRouter, MultihostService
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.replica import ReplicaGroup
    from sherman_tpu_torch.serve import RetryingClient
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.ycsb_bench import pages_for_keys

    assert a.hosts >= 2, "the multihost drill wants >= 2 hosts"
    t_start = time.time()
    walls: dict = {}
    H = a.hosts
    out: dict = {"metric": "multihost_drill", "seed": a.seed, "ok": False,
                 "hosts": H, "keys": a.keys, "secs": a.secs}
    root = a.dir or tempfile.mkdtemp(prefix="sherman_multihost_")
    out["dir"] = root
    snap0 = obs.snapshot()
    mem: dict = {}

    def lap(name: str, t: float) -> float:
        now = time.perf_counter()
        walls[name] = round(now - t, 3)
        return now

    # -- build: N host contexts, one shared chain directory ------------------
    t = time.perf_counter()
    router = HostRouter(H)
    keys = drill_keyspace(a.keys)
    own = router.owner(keys)
    out["key_split"] = [int((own == h).sum()) for h in range(H)]
    assert all(n > 0 for n in out["key_split"]), "degenerate key split"
    widths = (256, 1024)
    ppn = pages_for_keys(a.keys)
    hosts = []  # [(cluster, tree, eng, plane, srv, my_keys)]
    for h in range(H):
        cluster, tree, eng = build_cluster(
            1, ppn, batch_per_node=512, device=a.device,
            locks_per_node=1024, chunk_pages=64)
        my = keys[own == h]
        batched.bulk_load(tree, my, my ^ np.uint64(SALT))
        eng.attach_router()
        check_structure_device(tree)
        plane = RecoveryPlane(cluster, tree, eng, root,
                              group_commit_ms=2.0, host_id=h, hosts=H)
        plane.checkpoint_base()
        srv = front_door(eng, h, my, widths)
        hosts.append((cluster, tree, eng, plane, srv, my))
    svc = MultihostService([hc[4] for hc in hosts], router,
                           planes=[hc[3] for hc in hosts])
    t = lap("build", t)
    mem["built"] = memory(a.device)

    # -- acked mixed traffic through the routed front door -------------------
    tr = Traffic(svc, keys)
    n_round = max(4, int(a.secs * 5))
    tr.pool.join(tr.round(n_round), timeout=300)
    # a delta on every chain mid-stream (rotation and sweep each scoped
    # to its own -h<i>- namespace)
    deltas = [hc[3].checkpoint_delta() for hc in hosts]
    out["delta_pages"] = [int(d["pages"]) for d in deltas]
    tr.pool.join(tr.round(n_round), timeout=300)
    ws = tr.round(0)                 # in flight at the kill
    time.sleep(min(0.5, a.secs / 4))
    t = lap("traffic", t)

    # -- crash: kill every door, tear host 0's tail only ---------------------
    svc_stats = svc.stats()
    for hc in hosts:
        hc[4].kill()
    tr.stop.set()
    tr.pool.join(ws + tr.readers, timeout=120)
    frontiers = svc.journal_frontiers()
    out["frontiers"] = [[os.path.basename(p), int(n)] for p, n in frontiers]
    torn_path = hosts[0][2].journal.path
    # the killed contexts are dropped (their pools freed before recovery);
    # their journals are closed first, so no late append lands past the tear
    for hc in hosts:
        hc[3].close()
    with open(torn_path, "ab") as f:  # a crash mid-append: half a frame
        rec = J.encode_record(J.J_UPSERT, np.asarray([1 << 40], np.uint64),
                              np.asarray([7], np.uint64), rid=0xDEAD)
        f.write(rec[: len(rec) // 2])
    out["torn"] = os.path.basename(torn_path)
    assert "-h0-" in out["torn"], "tore the wrong host's tail"
    tr.svc = None
    del hosts, svc, hc, cluster, tree, eng, plane, srv
    gc.collect()
    if torch.device(a.device).type == "cuda":
        torch.cuda.empty_cache()
    t = lap("crash", t)
    mem["crashed"] = memory(a.device)

    # -- union recovery: every chain on its own, the torn tail local ---------
    ctxs, union = RecoveryPlane.recover_union(root, hosts=H,
                                              device=a.device)
    out["union"] = {"chains": union["chains"], "replay": union["replay"],
                    "per_host_ms": union["per_host_ms"],
                    "total_ms": union["total_ms"]}
    t = lap("recover_union", t)
    mem["recovered"] = memory(a.device)

    # -- RPO: the merged ledger against the recovered engines ----------------
    merged = tr.merged()
    assert merged, "drill acked no ops before the kill"
    assert any(not pres for pres, _ in merged.values()), \
        "drill acked no deletes (mixed traffic pin)"
    ak = np.asarray(sorted(merged), np.uint64)
    a_own = router.owner(ak)
    rpo = superseded = 0
    open_w = tr.open_writes()
    post_events = []
    for h in range(H):
        sel = a_own == h
        if not sel.any():
            continue
        t_inv = time.perf_counter()
        got, found = chunked_search(ctxs[h][3], ak[sel])
        t_resp = time.perf_counter()
        missed, sup = ledger_misses(ak[sel], got, found, merged, open_w)
        rpo += missed
        superseded += sup
        post_events += [(int(k), A.OP_READ, t_inv, t_resp,
                         int(g) if f else None, bool(f))
                        for k, g, f in zip(ak[sel].tolist(), got.tolist(),
                                           found.tolist())]
    out["rpo_ops"] = rpo
    out["superseded_by_inflight"] = superseded
    assert rpo == 0, f"{rpo} acked ops lost across union recovery"
    lost = rpo
    # the untouched-key probe: bulk values served verbatim.  A key with a
    # write in flight at the kill is not untouched (it may have landed)
    touched = np.asarray(sorted(set(merged) | set(open_w)), np.uint64)
    probe = keys[~in_sorted(keys, touched)][:: max(1, a.keys // 512)]
    p_own = router.owner(probe)
    for h in range(H):
        pk = probe[p_own == h]
        if not pk.size:
            continue
        got, found = chunked_search(ctxs[h][3], pk)
        lost += int((~found).sum()) + int(
            (got[found] != (pk ^ np.uint64(SALT))[found]).sum())
    out["lost_acks"] = lost
    assert lost == 0, f"{lost} acked/bulk ops lost across recovery"
    t = lap("audit_rpo", t)

    # -- the cross-host tail: ship -h0- out of the shared directory ----------
    plane0, _cl0, _tree0, eng0, _r0 = ctxs[0]
    group = ReplicaGroup(plane0, 1, cache_slots=4096)
    h0keys = keys[own == 0]
    srv0 = front_door(eng0, 0, h0keys, widths)
    tail_acked: dict = {}
    wcl = RetryingClient(srv0, tenant="tailwriter", policy=tr.pol, seed=900)
    wrng = np.random.default_rng(42)
    for _ in range(max(4, n_round // 2)):
        kreq = np.unique(h0keys[wrng.integers(0, h0keys.size, 48)])
        vreq = kreq ^ np.uint64(SALT) ^ np.uint64(0x9999 << 16)
        t_inv = time.perf_counter()
        ok = wcl.insert(kreq, vreq)
        t_resp = time.perf_counter()
        for k, v, o in zip(kreq.tolist(), vreq.tolist(), ok.tolist()):
            if o:
                tail_acked[k] = v
                post_events.append((k, A.OP_INSERT, t_inv, t_resp, v, True))
    lag_ms = group.measure_lag()
    fol = group.followers[0]
    tk = np.asarray(sorted(tail_acked), np.uint64)
    tv = np.asarray([tail_acked[int(k)] for k in tk], np.uint64)
    got, found = chunked_search(fol.eng, tk)
    diverged = int((~found).sum()) + int((got[found] != tv[found]).sum())
    assert diverged == 0, \
        f"cross-host follower diverged on {diverged} acked keys"
    # certified replica reads over host 0's untouched slice
    imm0 = tr.imm[router.owner(tr.imm) == 0]
    imm0 = imm0[:fol.eng.leaf_cache.capacity]
    fol.admit(imm0)
    t_inv = time.perf_counter()
    got, found = group.read(imm0[:256])
    t_resp = time.perf_counter()
    post_events += [(int(k), A.OP_READ, t_inv, t_resp,
                     int(g) if f else None, bool(f))
                    for k, g, f in zip(imm0[:256].tolist(),
                                       np.asarray(got).tolist(),
                                       np.asarray(found).tolist())]
    st = group.stats()
    out["tail"] = {
        "of_host": 0, "applied_records": st["applied_records"],
        "applied_rows": st["applied_rows"], "lag_ms": round(lag_ms, 2),
        "reads_served": st["reads_served"],
        "reads_forwarded": st["reads_forwarded"],
        "converged_keys": int(tk.size),
        "bootstrap_s": fol.bootstrap_s,
    }
    assert st["applied_records"] > 0, "the cross-host tail shipped nothing"
    assert st["reads_served"] > 0, "no replica-served reads"
    srv0.drain()
    group.close()
    t = lap("tail", t)
    mem["tail"] = memory(a.device)

    # -- offline linearizability over the whole routed history ---------------
    all_events = [e for ev in tr.events for e in ev] + post_events
    verdict = A.check_events(all_events,
                             initial=initial_state(all_events, SALT),
                             open_writes=tr.open_writes())
    out["audit"] = {
        "events": verdict["events"], "keys": verdict["keys"],
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

    # -- the service plane's receipt -----------------------------------------
    out["service"] = {
        "admitted_ops": svc_stats["admitted_ops"],
        "served_ops": svc_stats["served_ops"],
        "acked_writes": svc_stats["acked_writes"],
        "widths": svc_stats["widths"],
        "contract": svc_stats["contract"],
    }
    if "journal" in svc_stats:
        out["service"]["journal"] = svc_stats["journal"]
    assert svc_stats["acked_writes"] > 0
    t = lap("audit", t)

    # -- journal ack bandwidth: one shared stream vs a stream a host ---------
    out["ack_bandwidth"] = ack_bandwidth_ab(root, n_hosts=H, total=1000)
    assert out["ack_bandwidth"]["speedup"] >= 1.5, (
        "per-host journal streams cleared only "
        f"{out['ack_bandwidth']['speedup']}x the shared stream "
        "(want >= 1.5x)")
    t = lap("ack_ab", t)

    for _pl, _cl, _tr, _en, _rc in ctxs:
        _pl.close()
    d = obs.delta(snap0, obs.snapshot())
    out["obs"] = {k: round(float(d[k]), 2) for k in sorted(d)
                  if k.startswith("multihost.")
                  or k in ("recovery.replayed_records",)}
    assert d.get("multihost.split_submits", 0) > 0
    mem["end"] = memory(a.device)
    out["memory"] = mem
    out["phase_s"] = walls
    out["elapsed_s"] = round(time.time() - t_start, 1)
    out["ok"] = True
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="multihost drill of the PyTorch/CUDA port")
    p.add_argument("--keys", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_KEYS", 4000)))
    p.add_argument("--hosts", type=int, default=2,
                   help="emulated host count (>= 2)")
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("SHERMAN_CHAOS_SEED", 7)))
    p.add_argument("--secs", type=float,
                   default=float(os.environ.get("SHERMAN_DRILL_SECS", 2.0)))
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
        print("sherman_tpu_torch multihost drill: no CUDA device; it runs "
              "on the GPU (--device cpu rehearses it)", file=sys.stderr)
        return 2
    out = run(a)
    line = json.dumps(out)
    print(line, flush=True)
    receipt = os.environ.get("SHERMAN_MULTIHOST_RECEIPT")
    if receipt:
        with open(receipt, "w") as f:
            f.write(line + "\n")
    print("MULTIHOST-DRILL PASS", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
