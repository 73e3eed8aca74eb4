"""Host-failure drill: lease expiry under traffic, zombie-host fencing and
chain adoption by the surviving host (the port's counterpart of
``tools/hostfail_drill.py``; run it as ``python -m sherman_tpu_torch.bench
--hostfail-drill [--keys --seed --secs --lease-s --dir --device]``).

  build    two emulated host contexts in one process behind one
           ``MultihostService`` (per-host chains ``-h0-``/``-h1-`` in one
           shared directory, engines on the device) and the cross-host
           lease table: each host registers a durable heartbeat record, a
           renewer thread re-stamps it, and every engine's journal is
           wrapped by a ``HostFence`` bound to its host's lease epoch.
  traffic  writers and a deleter (exactly-once rids) and a reader drive
           the routed front door; one probe rid's acked result is kept for
           the re-ack after the adoption.
  freeze   host 0 freezes mid-traffic (``HostChaos``): the dispatch seam
           refuses its sub-batches typed (``HostDownError``), its renewals
           stop, and one in-flight append pins its lease view.  Its lease
           expires under traffic (``detect_ms``).
  adopt    host 1 adopts: the fence point captured (the last clean frame
           boundary), ``begin`` journaled, the epoch bumped, host 0's chain
           recovered (its torn tail cut, the stale sweep deferred), the
           dedup window seeded into a fresh front door, the ownership
           overlay published, ``done`` journaled (``adoption_ms``).  The
           availability gap runs from the freeze to the first routed op
           served on the dead keys.
  zombie   host 0 revives as a zombie: its pinned lease view still says
           epoch 1, so its stale acks land past the fence point, where
           ``count_fenced_suffix`` counts them and the read-back proves
           none merged.  On heal the next append raises ``StaleHostError``.
  audit    the retried probe rid re-acks its original result through the
           adopter's window; the merged ledger of acked ops reads back
           through the adopted door (``lost_acks == 0``); the whole routed
           history checks linearizable offline.

Prints one JSON line ``{"metric": "hostfail_drill", "ok": true,
"lost_acks": 0, "duplicate_acks": 0, "linearizable": true,
"fenced_acks_merged": 0, "unadopted_dead_hosts": 0,
"availability_gap_ms": ..., ...}`` and mirrors it to
``SHERMAN_HOSTFAIL_RECEIPT`` when set.  Runs on the card by default;
``--device cpu`` rehearses it at a small size.

Differences from the reference that only size forces (equal at its default
sizes): the keyspace is deduplicated by one sort, the untouched-key probe
masks by ``searchsorted``, and the audit's initial state covers the keys
the history touches.  The clients are the multihost drill's
(``multihost_drill.Traffic``): the reader sleeps 5 ms on a refused read
(the reference's spins on the frozen host's ``HostDownError``, starving
the adoption of the interpreter), and the lost-ack count is the
reference's (a key's state is its last acked outcome or that of a write
in flight at the freeze).
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

from sherman_tpu_torch.failover_drill import (build_cluster, drill_keyspace,
                                              in_sorted, initial_state)
from sherman_tpu_torch.multihost_drill import (SALT, Traffic, front_door,
                                               ledger_misses, memory)

PROBE_RID = 0x51C0FFEE  # the exactly-once re-ack probe


def chunked_svc_read(svc, keys: np.ndarray, width: int = 512):
    """Routed point reads in dispatch-sized chunks -> (values, found)."""
    vs, fs = [], []
    for i in range(0, keys.size, width):
        v, f = svc.submit("read", keys[i:i + width]).result(timeout=120)
        vs.append(np.asarray(v, np.uint64))
        fs.append(np.asarray(f, bool))
    if not vs:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    return np.concatenate(vs), np.concatenate(fs)


def run(a) -> dict:
    """The drill (module docstring); raises AssertionError on a failed
    pin.  -> the receipt."""
    from sherman_tpu_torch import audit as A
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.chaos import HostChaos
    from sherman_tpu_torch.errors import ShermanError
    from sherman_tpu_torch.hostlease import (HostFailover, HostFence,
                                             HostLeaseTable, StaleHostError,
                                             count_fenced_suffix)
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.validate import check_structure_device
    from sherman_tpu_torch.multihost import HostRouter, MultihostService
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.ycsb_bench import pages_for_keys

    t_start = time.time()
    walls: dict = {}
    H = 2
    out: dict = {"metric": "hostfail_drill", "seed": a.seed, "ok": False,
                 "hosts": H, "keys": a.keys, "lease_s": a.lease_s,
                 "secs": a.secs}
    root = a.dir or tempfile.mkdtemp(prefix="sherman_hostfail_")
    out["dir"] = root
    snap0 = obs.snapshot()
    mem: dict = {}

    def lap(name: str, t: float) -> float:
        now = time.perf_counter()
        walls[name] = round(now - t, 3)
        return now

    # -- build: two host contexts and the lease table ------------------------
    t = time.perf_counter()
    router = HostRouter(H)
    keys = drill_keyspace(a.keys)
    own = router.owner(keys)
    out["key_split"] = [int((own == h).sum()) for h in range(H)]
    assert all(n > 0 for n in out["key_split"]), "degenerate key split"
    hc = HostChaos([], seed=a.seed)
    table = HostLeaseTable(root, H, lease_s=a.lease_s, chaos=hc)
    widths = (256, 1024)
    ppn = pages_for_keys(a.keys)
    hosts = []  # [(cluster, tree, eng, plane, srv, my_keys)]
    epochs = {}
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
        epochs[h] = table.register(
            h, hwm=(eng.journal.path, os.path.getsize(eng.journal.path)))
        HostFence(table, h, epochs[h], chaos=hc).install(eng)
        srv = front_door(eng, h, my, widths)
        hosts.append((cluster, tree, eng, plane, srv, my))
    svc = MultihostService([x[4] for x in hosts], router,
                           planes=[x[3] for x in hosts])
    svc.attach_chaos(hc)
    failover = HostFailover(root, table, H,
                            recover_kw={"group_commit_ms": 2.0,
                                        "device": a.device})
    t = lap("build", t)
    mem["built"] = memory(a.device)

    # the renewer: each host's heartbeat, through the chaos seam (a
    # frozen or zombie host's renewals are suppressed)
    stop_renew = threading.Event()
    renew_err: list = []

    def renewer():
        try:
            while not stop_renew.is_set():
                for h in range(H):
                    table.renew(h, epochs[h])
                time.sleep(a.lease_s / 5.0)
        except Exception as e:  # noqa: BLE001 — raised after the join
            renew_err.append(e)

    renew_thr = threading.Thread(target=renewer, daemon=True)
    renew_thr.start()

    # -- acked mixed traffic through the routed front door -------------------
    tr = Traffic(svc, keys)
    n_round = max(4, int(a.secs * 5))
    tr.pool.join(tr.round(n_round), timeout=300)

    # the exactly-once probe: one acked rid whose result must re-ack the
    # same through the adopter after host 0 dies
    prng = np.random.default_rng(77)
    h0keys = keys[own == 0]
    h0imm = tr.imm[router.owner(tr.imm) == 0]
    pk = np.unique(h0imm[prng.integers(0, h0imm.size, 32)])
    pv = pk ^ np.uint64(SALT) ^ np.uint64(0xBEEF << 16)
    probe_f = svc.submit("insert", pk, pv, tenant="probe", rid=PROBE_RID)
    probe_ok = np.asarray(probe_f.result(timeout=120), bool)
    assert probe_ok.all()
    t_inv = time.perf_counter()
    for k, v in zip(pk.tolist(), pv.tolist()):
        tr.acked[0][k] = (True, v)
        tr.events[0].append((k, A.OP_INSERT, t_inv, t_inv, v, True))

    # round 2: open-ended, the traffic runs on through the failure
    ws = tr.round(0)
    time.sleep(min(0.5, a.secs / 4))
    t = lap("traffic", t)

    # -- freeze: host 0 stops serving and heartbeating -----------------------
    t_freeze = time.perf_counter()
    hc.freeze(0)
    # the frozen process serves nothing: its dispatcher stops dead (no
    # drain, the journal left open: the crash image)
    hosts[0][4].kill()
    # one in-flight append pins the frozen host's lease view (its key is
    # outside the clients' keys: pre-fence durable state, never read)
    eng0 = hosts[0][2]
    eng0.journal.append(J.J_UPSERT, np.asarray([1 << 58], np.uint64),
                        np.asarray([1], np.uint64))
    # the crash image: a torn half-frame (in flight at the freeze)
    rec = J.encode_record(J.J_UPSERT, np.asarray([1 << 40], np.uint64),
                          np.asarray([7], np.uint64), rid=0xDEAD)
    with open(hosts[0][2].journal.path, "ab") as f:
        f.write(rec[: len(rec) // 2])

    # the lease expires under traffic (the renewer still stamps host 1)
    deadline = time.time() + max(20.0, 40 * a.lease_s)
    while failover.detect() != [0] and time.time() < deadline:
        time.sleep(a.lease_s / 10.0)
    assert failover.detect() == [0], "host 0's lease never expired"
    assert failover.unadopted_dead_hosts() == 1
    t_expired = time.perf_counter()
    out["detect_ms"] = round((t_expired - t_freeze) * 1e3, 1)
    t = lap("freeze_detect", t)

    # -- adoption: host 1 takes over host 0's namespace ----------------------
    def door(plane, cluster, tree, eng):
        return front_door(eng, 1, h0keys, widths)

    r = failover.adopt(0, 1, door_factory=door, service=svc)
    assert r["seeded"] > 0, "dead dedup window did not re-seed"
    assert r["fence"] is not None
    out["adoption"] = {"dead": r["dead"], "adopter": r["adopter"],
                       "epoch": r["epoch"], "seeded": r["seeded"],
                       "fence": r["fence"],
                       "adoption_ms": r["adoption_ms"],
                       "recover": {k: r["recover"][k] for k in (
                           "restore_ms", "replay_ms", "rebase_ms",
                           "total_ms", "replay")}}
    out["adoption_ms"] = r["adoption_ms"]
    t = lap("adopt", t)
    mem["adopted"] = memory(a.device)
    # the first routed op served on the dead keys closes the gap
    avail_deadline = time.time() + 60
    while True:
        try:
            g, f = svc.submit("read", pk).result(timeout=30)
            break
        except ShermanError:
            assert time.time() < avail_deadline, "keyspace never returned"
            time.sleep(0.01)
    t_avail = time.perf_counter()
    out["availability_gap_ms"] = round((t_avail - t_freeze) * 1e3, 1)
    assert np.asarray(f, bool).all()
    np.testing.assert_array_equal(np.asarray(g, np.uint64), pv)

    # -- zombie: host 0 revives with its pinned pre-bump lease view ----------
    hc.revive(0, zombie=True)
    fenced_pairs = []
    zrng = np.random.default_rng(a.seed)
    for i in range(3):
        zk = np.unique(h0keys[zrng.integers(0, h0keys.size, 8)])
        zv = zk ^ np.uint64(0xFEFE << 8) ^ np.uint64(i)
        # a stale ack: the zombie's own gate still says epoch 1, so the
        # append lands past the fence point
        eng0.journal.append(J.J_UPSERT, zk, zv, rid=0xF0 + i)
        fenced_pairs += list(zip(zk.tolist(), zv.tolist()))
    suffix = count_fenced_suffix((os.path.join(root,
                                               r["fence"]["segment"]),
                                  r["fence"]["size"]))
    out["fenced_suffix_frames"] = suffix
    assert suffix >= 3, f"zombie appends not past the fence: {suffix}"
    # heal: the bump becomes visible and the next stale ack is refused
    hc.heal()
    typed = 0
    try:
        eng0.journal.append(J.J_UPSERT, np.asarray([h0keys[0]], np.uint64),
                            np.asarray([0], np.uint64))
    except StaleHostError:
        typed = 1
    out["zombie_typed_rejections"] = typed
    assert typed == 1, "post-heal zombie append was not typed-fenced"

    # the retried probe rid re-acks its original result through the
    # adopter's seeded window: exactly-once across the host's death
    f2 = svc.submit("insert", pk, pv, tenant="probe", rid=PROBE_RID)
    re_ok = np.asarray(f2.result(timeout=120), bool)
    dup = 0 if (bool(f2.deduped) and np.array_equal(re_ok, probe_ok)) \
        else 1
    out["duplicate_acks"] = dup
    assert dup == 0, "retried rid did not dedup through the adopter"
    t = lap("zombie", t)

    # -- stop the traffic, audit ---------------------------------------------
    tr.stop.set()
    tr.pool.join(ws + tr.readers, timeout=120)
    svc_stats = svc.stats()
    assert svc_stats["adoptions"] == 1
    assert svc_stats["overlay"] == {"0": 1}

    # the fenced acks provably never merged: every fenced (key, value)
    # pair read back through the adopted door
    fa = A.check_fenced_rejected(lambda ks: chunked_svc_read(svc, ks),
                                 fenced_pairs)
    out["fenced_acks"] = fa["fenced"]
    out["fenced_acks_merged"] = fa["merged"]
    assert fa["merged"] == 0, f"zombie acks merged: {fa['violations'][:3]}"

    # lost acks: the merged ledger against the adopted plane; a key's state
    # is its last acked outcome or an in-flight write's (result unknown)
    merged = tr.merged()
    assert merged, "drill acked no ops"
    assert any(not pres for pres, _ in merged.values()), \
        "drill acked no deletes (mixed traffic pin)"
    open_w = tr.open_writes()
    ak = np.asarray(sorted(merged), np.uint64)
    t_inv = time.perf_counter()
    got, found = chunked_svc_read(svc, ak)
    t_resp = time.perf_counter()
    lost, _sup = ledger_misses(ak, got, found, merged, open_w)
    post_events = [(int(k), A.OP_READ, t_inv, t_resp,
                    int(g) if f else None, bool(f))
                   for k, g, f in zip(ak.tolist(), got.tolist(),
                                      found.tolist())]
    # the untouched-key probe: bulk values served verbatim (a key with a
    # write in flight at the kill is not untouched)
    touched = np.asarray(sorted(set(merged) | set(open_w)), np.uint64)
    probe = keys[~in_sorted(keys, touched)][:: max(1, a.keys // 512)]
    got, found = chunked_svc_read(svc, probe)
    lost += int((~found).sum()) + int(
        (got[found] != (probe ^ np.uint64(SALT))[found]).sum())
    out["lost_acks"] = lost
    assert lost == 0, f"{lost} acked/bulk ops lost across adoption"

    # nothing left dead: host 0 adopted, host 1 still renewing
    out["unadopted_dead_hosts"] = failover.unadopted_dead_hosts()
    assert out["unadopted_dead_hosts"] == 0
    stop_renew.set()
    renew_thr.join(timeout=30)
    if renew_err:
        raise renew_err[0]

    # offline linearizability over the whole routed history
    all_events = [e for ev in tr.events for e in ev] + post_events
    verdict = A.check_events(all_events,
                             initial=initial_state(all_events, SALT),
                             open_writes=open_w)
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

    out["service"] = {
        "admitted_ops": svc_stats["admitted_ops"],
        "served_ops": svc_stats["served_ops"],
        "acked_writes": svc_stats["acked_writes"],
        "adoptions": svc_stats["adoptions"],
        "overlay": svc_stats["overlay"],
    }
    assert svc_stats["acked_writes"] > 0

    # flight events and the collector
    kinds = {e["kind"] for e in obs.get_recorder().events()}
    for want in ("host.lease_expired", "host.adopt_begin",
                 "host.adopt_done", "host.zombie_fenced"):
        assert want in kinds, f"missing flight event {want}"
    d = obs.delta(snap0, obs.snapshot())
    out["obs"] = {k: round(float(d[k]), 2) for k in sorted(d)
                  if k.startswith(("hostfail.", "multihost.adoptions",
                                   "chaos.host"))}
    assert d.get("hostfail.expirations", 0) >= 1
    assert d.get("hostfail.adoptions", 0) == 1
    assert d.get("hostfail.fenced_host_acks", 0) >= 1
    t = lap("audit", t)

    r["server"].stop()
    for _cl, _tr, _en, pl, srv, _my in hosts:
        try:
            srv.kill()
        except Exception:  # noqa: BLE001 — the frozen door is already dead
            pass
        pl.close()
    r["context"][0].close()
    mem["end"] = memory(a.device)
    out["memory"] = mem
    out["phase_s"] = walls
    out["elapsed_s"] = round(time.time() - t_start, 1)
    out["ok"] = True
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="host-failure drill of the PyTorch/CUDA port")
    p.add_argument("--keys", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_KEYS", 4000)))
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("SHERMAN_CHAOS_SEED", 7)))
    p.add_argument("--secs", type=float,
                   default=float(os.environ.get("SHERMAN_DRILL_SECS", 2.0)))
    p.add_argument("--lease-s", type=float,
                   default=float(os.environ.get("SHERMAN_HOST_LEASE_S",
                                                0.5)))
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
        print("sherman_tpu_torch hostfail drill: no CUDA device; it runs "
              "on the GPU (--device cpu rehearses it)", file=sys.stderr)
        return 2
    out = run(a)
    line = json.dumps(out)
    print(line, flush=True)
    receipt = os.environ.get("SHERMAN_HOSTFAIL_RECEIPT")
    if receipt:
        with open(receipt, "w") as f:
            f.write(line + "\n")
    print("HOSTFAIL-DRILL PASS", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
