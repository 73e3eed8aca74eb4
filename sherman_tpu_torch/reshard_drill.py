"""Reshard drill: a live N->M grow under mixed acknowledged traffic, crash-
restartable (the port's counterpart of ``tools/reshard_drill.py``; run it
as ``python -m sherman_tpu_torch.bench --reshard-drill [--keys --nodes
--target-nodes --seed --batch-pages --dir --device]``).

  phase 1  build and bulk-load an N-node cluster, arm the recovery plane
           (base checkpoint + journal) and start the online migrator
           (``migrate.py``) toward M nodes.
  phase 2  mixed acknowledged traffic (inserts, deletes, reads)
           interleaved with bounded migration batches; a delta checkpoint
           lands mid-stream (the migration's re-copy set rides its clear
           through the DSM's dirty sink).  The read p99 is sampled from
           the SLO plane before and during the migration.
  chaos +  a seeded FaultPlan wedges a lock as held by a dead client (the
  crash    migrator must revoke it to keep copying), then the cluster is
           dropped cold with a torn journal tail.
  recover  ``RecoveryPlane.recover`` (RPO 0 against the acked-op ledger),
           then ``Migrator.resume``: completed batches are re-verified from
           their CRC-tagged artifacts, not re-done.
  finish   more acked traffic, the copy completes, the quiesced cutover
           emits the M-node checkpoint.
  validate the emitted pool must be bit-identical to the offline
           ``utils.reshard`` transform of the same final state, and the
           restored M-node cluster must serve every acknowledged op:
           ``lost_acks == 0``.

Prints one JSON line ``{"metric": "reshard_drill", "ok": true,
"lost_acks": 0, "rpo_ops": 0, "bit_identical": true, ...}`` and mirrors it
to ``SHERMAN_RESHARD_RECEIPT`` when set.  Beside the reference's receipt it
carries the migration's batches (``batch``: host steps and ms a batch over
the copy loop), the seconds by phase and the device memory.  Runs on the
card by default; ``--device cpu`` rehearses it at a small size.

Differences from the reference that only size forces (equal at its
default sizes): the keyspace is the reference's draw deduplicated by one
sort, and the untouched-key probe masks by ``searchsorted``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from sherman_tpu_torch.failover_drill import (_mem, build_cluster,
                                              drill_keyspace, in_sorted)

SALT = 0xE1A57C  # the bulk load's value stamp (key ^ SALT)


def _p99(window: dict, op_class: str) -> float:
    rec = (window or {}).get(op_class) or {}
    return float(rec.get("p99_ms") or 0.0)


class BatchMeter:
    """Wraps a migrator's ``step``: the host steps (``dsm.host_steps``) and
    the wall of every batch that copied pages."""

    def __init__(self):
        from sherman_tpu_torch import obs
        self._steps = obs.counter("dsm.host_steps")
        self.ms: list[float] = []
        self.host_steps: list[int] = []
        self.pages: list[int] = []

    def step(self, mig) -> dict:
        h0, t0 = self._steps.value, time.perf_counter()
        r = mig.step()
        if r.get("pages"):
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.host_steps.append(self._steps.value - h0)
            self.pages.append(r["pages"])
        return r

    def receipt(self) -> dict:
        if not self.ms:
            return {"batches": 0}
        return {"batches": len(self.ms), "pages": int(sum(self.pages)),
                "ms_mean": float(np.mean(self.ms)),
                "ms_p99": float(np.percentile(self.ms, 99)),
                "host_steps_mean": float(np.mean(self.host_steps)),
                "ms_per_host_step": float(sum(self.ms)
                                          / max(1, sum(self.host_steps))),
                "copy_s": float(sum(self.ms) / 1e3)}


def run(a) -> dict:
    """The drill (module docstring); raises AssertionError on a failed
    pin.  -> the receipt."""
    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.config import TreeConfig
    from sherman_tpu_torch.migrate import Migrator
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.models.validate import check_structure_device
    from sherman_tpu_torch.obs import slo as SLO
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.utils import checkpoint as CK
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.utils.reshard import reshard
    from sherman_tpu_torch.ycsb_bench import pages_for_keys

    t_start = time.time()
    walls: dict = {}
    out: dict = {"metric": "reshard_drill", "seed": a.seed, "ok": False,
                 "nodes": a.nodes, "target_nodes": a.target_nodes,
                 "keys": a.keys, "batch_pages": a.batch_pages}
    root = a.dir or tempfile.mkdtemp(prefix="sherman_reshard_")
    rdir = os.path.join(root, "recovery")
    mdir = os.path.join(root, "migration")
    out["dir"] = root

    def lap(name: str, t: float) -> float:
        now = time.perf_counter()
        walls[name] = round(now - t, 3)
        return now

    # -- phase 1: build, arm the recovery plane and the migrator ------------
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
    plane = RecoveryPlane(cluster, tree, eng, rdir)
    plane.checkpoint_base()
    t = lap("base", t)
    mig = Migrator(cluster, tree, eng, a.target_nodes, mdir,
                   target_pages_per_node=ppn, batch_pages=a.batch_pages)
    out["migration"] = mig.start()
    snap0 = obs.snapshot()
    meter = BatchMeter()

    # the acked-op ledger: every key -> value (None: deleted) whose engine
    # op returned before the crash
    acked: dict = {}

    def ack_insert(ks, vs):
        st = eng.insert(ks, vs)
        assert st["lock_timeouts"] == 0, st
        acked.update(zip(ks.tolist(), vs.tolist()))

    def ack_delete(ks):
        gone = eng.delete(ks)
        assert gone.all()
        acked.update((k, None) for k in ks.tolist())

    # the read p99 with no migration interleaved (after a warm-up)
    for i in range(4):
        eng.search(keys[i::97])
    SLO.get_slo().reset()
    for i in range(6):
        eng.search(keys[i::61])
    p99_before = _p99(obs.slo_window(), "read")
    SLO.get_slo().reset()
    t = lap("warm", t)

    # -- phase 2: mixed traffic x migration batches -------------------------
    nb = max(64, a.keys // 10)
    i = 0
    rounds = 0
    while i < 3 * nb:
        meter.step(mig)
        rounds += 1
        b = keys[i: i + nb // 2]
        ack_insert(b, b ^ np.uint64(0x1111))
        eng.search(keys[(i + rounds) % nb:: 61])
        i += nb // 2
    ack_delete(keys[3 * nb: 3 * nb + nb // 4])
    t = lap("mixed", t)
    d1 = plane.checkpoint_delta()  # the dirty sink rides this clear
    out["delta1"] = {"pages": d1["pages"]}
    t = lap("delta", t)
    while not mig.copied_all and rounds < 10_000:
        meter.step(mig)
        rounds += 1
        eng.search(keys[rounds % nb:: 53])
    p99_during = _p99(obs.slo_window(), "read")
    t = lap("copy", t)
    out["slo"] = {"read_p99_before_ms": round(p99_before, 3),
                  "read_p99_during_ms": round(p99_during, 3),
                  "read_p99_spike": round(p99_during / p99_before, 2)
                  if p99_before > 0 else None}
    pre_crash_moved = mig.pages_moved
    assert pre_crash_moved > 0 and mig.batches > 1

    # -- chaos mid-migration: a wedged lock the migrator must revoke --------
    plan = CH.FaultPlan([CH.Fault(kind="wedge_lock", step=0)], seed=a.seed)
    cluster.dsm.install_chaos(plan)
    cluster.dsm.read_word(0, 0)
    cluster.dsm.install_chaos(None)
    b = keys[3 * nb + nb // 4: 4 * nb]
    ack_insert(b, b ^ np.uint64(0x2222))
    meter.step(mig)  # copies through the wedged word by lease revocation

    # -- crash: drop the cluster cold, tear the journal tail ----------------
    jpath = eng.journal.path
    plane.close()
    mig.close()
    with open(jpath, "ab") as f:  # a crash mid-append: half a record
        rec = J.encode_record(J.J_UPSERT, np.asarray([1 << 40], np.uint64),
                              np.asarray([7], np.uint64))
        f.write(rec[: len(rec) // 2])
    del cluster, tree, eng, mig
    t = lap("chaos_crash", t)

    # -- recover + resume ---------------------------------------------------
    t0 = time.perf_counter()
    plane, cluster, tree, eng, rec = RecoveryPlane.recover(
        rdir, device=a.device, batch_per_node=512,
        tcfg=TreeConfig(sibling_chase_budget=1))
    out["recover"] = {"total_ms": rec["total_ms"],
                      "replayed": rec["replay"]["records"]}
    mig = Migrator.resume(cluster, tree, eng, mdir,
                          batch_pages=a.batch_pages)
    out["resume"] = {"staged": mig.staged_pages,
                     "resume_count": mig.resume_count}
    assert mig.resume_count == 1

    # the RPO audit on the recovered source
    live = {k: v for k, v in acked.items() if v is not None}
    lk = np.asarray(sorted(live), np.uint64)
    lv = np.asarray([live[int(k)] for k in lk], np.uint64)
    got, found = eng.search(lk)
    rpo = int((~found).sum()) + int((got[found] != lv[found]).sum())
    dk = np.asarray(sorted(k for k, v in acked.items() if v is None),
                    np.uint64)
    if dk.size:
        _, dfound = eng.search(dk)
        rpo += int(dfound.sum())
    out["rpo_ops"] = rpo
    obs.gauge("recovery.rpo_ops").set(rpo)
    assert rpo == 0, f"RPO violated: {rpo} acknowledged ops lost"
    out["rto_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    t = lap("recover_resume", t)

    # -- finish: more acked traffic, complete, the quiesced cutover ---------
    b = keys[4 * nb: 5 * nb]
    ack_insert(b, b ^ np.uint64(0x3333))
    while not mig.copied_all:
        if meter.step(mig).get("idle"):
            break
    t = lap("catch_up", t)
    dst = os.path.join(mdir, "online.npz")
    summary = mig.finish(dst)
    assert mig.resume_verified > 0, \
        "resume re-verified nothing: batches were re-done, not resumed"
    out["cutover"] = {k: summary[k] for k in (
        "live_pages", "pages_moved", "batches", "retries",
        "lock_conflicts", "resume_verified", "cutover_ms",
        "cutover_parts_ms")}
    out["batch"] = meter.receipt()
    t = lap("cutover", t)

    # -- validate 1: bit-identity with the offline transform ----------------
    src_final = os.path.join(root, "final_src.npz")
    CK.checkpoint(cluster, src_final)
    offline = os.path.join(root, "offline.npz")
    reshard(src_final, offline, a.target_nodes, pages_per_node=ppn)
    ident = True
    with np.load(dst) as on, np.load(offline) as off:
        for k in ("pool", "locks", "counters", "dir_nodes", "dir_next",
                  "dir_root", "dir_free"):
            if not np.array_equal(on[k], off[k]):
                ident = False
                out.setdefault("identity_mismatch", []).append(k)
    out["bit_identical"] = ident
    assert ident, \
        f"online pool != offline reshard: {out.get('identity_mismatch')}"
    t = lap("offline", t)
    # the migrate.* collector reads the live migrator: delta before it goes
    d = obs.delta(snap0, obs.snapshot())
    out["obs"] = {k: int(d[k]) for k in sorted(d)
                  if k in ("migrate.pages_moved", "migrate.batches",
                           "migrate.retries", "migrate.lock_conflicts",
                           "migrate.resume_count",
                           "migrate.resume_verified", "migrate.epoch",
                           "lease.revoked")}
    plane.close()
    mem["source"] = _mem(a.device)
    del plane, cluster, tree, eng, mig

    # -- validate 2: the M-node cluster serves every acknowledged op --------
    c2 = CK.restore(dst, device=a.device)
    t2 = Tree(c2)
    e2 = batched.BatchedEngine(t2, batch_per_node=512,
                               tcfg=TreeConfig(sibling_chase_budget=1))
    e2.attach_router()
    info = check_structure_device(t2)
    got, found = e2.search(lk)
    lost = int((~found).sum()) + int((got[found] != lv[found]).sum())
    if dk.size:
        _, dfound = e2.search(dk)
        lost += int(dfound.sum())
    # untouched bulk keys ride along too
    ak = np.asarray(sorted(acked), np.uint64)
    probe = keys[5 * nb:: max(1, a.keys // 512)]
    probe = probe[~in_sorted(probe, ak)]
    got, found = e2.search(probe)
    lost += int((~found).sum()) + int(
        (got[found] != (probe ^ np.uint64(SALT))[found]).sum())
    out["lost_acks"] = lost
    assert lost == 0, f"{lost} acknowledged ops lost across the reshard"
    assert info["keys"] > 0
    # the new shape accepts writes (capacity really grew)
    st = e2.insert(keys[:8], keys[:8])
    assert st["applied"] + st["superseded"] == 8
    t = lap("restore_audit", t)

    mem["end"] = _mem(a.device)
    out["device_bytes"] = mem
    out["phase_s"] = walls
    out["elapsed_s"] = round(time.time() - t_start, 1)
    out["ok"] = True
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="reshard drill of the PyTorch/CUDA port")
    p.add_argument("--keys", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_KEYS", 4000)))
    p.add_argument("--nodes", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_NODES", 4)))
    p.add_argument("--target-nodes", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_TARGET_NODES",
                                              6)))
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("SHERMAN_CHAOS_SEED", 7)))
    p.add_argument("--batch-pages", type=int,
                   default=int(os.environ.get("SHERMAN_MIGRATE_BATCH_PAGES",
                                              32)),
                   help="migration batch size (small, so the copy "
                        "interleaves with the drill's traffic)")
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
        print("sherman_tpu_torch reshard drill: no CUDA device; it runs on "
              "the GPU (--device cpu rehearses it)", file=sys.stderr)
        return 2
    out = run(a)
    line = json.dumps(out)
    print(line, flush=True)
    receipt = os.environ.get("SHERMAN_RESHARD_RECEIPT")
    if receipt:
        with open(receipt, "w") as f:
            f.write(line + "\n")
    print("RESHARD-DRILL PASS", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
