"""Recovery drill: traffic -> crash -> recover, with measured RPO and RTO
(the port's counterpart of ``tools/recovery_drill.py``; run it as
``python -m sherman_tpu_torch.recovery_drill`` or ``python -m
sherman_tpu_torch.bench --recovery-drill``, with ``--keys --nodes --seed
--group-commit-ms --dir --device``).

  phase 1  build and bulk-load N emulated nodes (4 by default) on the
           card, start the recovery plane: base checkpoint, op journal
           armed with bounded-delay group commit (``group_commit_ms``;
           every ack still gates on a covering fsync).
  phase 2  acknowledged traffic: inserts, deletes, a delta checkpoint
           mid-stream, more inserts into the live journal segment.
  crash    the cluster is dropped cold; a torn half-record is appended to
           the journal first, its rows not acknowledged.
  recover  ``RecoveryPlane.recover``: restore base + deltas, replay the
           journal (the torn tail truncated), re-base.  RTO is the wall
           time to a re-validated serving engine; RPO, the acknowledged
           ops whose effect is missing afterwards, must be 0.
  phase 3  targeted repair: new traffic, chaos corruption on live pages,
           the scrubber quarantines and degrades, ``targeted_repair``
           restores only the damaged pages from the chain and exits
           degraded mode without a full restore.

Prints one JSON line ``{"metric": "recovery_drill", "ok": true,
"rpo_ops": 0, "rto_ms": ...}``, mirrored to ``SHERMAN_RECOVERY_RECEIPT``
when set; ``main(argv)`` returns the same dict.  Without a card it exits 2
unless given ``--device cpu``.  Env knobs: SHERMAN_DRILL_KEYS (default
4000), SHERMAN_DRILL_NODES (default 4), SHERMAN_CHAOS_SEED (default 7),
SHERMAN_DRILL_GC_MS (journal group-commit window, default 2.0).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from sherman_tpu_torch import tools_common as TC


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="recovery drill of the PyTorch/CUDA port")
    p.add_argument("--keys", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_KEYS", 4000)))
    p.add_argument("--nodes", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_NODES", 4)))
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("SHERMAN_CHAOS_SEED", 7)))
    p.add_argument("--group-commit-ms", type=float,
                   default=float(os.environ.get("SHERMAN_DRILL_GC_MS",
                                                2.0)),
                   help="journal group-commit window (0 = per-op fsync); "
                        "the drill pins RPO 0 with it on")
    p.add_argument("--dir", default=None,
                   help="recovery directory (default: a tempdir)")
    TC.add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    TC.require_device(a.device, "recovery_drill")

    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.config import TreeConfig
    from sherman_tpu_torch.models.scrub import Scrubber
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.validate import check_structure_device
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.utils import journal as J

    t_start = time.time()
    out: dict = {"metric": "recovery_drill", "seed": a.seed, "ok": False}
    rdir = a.dir or tempfile.mkdtemp(prefix="sherman_recovery_")
    out["dir"] = rdir

    # -- phase 1: build + arm the recovery plane ------------------------------
    cluster, tree, eng = TC.build_cluster(
        a.nodes, TC.pages_for_keys(a.keys), 512, locks_per_node=1024,
        chunk_pages=64, device=a.device)
    dsm = cluster.dsm
    keys = TC.drill_keyspace(a.keys)
    vals = keys ^ np.uint64(0xDEADBEEF)
    batched.bulk_load(tree, keys, vals)
    eng.attach_router()
    check_structure_device(tree)
    plane = RecoveryPlane(cluster, tree, eng, rdir,
                          group_commit_ms=a.group_commit_ms)
    plane.checkpoint_base()
    out["group_commit_ms"] = a.group_commit_ms
    snap0 = obs.snapshot()

    # the acknowledged-op ledger RPO is audited against: every (key ->
    # value | None for deleted) whose engine op returned before the crash
    acked: dict = {}

    def ack_insert(ks, vs):
        st = eng.insert(ks, vs)
        assert st["lock_timeouts"] == 0
        for k, v in zip(ks.tolist(), vs.tolist()):
            acked[k] = v

    # -- phase 2: acknowledged traffic across a delta boundary ----------------
    nb = max(64, a.keys // 8)
    b1 = keys[:nb]
    ack_insert(b1, b1 ^ np.uint64(0x1111))
    del_keys = keys[nb: nb + nb // 4]
    gone = eng.delete(del_keys)
    assert gone.all()
    for k in del_keys.tolist():
        acked[k] = None
    d1 = plane.checkpoint_delta()
    out["delta1"] = {"pages": d1["pages"], "bytes": d1["bytes"]}
    assert 0 < d1["pages"] < dsm.pool.shape[0], \
        "delta saved nothing or the whole pool"
    b2 = keys[nb + nb // 4: 2 * nb]
    ack_insert(b2, b2 ^ np.uint64(0x2222))

    # -- crash: drop the cluster cold, tear the journal tail ------------------
    jpath = eng.journal.path
    plane.close()
    with open(jpath, "ab") as f:  # a crash mid-append: torn half-record
        torn = J.encode_record(J.J_UPSERT, np.asarray([1 << 40], np.uint64),
                               np.asarray([7], np.uint64))
        f.write(torn[: len(torn) // 2])
    del cluster, tree, eng, dsm

    # -- recover: chain + replay; measure RTO to re-validated serving ---------
    t0 = time.perf_counter()
    plane, cluster, tree, eng, rec = RecoveryPlane.recover(
        rdir, device=a.device, batch_per_node=512,
        tcfg=TreeConfig(sibling_chase_budget=1),
        group_commit_ms=a.group_commit_ms)
    info = check_structure_device(tree)
    rto_ms = (time.perf_counter() - t0) * 1e3
    out["recover"] = rec
    out["rto_ms"] = round(rto_ms, 1)
    obs.gauge("recovery.rto_ms").set(rto_ms)

    # RPO audit: every acknowledged op's effect must be present
    live = {k: v for k, v in acked.items() if v is not None}
    lk = np.asarray(sorted(live), np.uint64)
    got, found = eng.search(lk)
    missing = int((~found).sum()) + int(
        (got[found] != np.asarray([live[int(k)] for k in lk],
                                  np.uint64)[found]).sum())
    dk = np.asarray([k for k, v in acked.items() if v is None], np.uint64)
    if dk.size:
        _, dfound = eng.search(dk)
        missing += int(dfound.sum())  # a deleted key resurfacing = loss
    out["rpo_ops"] = missing
    obs.gauge("recovery.rpo_ops").set(missing)
    assert missing == 0, f"RPO violated: {missing} acknowledged ops lost"
    # untouched bulk keys still intact
    probe = keys[2 * nb:: max(1, a.keys // 512)]
    probe = probe[~TC.in_sorted(probe, np.sort(np.asarray(list(acked),
                                                       np.uint64)))]
    got, found = eng.search(probe)
    assert found.all()
    np.testing.assert_array_equal(got, probe ^ np.uint64(0xDEADBEEF))
    d = obs.delta(snap0, obs.snapshot())
    out["journal"] = {
        "replayed_records": int(d.get("journal.replayed_records", 0)),
        "replayed_rows": int(d.get("journal.replayed_rows", 0)),
        "truncated_tails": int(d.get("journal.truncated_tails", 0)),
        # > 1 append a fsync: group commit coalesced acks, RPO 0 above
        # holding regardless
        "appends": int(d.get("journal.appends", 0)),
        "fsyncs": int(d.get("journal.fsyncs", 0)),
    }
    assert out["journal"]["truncated_tails"] >= 1, \
        "torn tail was not truncated"
    assert info["keys"] > 0

    # -- phase 3: targeted repair exits degraded without a full restore -------
    eng.tcfg = TreeConfig(sibling_chase_budget=1, lock_retry_rounds=2)
    b3 = keys[:nb]
    st = eng.insert(b3, b3 ^ np.uint64(0x3333))
    assert st["lock_timeouts"] == 0
    victim = int(tree._descend(int(keys[a.keys // 2]))[0])
    scr = Scrubber(eng, interval=1)
    assert scr.scrub()["violations"] == 0
    recovers_before = int(obs.snapshot().get("recovery.recovers", 0))
    plan = CH.FaultPlan([
        CH.Fault(kind="torn_page", step=0, addr=victim),
        CH.Fault(kind="flip_entry_ver", step=0, addr=victim, slot=2),
        *CH.FaultPlan.random(a.seed, n_faults=2, step_hi=1).faults,
    ], seed=a.seed)
    cluster.dsm.install_chaos(plan)
    cluster.dsm.read_word(0, 0)
    cluster.dsm.install_chaos(None)
    res = scr.scrub()
    assert res["violations"] >= 1 and eng.degraded
    damage = CH.FaultPlan.rows_to_addrs(
        plan.corrupted_pool_rows(), cluster.cfg.pages_per_node)
    rep = plane.targeted_repair(scr, addrs=damage)
    out["repair"] = {"pages": rep["pages"],
                     "repair_ms": rep["repair_ms"],
                     "replayed": rep["replay"]["records"]}
    assert not eng.degraded, "targeted repair did not exit degraded mode"
    assert int(obs.snapshot().get("recovery.recovers", 0)) \
        == recovers_before, "repair fell back to a full restore"
    check_structure_device(tree)
    got, found = eng.search(b3)
    assert found.all()
    np.testing.assert_array_equal(got, b3 ^ np.uint64(0x3333))
    st = eng.insert(b3[:8], b3[:8])  # writes accepted again
    assert st["applied"] + st["superseded"] == 8

    out["chain"] = {"deltas": len(plane.delta_paths)}
    out["elapsed_s"] = round(time.time() - t_start, 1)
    out["ok"] = True
    plane.close()
    line = json.dumps(out)
    print(line, flush=True)
    receipt = os.environ.get("SHERMAN_RECOVERY_RECEIPT")
    if receipt:
        with open(receipt, "w") as f:
            f.write(line + "\n")
    print("RECOVERY-DRILL PASS", file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
