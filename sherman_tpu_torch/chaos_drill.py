"""Data-plane chaos drill: inject -> detect -> recover -> re-validate (the
port's counterpart of ``tools/chaos_drill.py``; run it as ``python -m
sherman_tpu_torch.chaos_drill`` or ``python -m sherman_tpu_torch.bench
--chaos-drill``, with ``--keys --nodes --seed --device``).

  phase A  a client dies holding a page lock (chaos ``wedge_lock`` with a
           dead lease).  The host path detects the dead holder inside its
           spin loop and revokes the lease (``lease.revoked`` > 0);
           re-wedged, the engine's bounded lock retry detects it after
           ``lock_retry_rounds`` blocked rounds and revokes it through
           ``_recover_wedged_locks``: the insert completes either way.
  phase B  a lock wedged by a live lease: the engine does not revoke it;
           the write is rejected with the typed ``ST_LOCK_TIMEOUT``
           outcome after the bounded budget.
  phase C  pool corruption (torn front/rear page versions, a flipped
           entry-version half, a seeded random sprinkle).  The scrubber
           detects it, quarantines the page and flips the engine to
           read-only degraded mode: writes raise ``DegradedError`` while
           searches keep serving.
  recover  restore the pre-fault checkpoint into a fresh cluster,
           re-validate (``check_structure_device``), verify every key; the
           flight recorder's dump shows inject -> degraded -> restore in
           order.

N nodes (4 by default) are emulated on the card, never on a CPU mesh.
Prints one JSON line ``{"metric": "chaos_drill", "ok": true, ...}``;
``main(argv)`` returns the same dict.  Without a card it exits 2 unless
given ``--device cpu``.  Env knobs: SHERMAN_DRILL_KEYS (default 4000),
SHERMAN_DRILL_NODES (default 4), SHERMAN_CHAOS_SEED (default 7).
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
        description="data-plane chaos drill of the PyTorch/CUDA port")
    p.add_argument("--keys", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_KEYS", 4000)))
    p.add_argument("--nodes", type=int,
                   default=int(os.environ.get("SHERMAN_DRILL_NODES", 4)))
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("SHERMAN_CHAOS_SEED", 7)))
    TC.add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    TC.require_device(a.device, "chaos_drill")

    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.config import TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.models.scrub import Scrubber
    from sherman_tpu_torch.models.validate import check_structure_device
    from sherman_tpu_torch.parallel import dsm as D
    from sherman_tpu_torch.utils import checkpoint as CK

    t0 = time.time()
    out: dict = {"metric": "chaos_drill", "seed": a.seed, "ok": False}
    # the drill's flight recorder holds only its own story (a fresh ring):
    # the receipt proves the dump shows inject -> degrade -> recover
    rec = obs.get_recorder()
    rec.clear()
    cluster, tree, eng = TC.build_cluster(
        a.nodes, TC.pages_for_keys(a.keys), 512, locks_per_node=1024,
        chunk_pages=64, device=a.device)
    eng.tcfg = TreeConfig(sibling_chase_budget=1, lock_retry_rounds=2)
    dsm = cluster.dsm
    keys = TC.drill_keyspace(a.keys)
    vals = keys ^ np.uint64(0xDEADBEEF)
    batched.bulk_load(tree, keys, vals)
    eng.attach_router()
    check_structure_device(tree)
    ckpt = os.path.join(tempfile.mkdtemp(prefix="sherman_drill_"),
                        "pre_fault.npz")
    CK.checkpoint(cluster, ckpt)
    victim = int(tree._descend(int(keys[a.keys // 2]))[0])
    la = tree._lock_word_addr(victim)
    snap0 = obs.snapshot()

    def wedge(owner=CH.DEAD_OWNER_TAG, epoch=CH.DEAD_OWNER_EPOCH):
        plan = CH.FaultPlan([CH.Fault(kind="wedge_lock", step=0, addr=la,
                                      owner=owner, epoch=epoch)])
        dsm.install_chaos(plan)
        dsm.read_word(0, 0)  # one host step fires the wedge
        dsm.install_chaos(None)

    # -- phase A: dead-lease wedge, host-path revocation ---------------------
    wedge()
    la_held = tree._lock(victim)
    tree._unlock(la_held)
    d = obs.delta(snap0, obs.snapshot())
    out["host_revoked"] = int(d.get("lease.revoked", 0))
    assert out["host_revoked"] >= 1, "host spin path never revoked"

    # -- phase A2: dead-lease wedge, engine bounded-retry revocation ---------
    wedge()
    snap1 = obs.snapshot()
    band = keys[a.keys // 2: a.keys // 2 + 8]
    st = eng.insert(band, band)
    d = obs.delta(snap1, obs.snapshot())
    out["engine_revoked"] = int(d.get("lease.revoked", 0))
    out["engine_insert"] = {k: v for k, v in st.items()
                            if k != "lock_timeout_keys"}
    assert out["engine_revoked"] >= 1, "engine never revoked the wedge"
    assert st["lock_timeouts"] == 0 and st["applied"] + st[
        "superseded"] + st["host_path"] == band.size

    # -- phase B: live-lease wedge -> typed lock-timeout rejection -----------
    live_ctx = cluster.register_client()
    dsm.write_word(la, 0, live_ctx.lease, space=D.SPACE_LOCK)
    st = eng.insert(band[:4], band[:4])
    out["lock_timeouts"] = st["lock_timeouts"]
    assert st["lock_timeouts"] == 4, f"expected typed rejection: {st}"
    dsm.write_word(la, 0, 0, space=D.SPACE_LOCK)  # holder releases

    # -- phase C: corruption -> scrub detect -> quarantine + degrade ---------
    scr = Scrubber(eng, interval=1)
    clean = scr.scrub()
    assert clean["violations"] == 0, f"pre-fault scrub dirty: {clean}"
    plan = CH.FaultPlan([
        CH.Fault(kind="torn_page", step=0, addr=victim),
        CH.Fault(kind="flip_entry_ver", step=0, addr=victim, slot=2),
        # plus a seeded random sprinkle on other live pages
        *CH.FaultPlan.random(a.seed, n_faults=2, step_hi=1).faults,
    ], seed=a.seed)
    dsm.install_chaos(plan)
    dsm.read_word(0, 0)
    dsm.install_chaos(None)
    res = scr.scrub()
    out["scrub"] = {"pages_checked": res["pages_checked"],
                    "violations": res["violations"],
                    "classes": res["classes"],
                    "quarantined": res["quarantined"]}
    assert res["violations"] >= 1, "scrubber missed injected corruption"
    assert eng.degraded, "engine did not degrade on structural damage"
    try:
        eng.insert(band, band)
        raise AssertionError("degraded engine accepted a write")
    except batched.DegradedError as e:
        out["degraded_reason"] = e.reason
    v, f = eng.search(keys[:256])
    assert f.all(), "degraded engine dropped reads"
    out["degraded_reads_served"] = int(f.sum())

    # -- recover: checkpoint restore (the documented exit) -------------------
    cluster2 = CK.restore(ckpt, device=a.device)
    tree2 = Tree(cluster2)
    eng2 = batched.BatchedEngine(tree2, batch_per_node=512,
                                 tcfg=TreeConfig(sibling_chase_budget=1))
    eng2.attach_router()
    info = check_structure_device(tree2)
    assert info["keys"] == a.keys
    v, f = eng2.search(keys)
    assert f.all()
    np.testing.assert_array_equal(v, vals)
    st = eng2.insert(band, band)  # writes accepted again
    assert st["applied"] + st["superseded"] == band.size
    out["restored"] = info
    d = obs.delta(snap0, obs.snapshot())
    out["chaos_injected"] = int(d.get("chaos.faults_injected", 0))

    # -- black box: dump + assert the postmortem order -----------------------
    bb_dir = os.environ.get("SHERMAN_BLACKBOX_DIR") or os.path.join(
        tempfile.mkdtemp(prefix="sherman_drill_"), "blackbox")
    bb_path = rec.dump("chaos_drill", bb_dir)
    evs = rec.events()

    def first_seq(kind, after=-1):
        return next((e["seq"] for e in evs if e["kind"] == kind
                     and e["seq"] > after), None)

    s_inject = first_seq("chaos.inject")
    s_degraded = first_seq("engine.degraded_enter")
    s_typed = first_seq("engine.typed_error")
    s_restore = first_seq("checkpoint.restore")
    assert s_inject is not None, "no chaos.inject event in the black box"
    assert s_degraded is not None and s_degraded > s_inject, \
        "degraded transition missing or out of order in the black box"
    assert s_restore is not None and s_restore > s_degraded, \
        "recovery step missing or out of order in the black box"
    with open(bb_path) as f:
        bundle = json.load(f)
    bkinds = [e["kind"] for e in bundle["otherData"]["flight_events"]]
    assert "chaos.inject" in bkinds and "engine.degraded_enter" in bkinds
    out["blackbox"] = {
        "path": bb_path,
        "events": len(evs),
        "order": {"inject": s_inject, "degraded": s_degraded,
                  "typed_error": s_typed, "restore": s_restore},
        "ordered": True,
    }

    out["elapsed_s"] = round(time.time() - t0, 1)
    out["ok"] = True
    print(json.dumps(out), flush=True)
    print("CHAOS-DRILL PASS", file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
