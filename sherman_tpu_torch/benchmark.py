"""YCSB-style benchmark driver, ``test/benchmark.cpp`` parity (the port's
counterpart of ``tools/benchmark.py``).

CLI contract (benchmark.cpp:193-205)::

    python -m sherman_tpu_torch.benchmark <kNodeCount> <kReadRatio>
        <kThreadCount> [--keys N] [--theta T] [--secs S]
        [--ops-per-coro N] [--window W] [--combine auto|on|off]
        [--scans N] [--scan-span N] [--exchange xla|pallas]
        [--preempt-ckpt PATH] [--device cuda]

- ``kNodeCount``: cluster nodes, emulated in node-major tensors on the
  card (never a CPU mesh).
- ``kReadRatio``: percent of operations that are searches (YCSB-C=100,
  YCSB-B=95, YCSB-A=50); the rest are upserts.
- ``kThreadCount``: client threads per node.  The batched engine realizes
  the reference's kThreadCount x kCoroCnt ops in flight per node as one
  step of B = kThreadCount x kCoroCnt x opsPerCoro keys a node.

Workload (benchmark.cpp:15-24,159-188): a keyspace of ``--keys`` unique
keys, the warm ratio 0.8 bulk-loaded, zipf(``--theta``) over the warm
set.  Each ``--window`` seconds it reports node and cluster throughput
(the cluster's through ``cluster.keeper.sum``, DSMKeeper.cpp:163-176),
reads per op and, every third window, p50/p90/p95/p99/p999 from the
native 0.1 us ``LatencyHistogram`` (a key's latency is its step's, so each
block records (span, batch)).

``--exchange``: the port has one transport on the card, the hand-written
all-to-all kernel (K4, ``parallel/csrc/exchange.cu``); there is no XLA
collective to choose.  ``xla`` (the default) runs the benchmark on it.
``pallas`` first runs the reference's engine drill (insert with device
splits, routed search, delete, re-search) twice, on ``--device`` (K4 on
the card) and on the CPU (K4's plain twin), and requires the DSM op
counters of the two runs to be equal ("counter diff ... none (exact
match)"); then the same benchmark.  With one node there is no exchange,
and the choice prints one ``"skipped"`` line.

``--preempt-ckpt PATH``: on SIGTERM, checkpoint the cluster to PATH at
the next block boundary and stop (``utils/failure.PreemptionGuard``).

Across processes: launched on every rank by ``scripts/multihost_launch.sh
<coord:port> <ranks> <rank> -m sherman_tpu_torch.benchmark ...`` (which
sets ``SHERMAN_COORD``/``SHERMAN_NPROC``/``SHERMAN_PROC_ID``), each rank
joins the process group (``init_multihost``) and serves its block of the
nodes; every rank draws the same batches and uploads its own rows, the
window and block boundaries are agreed by all-reduces, the preemption
notice of any rank stops every rank at one block and the checkpoint is
the collective one.  Request combining and ``--exchange pallas`` are
single-process.

``main(argv)`` returns ``{"peak_ops", "windows", "preempted",
"latency_us" (the windows' percentiles, where taken), "nodes",
"read_ratio", "batch_per_node", "combine"}``.  Without a card it exits 2
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from sherman_tpu_torch import tools_common as TC

KCORO = 8          # kCoroCnt (Common.h:62-71)
WARM_RATIO = 0.8   # kWarmRatio (benchmark.cpp:19)


def _agreed(mh: bool, flag: bool) -> bool:
    """A flag every rank acts on together: true where any rank's is."""
    if not mh:
        return flag
    from sherman_tpu_torch.parallel import bootstrap
    return bootstrap.allreduce_int(int(flag), "max") > 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="YCSB-style benchmark driver of the PyTorch/CUDA port")
    p.add_argument("kNodeCount", type=int)
    p.add_argument("kReadRatio", type=int)
    p.add_argument("kThreadCount", type=int)
    p.add_argument("--keys", type=int, default=1_000_000)
    p.add_argument("--theta", type=float, default=0.99)
    p.add_argument("--secs", type=float, default=10.0)
    p.add_argument("--ops-per-coro", type=int, default=64,
                   help="batched ops per (thread, coroutine) slot")
    p.add_argument("--window", type=float, default=2.0,
                   help="report window seconds (benchmark.cpp:300)")
    p.add_argument("--combine", choices=("auto", "on", "off"),
                   default="auto",
                   help="request combining: duplicate lookups in a batch "
                        "share one descent (auto: on for skewed "
                        "workloads when it pays)")
    p.add_argument("--scans", type=int, default=0,
                   help="range scans per report window (sibling-link "
                        "traversal, Tree.cpp:461-522)")
    p.add_argument("--scan-span", type=int, default=1000,
                   help="target entries per range scan")
    p.add_argument("--exchange", choices=("xla", "pallas"), default="xla",
                   help="xla: the benchmark on the card's exchange kernel; "
                        "pallas: first the engine drill on the card and on "
                        "the CPU twin, the DSM counters equal (skipped on "
                        "one node)")
    p.add_argument("--preempt-ckpt", default=None, metavar="PATH",
                   help="on SIGTERM, checkpoint the cluster to PATH at the "
                        "next block boundary and stop")
    TC.add_device_arg(p)
    return p.parse_args(argv)


def exchange_counter_diff(n_nodes: int, device: str) -> dict:
    """The reference's transport certification: the same deterministic
    engine drill (insert with device splits, routed search, delete,
    re-search) on two fresh clusters, one on ``device`` (K4 on the card)
    and one on the CPU (K4's plain twin), then the diff of their DSM op
    counters, which must be empty.  -> {"device": snap, "cpu": snap,
    "diff": {counter: device - cpu}}."""
    snaps = {}
    for side, dev in (("device", device), ("cpu", "cpu")):
        cluster, tree, eng = TC.build_cluster(n_nodes, 4096, 128,
                                              device=dev)
        rng = np.random.default_rng(42)
        keys = np.unique(rng.integers(1, 1 << 48, 512, dtype=np.uint64))
        vals = keys ^ np.uint64(0xABCD)
        eng.insert(keys, vals)
        eng.attach_router()
        got, found = eng.search(keys)
        assert found.all() and (got == vals).all(), \
            f"exchange drill ({side}): engine drill lost keys"
        eng.delete(keys[::3])
        _, f2 = eng.search(keys[::3])
        assert not f2.any(), f"exchange drill ({side}): delete drill failed"
        snaps[side] = dict(cluster.dsm.counter_snapshot())
    diff = {k: snaps["device"].get(k, 0) - snaps["cpu"].get(k, 0)
            for k in snaps["cpu"]}
    return {**snaps, "diff": diff}


def main(argv=None) -> dict:
    a = parse_args(argv)
    TC.require_device(a.device, "benchmark")
    import json

    from sherman_tpu_torch import native
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.utils import Timer, notify_info, sorted_unique
    from sherman_tpu_torch.workload.zipf import ZipfGen, uniform_ranks

    B = a.kThreadCount * KCORO * a.ops_per_coro
    n_nodes = a.kNodeCount
    total_batch = B * n_nodes
    keeper = None
    if os.environ.get("SHERMAN_COORD"):
        from sherman_tpu_torch.parallel import bootstrap
        keeper = bootstrap.init_multihost()
        if a.exchange == "pallas":
            raise SystemExit("--exchange pallas is a single-process drill")
    if a.exchange == "pallas":
        if n_nodes < 2:
            out = {"metric": "exchange_pallas",
                   "skipped": f"needs a multi-device mesh (nodes={n_nodes}"
                              "): one node has no exchange"}
            print(json.dumps(out), flush=True)
            return out
        d = exchange_counter_diff(n_nodes, a.device)
        bad = {k: v for k, v in d["diff"].items() if v}
        notify_info("[bench] exchange=pallas drill ok; counter diff vs "
                    "xla: %s", bad or "none (exact match)")
        assert not bad, f"card/CPU DSM counter divergence: {bad}"
    cluster, tree, eng = TC.build_cluster(
        n_nodes, TC.pages_for_keys(a.keys) // n_nodes or 4096, B,
        device=a.device, keeper=keeper)
    mh = eng._mh
    dev = eng.device
    notify_info("[bench] nodes=%d read%%=%d threads=%d B/node=%d keys=%d "
                "theta=%.2f", n_nodes, a.kReadRatio, a.kThreadCount, B,
                a.keys, a.theta)

    # --- warmup: bulk-load the warm fraction (benchmark.cpp:114-120) --------
    rng = np.random.default_rng(7)
    keys = sorted_unique(rng.integers(1, 1 << 63, int(a.keys * 1.05),
                                      dtype=np.uint64))[:a.keys]
    assert keys.shape[0] == a.keys, "keyspace generation came up short"
    n_warm = int(a.keys * WARM_RATIO)
    warm = np.sort(rng.choice(keys, n_warm, replace=False))
    vals = warm ^ np.uint64(0xDEADBEEF)
    t = Timer()
    t.begin()
    stats = batched.bulk_load(tree, warm, vals)
    router = eng.attach_router()
    cluster.keeper.barrier("warm_finish")
    notify_info("[bench] warm %d keys in %.1fs %s", n_warm, t.end() / 1e9,
                stats)

    # --- pre-generate batches (zipf over the warm set) ----------------------
    n_batches = 32
    if a.theta > 0:
        ranks = ZipfGen(n_warm, a.theta, seed=11).sample(
            n_batches * total_batch)
    else:
        ranks = uniform_ranks(n_warm, n_batches * total_batch, rng)
    bkeys = warm[ranks].reshape(n_batches, total_batch)

    # the per-node read count first, the global count from it: the tiled
    # per-node [reads | writes] layout must agree with the global split
    r_node = B * a.kReadRatio // 100
    n_read = r_node * n_nodes
    # a node-major batch array on the card (across ranks: this rank's rows)
    D = (lambda x: eng._shard(np.asarray(x))) if mh else \
        (lambda x: torch.as_tensor(x, device=dev))

    def pack_batch(bk, act_r, act_w, salt):
        """Device-side batch dict from key layout + activity masks."""
        khi, klo = bits.keys_to_pairs(bk)
        nv_hi, nv_lo = bits.keys_to_pairs(bk ^ np.uint64(0xBEEF + salt))
        return dict(khi=D(khi), klo=D(klo),
                    start=D(router.host_start(khi, klo)),
                    vhi=D(nv_hi), vlo=D(nv_lo),
                    act_r=act_r if torch.is_tensor(act_r) else D(act_r),
                    act_w=act_w if torch.is_tensor(act_w) else D(act_w))

    # Request combining: duplicate lookups in a batch share one descent and
    # duplicate upserts collapse to their first writer (the step's own
    # same-key dedup, applied at prep); every client request's answer is
    # fanned out on the device inside the timed step.  Write combining is
    # single-node only (the mixed [reads | writes] layout is per node).
    can_combine = (n_nodes == 1 or a.kReadRatio == 100) and not mh
    if a.combine == "on" and not can_combine:
        notify_info("[bench] --combine on ignored: multi-node write "
                    "combining needs per-node static layouts")
    combine = can_combine and a.combine != "off" and (
        a.combine == "on" or a.theta > 0)

    def _cap(lens, limit):
        """Class capacity: the next quantum above the max unique count,
        never above the class's own request count."""
        quantum = 8192 * n_nodes
        m = max(lens, default=0)
        return min(-(-m // quantum) * quantum, limit) if m else 0

    batches = []
    if combine:
        ur = [np.unique(bkeys[i][:n_read], return_inverse=True)
              for i in range(n_batches)]
        uw = [np.unique(bkeys[i][n_read:], return_inverse=True)
              for i in range(n_batches)]
        r_cap = _cap([u.shape[0] for u, _ in ur], n_read)
        w_cap = _cap([u.shape[0] for u, _ in uw], total_batch - n_read)
        if a.combine == "auto" and (r_cap + w_cap) * 2 > total_batch:
            combine = False  # not enough duplication to pay
        else:
            dev_batch = r_cap + w_cap
            notify_info("[bench] combine: %d ops -> dev %d "
                        "(reads %d cap %d, writes %d cap %d); "
                        "per-request fan-out on device in-step",
                        total_batch, dev_batch,
                        max((u.shape[0] for u, _ in ur), default=0), r_cap,
                        max((u.shape[0] for u, _ in uw), default=0), w_cap)
            for i in range(n_batches):
                bk = np.zeros(dev_batch, np.uint64)
                act_r = np.zeros(dev_batch, bool)
                act_w = np.zeros(dev_batch, bool)
                (ukr, invr), (ukw, invw) = ur[i], uw[i]
                nr, nw = ukr.shape[0], ukw.shape[0]
                bk[:nr] = ukr
                act_r[:nr] = True
                bk[r_cap:r_cap + nw] = ukw
                act_w[r_cap:r_cap + nw] = True
                b = pack_batch(bk, act_r, act_w, i)
                # client slot j's answer row: reads first, then writes
                # offset by r_cap
                b["inv"] = D(np.concatenate([
                    invr.astype(np.int64), (r_cap + invw).astype(np.int64)]))
                batches.append(b)
            del ur, uw
    if not combine:
        # per-node [reads | writes] layout: each node's block holds its
        # reads first (slot-to-class assignment is workload-neutral)
        dev_batch = total_batch
        node_mask = np.zeros(B, bool)
        node_mask[:r_node] = True
        active_r = np.tile(node_mask, n_nodes)
        active_w = ~active_r
        ar_dev, aw_dev = D(active_r), D(active_w)
        for i in range(n_batches):
            bk = np.empty(total_batch, np.uint64)
            bk[active_r] = bkeys[i][:n_read]
            bk[active_w] = bkeys[i][n_read:]
            batches.append(pack_batch(bk, ar_dev, aw_dev, i))
    del bkeys
    root = int(tree._root_addr)

    dsm = tree.dsm
    hist = native.LatencyHistogram() if native.available() else None
    mixed = 0 < n_read < total_batch
    iters = eng._iters()
    # combined pure-read: the engine's fused search + fan-out; mixed: the
    # fused read/upsert step; pure write: the update-only insert step (the
    # workload draws from the warm set, so no split or fresh key)
    ffn = (eng._get_search_fanout(iters)
           if combine and not mixed and n_read else None)
    mfn = eng._get_mixed(iters) if mixed else None
    sfn = (eng._get_search(iters, True)
           if not mixed and n_read and ffn is None else None)
    wfn = (eng._get_insert(iters, True, with_fresh=False, update_only=True)
           if not mixed and n_read < total_batch else None)
    zero_dev = (torch.zeros(dev_batch, dtype=torch.int32, device=dev)
                if combine and wfn is not None else None)

    def fan(found, vh, vl, status, inv):
        # per-request fan-out of combined mixed/write-only steps: one
        # packed [dev_batch, 4] table, one gather, inside the timed step
        ans = torch.stack([found.to(torch.int32), vh, vl, status], dim=-1)
        return ans[inv][:, 3]

    def one_step(i):
        b = batches[i % n_batches]
        if ffn is not None:
            _, found, _, _ = ffn(dsm.pool, dsm.counters, b["khi"], b["klo"],
                                 root, b["act_r"], b["start"], b["inv"])
            return found
        if mfn is not None:
            status, _, found, vh, vl = mfn(
                dsm.pool, dsm.locks, dsm.counters, dsm.dirty, b["khi"],
                b["klo"], b["vhi"], b["vlo"], root, b["act_r"], b["act_w"],
                b["start"])
            return fan(found, vh, vl, status, b["inv"]) if combine \
                else status
        if sfn is not None:
            _, found, _, _ = sfn(dsm.pool, dsm.counters, b["khi"], b["klo"],
                                 root, b["act_r"], b["start"])
            return found
        status = wfn(dsm.pool, dsm.locks, dsm.counters, dsm.dirty, b["khi"],
                     b["klo"], b["vhi"], b["vlo"], root, b["act_w"],
                     b["start"])
        if combine:
            return fan(zero_dev, zero_dev, zero_dev, status, b["inv"])
        return status

    def drain(x):
        TC.sync(dev)
        return x

    # warm + settle
    out = drain(one_step(0))
    for i in range(8):
        out = one_step(i)
    drain(out)

    # --- timed windows ------------------------------------------------------
    t0 = time.time()
    for i in range(4):
        out = one_step(i)
    drain(out)
    est = max((time.time() - t0) / 4, 1e-4)
    # one drain a block: block span max(0.5 s, 32 steps), capped at the
    # window
    span = min(max(0.5, 32 * est), a.window)
    steps_per_block = max(1, int(span / est))
    if mh:      # the ranks' clocks differ: one block size for all
        from sherman_tpu_torch.parallel import bootstrap
        steps_per_block = bootstrap.allreduce_int(steps_per_block, "min")

    windows = max(1, int(a.secs / a.window))
    notify_info("[bench] est step %.1f ms -> %d steps/block",
                est * 1e3, steps_per_block)
    guard = None
    if a.preempt_ckpt:
        from sherman_tpu_torch.utils import failure
        guard = failure.PreemptionGuard(cluster.keeper)
    preempted = False
    results, lat = [], []
    step_i = 0
    c_prev = dsm.counter_snapshot()
    try:
        for w in range(windows):
            w0 = time.time()
            blocks = 0
            while not _agreed(mh, time.time() - w0 >= a.window):
                b0 = time.time()
                for _ in range(steps_per_block):
                    out = one_step(step_i)
                    step_i += 1
                drain(out)
                span = time.time() - b0
                blocks += 1
                if hist is not None:
                    hist.record_batch(int(span / steps_per_block * 1e9),
                                      total_batch * steps_per_block)
                # the block boundary is the stopping granularity
                if guard is not None and guard.should_act(step_i):
                    preempted = True
                    break
            if preempted:
                # checkpoint first: the eviction clock is ticking
                from sherman_tpu_torch.utils import checkpoint as CK
                CK.checkpoint(cluster, a.preempt_ckpt)
                print(f"[bench] preemption notice: checkpointed to "
                      f"{a.preempt_ckpt} at step {step_i}; stopping",
                      flush=True)
                break
            elapsed = time.time() - w0
            # range scans, timed after the window closes so the point-op
            # throughput is not deflated by them: candidate leaves of every
            # range prefetched in one gather (range_query_many)
            scan_entries = scan_ns = 0
            if a.scans:
                rq = []
                for s in range(a.scans):
                    i0 = int(rng.integers(0, max(1, n_warm - a.scan_span)))
                    lo = int(warm[i0])
                    hi = int(warm[min(n_warm - 1, i0 + a.scan_span)])
                    rq.append((lo, max(hi, lo + 1)))
                s0 = time.time_ns()
                res = eng.range_query_many(rq)
                scan_ns = time.time_ns() - s0
                scan_entries = sum(k.size for k, _ in res)
            ops = blocks * steps_per_block * total_batch
            tp_node = ops / elapsed / n_nodes
            tp_cluster = cluster.keeper.sum(f"tp:{w}", int(ops / elapsed))
            c_now = dsm.counter_snapshot()
            reads = c_now["read_ops"] - c_prev["read_ops"]
            c_prev = c_now
            line = (f"[window {w}] node tp {tp_node / 1e6:.2f} Mops/s, "
                    f"cluster tp {tp_cluster / 1e6:.2f} Mops/s, "
                    f"reads/op {reads / max(ops, 1):.2f}")
            if combine:
                # client ops and device rows both: each duplicate request's
                # answer is materialized on the device in the timed step
                dev_tp = blocks * steps_per_block * dev_batch / elapsed
                line += (f", dev rows {dev_tp / 1e6:.2f} M/s "
                         f"(combine {total_batch / dev_batch:.1f}x, "
                         "in-step fan-out)")
            if a.scans:
                line += (f", scans {a.scans} x "
                         f"{scan_entries // max(a.scans, 1)} entries @ "
                         f"{scan_ns / max(a.scans, 1) / 1e6:.1f} ms "
                         f"amortized ("
                         f"{scan_entries / max(scan_ns, 1) * 1e9 / 1e6:.2f}"
                         f" M entries/s)")
            if hist is not None and w % 3 == 2:
                pct = hist.percentiles_us()
                lat.append({"window": w, **pct})
                line += f", lat(us) {pct}"
            print(line, flush=True)
            results.append(tp_cluster)
    finally:
        if guard is not None:
            guard.close()

    # --- verify the last step's statuses (writes must have applied) --------
    last_b = batches[(step_i - 1) % n_batches]
    okst = (batched.ST_APPLIED, batched.ST_SUPERSEDED)
    if mfn is not None or wfn is not None:
        st = out.cpu().numpy()
        if combine:
            okw = np.isin(st[n_read:], okst)  # client-width statuses
        else:
            okw = np.isin(st[last_b["act_w"].cpu().numpy()], okst)
        assert okw.mean() > 0.99, f"write fast-path misses: {1-okw.mean():.3%}"
    elif ffn is not None:
        assert bool(out.all()), "combined searches missed keys"
    elif sfn is not None:
        assert bool(out[last_b["act_r"]].all()), "searches missed warm keys"

    best = max(results, default=0)  # empty when preempted in window 0
    print(f"[bench] peak cluster throughput {best / 1e6:.2f} Mops/s "
          f"({a.kReadRatio}% read, theta={a.theta})", flush=True)
    return {"peak_ops": best, "windows": results, "preempted": preempted,
            "latency_us": lat, "nodes": n_nodes, "read_ratio": a.kReadRatio,
            "batch_per_node": B, "combine": combine}


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
