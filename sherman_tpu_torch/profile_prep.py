"""Price the request-plane prep: host vs device A/B, and the staged prep's
stages (the port's counterpart of ``tools/profile_prep.py``).

Two modes:

* default: builds a small engine, constructs the shipped ingress step
  twice (``prep_impl=host`` and ``prep_impl=device``,
  ``workload/device_prep.make_ingress_step``) and prices the prep of each
  with ``step.prep_profile`` (the K/2K chained delta on the host clock),
  then the whole ingress step (prep and the fan-out serve, each call
  synced).  A duplicate-leaf write batch through the write-combining
  engine gives the combine ratio (``combine_locks_saved / (groups +
  saved)``).  The last stdout line is the JSON receipt; ``main(argv)``
  returns the same dict.
* ``--stages`` (or ``MODE=stages``): the cumulative cut-down profiler of
  the device-staged prep (PRNG -> +zipf gather -> +mix64 -> +pair sort ->
  +flag compact -> +router probe, and the rank-sort alternative), each
  stage the shipped ``device_prep`` helpers; successive deltas price each
  stage.  Each stage is timed with CUDA events on the card (``K`` calls
  between two events), with the host clock on the CPU.  Returns
  ``{"metric": "prep_stages", "stages": {name: ms}}``.

Env: KEYS (default 20_000), W (ingress width, default 1024), K (reps,
default 8), DUP (combine-batch duplication factor, default 8).  Stage
mode: KEYS (10 M), B (4 M), DEVB (1,114,112), K (16), LB (20), RT (router
table size, 1 << 24).  ``--device`` (cuda by default); without a card it
exits 2 unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from sherman_tpu_torch import tools_common as TC


def stage_deltas(device: str) -> dict:
    """Cumulative cut-down stage profiler; prints a table and returns the
    cumulative ms of each stage."""
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.workload import threefry
    from sherman_tpu_torch.workload.device_prep import (
        _gen_ranks, _keys_of_ranks, _router_probe, _sort_combine,
        _words, zipf_table)

    n_keys = int(os.environ.get("KEYS", 10_000_000))
    batch = int(os.environ.get("B", 4_194_304))
    K = int(os.environ.get("K", 16))
    theta = 0.99
    salt = 0x5E17_AB1E_5A17
    LB = int(os.environ.get("LB", 20))
    dev_b = int(os.environ.get("DEVB", 1_114_112))
    salt_hi, salt_lo = _words(salt)
    dev = torch.device(device)
    t = zipf_table(n_keys, theta, LB)
    tpair = torch.as_tensor(np.stack([t[:-1], t[1:]], axis=1), device=dev)
    # a stand-in router table (the probe is one gather from an int32 table
    # of this size; its content does not affect the cost)
    rt_size = int(os.environ.get("RT", 1 << 24))
    rtable = torch.zeros(rt_size, dtype=torch.int32, device=dev)
    rkey = threefry.PRNGKey(11, device=dev)

    # cumulative stages over the shipped device_prep helpers
    def stage_prng(si):
        return threefry.bits(threefry.fold_in(rkey, si), (2, batch))

    def stage_rank(si):
        return _gen_ranks(tpair, stage_prng(si), log2_bins=LB,
                          n_keys=n_keys)

    def stage_mix(si):
        return _keys_of_ranks(stage_rank(si), salt_hi, salt_lo)

    def stage_sort(si):
        khi, klo = stage_mix(si)
        return torch.sort(((khi - (1 << 31)) << 32) + klo).values

    def stage_compact(si):
        _, _, ukhi, uklo, seg, _ = _sort_combine(*stage_mix(si), dev_b)
        return ukhi, uklo, seg

    def stage_full(si):
        ukhi, uklo, seg = stage_compact(si)
        return _router_probe(rtable, ukhi, uklo, 20, rt_size), seg

    def stage_ranksort_full(si):
        # one 1-key sort of the ranks, the flag compaction, mix64 and the
        # probe on the unique set only
        srank = torch.sort(stage_rank(si)).values
        first = torch.ones_like(srank, dtype=torch.bool)
        first[1:] = srank[1:] != srank[:-1]
        seg = torch.cumsum(first, 0) - 1
        n = srank.shape[0]
        dest = torch.where(first, seg, seg[-1] + 1 + torch.arange(
            n, device=dev) - seg - 1)
        ur = torch.empty_like(srank).scatter_(0, dest, srank)[:dev_b]
        ukhi, uklo = _keys_of_ranks(ur, salt_hi, salt_lo)
        bhi, blo = bits.u64_shr(ukhi, uklo, 20)
        bucket = torch.where(bhi != 0, rt_size - 1,
                             blo.clamp(max=rt_size - 1))
        segc = seg.clamp(0, dev_b - 1)
        return rtable[bucket], seg, ukhi[segc], uklo[segc]

    stages = [
        ("prng(2xB)", stage_prng),
        ("+zipf gather", stage_rank),
        ("+mix64", stage_mix),
        ("+pair sort", stage_sort),
        ("+flag compact", stage_compact),
        ("+router probe", stage_full),
        ("ranksort FULL", stage_ranksort_full),
    ]
    on_card = dev.type == "cuda"
    out, prev = {}, 0.0
    for name, fn in stages:
        fn(0)
        TC.sync(dev)
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        else:
            t0 = time.perf_counter()
        for i in range(K):
            fn(i)
        if on_card:
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1) / K
        else:
            ms = (time.perf_counter() - t0) / K * 1e3
        out[name] = ms
        print(f"{name:16s} {ms:8.3f} ms  (delta {ms - prev:+8.3f})",
              flush=True)
        prev = ms
    return out


def _make_engine(n, device, *, write_combine=False):
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    cfg = DSMConfig(machine_nr=1, pages_per_node=max(2048, n // 8),
                    locks_per_node=512, step_capacity=1024, chunk_pages=32,
                    device=device)
    tree = Tree(Cluster(cfg))
    keys = np.arange(100, 100 + n * 3, 3, dtype=np.uint64)
    vals = keys * np.uint64(7)
    batched.bulk_load(tree, keys, vals)
    eng = batched.BatchedEngine(
        tree, batch_per_node=256, tcfg=TreeConfig(sibling_chase_budget=2),
        write_combine=write_combine)
    eng.attach_router()
    return eng, keys, vals


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="request-plane prep profiler of the PyTorch/CUDA port")
    p.add_argument("--stages", action="store_true",
                   help="the cumulative stage profiler of the staged prep")
    TC.add_device_arg(p)
    a = p.parse_args(argv)
    TC.require_device(a.device, "profile_prep")
    if a.stages or os.environ.get("MODE") == "stages":
        out = {"metric": "prep_stages", "stages": stage_deltas(a.device)}
        print(json.dumps(out), flush=True)
        return out

    from sherman_tpu_torch.workload.device_prep import make_ingress_step

    n = int(os.environ.get("KEYS", 20_000))
    width = int(os.environ.get("W", 1024))
    reps = int(os.environ.get("K", 8))
    dup = int(os.environ.get("DUP", 8))

    eng, keys, vals = _make_engine(n, a.device)
    rng = np.random.default_rng(17)
    batch = rng.choice(keys, size=width, replace=True).astype(np.uint64)

    # host-vs-device prep A/B: the same batch and timer, the only variable
    # where combine/sort/route ran
    impls = {}
    for impl in ("host", "device"):
        step = make_ingress_step(eng, width=width, prep_impl=impl)
        prof = step.prep_profile(batch, reps=reps)
        (key, ms), = prof.items()
        for _ in range(2):
            step(batch)
        t_warm = time.perf_counter()
        for _ in range(reps):
            step(batch)
        step_ms = (time.perf_counter() - t_warm) / reps * 1e3
        impls[impl] = {"prep_ms": round(ms, 4),
                       "step_ms": round(step_ms, 4),
                       "phase_key": key}
        print(f"prep[{impl:6s}]  prep {ms:8.3f} ms   "
              f"full step {step_ms:8.3f} ms", flush=True)

    # write combining on a duplicate-leaf write batch: DUP writers a key
    # land on one leaf page, one lock a group instead of one a row
    ceng, ckeys, _ = _make_engine(max(2048, n // 4), a.device,
                                  write_combine=True)
    wk = np.repeat(ckeys[: max(1, 512 // dup)], dup)[:512].astype(np.uint64)
    ceng.insert(wk, wk * np.uint64(3))
    snap = ceng.dsm.counter_snapshot()
    groups = int(snap["combine_groups"])
    saved = int(snap["combine_locks_saved"])
    ratio = saved / (groups + saved) if (groups + saved) else 0.0
    combine = {"groups": groups, "locks_saved": saved,
               "ops_combined": saved, "ratio": round(ratio, 4)}
    print(f"combine      groups {groups}  locks_saved {saved}  "
          f"ratio {ratio:.3f}", flush=True)

    out = {
        "metric": "prep_ab",
        "keys": n,
        "width": width,
        "reps": reps,
        "impls": impls,
        "speedup_prep": round(
            impls["host"]["prep_ms"] / impls["device"]["prep_ms"], 3)
        if impls["device"]["prep_ms"] else None,
        "combine": combine,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
