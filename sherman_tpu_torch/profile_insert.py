"""Insert-step phase profiler (the port's counterpart of
``tools/profile_insert.py``): where the write path's time goes.

The insert step (``batched.insert_step_spmd``) is: routed descent ->
page-snapshot gather -> dedup sort -> rank/verdict scans -> version
extract -> write-back scatter.  This driver times the full step (the
update-only and the general apply), the search step at the same width,
and each phase alone, as plain PyTorch on the same tensors, at
``--rows`` rows of a live tree.

The reference runs each phase K and 2K times chained inside one jitted
loop and takes the difference quotient, which cancels the ~100 ms sync of
its TPU host's access tunnel.  The card has no tunnel: each call is timed
with CUDA events behind a spin kernel (``utils/timer.time_ms``, the median
of ``2 --k + 5`` calls), on the CPU with the host clock.

    python -m sherman_tpu_torch.profile_insert [--rows 2097152]
        [--keys 2000000] [--k 8] [--device cuda]

Prints the phases and ``main(argv)`` returns ``{"metric":
"insert_step_profile", "rows", "keys", <phase>: ms, ...}`` with the
reference's phase names.  Without a card it exits 2 unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sherman_tpu_torch import tools_common as TC


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="insert-step phase profiler of the PyTorch/CUDA port")
    p.add_argument("--rows", type=int, default=2_097_152)
    p.add_argument("--keys", type=int, default=2_000_000)
    p.add_argument("--k", type=int, default=8)
    TC.add_device_arg(p)
    a = p.parse_args(argv)
    TC.require_device(a.device, "profile_insert")

    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.utils.timer import device_ms

    M, K = a.rows, a.k
    reps = 2 * K + 5
    cluster, tree, eng = TC.build_cluster(1, TC.pages_for_keys(a.keys), M,
                                          device=a.device)
    rng = np.random.default_rng(7)
    keys = TC.unique_keys(a.keys, 7)
    batched.bulk_load(tree, keys, keys)
    router = eng.attach_router()
    dsm = tree.dsm
    dev = eng.device
    P = dsm.pool.shape[0]
    print(f"# rows={M} keys={a.keys} pages={P} reps={reps}",
          file=sys.stderr)

    bk = keys[rng.integers(0, a.keys, M)]
    khi, klo = bits.keys_to_pairs(bk)
    d = lambda x: torch.as_tensor(x, device=dev)
    khi_d, klo_d = d(khi), d(klo)
    vhi_d, vlo_d = d(khi ^ np.int32(0xBEE)), d(klo)
    act_d = torch.ones(M, dtype=torch.bool, device=dev)
    start = router.host_start(khi, klo)
    start_d = d(start)
    root = int(tree._root_addr)
    rows_np = np.asarray(bits.addr_page(start)).astype(np.int32) % P
    rows_d = d(rows_np)
    rows_l = rows_d.long()
    res = {}

    def cost(name, fn):
        ms = device_ms(fn, dev, reps=reps)
        res[name] = ms
        print(f"{name:32s} {ms:9.4f} ms", flush=True)

    iters = eng._iters()
    # one real engine step first: a correctness spot check
    ifn = eng._get_insert(iters, True, with_fresh=False, update_only=True)
    st = ifn(dsm.pool, dsm.locks, dsm.counters, dsm.dirty, khi_d, klo_d,
             vhi_d, vlo_d, root, act_d, start_d).cpu().numpy()
    ok = np.isin(st, (batched.ST_APPLIED, batched.ST_SUPERSEDED))
    assert ok.all(), f"profile batch: {np.unique(st)}"
    for update_only in (True, False):
        fn = eng._get_insert(iters, True, with_fresh=False,
                             update_only=update_only)
        cost("insert_step_update_only" if update_only
             else "insert_step_general",
             lambda fn=fn: fn(dsm.pool, dsm.locks, dsm.counters, dsm.dirty,
                              khi_d, klo_d, vhi_d, vlo_d, root, act_d,
                              start_d))
    sfn = eng._get_search(iters, True)
    cost("search_step_same_width",
         lambda: sfn(dsm.pool, dsm.counters, khi_d, klo_d, root, act_d,
                     start_d))

    # --- isolated phases, as plain PyTorch ---------------------------------
    pool = dsm.pool
    cost("page_snapshot_gather", lambda: pool[rows_l])

    idx0 = torch.arange(M, dtype=torch.int64, device=dev)

    def sort6():
        # the dedup sort: by (page, key hi, key lo), lexicographic as two
        # stable sorts, the row index and the key words carried
        o = torch.argsort(klo_d, stable=True)
        o = o[torch.argsort(((rows_l << 32) | khi_d.long())[o],
                            stable=True)]
        return idx0[o], khi_d[o], klo_d[o]

    cost("dedup_sort_6op", sort6)

    def scans():
        w = rows_d
        head = torch.ones(M, dtype=torch.bool, device=dev)
        head[1:] = w[1:] != w[:-1]
        cum = torch.cumsum(head.to(torch.int32), 0)
        base = torch.cummax(torch.where(head, cum - 1, -1), 0).values
        enc = torch.cummax(torch.where(head, idx0 * 2 + 1, -1), 0).values
        return base + enc

    cost("verdict_scans_x3", scans)
    slot_d = d(rng.integers(0, C.LEAF_CAP, M).astype(np.int64))

    def onehot():
        blk = pool[rows_l][:, C.L_VER_W:C.L_VER_W + C.LEAF_CAP]
        return blk.gather(1, slot_d[:, None])[:, 0]

    cost("gather_plus_onehot_ver", onehot)
    field_w = np.array([C.L_VER_W, C.L_KHI_W, C.L_KLO_W, C.L_VHI_W,
                        C.L_VLO_W, C.W_FRONT_VER, C.W_REAR_VER,
                        C.W_NKEYS], np.int64)
    work = pool.clone().view(-1)
    for width in (8, 6, 4):
        idx = d((rows_np[:, None].astype(np.int64) * C.PAGE_WORDS
                 + field_w[None, :width]).reshape(-1))
        ent = d(rng.integers(1, 1 << 30, (M, width)).astype(np.int32)
                .reshape(-1))
        cost(f"writeback_scatter_{width}w",
             lambda idx=idx, ent=ent: work.index_put_((idx,), ent))
    del work
    for k, v in sorted(res.items(), key=lambda kv: -kv[1]):
        print(f"# {k:32s} {v:9.4f} ms", file=sys.stderr)
    out = {"metric": "insert_step_profile", "rows": M, "keys": a.keys,
           **res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
