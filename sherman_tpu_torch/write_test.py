"""Write-amplification probe, ``test/write_test.cpp`` parity (the port's
counterpart of ``tools/write_test.py``).

Performs N random upserts over a bulk-loaded tree, then dumps the DSM op
counters (read/write/cas counts and bytes, ``DSM.cpp:17-21`` /
``write_test.cpp:66-77``) and the write amplification per op: a
non-split insert writes one leaf entry and its versions, not a 1 KB page.
Before it, the read accounting of a routerless descent is held exact (one
page read per level per key), and after it the host lock round trip is
timed (``Tree.lock_bench``, ``Tree.cpp:310-321``).

    python -m sherman_tpu_torch.write_test [kNodeCount] [--n N]
        [--batch B] [--device cuda]

``kNodeCount`` nodes are emulated on the card.  Prints ``write_test
PASS``; ``main(argv)`` returns ``{"metric": "write_test", "ok": true,
"reads", "counters" (the upsert pass's deltas), "write_amplification_b",
"upsert_ops_s", "host_path", "lock_us"}``.  Without a card it exits 2
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from sherman_tpu_torch import tools_common as TC


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="write_test of the port")
    p.add_argument("kNodeCount", type=int, nargs="?", default=1)
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--batch", type=int, default=16_384)
    TC.add_device_arg(p)
    a = p.parse_args(argv)
    TC.require_device(a.device, "write_test")

    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.utils import Timer, notify_info

    n_nodes = a.kNodeCount
    cluster, tree, eng = TC.build_cluster(
        n_nodes, max(4096, TC.pages_for_keys(a.n) // n_nodes),
        a.batch // n_nodes, device=a.device)
    dsm = tree.dsm
    keys = TC.unique_keys(a.n, 11, hi=1 << 62, over=1.1)
    # seed the tree so the inserts take the non-split fast path, then
    # measure a fresh upsert pass over every key
    batched.bulk_load(tree, keys, keys)

    # exact read accounting (DSM.cpp:17-21): on a quiescent tree a
    # routerless descent costs one page read per level per key, (height +
    # 1) loop reads + 1 final leaf gather
    sample = keys[:2048]
    c0 = dsm.counter_snapshot()
    got, found = eng.search(sample)
    assert bool(found.all())
    c1 = dsm.counter_snapshot()
    reads = c1["read_ops"] - c0["read_ops"]
    expect = sample.size * (tree._root_level + 2)
    assert reads == expect, f"read accounting drift: {reads} != {expect}"
    print(f"read accounting parity: {reads:,} reads for {sample.size:,} "
          f"keys at height {tree._root_level} (exact)")

    eng.attach_router()
    base = dsm.counter_snapshot()
    t = Timer()
    t.begin()
    st = eng.insert(keys, keys * np.uint64(7))
    TC.sync(a.device)
    ns = t.end()
    now = dsm.counter_snapshot()
    delta = {k: now[k] - base[k] for k in now}
    n_ops = len(keys)
    notify_info("%d upserts in %.2fs (%.2f M ops/s), host_path=%d",
                n_ops, ns / 1e9, n_ops / (ns / 1e9) / 1e6, st["host_path"])
    print("op counters (delta):")
    for k, v in delta.items():
        print(f"  {k:>16}: {v:>14,}")
    wa_bytes = delta["write_bytes"] / max(n_ops, 1)
    print(f"  write amplification: {wa_bytes:.1f} B/insert "
          f"(full-page rewrite would be 1024 B)")
    got, found = eng.search(keys[: 4096])
    assert found.all() and (got == keys[:4096] * np.uint64(7)).all()
    lock_ns = tree.lock_bench(17, loops=16)  # Tree.cpp:310-321 micro-hook
    print(f"lock_bench: {lock_ns / 1e3:.1f} us/lock-unlock round trip")
    print("write_test PASS", flush=True)
    return {"metric": "write_test", "ok": True, "keys": n_ops,
            "nodes": n_nodes, "reads": reads, "counters": delta,
            "write_amplification_b": wa_bytes,
            "upsert_ops_s": n_ops / (ns / 1e9),
            "host_path": st["host_path"], "lock_us": lock_ns / 1e3}


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
