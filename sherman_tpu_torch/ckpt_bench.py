"""Checkpoint/restore wall times at benchmark scale on the card (the
port's counterpart of ``tools/ckpt_bench.py``).

Builds the north-star tree (default 100 M keys ``mix64(rank ^ salt)``,
values ``key ^ 0xDEADBEEF``, fill 0.75, a power-of-two pool), then times
one full cycle: ``checkpoint(cluster, path)`` -> (``--delta-ops`` engine
upserts of a clustered key range -> ``checkpoint_delta``) -> the original
pool released -> ``restore_chain`` -> a probe of ``--sample`` keys
through a fresh engine (and with ``--validate`` the device structure
validator).  It also prices the journal's group commit: per-op fsync
against ``Journal(sync=True, group_commit_ms=...)`` under 4 writers x 24
records of 256 rows (acks/s, ack latency, acks per fsync; at 2 ms the
acks per fsync must reach 2).  Prints a side-by-side table on stderr and
ONE JSON line (``metric: checkpoint_restore_at_scale``) with the card's
name and power limit and the ``obs`` section (the ``ckpt.*`` and
``journal.*`` counters, the memory accountant's bytes).  Run on the GPU::

    python -m sherman_tpu_torch.ckpt_bench [--keys 100000000]
        [--sample 200000] [--delta-ops N] [--validate] [--dir DIR]

Without a CUDA device it exits with code 2.  The full-size artifacts are
~4 GB on disk: ``--dir`` (default a temporary directory) must hold them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from sherman_tpu_torch import obs

SALT = 0x5E17_AB1E_5A17


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def journal_group_commit_ab(threads: int = 4, appends: int = 24,
                            rows: int = 256, modes=(0.0, 0.5, 2.0),
                            directory: str | None = None) -> dict:
    """The group-commit A/B: ``threads`` concurrent writers each appending
    ``appends`` batch records of ``rows`` u64 key/value pairs through one
    Journal per mode (0 = per-op fsync).  Every append blocks until an
    fsync covers its record (RPO 0 in every mode).  -> {mode label:
    {group_commit_ms, acks, acks_per_s, ack_mean_ms, ack_p99_ms, fsyncs,
    acks_per_fsync, added_ack_ms}}."""
    from sherman_tpu_torch.utils import journal as J

    td = tempfile.mkdtemp(prefix="sherman_jab_", dir=directory)
    rng = np.random.default_rng(17)
    # one key block per (thread, append), the same in every mode
    blocks = rng.integers(1, 1 << 60, (threads, appends, rows),
                          dtype=np.uint64)
    results: dict = {}
    try:
        for gc in modes:
            label = "per_op" if gc == 0 else f"gc_{gc:g}ms"
            path = os.path.join(td, f"{label}.wal")
            j = J.Journal(path, sync=True, group_commit_ms=gc)
            lat: list = []
            lock = threading.Lock()

            def writer(t):
                mine = []
                for i in range(appends):
                    ks = blocks[t, i]
                    t0 = time.perf_counter()
                    j.append(J.J_UPSERT, ks, ks ^ np.uint64(0x5EED))
                    mine.append(time.perf_counter() - t0)
                with lock:
                    lat.extend(mine)

            ths = [threading.Thread(target=writer, args=(t,))
                   for t in range(threads)]
            t0 = time.perf_counter()
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            elapsed = time.perf_counter() - t0
            j.close()
            n = threads * appends
            if len(J.read_records(path)) != n:
                raise AssertionError("group-commit A/B lost records")
            lat.sort()
            results[label] = {
                "group_commit_ms": gc, "acks": n,
                "acks_per_s": n / elapsed,
                "ack_mean_ms": 1e3 * sum(lat) / len(lat),
                "ack_p99_ms": 1e3 * lat[int(0.99 * (len(lat) - 1))],
                "fsyncs": j.fsyncs,
                "acks_per_fsync": n / max(1, j.fsyncs),
            }
    finally:
        shutil.rmtree(td, ignore_errors=True)
    base = results.get("per_op", {}).get("ack_mean_ms", 0.0)
    for r in results.values():
        # acks coalesce at the cost of up to group_commit_ms of ack latency
        r["added_ack_ms"] = r["ack_mean_ms"] - base
    g2 = results.get("gc_2ms")
    if g2 is not None and threads >= 2 and g2["acks_per_fsync"] < 2.0:
        raise AssertionError(f"group commit failed to coalesce: {g2}")
    return results


def pool_pages(n_keys: int, fill: float = 0.75) -> int:
    """The tool's pool: 10% slack and 8,192 pages over the leaves, rounded
    up to a power of two (at least 16,384)."""
    from sherman_tpu_torch.config import LEAF_CAP
    per_leaf = max(1, int(LEAF_CAP * fill))
    est = int(n_keys / per_leaf * 1.10) + 8192
    return 1 << max(14, (est - 1).bit_length())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="checkpoint/restore at "
                                 "benchmark scale (on the GPU)")
    ap.add_argument("--keys", type=int, default=100_000_000)
    ap.add_argument("--sample", type=int, default=200_000,
                    help="post-restore verification sample size")
    ap.add_argument("--dir", default=None,
                    help="where to write the .npz (default: a tempdir)")
    ap.add_argument("--validate", action="store_true",
                    help="run the device structure validator on the "
                         "restored tree too")
    ap.add_argument("--delta-ops", type=int, default=None,
                    help="engine upserts between base and delta (default "
                         "keys/100 capped at 1 M; 0 disables the delta)")
    ap.add_argument("--journal-ab-threads", type=int, default=4)
    ap.add_argument("--journal-ab-appends", type=int, default=24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sherman_tpu_torch.ckpt_bench: no CUDA device; the port's "
              "benchmark runs on the GPU", file=sys.stderr)
        return 2
    if args.delta_ops is None:
        args.delta_ops = min(max(args.keys // 100, 1000), 1_000_000)

    from sherman_tpu_torch.bench import _device_info
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.utils import checkpoint as CK
    from sherman_tpu_torch.ycsb_bench import synthetic_keys

    device = _device_info()
    pages = pool_pages(args.keys)
    cluster = Cluster(DSMConfig(machine_nr=1, pages_per_node=pages,
                                locks_per_node=65_536, step_capacity=65_536,
                                chunk_pages=4096))
    tree = Tree(cluster)
    keys = synthetic_keys(args.keys, SALT)
    t0 = time.perf_counter()
    batched.bulk_load(tree, keys, keys ^ np.uint64(0xDEADBEEF), fill=0.75)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _say(f"bulk_load {build_s:.1f}s ({args.keys} keys, pool {pages} pages)")

    td = args.dir or tempfile.mkdtemp(prefix="sherman_ckpt_")
    path = os.path.join(td, "bench.npz")
    dpath = os.path.join(td, "bench.delta1.npz")
    delta = dkeys = validate_s = None
    try:
        t0 = time.perf_counter()
        epoch = CK.checkpoint(cluster, path)
        ckpt_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        _say(f"checkpoint {ckpt_s:.1f}s ({size / 1e9:.2f} GB)")
        if args.delta_ops:
            # a CLUSTERED working set (the first keys in key order): the
            # delta covers the touched leaves, where a uniform spray would
            # dirty the whole tree
            eng0 = batched.BatchedEngine(
                tree, batch_per_node=min(65_536, max(1024, args.delta_ops)))
            eng0.attach_router()
            dkeys = keys[: min(args.delta_ops, args.keys)]
            t0 = time.perf_counter()
            st = eng0.insert(dkeys, dkeys ^ np.uint64(0x5EED))
            traffic_s = time.perf_counter() - t0
            if st["lock_timeouts"]:
                raise AssertionError(f"delta traffic: {st}")
            t0 = time.perf_counter()
            dinfo = CK.checkpoint_delta(cluster, dpath, parent_epoch=epoch)
            delta = {"ops": int(dkeys.size), "traffic_s": traffic_s,
                     "pages": dinfo["pages"], "npz_bytes": dinfo["bytes"],
                     "checkpoint_s": time.perf_counter() - t0}
            _say(f"delta checkpoint {delta['checkpoint_s']:.2f}s "
                 f"({delta['pages']} pages, "
                 f"{delta['npz_bytes'] / 1e6:.1f} MB)")
            del eng0
        # release the original pool before restoring
        del tree, cluster
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        c2 = CK.restore_chain(path, [dpath] if delta else [])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        _say(f"restore {restore_s:.1f}s"
             + (" (chain: base + 1 delta)" if delta else ""))
        t2 = Tree(c2)
        e2 = batched.BatchedEngine(t2, batch_per_node=65_536)
        e2.attach_router()
        t0 = time.perf_counter()
        idx = np.linspace(0, args.keys - 1,
                          min(args.sample, args.keys)).astype(np.int64)
        probe = keys[idx]
        got, found = e2.search(probe)
        if not found.all():
            raise AssertionError(f"restore lost {int((~found).sum())} keys")
        want = probe ^ np.uint64(0xDEADBEEF)
        if dkeys is not None:
            upd = np.isin(probe, dkeys)
            want[upd] = probe[upd] ^ np.uint64(0x5EED)
            gd, fd = e2.search(dkeys)
            if not (fd.all() and np.array_equal(gd,
                                                dkeys ^ np.uint64(0x5EED))):
                raise AssertionError("restore lost delta writes")
        if not np.array_equal(got, want):
            raise AssertionError("restored values differ")
        verify_s = time.perf_counter() - t0
        if args.validate:
            from sherman_tpu_torch.models.validate import \
                check_structure_device
            t0 = time.perf_counter()
            info = check_structure_device(t2)
            validate_s = time.perf_counter() - t0
            if info["keys"] != args.keys:
                raise AssertionError(f"validate: {info}")
    finally:
        if args.dir is None:
            shutil.rmtree(td, ignore_errors=True)

    if delta:
        _say("{:>10s} {:>12s} {:>12s}".format("", "full", "delta"))
        _say("{:>10s} {:>12.2f} {:>12.2f}".format(
            "save (s)", ckpt_s, delta["checkpoint_s"]))
        _say("{:>10s} {:>12.3f} {:>12.3f}".format(
            "size (GB)", size / 1e9, delta["npz_bytes"] / 1e9))
    jab = None
    if args.journal_ab_threads > 0:
        jab = journal_group_commit_ab(threads=args.journal_ab_threads,
                                      appends=args.journal_ab_appends)
        for label, r in jab.items():
            _say(f"journal {label}: {r['acks_per_s']:.0f} acks/s, ack "
                 f"{r['ack_mean_ms']:.3f} ms mean / {r['ack_p99_ms']:.3f} "
                 f"p99, {r['acks_per_fsync']:.2f} acks a fsync")
    print(json.dumps({
        "metric": "checkpoint_restore_at_scale",
        "value": ckpt_s + restore_s, "unit": "s",
        "keys": args.keys, "pool_pages": pages, "npz_bytes": size,
        "bulk_load_s": build_s, "checkpoint_s": ckpt_s,
        "restore_s": restore_s, "verify_sample": int(probe.shape[0]),
        "verify_s": verify_s, "validate_s": validate_s, "delta": delta,
        "journal_group_commit": jab, "obs": obs.obs_section(),
        "device": device,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
