"""Fresh-insert split storm (the port's counterpart of
``tools/insert_bench.py``, BASELINE config 3 at scale): an 80-90%-full
tree absorbs a stream of fresh keys with device-side leaf splits,
``flush_parents`` and the router's ``note_split`` inside the timed loop.

    python -m sherman_tpu_torch.insert_bench [--keys 10000000]
        [--fresh 3000000] [--chunk 1048576] [--fill 0.9]
        [--split-slots 16384] [--nodes 1] [--verify] [--device cuda]

Key layout: warm and fresh keys come from one synthetic keyspace
(``mix64(rank ^ salt)``, ``bench.synthetic_keys``, the keys of
``native.synthetic_keyspace``), so fresh keys interleave uniformly across
the warm tree.  ``--nodes N`` emulates N nodes on the card, ``--chunk``
rows a node a call.

Prints per-chunk progress and one summary JSON line with the reference's
fields (``fresh_insert_ops_s``, ``splits_s``, ``device_splits``,
``host_path``, ``rounds_per_chunk``, ...) plus ``parent_flushes`` (the
flushes that posted entries) and ``wall_s`` (the loop's wall split into
the synced insert steps, ``_drain_split_log``, ``flush_parents`` and the
rest).  ``main(argv)`` returns the same dict.  Runs on the card; without
one it exits 2 unless given ``--device cpu``.

:func:`storm_build`, :class:`StormTimers` and :func:`storm` are the loop
``chip_smoke.py`` runs too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

from sherman_tpu_torch import tools_common as TC

STORM_SALT = 0x5E17AB1E5A17
STORM_XOR = np.uint64(0xBEEF)


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def storm_build(n_warm: int, n_fresh: int, device: str, *,
                machine_nr: int = 1, batch: int = 1 << 20,
                split_slots: int = 16_384, fill: float = 0.9,
                locks_per_node: int = 65_536, chunk_pages: int = 4096,
                host_step_capacity: int = 8192,
                write_combine: bool = False, log=_say) -> dict:
    """The split storm's tree, sized as ``tools/insert_bench.py`` sizes it:
    keys ``mix64(rank ^ 0x5E17AB1E5A17)``, the ``n_warm`` lowest ranks
    bulk-loaded (values ``key ^ 0xBEEF``) at ``fill`` with the router
    attached, the next ``n_fresh`` ranks shuffled with numpy seed 13; a
    pool of ``1 << max(14, bits(1.35 x leaves of all keys + 8192))`` pages
    a node; ``batch`` rows a call (``batch / machine_nr`` a node, the step
    capacity); ``parent_flush_threshold = split_slots``; write combining
    as ``write_combine`` says.
    -> {tree, eng, fresh, keys, fill}."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.bench import synthetic_keys
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    N = machine_nr
    total = n_warm + n_fresh
    est = int(total / int(C.LEAF_CAP * fill) * 1.35) + 8192
    pages = 1 << max(14, (est - 1).bit_length())
    cfg = DSMConfig(machine_nr=N, pages_per_node=pages,
                    locks_per_node=locks_per_node, step_capacity=batch // N,
                    chunk_pages=chunk_pages,
                    host_step_capacity=host_step_capacity, device=device)
    tree = Tree(Cluster(cfg))
    eng = batched.BatchedEngine(tree, batch_per_node=batch // N,
                                split_slots=split_slots,
                                write_combine=write_combine)
    # flush parent entries once a chunk, not a round: the router's
    # note_split keeps mid-chunk descents short
    eng.parent_flush_threshold = eng.split_slots
    _, keys = synthetic_keys(total, STORM_SALT)
    warm = np.sort(keys[:n_warm])
    fresh = keys[n_warm:].copy()
    np.random.default_rng(13).shuffle(fresh)  # arrival order != key order
    t = time.perf_counter()
    stats = batched.bulk_load(tree, warm, warm ^ STORM_XOR, fill=fill)
    router = eng.attach_router()
    log(f"storm tree: nodes={N} warm={n_warm} fresh={n_fresh} fill={fill} "
        f"pages_per_node={pages} batch={batch} split_slots="
        f"{eng.split_slots} {stats} router_log2_buckets={router.lb} "
        f"load_s={time.perf_counter() - t:.3f}")
    return {"tree": tree, "eng": eng, "fresh": fresh, "keys": keys,
            "fill": fill}


class StormTimers:
    """Wall time an engine spends in its insert steps (each synced, so the
    device work is inside), in ``_drain_split_log`` and in
    ``flush_parents`` (with its descents and host steps), and the
    flushes that had entries; installed on the instance, removed by
    :meth:`close`."""

    def __init__(self, eng):
        self.eng = eng
        self.s = {"device_rounds": 0.0, "drain_split_log": 0.0,
                  "flush_parents": 0.0}
        self.flushes = 0
        dev = eng.device
        get, drain, flush = (eng._get_insert, eng._drain_split_log,
                             eng.flush_parents)

        def timed(key, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                TC.sync(dev)
                self.s[key] += time.perf_counter() - t
                return out
            return call

        def flush_counted():
            n = flush()
            self.flushes += n > 0
            return n

        eng._get_insert = lambda *a, **kw: timed("device_rounds",
                                                 get(*a, **kw))
        eng._drain_split_log = timed("drain_split_log", drain)
        eng.flush_parents = timed("flush_parents", flush_counted)

    def close(self) -> None:
        for a in ("_get_insert", "_drain_split_log", "flush_parents"):
            delattr(self.eng, a)


def storm(ctx: dict, chunk: int, window=None, count_syncs=None,
          log=None) -> dict:
    """One warm-up chunk of ``max(4096, chunk // 64)`` keys outside the
    timed window (its host syncs counted by ``count_syncs(fn)`` when
    given), then every other fresh key through ``eng.insert`` in chunks
    of ``chunk`` inside ``window`` (a context manager; the smoke's launch
    log).  Every fresh key must be applied and none rejected.  -> the
    storm's record (the reference's fields, the wall split and the
    warm-up's stats)."""
    eng, fresh = ctx["eng"], ctx["fresh"]
    w = max(4096, chunk // 64)
    box = {}
    warm_up = lambda: box.update(st=eng.insert(fresh[:w],
                                               fresh[:w] ^ STORM_XOR))
    syncs = count_syncs(warm_up) if count_syncs is not None else None
    if syncs is None:
        warm_up()
    ws = {k: v for k, v in box["st"].items() if k != "lock_timeout_keys"}
    agg = {k: 0 for k in ("applied", "superseded", "host_path", "rounds",
                          "st_locked", "lock_timeouts", "device_splits")}
    timers = StormTimers(eng)
    chunks = 0
    try:
        with window if window is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            for i in range(w, fresh.size, chunk):
                ck = fresh[i:i + chunk]
                st = eng.insert(ck, ck ^ STORM_XOR)
                for k in agg:
                    agg[k] += st.get(k, 0)
                chunks += 1
                if log is not None:
                    dt = time.perf_counter() - t0
                    log(f"  chunk {chunks}: +{ck.size} keys, splits "
                        f"{agg['device_splits']}, rounds {st['rounds']}, "
                        f"host_path {agg['host_path']}, "
                        f"{(i + ck.size - w) / dt / 1e6:.2f} M ops/s cum")
            elapsed = time.perf_counter() - t0
    finally:
        timers.close()
    n_storm = fresh.size - w
    if agg["applied"] != n_storm or agg["lock_timeouts"]:
        raise AssertionError(f"storm: {agg} for {n_storm} keys")
    walls = dict(timers.s)
    walls["other_host"] = elapsed - sum(timers.s.values())
    return {
        "nodes": eng.cfg.machine_nr,
        "keys_warm": int(ctx["keys"].size - fresh.size),
        "keys_fresh": int(n_storm), "chunk": chunk,
        "split_slots": eng.split_slots, "elapsed_s": elapsed,
        "fresh_insert_ops_s": n_storm / elapsed,
        "splits_s": agg["device_splits"] / elapsed,
        "device_splits": agg["device_splits"],
        "host_path": agg["host_path"], "st_locked": agg["st_locked"],
        "lock_timeouts": agg["lock_timeouts"],
        "rounds_per_chunk": agg["rounds"] / max(1, chunks),
        "rounds": agg["rounds"], "chunks": chunks,
        "parent_flushes": timers.flushes, "wall_s": walls,
        "host_syncs_per_round": (None if syncs is None
                                 else syncs / max(1, ws["rounds"])),
        "warmup_chunk": w, "warmup_stats": ws,
        "router_splits_noted": eng.router.splits_noted}


def verify(ctx: dict) -> dict:
    """The reference's ``--verify``: every fresh key and a sample of at
    most ~1 M warm keys searched, then the structure validated on the
    device with the key count exact."""
    from sherman_tpu_torch.models.validate import check_structure_device
    eng, fresh, keys = ctx["eng"], ctx["fresh"], ctx["keys"]
    got, found = eng.search(fresh)
    assert found.all(), f"storm lost {int((~found).sum())} fresh keys"
    np.testing.assert_array_equal(got, fresh ^ STORM_XOR)
    warm = np.sort(keys[:keys.size - fresh.size])
    sample = warm[::max(1, warm.size // 1_000_000)]
    got, found = eng.search(sample)
    assert found.all(), "storm lost warm keys"
    np.testing.assert_array_equal(got, sample ^ STORM_XOR)
    info = check_structure_device(eng.tree)
    assert info["keys"] == keys.size, info
    return info


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="fresh-insert split storm of the PyTorch/CUDA port")
    ap.add_argument("--keys", type=int, default=10_000_000,
                    help="warm tree size (bulk-loaded)")
    ap.add_argument("--fresh", type=int, default=3_000_000,
                    help="fresh keys inserted during the timed storm")
    ap.add_argument("--chunk", type=int, default=1_048_576,
                    help="fresh keys per engine insert call")
    ap.add_argument("--fill", type=float, default=0.9,
                    help="bulk-load leaf fill (higher = more splits)")
    ap.add_argument("--split-slots", type=int, default=16_384,
                    help="fresh-page grant slots per node per round")
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--verify", action="store_true",
                    help="post-storm: search every fresh key + device "
                         "structure validation")
    TC.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    TC.require_device(a.device, "insert_bench")
    ctx = storm_build(a.keys, a.fresh, a.device, machine_nr=a.nodes,
                      batch=a.chunk * a.nodes, split_slots=a.split_slots,
                      fill=a.fill)
    rec = storm(ctx, a.chunk, log=_say)
    out = {
        "metric": "fresh_insert_split_storm",
        "value": round(rec["fresh_insert_ops_s"]),
        "unit": "ops/s",
        "keys_warm": rec["keys_warm"],
        "keys_fresh": rec["keys_fresh"],
        "fill": a.fill,
        "elapsed_s": round(rec["elapsed_s"], 2),
        "fresh_insert_ops_s": round(rec["fresh_insert_ops_s"]),
        "device_splits": rec["device_splits"],
        "splits_s": round(rec["splits_s"]),
        "host_path": rec["host_path"],
        "st_locked": rec["st_locked"],
        "rounds_per_chunk": round(rec["rounds_per_chunk"], 2),
        "parent_flushes": rec["parent_flushes"],
        "router_splits_noted": rec["router_splits_noted"],
        "chunk": a.chunk,
        "split_slots": rec["split_slots"],
        "nodes": a.nodes,
        "wall_s": rec["wall_s"],
    }
    if a.verify:
        t0 = time.perf_counter()
        info = verify(ctx)
        out["verified"] = True
        _say(f"verify {time.perf_counter() - t0:.1f}s: every fresh + "
             f"sampled-warm key present, structure valid ({info['keys']} "
             "keys)")
    _say(f"storm: {rec['keys_fresh']} fresh keys in {rec['elapsed_s']:.1f}s "
         f"-> {rec['fresh_insert_ops_s'] / 1e6:.2f} M inserts/s, "
         f"{rec['device_splits']} device splits, host_path "
         f"{rec['host_path']}, {ctx['tree'].dsm.counter_snapshot()}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
