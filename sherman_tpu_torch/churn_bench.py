"""Drifting-keyspace churn and reclamation (the port's counterpart of
``tools/churn_bench.py``): a sliding key window on a bounded pool.  Each
iteration inserts a fresh window of keys at the right edge of every
stream and deletes the oldest window; the empty-leaf reclaim pass
(unlink, parent cleanup, quarantine, free) runs inside the timed loop and
must keep occupancy flat.

    python -m sherman_tpu_torch.churn_bench [--keys 10000000]
        [--window 524288] [--iters 55] [--chunk 131072] [--max-rounds 24]
        [--reclaim-every 2] [--fill 0.75] [--slack 0.55] [--streams 0]
        [--no-reclaim] [--minutes 0] [--device cuda]

The keyspace is a multi-stream time series: key ``(stream << 44) | seq``,
``--streams`` streams (0: ``window / 128`` capped to 16..4096).  The pool
holds the warm leaves and ``(3 x reclaim_every + 2) x (1 + slack)``
window footprints.  ``--no-reclaim`` is the control: the reference's fate
on this workload, the pool exhausted within a few iterations, which ends
the run in ``MemoryError``.

Prints per-iteration pool telemetry and one JSON line with the
reference's fields (``churn_ops_s``, ``pool_live_first/last/max``,
``pool_flat``, ``reclaim_ms_mean``, ``tree_keys``, ...) plus ``wall_s``
(insert, delete, reclaim and reclaim's parent removal); ``main(argv)``
returns the same dict.  Runs on the card; without one it exits 2 unless
given ``--device cpu``.

:func:`churn_build`, :func:`churn_iteration`, :class:`ChurnTimers` and
:func:`churn` are the loop ``chip_smoke.py`` runs too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

from sherman_tpu_torch import tools_common as TC
from sherman_tpu_torch.insert_bench import STORM_XOR, StormTimers


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def stream_keys(i, streams: int) -> np.ndarray:
    """The churn's multi-stream time-series keyspace: key ``i`` is number
    ``i // streams + 1`` of stream ``i % streams``, ``stream << 44 | seq``."""
    i = np.asarray(i, np.uint64)
    return ((i % np.uint64(streams)) << np.uint64(44)) \
        | ((i // np.uint64(streams)) + np.uint64(1))


def churn_build(n_live: int, window: int, device: str, *,
                machine_nr: int = 1, chunk: int = 131_072,
                streams: int | None = None, fill: float = 0.5,
                slack: float = 0.55, reclaim_every: int = 1,
                step_capacity: int | None = None,
                locks_per_node: int = 1 << 20, chunk_pages: int = 1024,
                host_step_capacity: int = 8192, log=_say) -> dict:
    """The churn's tree, sized as ``tools/churn_bench.py`` sizes it: the
    ``n_live`` lowest keys of ``streams`` streams (``window // 128``,
    capped to 16..4096) bulk-loaded at ``fill`` (values ``key ^ 0xBEEF``)
    with the router; a pool of the warm leaves x 1.06 + 2048 pages and
    ``(3 x reclaim_every + 2) x (1 + slack)`` window footprints
    (``window / 24`` pages each) a node; ``chunk`` rows a call (``chunk /
    machine_nr`` a node); ``split_slots`` two window footprints (at most
    131,072), the parent flush at ``split_slots``.  -> {tree, eng,
    key_of, ...}."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    N = machine_nr
    S = streams or max(16, min(4096, window // 128))
    per_leaf = max(1, int(C.LEAF_CAP * fill))
    warm_pages = int(n_live / per_leaf * 1.06) + 2048
    win_pages = int(window / (C.LEAF_CAP // 2))
    # in flight before the first release: a deleted window is unlinked one
    # pass after its delete, then quarantined ~2 passes, +1 window for the
    # alternate-pair drain
    slack_pages = int(win_pages * (3 * reclaim_every + 2) * (1.0 + slack))
    pages = warm_pages + slack_pages
    cfg = DSMConfig(machine_nr=N, pages_per_node=pages,
                    locks_per_node=locks_per_node,
                    step_capacity=step_capacity or chunk // N,
                    chunk_pages=chunk_pages,
                    host_step_capacity=host_step_capacity, device=device)
    tree = Tree(Cluster(cfg))
    eng = batched.BatchedEngine(tree, batch_per_node=chunk // N,
                                split_slots=min(131_072, win_pages * 2))
    eng.parent_flush_threshold = eng.split_slots
    key_of = lambda i: stream_keys(i, S)
    t = time.perf_counter()
    warm = np.sort(key_of(np.arange(n_live, dtype=np.uint64)))
    stats = batched.bulk_load(tree, warm, warm ^ STORM_XOR, fill=fill)
    del warm
    router = eng.attach_router()
    log(f"churn tree: nodes={N} live={n_live} window={window} streams={S} "
        f"fill={fill} pages_per_node={pages} "
        f"({pages * C.PAGE_BYTES / 2**20:.1f} MiB a node, warm ~{warm_pages},"
        f" slack {slack_pages}) chunk={chunk} split_slots={eng.split_slots} "
        f"{stats} router_log2_buckets={router.lb} "
        f"load_s={time.perf_counter() - t:.3f}")
    return {"tree": tree, "eng": eng, "key_of": key_of, "streams": S,
            "n_live": n_live, "window": window, "chunk": chunk,
            "win_pages": win_pages, "pages": pages, "cfg": cfg,
            "reclaim_every": reclaim_every, "lo": 0, "hi": n_live}


def pool_live(tree) -> tuple[int, int]:
    """(pages allocated and not in a free pool, pages in the free pools)
    over every node, the tool's occupancy."""
    used = free = 0
    for d in tree.cluster.directories:
        used += d.allocator.pages_used
        free += d.allocator.pages_free
    return used - free, free


def churn_iteration(ctx: dict, rng, walls: dict | None = None,
                    max_rounds: int = 24, reclaim: bool = True) -> dict:
    """One iteration of the tool's loop: the next window inserted in
    ascending chunks, each shuffled; the oldest window deleted; one
    reclaim pass when ``reclaim``.  Adds each part's wall to ``walls``.
    -> {insert stats summed, found masks, reclaim stats (None without the
    pass), pages taken from the free pools by the inserts}."""
    eng, key_of = ctx["eng"], ctx["key_of"]
    W, chunk = ctx["window"], ctx["chunk"]
    lo, hi = ctx["lo"], ctx["hi"]
    walls = {} if walls is None else walls

    def tick(k, t):
        TC.sync(eng.device)
        walls[k] = walls.get(k, 0.0) + time.perf_counter() - t

    ins = {}
    free0 = pool_live(eng.tree)[1]
    fresh = key_of(np.arange(hi, hi + W, dtype=np.uint64))
    for i in range(0, W, chunk):
        # ascending chunks, each shuffled (arrival order uncorrelated with
        # key order), so each chunk's split cascade builds on the last
        ck = fresh[i:i + chunk].copy()
        rng.shuffle(ck)
        t = time.perf_counter()
        st = eng.insert(ck, ck ^ STORM_XOR, max_rounds=max_rounds)
        tick("insert", t)
        for k, v in st.items():
            if k != "lock_timeout_keys":
                ins[k] = ins.get(k, 0) + v
    reused = free0 - pool_live(eng.tree)[1]
    dead = key_of(np.arange(lo, lo + W, dtype=np.uint64))
    found = []
    for i in range(0, W, chunk):
        t = time.perf_counter()
        found.append(eng.delete(dead[i:i + chunk]))
        tick("delete", t)
    rec = None
    if reclaim:
        t = time.perf_counter()
        rec = eng.reclaim_empty_leaves()
        tick("reclaim", t)
        walls.setdefault("reclaim_passes", []).append(
            time.perf_counter() - t)
    ctx["lo"], ctx["hi"] = lo + W, hi + W
    return {"insert": ins, "found": np.concatenate(found), "reclaim": rec,
            "pages_reused": reused}


class ChurnTimers:
    """Wall time an engine spends in ``_remove_parent_entries`` (reclaim's
    parent removal, its descent and host steps), installed on the
    instance, removed by :meth:`close`."""

    def __init__(self, eng):
        self.eng = eng
        self.s = 0.0
        fn = eng._remove_parent_entries

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s += time.perf_counter() - t

        eng._remove_parent_entries = timed

    def close(self) -> None:
        delattr(self.eng, "_remove_parent_entries")


def churn(ctx: dict, iters: int, window=None, count_syncs=None, *,
          no_reclaim: bool = False, minutes: float = 0.0,
          max_rounds: int = 24, log=None) -> dict:
    """The tool's warm-up outside the timed window (one insert of
    ``min(16,384, window)`` fresh keys, its delete, whose rounds and host
    syncs (``count_syncs(fn)``, when given) are counted, and one reclaim
    pass), then ``iters`` iterations (or ``minutes`` of them) inside
    ``window`` (a context manager; the smoke's launch log), a reclaim pass
    every ``ctx["reclaim_every"]`` iterations unless ``no_reclaim``.
    Every delete must find its keys.  The inserts' wall is split as the
    storm's is.  -> the churn's record (no verification; see
    :func:`verify`)."""
    eng, key_of = ctx["eng"], ctx["key_of"]
    n_live, W = ctx["n_live"], ctx["window"]
    re_every = ctx["reclaim_every"]
    w = min(16_384, W)
    wf = key_of(np.arange(n_live, n_live + w, dtype=np.uint64))
    eng.insert(wf, wf ^ STORM_XOR)
    get_delete, rounds = eng._get_delete, []
    eng._get_delete = lambda *a: rounds.append(a) or get_delete(*a)
    box = {}
    del_once = lambda: box.update(f=eng.delete(wf))
    try:
        syncs = count_syncs(del_once) if count_syncs is not None else None
        if syncs is None:
            del_once()
    finally:
        del eng._get_delete
    if not box["f"].all():
        raise AssertionError("churn warm-up: a key of the warm-up insert "
                             "was not found by its delete")
    if not no_reclaim:
        eng.reclaim_empty_leaves()
    rng = np.random.default_rng(23)
    occ = [pool_live(eng.tree)[0]]
    parked = [len(eng._reclaim_state["parked"])]
    walls: dict = {"insert": 0.0, "delete": 0.0, "reclaim": 0.0}
    agg = {"unlinked": 0, "freed": 0}
    ins = {}
    reused = 0
    last = None
    timers, ins_timers = ChurnTimers(eng), StormTimers(eng)
    it = 0
    try:
        with window if window is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            while (time.perf_counter() - t0 <= minutes * 60 if minutes > 0
                   else it < iters):
                r = churn_iteration(
                    ctx, rng, walls, max_rounds=max_rounds,
                    reclaim=(not no_reclaim
                             and it % re_every == re_every - 1))
                if not r["found"].all():
                    raise AssertionError("churn: a live key of the oldest "
                                         "window was not found by its "
                                         "delete")
                if r["reclaim"] is not None:
                    last = r["reclaim"]
                    for k in agg:
                        agg[k] += last[k]
                for k, v in r["insert"].items():
                    ins[k] = ins.get(k, 0) + v
                reused += r["pages_reused"]
                occ.append(pool_live(eng.tree)[0])
                parked.append(len(eng._reclaim_state["parked"]))
                it += 1
                if log is not None:
                    dt = time.perf_counter() - t0
                    log(f"  iter {it}: {2 * W * it / dt / 1e3:.1f} K ops/s "
                        f"cum, pool live {occ[-1]}, parked {parked[-1]}, "
                        f"reclaimed {agg['freed']}")
            elapsed = time.perf_counter() - t0
    finally:
        timers.close()
        ins_timers.close()
    win_pages, cp = ctx["win_pages"], ctx["cfg"].chunk_pages
    # flat: growth since the first full unlink -> quarantine -> release
    # cycle stays within the in-flight window footprint plus chunk-lease
    # granularity (the baseline clamped to the run's midpoint)
    base = occ[max(1, min(len(occ) - 1, 3 * re_every + 1,
                          (len(occ) - 1) // 2))]
    wall = {"insert": walls["insert"],
            **{"insert." + k: v for k, v in ins_timers.s.items()},
            "delete": walls["delete"], "reclaim": walls["reclaim"],
            "reclaim.parent_removal": timers.s}
    wall["other"] = elapsed - walls["insert"] - walls["delete"] \
        - walls["reclaim"]
    n_ops = 2 * W * it
    return {
        "nodes": eng.cfg.machine_nr, "keys_live": n_live, "window": W,
        "streams": ctx["streams"], "chunk": ctx["chunk"],
        "pool_pages": ctx["pages"], "split_slots": eng.split_slots,
        "iters": it, "elapsed_s": elapsed, "churn_ops_s": n_ops / elapsed,
        "wall_s": wall, "reclaim_s": walls.get("reclaim_passes", []),
        "unlinked": agg["unlinked"], "freed": agg["freed"],
        "quarantined": None if last is None else last["quarantined"],
        "parked": None if last is None else last["parked"],
        "parked_final": parked[-1],
        "pool_live": occ, "pool_flat": bool(
            occ[-1] - base <= (3 * re_every + 2) * win_pages + 2 * cp),
        "pages_reused": reused, "host_path": ins.get("host_path", 0),
        "insert_rounds": ins.get("rounds", 0),
        "parent_flushes": ins_timers.flushes,
        "device_splits": ins.get("device_splits", 0),
        "st_locked": ins.get("st_locked", 0),
        "lock_timeouts": ins.get("lock_timeouts", 0),
        "delete_rounds": len(rounds), "delete_chunk": int(w),
        "host_syncs": syncs}


def verify(ctx: dict, probe_every: int = 1) -> int:
    """The live window searched (every ``probe_every``-th key), the last
    deleted window probed (10,000 keys, none found) and the live slots
    counted: they must equal the live window.  -> the live slot count."""
    from sherman_tpu_torch.models import validate
    eng, key_of, W = ctx["eng"], ctx["key_of"], ctx["window"]
    lo, hi = ctx["lo"], ctx["hi"]
    live = key_of(np.arange(lo, hi, dtype=np.uint64))[::probe_every]
    TC.verify_all(eng, live, STORM_XOR)
    _, f_old = eng.search_combined(key_of(np.arange(
        max(0, lo - W), lo, dtype=np.uint64))[:10_000])
    if f_old.any():
        raise AssertionError(f"churn: {int(f_old.sum())} deleted keys "
                             "found")
    tree_keys = int(validate.leaf_chain_info(eng.tree)[4].sum())
    if tree_keys != hi - lo:
        raise AssertionError(f"churn: {tree_keys} live slots for "
                             f"{hi - lo} live keys")
    return tree_keys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="drifting-keyspace churn and reclaim of the "
                    "PyTorch/CUDA port")
    ap.add_argument("--keys", type=int, default=10_000_000,
                    help="live keys at any moment")
    ap.add_argument("--window", type=int, default=524_288,
                    help="keys inserted + deleted per iteration")
    ap.add_argument("--iters", type=int, default=55)
    ap.add_argument("--chunk", type=int, default=131_072,
                    help="engine call width")
    ap.add_argument("--max-rounds", type=int, default=24,
                    help="insert round budget per chunk")
    ap.add_argument("--reclaim-every", type=int, default=2,
                    help="reclaim pass cadence (iterations)")
    ap.add_argument("--fill", type=float, default=0.75)
    ap.add_argument("--slack", type=float, default=0.55,
                    help="pool slack over the warm tree, in units of "
                         "window-leaf footprints")
    ap.add_argument("--streams", type=int, default=0,
                    help="append streams (0 = auto: window/128, capped "
                         "16..4096)")
    ap.add_argument("--no-reclaim", action="store_true",
                    help="control: the reference's behavior (pool leaks)")
    ap.add_argument("--minutes", type=float, default=0.0,
                    help="if > 0, keep iterating until this much wall "
                         "time has passed (overrides --iters)")
    TC.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    TC.require_device(a.device, "churn_bench")
    ctx = churn_build(a.keys, a.window, a.device, chunk=a.chunk,
                      streams=a.streams or None, fill=a.fill, slack=a.slack,
                      reclaim_every=a.reclaim_every)
    rec = churn(ctx, a.iters, no_reclaim=a.no_reclaim, minutes=a.minutes,
                max_rounds=a.max_rounds, log=_say)
    t = time.perf_counter()
    tree_keys = verify(ctx, max(1, (ctx["hi"] - ctx["lo"]) // 50_000))
    _say(f"verify done in {time.perf_counter() - t:.1f}s: {tree_keys} keys")
    occ, rs = rec["pool_live"], [s * 1e3 for s in rec["reclaim_s"]]
    out = {
        "metric": "churn_reclaim",
        "value": round(rec["churn_ops_s"]),
        "unit": "ops/s",
        "churn_ops_s": round(rec["churn_ops_s"]),
        "iters": rec["iters"],
        "elapsed_s": round(rec["elapsed_s"], 1),
        "window": a.window,
        "keys_live": a.keys,
        "pool_pages": ctx["pages"],
        "pool_live_first": occ[1] if len(occ) > 1 else occ[0],
        "pool_live_last": occ[-1],
        "pool_live_max": max(occ),
        "pool_flat": rec["pool_flat"],
        "parked_final": rec["parked_final"],
        "reclaim_passes": len(rs),
        "reclaim_ms_mean": round(float(np.mean(rs)), 1) if rs else None,
        "reclaim_ms_max": round(float(np.max(rs)), 1) if rs else None,
        "unlinked": rec["unlinked"],
        "freed": rec["freed"],
        "tree_keys": tree_keys,
        "no_reclaim": a.no_reclaim,
        "wall_s": rec["wall_s"],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
