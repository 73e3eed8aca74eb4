"""YCSB A-F matrix driver of the PyTorch/CUDA port (counterpart of
``tools/ycsb_bench.py``): the core workloads of
:mod:`sherman_tpu_torch.workload.ycsb` as bench rows over one bulk-loaded
tree, on the card.

- **A/B** (zipf read/update) ride the fused ``mixed`` step inline, or
  the value heap's ``get``/``put`` with variable-length payloads;
- **C** (zipf read-only) runs ``search_combined``, or with the heap on
  ``ValueHeap.get`` (the fan-out and the heap gather in one call);
- **D** (read-latest + inserts) advances the insert frontier;
- **E** (scans + inserts) drives ``range_query_many`` (with the heap on,
  ``ValueHeap.scan``: every hit's payload gathered in one resolve);
- **F** (read-modify-write) reads, then writes each value xor 1 back (or
  with the heap, the payload with one byte appended).

Every row publishes its analytic twin (the op-class mix by construction,
the expected rows per scan in the hashed keyspace) next to the measured
numbers.  With the heap on (``SHERMAN_VALUE_HEAP`` pages a node), the
build migrates every loaded record out of line (``--value-bytes``,
``--value-dist``), and the line adds the heap's stats, ``heap_phase_ms``
(the fan-out alone against the fan-out with the heap gather, and the
resolve alone) and ``audit_ok`` (device payloads against the host
resolver on a sample); ``--ab`` adds YCSB-C inline against the heap at
28 B and 252 B records, each arm on a fresh tree.  Run on the GPU::

    python -m sherman_tpu_torch.ycsb_bench [--keys 200000] [--ops 8192]
        [--steps 8] [--theta 0.99] [--workloads A,B,C,D,E,F] [--nodes 1]
        [--value-bytes 64] [--value-dist fixed] [--ab]
    python -m sherman_tpu_torch.bench --ycsb [the same arguments]

``SHERMAN_BENCH_KEYS``, ``SHERMAN_YCSB_OPS``, ``SHERMAN_YCSB_WORKLOADS``,
``SHERMAN_VALUE_BYTES`` and ``SHERMAN_VALUE_DIST`` are the environment
twins of the arguments.  Prints one JSON line (``metric: ycsb_matrix``)
with the card's name and power limit; without a CUDA device it exits with
code 2.  ``--nodes N`` emulates N nodes on the card.

As in the reference, YCSB-C's timed steps run with the program ledger
sealed (``sealed``; ``retraces`` counts new program shapes in the window
and must be 0), and the line carries the ``obs`` section (the registry
snapshot and the span summary: per-class ``slo.*`` latencies, ``dsm.*``
op counts, ``kernels.*`` launches).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

SALT = 0x5E17_AB1E_5A17


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def pages_for_keys(n_keys: int, fill: float = 0.75) -> int:
    """Pool pages a node for ``n_keys`` keys at leaf ``fill``: 10% slack
    and 8,192 pages over the leaves, rounded up to a power of two."""
    from sherman_tpu_torch.config import LEAF_CAP
    per_leaf = max(1, int(LEAF_CAP * fill))
    est = int(n_keys / per_leaf * 1.10) + 8192
    return 1 << max(12, (est - 1).bit_length())


def synthetic_keys(n_keys: int, salt: int = SALT) -> np.ndarray:
    """The keys ``mix64(rank ^ salt)`` of the ranks below ``n_keys``,
    sorted and distinct."""
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.utils import sorted_unique
    return sorted_unique(bits.mix64_np(np.arange(n_keys, dtype=np.uint64)
                                       ^ np.uint64(salt)))


def build(n_keys: int, ops: int, nodes: int, device: str = "cuda", *,
          step_capacity: int | None = None, log=_say,
          heap_pages: int | None = None, value_bytes: int = 64,
          value_dist: str = "fixed", migrate: bool = True):
    """The tool's tree: keys ``mix64(rank ^ SALT)`` for ranks below
    ``n_keys``, values ``key ^ 0xD00D``, bulk-loaded at fill 0.75 into a
    pool sized for the D/E inserts too, with the router attached; an
    engine of ``max(256, ceil(ops / nodes))`` rows a node and a sibling
    chase budget of 2.  ``step_capacity`` None is the tool's
    ``max(512, min(ops, 8192))``.  ``heap_pages`` (None: the
    ``SHERMAN_VALUE_HEAP`` knob) > 0 gives the DSM a value heap of that
    many pages a node and attaches a ``ValueHeap`` (``eng.value_heap``),
    and with ``migrate`` moves every record out of line
    (:func:`migrate_to_heap`).  -> (cluster, tree, eng, keys)."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import (DSMConfig, TreeConfig,
                                          value_heap_pages)
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    if heap_pages is None:
        heap_pages = value_heap_pages()
    t0 = time.perf_counter()
    keys = synthetic_keys(n_keys)
    vals = keys ^ np.uint64(0xD00D)
    # D/E grow the frontier ~5% of the op budget: size the pool for it
    grow = max(1024, ops * 64 // 8)
    cfg = DSMConfig(
        machine_nr=nodes,
        pages_per_node=pages_for_keys((n_keys + grow) // nodes + 1),
        locks_per_node=16384,
        step_capacity=step_capacity or max(512, min(ops, 8192)),
        chunk_pages=256, heap_pages_per_node=heap_pages, device=device)
    cluster = Cluster(cfg)
    tree = Tree(cluster)
    stats = batched.bulk_load(tree, keys, vals)
    del vals
    eng = batched.BatchedEngine(
        tree, batch_per_node=max(256, -(-ops // nodes)),
        tcfg=TreeConfig(sibling_chase_budget=2))
    router = eng.attach_router()
    log(f"ycsb tree: nodes={nodes} keys={n_keys} pages_per_node="
        f"{cfg.pages_per_node} step_capacity={cfg.step_capacity} "
        f"batch_per_node={eng.B} {stats} router_log2_buckets={router.lb} "
        f"build_s={time.perf_counter() - t0:.3f}")
    if heap_pages:
        vh = eng.attach_value_heap()
        if migrate:
            dt = migrate_to_heap(vh, keys, ops, value_bytes, value_dist)
            log(f"heap migration: {keys.size} records of {value_bytes} B "
                f"({value_dist}) in {dt:.3f} s; {vh.stats()}")
    return cluster, tree, eng, keys


def migrate_to_heap(vh, keys, ops: int, value_bytes: int,
                    value_dist: str = "fixed") -> float:
    """Move every loaded record out of line: ``vh.put`` of each key's
    ``payload_for_key`` record in chunks of ``max(1024, ops)`` keys (the
    reference tool's migration).  -> seconds."""
    from sherman_tpu_torch.workload.ycsb import payloads_of
    t0 = time.perf_counter()
    step = max(1024, ops)
    for i in range(0, keys.size, step):
        ck = keys[i: i + step]
        vh.put(ck, payloads_of(ck, value_bytes, value_dist))
    return time.perf_counter() - t0


def _percentiles(walls_ms):
    w = np.sort(np.asarray(walls_ms))
    if w.size == 0:
        return 0.0, 0.0
    return (float(w[int(0.5 * (w.size - 1))]),
            float(w[int(np.ceil(0.99 * (w.size - 1)))]))


def run_workload(eng, gen, *, ops: int, steps: int,
                 seal: bool = False, vh=None) -> dict:
    """One warm-up batch, then ``steps`` closed-loop batches of ``ops``
    ops drawn from ``gen`` (a :class:`~sherman_tpu_torch.workload.ycsb.
    YcsbGen`), each played to its end (every call returns host arrays),
    with the program ledger sealed around them when ``seal``.  With
    ``vh`` (a ``ValueHeap``) every read, update, insert, read-modify-
    write and scan goes through the heap's payload API.
    -> the workload's row: ops/s over the timed steps, p50/p99 step
    wall, the op counts, the analytic expectations, ``sealed`` and
    ``retraces``."""
    from sherman_tpu_torch.obs import device as DEV
    from sherman_tpu_torch.workload.ycsb import payloads_of
    counts = {"read": 0, "update": 0, "insert": 0, "rmw": 0,
              "scan": 0, "scan_rows": 0, "scan_rows_expected": 0}

    def play(b) -> None:
        heap = vh is not None
        rk = b.get("read")
        uk = b.get("update")
        if not heap and rk is not None and uk is not None \
                and "scan" not in b and "rmw" not in b:
            # the fused mixed step serves the whole read+update batch
            keys = np.concatenate([rk, uk])
            isr = np.zeros(keys.size, bool)
            isr[: rk.size] = True
            eng.mixed(keys, keys ^ np.uint64(0xBEEF), isr)
            counts["read"] += rk.size
            counts["update"] += uk.size
            rk = uk = None
        if rk is not None:
            (vh.get(rk) if heap else eng.search_combined(rk))
            counts["read"] += rk.size
        if uk is not None:
            if heap:
                vh.put(uk, payloads_of(uk ^ np.uint64(1), gen.value_bytes,
                                       gen.value_dist))
            else:
                eng.insert(uk, uk ^ np.uint64(0xBEEF))
            counts["update"] += uk.size
        ik = b.get("insert")
        if ik is not None:
            if heap:
                vh.put(ik, gen.payloads_for_keys(ik))
            else:
                eng.insert(ik, ik ^ np.uint64(0xD00D))
            counts["insert"] += ik.size
        fk = b.get("rmw")
        if fk is not None:
            if heap:
                got, _ = vh.get(fk)
                vh.put(fk, [(g or b"\x00") + b"!"
                            if len(g or b"") < gen.value_bytes
                            else (g or b"\x00")
                            for g in got])
            else:
                v, _ = eng.search_combined(fk)
                eng.insert(fk, v ^ np.uint64(1))
            counts["rmw"] += fk.size
        sc = b.get("scan")
        if sc is not None:
            res = vh.scan(sc) if heap else eng.range_query_many(sc)
            counts["scan"] += len(sc)
            counts["scan_rows"] += int(sum(len(r[0]) for r in res))
            counts["scan_rows_expected"] += int(
                b.get("scan_expected_rows", 0))

    play(gen.batch(ops))     # warm-up: every class's first call
    ledger = DEV.get_ledger()
    r0 = ledger.retraces
    if seal:
        ledger.seal()
    walls = []
    t0 = time.perf_counter()
    try:
        for _ in range(steps):
            ts = time.perf_counter()
            play(gen.batch(ops))
            walls.append((time.perf_counter() - ts) * 1e3)
    finally:
        if seal:
            ledger.unseal()
    total_s = time.perf_counter() - t0
    p50, p99 = _percentiles(walls)
    out = {
        "ops": ops * steps,
        "ops_s": ops * steps / total_s,
        "step_p50_ms": p50,
        "step_p99_ms": p99,
        "counts": {k: int(v) for k, v in counts.items() if v},
        "analytic": gen.expectations(),
        "sealed": bool(seal),
        "retraces": int(ledger.retraces - r0),
    }
    if counts["scan"]:
        out["scan_rows_per_scan"] = counts["scan_rows"] / counts["scan"]
        out["scan_rows_expected_per_scan"] = (
            counts["scan_rows_expected"] / counts["scan"])
    return out


def heap_phase_attribution(eng, vh, keys, ops: int, reps: int = 4) -> dict:
    """The heap read path's time split: ``search_combined`` (the fan-out
    alone), ``vh.get`` (the fan-out and the heap gather) and the resolve
    alone, in ms a call of ``ops`` keys (the mean of ``reps`` calls after
    one warm call; every call returns host arrays)."""
    rng = np.random.default_rng(3)
    kb = keys[rng.integers(0, keys.size, ops)]
    dev = eng.dsm.pool.device

    def t(fn):
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / reps * 1e3

    fanout_ms = t(lambda: eng.search_combined(kb))
    fused_ms = t(lambda: vh.get(kb))
    vals, found = eng.search_combined(kb)
    resolve_ms = t(lambda: vh.resolve_u64(vals, found))
    return {"read_fanout_ms": fanout_ms, "fused_read_ms": fused_ms,
            "heap_gather_ms": resolve_ms,
            "fused_overhead_ms": fused_ms - fanout_ms}


def audit_heap(eng, vh, keys, n: int = 256) -> bool:
    """A sample's device payloads against the host reference resolver:
    True when every found flag and payload agrees."""
    rng = np.random.default_rng(11)
    ks = keys[rng.integers(0, keys.size, n)]
    dev, found = vh.get(ks)
    vals, f2 = eng.search(ks)
    ref, ok = vh.resolve_host(vals, f2)
    for i in range(ks.size):
        if bool(found[i]) != bool(f2[i] and ok[i]):
            return False
        if found[i] and dev[i] != ref[i]:
            return False
    return True


def heap_pages_for(n_keys: int, value_bytes: int, nodes: int = 1) -> int:
    """Heap pages a node for ``n_keys`` records of ``value_bytes``: the
    reference tool's A/B sizing (a slab a record, an eighth more, 64
    spare pages)."""
    from sherman_tpu_torch.models import value_heap as VH
    cls = VH.class_for_bytes(value_bytes)
    slabs = VH.SLAB_REGION_WORDS // VH.HEAP_CLASSES[cls]
    return n_keys // slabs // max(1, nodes) + n_keys // slabs // 8 + 64


def run_c_ab(keys: int, ops: int, steps: int, nodes: int = 1,
             theta: float = 0.99, device: str = "cuda", log=_say) -> dict:
    """YCSB-C with inline values against the heap at two size classes
    (28 B and 252 B), each arm on a fresh tree (no arm shares warm
    shapes or pool state with another), sealed."""
    from sherman_tpu_torch.workload.ycsb import YcsbGen
    arms = {}
    for label, vb in (("inline", 8), ("heap_28B", 28), ("heap_252B", 252)):
        hp = 0 if label == "inline" else heap_pages_for(keys, vb, nodes)
        cluster, tree, eng, _ = build(keys, ops, nodes, device,
                                      heap_pages=hp, value_bytes=vb,
                                      value_dist="fixed", log=log)
        gen = YcsbGen("C", keys, theta=theta, seed=17, salt=SALT,
                      value_bytes=vb, value_dist="fixed")
        arms[label] = run_workload(eng, gen, ops=ops, steps=steps,
                                   seal=True, vh=eng.value_heap)
        arms[label]["value_bytes"] = vb
        arms[label]["heap_pages_per_node"] = hp
        log(f"YCSB-C A/B {label}: {arms[label]['ops_s']:,.0f} ops/s")
        del cluster, tree, eng
        _release(device)
    return arms


def _release(device) -> None:
    """Free a dropped tree's device memory before the next one."""
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="YCSB A-F matrix bench of the "
                                 "PyTorch/CUDA port (on the GPU)")
    ap.add_argument("--keys", type=int, default=int(os.environ.get(
        "SHERMAN_BENCH_KEYS", 200_000)))
    ap.add_argument("--ops", type=int, default=int(os.environ.get(
        "SHERMAN_YCSB_OPS", 8192)), help="ops per closed-loop step")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--theta", type=float, default=0.99)
    ap.add_argument("--workloads", default=os.environ.get(
        "SHERMAN_YCSB_WORKLOADS", "A,B,C,D,E,F"))
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--value-bytes", type=int, default=int(os.environ.get(
        "SHERMAN_VALUE_BYTES", 64)))
    ap.add_argument("--value-dist", default=os.environ.get(
        "SHERMAN_VALUE_DIST", "fixed"), choices=("fixed", "uniform"))
    ap.add_argument("--ab", action="store_true",
                    help="YCSB-C heap-on vs inline A/B at 2 size classes")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sherman_tpu_torch.ycsb_bench: no CUDA device; the port's "
              "benchmark runs on the GPU", file=sys.stderr)
        return 2
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.bench import _device_info
    from sherman_tpu_torch.config import value_heap_pages
    from sherman_tpu_torch.workload.ycsb import YcsbGen

    device = _device_info()
    heap_pages = value_heap_pages()
    cluster, tree, eng, keys = build(a.keys, a.ops, a.nodes, "cuda",
                                     heap_pages=heap_pages,
                                     value_bytes=a.value_bytes,
                                     value_dist=a.value_dist)
    vh = eng.value_heap
    rows = {}
    for w in [w.strip().upper() for w in a.workloads.split(",")
              if w.strip()]:
        gen = YcsbGen(w, a.keys, theta=a.theta, seed=17, salt=SALT,
                      value_bytes=a.value_bytes, value_dist=a.value_dist)
        rows[w] = run_workload(eng, gen, ops=a.ops, steps=a.steps,
                               seal=(w == "C"), vh=vh)
        _say(f"YCSB-{w}: {rows[w]['ops_s']:,.0f} ops/s "
             f"(p99 {rows[w]['step_p99_ms']:.3f} ms/step)")
    out = {
        "metric": "ycsb_matrix",
        "schema_version": 3,
        "keys": a.keys,
        "batch": a.ops,
        "nodes": a.nodes,
        "theta": a.theta,
        "workloads": rows,
        "config": {"value_bytes": a.value_bytes if heap_pages else 8,
                   "value_dist": a.value_dist if heap_pages else "fixed",
                   "value_heap": bool(heap_pages),
                   "heap_pages_per_node": heap_pages,
                   "torch": torch.__version__, "cuda": torch.version.cuda},
    }
    if vh is not None:
        out["heap"] = vh.stats()
        out["heap_phase_ms"] = heap_phase_attribution(eng, vh, keys, a.ops)
        out["audit_ok"] = audit_heap(eng, vh, keys)
    if a.ab and heap_pages:
        del cluster, tree, eng, vh
        _release("cuda")
        out["ycsb_c_ab"] = run_c_ab(a.keys, a.ops, a.steps, a.nodes,
                                    a.theta)
    out["obs"] = obs.obs_section()
    out["device"] = device
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
