"""YCSB A-F matrix driver of the PyTorch/CUDA port (counterpart of
``tools/ycsb_bench.py``): the core workloads of
:mod:`sherman_tpu_torch.workload.ycsb` as bench rows over one bulk-loaded
tree, on the card.

- **A/B** (zipf read/update) ride the fused ``mixed`` step;
- **C** (zipf read-only) runs ``search_combined``;
- **D** (read-latest + inserts) advances the insert frontier;
- **E** (scans + inserts) drives ``range_query_many``;
- **F** (read-modify-write) reads with ``search_combined``, then writes
  each value xor 1 back through ``insert``.

Every row publishes its analytic twin (the op-class mix by construction,
the expected rows per scan in the hashed keyspace) next to the measured
numbers.  Run on the GPU::

    python -m sherman_tpu_torch.ycsb_bench [--keys 200000] [--ops 8192]
        [--steps 8] [--theta 0.99] [--workloads A,B,C,D,E,F] [--nodes 1]
    python -m sherman_tpu_torch.bench --ycsb [the same arguments]

``SHERMAN_BENCH_KEYS``, ``SHERMAN_YCSB_OPS`` and
``SHERMAN_YCSB_WORKLOADS`` are the environment twins of ``--keys``,
``--ops`` and ``--workloads``.  Prints one JSON line (``metric:
ycsb_matrix``) with the card's name and power limit; without a CUDA
device it exits with code 2.  ``--nodes N`` emulates N nodes on the card.

As in the reference, YCSB-C's timed steps run with the program ledger
sealed (``sealed``; ``retraces`` counts new program shapes in the window
and must be 0), and the line carries the ``obs`` section (the registry
snapshot and the span summary: per-class ``slo.*`` latencies, ``dsm.*``
op counts, ``kernels.*`` launches).

Not here yet: the value heap's paths (``--value-bytes``,
``--value-dist``, ``--ab``, the heap phase attribution and audit) wait
for ``models/value_heap.py`` (ROADMAP item 6b), and a nonzero
``SHERMAN_VALUE_HEAP`` is refused.
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
          step_capacity: int | None = None, log=_say):
    """The tool's tree: keys ``mix64(rank ^ SALT)`` for ranks below
    ``n_keys``, values ``key ^ 0xD00D``, bulk-loaded at fill 0.75 into a
    pool sized for the D/E inserts too, with the router attached; an
    engine of ``max(256, ceil(ops / nodes))`` rows a node and a sibling
    chase budget of 2.  ``step_capacity`` None is the tool's
    ``max(512, min(ops, 8192))``.  -> (cluster, tree, eng, keys)."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import (DSMConfig, TreeConfig,
                                          value_heap_pages)
    from sherman_tpu_torch.errors import NotPortedError
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    if value_heap_pages():
        raise NotPortedError(
            "SHERMAN_VALUE_HEAP asks for the value heap, which the port "
            "does not have yet (models/value_heap.py, ROADMAP item 6b); "
            "unset it to run the matrix with inline values")
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
        chunk_pages=256, device=device)
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
    return cluster, tree, eng, keys


def _percentiles(walls_ms):
    w = np.sort(np.asarray(walls_ms))
    if w.size == 0:
        return 0.0, 0.0
    return (float(w[int(0.5 * (w.size - 1))]),
            float(w[int(np.ceil(0.99 * (w.size - 1)))]))


def run_workload(eng, gen, *, ops: int, steps: int,
                 seal: bool = False) -> dict:
    """One warm-up batch, then ``steps`` closed-loop batches of ``ops``
    ops drawn from ``gen`` (a :class:`~sherman_tpu_torch.workload.ycsb.
    YcsbGen`), each played to its end (every call returns host arrays),
    with the program ledger sealed around them when ``seal``.
    -> the workload's row: ops/s over the timed steps, p50/p99 step
    wall, the op counts, the analytic expectations, ``sealed`` and
    ``retraces``."""
    from sherman_tpu_torch.obs import device as DEV
    counts = {"read": 0, "update": 0, "insert": 0, "rmw": 0,
              "scan": 0, "scan_rows": 0, "scan_rows_expected": 0}

    def play(b) -> None:
        rk = b.get("read")
        uk = b.get("update")
        if rk is not None and uk is not None \
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
            eng.search_combined(rk)
            counts["read"] += rk.size
        if uk is not None:
            eng.insert(uk, uk ^ np.uint64(0xBEEF))
            counts["update"] += uk.size
        ik = b.get("insert")
        if ik is not None:
            eng.insert(ik, ik ^ np.uint64(0xD00D))
            counts["insert"] += ik.size
        fk = b.get("rmw")
        if fk is not None:
            v, _ = eng.search_combined(fk)
            eng.insert(fk, v ^ np.uint64(1))
            counts["rmw"] += fk.size
        sc = b.get("scan")
        if sc is not None:
            res = eng.range_query_many(sc)
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
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sherman_tpu_torch.ycsb_bench: no CUDA device; the port's "
              "benchmark runs on the GPU", file=sys.stderr)
        return 2
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.bench import _device_info
    from sherman_tpu_torch.workload.ycsb import YcsbGen

    device = _device_info()
    _, _, eng, _ = build(a.keys, a.ops, a.nodes, "cuda")
    rows = {}
    for w in [w.strip().upper() for w in a.workloads.split(",")
              if w.strip()]:
        gen = YcsbGen(w, a.keys, theta=a.theta, seed=17, salt=SALT)
        rows[w] = run_workload(eng, gen, ops=a.ops, steps=a.steps,
                               seal=(w == "C"))
        _say(f"YCSB-{w}: {rows[w]['ops_s']:,.0f} ops/s "
             f"(p99 {rows[w]['step_p99_ms']:.3f} ms/step)")
    print(json.dumps({
        "metric": "ycsb_matrix",
        "schema_version": 3,
        "keys": a.keys,
        "batch": a.ops,
        "nodes": a.nodes,
        "theta": a.theta,
        "workloads": rows,
        "config": {"value_bytes": 8, "value_dist": "fixed",
                   "value_heap": False, "torch": torch.__version__,
                   "cuda": torch.version.cuda},
        "obs": obs.obs_section(),
        "device": device,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
