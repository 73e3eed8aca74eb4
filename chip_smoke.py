#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``sherman_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's serving paths at the north-star size of ``bench.py``
(100 M keys, zipf 0.99) through the entry points a user calls — first on
one node, then on 8 nodes emulated on the card — and holds every CUDA
kernel of those paths against its plain PyTorch version:

1. build the kernels from ``sherman_tpu_torch/ops/csrc`` and
   ``sherman_tpu_torch/parallel/csrc`` and check each against its plain
   version on garbage inputs (exact equality): the page kernels K1-K3 on
   garbage pools, the exchange all-to-all K4 at several (N, C, W) and
   through its packer;
2. one node at 20,000 keys on the card and on the CPU from one seed:
   pools and counters bit-identical;
3. one node: bulk-load 100 M keys (``key = mix64(rank ^ salt)``, ``value
   = key ^ 0xDEADBEEF``, fill 0.75, a 4 GiB pool) and attach the router;
   YCSB-C ``search_combined`` on zipf 0.99 batches of 4,194,304 keys,
   every answer checked, plus a batch of absent keys; YCSB-A ``mixed``
   50/50 read/update zipf 0.99 batches of 1,048,576 keys, reads checked
   against the step rule (the pre-step value or this step's write), then
   every updated key searched for its last value;
4. K1-K3 replayed at every input shape phase 3 launched them at, on the
   inputs of that shape's first launch (exact equality), timed with CUDA
   events beside their plain versions, a PyTorch library call where one
   computes the same function, and their device-memory bound; K1 from
   the root and K2 with its ``ok`` mask on real pages; one profiled step
   of each kind;
5. 8 nodes at 20,000 keys on the card and on the CPU from one seed:
   pools, locks and counters bit-identical;
6. 8 nodes: the same 100 M keys over ``machine_nr = 8`` pools of 524,288
   pages (4 GiB in all), the same YCSB-C and YCSB-A steps with every
   answer checked;
7. one untimed step of each kind: bucket overflows counted, a round-1
   page-reply exchange and a write-request exchange captured; K2-K4
   replayed at every shape phase 6 launched them at, as in phase 4 (K4
   on the captured buffers where their shape matches, else on random
   words of the shape: its work does not depend on the data); one
   profiled step of each kind.

Launch counts are reset just before phase 3 and read just after it (K1,
K2 and K3 must launch), and again around phase 6 (K2, K3 and K4 must
launch); in both windows the launches are also counted by input shape.
A kernel's ``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` are
means per launch over its shapes, each listed under ``shapes``.  The
second-to-last lines are the ``kernels`` JSON record and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.  Any
failure raises: the script exits nonzero and prints no ``ok`` line, also
when no CUDA device is present.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # H100 SXM 32-bit rate outside the tensor cores
                               # (67 TFLOP/s fp32, data sheet), for the compares
SALT = 0x5E17AB1E5A17
VAL_XOR = np.uint64(0xDEADBEEF)


def _log(msg: str) -> None:
    print(msg, flush=True)


def keys_of(ranks: np.ndarray, salt: int) -> np.ndarray:
    from sherman_tpu_torch.ops import bits
    return bits.mix64_np(np.asarray(ranks, np.uint64) ^ np.uint64(salt))


# ---------------------------------------------------------------------------
# Timing helpers.
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 21, warmup: int = 2) -> float:
    """Median of ``reps`` single-call CUDA-event timings, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def bound(nbytes: int, nops: int) -> dict:
    """Least time the card could take: the larger of bytes over the HBM
    rate and operations over the 32-bit rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes}


# largest |kernel - plain| seen per kernel; every check requires 0
MAX_ERR = {"descent_round": 0, "gather_pages": 0, "writeback": 0,
           "exchange": 0}


def _max_abs(x: torch.Tensor, y: torch.Tensor) -> int:
    """max |x - y| over integer tensors of the same shape, in slices of
    the leading dimension (the exchange buffers are several GB)."""
    if torch.equal(x, y):
        return 0
    x, y = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
    step = max(1, (1 << 26) // max(1, x.shape[1]))
    return max(int((x[i:i + step].long() - y[i:i + step].long()).abs().max())
               for i in range(0, x.shape[0], step))


def _eq(a, b, what: str) -> None:
    """Exact equality of a kernel's outputs with its plain version's."""
    pairs = zip(a, b) if isinstance(a, tuple) else ((a, b),)
    err = max(_max_abs(x, y) if x.numel() else 0 for x, y in pairs)
    kernel = what.split()[0]
    MAX_ERR[kernel] = max(MAX_ERR[kernel], err)
    if err != 0:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{what} (max abs err {err})")


# ---------------------------------------------------------------------------
# Phase 1: build + parity on garbage pools.
# ---------------------------------------------------------------------------

def garbage_parity(dev) -> None:
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.ops import page_kernels as PK
    rng = np.random.default_rng(0)

    def rw(shape):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).to(dev)

    for B, P, stop in ((777, 32, 0), (4099, 64, 1), (8, 16, 0),
                       (100_003, 8192, 0), (65_537, 4096, 1)):
        pool = rw((P, C.PAGE_WORDS))
        addr = rw(B)
        k = B // 3   # in-range pages, pages past the pool, garbage words
        addr[:k] = torch.from_numpy(rng.integers(0, P, k).astype(np.int32))
        addr[k:2 * k] = torch.from_numpy(
            rng.integers(0, 2 * P, k).astype(np.int32))
        khi, klo = rw(B), rw(B)
        act = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
        _eq(PK.descent_round(pool, addr, khi, klo, act, stop_level=stop),
            PK.descent_round_ref(pool, addr, khi, klo, act,
                                 stop_level=stop), f"descent_round B={B}")
        _eq(PK.gather_pages(pool, addr), PK.gather_pages_ref(pool, addr),
            f"gather_pages B={B}")
        _eq(PK.read_pages_local(pool, addr, act),
            (PK.gather_pages_ref(pool, addr & C.ADDR_PAGE_MASK,
                                 act & ((addr & C.ADDR_PAGE_MASK) < P)),
             act & ((addr & C.ADDR_PAGE_MASK) < P)),
            f"gather_pages (read_pages_local) B={B}")
        page = torch.from_numpy(rng.integers(0, P, B).astype(np.int32)).to(dev)
        slot = torch.from_numpy(
            rng.integers(0, C.LEAF_CAP, B).astype(np.int32)).to(dev)
        applied = _unique_targets(page, slot) & \
            torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
        for lanes in ((C.L_VER_W, C.L_VHI_W, C.L_VLO_W),
                      (C.L_VER_W, C.L_KHI_W, C.L_KLO_W, C.L_VHI_W,
                       C.L_VLO_W)):
            ent = rw((B, len(lanes)))
            _eq(PK.writeback(pool.clone(), page, slot, applied, ent, lanes),
                PK.writeback_ref(pool.clone(), page, slot, applied, ent,
                                 lanes), f"writeback B={B} L={len(lanes)}")
    torch.cuda.synchronize()


def exchange_parity(dev) -> None:
    """K4 against its plain version on garbage: vector and word copy
    widths (C*W % 4 == 0 and != 0), a round-1 page-reply width (W = 257),
    and bool / float32 fields through the packer."""
    from sherman_tpu_torch.parallel import transport as T
    from sherman_tpu_torch.parallel import transport_kernel as TK
    rng = np.random.default_rng(1)

    def rw(shape):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32))

    for n, c, w in ((8, 4, 1), (4, 8, 16), (8, 1024, 257), (3, 5, 3),
                    (8, 333, 1)):
        x = rw((n, n * c, w))
        _eq(TK.all_to_all(x.to(dev)).cpu(), TK.all_to_all_ref(x),
            f"exchange N={n} C={c} W={w}")
    n, c = 8, 64
    tree = {"data": rw((n, n * c, 256)),
            "ok": torch.from_numpy(rng.integers(0, 2, (n, n * c))
                                   .astype(bool)),
            "f": rw((n, n * c)).view(torch.float32)}
    got = T.exchange({k: v.to(dev) for k, v in tree.items()})
    want = T.exchange(tree)
    words = lambda t: (t.to(torch.int32) if t.dtype == torch.bool
                       else t.view(torch.int32))        # bit patterns
    for k in tree:
        if got[k].dtype != want[k].dtype:
            raise AssertionError(f"exchange packer changed {k}'s dtype")
        _eq(words(got[k].cpu()), words(want[k]),
            f"exchange packer field {k}")
    torch.cuda.synchronize()


def _unique_targets(page: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Mask keeping the first row of every (page, slot) target: the
    write-back contract (applied rows never share a word)."""
    key = page.long() * 64 + slot.long()
    _, inv = torch.unique(key, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), key.numel(), device=key.device)
    first = first.scatter_reduce(0, inv, torch.arange(key.numel(),
                                                      device=key.device),
                                 "amin")
    keep = torch.zeros(key.numel(), dtype=torch.bool, device=key.device)
    keep[first] = True
    return keep


# ---------------------------------------------------------------------------
# Phases 2-4: the serving path.
# ---------------------------------------------------------------------------

def serve(n_keys: int, batch_c: int, batch_a: int, steps: int,
          device: str, seed: int = 7, log=_log, machine_nr: int = 1,
          step_capacity: int | None = None, chunk_pages: int = 4096) -> dict:
    """Build, load and serve one tree; ``batch_c``/``batch_a`` are the
    whole batches, split into ``machine_nr`` node blocks."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.workload.zipf import ZipfGen

    per_leaf = int(C.LEAF_CAP * 0.75)
    est_pages = int(n_keys / per_leaf * 1.10) + 8192
    pages = 1 << max(14, (est_pages - 1).bit_length())   # in all nodes
    N = machine_nr
    cfg = DSMConfig(machine_nr=N, pages_per_node=pages // N,
                    locks_per_node=65_536,
                    step_capacity=step_capacity or batch_c // N,
                    chunk_pages=chunk_pages, device=device)
    cluster = Cluster(cfg)
    tree = Tree(cluster)
    tcfg = TreeConfig(sibling_chase_budget=1)
    eng_c = batched.BatchedEngine(tree, batch_per_node=batch_c // N,
                                  tcfg=tcfg)
    eng_a = batched.BatchedEngine(tree, batch_per_node=batch_a // N,
                                  tcfg=tcfg)

    t0 = time.perf_counter()
    salt = SALT
    while True:   # mix64 is a bijection: keys are unique; skip sentinels
        keys = keys_of(np.arange(n_keys, dtype=np.uint64), salt)
        if keys.min() >= C.KEY_MIN and keys.max() <= C.KEY_MAX:
            break
        salt += 1
    vals = keys ^ VAL_XOR
    t_gen = time.perf_counter() - t0
    stats = batched.bulk_load(tree, keys, vals, fill=0.75)
    router = eng_c.attach_router()
    eng_a.router = router
    if device != "cpu":
        torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    log(f"bulk_load: nodes={N} keys={n_keys} pages={pages} "
        f"pages_per_node={pages // N} step_capacity={cfg.step_capacity} "
        f"stats={stats} "
         f"router_log2_buckets={router.lb} keygen_s={t_gen:.3f} "
         f"total_s={t_load:.3f}")

    rng = np.random.default_rng(seed)
    zipf = ZipfGen(n_keys, 0.99, rng=rng)

    # -- YCSB-C: combined point lookups --------------------------------------
    walls = []
    for s in range(steps + 1):
        q = keys_of(zipf.sample(batch_c), salt)
        t = time.perf_counter()
        v, f = eng_c.search_combined(q)
        dt = time.perf_counter() - t
        if not (f.all() and np.array_equal(v, q ^ VAL_XOR)):
            raise AssertionError(f"YCSB-C step {s}: {int((~f).sum())} "
                                 "missing or wrong answers")
        if s:                              # step 0 is the warm-up
            walls.append(dt)
    absent = keys_of(np.arange(n_keys, n_keys + 65_536, dtype=np.uint64),
                     salt)
    _, f_abs = eng_c.search_combined(absent)
    if f_abs.any():
        raise AssertionError(f"{int(f_abs.sum())} absent keys found")
    ops_c = steps * batch_c / sum(walls)
    log(f"ycsb_c: batch={batch_c} steps={steps} ops_per_s={ops_c:.0f} "
         f"step_wall_ms={[round(w * 1e3, 3) for w in walls]}")

    # -- YCSB-A: 50/50 read/update through the fused mixed step -------------
    cur = vals.copy()                      # current value by rank
    walls_a = []
    upd_ranks = []
    for s in range(steps + 1):
        ranks = zipf.sample(batch_a)
        q = keys_of(ranks, salt)
        is_read = rng.random(batch_a) < 0.5
        step_salt = np.uint64((0x9E3779B97F4A7C15 * (s + 1)) & (2**64 - 1))
        wv = q ^ step_salt
        t = time.perf_counter()
        out, found, st = eng_a.mixed(q, wv, is_read)
        dt = time.perf_counter() - t
        w = ~is_read
        if not np.isin(st[w], (batched.ST_APPLIED,
                               batched.ST_SUPERSEDED)).all():
            raise AssertionError(f"YCSB-A step {s}: write statuses "
                                 f"{np.bincount(st[w])}")
        if int((st[w] == batched.ST_APPLIED).sum()) != np.unique(q[w]).size:
            raise AssertionError(f"YCSB-A step {s}: not one applied write "
                                 "per written key")
        written = np.zeros(batch_a, bool)
        written[is_read] = np.isin(ranks[is_read], ranks[w])
        r_ok = found[is_read] & (
            (out[is_read] == cur[ranks[is_read]])
            | (written[is_read] & (out[is_read] == wv[is_read])))
        if not r_ok.all():
            raise AssertionError(f"YCSB-A step {s}: {int((~r_ok).sum())} "
                                 "reads outside the step rule")
        cur[ranks[w]] = wv[w]
        upd_ranks.append(ranks[w])
        if s:
            walls_a.append(dt)
    ur = np.unique(np.concatenate(upd_ranks))
    for i in range(0, ur.size, batch_c):
        r = ur[i:i + batch_c]
        v, f = eng_c.search_combined(keys_of(r, salt))
        if not (f.all() and np.array_equal(v, cur[r])):
            raise AssertionError("YCSB-A: an updated key does not read "
                                 "back its last written value")
    ops_a = steps * batch_a / sum(walls_a)
    log(f"ycsb_a: batch={batch_a} steps={steps} ops_per_s={ops_a:.0f} "
         f"updated_keys_verified={ur.size} "
         f"step_wall_ms={[round(w * 1e3, 3) for w in walls_a]}")
    log(f"counters: {cluster.dsm.counter_snapshot()}")
    if N > 1:
        log("counters_per_node: " + json.dumps(
            cluster.dsm.counters_np().reshape(N, -1).tolist()))
    return {"tree": tree, "eng_c": eng_c, "eng_a": eng_a, "zipf": zipf,
            "salt": salt, "ops_c": ops_c, "ops_a": ops_a}


def reference_check(**kw) -> None:
    """The whole path at a small size on the card and on the CPU (where
    every wrapper runs its plain version) from the same seed: the pools,
    locks and counters must come out bit-identical."""
    ctx = {d: serve(20_000, 2048, 1024, 2, d, log=lambda m: None, **kw)
           for d in ("cuda", "cpu")}
    a, b = (ctx[d]["tree"].dsm for d in ("cuda", "cpu"))
    if not (torch.equal(a.pool.cpu(), b.pool)
            and torch.equal(a.locks.cpu(), b.locks)
            and torch.equal(a.counters.cpu(), b.counters)):
        raise AssertionError(f"the path on the card ({kw}) disagrees "
                             "with its plain version on the CPU")


def profile_step(name: str, fn) -> None:
    """One step under torch.profiler: wall time, the device's busy time
    (kernels and copies) and the largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    _log(f"profile_{name}: wall_ms={wall * 1e3:.3f} "
         + (f"device_busy_ms={busy:.3f} idle_share={1 - busy / (wall * 1e3):.4f} "
            f"top_device_ms={[(k[:60], round(v, 3)) for k, v in top]}"
            if busy > 0 else "device_busy_ms=not measured"))


def host_breakdown(ctx: dict, batch_c: int) -> None:
    """Host-side pieces of one YCSB-C step, timed alone: the request
    combining (np.unique) and the router probe."""
    from sherman_tpu_torch.ops import bits
    eng = ctx["eng_c"]
    q = keys_of(ctx["zipf"].sample(batch_c), ctx["salt"])
    t = time.perf_counter()
    uk = np.unique(q, return_inverse=True)[0]
    t_unique = time.perf_counter() - t
    khi, klo = bits.keys_to_pairs(uk)
    khi, klo = eng._pad(khi), eng._pad(klo)
    t = time.perf_counter()
    eng.router.host_start(khi, klo)
    t_route = time.perf_counter() - t
    _log(f"host_breakdown_c: unique_keys={uk.size} "
         f"np_unique_ms={t_unique * 1e3:.3f} "
         f"router_probe_ms={t_route * 1e3:.3f}")


# ---------------------------------------------------------------------------
# Launches by shape, and the kernels replayed at every shape a path gave them.
# ---------------------------------------------------------------------------

PAGE_SRC = "sherman_tpu_torch/ops/csrc/page_kernels.cu"
KERNELS = {   # name -> (TPU kernel it replaces, source of the CUDA kernel)
    "descent_round": ("sherman_tpu/ops/pallas_page.py:282", PAGE_SRC),
    "gather_pages": ("sherman_tpu/ops/pallas_page.py:471", PAGE_SRC),
    "writeback": ("sherman_tpu/ops/pallas_page.py:385", PAGE_SRC),
    "exchange": ("sherman_tpu/parallel/transport_pallas.py:147",
                 "sherman_tpu_torch/parallel/csrc/exchange.cu"),
}


def _shape(kernel: str, args, kw) -> tuple:
    """The input shape by which a kernel's launches are told apart."""
    if kernel == "exchange":
        return tuple(args[0].shape)
    pool, rows = args[0], args[1]
    if kernel == "descent_round":
        return (pool.shape[0], rows.shape[0], kw.get("stop_level", 0))
    if kernel == "gather_pages":
        ok = args[2] if len(args) > 2 else kw.get("ok")
        return (pool.shape[0], rows.shape[0], ok is not None)
    return (pool.shape[0], rows.shape[0], len(args[5]))      # lanes


class ShapeLog:
    """While open, counts the launches a window makes through each kernel
    wrapper, by input shape, and keeps the arguments of each shape's first
    launch for replay (K1-K3; K4's buffers, up to 8.6 GB each, are not
    kept: its work does not depend on the data).  The spies only count
    on the host.  Opening resets the wrappers' launch counts;
    :meth:`check` holds the spies' counts to those, so a caller that
    reached a kernel around its module attribute fails the run instead
    of going uncounted."""

    device_type = "cuda"

    def __enter__(self):
        from sherman_tpu_torch.ops import page_kernels as PK
        from sherman_tpu_torch.parallel import transport_kernel as TK
        self.counts: dict[str, dict[tuple, int]] = {}
        self.args: dict[str, dict[tuple, tuple]] = {}
        self._orig = [(m, a, getattr(m, a)) for m, a in (
            (PK, "descent_round"), (PK, "gather_pages"), (PK, "writeback"),
            (TK, "all_to_all"))]
        for (mod, attr, fn), kernel in zip(self._orig, KERNELS):
            setattr(mod, attr, self._spy(kernel, fn))
        PK.reset_launches()
        TK.reset_launches()
        return self

    def _spy(self, kernel: str, fn):
        def spy(*args, **kw):
            out = fn(*args, **kw)
            if args[0].device.type == self.device_type:
                shape = _shape(kernel, args, kw)
                by = self.counts.setdefault(kernel, {})
                by[shape] = by.get(shape, 0) + 1
                if kernel != "exchange":
                    self.args.setdefault(kernel, {}).setdefault(
                        shape, (args, kw))
            return out
        return spy

    def __exit__(self, *exc) -> bool:
        from sherman_tpu_torch.ops import page_kernels as PK
        from sherman_tpu_torch.parallel import transport_kernel as TK
        for mod, attr, fn in self._orig:
            setattr(mod, attr, fn)
        self.launches = {**PK.LAUNCHES, **TK.LAUNCHES}
        return False

    def check(self, path: str, must_launch) -> None:
        counted = {k: sum(self.counts.get(k, {}).values())
                   for k in self.launches}
        if counted != self.launches:
            raise AssertionError(f"{path}: launches seen by shape "
                                 f"{counted} != the wrappers' counts "
                                 f"{self.launches}")
        missing = [k for k in must_launch if self.launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} "
                                 f"path: {missing}")
        _log(f"{path} launches: {self.launches}; by shape: " + json.dumps(
            {k: [[list(s), n] for s, n in v.items()]
             for k, v in self.counts.items()}))


def replay_descent_round(pool, addr, khi, klo, active, *, stop_level=0):
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.ops import page_kernels as PK
    args, kw = (pool, addr, khi, klo, active), {"stop_level": stop_level}
    B = addr.shape[0]
    out = PK.descent_round(*args, **kw)
    _eq(out, PK.descent_round_ref(*args, **kw),
        f"descent_round B={B} P={pool.shape[0]}")
    n_act = int(active.sum())
    # each input read once: the per-row words, and every distinct page the
    # active rows need (zipf batches share leaves); the seven outputs
    pages = int(torch.unique(bits.addr_page(addr)[out[3]]).numel())
    del out
    nbytes = B * (3 * 4 + 1) + B * (3 * 4 + 4) + pages * C.PAGE_BYTES
    # per active row: ~6 operations on each of the 82 entry and 49 slot
    # words searched
    nops = n_act * 6 * (C.INTERNAL_CAP + C.LEAF_CAP)
    return {"rows": B, "pool_pages": pool.shape[0], "stop_level": stop_level,
            "active_rows": n_act, "distinct_pages": pages,
            "ms": time_ms(lambda: PK.descent_round(*args, **kw)),
            "plain_ms": time_ms(lambda: PK.descent_round_ref(*args, **kw),
                                reps=5),
            "library_ms": None, **bound(nbytes, nops)}


def replay_gather_pages(pool, rows, ok=None):
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.ops import page_kernels as PK
    M, P = rows.shape[0], pool.shape[0]
    _eq(PK.gather_pages(pool, rows, ok), PK.gather_pages_ref(pool, rows, ok),
        f"gather_pages M={M} P={P} ok={ok is not None}")
    src = rows.clamp(0, P - 1)
    # rows (and ok) in, every distinct source page read once, [M, 256] out
    pages = int(torch.unique(src if ok is None else src[ok]).numel())
    nbytes = M * 4 + (0 if ok is None else M) + (pages + M) * C.PAGE_BYTES
    lib = None
    if ok is None:     # the library's row gather (the rows are in range)
        src_l = src.long()
        lib = time_ms(lambda: pool.index_select(0, src_l), reps=5)
    return {"rows": M, "pool_pages": P, "ok": ok is not None,
            "distinct_pages": pages,
            "ms": time_ms(lambda: PK.gather_pages(pool, rows, ok)),
            "plain_ms": time_ms(lambda: PK.gather_pages_ref(pool, rows, ok),
                                reps=5),
            "library_ms": lib, **bound(nbytes, 0)}


def replay_writeback(pool, page, slot, applied, ent, field_w):
    """Parity on clones with fresh values; timing in place with the words
    the targets hold now, so the pool is left as it is."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.ops import page_kernels as PK
    M, L = page.shape[0], len(field_w)
    fw = torch.tensor(list(field_w), device=pool.device)
    idx = (page.long() * C.PAGE_WORDS)[:, None] + fw[None, :] \
        + slot.long()[:, None]
    flat = pool.view(-1)
    ent_same = flat[idx].contiguous()
    ent_new = ent ^ 0x5A5A5A5A
    _eq(PK.writeback(pool.clone(), page, slot, applied, ent_new, field_w),
        PK.writeback_ref(pool.clone(), page, slot, applied, ent_new, field_w),
        f"writeback M={M} P={pool.shape[0]} L={L}")
    n_app = int(applied.sum())
    sel = applied[:, None].expand_as(idx)
    flat_idx, flat_val = idx[sel], ent_same[sel]
    nbytes = M * (4 + 4 + 1 + 4 * L) + n_app * 4 * L
    return {"rows": M, "pool_pages": pool.shape[0], "lanes": L,
            "applied_rows": n_app,
            "ms": time_ms(lambda: PK.writeback(pool, page, slot, applied,
                                               ent_same, field_w)),
            "plain_ms": time_ms(lambda: PK.writeback_ref(
                pool, page, slot, applied, ent_same, field_w), reps=5),
            "library_ms": time_ms(
                lambda: flat.index_put_((flat_idx,), flat_val), reps=5),
            **bound(nbytes, 0)}


def replay_exchange(x: torch.Tensor, data: str) -> dict:
    """K4 against its plain version on ``x``, then timed beside it,
    ``transpose(0, 1).contiguous()`` and its bound."""
    from sherman_tpu_torch.parallel import transport_kernel as TK
    N, NC, W = x.shape
    _eq(TK.all_to_all(x), TK.all_to_all_ref(x),
        f"exchange {data} [{N}, {NC}, {W}]")
    lib = lambda: x.view(N, N, NC // N, W).transpose(0, 1).contiguous()
    return {"shape": [N, NC, W], "data": data,
            "ms": time_ms(lambda: TK.all_to_all(x)),
            "plain_ms": time_ms(lambda: TK.all_to_all_ref(x), reps=5),
            "library_ms": time_ms(lib, reps=5),
            # each word read once and written once
            **bound(2 * x.numel() * 4, 0)}


REPLAY = {"descent_round": replay_descent_round,
          "gather_pages": replay_gather_pages, "writeback": replay_writeback}


def replay(log: ShapeLog, path: str, real=None) -> dict:
    """Every (kernel, shape) the window launched, held against its plain
    version and timed on the window's own inputs (K4: on a buffer
    captured from the path where ``real`` has one of that shape, else on
    random words of the shape; each buffer of ``real`` must be of a
    launched shape) -> {kernel: [per-shape entries]}."""
    dev = torch.device(log.device_type)
    gen = torch.Generator(device=dev).manual_seed(4)
    real = {} if real is None else real
    out: dict[str, list] = {}
    for kernel, by_shape in log.counts.items():
        for shape, n in by_shape.items():
            if kernel == "exchange":
                x = real.pop(shape, None)
                data = "captured"
                if x is None:
                    x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                      dtype=torch.int32, device=dev)
                    data = "random"
                r = replay_exchange(x, data)
                del x
            else:
                args, kw = log.args[kernel][shape]
                r = REPLAY[kernel](*args, **kw)
            out.setdefault(kernel, []).append(
                {"path": path, "launches": n, **r})
    if real:
        raise AssertionError(f"exchanges of shapes {list(real)} were "
                             f"captured but not launched in the window")
    log.args.clear()
    torch.cuda.synchronize()
    return out


def kernel_record(name: str, shapes: list[dict]) -> dict:
    """One kernel's line: its launches over both paths; ``ms``,
    ``plain_ms``, ``library_ms`` and ``bound_ms`` are means per launch
    over the shapes it was launched at (so ``launches * (ms - bound_ms)``
    sums over the shapes), and ``shapes`` has each one."""
    n = sum(s["launches"] for s in shapes)
    mean = lambda k: sum(s["launches"] * s[k] for s in shapes) / n
    by_path = {p: sum(s["launches"] for s in shapes if s["path"] == p)
               for p in ("one_node", "eight_nodes")}
    rep, src = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": MAX_ERR[name], "ms": mean("ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": max(shapes, key=lambda s: s["launches"]
                            * s["bound_ms"])["bound_by"],
            "library_ms": (mean("library_ms") if all(
                s["library_ms"] is not None for s in shapes) else None),
            "bytes": round(mean("bytes")), "launches_by_path": by_path,
            "shapes": shapes}


def real_page_parity(ctx: dict, batch_c: int) -> None:
    """K1 from the root to level 1 and K2 with its ``ok`` mask (the
    single-node ``read_pages`` contract) on this pool's real pages, two
    variants the serving steps do not launch."""
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.ops import page_kernels as PK
    tree, eng = ctx["tree"], ctx["eng_c"]
    pool = tree.dsm.pool
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(pool.device)
    uk = np.unique(keys_of(ctx["zipf"].sample(batch_c), ctx["salt"]))
    khi, klo = bits.keys_to_pairs(uk)
    khi, klo = eng._pad(khi), eng._pad(klo)
    act = T(eng._pad(np.ones(uk.size, bool)))
    start = T(eng.router.host_start(khi, klo))
    khi_t, klo_t = T(khi), T(klo)
    root = torch.full_like(start, tree._root_addr)
    _eq(PK.descent_round(pool, root, khi_t, klo_t, act, stop_level=1),
        PK.descent_round_ref(pool, root, khi_t, klo_t, act, stop_level=1),
        "descent_round real pages stop_level=1")
    rows = bits.addr_page(start).contiguous()
    ok = act & (rows < pool.shape[0])
    _eq(PK.gather_pages(pool, rows, ok), PK.gather_pages_ref(pool, rows, ok),
        "gather_pages (read_pages_local) real pages")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Phases 6-7: the 8-node path.
# ---------------------------------------------------------------------------

def count_overflow():
    """Count, per bucket capacity, the active rows that found no slot in
    their destination bucket.  -> (counts, restore); ``counts`` stays
    empty if no bucketize was reached."""
    from sherman_tpu_torch.parallel import transport as T
    orig = T.bucketize
    counts: dict[int, torch.Tensor] = {}

    def counted(dest, active, n_nodes, capacity):
        bucket_idx, routed = orig(dest, active, n_nodes, capacity)
        n = (active & ~routed).sum()
        counts[capacity] = counts.get(capacity, 0) + n
        return bucket_idx, routed

    T.bucketize = counted
    return counts, lambda: setattr(T, "bucketize", orig)


def capture_exchange(fn, width: int) -> torch.Tensor:
    """The first packed ``[N, N*C, width]`` buffer that ``fn`` hands the
    exchange kernel."""
    from sherman_tpu_torch.parallel import transport_kernel as TK
    orig = TK.all_to_all
    got = []

    def record(x):
        if x.shape[2] == width and not got:
            got.append(x)
        return orig(x)

    TK.all_to_all = record
    try:
        fn()
    finally:
        TK.all_to_all = orig
    if not got:
        raise AssertionError(f"no exchange of width {width} in the step")
    return got[0]


def multinode(n_keys, batch_c, batch_a, steps) -> dict:
    """Phases 6-7 -> {kernel: [per-shape entries of the 8-node window]}."""
    N, cap = 8, 131_072
    torch.cuda.reset_peak_memory_stats()
    with ShapeLog() as log:
        ctx = serve(n_keys, batch_c, batch_a, steps, "cuda", machine_nr=N,
                    step_capacity=cap)
    _log(f"8-node peak device memory: "
         f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log.check("8-node", ("gather_pages", "writeback", "exchange"))

    # untimed probe steps of each kind at the window's batch sizes: bucket
    # overflow, and the round-1 page reply and write request exchanged
    zipf, salt = ctx["zipf"], ctx["salt"]
    qc = keys_of(zipf.sample(batch_c), salt)
    qa = keys_of(zipf.sample(batch_a), salt)
    ra = np.random.default_rng(6).random(batch_a) < 0.5
    overflow, restore = count_overflow()
    try:
        reply = capture_exchange(lambda: ctx["eng_c"].search_combined(qc),
                                 257)
        request = capture_exchange(
            lambda: ctx["eng_a"].mixed(qa, qa ^ VAL_XOR, ra), 6)
    finally:
        restore()
    if not overflow:
        raise AssertionError("the overflow count reached no bucketize")
    _log("8-node bucket overflow in one untimed step of each kind "
         "(unrouted active rows, by capacity): "
         + json.dumps({k: int(v) for k, v in overflow.items()}))
    real = {tuple(reply.shape): reply, tuple(request.shape): request}
    del reply, request       # replay frees each buffer once it is used
    shapes = replay(log, "eight_nodes", real)
    _log("8-node parity at every launched shape (K2, K3, K4 on captured "
         "and random buffers): exact")
    profile_step("ycsb_c_8_nodes", lambda: ctx["eng_c"].search_combined(qc))
    profile_step("ycsb_a_8_nodes",
                 lambda: ctx["eng_a"].mixed(qa, qa ^ VAL_XOR, ra))
    return shapes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the GPU",
              file=sys.stderr)
        return 2
    from sherman_tpu_torch.ops import page_kernels as PK

    n_keys, batch_c, batch_a, steps = 100_000_000, 1 << 22, 1 << 20, 8
    dev = torch.device("cuda")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    PK.load_library()
    _log(f"build: {time.perf_counter() - t:.3f} s")
    garbage_parity(dev)
    exchange_parity(dev)
    _log("parity on garbage inputs (K1-K4): exact")
    reference_check()
    _log("reference check (one node, 20,000 keys, card vs plain path on the "
         "CPU): pools, locks and counters bit-identical")

    with ShapeLog() as log:
        ctx = serve(n_keys, batch_c, batch_a, steps, "cuda")
    log.check("one-node", ("descent_round", "gather_pages", "writeback"))
    shapes = replay(log, "one_node")
    real_page_parity(ctx, batch_c)
    _log("one-node parity at every launched shape and on real pages: exact")
    zipf, salt = ctx["zipf"], ctx["salt"]
    qc = keys_of(zipf.sample(batch_c), salt)
    profile_step("ycsb_c", lambda: ctx["eng_c"].search_combined(qc))
    qa = keys_of(zipf.sample(batch_a), salt)
    ra = np.random.default_rng(5).random(batch_a) < 0.5
    profile_step("ycsb_a", lambda: ctx["eng_a"].mixed(qa, qa ^ VAL_XOR, ra))
    host_breakdown(ctx, batch_c)
    del ctx, qc, qa
    gc.collect()
    torch.cuda.empty_cache()

    reference_check(machine_nr=8, step_capacity=32, chunk_pages=64)
    _log("reference check (8 nodes, 20,000 keys, step capacity 32, card vs "
         "plain path on the CPU): pools, locks and counters bit-identical")
    for k, v in multinode(n_keys, batch_c, batch_a, steps).items():
        shapes.setdefault(k, []).extend(v)
    recs = [kernel_record(k, shapes[k]) for k in KERNELS]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": recs}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
