"""Headline benchmark of the PyTorch/CUDA port on one GPU: YCSB-C point
lookups, zipf 0.99, 100 M keys, with the client side staged on the card.

    python -m sherman_tpu_torch.bench
    python -m sherman_tpu_torch.bench --ycsb [ycsb_bench's arguments]
    python -m sherman_tpu_torch.bench --serve [serve_bench's arguments]
    python -m sherman_tpu_torch.bench --reshard-drill [its arguments]
    python -m sherman_tpu_torch.bench --contract-drill [its arguments]
    python -m sherman_tpu_torch.bench --multihost-drill [its arguments]
    python -m sherman_tpu_torch.bench --hostfail-drill [its arguments]

With ``--ycsb`` it runs the YCSB A-F matrix instead
(:mod:`sherman_tpu_torch.ycsb_bench`), with ``--serve`` the open-loop
front-door bench or, with ``--crash-drill`` too, its journaled-ack drill
(:mod:`sherman_tpu_torch.serve_bench`); ``--failover-drill``,
``--partition-drill``, ``--reshard-drill``, ``--contract-drill``,
``--multihost-drill`` and ``--hostfail-drill`` run those drills
(``failover_drill.py``, ``partition_drill.py``, ``reshard_drill.py``,
``contract_drill.py``, ``multihost_drill.py``, ``hostfail_drill.py``).  The configuration is the north
star of the repo's ``bench.py``: keys ``mix64(rank ^ 0x5E17AB1E5A17)``,
values ``key ^ 0xDEADBEEF``, leaf fill 0.75 and the same pool sizing,
the default router, zipf 0.99, batches of 4,194,304 client ops, the
``analytic`` rank sampler.  Phases:

1. bulk load and router;
2. size the unique-row cap ``dev_b`` from one staged step at ``dev_b =
   batch`` (its largest unique count x 1.02, rounded up to 8192, plus
   16384);
3. sustained staged YCSB-C (``workload.device_prep.make_staged_step``,
   fusion from ``SHERMAN_STAGED_FUSION``): ``sustained_ops_s`` and
   ``sus_dev_ms_per_step`` over a window with one sync at its end, the
   per-phase times (``sus_dev_phase_ms``), and ``p50_ms``/``p99_ms`` from
   the walls of steps synced one by one;
4. a throughput window over batches the port's own prep staged on the
   card before the window: the serve alone, ``client_ops_s`` (the
   headline ``value``) and ``device_rows_s``;
5. sustained staged YCSB-A 50/50 (``make_staged_mixed_step``), row caps
   tightened after a warm-up step as ``bench.py`` tightens them, the
   carry never reset (the pool holds the warm-up's stamps).

With ``SHERMAN_LEAF_CACHE`` set, the hot-key tier
(``models/leaf_cache.py``) is attached after the bulk load and filled
with the hottest ranks (as many as it admits), and the sustained YCSB-C
run probes it: its residual cap ``dev_b_resid`` is sized from two
warm-up steps (the mean misses a step x 1.05, rounded up to 8192, within
``dev_b``), and the line gains a ``cache`` block: slots, capacity, keys
placed, hits over the timed window's client ops (the measured hit
ratio) beside ``zipf.expected_hit_ratio`` at the keys placed, unique
rows taken out of the serve, ``dev_b_resid`` and invalidations.

Every receipt is asserted: ``ok == 1``, every client answer correct, and
for the mixed loop every read linearization-checked and every write
applied.  The program ledger (``obs/device.py``) is sealed around every
timed window, so a new program shape there counts as a retrace (the line's
``retraces``, which must be 0), and each timed window is attributed to
its SLO class at once (``slo``).  Prints one JSON line (``bench.py``'s
field names where it measures the same thing, its ``obs`` section among
them) with the card's name and power limit.  Without a
CUDA device it exits with code 2; it never runs on the CPU.

The tree builder and the loops' runners (:func:`build`,
:func:`size_dev_b`, :func:`staged_read`, :func:`staged_mixed`) are the
ones ``chip_smoke.py`` drives.  Environment: ``SHERMAN_BENCH_KEYS``,
``SHERMAN_BENCH_BATCH``, ``SHERMAN_BENCH_THETA``,
``SHERMAN_BENCH_SAMPLER``, ``SHERMAN_BENCH_LB`` (router log2 buckets);
``SHERMAN_BENCH_VALIDATE`` set runs ``check_structure_device`` on the tree
after the bulk load and asserts its key count.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from sherman_tpu_torch import obs
from sherman_tpu_torch.obs import device as DEV

NORTH_STAR = 10_000_000          # ops/s on one device (BASELINE.json)
SALT = 0x5E17AB1E5A17
CHECK_XOR = 0xDEADBEEF
STEPS = 32                       # timed staged YCSB-C steps
LAT_STEPS = 32                   # staged YCSB-C steps synced one by one
MIXED_STEPS = 16                 # timed staged YCSB-A steps


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _env(name: str, default, kind=int):
    v = os.environ.get(name)
    return default if v in (None, "") else kind(v)


def _ints(carry) -> list:
    return [int(x) for x in carry]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _device_info() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in smi.split(",", 1))
    return {"name": name, "power_limit": limit,
            "torch_name": torch.cuda.get_device_name(0)}


def build(n_keys: int, batch_c: int, batch_a: int, device: str = "cuda", *,
          log=_say, machine_nr: int = 1, step_capacity: int | None = None,
          chunk_pages: int = 4096, lb: int | None = None) -> dict:
    """The north-star tree: bulk-load ``n_keys`` keys ``mix64(rank ^
    salt)`` (values ``key ^ 0xDEADBEEF``, fill 0.75) and attach the
    router (``lb`` log2 buckets, else the default).  Two engines share
    it, taking ``batch_c``/``batch_a`` rows in all, split into
    ``machine_nr`` node blocks.  -> {cluster, tree, eng_c, eng_a, salt,
    vals, n_keys}."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.ops import bits

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
    # chase budget 1: the measured windows write no structure
    tcfg = TreeConfig(sibling_chase_budget=1)
    eng_c = batched.BatchedEngine(tree, batch_per_node=batch_c // N,
                                  tcfg=tcfg)
    eng_a = batched.BatchedEngine(tree, batch_per_node=batch_a // N,
                                  tcfg=tcfg)

    t0 = time.perf_counter()
    salt = SALT
    ranks = np.arange(n_keys, dtype=np.uint64)
    while True:   # mix64 is a bijection: keys are unique; skip sentinels
        keys = bits.mix64_np(ranks ^ np.uint64(salt))
        if keys.min() >= C.KEY_MIN and keys.max() <= C.KEY_MAX:
            break
        salt += 1
    del ranks
    vals = keys ^ np.uint64(CHECK_XOR)
    t_gen = time.perf_counter() - t0
    stats = batched.bulk_load(tree, keys, vals, fill=0.75)
    del keys
    router = eng_c.attach_router(lb)
    eng_a.router = router
    _sync(device)
    log(f"bulk_load: nodes={N} keys={n_keys} pages={pages} "
        f"pages_per_node={pages // N} step_capacity={cfg.step_capacity} "
        f"stats={stats} router_log2_buckets={router.lb} "
        f"keygen_s={t_gen:.3f} total_s={time.perf_counter() - t0:.3f}")
    return {"cluster": cluster, "tree": tree, "eng_c": eng_c,
            "eng_a": eng_a, "salt": salt, "vals": vals, "n_keys": n_keys}


def size_dev_b(eng, n_keys: int, theta: float, salt: int, batch: int,
               sampler: str):
    """The staged read loop's unique-row cap from one warm-up step at
    ``dev_b = batch``: its largest per-node unique count x 1.02, rounded
    up to 8192, plus 16384.  -> (dev_b, staged tables)."""
    from sherman_tpu_torch.workload import device_prep as DP
    step, (new_carry, tb, rt, rk) = DP.make_staged_step(
        eng, n_keys=n_keys, theta=theta, salt=salt, batch=batch,
        dev_b=batch, sampler=sampler, fusion="aligned")
    _, c = step(eng.dsm.pool, eng.dsm.counters, tb, rt, rk, new_carry())
    c = _ints(c)
    want = batch * eng.cfg.machine_nr
    if c[1] != 1 or c[2] != want:
        raise AssertionError(f"sizing step receipts {c}, want {want} "
                             "correct")
    return min(batch, -(-int(c[4] * 1.02) // 8192) * 8192 + 16384), \
        (tb, rt, rk)


def tighten_caps(carry, R: int, W: int) -> tuple[int, int]:
    """The mixed loop's row caps from a warm-up carry (as ``bench.py``
    tightens them): each class's largest unique count x 1.04, rounded up
    to 65536, within the class size."""
    c = _ints(carry)
    return (min(R, -(-int(c[5] * 1.04) // 65536) * 65536),
            min(W, -(-int(c[6] * 1.04) // 65536) * 65536))


def size_dev_b_resid(eng, n_keys: int, theta: float, salt: int,
                     batch: int, dev_b: int, staged, *, sampler: str,
                     leaf_cache) -> int:
    """The cached read loop's residual cap from two warm-up steps at
    ``dev_b_resid = dev_b``: the mean misses a step (unique rows less
    cache hits) x 1.05, rounded up to 8192, within ``dev_b`` (the
    reference bench's tightening)."""
    from sherman_tpu_torch.workload import device_prep as DP
    step, (new_carry, tb, rt, rk) = DP.make_staged_step(
        eng, n_keys=n_keys, theta=theta, salt=salt, batch=batch,
        dev_b=dev_b, sampler=sampler, fusion="aligned", staged=staged,
        leaf_cache=leaf_cache)
    carry = new_carry()
    for _ in range(2):
        _, carry = step(eng.dsm.pool, eng.dsm.counters, tb, rt, rk, carry)
    c = _ints(carry)
    if c[1] != 1:
        raise AssertionError(f"cached sizing steps receipts {c}")
    resid = max(1, (c[3] - c[6] + 1) // 2)
    return min(dev_b, -(-int(resid * 1.05) // 8192) * 8192)


def staged_read(eng, n_keys: int, theta: float, salt: int, batch: int,
                dev_b: int, staged, *, sampler: str,
                fusion: str | None = None, steps: int = STEPS,
                lat_steps: int = LAT_STEPS, leaf_cache=None,
                dev_b_resid: int | None = None):
    """Staged YCSB-C on ``eng``: two warm-up steps, ``steps`` timed steps
    with one sync at the window's end, then ``lat_steps`` steps synced
    one by one (their walls); each run from a fresh carry, every receipt
    asserted.  ``batch`` clients a node.  The ledger is sealed around
    both measured runs and the timed window goes to the SLO plane.  With
    ``leaf_cache`` the loop probes it (residual cap ``dev_b_resid``) and
    the record's receipts end with the hit sums.
    -> (record, step, new_carry)."""
    from sherman_tpu_torch.workload import device_prep as DP
    N = eng.cfg.machine_nr
    want = batch * N
    step, (new_carry, tb, rt, rk) = DP.make_staged_step(
        eng, n_keys=n_keys, theta=theta, salt=salt, batch=batch,
        dev_b=dev_b, sampler=sampler, fusion=fusion, staged=staged,
        leaf_cache=leaf_cache, dev_b_resid=dev_b_resid)
    pool, counters = eng.dsm.pool, eng.dsm.counters

    ledger = DEV.get_ledger()

    def run(k: int, sync_each: bool = False):
        carry, walls = new_carry(), []
        _sync(pool.device)
        t0 = time.perf_counter()
        for _ in range(k):
            t = time.perf_counter()
            _, carry = step(pool, counters, tb, rt, rk, carry)
            if sync_each:
                _sync(pool.device)
                walls.append((time.perf_counter() - t) * 1e3)
        carry = step.drain(carry)
        _sync(pool.device)
        dt = time.perf_counter() - t0
        c = _ints(carry)
        if c[0] != k or c[1] != 1 or c[2] != k * want:
            raise AssertionError(
                f"staged YCSB-C {step.fusion}: receipts {c}, want "
                f"{k * want} correct (ok 0: a unique count overflowed "
                "dev_b)")
        return c, dt, walls

    run(2)                                   # warm-up
    r0 = ledger.retraces
    with ledger.sealed_scope():
        c, dt, _ = run(steps)
        _, _, walls = run(lat_steps, sync_each=True)
    step.record_slo(steps, dt)
    return {"loop": "ycsb_c", "fusion": step.fusion,
            "sampler": step.sampler, "nodes": N, "batch_per_node": batch,
            "dev_b": dev_b, "steps": steps,
            "ops_per_s": steps * want / dt, "ms_per_step": dt / steps * 1e3,
            "synced_step_ms": walls, "combine": steps * want / max(1, c[3]),
            "max_nuniq": c[4], "receipts": c, "sealed": True,
            "retraces": ledger.retraces - r0}, step, new_carry


def staged_mixed(eng, n_keys: int, theta: float, salt: int, batch: int, *,
                 sampler: str, dev_b: int | None = None,
                 fusion: str | None = None, steps: int = MIXED_STEPS,
                 carry=None, caps=None, staged=None):
    """Staged YCSB-A 50/50 on ``eng`` (``batch`` clients a node),
    continuing ``carry``: the carry is never reset, since the pool holds
    the stamps of earlier mixed steps.  ``caps`` None: one sizing step at
    caps ``min(class, dev_b + 16384)``, then the caps tightened by
    :func:`tighten_caps`.  Then one warm-up step and ``steps`` timed
    steps with one sync at the window's end (the ledger sealed around
    it, the window attributed to the SLO plane); the receipts of each
    run are asserted on their deltas.  -> (record, step, carry, caps,
    staged tables)."""
    from sherman_tpu_torch.workload import device_prep as DP
    N = eng.cfg.machine_nr
    R = int(round(batch * 0.5))
    W = batch - R
    pool, locks, counters = eng.dsm.pool, eng.dsm.locks, eng.dsm.counters
    mk = lambda rb, wb, st: DP.make_staged_mixed_step(
        eng, n_keys=n_keys, theta=theta, salt=salt, batch=batch,
        read_ratio=0.5, dev_rb=rb, dev_wb=wb, sampler=sampler,
        fusion=fusion, staged=st)

    def run(step, k: int, carry):
        for _ in range(k):
            _, _, carry = step(pool, locks, counters, *staged, carry)
        return step.drain(carry)

    def check(base: list, carry, k: int, what: str) -> list:
        c = _ints(carry)
        d_r, d_w = c[2] - base[2], c[3] - base[3]
        if c[1] != 1 or d_r != k * R * N or d_w != k * W * N:
            raise AssertionError(
                f"staged YCSB-A {what}: receipts {c} (from {base}), want "
                f"{k * R * N} reads correct and {k * W * N} writes applied "
                "(ok 0: a unique count overflowed its cap)")
        return c

    first = caps or (min(R, dev_b + 16384), min(W, dev_b + 16384))
    step, (new_carry, *tabs) = mk(*first, staged)
    staged = tuple(tabs)
    carry = new_carry() if carry is None else carry
    if caps is None:
        base = _ints(carry)
        carry = run(step, 1, carry)
        check(base, carry, 1, "sizing step")
        caps = tighten_caps(carry, R, W)
        if caps != first:
            step, _ = mk(*caps, staged)
    base = _ints(carry)
    carry = run(step, 1, carry)
    check(base, carry, 1, f"{step.fusion} warm-up")
    base = _ints(carry)
    ledger = DEV.get_ledger()
    r0 = ledger.retraces
    with ledger.sealed_scope():
        _sync(pool.device)
        t0 = time.perf_counter()
        carry = run(step, steps, carry)
        _sync(pool.device)
        dt = time.perf_counter() - t0
    step.record_slo(steps, dt)
    c = check(base, carry, steps, step.fusion)
    return ({"loop": "ycsb_a", "fusion": step.fusion,
             "sampler": step.sampler, "nodes": N, "batch_per_node": batch,
             "caps": list(caps), "steps": steps,
             "ops_per_s": steps * batch * N / dt,
             "ms_per_step": dt / steps * 1e3,
             "combine": steps * batch * N / max(1, c[4] - base[4]),
             "receipts": c, "sealed": True,
             "retraces": ledger.retraces - r0}, step, carry, caps, staged)


def _throughput_window(eng, step, tables, batch, n_batches: int = 4,
                       win_steps: int = 32) -> dict:
    """The serve alone over batches the port's prep staged on the card
    before the window (``bench.py``'s throughput window, with the prep
    on the card instead of on the host)."""
    pool, counters = eng.dsm.pool, eng.dsm.counters
    tb, rt, rk = tables
    preps = [step.jprep(tb, rt, rk, 1_000_000 + i) for i in range(n_batches)]
    n_uniq = [int(p[8].max()) for p in preps]
    fresh = lambda: tuple(torch.tensor(v, dtype=torch.int32,
                                       device=pool.device)
                          for v in (1, 0, 0, 0))
    rc = fresh()
    for p in preps:                        # warm-up, every answer verified
        _, skhi, sklo, khi, klo, start, active, inv, nu = p
        _, f, vh, vl = step.jserve(pool, counters, khi, klo,
                                   eng.tree._root_addr, active, start, inv)
        rc = step.jverify(rc, skhi, sklo, f, vh, vl, nu)
    rc = _ints(rc)
    if rc[0] != 1 or rc[1] != n_batches * batch:
        raise AssertionError(f"throughput warm-up receipts {rc}")
    _sync(pool.device)
    t0 = time.perf_counter()
    for i in range(win_steps):
        _, skhi, sklo, khi, klo, start, active, inv, nu = preps[i % n_batches]
        done, f, vh, vl = step.jserve(pool, counters, khi, klo,
                                      eng.tree._root_addr, active, start, inv)
    _sync(pool.device)
    elapsed = time.perf_counter() - t0
    last = _ints(step.jverify(fresh(), skhi, sklo, f, vh, vl, nu))
    if last[0] != 1 or last[1] != batch:
        raise AssertionError(f"window receipts {last}")
    return {"client_ops_s": win_steps * batch / elapsed,
            "device_rows_s": win_steps * step.dev_b / elapsed,
            "combine_ratio": batch / max(n_uniq),
            "window_steps": win_steps,
            "window_ms_per_step": elapsed / win_steps * 1e3}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--ycsb" in argv:
        # the YCSB A-F matrix, with its own arguments and JSON line
        argv.remove("--ycsb")
        from sherman_tpu_torch import ycsb_bench
        return ycsb_bench.main(argv)
    if "--serve" in argv:
        # the serving front door's open-loop bench (or crash drill), with
        # its own arguments and JSON line
        argv.remove("--serve")
        from sherman_tpu_torch import serve_bench
        return serve_bench.main(argv)
    if "--failover-drill" in argv:
        # the replication plane's failover drill, with its own arguments
        # and JSON line
        argv.remove("--failover-drill")
        from sherman_tpu_torch import failover_drill
        return failover_drill.main(argv)
    if "--partition-drill" in argv:
        # the partition plane's drill, with its own arguments and JSON line
        argv.remove("--partition-drill")
        from sherman_tpu_torch import partition_drill
        return partition_drill.main(argv)
    if "--reshard-drill" in argv:
        # the elastic resize's reshard drill, with its own arguments and
        # JSON line
        argv.remove("--reshard-drill")
        from sherman_tpu_torch import reshard_drill
        return reshard_drill.main(argv)
    if "--contract-drill" in argv:
        # the client-contract drill, with its own arguments and JSON line
        argv.remove("--contract-drill")
        from sherman_tpu_torch import contract_drill
        return contract_drill.main(argv)
    if "--multihost-drill" in argv:
        # the multihost service plane's drill, with its own arguments and
        # JSON line
        argv.remove("--multihost-drill")
        from sherman_tpu_torch import multihost_drill
        return multihost_drill.main(argv)
    if "--hostfail-drill" in argv:
        # host failover's drill, with its own arguments and JSON line
        argv.remove("--hostfail-drill")
        from sherman_tpu_torch import hostfail_drill
        return hostfail_drill.main(argv)
    if not torch.cuda.is_available():
        print("sherman_tpu_torch.bench: no CUDA device; the port's benchmark "
              "runs on the GPU", file=sys.stderr)
        return 2
    from sherman_tpu_torch import config as C
    n_keys = _env("SHERMAN_BENCH_KEYS", 100_000_000)
    batch = _env("SHERMAN_BENCH_BATCH", 4_194_304)
    theta = _env("SHERMAN_BENCH_THETA", 0.99, float)
    sampler = os.environ.get("SHERMAN_BENCH_SAMPLER", "analytic")
    lb = _env("SHERMAN_BENCH_LB", None)
    fusion = C.staged_fusion()
    device = _device_info()
    _say(f"device={device} keys={n_keys} batch={batch} theta={theta} "
         f"fusion={fusion} sampler={sampler}")

    b = build(n_keys, batch, batch, "cuda", lb=lb)
    salt = b["salt"]
    del b["vals"]
    if os.environ.get("SHERMAN_BENCH_VALIDATE"):
        # the whole-tree structure check on the card (every invariant,
        # every page); raises on any violation
        from sherman_tpu_torch.models.validate import check_structure_device
        t1 = time.perf_counter()
        info = check_structure_device(b["tree"])
        _say(f"structure valid in {time.perf_counter() - t1:.3f} s: {info}")
        if info["keys"] != n_keys:
            raise AssertionError(f"{info['keys']} keys in the tree, "
                                 f"{n_keys} loaded")
    eng = b["eng_c"]
    dev_b, staged = size_dev_b(eng, n_keys, theta, salt, batch, sampler)
    cache = cache_fill = resid = None
    if C.leaf_cache_slots():
        from sherman_tpu_torch.ops import bits
        cache = eng.attach_leaf_cache(slots=C.leaf_cache_slots())
        hot = bits.mix64_np(np.arange(cache.capacity, dtype=np.uint64)
                            ^ np.uint64(salt))
        t1 = time.perf_counter()
        cache_fill = cache.fill(hot)
        resid = size_dev_b_resid(eng, n_keys, theta, salt, batch, dev_b,
                                 staged, sampler=sampler, leaf_cache=cache)
        _say(f"leaf cache: {cache.slots} slots, {cache_fill} in "
             f"{time.perf_counter() - t1:.3f} s, dev_b_resid {resid}")
    read, step, _ = staged_read(eng, n_keys, theta, salt, batch, dev_b,
                                staged, sampler=sampler, leaf_cache=cache,
                                dev_b_resid=resid)
    _say(f"sustained(device-staged): {read['steps']} steps -> "
         f"{read['ops_per_s'] / 1e6:.2f} M ops/s "
         f"({read['ms_per_step']:.1f} ms/step, dev_b {dev_b})")
    pool, counters = eng.dsm.pool, eng.dsm.counters
    phase_ms = step.phase_profile(pool, counters, *staged, reps=4)[0]
    from sherman_tpu_torch.workload.device_prep import record_phase_obs
    record_phase_obs("staged", phase_ms)
    cache_rec = None
    if cache is not None:
        from sherman_tpu_torch.workload.zipf import expected_hit_ratio
        c = read["receipts"]
        ops = read["steps"] * batch
        cache_rec = {
            "enabled": True, "slots": cache.slots,
            "capacity": cache.capacity,
            "cached_keys": cache_fill["placed"],
            "placement_failed": cache_fill["failed"],
            "hits": c[5], "uniq_hits": c[6], "client_ops": ops,
            "dev_b_resid": resid, "hit_ratio": c[5] / ops,
            "hit_ratio_pred": expected_hit_ratio(n_keys, theta,
                                                 cache_fill["placed"]),
            "invalidations": cache.invalidations}
        # the throughput window below times the uncached serve
        from sherman_tpu_torch.workload import device_prep as DP
        step, _ = DP.make_staged_step(
            eng, n_keys=n_keys, theta=theta, salt=salt, batch=batch,
            dev_b=dev_b, sampler=sampler, staged=staged)
    win = _throughput_window(eng, step, staged, batch)
    mixed = staged_mixed(b["eng_a"], n_keys, theta, salt, batch,
                         sampler=sampler, dev_b=dev_b)[0]
    _say(f"sustained(device-staged MIXED 50/50): {mixed['steps']} steps -> "
         f"{mixed['ops_per_s'] / 1e6:.2f} M ops/s (caps {mixed['caps']})")
    rnd = lambda d: {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in d.items()}
    walls = read["synced_step_ms"]
    out = {
        "metric": "ycsb_c_zipf%.2f_lookup_throughput" % theta,
        "value": round(win["client_ops_s"]),
        "unit": "ops/s",
        "vs_baseline": round(win["client_ops_s"] / NORTH_STAR, 4),
        "client_ops_s": round(win["client_ops_s"]),
        "device_rows_s": round(win["device_rows_s"]),
        "combine_ratio": round(win["combine_ratio"], 2),
        "p50_ms": round(float(np.percentile(walls, 50)), 3),
        "p99_ms": round(float(np.percentile(walls, 99)), 3),
        "keys": n_keys,
        "batch": batch,
        "sustained_ops_s": round(read["ops_per_s"]),
        "sus_dev_ms_per_step": round(read["ms_per_step"], 3),
        "sus_dev_phase_ms": rnd(phase_ms),
        "sus_dev_fusion": read["fusion"],
        "sus_dev_sampler": read["sampler"],
        "sus_dev_combine": round(read["combine"], 3),
        "sus_dev_steps": read["steps"],
        "dev_b": dev_b,
        "window_ms_per_step": round(win["window_ms_per_step"], 3),
        "sus_mixed_ops_s": round(mixed["ops_per_s"]),
        "sus_mixed_ms_per_step": round(mixed["ms_per_step"], 3),
        "sus_mixed_combine": round(mixed["combine"], 3),
        "sus_mixed_fusion": mixed["fusion"],
        "sus_mixed_sampler": mixed["sampler"],
        "sus_mixed_caps": mixed["caps"],
        "sus_mixed_steps": mixed["steps"],
        "retraces": read["retraces"] + mixed["retraces"],
        "slo": {cls: rnd(s) for cls, s in obs.slo_window().items()},
        "ledger": {k: v for k, v in DEV.get_ledger().summary().items()
                   if k != "entries"},
        "cache": cache_rec,
        "obs": obs.obs_section(),
        "device": device,
        "config": {"staged_fusion": fusion,
                   "pipeline_depth": 2 if fusion == "pipelined" else 1,
                   "torch": torch.__version__, "cuda": torch.version.cuda},
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
