"""Headline benchmark of the PyTorch/CUDA port on one GPU: YCSB-C point
lookups, zipf 0.99, 100 M keys, with the client side staged on the card
and, beside it, on the host through the native tier.

    python -m sherman_tpu_torch.bench
    python -m sherman_tpu_torch.bench --ycsb [ycsb_bench's arguments]
    python -m sherman_tpu_torch.bench --serve [serve_bench's arguments]
    python -m sherman_tpu_torch.bench --reshard-drill [its arguments]
    python -m sherman_tpu_torch.bench --contract-drill [its arguments]
    python -m sherman_tpu_torch.bench --multihost-drill [its arguments]
    python -m sherman_tpu_torch.bench --hostfail-drill [its arguments]
    python -m sherman_tpu_torch.bench --chaos-drill [its arguments]
    python -m sherman_tpu_torch.bench --recovery-drill [its arguments]

With ``--ycsb`` it runs the YCSB A-F matrix instead
(:mod:`sherman_tpu_torch.ycsb_bench`), with ``--serve`` the open-loop
front-door bench or, with ``--crash-drill`` too, its journaled-ack drill
(:mod:`sherman_tpu_torch.serve_bench`); ``--failover-drill``,
``--partition-drill``, ``--reshard-drill``, ``--contract-drill``,
``--multihost-drill``, ``--hostfail-drill``, ``--chaos-drill`` and
``--recovery-drill`` run those drills (``failover_drill.py``,
``partition_drill.py``, ``reshard_drill.py``, ``contract_drill.py``,
``multihost_drill.py``, ``hostfail_drill.py``, ``chaos_drill.py``,
``recovery_drill.py``).
The configuration is the north star of the repo's ``bench.py``: keys
``mix64(rank ^ 0x5E17AB1E5A17)`` (:func:`synthetic_keys`, the keys of
``native.synthetic_keyspace``, the salt moved on should a key fall out of
range), values ``key ^ 0xDEADBEEF``, leaf fill 0.75 and the same pool
sizing, the default router, zipf 0.99, batches of 4,194,304 client ops,
the ``analytic`` rank sampler on the card.  Phases:

1. bulk load and router;
2. size the unique-row cap ``dev_b`` from one staged step at ``dev_b =
   batch`` (its largest unique count x 1.02, rounded up to 8192, plus
   16384);
3. sustained staged YCSB-C (``workload.device_prep.make_staged_step``,
   fusion from ``SHERMAN_STAGED_FUSION``): ``sustained_ops_s`` and
   ``sus_dev_ms_per_step`` over a window with one sync at its end, the
   per-phase times (``sus_dev_phase_ms``), and ``sus_dev_p50_ms``/
   ``sus_dev_p99_ms`` from the walls of steps synced one by one (through
   :func:`span_percentiles`);
4. a throughput window over batches the port's own prep staged on the
   card before the window: the serve alone, ``client_ops_s`` (the
   headline ``value``) and ``device_rows_s``;
5. the host-staged half (``bench.py``'s, through
   :mod:`sherman_tpu_torch.native`): ``dev_b`` sized by three
   ``BatchPrep`` passes at full width (:func:`size_host_dev_b`); one
   warm-up batch through ``_get_search_fanout``, every answer checked
   against ``key ^ 0xDEADBEEF``; the host-staged sustained loop
   (:func:`host_sustained`: the prep of batch k+1 on one host core while
   the card serves batch k, two ``PrepBuffers`` in page-locked memory
   uploaded on the current stream, a buffer never overwritten before its
   upload has completed, every answer checked on the card):
   ``sus_host_ops_s``, ``sus_prep_ms``, ``sus_put_ms`` (an upload's
   device time, between CUDA events), ``sus_put_host_ms``; start-sorted
   staging of a few batches (:func:`host_staged_batches`):
   ``prep_ms_per_batch`` and ``sort_ms_per_batch``; the latency phase
   over those batches (:func:`latency_phase`): one span a step, each step
   synced (a co-located host: the reference's ``LAT_BLOCK=1``), recorded
   into ``native.LatencyHistogram.record_batch``, ``p50_ms``/``p99_ms``
   from it (``np.percentile`` only for spans at or past its 100 ms range);
   the host per-op floor through the host ``Tree`` and its local lock
   tier (:func:`host_floor`): ``host_lock_us``, ``host_search_us``,
   ``host_insert_us``;
6. sustained staged YCSB-A 50/50 (``make_staged_mixed_step``), row caps
   tightened after a warm-up step as ``bench.py`` tightens them, the
   carry never reset (the pool holds the warm-up's stamps).

The host-staged half needs the native tier: where it cannot load, the
bench fails with ``NativeUnavailableError`` carrying the build's output,
and never runs a numpy prep in its place.

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

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from sherman_tpu_torch import obs
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.utils import failure

NORTH_STAR = 10_000_000          # ops/s on one device (BASELINE.json)
SALT = 0x5E17AB1E5A17
CHECK_XOR = 0xDEADBEEF
STEPS = 32                       # timed staged YCSB-C steps
LAT_STEPS = 32                   # staged YCSB-C steps synced one by one
MIXED_STEPS = 16                 # timed staged YCSB-A steps
HOST_SEED = 11                   # BatchPrep's zipf seed (bench.py's)
HOST_SUS_STEPS = 32              # host-staged sustained steps
HOST_BATCHES = 8                 # start-sorted host-staged batches
HOST_LAT_STEPS = 64              # latency-phase spans (bench.py's blocks)
HOST_FLOOR_LOOPS = 20            # host ops a per-op floor mean
HIST_RANGE_NS = 100e6            # spans the histogram holds (104.8 ms cap)
# the low word of CHECK_XOR as the int32 lane of a key's low half
_XOR_LO = int(np.array(CHECK_XOR, np.uint32).view(np.int32))


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


def require_native():
    """The native tier, or :class:`NativeUnavailableError` with the
    build's output: the host-staged paths have no numpy stand-in."""
    from sherman_tpu_torch import native
    from sherman_tpu_torch.errors import NativeUnavailableError
    if not native.available():
        raise NativeUnavailableError(
            f"the native host tier is unavailable: {native.load_error()}")
    return native


def synthetic_keys(n_keys: int, salt: int = SALT):
    """``bench.py``'s keyspace by rank: key ``mix64(rank ^ salt)``, the
    salt moved on by one while a key falls out of range (``mix64`` is a
    bijection, so the keys are distinct; ``native.synthetic_keyspace``
    gives the same keys sorted).  -> (salt, rank_to_key)."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.ops import bits
    ranks = np.arange(n_keys, dtype=np.uint64)
    while True:
        keys = bits.mix64_np(ranks ^ np.uint64(salt))
        if keys.min() >= C.KEY_MIN and keys.max() <= C.KEY_MAX:
            return salt, keys
        salt += 1


def build(n_keys: int, batch_c: int, batch_a: int, device: str = "cuda", *,
          log=_say, machine_nr: int = 1, step_capacity: int | None = None,
          chunk_pages: int = 4096, lb: int | None = None,
          keeper=None) -> dict:
    """The north-star tree: bulk-load ``n_keys`` keys ``mix64(rank ^
    salt)`` (:func:`synthetic_keys`; values ``key ^ 0xDEADBEEF``, fill
    0.75) and attach the router (``lb`` log2 buckets, else the default).
    Two engines share it, taking ``batch_c``/``batch_a`` rows in all,
    split into ``machine_nr`` node blocks.  ``keeper``: the distributed
    keeper of ``init_multihost``, whose ranks then share the nodes (every
    rank calls this with the same arguments).  -> {cluster, tree, eng_c,
    eng_a, salt, vals (by rank), n_keys}."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    per_leaf = int(C.LEAF_CAP * 0.75)
    est_pages = int(n_keys / per_leaf * 1.10) + 8192
    pages = 1 << max(14, (est_pages - 1).bit_length())   # in all nodes
    N = machine_nr
    cfg = DSMConfig(machine_nr=N, pages_per_node=pages // N,
                    locks_per_node=65_536,
                    step_capacity=step_capacity or batch_c // N,
                    chunk_pages=chunk_pages, device=device)
    cluster = Cluster(cfg, keeper=keeper)
    tree = Tree(cluster)
    # chase budget 1: the measured windows write no structure
    tcfg = TreeConfig(sibling_chase_budget=1)
    eng_c = batched.BatchedEngine(tree, batch_per_node=batch_c // N,
                                  tcfg=tcfg)
    eng_a = batched.BatchedEngine(tree, batch_per_node=batch_a // N,
                                  tcfg=tcfg)

    t0 = time.perf_counter()
    salt, keys = synthetic_keys(n_keys)
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


def _multihost_capable_stamp() -> bool | None:
    """Can this PyTorch run gloo collectives between processes (the
    process-spanning transport)?  Probed once a run by two short-lived
    subprocesses (``multihost.multihost_capable``); None, never a crash,
    when the probe itself cannot run."""
    try:
        from sherman_tpu_torch.multihost import multihost_capable
        return multihost_capable()[0]
    except Exception:
        return None


@functools.lru_cache(maxsize=1)
def _lint_clean() -> bool | None:
    """True when the tree this bench ran from passes the port's
    shermanlint (``sherman_tpu_torch/`` and ``chip_smoke.py`` with the
    committed baseline, anchored at the repo root whatever the working
    directory), stamped into the JSON ``config`` block.  AST-only, once
    a process and outside every timer; None, never a crash, when the
    linter itself cannot run."""
    try:
        from sherman_tpu_torch import analysis, shermanlint
        baseline = analysis.load_baseline(shermanlint.DEFAULT_BASELINE)
        return shermanlint.lint(baseline=baseline).clean
    except Exception:
        return None


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
        # fail fast (utils/failure.py): SHERMAN_COLLECTIVE_TIMEOUT_S arms a
        # watchdog around the windowed dispatch; a wedged collective
        # cannot be cancelled from Python, so on expiry it prints the DSM
        # counter snapshot and exits for the launcher to restart
        with failure.Watchdog.maybe(
                what=f"device-step window ({k} steps)",
                diagnostics=eng.dsm.counter_snapshot):
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
        with failure.Watchdog.maybe(
                what=f"device-step window ({k} steps)",
                diagnostics=eng.dsm.counter_snapshot):
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


# -- the host-staged half (native tier) ---------------------------------------

def size_host_dev_b(n_keys: int, theta: float, salt: int,
                    batch: int) -> tuple[int, int]:
    """``bench.py``'s sizing: three full-width ``BatchPrep`` passes bound
    the unique count ``n_u0``; ``dev_b`` is ``n_u0`` x 1.02 rounded up to
    8192.  -> (dev_b, n_u0)."""
    native = require_native()
    sizer = native.BatchPrep(batch, batch, n_keys, theta, seed=HOST_SEED,
                             salt=salt)
    sbuf = sizer.buffers()
    n_u0 = 0
    for _ in range(3):
        sizer.run_zipf(None, sbuf, None)
        n_u0 = max(n_u0, sbuf.n_uniq)
    return -(-int(n_u0 * 1.02) // 8192) * 8192, n_u0


class HostStager:
    """The native prep of the host-staged loops on one engine: a
    ``BatchPrep`` (synthetic keys, ``dev_b`` unique rows) and two
    ``PrepBuffers`` whose arrays live in page-locked memory on a CUDA
    device; :meth:`upload` copies a buffer to the card on the current
    stream between two timing events (``copies``: the copy's device
    time), and :meth:`prep` waits on the end event of the buffer's last
    upload before overwriting it (that wait and the copies' enqueue are
    ``put_s``, on the host's clock)."""

    FIELDS = ("khi", "klo", "start", "active", "inv")

    def __init__(self, eng, n_keys: int, theta: float, salt: int,
                 batch: int, dev_b: int):
        from sherman_tpu_torch.errors import ConfigError
        native = require_native()
        if eng.cfg.machine_nr != 1:
            raise ConfigError("the host-staged loops serve one node "
                              f"(machine_nr={eng.cfg.machine_nr})")
        self.eng, self.batch, self.dev_b = eng, batch, dev_b
        self.device = torch.device(eng.device)
        self.cuda = self.device.type == "cuda"
        self.batch_prep = native.BatchPrep(batch, dev_b, n_keys, theta,
                                      seed=HOST_SEED, salt=salt)
        self.bufs, self.host = [], []
        for _ in range(2):
            b = self.batch_prep.buffers(with_keys=True)
            t = {}
            for f in self.FIELDS:
                a = getattr(b, f)
                t[f] = torch.empty(a.shape, pin_memory=self.cuda,
                                   dtype=(torch.uint8 if a.dtype == np.uint8
                                          else torch.int32))
                setattr(b, f, t[f].numpy())
            self.bufs.append(b)
            self.host.append(t)
        self.events = [None, None]
        self.copies = []          # (start, end) events of each upload
        self.put_s = 0.0
        self.fn = eng._get_search_fanout(eng._iters())

    def prep(self, i: int, want_keys: bool = False):
        """Prep the next batch into buffer ``i`` (after its last upload
        has completed).  -> the buffer."""
        ev = self.events[i]
        if ev is not None:
            t = time.perf_counter()
            ev.synchronize()
            self.put_s += time.perf_counter() - t
            self.events[i] = None
        router = self.eng.router
        with router._read_locked():
            return self.batch_prep.run_zipf(
                None, self.bufs[i], router.table_np, router.shift,
                want_keys=want_keys)

    def upload(self, i: int, arrays=None) -> tuple:
        """Buffer ``i`` (or ``arrays``, host arrays of the five fields)
        on the card: (khi, klo, start, active, inv), ``active`` as bool."""
        src = (tuple(torch.from_numpy(a) for a in arrays) if arrays
               is not None else tuple(self.host[i][f] for f in self.FIELDS))
        t = time.perf_counter()
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            d = tuple(x.to(self.device, non_blocking=True) for x in src)
            ev[1].record()
            self.copies.append(tuple(ev))
            if arrays is None:
                self.events[i] = ev[1]
        else:
            d = tuple(x.clone() for x in src)
        self.put_s += time.perf_counter() - t
        khi, klo, start, act, inv = d
        return khi, klo, start, act.view(torch.bool), inv

    def serve(self, d: tuple):
        """One fan-out step on uploaded arrays -> (done, found, vhi, vlo)."""
        khi, klo, start, act, inv = d
        return self.fn(self.eng.dsm.pool, self.eng.dsm.counters, khi, klo,
                       self.eng.tree._root_addr, act, start, inv)

    @staticmethod
    def wrong(d: tuple, out) -> torch.Tensor:
        """Client answers that are not ``key ^ 0xDEADBEEF`` (found, both
        words), counted on the card: each client's key is its unique
        row's (``inv``)."""
        khi, klo, _, _, inv = d
        _, found, vhi, vlo = out
        i = inv.long()
        ok = found & (vhi == khi[i]) & (vlo == (klo[i] ^ _XOR_LO))
        return (~ok).sum()


def host_warmup(st: HostStager) -> None:
    """One prepped batch through the fan-out, every client answer checked
    on the host against ``key ^ 0xDEADBEEF`` (``bench.py``'s warm-up)."""
    from sherman_tpu_torch.ops import bits
    b = st.prep(0, want_keys=True)
    keys0 = b.keys.copy()
    d = st.upload(0)
    done, found, vhi, vlo = st.serve(d)
    f = found.cpu().numpy()[:st.batch]
    if not f.all():
        raise AssertionError(f"host-staged warm-up: {(~f).sum()} lookups "
                             "missed")
    if not bool(done[:b.n_uniq].all()):
        raise AssertionError("host-staged warm-up: stragglers")
    got = bits.pairs_to_keys(vhi.cpu().numpy()[:st.batch],
                             vlo.cpu().numpy()[:st.batch])
    if not np.array_equal(got, keys0 ^ np.uint64(CHECK_XOR)):
        raise AssertionError("host-staged warm-up: wrong answers")


def host_sustained(st: HostStager, steps: int = HOST_SUS_STEPS) -> dict:
    """``bench.py``'s host-shipped sustained loop: the prep of batch k+1
    runs on the host while the card serves batch k (the serve is
    enqueued, not waited for), the uploads on the current stream from the
    two page-locked buffers in turn; every client answer is checked on
    the card and the wrong ones summed there, one sync at the window's
    end.  -> sus_host_ops_s, sus_prep_ms (pure host prep), sus_put_ms
    (an upload's device time, between its events; on the CPU the
    clone's host time), sus_put_host_ms (the uploads' enqueue and the
    waits before a buffer is reused, on the host's clock),
    sus_ms_per_step."""
    st.put_s = 0.0
    st.copies = []
    prep_s = 0.0
    bad = torch.zeros((), dtype=torch.int64, device=st.device)
    b = st.prep(0)
    _sync(st.device)
    t0 = time.perf_counter()
    for k in range(steps):
        last_nu = b.n_uniq
        d = st.upload(k % 2)
        out = st.serve(d)
        bad += st.wrong(d, out)
        if k + 1 < steps:
            t, put0 = time.perf_counter(), st.put_s
            b = st.prep((k + 1) % 2)
            # the wait on the buffer's last upload counts as upload time
            prep_s += time.perf_counter() - t - (st.put_s - put0)
    _sync(st.device)
    elapsed = time.perf_counter() - t0
    if not bool(out[0][:last_nu].all()):
        raise AssertionError("host-staged sustained: stragglers")
    if int(bad):
        raise AssertionError(f"host-staged sustained: {int(bad)} wrong "
                             "answers")
    return {"sus_host_ops_s": steps * st.batch / elapsed,
            "sus_prep_ms": prep_s / max(1, steps - 1) * 1e3,
            "sus_put_ms": (sum(s.elapsed_time(e) for s, e in st.copies)
                           / steps if st.cuda else st.put_s / steps * 1e3),
            "sus_put_host_ms": st.put_s / steps * 1e3,
            "sus_ms_per_step": elapsed / steps * 1e3,
            "sus_host_steps": steps}


def host_staged_batches(st: HostStager, n: int = HOST_BATCHES):
    """``bench.py``'s start-sorted staging of ``n`` batches: each prepped,
    its unique rows sorted by start page (the inverse map composed with
    the permutation, so every client keeps its answer), and uploaded;
    the prep and the sort are timed per batch.  -> (device batches,
    prep_ms_per_batch, sort_ms_per_batch, max unique rows)."""
    prep_ns, sort_ns, n_uniq, out = [], [], [], []
    for i in range(n):
        t1 = time.perf_counter_ns()
        b = st.prep(i % 2)
        prep_ns.append(time.perf_counter_ns() - t1)
        m = b.n_uniq
        n_uniq.append(m)
        t2 = time.perf_counter_ns()
        ordr = np.argsort(b.start[:m], kind="stable")
        rank = np.empty(m, np.int32)
        rank[ordr] = np.arange(m, dtype=np.int32)
        khi_s, klo_s = b.khi.copy(), b.klo.copy()
        st_s = b.start.copy()
        khi_s[:m] = b.khi[ordr]
        klo_s[:m] = b.klo[ordr]
        st_s[:m] = b.start[ordr]
        inv_s = rank[b.inv]
        sort_ns.append(time.perf_counter_ns() - t2)
        d = st.upload(i % 2, (khi_s, klo_s, st_s, b.active.copy(), inv_s))
        _sync(st.device)      # the sources are freed with this iteration
        out.append(d)
    return (out, float(np.mean(prep_ns)) / 1e6,
            float(np.mean(sort_ns)) / 1e6, max(n_uniq))


def span_percentiles(spans_ns, ops_per_span: int) -> tuple:
    """p50 and p99 in ms of step spans, each ``ops_per_span`` ops that
    completed together: from ``native.LatencyHistogram.record_batch``,
    and from ``np.percentile`` only when a span is at or past the
    histogram's range.  -> (p50_ms, p99_ms, source)."""
    native = require_native()
    spans = np.asarray(spans_ns, np.float64)
    if spans.size and spans.max() < HIST_RANGE_NS:
        h = native.LatencyHistogram()
        for sp in spans:
            h.record_batch(int(sp), ops_per_span)
        pct = h.percentiles_us((0.5, 0.99))
        return pct["p50"] / 1e3, pct["p99"] / 1e3, "histogram"
    return (float(np.percentile(spans, 50)) / 1e6,
            float(np.percentile(spans, 99)) / 1e6, "percentile")


def latency_phase(st: HostStager, batches, steps: int = HOST_LAT_STEPS
                  ) -> dict:
    """The latency phase over staged batches: one step a span, each step
    synced (a co-located host: ``bench.py``'s ``LAT_BLOCK=1``), every
    answer checked on the card; p50/p99 from :func:`span_percentiles`."""
    spans = []
    bad = torch.zeros((), dtype=torch.int64, device=st.device)
    for i in range(steps + 1):
        d = batches[i % len(batches)]
        _sync(st.device)
        t = time.perf_counter_ns()
        out = st.serve(d)
        _sync(st.device)
        if i:                                  # step 0 warms the shape
            spans.append(time.perf_counter_ns() - t)
        bad += st.wrong(d, out)
    if int(bad):
        raise AssertionError(f"latency phase: {int(bad)} wrong answers")
    p50, p99, src = span_percentiles(spans, st.batch)
    return {"p50_ms": p50, "p99_ms": p99, "lat_source": src,
            "lat_steps": steps, "lat_max_ms": max(spans) / 1e6}


def host_floor(tree, keys, vals, loops: int = HOST_FLOOR_LOOPS) -> dict:
    """``bench.py``'s host per-op floor through the host ``Tree`` (its
    local lock tier, and the page kernels under each host step): a lock
    and unlock round trip, single-key searches, and in-place inserts of
    the same values; each path warmed once first.  -> host_lock_us,
    host_search_us, host_insert_us."""
    keys = [int(k) for k in keys[:loops]]
    vals = [int(v) for v in vals[:loops]]
    tree.lock_bench(12345, loops=1)
    tree.search(keys[0])
    tree.insert(keys[0], vals[0])
    lock_us = tree.lock_bench(12345, loops=loops) / 1e3
    t = time.perf_counter_ns()
    got = [tree.search(k) for k in keys]
    search_us = (time.perf_counter_ns() - t) / loops / 1e3
    if got != vals:
        raise AssertionError("host floor: a search read a wrong value")
    t = time.perf_counter_ns()
    for k, v in zip(keys, vals):
        tree.insert(k, v)
    insert_us = (time.perf_counter_ns() - t) / loops / 1e3
    if [tree.search(k) for k in keys] != vals:
        raise AssertionError("host floor: an insert lost its value")
    return {"host_lock_us": lock_us, "host_search_us": search_us,
            "host_insert_us": insert_us}


def host_staged(eng, n_keys: int, theta: float, salt: int, batch: int, *,
                steps: int = HOST_SUS_STEPS, n_batches: int = HOST_BATCHES,
                lat_steps: int = HOST_LAT_STEPS, floor_keys=None,
                floor_vals=None, log=_say) -> dict:
    """The host-staged half in ``bench.py``'s order: sizing, warm-up,
    sustained loop, start-sorted staging, latency phase, and (with
    ``floor_keys``/``floor_vals``) the host per-op floor.  -> the fields
    of the JSON line."""
    t = time.perf_counter()
    dev_b, n_u0 = size_host_dev_b(n_keys, theta, salt, batch)
    st = HostStager(eng, n_keys, theta, salt, batch, dev_b)
    host_warmup(st)
    log(f"host-staged: dev_b {dev_b} (n_u0 {n_u0}) sized and warmed in "
        f"{time.perf_counter() - t:.3f} s")
    rec = {"host_dev_b": dev_b, "host_n_u0": n_u0}
    rec.update(host_sustained(st, steps))
    log(f"sustained(host-staged): {steps} steps -> "
        f"{rec['sus_host_ops_s'] / 1e6:.2f} M ops/s "
        f"({rec['sus_ms_per_step']:.1f} ms/step; prep "
        f"{rec['sus_prep_ms']:.1f} + upload {rec['sus_put_ms']:.1f} "
        "ms/batch)")
    batches, prep_ms, sort_ms, max_u = host_staged_batches(st, n_batches)
    rec.update(prep_ms_per_batch=prep_ms, sort_ms_per_batch=sort_ms,
               host_combine_ratio=batch / max_u)
    rec.update(latency_phase(st, batches, lat_steps))
    log(f"host-staged batches: prep {prep_ms:.1f} + sort {sort_ms:.1f} "
        f"ms/batch; latency p50 {rec['p50_ms']:.3f} p99 "
        f"{rec['p99_ms']:.3f} ms ({rec['lat_source']})")
    del batches
    if floor_keys is not None:
        rec.update(host_floor(eng.tree, floor_keys, floor_vals))
        log(f"host floor: lock {rec['host_lock_us']:.1f} us, search "
            f"{rec['host_search_us']:.1f} us, insert "
            f"{rec['host_insert_us']:.1f} us")
    return rec


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
    if "--chaos-drill" in argv:
        # the data-plane chaos drill, with its own arguments and JSON line
        argv.remove("--chaos-drill")
        from sherman_tpu_torch import chaos_drill
        chaos_drill.main(argv)
        return 0
    if "--recovery-drill" in argv:
        # the recovery plane's drill, with its own arguments and JSON line
        argv.remove("--recovery-drill")
        from sherman_tpu_torch import recovery_drill
        recovery_drill.main(argv)
        return 0
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
    floor_vals = b["vals"][:HOST_FLOOR_LOOPS].copy()   # ranks 0-19
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
    host = host_staged(eng, n_keys, theta, salt, batch,
                       floor_keys=floor_vals ^ np.uint64(CHECK_XOR),
                       floor_vals=floor_vals)
    mixed = staged_mixed(b["eng_a"], n_keys, theta, salt, batch,
                         sampler=sampler, dev_b=dev_b)[0]
    _say(f"sustained(device-staged MIXED 50/50): {mixed['steps']} steps -> "
         f"{mixed['ops_per_s'] / 1e6:.2f} M ops/s (caps {mixed['caps']})")
    rnd = lambda d: {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in d.items()}
    dev_p50, dev_p99, _ = span_percentiles(
        np.asarray(read["synced_step_ms"]) * 1e6, batch)
    out = {
        "metric": "ycsb_c_zipf%.2f_lookup_throughput" % theta,
        "value": round(win["client_ops_s"]),
        "unit": "ops/s",
        "vs_baseline": round(win["client_ops_s"] / NORTH_STAR, 4),
        "client_ops_s": round(win["client_ops_s"]),
        "device_rows_s": round(win["device_rows_s"]),
        "combine_ratio": round(win["combine_ratio"], 2),
        "p50_ms": round(host["p50_ms"], 3),
        "p99_ms": round(host["p99_ms"], 3),
        "lat_source": host["lat_source"],
        "lat_steps": host["lat_steps"],
        "keys": n_keys,
        "batch": batch,
        "sustained_ops_s": round(read["ops_per_s"]),
        "sus_dev_ms_per_step": round(read["ms_per_step"], 3),
        "sus_dev_phase_ms": rnd(phase_ms),
        "sus_dev_fusion": read["fusion"],
        "sus_dev_sampler": read["sampler"],
        "sus_dev_combine": round(read["combine"], 3),
        "sus_dev_steps": read["steps"],
        "sus_dev_p50_ms": round(dev_p50, 3),
        "sus_dev_p99_ms": round(dev_p99, 3),
        "dev_b": dev_b,
        "sus_host_ops_s": round(host["sus_host_ops_s"]),
        "sus_prep_ms": round(host["sus_prep_ms"], 3),
        "sus_put_ms": round(host["sus_put_ms"], 3),
        "sus_put_host_ms": round(host["sus_put_host_ms"], 3),
        "sus_ms_per_step": round(host["sus_ms_per_step"], 3),
        "sus_host_steps": host["sus_host_steps"],
        "host_dev_b": host["host_dev_b"],
        "host_combine_ratio": round(host["host_combine_ratio"], 2),
        "prep_ms_per_batch": round(host["prep_ms_per_batch"], 3),
        "sort_ms_per_batch": round(host["sort_ms_per_batch"], 3),
        "host_lock_us": round(host["host_lock_us"], 2),
        "host_search_us": round(host["host_search_us"], 2),
        "host_insert_us": round(host["host_insert_us"], 2),
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
                   "torch": torch.__version__, "cuda": torch.version.cuda,
                   # which transport this run could cross processes with
                   "multihost_capable": _multihost_capable_stamp(),
                   # whether the tree it ran from lints clean
                   "lint_clean": _lint_clean()},
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
