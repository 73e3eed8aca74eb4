"""Open-loop serving front-door bench of the PyTorch/CUDA port
(counterpart of ``tools/serve_bench.py``; ``python -m
sherman_tpu_torch.bench --serve`` hands over to it).

Where the closed-loop bench owns the card, this bench is the front
door's proof of service: paced multi-tenant clients submit independent
requests through :class:`sherman_tpu_torch.serve.ShermanServer`, and the
JSON line shows the SLO-adaptive width controller settling on a step
width whose measured end-to-end p99 meets the target, while the saturated
open-loop throughput stays within 1.3x of the closed-loop number at that
width (measured in-process by the calibration sweep: same tree, same
functions, same host).

- Admissions are paced by :class:`AdmissionPacer` (sleep, then spin on the
  ns clock); every paced tenant's jitter lands in one ``adm_*`` receipt
  with its ``adm_feasible`` verdict.
- Phase 0 (capacity): one unpaced loader saturates the front door; its
  throughput at the settled width against the closed loop's is the
  ``within_1_3x`` pin.
- Phase A (SLO): ``--tenants`` paced tenants offer ``rho`` x the mid
  rung's closed-loop rate; the read p99 against the target.
- Phase B (fairness): an unpaced greedy tenant beside a polite paced one;
  the greedy one's typed rejects and each tenant's served share.
- The serving loop runs sealed: ``retraces`` must be 0.  Writes are
  journaled by construction (ack gate = fsync).

``--crash-drill`` instead runs the durability drill: 4 writer tenants
stream value re-stamps while a client-side ledger records every acked
(key, value); the server is killed mid-traffic (journal left unclosed),
the base image is rebuilt, the journal replays, and the line pins
``rpo_ops == 0`` and ``acks_per_fsync > 1``.

The keyspace and the zipf sampler are the reference's: rank r's key is
``mix64(r ^ salt)`` (the keys of ``native.synthetic_keyspace``), and each
client draws from a ``native.ZipfGen`` of its own seed
(:mod:`sherman_tpu_torch.native`, required: no numpy sampler stands in).
Every client's requests are drawn before the phases' timers start.  Run
on the GPU::

    python -m sherman_tpu_torch.serve_bench [--keys 200000] [--secs 6]
        [--widths 1024,4096,16384] [--p99-ms 0 (auto)] [--tenants 3]
        [--req-ops 1024] [--rho 0.6] [--write-frac 0] [--no-greedy]
        [--cache] [--crash-drill]

``SHERMAN_PREP_IMPL=device`` puts the ingress prep on the card.  Prints
one JSON line (``metric: serve_bench`` or ``serve_crash_drill``); without
a CUDA device it exits with code 2 (``--device cpu`` runs the plain path
on the CPU, for rehearsals at small sizes).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

STAMP0 = 0xD00D          # bulk-load value stamp (key ^ STAMP0)
STAMP1 = 0x5EED_0001     # open-loop write re-stamp


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


class AdmissionPacer:
    """The ``perf_counter_ns`` sleep+spin admission pacer of the open-loop
    benches (a copy of ``tools/common.py``'s).

    ``time.sleep`` alone cannot pace sub-ms periods, so the pacer sleeps
    until ``spin_ns`` before each deadline, then spins on the ns clock;
    the spin budget is capped at half the period.  Every admission's
    pacing error (dispatch time - due time) is recorded;
    :meth:`jitter_receipt` publishes its p50/p99 and an ``adm_feasible``
    verdict (p99 error small against the period).

    Usage::

        pacer = AdmissionPacer(period_s, spin_ms=2.0)
        pacer.start()                 # schedule anchored 2 periods out
        for i in range(n):
            pacer.wait_turn(i)        # blocks until deadline i
            ... dispatch ...

    One pacer paces one admission stream; ``merge_errors`` merges
    several pacers' errors into one receipt."""

    def __init__(self, period_s: float, spin_ms: float = 2.0):
        assert period_s > 0
        self._clock = time.perf_counter_ns
        self._sleep = time.sleep
        self.period_ns = int(period_s * 1e9)
        # duty-cycle bound: never spin more than half the period
        self.spin_ns = int(min(spin_ms * 1e6, 0.5 * self.period_ns))
        self.errors_ns: list[int] = []
        self._t_base: int | None = None

    def start(self, lead_periods: int = 2) -> None:
        """Anchor the schedule ``lead_periods`` periods from now."""
        self._t_base = self._clock() + lead_periods * self.period_ns

    def due_ns(self, i: int) -> int:
        assert self._t_base is not None, "call start() first"
        return self._t_base + i * self.period_ns

    def wait_turn(self, i: int) -> int:
        """Block (sleep, then spin) until deadline ``i``; returns and
        records the pacing error in ns (>= 0: late dispatch)."""
        due = self.due_ns(i)
        now = self._clock()
        if now < due - self.spin_ns:
            self._sleep((due - self.spin_ns - now) / 1e9)
        while True:
            now = self._clock()
            if now >= due:
                break
        err = now - due
        self.errors_ns.append(err)
        return err

    def absorb_stall(self, next_i: int, cap_ns: int) -> None:
        """Re-anchor the schedule by at most ``cap_ns`` after an observer
        stall; uncapped re-anchoring would hide genuine backlog
        (coordinated omission)."""
        lag = self._clock() - self.due_ns(next_i)
        if lag > 0:
            self._t_base += min(lag, cap_ns)

    def merge_errors(self, other: "AdmissionPacer") -> None:
        self.errors_ns.extend(other.errors_ns)

    def jitter_receipt(self, feasible_frac: float = 0.25) -> dict:
        """{adm_jitter_p50_ms, adm_jitter_p99_ms, adm_spin_budget_ms,
        adm_feasible, pacing}."""
        errs = self.errors_ns or [0]
        p50 = float(np.percentile(errs, 50)) / 1e6
        p99 = float(np.percentile(errs, 99)) / 1e6
        return {
            "adm_jitter_p50_ms": round(p50, 3),
            "adm_jitter_p99_ms": round(p99, 3),
            "adm_spin_budget_ms": round(self.spin_ns / 1e6, 3),
            "adm_feasible": bool(
                p99 < feasible_frac * self.period_ns / 1e6),
            "pacing": "sleep+spin",
        }


@functools.lru_cache(maxsize=1)
def keyspace(n_keys: int) -> tuple:
    """The reference's keyspace -> (sorted keys, rank_to_key): rank r's
    key is ``mix64(r ^ salt)`` (``bench.synthetic_keys``; the keys of
    ``native.synthetic_keyspace``).  Kept for the next call, which gets
    the same arrays: the drill rebuilds the same tree."""
    from sherman_tpu_torch.bench import synthetic_keys
    rank_to_key = synthetic_keys(n_keys)[1]
    return np.sort(rank_to_key), rank_to_key


def build_engine(n_keys: int, widths, cache: bool, device: str = "cuda"):
    """Cluster + bulk-loaded tree + engine (+ router, + optional
    sketch-admission leaf cache).  -> (cluster, tree, eng, keys,
    rank_to_key)."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.ycsb_bench import pages_for_keys

    keys, rank_to_key = keyspace(n_keys)
    vals = keys ^ np.uint64(STAMP0)
    cfg = DSMConfig(machine_nr=1, pages_per_node=pages_for_keys(n_keys),
                    locks_per_node=65_536, step_capacity=max(widths),
                    chunk_pages=1024, device=device)
    cluster = Cluster(cfg)
    tree = Tree(cluster)
    batched.bulk_load(tree, keys, vals)
    # the engine's batch bounds the WRITE path's padded step (the ingress
    # read path pads per rung): a write flush stalls the one dispatcher
    # for an engine op, so keep it at the mid rung, not the widest
    eng_b = min(4096, max(widths))
    eng = batched.BatchedEngine(tree, batch_per_node=eng_b,
                                tcfg=TreeConfig(sibling_chase_budget=1))
    eng.attach_router()
    if cache:
        # sketch admission from the front door's real request streams
        eng.attach_leaf_cache(slots=4096, admit_every=16)
    return cluster, tree, eng, keys, rank_to_key


def make_sampler(n_keys: int, theta: float, rank_to_key, seed: int):
    """``n -> n keys`` drawn from zipf(theta) ranks (uniform at theta 0)
    through ``rank_to_key``: one ``native.ZipfGen`` of its own seed (its
    set-up sums zeta over ``n_keys``), the native tier required
    (``NativeUnavailableError`` where it cannot load)."""
    if theta > 0:
        from sherman_tpu_torch.bench import require_native
        zg = require_native().ZipfGen(n_keys, theta, seed=seed)
        return lambda n: rank_to_key[zg.sample(n)]
    from sherman_tpu_torch.workload.zipf import uniform_ranks
    rng = np.random.default_rng(seed)
    return lambda n: rank_to_key[uniform_ranks(n_keys, n, rng)]


def run_serve(a, built=None, auditor=None) -> dict:
    """The open-loop bench (module docstring) -> its JSON record.
    ``built`` (``build_engine``'s tuple) serves an existing tree instead
    of building one; ``auditor`` (an
    :class:`~sherman_tpu_torch.audit.Auditor`) rides the server, and its
    verdict and inline cost join the record."""
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.errors import ShermanError
    from sherman_tpu_torch.models.batched import DegradedError
    from sherman_tpu_torch.serve import (ServeConfig, ServeOverloadError,
                                         ShermanServer)
    from sherman_tpu_torch.utils.journal import Journal

    widths = tuple(int(w) for w in a.widths.split(","))
    t0 = time.time()
    if built is None:
        built = build_engine(a.keys, widths, a.cache, a.device)
        _say(f"build + bulk load {time.time() - t0:.1f}s (keys={a.keys}, "
             f"cache={'on' if a.cache else 'off'})")
    cluster, tree, eng, keys, rank_to_key = built

    jdir = a.journal_dir or tempfile.mkdtemp(prefix="serve-journal-")
    jpath = os.path.join(jdir, "serve-journal.bin")
    journal = Journal(jpath, sync=True, group_commit_ms=a.group_commit_ms)
    # provisional huge target: calibration first, then re-aim (auto mode
    # picks the target from the measured frontier below)
    cfg = ServeConfig(widths=widths,
                      p99_targets_ms={c: (a.p99_ms or 1e9)
                                      for c in ("read", "scan",
                                                "insert", "delete")},
                      fusion=a.fusion,
                      group_commit_ms=a.group_commit_ms,
                      # one engine chunk a write flush: a wider flush is a
                      # longer dispatcher stall every read behind it pays
                      write_width=2048,
                      # end-to-end p99 model on a GIL'd host: formation
                      # wait + the in-flight pipeline slot + service +
                      # scheduling jitter, ~3.5x the step wall
                      model_mult=3.5)
    srv = ShermanServer(eng, cfg, journal=journal, auditor=auditor)
    calib_n = min(a.keys, 4096)
    absent = np.asarray([int(keys.max()) - 1], np.uint64)
    # keys are sorted: a search, not np.isin's unique of every key
    absent = absent[keys[np.searchsorted(keys, absent)] != absent]
    t_cal = time.perf_counter()
    calib = srv.start(
        calib_keys=keys[:: max(1, a.keys // 65536)],
        calib_writes=(keys[:calib_n], keys[:calib_n] ^ np.uint64(STAMP0)),
        calib_delete_keys=absent if absent.size else None)
    calib_s = time.perf_counter() - t_cal
    for w, c in sorted(calib.items()):
        _say(f"calib W={w:>7}: {c['wall_ms']:8.2f} ms/step closed -> "
             f"{c['ops_s'] / 1e6:6.2f} M ops/s")

    # aim the controller: explicit --p99-ms, or AUTO = a target between
    # the second-widest and widest rungs' modeled p99, so the adaptive
    # pick has a real ceiling to respect (2.5x slack over the idle
    # calibration model for the wall inflation under client threads)
    if a.p99_ms:
        target = float(a.p99_ms)
    else:
        w_mid = widths[-2] if len(widths) > 1 else widths[-1]
        target = cfg.model_mult * calib[w_mid]["wall_ms"] * 2.5
    srv.retarget("read", target)
    n_paced = max(1, a.tenants)

    jstats0 = journal.stats()  # calibration's appends/fsyncs excluded
    stats_lock = threading.Lock()
    cstats = {"rejects": 0, "degraded_rejects": 0, "bad_values": 0,
              "reqs": 0, "write_reqs": 0, "inflight_failures": 0}
    pacers: list[AdmissionPacer] = []
    ok_vals = (np.uint64(STAMP0), np.uint64(STAMP1))

    def check_reads(keys_req, vals_out, found):
        # every loaded key must be found, valued with either stamp
        x = vals_out ^ keys_req
        return int(np.sum(~(found & ((x == ok_vals[0])
                                     | (x == ok_vals[1])))))

    def draw(seed: int, n: int) -> list:
        # a tenant's requests, drawn before the phases' timers start (a
        # sampler's set-up sums zeta over every key)
        sample = make_sampler(a.keys, a.theta, rank_to_key, seed)
        return [np.ascontiguousarray(sample(a.req_ops), np.uint64)
                for _ in range(n)]

    # tenant -> (seed, requests to draw): the loader, the paced tenants, and
    # phase B's greedy and polite tenants, drawn on one thread each
    seeds = {"loader": (555, 32),
             **{f"tenant{k}": (100 + k, 128) for k in range(n_paced)},
             **({"greedy": (999, 32), "polite": (777, 128)}
                if a.greedy else {})}
    with ThreadPoolExecutor(len(seeds)) as ex:
        reqs = dict(zip(seeds, ex.map(lambda sn: draw(*sn),
                                      seeds.values())))

    def client(tenant: str, seed: int, stop: threading.Event,
               period: float, write_frac: float):
        # requests are pre-generated and results audited after the
        # phase, so per-request numpy work stays out of the paced loop
        reqpool = reqs[tenant]
        wmask = np.random.default_rng(seed).random(4096) < write_frac
        pacer = AdmissionPacer(period, spin_ms=a.spin_ms)
        with stats_lock:
            pacers.append(pacer)
        futs = []    # (future, request keys) in flight
        results = []  # (request keys, result) for the post-phase audit
        local = {"rejects": 0, "deg": 0, "bad": 0, "reqs": 0,
                 "writes": 0, "seen": 0, "failed": 0}

        def drain(f, kreq):
            try:
                res = f.result(timeout=60)
            except (ServeOverloadError, DegradedError):
                local["rejects"] += 1
                return
            except ShermanError:
                local["failed"] += 1
                return
            if f.op == "read":
                # sample 1 in 4 at append time: keeping every result
                # would hold GBs at 65,536-op requests over 30 s
                local["seen"] += 1
                if local["seen"] % 4 == 0:
                    results.append((kreq, res))

        pacer.start()
        i = 0
        while not stop.is_set():
            pacer.wait_turn(i)
            kreq = reqpool[i & 127]
            write = bool(wmask[i & 4095])
            i += 1
            try:
                if write:
                    fut = srv.submit("insert", kreq,
                                     kreq ^ np.uint64(STAMP1),
                                     tenant=tenant)
                    local["writes"] += 1
                else:
                    fut = srv.submit("read", kreq, tenant=tenant)
                futs.append((fut, kreq))
                local["reqs"] += 1
            except ServeOverloadError:
                local["rejects"] += 1
            except DegradedError:
                local["deg"] += 1
            # reap completed futures without blocking the pacer; block
            # (bounded in-flight) only when the backlog runs away
            while futs and futs[0][0].done():
                drain(*futs.pop(0))
            while len(futs) > 256:
                drain(*futs.pop(0))
        for f, kreq in futs:
            drain(f, kreq)
        for kreq, (vals_out, found) in results:
            local["bad"] += check_reads(kreq, vals_out, found)
        with stats_lock:
            cstats["rejects"] += local["rejects"]
            cstats["degraded_rejects"] += local["deg"]
            cstats["bad_values"] += local["bad"]
            cstats["reqs"] += local["reqs"]
            cstats["write_reqs"] += local["writes"]
            cstats["inflight_failures"] += local["failed"]

    def greedy(tenant: str, stop: threading.Event):
        """Unpaced burst tenant: admission must cap it at its share with
        typed rejects while the polite tenants keep admitting."""
        reqpool = reqs[tenant]
        futs = []
        i = 0
        while not stop.is_set():
            i += 1
            try:
                futs.append(srv.submit("read", reqpool[i & 31],
                                       tenant=tenant))
            except ServeOverloadError:
                time.sleep(0.002)
            while len(futs) > 64:
                try:
                    futs.pop(0).result(timeout=60)
                except ShermanError:
                    pass
        for f in futs:
            try:
                f.result(timeout=60)
            except ShermanError:
                pass

    # -- phase 0 (capacity): one unpaced loader saturates the front door
    # at the controller's settled width; within_1_3x compares this with
    # the same width's closed-loop calibration
    served0 = srv.served_ops
    picks0 = dict(srv.controller.picks)
    stop0 = threading.Event()
    ld = threading.Thread(target=greedy, args=("loader", stop0),
                          daemon=True)
    phase_s = {"calibrate": calib_s}
    t1 = time.perf_counter()
    ld.start()
    time.sleep(min(2.5, a.secs / 2))
    stop0.set()
    ld.join(timeout=120)
    cap_elapsed = time.perf_counter() - t1
    phase_s["capacity"] = cap_elapsed
    cap_ops_s = (srv.served_ops - served0) / cap_elapsed
    cap_picks = {w: srv.controller.picks[w] - picks0.get(w, 0)
                 for w in srv.controller.picks}
    settled = max(cap_picks.items(), key=lambda kv: kv[1])[0]
    closed_at_settled = calib[settled]["ops_s"]
    ratio = closed_at_settled / cap_ops_s if cap_ops_s else None
    _say(f"capacity: {cap_ops_s / 1e6:.2f} M ops/s open-loop saturated at "
         f"settled W={settled} (closed {closed_at_settled / 1e6:.2f} M -> "
         f"ratio {ratio if ratio else float('nan'):.2f})")

    # -- phase A (SLO): paced tenants at rho x the mid rung's closed rate
    # (the greedy flooder is absent: a saturated queue measures the cap,
    # not the width)
    w_mid = widths[-2] if len(widths) > 1 else widths[-1]
    offered_ops_s = a.rho * calib[w_mid]["ops_s"]
    req_rate = offered_ops_s / a.req_ops
    period_s = n_paced / req_rate
    _say(f"target p99 {target:.2f} ms; offering "
         f"{offered_ops_s / 1e6:.2f} M ops/s ({req_rate:.0f} req/s x "
         f"{a.req_ops} ops, rho {a.rho}, {n_paced} paced tenants)")
    srv.tracker.reset()
    served0 = srv.served_ops
    stopA = threading.Event()
    threads = [threading.Thread(
        target=client,
        args=(f"tenant{k}", 100 + k, stopA, period_s, a.write_frac),
        daemon=True) for k in range(n_paced)]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(a.secs)
    stopA.set()
    for t in threads:
        t.join(timeout=120)
    elapsed = time.perf_counter() - t1
    phase_s["slo"] = elapsed
    window = srv.tracker.window()
    served_ops = srv.served_ops - served0
    width_picks = dict(srv.controller.picks)
    downshifts = srv.controller.downshifts
    slo_picks = {w: width_picks[w] - cap_picks.get(w, 0)
                 - picks0.get(w, 0) for w in width_picks}
    slo_settled = max(slo_picks.items(), key=lambda kv: kv[1])[0] \
        if any(slo_picks.values()) else settled

    # -- phase B (fairness): an unpaced greedy flooder beside a polite
    # paced tenant
    fairness = None
    t1 = time.perf_counter()
    if a.greedy:
        stopB = threading.Event()
        tb = [threading.Thread(target=greedy, args=("greedy", stopB),
                               daemon=True),
              threading.Thread(target=client,
                               args=("polite", 777, stopB,
                                     period_s * 2, 0.0),
                               daemon=True)]
        for t in tb:
            t.start()
        time.sleep(min(3.0, a.secs / 2))
        stopB.set()
        for t in tb:
            t.join(timeout=120)
        tstats = srv.stats()["tenants"]
        phase_b = {name: tstats[name] for name in ("greedy", "polite")
                   if name in tstats}
        b_served = max(1, sum(t["served_ops"] for t in phase_b.values()))
        for t in phase_b.values():
            t["share"] = round(t["served_ops"] / b_served, 4)
        fairness = {
            "tenants": phase_b,
            "greedy_rejects": phase_b.get("greedy", {}).get(
                "rejected_overload", 0),
            "polite_rejects": phase_b.get("polite", {}).get(
                "rejected_overload", 0),
        }

    phase_s["fairness"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    sstats = srv.stats()
    retraces = srv.retraces
    srv.stop()
    journal.close()
    phase_s["stop"] = time.perf_counter() - t1
    serve_ops_s = served_ops / elapsed
    read_w = window.get("read") or {}
    ins_w = window.get("insert") or {}
    p99_read = read_w.get("p99_ms")
    adm = pacers[0] if pacers else AdmissionPacer(period_s)
    for p in pacers[1:]:
        adm.merge_errors(p)
    adm_receipt = adm.jitter_receipt()
    obs_slo = obs.slo_window()

    out = {
        "schema_version": 3,
        "metric": "serve_bench",
        "keys": a.keys,
        "theta": a.theta,
        "nodes": 1,
        "secs": round(elapsed, 2),
        "calib_s": round(calib_s, 3),
        "phase_s": {k: round(v, 3) for k, v in phase_s.items()},
        "serve_ops_s": round(serve_ops_s),
        "serve_read_p99_ms": round(p99_read, 3) if p99_read else None,
        "serve_write_p99_ms": round(ins_w["p99_ms"], 3)
        if ins_w.get("p99_ms") else None,
        "serve": {
            "p99_targets_ms": {"read": round(target, 3)},
            "p99_target_met": bool(p99_read is not None
                                   and p99_read <= target),
            "widths": list(widths),
            # the capacity phase's settled width (the throughput pin's)
            # and the SLO phase's own
            "settled_width": settled,
            "slo_settled_width": slo_settled,
            "width_picks": width_picks,
            "slo_picks": slo_picks,
            "downshifts": downshifts,
            "fusion": a.fusion,
            "prep_impl": sstats["request_plane"]["prep_impl"],
            "offered_ops_s": round(offered_ops_s),
            "rho": a.rho,
            "req_ops": a.req_ops,
            "requests": cstats["reqs"],
            "write_requests": cstats["write_reqs"],
            "closed_loop": {str(w): round(c["ops_s"])
                            for w, c in calib.items()},
            "calibration_wall_ms": {str(w): round(c["wall_ms"], 3)
                                    for w, c in calib.items()},
            "capacity_ops_s": round(cap_ops_s),
            "capacity_picks": cap_picks,
            "closed_ops_s_at_settled": round(closed_at_settled),
            "ratio_vs_closed": round(ratio, 3) if ratio else None,
            "within_1_3x": bool(ratio is not None and ratio <= 1.3),
            "tenants": {n: t for n, t in sstats["tenants"].items()
                        if n.startswith("tenant")},
            "fairness": fairness,
            "rejects": sstats["rejects"],
            "client_rejects": cstats["rejects"],
            "inflight_failures": cstats["inflight_failures"],
            "bad_values": cstats["bad_values"],
            "window": {cls: {k: round(float(v), 3)
                             for k, v in st.items()}
                       for cls, st in window.items()},
            "slo_window": {cls: {k: round(float(v), 3)
                                 for k, v in st.items()}
                           for cls, st in obs_slo.items()},
            "sealed": sstats["sealed"],
            "retraces": retraces,
            # traffic-phase journal coalescing (calibration excluded)
            "journal": {
                "appends": sstats["journal"]["appends"]
                - jstats0["appends"],
                "fsyncs": sstats["journal"]["fsyncs"]
                - jstats0["fsyncs"],
                "acked_write_requests": cstats["write_reqs"],
                "acks_per_fsync": round(
                    cstats["write_reqs"]
                    / (sstats["journal"]["fsyncs"] - jstats0["fsyncs"]),
                    2)
                if sstats["journal"]["fsyncs"] > jstats0["fsyncs"]
                else None,
            } if sstats.get("journal") else None,
            "cache": sstats.get("cache"),
            **adm_receipt,
        },
    }
    if auditor is not None:
        out["serve"]["audit"] = {
            **sstats.get("audit", {}),
            "violations": auditor.violations,
            "cost_frac": auditor.cost_frac(elapsed),
        }
    ok = (retraces == 0 and cstats["bad_values"] == 0
          and out["serve"]["p99_target_met"]
          and out["serve"]["within_1_3x"])
    if fairness is not None:
        ok = ok and fairness["greedy_rejects"] > 0 \
            and fairness["polite_rejects"] == 0
    out["ok"] = bool(ok)
    _say(f"serve: {served_ops} ops in {elapsed:.2f}s -> "
         f"{serve_ops_s / 1e6:.2f} M ops/s open-loop; read p99 "
         f"{p99_read if p99_read else float('nan'):.2f} ms vs target "
         f"{target:.2f} ("
         f"{'MET' if out['serve']['p99_target_met'] else 'MISSED'}); "
         f"settled W={settled}; retraces {retraces}; "
         f"rejects {sstats['rejects']}; adm p99 "
         f"{adm_receipt['adm_jitter_p99_ms']:.3f} ms")
    return out


def run_crash_drill(a) -> dict:
    """The journaled-ack durability drill (module docstring)."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.errors import StateError
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.serve import ServeConfig, ShermanServer
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.ycsb_bench import pages_for_keys

    widths = tuple(int(w) for w in a.widths.split(","))
    t0 = time.perf_counter()
    cluster, tree, eng, keys, rank_to_key = build_engine(
        a.keys, widths, False, a.device)
    build_s = time.perf_counter() - t0
    jdir = a.journal_dir or tempfile.mkdtemp(prefix="serve-crash-")
    jpath = os.path.join(jdir, "serve-journal.bin")
    journal = J.Journal(jpath, sync=True,
                        group_commit_ms=a.group_commit_ms)
    cfg = ServeConfig(widths=widths,
                      p99_targets_ms={c: 1e9 for c in
                                      ("read", "scan", "insert",
                                       "delete")},
                      group_commit_ms=a.group_commit_ms,
                      write_linger_ms=0.5)
    srv = ShermanServer(eng, cfg, journal=journal)
    srv.start(calib_keys=keys[:4096],
              calib_writes=(keys[:512], keys[:512] ^ np.uint64(STAMP0)))
    jstats0 = journal.stats()  # calibration fsyncs excluded

    n_writers = 4
    per = a.keys // (n_writers + 1)
    acked: list[dict] = [dict() for _ in range(n_writers)]
    stop = threading.Event()

    def writer(w: int):
        # a disjoint key slice a writer: per-key FIFO within one tenant
        # makes "last acked value" well defined for the RPO audit
        my = keys[w * per:(w + 1) * per]
        rng = np.random.default_rng(w)
        gen = 0
        while not stop.is_set():
            gen += 1
            idx = rng.integers(0, my.size, 128)
            kreq = np.unique(my[idx])
            vreq = kreq ^ np.uint64(STAMP1) ^ np.uint64(gen)
            try:
                fut = srv.submit("insert", kreq, vreq,
                                 tenant=f"writer{w}")
                ok = fut.result(timeout=30)
            except StateError:
                return  # the crash: an in-flight op never acked, not owed
            except Exception:
                continue
            # the ack gate passed: the OK rows are durable by contract (a
            # lock-timeout row is typed-rejected and never journaled)
            for k, v, o in zip(kreq.tolist(), vreq.tolist(), ok.tolist()):
                if o:
                    acked[w][k] = v

    threads = [threading.Thread(target=writer, args=(w,), daemon=True)
               for w in range(n_writers)]
    for t in threads:
        t.start()
    time.sleep(a.secs)
    # CRASH: kill mid-traffic, no drain, journal left unclosed
    srv.kill()
    stop.set()
    for t in threads:
        t.join(timeout=60)
    jstats = journal.stats()
    n_acked = sum(len(d) for d in acked)
    acked_reqs = srv.acked_writes
    fsyncs = jstats["fsyncs"] - jstats0["fsyncs"]
    acks_per_fsync = acked_reqs / fsyncs if fsyncs else None
    del srv, eng, tree, cluster
    if torch.device(a.device).type == "cuda":
        import gc
        gc.collect()
        torch.cuda.empty_cache()

    # RECOVERY: rebuild the base image the journal's records apply onto,
    # replay, audit every acked write
    t0 = time.perf_counter()
    cfg2 = DSMConfig(machine_nr=1, pages_per_node=pages_for_keys(a.keys),
                     locks_per_node=65_536, step_capacity=max(widths),
                     chunk_pages=1024, device=a.device)
    tree2 = Tree(Cluster(cfg2))
    batched.bulk_load(tree2, keys, keys ^ np.uint64(STAMP0))
    # the serving engine's batch: a replayed record is one flush's
    # coalesced writes (hundreds of keys), and padding each to the widest
    # rung would make the replay's time that of ~1,000 full-width steps
    eng2 = batched.BatchedEngine(tree2,
                                 batch_per_node=min(4096, max(widths)),
                                 tcfg=TreeConfig(sibling_chase_budget=1))
    eng2.attach_router()
    rebuild_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay_stats = J.replay(jpath, eng2)
    replay_s = time.perf_counter() - t0
    missing = 0
    for d in acked:
        if not d:
            continue
        ak = np.fromiter(d.keys(), np.uint64, len(d))
        av = np.fromiter(d.values(), np.uint64, len(d))
        got, found = eng2.search(ak)
        missing += int(np.sum(~(found & (got == av))))
    out = {
        "schema_version": 3,
        "metric": "serve_crash_drill",
        "keys": a.keys,
        "writers": n_writers,
        "secs": a.secs,
        "acked_write_requests": acked_reqs,
        "acked_rows": n_acked,
        "rpo_ops": missing,
        "group_commit_ms": a.group_commit_ms,
        "journal": jstats,
        "acks_per_fsync": round(acks_per_fsync, 2)
        if acks_per_fsync else None,
        "replay": replay_stats,
        "build_s": round(build_s, 3),
        "rebuild_s": round(rebuild_s, 3),
        "replay_s": round(replay_s, 3),
        "ok": bool(missing == 0 and n_acked > 0
                   and (acks_per_fsync or 0) > 1),
    }
    _say(f"crash drill: {acked_reqs} acked write reqs ({n_acked} rows) "
         f"across {n_writers} writers; {fsyncs} fsyncs -> "
         f"{acks_per_fsync or 0:.1f} acks/fsync; replayed "
         f"{replay_stats['records']} records; RPO {missing} ops")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="open-loop serving front-door bench / crash drill of "
                    "the PyTorch/CUDA port (on the GPU)")
    ap.add_argument("--keys", type=int, default=200_000)
    ap.add_argument("--theta", type=float, default=0.99)
    ap.add_argument("--widths", type=str, default="1024,4096,16384")
    ap.add_argument("--p99-ms", type=float, default=0.0,
                    help="read p99 target in ms (0 = auto from the "
                         "calibrated frontier)")
    ap.add_argument("--secs", type=float, default=6.0)
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--req-ops", type=int, default=1024,
                    help="ops per client request (one RPC's batch)")
    ap.add_argument("--rho", type=float, default=0.6,
                    help="SLO-phase offered fraction of the mid rung's "
                         "closed-loop calibration rate")
    ap.add_argument("--write-frac", type=float, default=0.0,
                    help="write fraction of SLO-phase requests (default "
                         "0: the SLO phase measures reads, YCSB-C)")
    ap.add_argument("--spin-ms", type=float, default=2.0)
    ap.add_argument("--fusion", choices=("aligned", "pipelined"),
                    default="pipelined")
    ap.add_argument("--no-greedy", dest="greedy", action="store_false",
                    help="drop the unpaced burst tenant")
    ap.add_argument("--cache", action="store_true",
                    help="attach the hot-key leaf cache with sketch "
                         "admission (admit_every=16)")
    ap.add_argument("--group-commit-ms", type=float, default=2.0)
    ap.add_argument("--journal-dir", type=str, default=None)
    ap.add_argument("--crash-drill", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for a rehearsal of the "
                         "plain path at a small size")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    if torch.device(a.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("sherman_tpu_torch.serve_bench: no CUDA device; the port's "
              "benchmark runs on the GPU", file=sys.stderr)
        return 2
    out = run_crash_drill(a) if a.crash_drill else run_serve(a)
    if torch.device(a.device).type == "cuda":
        from sherman_tpu_torch.bench import _device_info
        out["device"] = _device_info()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
