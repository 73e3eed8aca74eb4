"""One run of one cell: set-up, warm-up, the measured window, the
read-back, the check, and the result line's pieces.

Set-up (``setup_s``, from the process's start): the inputs from the
seed, the port's build and bulk load, the ring, and a warm-up of
``warmup_batches`` batches through the cell's own entry (the kernel
libraries load or build at its first call).  The window then drives the
entry for ``seconds``.  After it: the device's peak memory, the read-back
of every updated key through the entry, the program's state freed, and
the reference's replay of every batch sent.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import check, gen, loops
from portbench import trace as T
from portbench.system import ControlSystem, PortSystem

TRACE_S = 4.0            # the profiler's share of a traced window


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def counter_delta(before: dict, after: dict) -> dict:
    """Numbers subtract; per-node DSM counters (uint32, wrapping) subtract
    node by node modulo 2**32 and sum."""
    out = {}
    for k, v in after.items():
        b = before.get(k, 0)
        if isinstance(v, np.ndarray):
            out[k] = int(((v - b) % (1 << 32)).sum())
        else:
            out[k] = v - b
    return out


def leaf_pages(keys: np.ndarray, ring, slots, leaf_keys: int,
               device: str) -> int:
    """The leaf pages the sent batches need, each batch's distinct leaves
    once: the bulk load lays the keys out in key order, ``leaf_keys`` to
    a leaf, so rank ``r``'s leaf is its key's sorted position over
    ``leaf_keys``.  Computed from the benchmark's own keys, not read from
    the program."""
    if not slots:
        return 0
    k = torch.from_numpy(keys.view(np.int64)).to(device) ^ (-(1 << 63))
    order = torch.sort(k).indices              # unsigned key order
    del k
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.shape[0], device=device)
    del order
    per_slot = {}
    for s in set(slots):
        r = torch.from_numpy(ring[s].ranks).to(device)
        per_slot[s] = int(torch.unique(pos[r] // leaf_keys).numel())
    return sum(per_slot[s] for s in slots)


def run_cell(spec, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str, *, t_start: float, control: bool = False,
             window_batches: int | None = None, log=_log) -> dict:
    """-> {"result": the line's keys but ``device``'s card fields,
    "check": the number compared beside its limit, "parts": its parts}.
    ``control`` puts
    the reference with a broken guarantee in the program's place
    (``portbench/control.py``), whose window sends ``window_batches``."""
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    entry = traffic["entry"]
    n_keys, width = int(cfg["n_keys"]), int(cfg["batch"])

    marks = [("start", t_start), ("imports", time.perf_counter())]
    values = gen.make_values(seed, n_keys)
    marks.append(("values", time.perf_counter()))
    if control:
        keys = None
        system = ControlSystem(values)
        ranks_to_keys = np.zeros(n_keys, np.uint64)
    else:
        _, keys = gen.make_keys(int(cfg["key_salt"], 0), n_keys, device,
                                seed)
        marks.append(("keys", time.perf_counter()))
        system = PortSystem(cfg, entry, keys, values, device, log)
        ranks_to_keys = keys
    marks.append(("build", time.perf_counter()))
    ring = gen.make_ring(traffic, n_keys, width, seed, ranks_to_keys)
    marks.append(("ring", time.perf_counter()))
    loop = loops.LOOPS[entry]
    warm = loop(system, ring, 0, 0.0, tracer=T.Tracer(False),
                max_batches=int(traffic["warmup_batches"]))
    system.sync()
    dtypes = ((np.uint64, bool) if entry == "read"
              else (np.uint64, bool, np.int32))
    keeper = loops.Keeper(gen.rng(seed, gen.KEEP),
                          float(traffic["check_share"]),
                          int(traffic["check_cap"]), width, dtypes)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    log(f"setup {setup_s:.3f} s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f"; warm-up {len(warm.sent)} batches")

    tracer = T.Tracer(trace and not control and not warm.error, TRACE_S,
                      obs_snapshot=getattr(system, "counters", None))
    tracer.start(system.sync)
    win = (loops.Record() if warm.error else
           loop(system, ring, len(warm.sent), seconds, tracer=tracer,
                max_batches=window_batches, keep=keeper))
    errors = [r.error for r in (warm, win) if r.error]
    if not errors:
        tracer.finish(system.sync)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    lat = np.array(win.lat_s or [0.0]) * 1e3
    log(f"window {win.seconds:.3f} s, {len(win.sent)} batches, "
        f"{win.ops} ops; batch ms p50 {np.percentile(lat, 50):.2f} "
        f"p95 {np.percentile(lat, 95):.2f} max {lat.max():.2f}; "
        f"{win.n_refused} updates refused")

    t_check = time.perf_counter()
    chk = check.Checker(values, ring, entry)
    wranks = chk.written_ranks(warm.sent + win.sent)
    rb = (system.readback(ranks_to_keys[wranks], wranks)
          if wranks.size and not errors else None)
    trace_red = (T.reduce(tracer.events())
                 if tracer.enabled and not errors else None)
    system.free()
    del system
    pages = (leaf_pages(keys, ring, tracer.traced_slots,
                        int(cfg["leaf_keys"]), device)
             if trace_red is not None else 0)
    del keys

    for rec in (warm, win):
        for pos, slot in enumerate(rec.sent):
            chk.batch(slot, rec.kept.get(pos), rec.refused.get(pos, ()))
    if rb is not None:
        chk.readback(wranks, *rb)
    for e in errors:
        log(f"the program raised:\n{e}")
    chk.n["unanswered"] = len(errors) * width
    log(f"check parts {chk.n}; later duplicates acknowledged APPLIED "
        f"{chk.multi_applied}")

    run = {"cell": cell, "config": cfg, "traffic": traffic,
           "window": win, "setup_s": setup_s, "trace": trace_red,
           "device_kind": (torch.cuda.get_device_name(0) if on_card
                           else "cpu")}
    if tracer.enabled:
        o = tracer.obs
        run["counters"] = {"traced": counter_delta(o["start"], o["traced"]),
                           "untraced": counter_delta(o["traced"], o["end"])}
        run["batches"] = dict(tracer.batches)
        run["leaf_pages"] = pages
        log(f"batches {run['batches']}; counters {run['counters']}")
    metrics = {}
    for m in [] if errors else spec.metrics(cell_name, trace):
        v = spec.reader(m, trace)(run)
        if v is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": chk.correct(), "attempted": win.ops,
              "failed": win.n_refused, "metrics": metrics,
              "device": {"memory_peak_bytes": int(peak)}}
    if trace_red is not None:
        result["device"]["busy_s"] = trace_red["busy_s"]
        result["device"]["window_s"] = trace_red["window_s"]
        result["breakdown"] = trace_red["breakdown"]
    log(f"kept {keeper.n} window batches ({keeper.full} past the cap); "
        f"checked {chk.batches} batches, {chk.answers} answers in "
        f"{time.perf_counter() - t_check:.3f} s (with the read-back)")
    return {"result": result, "check": chk.numbers(), "parts": dict(chk.n)}
