"""White-box device report: the program ledger and the roofline receipts
(the port's counterpart of ``tools/device_report.py``).

Two modes:

- ``--receipt FILE``: render the ``device`` section of a receipt the
  port's bench printed (a JSON line saved to a file, bare or wrapped as
  ``{"parsed": {...}}``) as the side-by-side tables.  A receipt without
  one gives a typed error line.
- live (default): build a small tree on the card, run the staged read
  loop under a sealed program ledger (``obs/device.py``): the warm-up
  covers both carry variants, so any program signature new inside the
  sealed window is a retrace, and the report fails on one.  Then the
  per-phase walls (``step.phase_profile``: device time between CUDA
  events on the card) are joined with the ledger's entries by
  ``obs.device.rooflines``.  Eager PyTorch has no cost analysis of a
  program (``program_cost`` is typed unavailable), so each receipt says
  "unavailable" where the reference prints a fraction of peak; the report
  invents no byte count.

Env knobs (live mode): KEYS (20 K), B (8192), DEVB (B), K (delta reps,
2), STEPS (sealed steps, 8), FUSION (config.staged_fusion), SAMPLER
(analytic), THETA (0.99); ``SHERMAN_LEAF_CACHE`` runs the sealed loop
with the hot-key tier's probe chained in.

    python -m sherman_tpu_torch.device_report [--receipt FILE]
        [--device cuda]

Prints the ledger table, the roofline table and the memory gauges on
stderr and one JSON line ``{"metric": "device_report", ...}``;
``main(argv)`` returns the same dict.  Live mode needs a card (exit 2
without one) unless given ``--device cpu``; receipt mode needs none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from sherman_tpu_torch import tools_common as TC


def _f(v, w=8, p=2):
    """Right-aligned number or a dash for absent values."""
    return f"{v:{w}.{p}f}" if isinstance(v, (int, float)) else f"{'-':>{w}s}"


def print_tables(dev: dict, file=None) -> None:
    """The side-by-side tables of one ``device`` section (on stderr by
    default)."""
    file = sys.stderr if file is None else file
    led = dev.get("ledger") or {}
    print(f"# compile ledger ({dev.get('compile_source', '?')}): "
          f"{led.get('programs', 0)} programs, "
          f"{led.get('compiles', 0)} compiles, "
          f"{led.get('compile_ms_total', 0)} ms total, "
          f"{led.get('retraces', 0)} steady-state retraces over "
          f"{led.get('sealed_windows', 0)} sealed windows", file=file)
    print(f"# {'program':34s} {'compiles':>8s} {'compile ms':>11s} "
          f"{'retraces':>8s}", file=file)
    for e in led.get("entries", ()):
        print(f"# {e['label']:34s} {e['compiles']:>8d} "
              f"{e['compile_ms']:>11.1f} {e['retraces']:>8d}", file=file)
    peaks = dev.get("peaks") or {}
    for group, phases in (dev.get("rooflines") or {}).items():
        print(f"#\n# roofline receipts [{group}] "
              f"(peaks: {peaks.get('source', '?')})", file=file)
        print(f"# {'phase':22s} {'program':30s} {'wall ms':>8s} "
              f"{'GB/s':>8s} {'GF/s':>8s} {'B-frac':>8s} {'F-frac':>8s} "
              f"{'bound':>6s}", file=file)
        for ph, rec in phases.items():
            if not rec.get("available"):
                print(f"# {ph:22s} {rec.get('program', '?'):30s} "
                      f"{_f(rec.get('wall_ms'))} unavailable: "
                      f"{rec.get('reason', '?')}", file=file)
                continue
            if rec.get("wall_below_resolution"):
                print(f"# {ph:22s} {rec.get('program', '?'):30s} "
                      f"{_f(rec.get('wall_ms'))} {'<res':>8s} {'<res':>8s} "
                      f"{'-':>8s} {'-':>8s} {'-':>6s}", file=file)
                continue
            print(f"# {ph:22s} {rec.get('program', '?'):30s} "
                  f"{_f(rec.get('wall_ms'))} "
                  f"{_f(rec.get('achieved_gbytes_s'))} "
                  f"{_f(rec.get('achieved_gflops_s'))} "
                  f"{_f(rec.get('achieved_bytes_frac'), p=4)} "
                  f"{_f(rec.get('achieved_flops_frac'), p=4)} "
                  f"{rec.get('bound', '-'):>6s}", file=file)
    mem = dev.get("memory") or {}
    if mem:
        print("#\n# memory gauges: "
              + ", ".join(f"{k} {v}" for k, v in sorted(mem.items())),
              file=file)


def _receipt_report(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    dev = doc.get("device") if isinstance(doc, dict) else None
    if not isinstance(dev, dict):
        out = {"metric": "device_report", "source": path,
               "error": "no device section (schema_version < 3 or "
                        "SHERMAN_DEVICE_OBS=0 run)"}
        print(json.dumps(out), flush=True)
        return out
    print_tables(dev)
    out = {"metric": "device_report", "source": path,
           "schema_version": doc.get("schema_version"),
           "retraces": (dev.get("ledger") or {}).get("retraces"),
           "device": dev}
    print(json.dumps(out), flush=True)
    return out


def _live_report(device: str) -> dict:
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.bench import synthetic_keys
    from sherman_tpu_torch.config import LEAF_CAP
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.obs import device as DEV
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.workload import device_prep

    n_keys = int(os.environ.get("KEYS", 20_000))
    batch = int(os.environ.get("B", 8192))
    dev_b = int(os.environ.get("DEVB", batch))
    theta = float(os.environ.get("THETA", 0.99))
    K = int(os.environ.get("K", 2))
    S = int(os.environ.get("STEPS", 8))
    fusion = os.environ.get("FUSION") or C.staged_fusion()
    sampler = os.environ.get("SAMPLER", "analytic")
    per_leaf = max(1, int(LEAF_CAP * 0.75))
    est_pages = int(n_keys / per_leaf * 1.10) + 2048
    pages = 1 << max(12, (est_pages - 1).bit_length())

    # a fresh ledger for this report: the programs built below are new
    # function objects, so their first calls land cleanly
    ledger = DEV.get_ledger()
    ledger.reset()

    _, tree, eng = TC.build_cluster(1, pages, batch, device=device)
    salt, rank_to_key = synthetic_keys(n_keys, 0x5E17_AB1E_5A17)
    keys = np.sort(rank_to_key)
    t0 = time.time()
    with obs.span("device_report.bulk_load", keys=n_keys):
        batched.bulk_load(tree, keys, keys ^ np.uint64(0xDEADBEEF),
                          fill=0.75)
    eng.attach_router()
    print(f"# bulk_load {time.time() - t0:.1f}s", file=sys.stderr)

    lc = None
    if C.leaf_cache_slots():
        lc = eng.attach_leaf_cache()
        hot = bits.mix64_np(np.arange(min(lc.capacity, n_keys),
                                      dtype=np.uint64) ^ np.uint64(salt))
        filled = lc.fill(hot)
        print(f"# leaf cache: {lc.slots} slots, prefilled "
              f"{filled['placed']} hottest ranks", file=sys.stderr)
    step, (new_carry, tb, rt, rk) = device_prep.make_staged_step(
        eng, n_keys=n_keys, theta=theta, salt=salt, batch=batch,
        dev_b=dev_b, sampler=sampler, fusion=fusion, leaf_cache=lc)
    dsm = eng.dsm
    pool, counters = dsm.pool, dsm.counters

    # warm-up: both carry variants (a fresh new_carry() and the threaded
    # outputs), so the sealed window below must record no new signature
    carry = new_carry()
    for _ in range(2):
        counters, carry = step(pool, counters, tb, rt, rk, carry)
    carry = step.drain(carry)
    TC.sync(device)

    # the sealed steady-state loop: the zero-retrace pin
    with ledger.sealed_scope():
        t0 = time.perf_counter()
        for _ in range(S):
            counters, carry = step(pool, counters, tb, rt, rk, carry)
        carry = step.drain(carry)
        TC.sync(device)
        wall = time.perf_counter() - t0
    assert int(carry[1]) == 1, "unique overflow"
    assert int(carry[2]) == (S + 2) * batch, "staged receipts failed"
    retraces = ledger.retraces
    cache_hit_ratio = None
    if lc is not None:
        hits = int(carry[5])
        cache_hit_ratio = hits / ((S + 2) * batch)
        print(f"# leaf cache: {hits} client hits "
              f"(ratio {cache_hit_ratio:.4f})", file=sys.stderr)
        assert hits > 0, "cache-on sealed loop served zero hits"
    print(f"# sealed loop: {S} steps in {wall:.3f}s "
          f"({wall / S * 1e3:.3f} ms/step), {retraces} retraces",
          file=sys.stderr)

    with obs.span("device_report.phase_attribution", reps=K):
        phase_ms, counters = step.phase_profile(pool, counters, tb, rt, rk,
                                                reps=K)
    device_prep.record_phase_obs("staged", phase_ms)

    peaks = DEV.device_peaks()
    roofs = DEV.rooflines(phase_ms, step.phase_labels, memory=True,
                          peaks=peaks, ledger=ledger)
    dev = {
        "compile_source": "program_ledger",
        "ledger": ledger.summary(),
        "peaks": peaks,
        "rooflines": {"staged": roofs},
        "memory": DEV.get_accountant().gauges(),
    }
    print_tables(dev)
    out = {"metric": "device_report", "fusion": step.fusion,
           "keys": n_keys, "batch": batch, "steps": S,
           "wall_ms_per_step": round(wall / S * 1e3, 4),
           "retraces": retraces,
           "cache": ({"slots": lc.slots,
                      "hit_ratio": round(cache_hit_ratio, 4)}
                     if lc is not None else None),
           "device": dev}
    print(json.dumps(out), flush=True)
    # the pin: a live report with a steady-state retrace is a broken
    # serving loop, not a report
    assert retraces == 0, \
        f"{retraces} steady-state retraces in the sealed loop (see the " \
        "ledger table above)"
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="white-box device report of the PyTorch/CUDA port: "
                    "program ledger + rooflines")
    ap.add_argument("--receipt", default=None,
                    help="render a receipt's device section instead of "
                         "running the live sealed loop")
    TC.add_device_arg(ap)
    a = ap.parse_args(argv)
    if a.receipt:
        return _receipt_report(a.receipt)
    TC.require_device(a.device, "device_report")
    return _live_report(a.device)


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
