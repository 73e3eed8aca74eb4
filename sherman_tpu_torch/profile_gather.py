"""Page-kernel profiler (the port's counterpart of
``tools/profile_gather.py``): each hand-written page kernel beside its
plain PyTorch twin and, where there is one, the PyTorch library call that
computes the same function, at ``--rows`` rows of a live tree.

The reference's A/B is "pallas vs xla" timed by a chained delta inside one
jitted loop (K and 2K chained reps, which cancels a ~100 ms per-call sync
through the TPU host's access tunnel).  The card has no tunnel: each call
is timed alone with CUDA events behind a spin kernel
(``utils/timer.time_ms``, median of 21; the twin and the library call
median of 5), on the CPU with the host clock.  Phases:

- ``descent_round``   K1 (fused page fetch + in-page search) on the
                      router's start pages; no library call.
- ``snapshot_gather`` K2 ``gather_pages``; library ``index_select``.
- ``writeback_3w/5w`` K3 on a copy of the pool (the update's and the
                      insert's lanes, one applied row per distinct
                      (page, slot) target, as the kernel's contract
                      asks); library ``index_put_``.

``--impls`` takes ``twin,kernel,library`` (the reference's ``xla``/
``pallas`` become ``twin``/``kernel``).  Each time is recorded as a
``kernels.{phase}_{impl}_ms`` obs histogram.  On the CPU the kernel
wrappers run their twins (``kernel_on_card`` false, the reference's
``pallas_interpreted``).

    python -m sherman_tpu_torch.profile_gather [--rows 2097152]
        [--keys 2000000] [--k 4] [--impls twin,kernel,library]
        [--device cuda]

Prints a table on stderr and one JSON line ``{"metric":
"page_kernels_ab", "phases": {phase: {twin, kernel, library, ratio}}}``
(``ratio`` = kernel / twin); ``main(argv)`` returns the same dict.
Without a card it exits 2 unless given ``--device cpu``.  ``--k`` is kept
for the reference's CLI and sets the warm-up calls.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sherman_tpu_torch import tools_common as TC

IMPLS = ("twin", "kernel", "library")


def phase_table(pool, addr, khi, klo, *, impls=IMPLS, warmup: int = 2,
                seed: int = 3) -> dict:
    """ms per phase per impl on live tensors: ``pool`` [P, 256], ``addr``
    packed page addresses [M] (the descent's start and the gather's and
    scatter's rows), ``khi``/``klo`` [M] key words.  The write-backs
    scatter into one copy of ``pool``.  Records the ``kernels.*_ms``
    histograms.  -> {phase: {impl: ms}}."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.ops import page_kernels as PK
    from sherman_tpu_torch.utils.timer import device_ms

    dev = pool.device
    M, P = addr.shape[0], pool.shape[0]
    rng = np.random.default_rng(seed)
    act = torch.ones(M, dtype=torch.bool, device=dev)
    rows = bits.addr_page(addr).clamp(0, P - 1).to(torch.int32)
    rows_l = rows.long()
    slot_np = rng.integers(0, C.LEAF_CAP, M).astype(np.int32)
    tgt = rows.cpu().numpy().astype(np.int64) * C.LEAF_CAP + slot_np
    applied_np = np.zeros(M, bool)
    applied_np[np.unique(tgt, return_index=True)[1]] = True
    slot = torch.as_tensor(slot_np, device=dev)
    applied = torch.as_tensor(applied_np, device=dev)
    work = pool.clone()
    flat = work.view(-1)
    res: dict = {}

    def run(phase, impl, fn, reps):
        ms = device_ms(fn, dev, reps=reps, warmup=warmup)
        res.setdefault(phase, {})[impl] = ms
        obs.histogram(f"kernels.{phase}_{impl}_ms").record(ms)
        print(f"{phase:20s} {impl:8s} {ms:9.4f} ms", file=sys.stderr,
              flush=True)

    upd = (C.L_VER_W, C.L_VHI_W, C.L_VLO_W)
    ins = (C.L_VER_W, C.L_KHI_W, C.L_KLO_W, C.L_VHI_W, C.L_VLO_W)
    wb = {}
    for name, lanes in (("writeback_3w", upd), ("writeback_5w", ins)):
        ent = torch.as_tensor(rng.integers(1, 1 << 30, (M, len(lanes)))
                              .astype(np.int32), device=dev)
        fw = torch.tensor(lanes, dtype=torch.int64, device=dev)
        idx = ((rows_l * C.PAGE_WORDS)[:, None] + fw[None, :]
               + slot.long()[:, None])
        sel = applied[:, None].expand_as(idx)
        wb[name] = (lanes, ent, idx[sel], ent[sel])
    phases = {
        "descent_round": {
            "twin": lambda: PK.descent_round_ref(pool, addr, khi, klo, act),
            "kernel": lambda: PK.descent_round(pool, addr, khi, klo, act)},
        "snapshot_gather": {
            "twin": lambda: PK.gather_pages_ref(pool, rows),
            "kernel": lambda: PK.gather_pages(pool, rows),
            "library": lambda: pool.index_select(0, rows_l)},
    }
    for name, (lanes, ent, fi, fv) in wb.items():
        phases[name] = {
            "twin": lambda lanes=lanes, ent=ent: PK.writeback_ref(
                work, rows, slot, applied, ent, lanes),
            "kernel": lambda lanes=lanes, ent=ent: PK.writeback(
                work, rows, slot, applied, ent, lanes),
            "library": lambda fi=fi, fv=fv: flat.index_put_((fi,), fv)}
    for phase, by in phases.items():
        for impl in impls:
            if impl in by:
                run(phase, impl, by[impl], 5 if impl != "kernel" else 21)
    for by in res.values():
        if by.get("twin") and "kernel" in by:
            by["ratio"] = by["kernel"] / by["twin"]
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="page-kernel profiler of the PyTorch/CUDA port")
    p.add_argument("--rows", type=int, default=2_097_152)
    p.add_argument("--keys", type=int, default=2_000_000)
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--impls", default=",".join(IMPLS))
    TC.add_device_arg(p)
    a = p.parse_args(argv)
    TC.require_device(a.device, "profile_gather")

    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.ops import bits

    impls = tuple(s for s in a.impls.split(",") if s)
    bad = set(impls) - set(IMPLS)
    if bad:
        p.error(f"--impls {sorted(bad)}: want a subset of {IMPLS}")
    cluster, tree, eng = TC.build_cluster(1, TC.pages_for_keys(a.keys),
                                          a.rows, device=a.device)
    rng = np.random.default_rng(7)
    keys = TC.unique_keys(a.keys, 7)
    batched.bulk_load(tree, keys, keys)
    router = eng.attach_router()
    dsm = tree.dsm
    on_card = eng.device.type == "cuda"
    print(f"# rows={a.rows} keys={a.keys} pages={dsm.pool.shape[0]} "
          f"device={eng.device}"
          + ("" if on_card else " (kernel wrappers run their twins)"),
          file=sys.stderr)
    bk = keys[rng.integers(0, a.keys, a.rows)]
    khi, klo = bits.keys_to_pairs(bk)
    start = router.host_start(khi, klo)
    d = lambda x: torch.as_tensor(x, device=eng.device)
    res = phase_table(dsm.pool, d(start), d(khi), d(klo), impls=impls,
                      warmup=a.k)
    out = {
        "metric": "page_kernels_ab",
        "rows": a.rows,
        "keys": a.keys,
        "device": str(eng.device),
        "kernel_on_card": on_card,
        "phases": {ph: {k2: round(v, 4) for k2, v in by.items()}
                   for ph, by in res.items()},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
