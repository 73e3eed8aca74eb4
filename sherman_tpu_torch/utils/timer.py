"""Timers: the reference's nanosecond host timer (a copy of
``sherman_tpu/utils/timer.py``, the ``include/Timer.h`` counterpart) and
the card's device-time helpers that the profilers and ``chip_smoke.py``
share.

Device time is taken with CUDA events.  A spin kernel
(``torch.cuda._sleep``) is queued before the start event, so the card is
busy while the host enqueues the timed launches and the interval holds no
host time unless the timed function waits for the card.  The helpers need
a card; on the CPU the profilers time on the host clock instead.
"""

from __future__ import annotations

import time

import numpy as np


class Timer:
    """begin/end ns timer; ``end(loop)`` returns ns amortized per loop."""

    def __init__(self):
        self._t0 = 0

    def begin(self) -> None:
        self._t0 = time.perf_counter_ns()

    def end(self, loop: int = 1) -> float:
        """Elapsed ns since ``begin``, divided by ``loop`` (Timer.h:24-33)."""
        return (time.perf_counter_ns() - self._t0) / max(loop, 1)

    def end_print(self, loop: int = 1, label: str = "") -> float:
        ns = self.end(loop)
        prefix = f"{label}: " if label else ""
        if ns >= 1e9:
            print(f"{prefix}{ns / 1e9:.3f} s")
        elif ns >= 1e6:
            print(f"{prefix}{ns / 1e6:.3f} ms")
        elif ns >= 1e3:
            print(f"{prefix}{ns / 1e3:.3f} us")
        else:
            print(f"{prefix}{ns:.0f} ns")
        return ns

    def end_us(self, loop: int = 1) -> float:
        return self.end(loop) / 1e3


def spin_sleep_ns(ns: int) -> None:
    """Busy-wait for ``ns`` nanoseconds (Timer.h:45-53 ``sleep``), for
    sub-scheduler-quantum pacing in benchmark drivers."""
    end = time.perf_counter_ns() + ns
    while time.perf_counter_ns() < end:
        pass


# -- device time on the card --------------------------------------------------

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # H100 SXM 32-bit rate outside the tensor cores
#                                (67 TFLOP/s fp32, data sheet), for compares
SPIN_CYCLES = 2_000_000        # ~1 ms of the card's clock


def _event_ms(fn) -> float:
    """One call timed with CUDA events, in ms: the device time of what
    ``fn`` launches, the host's enqueue hidden behind a spin kernel."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_ms(fn, reps: int = 21, warmup: int = 2) -> float:
    """Median of ``reps`` single-call CUDA-event timings, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return float(np.median([_event_ms(fn) for _ in range(reps)]))


def host_ms(fn, reps: int = 21) -> float:
    """Mean host time to enqueue one call of ``fn`` (wrapper and launch),
    in ms, with the card kept busy so no call waits for it."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * reps)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e3


def time_ab(fa, fb, reps: int = 21, warmup: int = 2) -> tuple[float, float]:
    """Medians of ``reps`` single-call timings of ``fa`` and of ``fb``,
    taken in turns (a b, b a, a b, ...) so that drift falls on both."""
    import torch
    for _ in range(warmup):
        fa()
        fb()
    torch.cuda.synchronize()
    ta, tb = [], []
    for k in range(reps):
        for f, ts in ((fa, ta), (fb, tb))[::1 if k % 2 == 0 else -1]:
            ts.append(_event_ms(f))
    return float(np.median(ta)), float(np.median(tb))


def bound(nbytes: int, nops: int) -> dict:
    """Least time the card could take: the larger of bytes over the HBM
    rate and operations over the 32-bit rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes}


def device_ms(fn, device, reps: int = 21, warmup: int = 2) -> float:
    """:func:`time_ms` on the card; on the CPU the median of ``reps``
    host-clock timings of one call (the CPU's work is synchronous)."""
    import torch
    if torch.device(device).type == "cuda":
        return time_ms(fn, reps=reps, warmup=warmup)
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))
