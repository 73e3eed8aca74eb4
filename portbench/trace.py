"""The traced run (``--trace 1``): ``torch.profiler`` over the first
``trace_seconds`` of the window, the program's registry read at the
trace's start and stop and at the window's close, and the reduction of
the trace to what the per-layer readers and the result line take:

- ``busy_s``: the union of the device's activity (kernels, copies,
  sets) inside the traced window; ``window_s``: the window's length
  (the ``portbench.window`` span);
- ``kernel_s``: device seconds by kernel name;
- ``breakdown``: the ten device operations that took most time, and the
  device's idle time by what the host was doing (the benchmark's span
  and the outermost host operation at the gap's start).

Spans are ``torch.profiler.record_function`` ranges that the benchmark's
own code opens around its calls into each layer (``portbench.*``); with
tracing off they cost nothing.
"""

from __future__ import annotations

import bisect
import contextlib

import torch

SPAN_PREFIX = "portbench."
# the activities that occupy the device
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, enabled: bool, trace_s: float = 0.0,
                 obs_snapshot=None):
        self.enabled = enabled
        self.trace_s = trace_s
        self._snap = obs_snapshot
        self.prof = None
        self.active = False
        self._win = None
        self.obs = {}
        self.batches = {"traced": 0, "untraced": 0}
        self.traced_slots = []

    def span(self, name: str):
        if self.enabled and self.active:
            return torch.profiler.record_function(SPAN_PREFIX + name)
        return contextlib.nullcontext()

    def start(self, sync) -> None:
        """At the window's opening: the registry, then the profiler."""
        if not self.enabled:
            return
        self.obs["start"] = self._snap()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        sync()
        self._win = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._win.__enter__()
        self.active = True

    def tick(self, elapsed: float, sync) -> None:
        if self.active and elapsed >= self.trace_s:
            self._stop(sync)

    def count(self, slot: int) -> None:
        """One batch sent (its ring slot)."""
        if self.enabled:
            self.batches["traced" if self.active else "untraced"] += 1
            if self.active:
                self.traced_slots.append(slot)

    def _stop(self, sync) -> None:
        sync()
        self._win.__exit__(None, None, None)
        self.prof.stop()
        self.active = False
        self.obs["traced"] = self._snap()

    def finish(self, sync) -> None:
        """At the window's close."""
        if not self.enabled:
            return
        if self.active:
            self._stop(sync)
        self.obs["end"] = self._snap()

    def events(self):
        return self.prof.profiler.kineto_results.events()


def _merge(iv):
    """Union of [start, end) intervals -> sorted disjoint list."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _outermost(iv):
    """The outermost of nested (start, end, name) host ranges."""
    out = []
    for s, e, name in sorted(iv, key=lambda x: (x[0], -x[1])):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def _at(ranges, starts, t):
    """The range of ``ranges`` (outermost, sorted) that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ranges[i][0] <= t < ranges[i][1]:
        return ranges[i][2]
    return None


def _kind(e) -> str:
    """The event's activity (kineto's name for it; torch builds without
    ``activity_type`` are read by device and annotation flags)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    cuda = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.is_user_annotation():
        return "gpu_user_annotation" if cuda else "user_annotation"
    return "kernel" if cuda else "cpu_op"


def reduce(events, top: int = 10) -> dict:
    """Kineto events -> {busy_s, window_s, kernel_s, breakdown}.  Times
    in the profiler's clock (ns), clipped to the ``portbench.window``
    span."""
    win = None
    dev, spans, host = [], [], []
    for e in events:
        kind = _kind(e)
        name = e.name()
        s, d = e.start_ns(), e.duration_ns()
        if kind in _DEVICE_KINDS:
            dev.append((s, s + d, name))
        elif kind == "user_annotation" and name.startswith(SPAN_PREFIX):
            if name == SPAN_PREFIX + "window":
                win = (s, s + d)
            else:
                spans.append((s, s + d, name[len(SPAN_PREFIX):]))
        elif kind == "cpu_op" and d > 0:
            host.append((s, s + d, name))
    if win is None:
        raise RuntimeError("trace: no portbench.window span")
    w0, w1 = win
    kernel_ns: dict[str, int] = {}
    iv = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            kernel_ns[name] = kernel_ns.get(name, 0) + (e - s)
            iv.append((s, e))
    busy = _merge(iv)
    busy_ns = sum(e - s for s, e in busy)
    # idle gaps inside the window, by the benchmark's span and the
    # outermost host operation at the gap's start
    spans_o = _outermost(spans)
    span_starts = [x[0] for x in spans_o]
    host_o = _outermost(host)
    host_starts = [x[0] for x in host_o]
    idle: dict[str, int] = {}
    edges = [w0] + [t for seg in busy for t in seg] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = (f"{_at(spans_o, span_starts, a) or 'outside'}/"
                 f"{_at(host_o, host_starts, a) or 'idle'}")
        idle[label] = idle.get(label, 0) + (b - a)
    by_time = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
        "breakdown": {
            "device_ops": [[k[:160], v / 1e9] for k, v in by_time(kernel_ns)],
            "idle_gaps": [[k[:160], v / 1e9] for k, v in by_time(idle)],
        },
    }


def kernel_seconds(trace: dict, substring: str) -> float:
    """Device seconds of every kernel whose name holds ``substring``."""
    return sum(v for k, v in trace["kernel_s"].items() if substring in k)
