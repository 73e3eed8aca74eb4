"""Span tracing: nested wall-clock spans with Chrome-trace export (the
port's copy of ``sherman_tpu/obs/spans.py``).

Two tiers, sharing one recording substrate:

- :class:`StepTrace` — the legacy flat micro-tracer (phase -> spans)
  for driver loops, kept API-identical to ``utils.trace.StepTrace``
  (which now re-exports from here).  ~100 ns per record.
- :class:`SpanTracer` — nested spans with thread-safe recording: each
  thread keeps its own span stack (``threading.local``), completed
  spans append to one shared list under a lock (completion is off the
  per-op hot path — it happens once per *phase*, not per request).
  Export is Chrome-trace-event JSON (``"X"`` complete events with
  microsecond timestamps), loadable in ``chrome://tracing`` and
  Perfetto (https://ui.perfetto.dev — open the file directly).

:func:`device_trace` (a ``torch.profiler`` capture over the CPU and,
where present, the CUDA activities) also lives here; it complements the
host spans with the card's kernel timeline.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

__all__ = ["StepTrace", "SpanTracer", "device_trace", "get_tracer", "span"]


class StepTrace:
    """Accumulate (phase -> spans) across a driver loop.

    >>> tr = StepTrace()
    >>> with tr.span("descend"):
    ...     ...
    >>> tr.summary()  # {'descend': {'n': 1, 'total_s': ..., 'mean_ms': ...}}
    """

    def __init__(self):
        self._spans = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self._spans[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._spans[name].append(float(seconds))

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, spans in self._spans.items():
            tot = sum(spans)
            out[name] = {"n": len(spans), "total_s": tot,
                         "mean_ms": tot / len(spans) * 1e3}
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:24s} n={s['n']:<6d} "
                         f"total={s['total_s']:8.3f}s "
                         f"mean={s['mean_ms']:8.3f}ms")
        return "\n".join(lines)


class SpanTracer:
    """Nested spans, thread-safe, Chrome-trace exportable.

    Each completed span records (name, start_us, dur_us, tid, depth);
    nesting comes from a per-thread stack so concurrent host clients
    (the local-lock tier's use case) never corrupt each other's spans.
    Bounded: beyond ``max_events`` completed spans the tracer keeps
    aggregating summaries but stops appending events (a multi-hour
    churn run must not grow an unbounded list); ``dropped`` counts the
    overflow so exports can say so.
    """

    def __init__(self, max_events: int = 1_000_000):
        self._lock = threading.Lock()
        self._events: list[tuple] = []
        self._agg = defaultdict(lambda: [0, 0.0])  # name -> [n, total_s]
        self._tls = threading.local()
        self._t0 = time.perf_counter()
        self.max_events = max_events
        self.dropped = 0
        # optional span-close subscriber (name, dur_s, depth) — the
        # flight recorder's feed; called OUTSIDE the lock, per span
        # completion (per phase, not per op)
        self.on_close = None

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **args):
        st = self._stack()
        st.append(name)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            t1 = time.perf_counter()
            st.pop()
            self._record(name, t0, t1, len(st), args or None)

    def record(self, name: str, seconds: float) -> None:
        """StepTrace-compatible after-the-fact record (the span ends
        now and lasted ``seconds``)."""
        t1 = time.perf_counter()
        self._record(name, t1 - float(seconds), t1, len(self._stack()),
                     None)

    def _record(self, name, t0, t1, depth, args) -> None:
        tid = threading.get_ident()
        # an after-the-fact record() may claim a start BEFORE the
        # tracer's epoch; clip the exported event to the trace window
        # (negative ts breaks the Chrome trace-event contract) while
        # the aggregate keeps the true duration
        e0 = max(t0, self._t0)
        with self._lock:
            a = self._agg[name]
            a[0] += 1
            a[1] += t1 - t0
            if len(self._events) < self.max_events:
                self._events.append((name, e0 - self._t0, t1 - e0, tid,
                                     depth, args))
            else:
                self.dropped += 1
        cb = self.on_close
        if cb is not None:
            cb(name, t1 - t0, depth)

    # -- views ---------------------------------------------------------------

    def summary(self) -> dict[str, dict[str, float]]:
        """StepTrace-shaped aggregate: full history even past the event
        cap."""
        with self._lock:
            return {name: {"n": n, "total_s": tot,
                           "mean_ms": tot / n * 1e3}
                    for name, (n, tot) in self._agg.items()}

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:24s} n={s['n']:<6d} "
                         f"total={s['total_s']:8.3f}s "
                         f"mean={s['mean_ms']:8.3f}ms")
        return "\n".join(lines)

    def chrome_trace(self) -> dict:
        """Chrome-trace-event JSON object: ``{"traceEvents": [...]}``.

        Complete ("X") events with microsecond timestamps; one pid
        (this process), tids preserved so multi-threaded drivers render
        as parallel tracks.  Load in chrome://tracing or Perfetto.
        """
        pid = os.getpid()
        with self._lock:
            events = list(self._events)
        trace_events = [
            {"name": name, "ph": "X", "pid": pid, "tid": tid,
             "ts": round(start * 1e6, 3), "dur": round(dur * 1e6, 3),
             "cat": "sherman_tpu",
             **({"args": args} if args else {})}
            for name, start, dur, tid, _depth, args in events
        ]
        meta = {"dropped_events": self.dropped} if self.dropped else {}
        return {"traceEvents": trace_events, "displayTimeUnit": "ms",
                "otherData": {"tracer": "sherman_tpu_torch.obs", **meta}}

    def export_chrome(self, path: str) -> str:
        """Write :meth:`chrome_trace` to ``path``; returns the path."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._agg.clear()
            self.dropped = 0
            self._t0 = time.perf_counter()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block and write
    it as a Chrome trace (``trace-<pid>-<n>.json``) into ``log_dir``.

    Records the CPU activity and, when a CUDA device is present, the
    card's kernels and copies.  Open the file in Perfetto or
    ``chrome://tracing``.  No cost outside the block.  Yields the
    profiler (``key_averages()`` gives the per-kernel sums)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace-")])
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}-{n}.json"))


# -- process-wide default tracer ---------------------------------------------

_TRACER = SpanTracer()


def get_tracer() -> SpanTracer:
    return _TRACER


def span(name: str, **args):
    """Span on the default tracer — the one instrumentation sites use."""
    return _TRACER.span(name, **args)
