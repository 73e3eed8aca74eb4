"""Process-wide metrics registry: counters, gauges, histograms (the
port's copy of ``sherman_tpu/obs/registry.py``).

Design constraints (from the benchmark drivers that motivated it):

- **Hot-path increments are counter-increment cheap.**  ``Counter.inc``
  is one attribute add — no locks, no dict lookups, no branches.  The
  single-threaded driver path (bench loops, the batched engine) pays
  ~40 ns per increment; under free threading a data race can at worst
  undercount (increments are not atomic read-modify-writes across
  threads), which is the standard statsd/prometheus-client trade for a
  lock-free hot path.  Metric *creation* takes the registry lock.
- **Snapshot/delta semantics.**  ``snapshot()`` flattens every metric
  to plain Python values; ``delta(before, after)`` diffs two snapshots
  so a test or bench can assert "this region cost N DSM reads" without
  resetting global state.
- **Pull collectors.**  State that lives off-host (the DSM's device
  counter array) registers a callable; snapshots invoke it and merge
  the returned dict under the collector's prefix.  Collectors are held
  by weakref-bound closures at the call sites, and a collector that
  raises is skipped (recorded under ``_collector_errors``) — a donated
  device buffer mid-step must not take the whole snapshot down.
"""

from __future__ import annotations

import math
import threading
from typing import Callable

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "snapshot", "delta",
    "register_collector", "unregister_collector", "get_registry",
]


class Counter:
    """Monotonic event counter.  ``inc`` is the hot path: no locks."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """Last-value-wins instantaneous measurement."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, v: float) -> None:
        self.value += float(v)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Log2-bucketed value distribution in Python, host-side and
    unit-agnostic (the native tier's fixed-width ``LatencyHistogram``,
    :mod:`sherman_tpu_torch.native`, serves the bench's latency phase):
    64 power-of-two buckets cover any non-negative range;
    count/sum/min/max are exact, percentiles bucket-resolved (within 2x
    — the same fidelity class the fixed-width histogram trades at its
    range cap)."""

    __slots__ = ("name", "buckets", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.buckets = [0] * 64
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float, n: int = 1) -> None:
        b = max(0, float(v)).__trunc__().bit_length()  # 0 -> bucket 0
        self.buckets[min(b, 63)] += n
        self.count += n
        self.sum += float(v) * n
        if v < self.min:
            self.min = float(v)
        if v > self.max:
            self.max = float(v)

    def percentile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-th percentile (q in
        [0, 100]); 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        seen = 0
        for b, c in enumerate(self.buckets):
            seen += c
            if seen >= target and c:
                return float((1 << b) - 1) if b else 0.0
        return float(self.max)

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": (self.sum / self.count) if self.count else None,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named metrics + pull collectors; get-or-create is idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._collectors: dict[str, Callable[[], dict]] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def metrics(self) -> list:
        """The live metric objects (typed view — the Prometheus
        exposition needs counter/gauge/histogram kinds, which the flat
        snapshot erases)."""
        with self._lock:
            return list(self._metrics.values())

    def register_collector(self, prefix: str,
                           fn: Callable[[], dict]) -> None:
        """Merge ``fn()`` (a flat name -> number dict) into every
        snapshot under ``prefix.``.  Re-registering a prefix replaces
        the previous collector (a rebuilt DSM supersedes its ancestor)."""
        with self._lock:
            self._collectors[prefix] = fn

    def unregister_collector(self, prefix: str) -> None:
        with self._lock:
            self._collectors.pop(prefix, None)

    def snapshot(self) -> dict:
        """Flatten everything to plain values: counters -> int, gauges
        -> float, histograms -> dict, collectors -> prefixed entries."""
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors.items())
        for m in metrics:
            out[m.name] = m.snapshot()
        errs = []
        for prefix, fn in collectors:
            try:
                for k, v in fn().items():
                    out[f"{prefix}.{k}"] = v
            except Exception as e:  # donated buffer mid-step, dead ref…
                errs.append(f"{prefix}: {type(e).__name__}: {e}")
        if errs:
            out["_collector_errors"] = errs
        return out

    def reset(self) -> None:
        """Zero every metric IN PLACE (test isolation).

        Registrations and collectors survive: instrumentation sites
        (btree, dsm, transport) bind their Counter objects at import,
        so dropping the objects would disconnect them from snapshots
        for the life of the process — zeroing keeps the bindings live.
        """
        with self._lock:
            for m in self._metrics.values():
                if isinstance(m, Counter):
                    m.value = 0
                elif isinstance(m, Gauge):
                    m.value = 0.0
                else:
                    m.buckets = [0] * 64
                    m.count = 0
                    m.sum = 0.0
                    m.min = math.inf
                    m.max = -math.inf


def delta(before: dict, after: dict) -> dict:
    """Diff two snapshots: numeric entries subtract (counter deltas),
    histogram dicts diff their ``count``/``sum``, and keys only present
    in ``after`` (metrics born inside the region) count from zero."""
    out: dict = {}
    for k, v in after.items():
        if k.startswith("_"):
            continue
        b = before.get(k)
        if isinstance(v, dict):
            bc = b if isinstance(b, dict) else {}
            out[k] = {"count": v.get("count", 0) - bc.get("count", 0),
                      "sum": (v.get("sum") or 0) - (bc.get("sum") or 0)}
        elif isinstance(v, (int, float)):
            out[k] = v - (b if isinstance(b, (int, float)) else 0)
    return out


# -- process-wide default registry -------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return _REGISTRY.histogram(name)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def register_collector(prefix: str, fn: Callable[[], dict]) -> None:
    _REGISTRY.register_collector(prefix, fn)


def unregister_collector(prefix: str) -> None:
    _REGISTRY.unregister_collector(prefix)
