"""Per-op-class SLO telemetry: windowed rates + streaming latency (the
port's copy of ``sherman_tpu/obs/slo.py``).

The paper's evaluation is tail-latency-first (Sherman's headline is p99
under write-heavy skew), and the serving front door the ROADMAP names
cannot pick step widths against a per-class p99 target until something
*measures* per-class latency continuously.  The registry's
:class:`~sherman_tpu_torch.obs.registry.Histogram` is a coarse (2x-fidelity)
log2 profile tool; this module is the SLO-grade layer on top:

- :class:`LatencyTracker` — a streaming log-bucketed histogram with 8
  linear sub-buckets per octave (the HdrHistogram shape), so quantile
  estimates carry <= 12.5% bucket error (rank-interpolated within the
  bucket, typically a few %) at 512 ints of state.  ``record`` is a
  handful of integer ops — no locks, no allocation; under free
  threading a race can at worst undercount (the registry's documented
  trade).
- :class:`WindowedRate` — sliding-window ops/s over a granule ring
  (no per-op timestamps, no unbounded lists).
- :class:`SloTracker` — the per-op-class front: every *batch wall* is
  attributed to its op class (``read`` / ``insert`` / ``delete`` /
  ``mixed`` / ``scan``) as amortized per-op latency — in the batched
  execution model a client op's completion latency IS its batch's wall
  (the bench's step-span latency model), so a batch of ``ops`` requests
  served in ``wall_s`` records one wall sample *weighted by ops* and
  adds ``ops`` to the class's windowed rate.  :meth:`SloTracker.window`
  publishes, per class and per sliding window: ``ops_s``, ``p50_ms``,
  ``p99_ms``, ``p999_ms`` — exactly the width x latency frontier data
  an adaptive batcher consumes.

Window semantics: percentiles are two-generation — a current and a
previous window-sized tracker, rotated every ``window_s``; the
published quantiles merge both, so the view always covers at least one
full window and at most two (the standard rolling-histogram trade; no
per-sample timestamps).

Process-wide default: :func:`observe` / :func:`observe_op` feed the
default tracker; :func:`get_slo` registers it as a pull collector so
every registry snapshot (and therefore the Prometheus exposition and
the bench JSON ``obs`` section) carries flat ``slo.<class>.<stat>``
keys.  ``SHERMAN_SLO=0`` turns the default-tracker observers into
no-ops (the obs-on/off A/B knob; ``chip_smoke.py`` measures the staged
and host-path steps' obs cost with it on the card).

Instrumented sites: the BatchedEngine host entry points (search ->
``read``, insert -> ``insert``, delete -> ``delete``, mixed ->
``mixed``, range_query_many -> ``scan``) and the device-staged step
factories (``make_staged_step(...).record_slo`` — the bench's
sustained windows attribute whole windows at once, nothing per step).
"""

from __future__ import annotations

import math
import os
import threading
import time

__all__ = [
    "OP_CLASSES", "LatencyTracker", "WindowedRate", "SloTracker",
    "get_slo", "observe", "observe_op", "slo_window", "enabled",
]

# the serving op classes every batch wall is attributed to
OP_CLASSES = ("read", "insert", "delete", "mixed", "scan")

_SUB = 8          # linear sub-buckets per octave (3 mantissa bits)
_NBUCKETS = 512   # covers the full 63-bit ns range (u64 latencies)


class LatencyTracker:
    """Streaming log-bucketed latency histogram (ns resolution).

    Bucket layout: values below 8 ns are exact (buckets 0-7); above,
    octave ``o = bit_length - 1`` splits into 8 linear sub-buckets, so
    bucket width is value/8 — quantiles resolve within 12.5% before the
    in-bucket rank interpolation tightens them further.  ``record`` is
    integer ops + two adds; safe (undercount-at-worst) under threads.
    """

    __slots__ = ("buckets", "count", "sum_ns", "min_ns", "max_ns")

    def __init__(self):
        self.buckets = [0] * _NBUCKETS
        self.count = 0
        self.sum_ns = 0
        self.min_ns = None
        self.max_ns = None

    @staticmethod
    def _bucket(v: int) -> int:
        if v < 8:
            return v if v > 0 else 0
        o = v.bit_length() - 1
        return (o - 3) * _SUB + (v >> (o - 3))

    @staticmethod
    def _bucket_bounds(idx: int) -> tuple[int, int]:
        """[lo, hi) value range of bucket ``idx``."""
        if idx < 8:
            return idx, idx + 1
        j = idx - 8
        o = j // _SUB + 3
        m = j % _SUB + 8
        lo = m << (o - 3)
        return lo, lo + (1 << (o - 3))

    def record(self, seconds: float, n: int = 1) -> None:
        """One latency sample of ``seconds``, weighted ``n`` (a batch
        wall attributed to each of its n ops records once with n)."""
        v = int(seconds * 1e9)
        if v < 0:
            v = 0
        self.buckets[self._bucket(v)] += n
        self.count += n
        self.sum_ns += v * n
        if self.min_ns is None or v < self.min_ns:
            self.min_ns = v
        if self.max_ns is None or v > self.max_ns:
            self.max_ns = v

    def merge(self, other: "LatencyTracker") -> "LatencyTracker":
        """Bucket-wise accumulate ``other`` into self (window merging)."""
        ob = other.buckets
        sb = self.buckets
        for i in range(_NBUCKETS):
            if ob[i]:
                sb[i] += ob[i]
        self.count += other.count
        self.sum_ns += other.sum_ns
        if other.min_ns is not None and (
                self.min_ns is None or other.min_ns < self.min_ns):
            self.min_ns = other.min_ns
        if other.max_ns is not None and (
                self.max_ns is None or other.max_ns > self.max_ns):
            self.max_ns = other.max_ns
        return self

    def percentile_ns(self, q: float) -> float:
        """Rank-interpolated q-th percentile (q in [0, 100]); 0.0 when
        empty.  Clamped into [min, max] so the bucket upper bound can
        never report a tail beyond the largest recorded value."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.buckets):
            if not c:
                continue
            if seen + c >= target:
                lo, hi = self._bucket_bounds(i)
                frac = (target - seen) / c
                est = lo + (hi - lo) * frac
                if self.min_ns is not None:
                    est = max(est, self.min_ns)
                if self.max_ns is not None:
                    est = min(est, self.max_ns)
                return est
            seen += c
        return float(self.max_ns or 0)

    def percentile_ms(self, q: float) -> float:
        return self.percentile_ns(q) / 1e6

    def snapshot(self) -> dict:
        c = self.count
        return {
            "count": c,
            "sum_ms": self.sum_ns / 1e6,
            "mean_ms": (self.sum_ns / c / 1e6) if c else None,
            "min_ms": (self.min_ns / 1e6) if c else None,
            "max_ms": (self.max_ns / 1e6) if c else None,
            "p50_ms": self.percentile_ms(50),
            "p99_ms": self.percentile_ms(99),
            "p999_ms": self.percentile_ms(99.9),
        }


class WindowedRate:
    """Sliding-window event rate over a granule ring.

    ``granules`` fixed-width time cells cover ``window_s``; ``add``
    lands counts in the current cell (lazily zeroing cells the clock
    skipped), ``rate`` sums live cells over the covered span.  O(1)
    memory, no timestamps per event; resolution is one granule.
    """

    def __init__(self, window_s: float = 10.0, granules: int = 20):
        assert window_s > 0 and granules > 0
        self.window_s = float(window_s)
        self.granules = int(granules)
        self._gw = self.window_s / self.granules
        self._counts = [0.0] * self.granules
        self._gids = [-1] * self.granules
        self._t0: float | None = None  # first add (startup partial window)

    def add(self, n: float, now: float) -> None:
        if self._t0 is None:
            self._t0 = now
        g = int(now / self._gw)
        i = g % self.granules
        if self._gids[i] != g:
            self._gids[i] = g
            self._counts[i] = 0.0
        self._counts[i] += n

    def total(self, now: float) -> float:
        """Events inside the window ending at ``now``."""
        g = int(now / self._gw)
        lo = g - self.granules + 1
        return sum(c for c, gid in zip(self._counts, self._gids)
                   if lo <= gid <= g)

    def rate(self, now: float) -> float:
        """Events/s over the window (partial-window aware at startup,
        so a 2-second-old tracker divides by 2 s, not the full window —
        even when 2 s is less than one granule; a long-window tracker
        queried right after a short burst must not dilute the rate by
        the granule width).  Only the degenerate zero-elapsed query
        falls back to a granule of cover."""
        if self._t0 is None:
            return 0.0
        covered = min(self.window_s, now - self._t0)
        if covered <= 0.0:
            covered = self._gw
        return self.total(now) / covered


class _ClassStats:
    """One op class's rolling state: two-generation latency trackers
    (merged view >= one full window), a windowed rate, and cumulative
    totals."""

    __slots__ = ("cur", "prev", "cur_start", "rate",
                 "ops_total", "batches_total", "wall_s_total")

    def __init__(self, window_s: float, now: float):
        self.cur = LatencyTracker()
        self.prev = LatencyTracker()
        self.cur_start = now
        self.rate = WindowedRate(window_s)
        self.ops_total = 0
        self.batches_total = 0
        self.wall_s_total = 0.0

    def rotate_if_due(self, window_s: float, now: float,
                      lock: threading.Lock) -> None:
        # Fast path is one float compare; the swap itself runs under the
        # tracker lock with a due re-check — an observe() racing a
        # scrape-thread window() at the boundary must rotate ONCE, not
        # twice (a double swap would shunt the just-filled tracker
        # straight through prev and publish a near-empty window).
        if now - self.cur_start >= window_s:
            with lock:
                if now - self.cur_start >= window_s:
                    self.prev = self.cur
                    self.cur = LatencyTracker()
                    self.cur_start = now

    def merged(self) -> LatencyTracker:
        m = LatencyTracker()
        m.merge(self.prev)
        m.merge(self.cur)
        return m


class SloTracker:
    """Per-op-class SLO accounting (see module docstring).

    ``observe(cls, ops, wall_s, batches=k)`` attributes a window of
    ``k`` batches totalling ``ops`` ops that took ``wall_s`` seconds:
    the per-batch wall (``wall_s / k``) is recorded as each op's
    completion latency (weight ``ops``), and ``ops`` land in the
    class's sliding rate.  ``observe_op`` records a single op's own
    latency (the open-loop latency bench's sample shape).
    """

    def __init__(self, window_s: float = 10.0, clock=time.monotonic):
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()   # class creation + rotation only
        self._classes: dict[str, _ClassStats] = {}

    def _stats(self, op_class: str, now: float) -> _ClassStats:
        st = self._classes.get(op_class)
        if st is None:
            with self._lock:
                st = self._classes.get(op_class)
                if st is None:
                    st = _ClassStats(self.window_s, now)
                    self._classes[op_class] = st
        return st

    def observe(self, op_class: str, ops: int, wall_s: float, *,
                batches: int = 1, now: float | None = None) -> None:
        if ops <= 0:
            return
        now = self._clock() if now is None else now
        st = self._stats(op_class, now)
        st.rotate_if_due(self.window_s, now, self._lock)
        st.cur.record(wall_s / max(1, batches), int(ops))
        st.rate.add(ops, now)
        st.ops_total += int(ops)
        st.batches_total += int(batches)
        st.wall_s_total += float(wall_s)

    def observe_op(self, op_class: str, latency_s: float, *,
                   now: float | None = None) -> None:
        self.observe(op_class, 1, latency_s, batches=1, now=now)

    def window(self, now: float | None = None) -> dict:
        """{class: {ops_s, p50_ms, p99_ms, p999_ms, window_ops,
        ops_total, batches_total}} for every observed class."""
        now = self._clock() if now is None else now
        out = {}
        for cls, st in list(self._classes.items()):
            st.rotate_if_due(self.window_s, now, self._lock)
            m = st.merged()
            out[cls] = {
                "ops_s": st.rate.rate(now),
                "p50_ms": m.percentile_ms(50),
                "p99_ms": m.percentile_ms(99),
                "p999_ms": m.percentile_ms(99.9),
                "window_ops": m.count,
                "ops_total": st.ops_total,
                "batches_total": st.batches_total,
            }
        return out

    def collect(self) -> dict:
        """Flat {"<class>.<stat>": number} view — the registry pull
        collector (every snapshot / Prometheus scrape carries it)."""
        flat = {}
        for cls, stats in self.window().items():
            for k, v in stats.items():
                flat[f"{cls}.{k}"] = round(float(v), 6)
        return flat

    def reset(self) -> None:
        with self._lock:
            self._classes.clear()


# -- process-wide default tracker ---------------------------------------------

_TRACKER = SloTracker(
    window_s=float(os.environ.get("SHERMAN_SLO_WINDOW_S", 10.0)))
_REGISTERED = [False]


def enabled() -> bool:
    """The default-tracker observers honor ``SHERMAN_SLO=0`` (the
    obs-on/off A/B knob); per-instance trackers are always live."""
    return os.environ.get("SHERMAN_SLO", "1") != "0"


def get_slo() -> SloTracker:
    """The default tracker, registered as the ``slo.`` pull collector
    on first access so snapshots and expositions carry it."""
    if not _REGISTERED[0]:
        from sherman_tpu_torch.obs import registry as _registry
        _registry.register_collector("slo", _TRACKER.collect)
        _REGISTERED[0] = True
    return _TRACKER


def observe(op_class: str, ops: int, wall_s: float, *,
            batches: int = 1) -> None:
    if enabled():
        get_slo().observe(op_class, ops, wall_s, batches=batches)


def observe_op(op_class: str, latency_s: float) -> None:
    if enabled():
        get_slo().observe_op(op_class, latency_s)


def slo_window() -> dict:
    """The default tracker's per-class window — the bench's ``slo``
    JSON section."""
    return get_slo().window()
