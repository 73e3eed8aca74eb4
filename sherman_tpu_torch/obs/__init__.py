"""sherman_tpu_torch.obs — the port's observability plane (counterpart of
``sherman_tpu/obs``).

One instrumentation surface every layer of the port reports through:

- :mod:`~sherman_tpu_torch.obs.registry` — process-wide metrics registry
  (counters, gauges, histograms) with snapshot/delta semantics, so
  drivers and tests can diff op counts around a region.  Hot-path
  increments are a plain attribute add: no locks, no dict lookups.
- :mod:`~sherman_tpu_torch.obs.spans` — nested span tracing, thread-safe,
  with Chrome-trace-event JSON export (``chrome://tracing`` / Perfetto),
  the :class:`StepTrace` micro-tracer, and :func:`device_trace`, a
  ``torch.profiler`` capture of the card's kernels.
- :mod:`~sherman_tpu_torch.obs.slo` — per-op-class (read / insert /
  delete / mixed / scan) amortized latency with sliding-window ops/s and
  p50/p99/p999, fed by every engine batch wall and by the staged step
  factories' ``record_slo``; the ``slo.*`` pull collector.
  ``SHERMAN_SLO=0`` turns the default observers off.
- :mod:`~sherman_tpu_torch.obs.recorder` — the black-box flight
  recorder: a bounded ring of structured events (chaos injections, lease
  revocations, degraded transitions, journal poisonings, recovery and
  repair steps, retraces, span closes), dumped as a bundle (Chrome trace
  + events JSONL) into ``SHERMAN_BLACKBOX_DIR`` on degraded entry, a
  typed-error raise or a sealed-window retrace.
- :mod:`~sherman_tpu_torch.obs.device` — the torch form of the
  device-telemetry plane: a ledger of kernel builds and of each wrapped
  program's first call per signature, with the post-seal retrace
  detector; the memory accountant (weakref-bound pool/journal/checkpoint
  byte sources, and the CUDA allocator's bytes); roofline receipts.
  The ``device.`` pull collector; ``SHERMAN_DEVICE_OBS=0`` kills it.
- :mod:`~sherman_tpu_torch.obs.export` — JSONL snapshots, :func:`dump`,
  :func:`obs_section` for the drivers' JSON lines, Prometheus text
  exposition (textfile and an HTTP ``/metrics`` endpoint behind
  ``SHERMAN_METRICS_PORT``).

Wired-in sources: the DSM's device op counters (``dsm.*``, pulled) and
host steps, the kernels' launch counts and rows (``kernels.*``, pulled)
and the exchange's bytes, the engine's spans, SLO attribution, degraded
mode and ``combine.*``, the host tree's lease and descent counters, the
scrubber, the chaos plan, the journal, the checkpoints and the recovery
plane.
"""

from __future__ import annotations

from sherman_tpu_torch.obs.device import (CompileLedger, MemoryAccountant,
                                          device_peaks, get_accountant,
                                          get_ledger, program_cost,
                                          program_memory, roofline,
                                          rooflines, wrap_program)
from sherman_tpu_torch.obs.export import (MetricsServer, PeriodicExporter,
                                          dump, maybe_serve_http,
                                          obs_section, prometheus_text,
                                          write_prometheus,
                                          write_snapshot_jsonl)
from sherman_tpu_torch.obs.recorder import (FlightRecorder, auto_dump,
                                            get_recorder, record_event)
from sherman_tpu_torch.obs.registry import (Counter, Gauge, Histogram,
                                            MetricsRegistry, counter, delta,
                                            gauge, get_registry, histogram,
                                            register_collector, snapshot)
from sherman_tpu_torch.obs.slo import (LatencyTracker, SloTracker,
                                       WindowedRate, get_slo, observe,
                                       observe_op, slo_window)
from sherman_tpu_torch.obs.spans import (SpanTracer, StepTrace,
                                         device_trace, get_tracer, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "snapshot", "delta",
    "register_collector", "get_registry",
    "SpanTracer", "StepTrace", "device_trace", "get_tracer", "span",
    "dump", "obs_section", "write_snapshot_jsonl", "PeriodicExporter",
    "prometheus_text", "write_prometheus", "MetricsServer",
    "maybe_serve_http",
    "LatencyTracker", "WindowedRate", "SloTracker",
    "get_slo", "observe", "observe_op", "slo_window",
    "FlightRecorder", "get_recorder", "record_event", "auto_dump",
    "CompileLedger", "MemoryAccountant", "get_ledger", "get_accountant",
    "wrap_program", "program_cost", "program_memory", "roofline",
    "rooflines", "device_peaks",
]
