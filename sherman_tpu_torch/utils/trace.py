"""Back-compat shim over :mod:`sherman_tpu_torch.obs.spans` (counterpart of
``sherman_tpu/utils/trace.py``): :class:`StepTrace` (the flat per-phase
micro-tracer), :class:`SpanTracer` and :func:`device_trace` (the
``torch.profiler`` capture) live in ``obs.spans``; importing them from
here keeps working for drivers written against the reference's path.
"""

from __future__ import annotations

from sherman_tpu_torch.obs.spans import SpanTracer, StepTrace, device_trace

__all__ = ["StepTrace", "SpanTracer", "device_trace"]
