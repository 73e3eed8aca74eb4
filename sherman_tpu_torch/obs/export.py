"""Exporters: JSON dumps, periodic snapshots, Prometheus exposition (the
port's copy of ``sherman_tpu/obs/export.py``).

The port's drivers (``bench``, ``ycsb_bench``, ``ckpt_bench``) report
through here instead of hand-formatting their own strings:

- :func:`obs_section` — the dict a driver embeds in its JSON output
  (``{"counters": ..., "spans": ...}``), built from the default
  registry + tracer.
- :func:`dump` — write a full observability dump (metrics snapshot +
  span summary + Chrome trace events) to one JSON file.
- :func:`write_snapshot_jsonl` / :class:`PeriodicExporter` — append
  timestamped registry snapshots to a JSONL file, manually or on a
  background interval.  ``PeriodicExporter(..., fmt="prom")`` instead
  rewrites a Prometheus textfile each tick — the node-exporter
  textfile-collector deployment shape.
- :func:`prometheus_text` / :func:`write_prometheus` — Prometheus
  text-format exposition (0.0.4): counters as ``_total``, gauges as
  gauges, histograms as summaries with p50/p99/p999 quantiles, pull
  collectors (``dsm.*``, ``slo.*``) as untyped gauges.
  :func:`write_prometheus` is atomic (tmp + rename) per the textfile
  collector's contract.
- :class:`MetricsServer` / :func:`maybe_serve_http` — an optional
  stdlib HTTP scrape endpoint (``/metrics``), armed by
  ``SHERMAN_METRICS_PORT`` (0/unset = off); daemon thread, no
  dependencies — metrics leave the process without parsing bench JSON.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from sherman_tpu_torch.obs import registry as _registry
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.obs import spans as _spans

__all__ = ["dump", "obs_section", "write_snapshot_jsonl",
           "PeriodicExporter", "prometheus_text", "write_prometheus",
           "MetricsServer", "maybe_serve_http", "METRICS_PORT_ENV"]

METRICS_PORT_ENV = "SHERMAN_METRICS_PORT"


def obs_section(reg=None, tracer=None) -> dict:
    """The ``obs`` dict drivers embed in their JSON output."""
    reg = reg if reg is not None else _registry.get_registry()
    tracer = tracer if tracer is not None else _spans.get_tracer()
    return {"counters": reg.snapshot(), "spans": tracer.summary()}


def dump(path: str, reg=None, tracer=None, *, extra: dict | None = None
         ) -> str:
    """Write metrics + spans + Chrome trace events to ``path`` (JSON).

    The file doubles as a Perfetto-loadable trace: ``traceEvents`` is
    top-level per the Chrome trace-event spec, with the metrics
    snapshot riding in ``otherData``.  Returns the path."""
    reg = reg if reg is not None else _registry.get_registry()
    tracer = tracer if tracer is not None else _spans.get_tracer()
    doc = tracer.chrome_trace()
    doc["otherData"].update({
        "metrics": reg.snapshot(),
        "span_summary": tracer.summary(),
        "wall_time": time.time(),
        **(extra or {}),
    })
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_snapshot_jsonl(path: str, reg=None, *,
                         extra: dict | None = None) -> None:
    """Append one timestamped registry snapshot as a JSONL line."""
    reg = reg if reg is not None else _registry.get_registry()
    line = {"t": time.time(), "metrics": reg.snapshot(), **(extra or {})}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(line) + "\n")


class PeriodicExporter:
    """Background-thread periodic exporter: JSONL append (default) or
    Prometheus textfile rewrite (``fmt="prom"``).

    >>> ex = PeriodicExporter("obs.jsonl", interval_s=10.0)
    >>> ex.start()
    ...
    >>> ex.stop()   # writes one final snapshot

    Snapshots invoke registry collectors (which may touch device
    arrays); drivers whose collectors are not safe mid-step should
    snapshot manually at step boundaries instead.
    """

    def __init__(self, path: str, interval_s: float = 10.0, reg=None,
                 fmt: str = "jsonl"):
        assert fmt in ("jsonl", "prom"), fmt
        self.path = path
        self.interval_s = interval_s
        self.reg = reg if reg is not None else _registry.get_registry()
        self.fmt = fmt
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _write(self, extra=None) -> None:
        if self.fmt == "prom":
            write_prometheus(self.path, self.reg)
        else:
            write_snapshot_jsonl(self.path, self.reg, extra=extra)

    def start(self) -> "PeriodicExporter":
        assert self._thread is None, "already started"
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-exporter")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self._write(extra={"final": True})

    def __enter__(self) -> "PeriodicExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- Prometheus exposition ----------------------------------------------------

def _prom_name(name: str, prefix: str = "sherman") -> str:
    return f"{prefix}_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_num(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if not f.is_integer() else str(int(f))


def prometheus_text(reg=None, prefix: str = "sherman") -> str:
    """Render the registry as Prometheus text exposition (0.0.4).

    Counters end in ``_total``, gauges are gauges, histograms render as
    summaries (``quantile`` labels for p50/p99/p999 + ``_sum``/
    ``_count``), and pull-collector values (``dsm.*``, ``slo.*`` — flat
    numbers whose kind the collector erased) render as untyped gauges.
    Dots in metric names become underscores under the ``sherman_``
    namespace (``dsm.read_ops`` -> ``sherman_dsm_read_ops_total`` for
    typed counters, ``sherman_dsm_read_ops`` for collector values).
    """
    reg = reg if reg is not None else _registry.get_registry()
    lines: list[str] = []
    typed_names = set()
    for m in reg.metrics():
        typed_names.add(m.name)
        p = _prom_name(m.name, prefix)
        if isinstance(m, _registry.Counter):
            lines.append(f"# TYPE {p}_total counter")
            lines.append(f"{p}_total {_prom_num(m.value)}")
        elif isinstance(m, _registry.Gauge):
            lines.append(f"# TYPE {p} gauge")
            lines.append(f"{p} {_prom_num(m.value)}")
        else:  # Histogram -> summary
            lines.append(f"# TYPE {p} summary")
            for q, pct in (("0.5", 50), ("0.99", 99), ("0.999", 99.9)):
                lines.append(
                    f'{p}{{quantile="{q}"}} '
                    f"{_prom_num(m.percentile(pct))}")
            lines.append(f"{p}_sum {_prom_num(m.sum)}")
            lines.append(f"{p}_count {_prom_num(m.count)}")
    # collector-sourced flat values (snapshot keys beyond the typed set)
    for k, v in sorted(reg.snapshot().items()):
        if k in typed_names or k.startswith("_") \
                or not isinstance(v, (int, float)) \
                or isinstance(v, bool):
            continue
        p = _prom_name(k, prefix)
        lines.append(f"# TYPE {p} gauge")
        lines.append(f"{p} {_prom_num(v)}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, reg=None, prefix: str = "sherman") -> str:
    """Atomic Prometheus textfile write (tmp + rename): the
    node-exporter textfile collector must never read a torn file."""
    text = prometheus_text(reg, prefix)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


class MetricsServer:
    """Stdlib HTTP scrape endpoint: ``GET /metrics`` serves
    :func:`prometheus_text`; anything else 404s.  Daemon-threaded,
    binds once on :meth:`start` (``port=0`` picks a free port — the
    bound one is in ``.port``)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", reg=None,
                 prefix: str = "sherman"):
        self.host = host
        self.port = int(port)
        self.reg = reg if reg is not None else _registry.get_registry()
        self.prefix = prefix
        self._httpd = None
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsServer":
        assert self._httpd is None, "already started"
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = prometheus_text(server.reg,
                                           server.prefix).encode()
                except Exception as e:  # a raising collector mid-step
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="obs-metrics")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def maybe_serve_http(env: str = METRICS_PORT_ENV,
                     reg=None) -> "MetricsServer | None":
    """Env-gated scrape endpoint: start a :class:`MetricsServer` when
    ``env`` holds a positive port, else None.  A malformed value raises
    (a typo on an exposition knob should be loud, not silently dark)."""
    raw = os.environ.get(env, "").strip()
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        raise ConfigError(
            f"{env}={raw!r} is not a port number; set e.g. 9095, or "
            "unset it to disable the scrape endpoint") from None
    if port <= 0:
        return None
    return MetricsServer(port=port, reg=reg).start()
