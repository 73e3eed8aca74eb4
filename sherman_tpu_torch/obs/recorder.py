"""Black-box flight recorder: a bounded ring of structured events
(the port's copy of ``sherman_tpu/obs/recorder.py``).

A chaos or recovery drill that goes wrong leaves scattered counters
behind — totals with no order.  This module keeps the ORDER: a bounded
ring buffer of recent structured events (span closes, chaos
injections, lease revocations, degraded-mode transitions, journal
fsync poisonings, recovery/repair steps), cheap enough to stay on
permanently (one deque append under a lock, at control-plane moments —
never per op), and dumped as a readable bundle when something breaks.

Event sources (each site calls :func:`record_event`):

- ``span``                      every default-tracer span close
  (completion is per *phase*, not per request — the tracer's own
  contract keeps this off the hot path)
- ``chaos.inject``              each fired fault (kind/step/addr)
- ``lease.revoked``             a dead holder's lock revoked
- ``scrub.violation`` / ``scrub.quarantine``
- ``engine.degraded_enter`` / ``engine.degraded_exit`` /
  ``engine.typed_error``
- ``journal.poisoned`` / ``journal.torn_tail``
- ``checkpoint.save`` / ``checkpoint.restore``
- ``recovery.checkpoint_base`` / ``recovery.checkpoint_delta`` /
  ``recovery.recover`` / ``recovery.targeted_repair`` /
  ``recovery.targeted_repair_failed``
- ``compile.retrace``           a new call signature of a ledgered
  program inside a sealed window (``obs/device.py``)
- ``serve.start`` / ``serve.sealed`` / ``serve.width_change`` /
  ``serve.brownout_enter`` / ``serve.brownout_exit`` /
  ``serve.dispatch_error`` / ``serve.heap_warm_skipped`` /
  ``serve.stop`` / ``serve.drain``   (the serving front door's
  control-plane moments — ``serve.py``)
- ``audit.violation`` / ``audit.checker_error``   (the client-contract
  linearizability auditor — ``audit.py``; a violation also auto-dumps
  the black box)

- ``chaos.repl_inject`` / ``chaos.repl_heal``   (the replication fault
  layer — ``chaos.py``)
- ``repl.promote`` / ``repl.fenced`` / ``repl.tail_torn_wait`` /
  ``repl.tail_slow`` / ``repl.tail_stalled`` / ``repl.rebootstrap`` /
  ``repl.quorum_timeout`` / ``repl.quarantine`` / ``repl.repair`` /
  ``repl.tail_error`` / ``repl.anti_entropy_error``   (the replication
  plane — ``replica.py``)

- ``host.lease_expired`` / ``host.adopt_begin`` / ``host.adopt_done`` /
  ``host.zombie_fenced`` / ``host.handback``, ``chaos.host_inject`` /
  ``chaos.host_heal`` and ``recovery.recover_union``   (host failover and
  the multihost service plane — ``hostlease.py``, ``chaos.py``,
  ``recovery.py``)

``watchdog.fired`` comes with the process failure detector
(``utils/failure.py``, ROADMAP.md item 7c-iv).

Auto-dump: :func:`auto_dump` fires on degraded entry, typed-error
raise, a sealed-window retrace and watchdog expiry — but only when ``SHERMAN_BLACKBOX_DIR``
names a directory (tests and libraries must not spray files), and
debounced to one dump per ``min_dump_interval_s`` unless forced (the
watchdog forces: it is about to kill the process).  A dump is a
two-file bundle:

- ``blackbox-<stamp>-<reason>.json`` — Perfetto-loadable Chrome trace
  (the default tracer's events) with the event ring, the full metrics
  snapshot and the span summary riding in ``otherData``;
- ``blackbox-<stamp>-<reason>.events.jsonl`` — the event ring alone,
  one JSON object per line (grep-able postmortem order).
"""

from __future__ import annotations

import json
import os
import threading
import time

from sherman_tpu_torch.obs import registry as _registry
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.obs import spans as _spans

__all__ = ["FlightRecorder", "get_recorder", "record_event", "auto_dump",
           "BLACKBOX_ENV"]

BLACKBOX_ENV = "SHERMAN_BLACKBOX_DIR"


class FlightRecorder:
    """Bounded, thread-safe ring of (seq, t, kind, fields) events."""

    def __init__(self, capacity: int = 4096,
                 min_dump_interval_s: float = 5.0):
        from collections import deque
        self.capacity = int(capacity)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self._lock = threading.Lock()
        self._ring = deque(maxlen=self.capacity)
        self._seq = 0
        self._dumps = 0
        self._last_dump = -1e18
        self.dropped = 0  # events evicted by the ring bound

    def record(self, kind: str, **fields) -> int:
        """Append one event; returns its sequence number (global order
        even across ring eviction)."""
        t = time.time()
        with self._lock:
            self._seq += 1
            seq = self._seq
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append((seq, t, kind, fields or None))
        return seq

    def events(self) -> list[dict]:
        with self._lock:
            ring = list(self._ring)
        return [{"seq": seq, "t": t, "kind": kind,
                 **({"fields": fields} if fields else {})}
                for seq, t, kind, fields in ring]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    # -- dumping --------------------------------------------------------------

    def dump(self, reason: str, directory: str | None = None) -> str:
        """Write the bundle (see module docstring); returns the path of
        the ``.json`` trace file.  ``directory`` defaults to
        ``$SHERMAN_BLACKBOX_DIR`` and must resolve to something."""
        directory = directory or os.environ.get(BLACKBOX_ENV)
        if not directory:
            raise ConfigError(
                f"flight-recorder dump needs a directory ({BLACKBOX_ENV} "
                "unset and none passed)")
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self._dumps += 1
            n = self._dumps
            self._last_dump = time.monotonic()
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48]
        stamp = time.strftime("%Y%m%d-%H%M%S")
        stem = os.path.join(directory, f"blackbox-{stamp}-{n:03d}-{safe}")
        events = self.events()
        tracer = _spans.get_tracer()
        doc = tracer.chrome_trace()
        doc["otherData"].update({
            "reason": reason,
            "wall_time": time.time(),
            "flight_events": events,
            "flight_dropped": self.dropped,
            "metrics": _registry.snapshot(),
            "span_summary": tracer.summary(),
        })
        with open(stem + ".json", "w") as f:
            json.dump(doc, f)
        with open(stem + ".events.jsonl", "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return stem + ".json"

    def auto_dump(self, trigger: str, *, force: bool = False) -> str | None:
        """Env-gated, debounced dump — the degraded-entry / typed-error
        / watchdog hook.  None when the env knob is unset or the
        debounce window has not elapsed (a degraded engine raising
        DegradedError per rejected write must not dump per raise)."""
        directory = os.environ.get(BLACKBOX_ENV)
        if not directory:
            return None
        if not force:
            with self._lock:
                if (time.monotonic() - self._last_dump
                        < self.min_dump_interval_s):
                    return None
        try:
            return self.dump(trigger, directory)
        except OSError:
            return None  # a full/readonly disk must not take serving down


# -- process-wide default recorder --------------------------------------------

_RECORDER = FlightRecorder(
    capacity=int(os.environ.get("SHERMAN_BLACKBOX_EVENTS", 4096)))


def get_recorder() -> FlightRecorder:
    return _RECORDER


def record_event(kind: str, **fields) -> int:
    return _RECORDER.record(kind, **fields)


def auto_dump(trigger: str, *, force: bool = False) -> str | None:
    return _RECORDER.auto_dump(trigger, force=force)


def _span_close(name: str, dur_s: float, depth: int) -> None:
    _RECORDER.record("span", name=name, dur_ms=round(dur_s * 1e3, 3),
                     depth=depth)


# subscribe the default recorder to the default tracer's span closes
# (per-phase, not per-op — see the SpanTracer docstring)
_spans.get_tracer().on_close = _span_close
