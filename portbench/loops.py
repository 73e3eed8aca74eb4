"""The closed loops that drive the entries, with the client's timing.

A batch's time runs from the call that sends it (``dispatch`` or
``mixed``) to its answers in host memory.  The list of ring slots sent is
the order the reference replays; the answers of the batches a
:class:`Keeper` picks are kept for the check after the window.

- :func:`read_loop`: two batches in flight, as the front door's
  dispatcher keeps them: batch k+1 is dispatched before batch k is
  completed.
- :func:`mixed_loop`: one ``mixed`` call at a time.

A :func:`mixed_loop` batch's refusals (updates acknowledged
``ST_LOCK_TIMEOUT``) are counted in every batch, after its time is
taken: ``ops_s`` counts the ops answered, and the reference replays a
batch whose answers were not kept without the refused updates.

Both stop sending once ``seconds`` have passed since the first send (a
warm-up: once ``max_batches`` are sent) and end with the last answer;
the window is that span.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from portbench.reference import kv


@dataclass
class Record:
    """What one loop sent and got back."""
    lat_s: list = field(default_factory=list)
    sent: list = field(default_factory=list)       # ring slots, in order
    kept: dict = field(default_factory=dict)   # position in sent -> answers
    refused: dict = field(default_factory=dict)  # position -> op indices
    n_refused: int = 0
    t0: float = 0.0
    t1: float = 0.0
    ops: int = 0
    error: str | None = None    # the program's exception, if it raised

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def keep_all(pos: int, out):
    """Keep every batch's answers as they are (the warm-up's few)."""
    return out


class Keeper:
    """Which window batches' answers the check keeps: each with
    probability ``share``, drawn from the seed, up to ``cap`` of them.
    A kept batch's answers are copied, after its time is taken, into
    buffers made and touched in set-up: answers kept where the program
    allocated them would hold its freed pages, and every later batch
    would pay the page faults of fresh memory (measured: 10-15% of a
    read batch, and most of the spread between runs)."""

    def __init__(self, rng, share: float, cap: int, width: int,
                 dtypes):
        self.pick = rng.random(1 << 20) < share
        self.cap = cap
        self.bufs = [np.zeros((cap, width), dt) for dt in dtypes]
        for b in self.bufs:
            b.fill(1)           # touch every page now
        self.n = 0
        self.full = 0           # picked but past the cap

    def __call__(self, pos: int, out):
        if not self.pick[pos % self.pick.shape[0]]:
            return None
        if self.n == self.cap:
            self.full += 1
            return None
        k = out[0].shape[0]
        kept = []
        for buf, a in zip(self.bufs, out):
            buf[self.n, :k] = a
            kept.append(buf[self.n, :k])
        self.n += 1
        return tuple(kept)


def _more(n_sent: int, elapsed: float, seconds: float,
          max_batches: int | None) -> bool:
    """Send another batch?  A warm-up sends ``max_batches``; a window
    sends until ``seconds`` have passed (at least one batch)."""
    if max_batches is not None:
        return n_sent < max_batches
    return n_sent == 0 or elapsed < seconds


def _guarded(loop):
    """Run ``loop``; where the program raises, keep its traceback in the
    record (the run is then not correct) and stop sending."""
    def run(system, ring, start, seconds, **kw):
        rec = Record()
        try:
            loop(rec, system, ring, start, seconds, **kw)
        except Exception:  # the program under test failed: report it
            rec.error = traceback.format_exc()
        return rec
    run.__doc__ = loop.__doc__
    return run


@_guarded
def read_loop(rec, system, ring, start: int, seconds: float, *,
              tracer, max_batches: int | None = None,
              keep=keep_all) -> None:
    span, tick, count = tracer.span, tracer.tick, tracer.count
    R = len(ring)
    i = start
    rec.t0 = t_send = time.perf_counter()
    with span("dispatch"):
        pending = (ring[i % R], t_send, system.dispatch(ring[i % R]))
    count(ring[i % R].slot)
    while pending is not None:
        b, t_b, h = pending
        pending = None
        now = time.perf_counter()
        tick(now - rec.t0, system.sync)
        if _more(i + 1 - start, now - rec.t0, seconds, max_batches):
            i += 1
            nb = ring[i % R]
            with span("dispatch"):
                pending = (nb, now, system.dispatch(nb))
            count(nb.slot)
        with span("complete"):
            vals, found = system.complete(h)
        t_done = time.perf_counter()
        rec.lat_s.append(t_done - t_b)
        kept = keep(len(rec.sent), (vals, found))
        if kept is not None:
            rec.kept[len(rec.sent)] = kept
        rec.sent.append(b.slot)
        rec.ops += b.n
        rec.t1 = t_done


@_guarded
def mixed_loop(rec, system, ring, start: int, seconds: float, *,
               tracer, max_batches: int | None = None,
               keep=keep_all) -> None:
    span, tick, count = tracer.span, tracer.tick, tracer.count
    R = len(ring)
    i = start
    rec.t0 = t = time.perf_counter()
    while _more(i - start, t - rec.t0, seconds, max_batches):
        b = ring[i % R]
        count(b.slot)
        with span("mixed"):
            out = system.mixed(b)
        t_done = time.perf_counter()
        rec.lat_s.append(t_done - t)
        no = np.flatnonzero(out[2] == kv.ST_LOCK_TIMEOUT)
        if no.size:
            rec.refused[len(rec.sent)] = no
            rec.n_refused += int(no.size)
        kept = keep(len(rec.sent), out)
        if kept is not None:
            rec.kept[len(rec.sent)] = kept
        rec.sent.append(b.slot)
        rec.ops += b.n
        rec.t1 = t_done
        i += 1
        tick(t_done - rec.t0, system.sync)
        t = time.perf_counter()


LOOPS = {"read": read_loop, "mixed": mixed_loop}
