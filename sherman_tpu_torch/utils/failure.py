"""Failure detection and fail-fast guards: the port's copy of
``sherman_tpu/utils/failure.py``.

A cluster of several processes ("ranks", :func:`sherman_tpu_torch.
parallel.bootstrap.init_multihost`) has two failure classes, and a
detector for each:

  peer DEATH   (process gone) — the heartbeat monitor.  Each rank's daemon
               thread advances its own counter in the process group's
               store every ``timeout / 4``; a peer whose counter stands
               still for ``SHERMAN_HEARTBEAT_S`` makes the survivor print
               a diagnostic naming it and exit (code
               :data:`HEARTBEAT_EXIT`) instead of hanging in its next
               collective.  Termination, not an exception: a rank blocked
               inside a collective cannot be interrupted from Python.
               This stands in for the coordination service's heartbeats
               of the reference, which ``torch.distributed`` lacks.
  peer STALL   (alive, heartbeats fine, but stuck) —
               ``DistributedKeeper.barrier(name, timeout_s=...)``, a
               store barrier with a deadline that raises a catchable
               :class:`PeerFailure` naming the ranks that never arrived.
  fail fast    :class:`Watchdog` — a host-side deadline around a blocking
               section (a device-step sync, the collective checkpoint);
               on expiry it dumps diagnostics and exits (code 86).
  PREEMPTION   :class:`PreemptionGuard` — a SIGTERM latched on any rank
               flips ``should_act(step)`` on EVERY rank at the same step
               (one all-reduce of the latch a step), so the cluster
               checkpoints collectively at a clean boundary.
  recover      relaunch + ``utils.checkpoint.restore``: the collective
               checkpoint is atomic, nonce-tagged and epoch-checked.

Detection and fail-fast are control-plane mechanisms: device steps queued
on a card either complete or die with their process.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time

from sherman_tpu_torch.errors import ConfigError, ShermanError

#: exit status of a survivor the heartbeat monitor ends
HEARTBEAT_EXIT = 88


class PeerFailure(ShermanError, RuntimeError):
    """A guarded collective's deadline expired because peers never arrived
    (dead OR stalled — the deadline cannot tell; a dead peer makes the
    heartbeat monitor end this process shortly anyway, so a *caught*
    PeerFailure in practice means a stall).

    ``missing`` holds the ranks that never arrived; ``attempt`` is the
    barrier attempt that timed out (see :func:`barrier_guarded`)."""

    def __init__(self, msg: str, missing=(), attempt: int = -1):
        super().__init__(msg)
        self.missing = sorted(int(p) for p in missing)
        self.attempt = attempt


def coordination_client():
    """The process group's key-value store (prefixed for this module), or
    None outside a multi-process group (a single process has nothing to
    probe)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return None
    global _client
    if _client is None or _client[0] is not dist.group.WORLD:
        store = dist.distributed_c10d._get_default_store()
        _client = (dist.group.WORLD, dist.PrefixStore("sherman", store))
    return _client[1]


_client = None


# ---------------------------------------------------------------------------
# The heartbeat monitor (peer death).
# ---------------------------------------------------------------------------

class _Heartbeat:
    """One daemon thread: advance this rank's counter, watch the peers'."""

    def __init__(self, store, rank: int, world: int, timeout_s: float):
        self.store, self.rank, self.world = store, rank, world
        self.timeout_s = float(timeout_s)
        self.period_s = max(0.05, self.timeout_s / 4)
        now = time.monotonic()
        self._last = {p: (-1, now) for p in range(world) if p != rank}
        self._stop = threading.Event()
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sherman-heartbeat")
        self._thread.start()

    def beat(self) -> None:
        self.store.add(f"hb:{self.rank}", 1)

    def stale(self) -> list[int]:
        """Peers whose heartbeat has stood still for the whole timeout."""
        now = time.monotonic()
        return sorted(p for p, (_, t) in self._last.items()
                      if now - t >= self.timeout_s)

    def _poll(self) -> None:
        now = time.monotonic()
        for p, (v, t) in list(self._last.items()):
            cur = self.store.add(f"hb:{p}", 0)
            if cur != v:
                self._last[p] = (cur, now)

    def _run(self) -> None:
        unreachable_since = None
        while not self._stop.wait(self.period_s):
            try:
                self.beat()
                self._poll()
                unreachable_since = None
            except Exception as e:  # the store's host (rank 0) is gone
                now = time.monotonic()
                unreachable_since = unreachable_since or now
                if now - unreachable_since >= self.timeout_s:
                    self._die([0], f"store unreachable: {e!r}")
                continue
            dead = self.stale()
            if dead:
                self._die(dead, "no heartbeat")

    def _die(self, dead: list[int], why: str) -> None:
        msg = (f"[sherman heartbeat] rank {self.rank}: peer process(es) "
               f"{dead} stopped heartbeating for {self.timeout_s:g}s "
               f"({why}): another task died; terminating this process "
               "instead of hanging in its next collective")
        try:
            from sherman_tpu_torch.obs import recorder as _fr
            _fr.record_event("heartbeat.peer_dead", peers=dead,
                             timeout_s=self.timeout_s)
            _fr.auto_dump("heartbeat", force=True)
        except Exception:
            pass  # the exit must never be blocked by obs
        print(msg, file=sys.stderr, flush=True)
        print(msg, flush=True)
        os._exit(HEARTBEAT_EXIT)

    def stop(self) -> None:
        self._stop.set()


_monitor: _Heartbeat | None = None


def start_heartbeat(timeout_s: float) -> _Heartbeat | None:
    """Start this rank's heartbeat monitor (once a process); None outside
    a multi-process group."""
    global _monitor
    client = coordination_client()
    if client is None:
        return None
    if _monitor is None:
        import torch.distributed as dist
        _monitor = _Heartbeat(client, dist.get_rank(),
                              dist.get_world_size(), timeout_s)
    return _monitor


def heartbeat_monitor() -> _Heartbeat | None:
    return _monitor


_rollcalls = 0


def live_processes(num_processes: int, client=None) -> list[int]:
    """Collective liveness roll call: the ranks that answer it while their
    heartbeat is fresh.

    COLLECTIVE semantics, as the reference's: every live rank calls this
    together (replicated control flow, e.g. a periodic health check
    between engine steps).  A rank waits for every peer until it answers
    or its heartbeat goes stale; do not use it to diagnose a peer that
    may be stalled (:attr:`PeerFailure.missing` already names those).
    Returns every index outside a process group (a single process is
    trivially live)."""
    global _rollcalls
    if client is None:
        client = coordination_client()
    if client is None:
        return list(range(num_processes))
    import torch.distributed as dist
    rank = dist.get_rank()
    seq = _rollcalls
    _rollcalls += 1
    client.add(f"roll:{seq}:{rank}", 1)
    while True:
        here = [p for p in range(num_processes)
                if client.add(f"roll:{seq}:{p}", 0) > 0]
        stale = set(_monitor.stale()) if _monitor is not None else set()
        if all(p in here or p in stale for p in range(num_processes)):
            return sorted(p for p in here if p not in stale)
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# The guarded barrier (peer stall).
# ---------------------------------------------------------------------------

def _read_burn_marker(client, key: str) -> int:
    """Last burned attempt of a barrier name, -1 when none exists."""
    if not client.check([key]):
        return -1
    return int(client.get(key))


def barrier_guarded(name: str, timeout_s: float, *,
                    attempt: int, client=None) -> int:
    """Store-level named barrier with a deadline (the memcached
    fetch-add-and-spin barrier of ``DSMKeeper.cpp:148-161``, with the spin
    bounded).  Returns the attempt number used.

    A barrier instance (id) is burned once its deadline fires, so each use
    needs a fresh id.  ``attempt`` is the caller's local use count for
    this name; under replicated control flow every rank passes the same
    count.  After a timeout the counts no longer line up (the survivor
    advanced, the stalled peer did not), so the timeout publishes the
    burned attempt in the store and every caller fast-forwards past it on
    entry, and a waiter whose id is burned under it realigns: a
    survivor's RETRY and a recovered peer's late first call meet on one
    fresh id.

    Each id resolves exactly once, by compare-and-set on its state key:
    the waiter that sees every rank arrived marks it ``done``, a waiter
    whose deadline passed marks it ``burned``; every waiter follows the
    state that won.  Raises :class:`PeerFailure` (carrying the attempt and
    the ranks that never arrived) on deadline expiry.  Control-plane only:
    it does not flush the card."""
    if client is None:
        client = coordination_client()
    if client is None:
        return attempt  # single process: arrival == completion
    import torch.distributed as dist
    ws, rank = dist.get_world_size(), dist.get_rank()
    burn_key = f"barrier-burned:{name}"
    t0 = time.monotonic()
    deadline = t0 + float(timeout_s)
    eff = max(attempt, _read_burn_marker(client, burn_key) + 1)
    while True:
        bid = f"barrier:{name}:{eff}"
        client.add(f"{bid}:arrived:{rank}", 1)
        client.add(f"{bid}:count", 1)
        state = ""
        while True:
            if client.add(f"{bid}:count", 0) >= ws:
                state = client.compare_set(f"{bid}:state", "",
                                           "done").decode()
            elif client.check([f"{bid}:state"]):
                state = client.get(f"{bid}:state").decode()
            elif time.monotonic() >= deadline:
                state = client.compare_set(f"{bid}:state", "",
                                           f"burned:{rank}").decode()
            if state:
                break
            time.sleep(0.005)
        if state == "done":
            return eff
        if state != f"burned:{rank}":
            # a peer burned this id under us: realign on the next one
            eff = max(eff + 1, _read_burn_marker(client, burn_key) + 1)
            continue
        # this rank burned it: publish the marker, name the absent ranks
        cur = _read_burn_marker(client, burn_key)
        if eff > cur:
            client.set(burn_key, str(eff))
        missing = [p for p in range(ws)
                   if client.add(f"{bid}:arrived:{p}", 0) == 0]
        waited = time.monotonic() - t0
        raise PeerFailure(
            f"barrier '{name}' timed out after {waited:.1f}s (deadline "
            f"{timeout_s:g}s, attempt {eff}); never arrived: "
            f"{missing or 'unknown'}", missing=missing, attempt=eff)


# ---------------------------------------------------------------------------
# Fail fast: the watchdog.
# ---------------------------------------------------------------------------

class Watchdog:
    """Deadline for a blocking host section — fail fast instead of hang.

    Usage::

        with Watchdog(120, what="collective checkpoint",
                      diagnostics=lambda: dsm.counter_snapshot()):
            ck.checkpoint(cluster, path)

    If the body does not finish within ``timeout_s`` the watchdog thread
    fires: it records a ``watchdog.fired`` flight event (and a forced
    black-box dump), prints ``what`` + the diagnostics callback's result
    to stderr and invokes ``action`` — by default ``os._exit(86)``,
    because a Python thread cannot interrupt a blocking collective; the
    launcher restarts the process (recovery = restore the last
    checkpoint).  Pass ``action`` to override (tests record instead).

    ``timeout_s <= 0`` disarms entirely, which is what :meth:`maybe`
    returns when its env knob is unset.
    """

    EXIT_CODE = 86  # distinct, grep-able "watchdog fired" status
    DIAG_DEADLINE_S = 5.0

    def __init__(self, timeout_s: float, what: str = "blocking section",
                 action=None, diagnostics=None):
        self.timeout_s = float(timeout_s)
        self.what = what
        self.action = action
        self.diagnostics = diagnostics
        self.fired = False
        self._timer: threading.Timer | None = None

    @classmethod
    def maybe(cls, env: str = "SHERMAN_COLLECTIVE_TIMEOUT_S",
              what: str = "blocking section", diagnostics=None) -> "Watchdog":
        """Env-gated watchdog: armed only when ``env`` is set to a positive
        number of seconds.  A malformed value raises
        :class:`ConfigError` naming the knob rather than silently
        disarming the protection the operator asked for."""
        raw = os.environ.get(env, 0) or 0
        try:
            timeout_s = float(raw)
        except ValueError:
            raise ConfigError(
                f"{env}={raw!r} is not a number of seconds; fix the env "
                "var (e.g. '120') or unset it to disarm the watchdog"
            ) from None
        return cls(timeout_s, what=what, diagnostics=diagnostics)

    def _fire(self):
        self.fired = True
        # black box first: the default action is os._exit, so the flight
        # recorder's forced dump is the postmortem's only record
        try:
            from sherman_tpu_torch.obs import recorder as _fr
            _fr.record_event("watchdog.fired", what=self.what,
                             timeout_s=self.timeout_s)
            _fr.auto_dump("watchdog", force=True)
        except Exception:
            pass  # the watchdog's exit must never be blocked by obs
        msg = (f"[sherman watchdog] '{self.what}' exceeded "
               f"{self.timeout_s:g}s deadline")
        if self.diagnostics is not None:
            # the callback may itself block on the wedged runtime: run it
            # on its own daemon thread and abandon it after a deadline
            box: list = []

            def run():
                try:
                    box.append(f"diagnostics: {self.diagnostics()}")
                except Exception as e:
                    box.append(f"diagnostics failed: {e!r}")

            th = threading.Thread(target=run, daemon=True)
            th.start()
            th.join(self.DIAG_DEADLINE_S)
            msg += "\n[sherman watchdog] " + (
                box[0] if box else
                f"diagnostics hung > {self.DIAG_DEADLINE_S:g}s (wedged "
                "runtime?); abandoned")
        print(msg, file=sys.stderr, flush=True)
        if self.action is not None:
            self.action()
        else:
            os._exit(self.EXIT_CODE)

    def __enter__(self) -> "Watchdog":
        if self.timeout_s > 0:
            self._timer = threading.Timer(self.timeout_s, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


# ---------------------------------------------------------------------------
# Preemption.
# ---------------------------------------------------------------------------

class PreemptionGuard:
    """Turn an eviction SIGTERM into a clean collective checkpoint and
    exit instead of a dead cluster: a Python signal handler latches a
    flag the driver polls between steps (:meth:`should_act`).

    With a keeper that spans processes, every rank latches its own
    signal and :meth:`should_act` reduces the latches with one
    all-reduce (MAX) a call, so a notice on any one rank flips it on
    EVERY rank at the SAME step (the reference's preemption sync
    manager agrees on a sync point the same way).

    Driver shape (``benchmark.py --preempt-ckpt``)::

        guard = PreemptionGuard(cluster.keeper)
        for step in ...:
            run_step()
            if guard.should_act(step):
                checkpoint(cluster, path)
                break   # exit cleanly; relaunch restores

    ``should_act`` must be called with a monotonically increasing step on
    every rank each iteration (replicated control flow).
    """

    def __init__(self, keeper=None, signals=(signal.SIGTERM,)):
        self._flag = False
        self._prev: dict[int, object] = {}
        self._multihost = keeper is not None and getattr(
            keeper, "is_multihost", False)
        for s in signals:
            self._prev[s] = signal.signal(s, self._latch)

    def _latch(self, signum, frame):
        self._flag = True

    def should_act(self, step: int) -> bool:
        """True when this (and, across ranks, EVERY) process should stop
        after the current step and checkpoint."""
        if self._multihost:
            from sherman_tpu_torch.parallel import bootstrap
            return bootstrap.allreduce_int(int(self._flag), "max") > 0
        return self._flag

    def close(self) -> None:
        """Restore the signal handlers this guard installed.  A handler
        installed from C (``signal.signal`` returned None) cannot be
        re-installed from Python; leave it to the latch in that case."""
        for s, prev in self._prev.items():
            if prev is not None:
                signal.signal(s, prev)
        self._prev.clear()
