"""Checkpoint-on-preemption for one process: the port's copy of
``PreemptionGuard`` from ``sherman_tpu/utils/failure.py``.

The rest of the reference's module (the heartbeat monitor, the
coordination-service errors, the multihost preemption sync manager) waits
for the port's multi-process plane, which one process driving every node
of a card does not need.
"""

from __future__ import annotations

import signal

from sherman_tpu_torch.errors import NotPortedError


class PreemptionGuard:
    """Turn an eviction SIGTERM into a clean checkpoint and exit instead of
    a dead cluster: a Python signal handler latches a flag the driver polls
    between steps (:meth:`should_act`).

    Driver shape (``benchmark.py --preempt-ckpt``)::

        guard = PreemptionGuard(cluster.keeper)
        for step in ...:
            run_step()
            if guard.should_act(step):
                checkpoint(cluster, path)
                break   # exit cleanly; relaunch restores

    A keeper that spans processes (the reference's multihost sync manager)
    raises :class:`NotPortedError`: the port runs every node in one
    process.
    """

    def __init__(self, keeper=None, signals=(signal.SIGTERM,)):
        if keeper is not None and getattr(keeper, "is_multihost", False):
            raise NotPortedError("PreemptionGuard across processes (the "
                                 "preemption sync manager) is not ported")
        self._flag = False
        self._prev: dict[int, object] = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._latch)

    def _latch(self, signum, frame):
        self._flag = True

    def should_act(self, step: int) -> bool:
        """True when this process should stop after the current step and
        checkpoint."""
        return self._flag

    def close(self) -> None:
        """Restore the signal handlers this guard installed.  A handler
        installed from C (``signal.signal`` returned None) cannot be
        re-installed from Python; leave it to the latch in that case."""
        for s, prev in self._prev.items():
            if prev is not None:
                signal.signal(s, prev)
        self._prev.clear()
