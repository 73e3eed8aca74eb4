"""Cluster bootstrap + control-plane collectives — the Keeper role (the
port's copy of ``sherman_tpu/parallel/bootstrap.py``).

The reference coordinates out-of-band through memcached: node-ID assignment
(``Keeper.cpp:67-85``), all-pairs QP handshake (``DSMKeeper.cpp:36-134``),
named barriers via fetch-add + spin (``DSMKeeper.cpp:148-161``) and ``sum``
all-reduce via per-node keys (``DSMKeeper.cpp:163-176``).

One process driving every node of a card reduces the Keeper to a small
in-memory KV + collectives surface (:class:`Keeper`).  Several processes
("ranks", each driving a contiguous block of nodes) join through
:func:`init_multihost`, which opens a ``torch.distributed`` process group
on the ``gloo`` backend; its ``TCPStore`` is the memcached analogue, and
:class:`DistributedKeeper` backs the same interface with it.

The module-level collectives (:func:`process_allgather`,
:func:`broadcast_one_to_all`, :func:`sync_global_devices`,
:func:`allreduce_int`, :func:`allgather_object`) are the port's stand-ins
for ``jax.experimental.multihost_utils``: every module that crosses ranks
on the host goes through them.  They move host (numpy) values; the device
steps cross ranks through :mod:`sherman_tpu_torch.parallel.transport`.
"""

from __future__ import annotations

import datetime
import os
import threading
from collections import defaultdict

import numpy as np

from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.parallel.mesh import process_layout

# the process group's own timeout for a collective (gloo's), long enough
# for the largest exchange; a dead peer is caught by the heartbeat monitor
_PG_TIMEOUT_S = 1800
# the reference's default death-detection latency (jax's heartbeat timeout)
DEFAULT_HEARTBEAT_S = 100


class Keeper:
    """In-process KV / barrier / sum with DSMKeeper's interface."""

    is_multihost = False

    def __init__(self, machine_nr: int):
        self.machine_nr = machine_nr
        self._kv: dict[str, bytes] = {}
        self._counters: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._server_num = 0

    # -- membership (Keeper::serverEnter, Keeper.cpp:67-85) ------------------

    def server_enter(self) -> int:
        with self._lock:
            node_id = self._server_num
            self._server_num += 1
            assert node_id < self.machine_nr, "cluster full"
            return node_id

    # -- KV (Keeper::memSet/memGet/memFetchAndAdd, Keeper.cpp:115-160) -------

    def mem_set(self, key: str, value: bytes) -> None:
        with self._lock:
            self._kv[key] = value

    def mem_get(self, key: str) -> bytes | None:
        with self._lock:
            return self._kv.get(key)

    def mem_fetch_and_add(self, key: str, delta: int = 1) -> int:
        with self._lock:
            old = self._counters[key]
            self._counters[key] = old + delta
            return old

    # -- collectives (DSMKeeper.cpp:148-176) ---------------------------------

    def barrier(self, name: str, timeout_s: float | None = None) -> None:
        """Named cluster barrier.  In single-process SPMD every node's work
        is already serialized through one driver, so arrival==completion;
        the fetch-add bookkeeping is kept for interface parity.
        ``timeout_s`` is accepted for interface parity with the guarded
        multihost barrier (trivially met here)."""
        self.mem_fetch_and_add("barrier:" + name, 1)

    def sum(self, name: str, value: int) -> int:
        """All-reduce sum of one contribution per call (cluster throughput
        aggregation in the benchmark driver, test/benchmark.cpp:336-346)."""
        with self._lock:
            k = "sum:" + name
            self._counters[k] += int(value)
            return self._counters[k]


# ---------------------------------------------------------------------------
# Host collectives over the process group (multihost_utils' stand-ins).
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def _as_tuple(x):
    single = not isinstance(x, (tuple, list))
    return single, ((x,) if single else tuple(x))


def _pack(arrs) -> tuple:
    """Arrays -> (one uint8 tensor of their bytes, [(shape, dtype, n)])."""
    import torch
    metas, parts = [], []
    for a in arrs:
        a = np.ascontiguousarray(a)
        b = a.reshape(-1).view(np.uint8)
        metas.append((a.shape, a.dtype, b.size))
        parts.append(b)
    buf = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return torch.from_numpy(buf.copy()), metas


def _unpack(buf: np.ndarray, metas) -> list:
    out, off = [], 0
    for shape, dtype, n in metas:
        out.append(buf[off:off + n].view(dtype).reshape(shape).copy())
        off += n
    return out


def process_allgather(x, tiled: bool = False):
    """Every rank's host array(s) on every rank (``multihost_utils.
    process_allgather``): stacked on a new leading axis, or concatenated
    along axis 0 with ``tiled``.  ``x`` is an array or a tuple of arrays
    (one collective for all of them); every rank passes the same shapes.
    Outside a process group it returns ``x`` as one rank's gather."""
    single, arrs = _as_tuple(x)
    ws, _ = process_layout()
    if ws == 1:
        out = tuple(np.asarray(a) if tiled else np.asarray(a)[None]
                    for a in arrs)
        return out[0] if single else out
    import torch
    dist = _dist()
    t, metas = _pack(arrs)
    got = [torch.empty_like(t) for _ in range(ws)]
    dist.all_gather(got, t)
    per = [_unpack(g.numpy(), metas) for g in got]
    out = tuple((np.concatenate if tiled else np.stack)(
        [p[i] for p in per]) for i in range(len(arrs)))
    return out[0] if single else out


def broadcast_one_to_all(x):
    """Rank 0's host array(s) on every rank (``multihost_utils.
    broadcast_one_to_all``); the other ranks pass placeholders of the
    same shapes and dtypes."""
    single, arrs = _as_tuple(x)
    if process_layout()[0] == 1:
        return x
    dist = _dist()
    t, metas = _pack(arrs)
    dist.broadcast(t, 0)
    out = tuple(_unpack(t.numpy(), metas))
    return out[0] if single else out


def allreduce_int(value: int, op: str = "sum") -> int:
    """One integer reduced over the ranks (``sum``, ``max`` or ``min``)."""
    ws, _ = process_layout()
    if ws == 1:
        return int(value)
    import torch
    dist = _dist()
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX,
                           "min": dist.ReduceOp.MIN}[op])
    return int(t[0])


def allgather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order (variable sizes)."""
    ws, _ = process_layout()
    if ws == 1:
        return [obj]
    out = [None] * ws
    _dist().all_gather_object(out, obj)
    return out


def sync_global_devices(name: str) -> None:
    """Flush this rank's queued device work, then meet every rank
    (``multihost_utils.sync_global_devices``)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if process_layout()[0] > 1:
        _dist().barrier()


# ---------------------------------------------------------------------------
# Joining a multi-process deployment.
# ---------------------------------------------------------------------------

def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   heartbeat_timeout_s: int | None = None
                   ) -> "DistributedKeeper":
    """Join a multi-process deployment and return its Keeper.

    The memcached bootstrap role (``Keeper.cpp:28-56``): every rank calls
    this before building the Cluster.  It opens the ``gloo`` process group
    at ``tcp://<coordinator_address>`` (``host:port``; rank 0 hosts the
    store there), pins the rank's card (``cuda:(rank % device_count)``)
    and starts the heartbeat monitor (:mod:`sherman_tpu_torch.utils.
    failure`).  ``scripts/multihost_launch.sh`` passes the arguments as
    ``SHERMAN_COORD`` / ``SHERMAN_NPROC`` / ``SHERMAN_PROC_ID``, read here
    when they are omitted.

    ``heartbeat_timeout_s`` (env ``SHERMAN_HEARTBEAT_S``, default 100 s):
    a peer whose heartbeat stands still this long makes every survivor
    print a diagnostic naming it and exit, instead of hanging in its next
    collective.  Stalled-but-alive peers are the other half: a guarded
    ``barrier(..., timeout_s=...)`` raises a catchable PeerFailure.
    """
    import torch

    from sherman_tpu_torch.utils import failure
    dist = _dist()
    if coordinator_address is None:
        coordinator_address = os.environ.get("SHERMAN_COORD")
        if coordinator_address is not None:
            # env fills only the args the caller omitted
            if num_processes is None:
                num_processes = _env_int("SHERMAN_NPROC")
            if process_id is None:
                process_id = _env_int("SHERMAN_PROC_ID")
    if heartbeat_timeout_s is None:
        hb = os.environ.get("SHERMAN_HEARTBEAT_S")
        if hb:
            try:
                heartbeat_timeout_s = int(hb)
            except ValueError:
                raise ConfigError(
                    f"SHERMAN_HEARTBEAT_S={hb!r} is not a whole number of "
                    "seconds; fix the env var (e.g. '10') or unset it to "
                    "keep jax's default") from None
    if not dist.is_initialized():
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ConfigError(
                "init_multihost: no process group and no coordinator: pass "
                "coordinator_address/num_processes/process_id or set "
                "SHERMAN_COORD, SHERMAN_NPROC and SHERMAN_PROC_ID")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=_PG_TIMEOUT_S))
    elif heartbeat_timeout_s is not None \
            and failure.heartbeat_monitor() is not None:
        import warnings
        warnings.warn(
            f"heartbeat_timeout_s={heartbeat_timeout_s} ignored: the "
            "process group was joined before and its heartbeat monitor "
            "keeps the timeout it started with", RuntimeWarning,
            stacklevel=2)
    if torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    failure.start_heartbeat(heartbeat_timeout_s or DEFAULT_HEARTBEAT_S)
    return DistributedKeeper()


class DistributedKeeper(Keeper):
    """Multi-process Keeper over the ``torch.distributed`` group.

    Node-ID assignment maps to the rank (``serverEnter``'s atomic
    increment, Keeper.cpp:67-85), ``barrier`` to a global device sync
    (DSMKeeper.cpp:148-161) and ``sum`` to an all-reduce
    (DSMKeeper.cpp:163-176).  The KV surface stays process-local:
    cluster-global state lives in the DSM itself (the root pointer is a
    meta-page word installed by CAS)."""

    is_multihost = True

    def __init__(self):
        ws, self._rank = process_layout()
        super().__init__(machine_nr=ws)

    def server_enter(self) -> int:
        return self._rank

    def barrier(self, name: str, timeout_s: float | None = None) -> None:
        """Named cluster barrier.

        Default (``timeout_s=None``): flush this rank's card, then a
        process-group barrier: the strongest form, and like the
        reference's memcached spin it waits as long as its peers do (the
        heartbeat monitor ends it if a peer died).

        Guarded (``timeout_s`` set): a store-level barrier with a deadline
        that raises :class:`sherman_tpu_torch.utils.failure.PeerFailure`
        naming the ranks that never arrived.  Control-plane only: it does
        not flush the card."""
        if timeout_s is not None:
            from sherman_tpu_torch.utils import failure
            key = "guarded_barrier:" + name
            with self._lock:
                attempt = self._counters[key]
            used = attempt
            try:
                used = failure.barrier_guarded(name, timeout_s,
                                               attempt=attempt)
            except failure.PeerFailure as e:
                used = e.attempt
                raise
            finally:
                # advance past the attempt consumed (success OR burned by
                # a timeout): a retry after PeerFailure and the stalled
                # peer's late call (via the burn marker) meet on one id
                with self._lock:
                    self._counters[key] = max(self._counters[key], used + 1)
            return
        sync_global_devices(name)

    def live_processes(self) -> list[int]:
        """Heartbeat-based liveness roll call (see utils.failure)."""
        from sherman_tpu_torch.utils import failure
        return failure.live_processes(self.machine_nr)

    def sum(self, name: str, value: int) -> int:
        return allreduce_int(int(value))
