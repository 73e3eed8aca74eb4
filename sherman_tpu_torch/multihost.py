"""Multihost service plane: per-host chain ownership, key routing and a
cross-host front door (the port's copy of ``sherman_tpu/multihost.py``).

Every host of a Sherman cluster serves clients against the shared pool.
The pool is sharded over nodes; this module is the service half:

- **ownership**: the key space is partitioned over hosts by a
  deterministic mix hash (:class:`HostRouter`).  Each host owns one
  journal stream and one chain namespace in the shared recovery directory
  (``base-h<i>.npz`` / ``delta-h<i>-<cid>-k.npz`` /
  ``journal-h<i>-<cid>-k.wal``, ``recovery.py``), so N hosts fsync,
  rotate and sweep independently: ack bandwidth grows with the host count
  instead of serializing on one stream.
- **front door**: a ``ShermanServer`` a host, each with its own
  ``WidthController``, behind one logical :class:`MultihostService`: a
  submit splits by owner host, each sub-batch rides its owner's door, and
  a write's ack waits on the owner's journal only.
  :func:`merge_host_stats` folds the per-host receipts into one logical
  SLO plane (summed throughput counters, worst-host tail percentiles).
- **recovery**: ``RecoveryPlane.recover_union``, the union of the
  per-host chains, each restored and replayed on its own; a torn tail on
  one host never blocks another's replay, and no two hosts' journals
  carry the same key (the router is the partition).
- **replication seam**: a follower on host B ships host A's chain through
  ``JournalTailer(dir, cid, host_id=A)`` (``replica.py``).

The plane runs its N host contexts in one process: N single-process
clusters (each its own chain namespace) behind one routing table.  The
file formats, routing, recovery and replication paths are the real code;
the transport between processes is not part of it.  ``SHERMAN_HOSTS=1``
(the default) builds no plane at all: artifact names, journal bytes and
receipts are those of a build without this module.

Observability: the ``multihost.split_submits``, ``multihost.routed_ops``,
``multihost.fanout_scans`` and ``multihost.adoptions`` counters.
"""

from __future__ import annotations

import numpy as np

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ConfigError, StateError

_OBS_SPLITS = obs.counter("multihost.split_submits")
_OBS_ROUTED = obs.counter("multihost.routed_ops")
_OBS_SCANS = obs.counter("multihost.fanout_scans")
_OBS_ADOPTIONS = obs.counter("multihost.adoptions")


class HostDownError(StateError):
    """The owner host of (part of) this request is unreachable: crashed or
    frozen at the dispatch seam.  Typed, so a client retries by rid once
    an adopter serves the namespace (exactly-once re-acks) instead of
    holding a half-submitted merged future."""

#: the cached :func:`multihost_capable` probe result, ``[(ok, reason)]``
#: once probed
_MULTIHOST_PROBE: list = []

_PROBE_WORKER = r'''
import sys
import torch
import torch.distributed as dist
pid = int(sys.argv[1]); port = sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=pid)
out = [torch.zeros(1, dtype=torch.int32) for _ in range(2)]
dist.all_gather(out, torch.tensor([pid], dtype=torch.int32))
assert sorted(int(t) for t in out) == [0, 1]
dist.destroy_process_group()
print("PROBE-OK", flush=True)
'''


def multihost_capable() -> tuple[bool, str]:
    """(capable, reason): can this PyTorch run a collective between two
    processes on the ``gloo`` backend (the process-spanning transport of
    ``parallel/transport.py``)?  Probed once per process: two short-lived
    subprocesses run an all-gather under a 120 s deadline, so the probe
    can neither poison nor be poisoned by this process.  Stamped into the
    bench receipt (``config.multihost_capable``), so an artifact says
    which transport it could run."""
    if _MULTIHOST_PROBE:
        return _MULTIHOST_PROBE[0]
    import os
    import socket
    import subprocess
    import sys as _sys
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        worker = os.path.join(d, "probe.py")
        with open(worker, "w") as f:
            f.write(_PROBE_WORKER)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        procs = [subprocess.Popen(
            [_sys.executable, worker, str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(2)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=120)
                outs.append(out)
        except subprocess.TimeoutExpired:
            _MULTIHOST_PROBE.append(
                (False, "probe timed out (collective hung)"))
            return _MULTIHOST_PROBE[0]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 and "PROBE-OK" in o
               for p, o in zip(procs, outs)):
            _MULTIHOST_PROBE.append((True, ""))
        else:
            tail = next((o for p, o in zip(procs, outs)
                         if p.returncode != 0), outs[0])[-600:]
            _MULTIHOST_PROBE.append(
                (False, "this PyTorch cannot run gloo multiprocess "
                 "collectives: " + tail.strip().replace("\n", " | ")))
    return _MULTIHOST_PROBE[0]


# ---------------------------------------------------------------------------
# Key -> owner-host routing
# ---------------------------------------------------------------------------

class HostRouter:
    """Deterministic key -> owner-host partition.  A splitmix64 finalizer
    over the raw key, mod the host count: stateless, the same on every
    host and every retry (a retried rid re-splits into the same per-host
    sub-batches), and independent of the tree's node routing (any host
    can read any page; only the owner journals the write).

    **The adoption overlay**: :meth:`owner` is namespace identity and
    never changes (a dead host's keys still belong to its chain
    namespace).  The overlay answers which host's process serves that
    namespace now (:meth:`route`): after a host failover,
    ``overlay[dead] = adopter``.  The map itself is journaled by the
    failover plane (``hostlease.OwnershipLog``); this is the in-memory
    routing view the service publishes."""

    __slots__ = ("hosts", "overlay")

    def __init__(self, hosts: int):
        if int(hosts) < 1:
            raise ConfigError(f"HostRouter wants hosts >= 1 (got {hosts})")
        self.hosts = int(hosts)
        #: namespace -> serving host (absent: it serves itself)
        self.overlay: dict[int, int] = {}

    def route(self, host: int) -> int:
        """Which host's process serves ``host``'s namespace now (itself
        until an adoption installs an overlay entry)."""
        return self.overlay.get(int(host), int(host))

    def adopt(self, dead: int, adopter: int) -> None:
        """Install one adoption: ``dead``'s namespace is now served by
        ``adopter``'s process.  :meth:`owner` does not change: the adopted
        front door runs over the dead namespace's recovered engine."""
        dead, adopter = int(dead), int(adopter)
        if not (0 <= dead < self.hosts and 0 <= adopter < self.hosts):
            raise ConfigError(
                f"adopt({dead} -> {adopter}): hosts outside "
                f"[0, {self.hosts})")
        if dead == adopter:
            raise ConfigError(f"host {dead} cannot adopt itself")
        self.overlay[dead] = adopter

    def handback(self, dead: int) -> None:
        """Drop one overlay entry: ``dead``'s namespace serves itself
        again (the routing half of ``hostlease.HostFailover.handback``;
        the caller rebuilds the returning host's door first)."""
        self.overlay.pop(int(dead), None)

    def owner(self, keys) -> np.ndarray:
        """The owner host of each key -> int32 [n] in [0, hosts)."""
        k = np.ascontiguousarray(keys, np.uint64)
        if self.hosts == 1:
            return np.zeros(k.shape, np.int32)
        # the splitmix64 finalizer: unsigned wraparound is the algorithm
        x = k.copy()
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        return (x % np.uint64(self.hosts)).astype(np.int32)

    def split(self, keys, values=None):
        """Partition one request by owner -> [(host, idx, keys_h,
        values_h)], ``idx`` the positions of ``keys_h`` in the batch (the
        merge permutation).  Hosts with no key in the batch are absent."""
        k = np.ascontiguousarray(keys, np.uint64)
        own = self.owner(k)
        v = None if values is None \
            else np.ascontiguousarray(values, np.uint64)
        out = []
        for h in range(self.hosts):
            idx = np.nonzero(own == h)[0]
            if idx.size:
                out.append((h, idx, k[idx],
                            None if v is None else v[idx]))
        return out


# ---------------------------------------------------------------------------
# A host context
# ---------------------------------------------------------------------------

class HostContext:
    """One host's slice of the plane: its cluster, tree and engine, its
    recovery plane (chain namespace ``-h<host_id>-``) and its front door.
    One process holds one of these a host (``SHERMAN_HOST_ID``); the
    emulated plane builds all N in one process."""

    __slots__ = ("host_id", "cluster", "tree", "eng", "plane", "server")

    def __init__(self, host_id: int, cluster=None, tree=None, eng=None,
                 plane=None, server=None):
        self.host_id = int(host_id)
        self.cluster = cluster
        self.tree = tree
        self.eng = eng
        self.plane = plane
        self.server = server


# ---------------------------------------------------------------------------
# The cross-host front door
# ---------------------------------------------------------------------------

class _MergedFuture:
    """The future of one split submit: resolves when every owner host's
    sub-future has, putting the per-host results back in the batch's
    order.  It has the ``ServeFuture`` surface the clients use
    (``result``, ``done``, ``deduped``)."""

    __slots__ = ("op", "tenant", "n_ops", "rid", "parts")

    def __init__(self, op: str, tenant: str, n_ops: int, rid,
                 parts: list):
        self.op = op
        self.tenant = tenant
        self.n_ops = int(n_ops)
        self.rid = rid
        #: [(host, idx, sub_future)]; idx maps the sub-results home
        self.parts = parts

    def done(self) -> bool:
        return all(f.done() for _h, _i, f in self.parts)

    @property
    def deduped(self) -> bool:
        """True when every owner host re-acked from its exactly-once
        window (the router is deterministic, so a retried rid reaches the
        same owners and each dedups on its own)."""
        return all(f.deduped for _h, _i, f in self.parts)

    def result(self, timeout: float | None = None):
        subs = [(idx, f.result(timeout)) for _h, idx, f in self.parts]
        if self.op == "read":
            vals = np.zeros(self.n_ops, np.uint64)
            found = np.zeros(self.n_ops, bool)
            for idx, (v, fnd) in subs:
                vals[idx] = np.asarray(v, np.uint64)
                found[idx] = np.asarray(fnd, bool)
            return vals, found
        # insert -> ok a key; delete -> found a key
        ok = np.zeros(self.n_ops, bool)
        for idx, r in subs:
            ok[idx] = np.asarray(r, bool)
        return ok


class _MergedScan:
    """The future of one fan-out scan: every host runs the same range set
    over its shard (a hash partition scatters any range's keys over all
    hosts), and each range's per-host results are concatenated and sorted
    again by key, ``range_query_many``'s order restored plane-wide."""

    __slots__ = ("tenant", "n_ranges", "parts")

    def __init__(self, tenant: str, n_ranges: int, parts: list):
        self.tenant = tenant
        self.n_ranges = int(n_ranges)
        #: [(host, sub_future)]: every host contributes to every range
        self.parts = parts

    def done(self) -> bool:
        return all(f.done() for _h, f in self.parts)

    @property
    def deduped(self) -> bool:
        return False            # scans never ride the write contract

    def result(self, timeout: float | None = None):
        per_host = [f.result(timeout) for _h, f in self.parts]
        out = []
        for r in range(self.n_ranges):
            ks = np.concatenate([np.asarray(ph[r][0], np.uint64)
                                 for ph in per_host])
            vs = np.concatenate([np.asarray(ph[r][1], np.uint64)
                                 for ph in per_host])
            order = np.argsort(ks, kind="stable")
            out.append((ks[order], vs[order]))
        return out


class MultihostService:
    """One logical front door over N per-host servers.

    Reads and writes split by owner host (:meth:`HostRouter.split`); each
    sub-batch is admitted by its owner's own width controller and tenant
    gates and, a write, acked only after the owner's journal fsync covers
    it.  The merged future resolves in the batch's order.  Scans fan out:
    each host runs the whole range set over its shard and the merged
    future sorts each range again.  The one typed refusal is a scan with a
    resume ``cursor``: a cursor is positional within one host's range
    walk and does not compose over a hash partition.

    The service holds no pool state: it is a routing table and the glue
    of the futures."""

    def __init__(self, servers, router: HostRouter | None = None,
                 planes=None):
        if not servers:
            raise ConfigError("MultihostService wants >= 1 server")
        self.servers = list(servers)
        self.hosts = len(self.servers)
        self.router = router or HostRouter(self.hosts)
        if self.router.hosts != self.hosts:
            raise ConfigError(
                f"router spans {self.router.hosts} hosts but "
                f"{self.hosts} servers were given")
        #: the per-host recovery planes (host order), for the frontier
        #: tokens; the front door itself never touches the chain
        self.planes = list(planes) if planes is not None else None
        self._chaos = None      # HostChaos at the dispatch seam
        self.adoptions = 0

    def attach_chaos(self, host_chaos) -> None:
        """Install a ``chaos.HostChaos`` layer at the dispatch seam: every
        sub-batch's serving host is asked before routing, and a crashed or
        frozen host refuses typed (:class:`HostDownError`)."""
        self._chaos = host_chaos

    def _check_dispatch(self, owners) -> None:
        """Ask the chaos layer about every serving host of this request
        before submitting any part (a typed refusal must not strand
        sub-futures already admitted on live hosts).  The dispatch clock
        ticks once a service dispatch, refused or not."""
        if self._chaos is None:
            return
        try:
            for h in owners:
                serving = self.router.route(h)
                d = self._chaos.on_dispatch(serving)
                if d is not None and d.get("down"):
                    raise HostDownError(
                        f"host {serving} (serving namespace {h}) is "
                        f"unreachable ({d.get('state')}); retry by rid "
                        "once the namespace is adopted")
        finally:
            self._chaos.tick()

    def submit(self, op: str, keys=None, values=None, *,
               tenant: str = "default", ranges=None, cursor=None,
               rid=None, deadline_ms: float | None = None):
        """Split-admit one request over its owner hosts -> a merged future
        (in the batch's order).  A one-host plane passes it straight
        through."""
        if cursor is not None:
            raise ConfigError(
                "scan cursors do not resume over a hash-partitioned host "
                "plane (a resume token is positional within one host's "
                "range walk); re-submit the full ranges, or resume on a "
                "single-host front door")
        if self.hosts == 1:
            return self.servers[0].submit(
                op, keys, values, tenant=tenant, ranges=ranges,
                rid=rid, deadline_ms=deadline_ms)
        if op == "scan":
            if not ranges:
                raise ConfigError("scan submit needs ranges")
            self._check_dispatch(range(self.hosts))
            _OBS_SCANS.inc()
            parts = [(h, self.servers[h].submit(
                "scan", tenant=tenant, ranges=ranges,
                deadline_ms=deadline_ms)) for h in range(self.hosts)]
            return _MergedScan(tenant, len(ranges), parts)
        keys = np.ascontiguousarray(keys, np.uint64)
        parts_in = self.router.split(keys, values)
        self._check_dispatch([h for h, _i, _k, _v in parts_in])
        _OBS_SPLITS.inc()
        _OBS_ROUTED.inc(int(keys.size))
        parts = []
        for h, idx, k_h, v_h in parts_in:
            f = self.servers[h].submit(
                op, k_h, v_h, tenant=tenant, rid=rid,
                deadline_ms=deadline_ms)
            parts.append((h, idx, f))
        return _MergedFuture(op, tenant, int(keys.size), rid, parts)

    def adopt(self, dead: int, server, *, plane=None,
              adopter: int | None = None) -> None:
        """Swap ``dead``'s front door for the adopted one (a fresh server
        over the dead namespace's recovered engine, run by the adopter)
        and install the router overlay.  ``hostlease.HostFailover.adopt``
        calls it after its ``done`` frame is durable: the service's view
        follows the journaled ownership map, never leads it."""
        dead = int(dead)
        if not (0 <= dead < self.hosts):
            raise ConfigError(f"adopt: host {dead} outside "
                              f"[0, {self.hosts})")
        self.servers[dead] = server
        if self.planes is not None and plane is not None:
            self.planes[dead] = plane
        if adopter is not None:
            self.router.adopt(dead, adopter)
        self.adoptions += 1
        _OBS_ADOPTIONS.inc()

    def journal_frontiers(self) -> list[tuple[str, int]]:
        """The per-host durable journal frontiers, host order: the union
        coverage token (followers covering every entry hold everything
        any host acked)."""
        if self.planes is None:
            raise StateError(
                "MultihostService was built without planes= — frontier "
                "tokens live on the per-host RecoveryPlanes")
        return [p.journal_frontier() for p in self.planes]

    def stats(self) -> dict:
        """One logical SLO plane over the per-host receipts
        (:func:`merge_host_stats`).  The adoption state rides along only
        once an adoption happened."""
        out = merge_host_stats([s.stats() for s in self.servers])
        if self.adoptions:
            out["adoptions"] = self.adoptions
            out["overlay"] = {str(d): a for d, a
                              in sorted(self.router.overlay.items())}
        return out


def merge_host_stats(per_host: list[dict]) -> dict:
    """Fold per-host ``ShermanServer.stats()`` receipts into one logical
    SLO plane: throughput counters sum (the plane serves the union of the
    hosts' traffic), tail percentiles take the worst host (a plane's p99
    is broken if any host's is), and the journal's coalescing is derived
    again from the summed acks and fsyncs."""
    if not per_host:
        raise ConfigError("merge_host_stats wants >= 1 stats dict")
    merged = {
        "hosts": len(per_host),
        "admitted_ops": sum(s.get("admitted_ops", 0) for s in per_host),
        "served_ops": sum(s.get("served_ops", 0) for s in per_host),
        "acked_writes": sum(s.get("acked_writes", 0) for s in per_host),
        "rejects": {
            "overload": sum(s.get("rejects", {}).get("overload", 0)
                            for s in per_host),
            "degraded": sum(s.get("rejects", {}).get("degraded", 0)
                            for s in per_host),
        },
        "dispatch_errors": sum(s.get("dispatch_errors", 0)
                               for s in per_host),
        "retraces": sum(s.get("retraces", 0) for s in per_host),
        "widths": [(s.get("controller") or {}).get(
            "settled_width", (s.get("controller") or {}).get("cap_width"))
            for s in per_host],
    }
    # the worst host's tail a class, over the hosts that observed it
    window: dict = {}
    for s in per_host:
        for cls, w in (s.get("window") or {}).items():
            cur = window.setdefault(cls, {
                "ops_s": 0.0, "p50_ms": 0.0, "p99_ms": 0.0,
                "window_ops": 0, "ops_total": 0})
            cur["ops_s"] += float(w.get("ops_s", 0.0))
            cur["p50_ms"] = max(cur["p50_ms"],
                                float(w.get("p50_ms", 0.0)))
            cur["p99_ms"] = max(cur["p99_ms"],
                                float(w.get("p99_ms", 0.0)))
            cur["window_ops"] += int(w.get("window_ops", 0))
            cur["ops_total"] += int(w.get("ops_total", 0))
    merged["window"] = window
    # the exactly-once windows, summed (disjoint: one rid's entries live
    # only on its sub-batches' owner hosts)
    merged["contract"] = {
        k: sum((s.get("contract") or {}).get(k, 0) for s in per_host)
        for k in ("dedup_hits", "deadline_shed", "duplicate_applies",
                  "cached_rids", "pending_rids")}
    fsyncs = sum((s.get("journal") or {}).get("fsyncs", 0)
                 for s in per_host)
    appends = sum((s.get("journal") or {}).get("appends", 0)
                  for s in per_host)
    if fsyncs:
        merged["journal"] = {
            "fsyncs": fsyncs, "appends": appends,
            "acks_per_fsync": round(
                merged["acked_writes"] / fsyncs, 3),
        }
    return merged


# ---------------------------------------------------------------------------
# Construction from the knobs
# ---------------------------------------------------------------------------

def plane_from_env() -> tuple[int, int]:
    """(hosts, host_id) from the knobs; the default (1, 0) builds no
    plane.  Callers pass the pair into ``RecoveryPlane(..., hosts=,
    host_id=)``."""
    return C.hosts(), C.host_id()
