"""Host-failure plane: the cross-host lease table, zombie-host fencing
and chain adoption by surviving hosts (the port's copy of
``sherman_tpu/hostlease.py``).

The multihost service plane (``multihost.py``) partitions the key space
over hosts, but ``HostRouter`` is a static key -> owner map: a dead
host's keys are unserved until someone steps in.  This module composes
three single-host mechanisms into failover at host granularity:

- **the cross-host lease table** (:class:`HostLeaseTable`): one durable
  heartbeat record a host in the shared chain directory
  (``hostlease-h<i>.rec``: ``{host_id, epoch, hwm, timestamp}``, framed
  with the journal's CRC frame, replaced by an atomic rename), judged by
  age against ``SHERMAN_HOST_LEASE_S``.  Expiry alone changes nothing
  durable: it lets a surviving host bump the dead host's epoch (the fence
  point) and adopt;
- **zombie-host fencing** (:class:`HostFence`): each host's journal
  checks its own lease epoch before every append (the replica plane's
  fenced journal at host granularity).  A frozen host revived after its
  epoch was bumped appends past a fence point captured at the bump; its
  late acks are a fenced suffix that is provably never merged
  (``audit.check_fenced_rejected``, :func:`count_fenced_suffix`), and
  once its lease view heals its next append raises the typed
  :class:`StaleHostError`;
- **chain adoption** (:class:`HostFailover`): a surviving host runs the
  dead host's ``-h<dead>-`` namespace through the restore-then-replay
  core (``RecoveryPlane.recover`` scoped to one host), seeds the dead
  host's exactly-once window into the adopted front door (``seed_dedup``,
  journaled again for a second crash) and publishes an epoch-versioned
  ownership map: the append-only, CRC-framed ``ownership.maplog``.  An
  adoption writes a ``begin`` frame (with the captured fence point)
  before it touches the dead chain and a ``done`` frame after the seed,
  so an adopter that crashes mid-adoption leaves a durable marker that
  :meth:`HostFailover.resume` completes, re-asserting the journaled epoch
  bump and reusing the journaled fence.  A restarted host that was
  adopted cannot rejoin at the fence epoch: ``register`` refuses typed
  until :meth:`HostFailover.handback` clears the overlay and opens a new
  lease generation.

The hosts run in one process, sharing one directory, as the service
plane's host contexts do.  ``hosts == 1`` builds none of this (the table
refuses construction), so single-host artifacts and journal bytes are
those of a build without it.  The lease table and the ownership log are
the reference's bytes: either package reads what the other wrote.

Observability: the ``hostfail.`` pull collector (``leases_renewed``,
``expirations``, ``adoptions``, ``fenced_host_acks``, ``adoption_ms``)
and the flight events ``host.lease_expired``, ``host.adopt_begin``,
``host.adopt_done``, ``host.zombie_fenced`` and ``host.handback``, with
the debounced black-box dump fired on every completed adoption.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ShermanError, StateError
from sherman_tpu_torch.utils import journal as J

_RECORD = "hostlease-h{host}.rec"
_MAPLOG = "ownership.maplog"

#: flat ``hostfail.`` pull-collector state — module-global because the
#: incrementing sites span three classes (table, fence, failover) that
#: share one plane; registered lazily on first table construction so
#: hosts=1 builds never grow the collector
_STATS = {"leases_renewed": 0, "expirations": 0, "adoptions": 0,
          "fenced_host_acks": 0, "adoption_ms": 0.0}
_COLLECTOR_ARMED: list = []


def _ensure_collector() -> None:
    if not _COLLECTOR_ARMED:
        obs.register_collector("hostfail", lambda: dict(_STATS))
        _COLLECTOR_ARMED.append(True)


class StaleHostError(StateError):
    """This host's lease epoch was bumped by an adopter: the append is
    fenced — a zombie host must not fork its (now adopted) journal."""


class HostAdoptedError(StateError):
    """This host's namespace is currently ADOPTED by a surviving peer:
    re-registering would rejoin at the fence epoch and dual-write the
    chain the adopter is serving.  An explicit hand-back
    (:meth:`HostFailover.handback`) clears the overlay and opens a
    fresh lease generation first."""


class HostLeaseCorruptError(ShermanError, RuntimeError):
    """A lease record failed its CRC frame — corruption in the lease
    table is a typed refusal, never a silently-parsed heartbeat."""


# ---------------------------------------------------------------------------
# The cross-host lease table
# ---------------------------------------------------------------------------


class HostLeaseTable:
    """Durable per-host heartbeat records in the shared chain
    directory.  One record per host, journal-CRC-framed, replaced
    atomically (tmp + fsync + ``os.replace``) so a reader never sees a
    torn heartbeat; liveness is judged by record age against
    ``lease_s`` (``SHERMAN_HOST_LEASE_S``), epochs by exact match —
    the client lease table's discipline (``cluster.lease_is_live``),
    durable on disk.

    Requires ``hosts >= 2``: a single-host plane has no peer to probe
    or adopt, and constructing a table there would break the hosts=1
    bit-identity contract (no ``hostlease-*`` files, no collector)."""

    def __init__(self, directory: str, hosts: int,
                 lease_s: float | None = None, chaos=None):
        if int(hosts) < 2:
            raise StateError(
                f"HostLeaseTable wants hosts >= 2 (got {hosts}); a "
                "single-host plane has no peer lease to keep")
        self.dir = directory
        self.hosts = int(hosts)
        self.lease_s = float(lease_s) if lease_s is not None \
            else C.host_lease_s()
        #: host-chaos layer (``chaos.HostChaos``): the lease-renewal
        #: seam — a crashed/frozen/zombified host's renewals are
        #: suppressed, so its lease expires under traffic
        self.chaos = chaos
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        _ensure_collector()

    def _path(self, host_id: int) -> str:
        return os.path.join(self.dir, _RECORD.format(host=int(host_id)))

    def _write(self, rec: dict) -> None:
        """Atomic durable record publish — tmp + fsync + rename, the
        follower-watermark pattern, under the journal CRC frame."""
        path = self._path(rec["host_id"])
        blob = J.frame_blob(json.dumps(rec, sort_keys=True).encode())
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def read(self, host_id: int) -> dict | None:
        """The host's current heartbeat record, or None when absent
        (never registered / swept).  A record that fails its CRC frame
        raises :class:`HostLeaseCorruptError` typed."""
        try:
            with open(self._path(host_id), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        try:
            return json.loads(J.unframe_blob(blob))
        except (J.JournalCorruptError, ValueError) as e:
            raise HostLeaseCorruptError(
                f"host {int(host_id)} lease record unreadable: {e}"
            ) from e

    def register(self, host_id: int, hwm=None) -> int:
        """Join (or re-join) the table: adopt the recorded epoch if a
        record exists (a restarting host continues its own lease
        generation), else start at epoch 1; write a fresh heartbeat.
        Returns the epoch this host now holds.

        A record carrying an ``adopter`` stamp is a namespace someone
        else is SERVING right now: rejoining at the recorded (fence)
        epoch would make ``HostFence.check`` pass on the restarted
        host while the adopter appends to the same chain — a
        dual-writer.  Refused typed (:class:`HostAdoptedError`) until
        an explicit hand-back (:meth:`handback`) clears the stamp."""
        rec = self.read(host_id)
        if rec is not None and "adopter" in rec:
            raise HostAdoptedError(
                f"host {int(host_id)}'s namespace is adopted by host "
                f"{int(rec['adopter'])} (fence epoch {int(rec['epoch'])}); "
                "re-registering would dual-write the adopted chain — "
                "hand the namespace back first")
        epoch = int(rec["epoch"]) if rec is not None else 1
        self.renew(host_id, epoch, hwm=hwm, force=True)
        return epoch

    def renew(self, host_id: int, epoch: int, hwm=None,
              force: bool = False) -> bool:
        """One heartbeat: re-stamp the record's timestamp (and the
        durable journal frontier ``hwm``, when given).  Returns False
        without writing when the chaos layer says this host makes no
        progress (crashed/frozen/zombie — the lease-renewal seam), or
        when the host no longer owns the recorded epoch (a fenced host
        must not resurrect its lease).  ``force`` skips the epoch
        guard for :meth:`register`."""
        if self.chaos is not None \
                and not self.chaos.allow_renew(int(host_id)):
            return False
        with self._lock:
            rec = None
            if not force:
                rec = self.read(host_id)
                if rec is not None and int(rec["epoch"]) != int(epoch):
                    return False
            new = {"host_id": int(host_id), "epoch": int(epoch),
                   "hwm": self._hwm_field(hwm),
                   "timestamp": time.time()}
            if rec is not None and "adopter" in rec:
                # the adoption stamp is sticky across heartbeats: only
                # an explicit hand-back may clear it
                new["adopter"] = int(rec["adopter"])
            self._write(new)
        _STATS["leases_renewed"] += 1
        return True

    @staticmethod
    def _hwm_field(hwm):
        """Journal-frontier token -> JSON shape: a
        ``RecoveryPlane.journal_frontier()`` pair becomes
        ``[segment basename, size]``; None stays None."""
        if hwm is None:
            return None
        path, size = hwm
        return [os.path.basename(str(path)), int(size)]

    def probe(self, host_id: int, now: float | None = None) -> str:
        """Liveness verdict: ``"live"`` / ``"expired"`` / ``"absent"``
        — record age against ``lease_s``, the client lease table's
        expiry discipline made durable."""
        rec = self.read(host_id)
        if rec is None:
            return "absent"
        now = time.time() if now is None else float(now)
        return "expired" if now - float(rec["timestamp"]) > self.lease_s \
            else "live"

    def is_live(self, host_id: int, epoch: int) -> bool:
        """Does ``host_id`` still hold ``epoch``?  Exact-match epoch
        discipline (``cluster.lease_is_live``): the adopter's durable
        epoch bump — not wall-clock expiry — is what fences a host;
        before the bump the (possibly slow) host is still the
        legitimate owner and its acks are legal."""
        rec = self.read(host_id)
        return rec is not None and int(rec["epoch"]) == int(epoch)

    def expire(self, host_id: int, adopter: int | None = None) -> int:
        """The fence: durably bump the host's lease epoch (the
        adoption-time analog of ``cluster.expire_client``).  Every
        later append through the old epoch's fence raises
        :class:`StaleHostError`.  Records the adopter for the
        published ownership story; returns the NEW epoch."""
        with self._lock:
            rec = self.read(host_id)
            old = int(rec["epoch"]) if rec is not None else 0
            new = {"host_id": int(host_id), "epoch": old + 1,
                   "hwm": rec.get("hwm") if rec is not None else None,
                   "timestamp": time.time()}
            if adopter is not None:
                new["adopter"] = int(adopter)
            self._write(new)
        _STATS["expirations"] += 1
        return old + 1

    def ensure_epoch(self, host_id: int, epoch: int,
                     adopter: int | None = None) -> int:
        """Idempotent fence toward a journaled epoch: durably raise
        ``host_id``'s lease epoch to AT LEAST ``epoch``.  The resume
        path's bump — an adopter that crashed between the ``begin``
        frame and :meth:`expire` left the dead host's epoch one short
        of the journaled fence, and without the repair the zombie's
        fence check and renewals would still pass.  A no-op when the
        recorded epoch already reached ``epoch`` (the bump happened
        before the crash).  Returns the recorded epoch after."""
        with self._lock:
            rec = self.read(host_id)
            cur = int(rec["epoch"]) if rec is not None else 0
            if cur >= int(epoch):
                return cur
            new = {"host_id": int(host_id), "epoch": int(epoch),
                   "hwm": rec.get("hwm") if rec is not None else None,
                   "timestamp": time.time()}
            if adopter is not None:
                new["adopter"] = int(adopter)
            self._write(new)
        _STATS["expirations"] += 1
        return int(epoch)

    def handback(self, host_id: int) -> int:
        """Clear the adopter stamp and bump the epoch — the explicit
        hand-back that lets a previously-adopted host re-register
        (:meth:`register` refuses typed while the stamp is set).  The
        bump opens a FRESH lease generation: every epoch the zombie or
        the adopter ever fenced against stays behind the new fence.
        Idempotent when no stamp is set (crash-retry safe); typed when
        the host never registered.  Returns the epoch a re-register
        will now join."""
        with self._lock:
            rec = self.read(host_id)
            if rec is None:
                raise StateError(
                    f"host {int(host_id)} has no lease record to hand "
                    "back")
            if "adopter" not in rec:
                return int(rec["epoch"])
            new = {"host_id": int(host_id),
                   "epoch": int(rec["epoch"]) + 1,
                   "hwm": rec.get("hwm"),
                   "timestamp": time.time()}
            self._write(new)
            return int(rec["epoch"]) + 1

    def epochs(self) -> dict:
        """{host: epoch} over every present record — the receipt
        shape."""
        out = {}
        for h in range(self.hosts):
            rec = self.read(h)
            if rec is not None:
                out[h] = int(rec["epoch"])
        return out


# ---------------------------------------------------------------------------
# The zombie fence at the journal durability gate
# ---------------------------------------------------------------------------


class _FencedHostJournal:
    """Journal proxy that checks this HOST's lease epoch before every
    append — the replica plane's ``_FencedJournal`` at host granularity.
    Everything else (close, stats, path, rotation handoff) delegates,
    so the recovery plane's rotation protocol is untouched."""

    def __init__(self, inner, fence: "HostFence"):
        self._inner = inner
        self._fence = fence

    def append(self, *a, **kw):
        self._fence.check()
        return self._inner.append(*a, **kw)

    def append_acks(self, *a, **kw):
        self._fence.check()
        return self._inner.append_acks(*a, **kw)

    def append_heap(self, *a, **kw):
        self._fence.check()
        return self._inner.append_heap(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class HostFence:
    """One host's epoch check at its journal durability gate.

    ``install(eng)`` wraps the engine's journal ATTACH point (not one
    segment), so every rotation's fresh segment appends through the
    check too.  The check routes the lease-table read through the
    chaos layer when attached: a zombified host sees a FROZEN snapshot
    of its own record — it cannot watch its epoch get bumped, so it
    keeps acking (the split-brain ingredient the fence point +
    fenced-suffix accounting make safe); the heal surfaces
    :class:`StaleHostError` to its next append."""

    def __init__(self, table: HostLeaseTable, host_id: int, epoch: int,
                 chaos=None):
        self.table = table
        self.host_id = int(host_id)
        self.epoch = int(epoch)
        self.chaos = chaos if chaos is not None else table.chaos
        self.fenced = 0  # appends refused typed through this fence

    def install(self, eng) -> None:
        fence = self
        orig_attach = eng.attach_journal

        def fenced_attach(journal):
            orig_attach(None if journal is None
                        else _FencedHostJournal(journal, fence))

        eng.attach_journal = fenced_attach
        if eng.journal is not None:
            orig_attach(_FencedHostJournal(eng.journal, fence))

    def check(self) -> None:
        rec = self.table.read(self.host_id)
        if self.chaos is not None:
            rec = self.chaos.lease_view(self.host_id, rec)
        live = rec is not None and int(rec["epoch"]) == self.epoch
        if not live:
            self.fenced += 1
            _STATS["fenced_host_acks"] += 1
            obs.record_event("host.zombie_fenced", host=self.host_id,
                             epoch=self.epoch,
                             table_epoch=None if rec is None
                             else int(rec["epoch"]))
            raise StaleHostError(
                f"host {self.host_id} lease epoch {self.epoch} was "
                "bumped (namespace adopted by a surviving host): this "
                "write is fenced — a zombie host must not fork its "
                "journal")


def count_fenced_suffix(fence: tuple[str, int] | None) -> int:
    """Complete CRC-valid frames past a fence point ``(path, size)``:
    writes a zombie host durably appended (and acked) AFTER its epoch
    bump — the provably-rejected set the drill pins against
    ``fenced_acks_merged``.  Trailing torn bytes are an unacked
    in-flight append, not counted.  (The replica plane's
    ``count_fenced_suffix`` walk, shared shape.)"""
    if fence is None:
        return 0
    path, base = fence
    try:
        with open(path, "rb") as f:
            f.seek(int(base))
            blob = f.read()
    except OSError:
        return 0
    n = 0
    pos = 0
    size = len(blob)
    while pos + J._HDR.size <= size:
        length, crc = J._HDR.unpack_from(blob, pos)
        end = pos + J._HDR.size + length
        if length > J.MAX_PAYLOAD or end > size:
            break
        if zlib.crc32(blob[pos + J._HDR.size:end]) != crc:
            break
        n += 1
        pos = end
    return n


# ---------------------------------------------------------------------------
# The epoch-versioned ownership map
# ---------------------------------------------------------------------------


class OwnershipLog:
    """Append-only CRC-framed adoption log (``ownership.maplog``) —
    the durable ownership map.  Every adoption appends a ``begin``
    frame (before the dead chain is touched) and a ``done`` frame
    (after the window re-seed), each ``{version, dead, adopter,
    epoch, state}`` with a monotonic version; :meth:`load` folds the
    frames into the current overlay plus the in-flight set, so an
    adopter crashing mid-adoption leaves a durable marker that
    :meth:`HostFailover.resume` completes.  A torn trailing frame is
    a crashed append — truncated-by-ignoring, the journal's own
    torn-tail rule."""

    def __init__(self, directory: str):
        self.path = os.path.join(directory, _MAPLOG)
        self._lock = threading.Lock()

    def append(self, rec: dict) -> None:
        blob = J.frame_blob(json.dumps(rec, sort_keys=True).encode())
        with self._lock:
            with open(self.path, "ab") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())

    def load(self) -> dict:
        """-> ``{"version", "overlay": {dead: adopter}, "pending":
        [(dead, adopter, epoch, fence), ...], "records"}``.
        ``overlay`` is the completed adoptions (latest version per
        dead host wins); ``pending`` the begun-but-not-done set a
        resume must finish, each carrying the fence point captured in
        its ``begin`` frame (``[relpath, size]`` or None) so the
        resume never recomputes it; a ``handback`` frame clears the
        host's overlay entry (the namespace serves itself again)."""
        try:
            with open(self.path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            blob = b""
        frames, _clean = J.iter_frames(blob)
        records = [json.loads(p) for p in frames]
        overlay: dict = {}
        open_begins: dict = {}
        version = 0
        for r in records:
            version = max(version, int(r["version"]))
            dead = int(r["dead"])
            if r["state"] == "begin":
                open_begins[dead] = r
            elif r["state"] == "done":
                open_begins.pop(dead, None)
                overlay[dead] = int(r["adopter"])
            elif r["state"] == "handback":
                open_begins.pop(dead, None)
                overlay.pop(dead, None)
        pending = [(int(r["dead"]), int(r["adopter"]), int(r["epoch"]),
                    r.get("fence"))
                   for r in open_begins.values()]
        return {"version": version, "overlay": overlay,
                "pending": pending, "records": records}


# ---------------------------------------------------------------------------
# Chain adoption
# ---------------------------------------------------------------------------


class HostFailover:
    """Failure detector + adoption orchestrator for one shared chain
    directory.  Liveness rides :meth:`detect` (or the knob-gated
    background prober, ``SHERMAN_HOST_PROBE_S``); takeover is
    :meth:`adopt`: fence-point capture -> durable ``begin`` frame ->
    epoch bump -> restore-then-replay of the dead namespace ->
    exactly-once window re-seed into the adopted front door ->
    ``done`` frame + router overlay.  Crash-resume is
    :meth:`resume`."""

    def __init__(self, directory: str, table: HostLeaseTable,
                 hosts: int, recover_kw: dict | None = None):
        self.dir = directory
        self.table = table
        self.hosts = int(hosts)
        #: kwargs forwarded into ``RecoveryPlane.recover`` for the
        #: dead namespace (batch_per_node, tcfg, group_commit_ms, ...)
        self.recover_kw = dict(recover_kw or {})
        self.log = OwnershipLog(directory)
        self.adoption_ms = 0.0
        self._seen_expired: set[int] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        _ensure_collector()

    # -- detection -----------------------------------------------------------

    def detect(self, now: float | None = None) -> list[int]:
        """Expired hosts whose namespace nobody has adopted yet.  Each
        NEW expiry fires one ``host.lease_expired`` flight event."""
        adopted = set(self.log.load()["overlay"])
        out = []
        for h in range(self.hosts):
            if h in adopted:
                continue
            if self.table.probe(h, now=now) == "expired":
                out.append(h)
                if h not in self._seen_expired:
                    self._seen_expired.add(h)
                    obs.record_event("host.lease_expired", host=h,
                                     lease_s=self.table.lease_s)
        return out

    def unadopted_dead_hosts(self, now: float | None = None) -> int:
        """The drill's zero-pin: expired hosts still awaiting
        adoption."""
        return len(self.detect(now=now))

    def start(self) -> None:
        """Knob-gated background prober (``SHERMAN_HOST_PROBE_S`` > 0
        — ships OFF): sweeps :meth:`detect` so expiries surface as
        flight events without an operator in the loop.  Detection
        only; adoption stays an explicit call (WHO adopts is a
        placement decision)."""
        cadence = C.host_probe_s()
        if cadence <= 0 or self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                self.detect()
                self._stop.wait(cadence)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="sherman-host-probe")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- adoption ------------------------------------------------------------

    def fence_point(self, dead: int) -> tuple[str, int] | None:
        """The dead host's durable journal frontier ``(live segment
        path, clean size)`` from its on-disk chain — every byte a
        zombie appends past it is the fenced suffix.  ``clean size``
        is the last complete CRC-valid frame boundary, NOT the raw
        file size: a torn in-flight tail (crash mid-append) is about
        to be truncated away by the adoption's replay, and the
        zombie's post-truncation appends land exactly at the clean
        boundary.  None when the dead host has no live segment to
        fence."""
        from sherman_tpu_torch.recovery import RecoveryPlane
        try:
            _cid, _deltas, journals = RecoveryPlane._discover(
                self.dir, host_id=int(dead))
        except FileNotFoundError:
            return None
        if not journals:
            return None
        path = journals[-1]
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return (path, 0)
        pos = len(J.MAGIC) if blob[:len(J.MAGIC)] == J.MAGIC else 0
        size = len(blob)
        while pos + J._HDR.size <= size:
            length, crc = J._HDR.unpack_from(blob, pos)
            end = pos + J._HDR.size + length
            if length > J.MAX_PAYLOAD or end > size:
                break
            if zlib.crc32(blob[pos + J._HDR.size:end]) != crc:
                break
            pos = end
        return (path, pos)

    def adopt(self, dead: int, adopter: int, *, door_factory=None,
              service=None) -> dict:
        """Take over ``dead``'s namespace onto ``adopter``.

        Protocol (every step durable before the next):

        1. capture the fence point (dead's live-segment size);
        2. append the ``begin`` frame, the fence point journaled
           inside it (crash after this is resumable, and the resume
           reuses THIS fence rather than recomputing a later one);
        3. durably raise dead's lease epoch to the journaled fence
           epoch (:meth:`HostLeaseTable.ensure_epoch`) — zombie
           appends from here land past the fence;
        4. restore-then-replay dead's chain (``RecoveryPlane.recover``
           scoped to one peer, stale sweep deferred so the fenced
           zombie segment stays on disk as evidence);
        5. ``door_factory(plane, cluster, tree, eng)`` builds + starts
           the adopted front door (run by the ADOPTER's process);
           the dead window re-seeds into it (``seed_dedup``,
           re-journaled);
        6. append the ``done`` frame, install the service overlay
           (keys of ``dead`` now route to ``adopter``), publish the
           receipt + the black-box dump.

        Returns the adoption receipt; the recovered context rides in
        under ``"context"`` for the caller to own."""
        st = self.log.load()
        version = st["version"] + 1
        # resume path re-enters with the begin frame already durable
        pend = next((p for p in st["pending"] if p[0] == int(dead)),
                    None)
        return self._run_adoption(int(dead), int(adopter), version,
                                  pend, door_factory, service)

    def resume(self, *, door_factory=None, service=None) -> list[dict]:
        """Finish every begun-but-not-done adoption in the ownership
        log — the adopter-crashed-mid-adoption exit.  Re-running the
        restore-then-replay core is safe: recover() rebuilds from the
        chain and re-bases.  The crash may have landed BETWEEN the
        begin frame and the epoch bump, so the resume re-asserts the
        journaled epoch (``ensure_epoch`` — a no-op when the bump
        already happened, a repair when it did not: without it the
        zombie's fence check and renewals would still pass while the
        adopter serves the namespace).  The fence point is the one
        captured in the begin frame, never recomputed — a zombie may
        have appended between the crash and the resume, and those
        frames belong to the fenced suffix too."""
        out = []
        for pend in self.log.load()["pending"]:
            version = self.log.load()["version"] + 1
            out.append(self._run_adoption(pend[0], pend[1], version,
                                          pend, door_factory, service))
        return out

    def handback(self, dead: int, router=None) -> int:
        """Explicit hand-back: the adopted namespace returns to its
        (restarted) owner.  Durably appends a ``handback`` frame to
        the ownership log (clearing the overlay, so ``detect`` can
        see the host again), clears the lease record's adopter stamp
        and bumps the epoch (:meth:`HostLeaseTable.handback` — the
        returning host re-registers into a FRESH generation, so no
        fence the adopter raised ever passes again), and drops the
        in-memory router overlay entry when a router is given.  The
        caller owns rebuilding the host's front door before routing
        traffic back.  Crash-retry safe: the log frame lands before
        the lease record changes, and both halves are idempotent.
        Returns the lease epoch a re-register now joins."""
        dead = int(dead)
        st = self.log.load()
        rec = self.table.read(dead)
        stamped = rec is not None and "adopter" in rec
        if dead not in st["overlay"] and not stamped:
            raise StateError(
                f"host {dead} is not adopted; nothing to hand back")
        if dead in st["overlay"]:
            self.log.append({"version": st["version"] + 1, "dead": dead,
                             "adopter": int(st["overlay"][dead]),
                             "epoch": (int(rec["epoch"]) + 1
                                       if rec is not None else 0),
                             "state": "handback"})
        epoch = self.table.handback(dead)
        self._seen_expired.discard(dead)
        if router is not None:
            router.handback(dead)
        obs.record_event("host.handback", host=dead, epoch=epoch)
        return epoch

    def _fence_field(self, fence: tuple[str, int] | None):
        """Fence point -> its begin-frame shape (path made relative to
        the chain directory, so the log moves with the directory)."""
        if fence is None:
            return None
        path, size = fence
        return [os.path.relpath(str(path), self.dir), int(size)]

    def _fence_from_field(self, field) -> tuple[str, int] | None:
        if field is None:
            return None
        rel, size = field
        return (os.path.join(self.dir, str(rel)), int(size))

    def _run_adoption(self, dead: int, adopter: int, version: int,
                      pending, door_factory, service) -> dict:
        from sherman_tpu_torch.recovery import RecoveryPlane
        t0 = time.perf_counter()
        if pending is None:
            # fresh adoption: capture the fence, journal it inside the
            # durable intent marker, then bump the epoch — a crash
            # between any two steps leaves either nothing (retry from
            # detect) or a pending begin frame (resume)
            fence = self.fence_point(dead)
            rec = self.table.read(dead)
            epoch_new = (int(rec["epoch"]) if rec is not None else 0) + 1
            self.log.append({"version": version, "dead": dead,
                             "adopter": adopter, "epoch": epoch_new,
                             "state": "begin",
                             "fence": self._fence_field(fence)})
        else:
            _d, _a, epoch_new, fence_field = pending
            fence = self._fence_from_field(fence_field)
        # idempotent toward the journaled epoch: on the fresh path
        # this IS the bump; on resume it repairs the crash window
        # between the begin frame and the bump
        self.table.ensure_epoch(dead, epoch_new, adopter=adopter)
        obs.record_event("host.adopt_begin", dead=dead, adopter=adopter,
                         epoch=epoch_new, version=version,
                         fence=None if fence is None else
                         [os.path.basename(fence[0]), fence[1]])
        plane, cluster, tree, eng, rec = RecoveryPlane.recover(
            self.dir, host_id=dead, hosts=self.hosts,
            sweep_stale=False, **self.recover_kw)
        server = None
        seeded = 0
        if door_factory is not None:
            server = door_factory(plane, cluster, tree, eng)
            # second-crash durability: the re-journaled ack batch
            # lands in the ADOPTED chain's fresh segment
            seeded = server.seed_dedup(plane.dedup_window,
                                       rejournal=True)
        self.log.append({"version": version, "dead": dead,
                         "adopter": adopter, "epoch": epoch_new,
                         "state": "done"})
        if service is not None:
            service.adopt(dead,
                          server if server is not None
                          else service.servers[dead],
                          plane=plane, adopter=adopter)
        ms = (time.perf_counter() - t0) * 1e3
        self.adoption_ms = round(ms, 1)
        _STATS["adoptions"] += 1
        _STATS["adoption_ms"] = self.adoption_ms
        obs.record_event("host.adopt_done", dead=dead, adopter=adopter,
                         epoch=epoch_new, version=version,
                         seeded=seeded, adoption_ms=self.adoption_ms)
        # the black box: an adoption is exactly the kind of incident a
        # post-mortem replays — debounced like every other trigger
        obs.auto_dump("host.adopt_done")
        return {
            "dead": dead, "adopter": adopter, "version": version,
            "epoch": epoch_new, "seeded": seeded,
            "fence": None if fence is None else
            {"segment": os.path.basename(fence[0]), "size": fence[1]},
            "recover": rec,
            "adoption_ms": self.adoption_ms,
            "context": (plane, cluster, tree, eng),
            "server": server,
        }
