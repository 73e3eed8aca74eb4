"""Write-ahead op journal — the replayable half of the recovery plane
(the port's copy of ``sherman_tpu/utils/journal.py``: the same frames,
byte for byte, so either package replays the other's segments).

Checkpoints (``utils/checkpoint.py``) bound the loss window to
"everything since the last save".  This module closes that window: an
append-only journal of CRC-framed, length-prefixed **batch records**,
one per acknowledged engine write op (op kind + the rows it actually
applied), fsync'd before the op is acknowledged.  Recovery is then

    restore checkpoint chain  +  replay journal in record order

and the loss of *acknowledged* ops (RPO) is zero: an op is acked only
after its record is durable, and replay re-applies records onto the
restored pool.  Replay is convergent because the engine's write ops are
idempotent in-order (insert is an upsert — last writer per key wins;
delete clears; re-running a prefix that already landed re-produces the
same state), so segments may safely be replayed from any checkpoint at
or before their first record.

Frame format (little-endian, after the 8-byte file magic)::

    [u32 length | u32 crc32(payload) | payload]
    payload = u8 kind | u8 flags | u8 x 2 pad | u32 nrows
              (| rid u64 when flags & FLAG_RID)
              | keys u64[n] (| vals u64[n])

Format v2 (magic ``SHJRNL02``): the second header byte is a
FLAGS field; ``FLAG_RID`` marks a client request id (u64) riding the
record — the exactly-once plane's join key (the serving front door's
dedup window; ``serve.py`` comes to the port with ROADMAP.md item 6c).  v1 segments (``SHJRNL01``) wrote that byte as zero
pad, and readers decode them with flags forced to 0: old journals
replay cleanly, just with no request ids — dedup is DISABLED for
those segments (the client-contract back-compat rule).  Appends to a
v1 segment keep writing v1 records (rid silently dropped, ack records
refused as no-ops) so one segment never mixes formats.

Ack records (``J_ACK``, v2 only): one frame carrying the CACHED
RESULTS of a batch of client write requests — per ack ``(rid, tenant,
op kind, ok-per-key bitmap)`` — appended by the serving front door
after the engine batch record and BEFORE any future resolves (the
same durability gate).  Replay hands them to ``ack_sink`` so
``RecoveryPlane.recover`` reconstructs the exactly-once dedup window:
a write retried across a cold crash re-acks its ORIGINAL result
instead of re-applying.

Torn-tail contract (crash mid-append): a frame that runs past EOF, or
whose CRC fails **at the very tail**, is a partially flushed append —
readers truncate it away and the journal stays usable.  A CRC failure with more bytes *after* the frame is
content corruption, not a torn append: readers raise the typed
:class:`JournalCorruptError` — a corrupt journal must never silently
replay wrong rows (``tests/test_fuzz.py`` storms both cases).

Group commit (``Journal(sync=True, group_commit_ms=...)``): bounded-
delay batched acks — multiple ops' records coalesce into one fsync
before ANY of their acks release, so RPO stays zero by construction
while the fsync cost amortizes across the group (the prerequisite for
a pipelined or multi-client write path, which a per-op fsync would
re-serialize).  See the :class:`Journal` docstring for the
leader/follower protocol and the measured ack-latency tradeoff.

Accounting: each :class:`Journal` counts its own ``appends``, ``rows``
and ``fsyncs`` (real fsyncs — under group commit ``appends / fsyncs`` is
the coalescing ratio).  The process-wide ``journal.*`` counters total
every segment (appends, rows, bytes, fsyncs, truncated tails, replayed
records and rows); a failed fsync is a ``journal.poisoned`` flight event
and a torn tail a ``journal.torn_tail`` one; the live segment's on-disk
size is the memory accountant's ``host_journal_bytes`` source.
"""

from __future__ import annotations

import os
import struct
import threading
import weakref
import zlib

import numpy as np

from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ConfigError, ShermanError, StateError

_OBS_APPENDS = obs.counter("journal.appends")
_OBS_ROWS = obs.counter("journal.rows")
_OBS_BYTES = obs.counter("journal.bytes")
_OBS_FSYNCS = obs.counter("journal.fsyncs")
_OBS_TORN = obs.counter("journal.truncated_tails")
_OBS_RP_RECORDS = obs.counter("journal.replayed_records")
_OBS_RP_ROWS = obs.counter("journal.replayed_rows")

MAGIC = b"SHJRNL02"      # format v2: flags byte + optional request id
MAGIC_V1 = b"SHJRNL01"   # format v1: no flags (decoded with flags=0)
_HDR = struct.Struct("<II")          # length, crc32(payload)
_PAY = struct.Struct("<BBxxI")       # kind, flags, nrows
_ACK = struct.Struct("<QBBH")        # rid, op kind, tenant len, n_ops
_RID = struct.Struct("<Q")

FLAG_RID = 1     # payload carries a client request id after the header

# ack-entry op-byte flag: the entry carries payload PROVENANCE
# — one u64 handle per op (slab address + slab version packed by
# models/value_heap.pack_handles; 0 = no provenance for that op) after
# the ok bitmap.  Old readers never see it (old records never set the
# bit) and old records decode unchanged (4-tuples), so the wire format
# stays back-compatible in both directions.
ACK_PROV = 0x80

J_UPSERT = 1     # keys + values (engine insert / mixed write rows)
J_DELETE = 2     # keys only
J_HEAP_PUT = 3   # value-heap slab writes: keys + handles + payload blob
J_HEAP_FREE = 4  # value-heap slab frees: keys + handles
J_ACK = 5        # client-contract ack batch: (rid, tenant, op, ok bits)
KINDS = (J_UPSERT, J_DELETE, J_HEAP_PUT, J_HEAP_FREE, J_ACK)
# kinds whose payload is keys + one u64 value lane (shared layout)
_TWO_LANE = (J_UPSERT, J_HEAP_FREE)

# One frame is one engine-op batch; anything claiming more than this is
# a corrupt length word, not a real record (the engine chunks batches
# far below it).
MAX_PAYLOAD = 1 << 30

# indirection for tests (monkeypatching os.fsync itself would also
# intercept numpy/torch internals)
_fsync = os.fsync


class JournalCorruptError(ShermanError, RuntimeError):
    """A journal frame failed its CRC (or framing) with further bytes
    following it — content corruption, not a torn tail.  Replay refuses
    rather than applying rows it cannot trust."""


class JournalSyncError(ShermanError, RuntimeError):
    """An fsync on this journal failed, poisoning it: on Linux a failed
    fsync CONSUMES the writeback error and may drop the dirty pages, so
    a retried fsync on the same fd can return success without the
    records ever reaching disk — releasing an ack on that retry would
    be silent RPO > 0.  Every append after the failure raises this
    (chained to the original OSError); rotate to a fresh segment
    (``RecoveryPlane._rotate_journal``) to resume."""


def encode_record(kind: int, keys, values=None, rid=None) -> bytes:
    """One framed record (header + payload) for ``append``/tests.
    ``rid`` (optional client request id, u64) rides the v2 flags
    field — see the module docstring's exactly-once contract."""
    if kind not in KINDS or kind in (J_HEAP_PUT, J_ACK):
        raise ConfigError(f"unknown journal record kind {kind}"
                          if kind not in (J_HEAP_PUT, J_ACK) else
                          "J_HEAP_PUT/J_ACK records have their own "
                          "encoders: encode_heap_record / "
                          "encode_ack_record")
    keys = np.ascontiguousarray(keys, np.uint64)
    flags = 0 if rid is None else FLAG_RID
    payload = _PAY.pack(kind, flags, keys.size)
    if rid is not None:
        payload += _RID.pack(int(rid) & 0xFFFFFFFFFFFFFFFF)
    payload += keys.tobytes()
    if kind in _TWO_LANE:
        values = np.ascontiguousarray(values, np.uint64)
        if values.shape != keys.shape:
            raise ConfigError("journal upsert needs one value per key")
        payload += values.tobytes()
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def encode_ack_record(acks) -> bytes:
    """One framed ack-batch record: ``acks`` is a sequence of
    ``(rid, tenant, op_kind, ok)`` with ``ok`` a bool array (one bit
    per submitted op of the ORIGINAL request), optionally extended to
    ``(rid, tenant, op_kind, ok, handles)`` where ``handles`` (u64,
    one per op; 0 = none) is payload provenance for heap writes — the
    slab address + version the acked payload landed at (flagged with
    :data:`ACK_PROV` in the op byte; see the flag's comment).  One
    frame covers every client write a flush coalesced, so the
    exactly-once plane costs one extra append (not one per request)
    per write batch."""
    n = len(acks)
    if n == 0 or n > 0xFFFFFFFF:
        raise ConfigError(f"ack record wants 1..2^32-1 acks, got {n}")
    payload = _PAY.pack(J_ACK, 0, n)
    for entry in acks:
        rid, tenant, op, ok = entry[:4]
        handles = entry[4] if len(entry) > 4 else None
        tb = str(tenant).encode("utf-8")
        if len(tb) > 255:
            raise ConfigError(f"tenant name over 255 bytes: {tenant!r}")
        ok = np.ascontiguousarray(ok, bool)
        if ok.size > 0xFFFF:
            raise ConfigError(
                f"ack result of {ok.size} ops exceeds the u16 bound")
        if op not in (J_UPSERT, J_DELETE, J_HEAP_PUT):
            raise ConfigError(f"ack op kind {op}: want a write kind")
        opb = int(op)
        hb = b""
        if handles is not None:
            handles = np.ascontiguousarray(handles, np.uint64)
            if handles.shape != ok.shape:
                raise ConfigError(
                    "ack provenance wants one handle per op")
            opb |= ACK_PROV
            hb = handles.tobytes()
        payload += _ACK.pack(int(rid) & 0xFFFFFFFFFFFFFFFF, opb,
                             len(tb), ok.size)
        payload += tb + np.packbits(ok).tobytes() + hb
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def _decode_acks(body: bytes, n: int, off: int):
    """-> [(rid, tenant, op_kind, ok bool[n_ops]), ...] — entries
    flagged :data:`ACK_PROV` come back as 5-tuples with a trailing
    ``handles`` u64[n_ops] provenance lane (star-unpack tolerant:
    ``rid, tenant, op, ok, *prov = entry``)."""
    out = []
    pos = 0
    for _ in range(n):
        if pos + _ACK.size > len(body):
            raise JournalCorruptError(
                f"journal record at byte {off}: ack batch overruns "
                "its body")
        rid, op, tlen, nops = _ACK.unpack_from(body, pos)
        pos += _ACK.size
        prov = bool(op & ACK_PROV)
        op &= ~ACK_PROV
        nbytes = (nops + 7) // 8 + (nops * 8 if prov else 0)
        if pos + tlen + nbytes > len(body):
            raise JournalCorruptError(
                f"journal record at byte {off}: ack entry overruns "
                "its body")
        tenant = body[pos: pos + tlen].decode("utf-8")
        pos += tlen
        nok = (nops + 7) // 8
        ok = np.unpackbits(
            np.frombuffer(body[pos: pos + nok], np.uint8),
            count=nops).astype(bool)
        pos += nok
        if prov:
            handles = np.frombuffer(
                body[pos: pos + nops * 8], np.uint64).copy()
            pos += nops * 8
            out.append((int(rid), tenant, int(op), ok, handles))
        else:
            out.append((int(rid), tenant, int(op), ok))
    if pos != len(body):
        raise JournalCorruptError(
            f"journal record at byte {off}: {len(body) - pos} trailing "
            "bytes after the last ack")
    return out


def encode_heap_record(kind: int, keys, handles, payloads) -> bytes:
    """Value-heap put record: keys + handles + per-key byte lengths +
    concatenated payload blob (``payloads``: list of bytes).  The
    handle encodes the slab address, so replay rewrites every payload
    AT its recorded slab — bit-identical heap content after
    restore+replay."""
    if kind != J_HEAP_PUT:
        raise ConfigError(f"encode_heap_record wants J_HEAP_PUT, "
                          f"got {kind}")
    keys = np.ascontiguousarray(keys, np.uint64)
    handles = np.ascontiguousarray(handles, np.uint64)
    if handles.shape != keys.shape or len(payloads) != keys.size:
        raise ConfigError("heap record needs one handle+payload per key")
    lens = np.asarray([len(b) for b in payloads], np.uint32)
    blob = b"".join(bytes(b) for b in payloads)
    payload = (_PAY.pack(kind, 0, keys.size) + keys.tobytes()
               + handles.tobytes() + lens.tobytes() + blob)
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def _decode_payload(payload: bytes, off: int, fmt: int = 2):
    """payload bytes -> (kind, keys, aux, rid); raises on bad shape.
    ``aux`` is the value lane (u64, or None for J_DELETE), except
    J_HEAP_PUT where it is ``(handles u64[n], payloads list[bytes])``
    and J_ACK where ``keys`` is None and ``aux`` the decoded ack list.
    ``fmt`` is the segment format (1 = pre-rid: the flags byte was pad,
    decoded as 0 — dedup disabled for that segment)."""
    kind, flags, n = _PAY.unpack_from(payload)
    if fmt < 2:
        flags = 0
    rid = None
    body = payload[_PAY.size:]
    if flags & FLAG_RID:
        if len(body) < _RID.size:
            raise JournalCorruptError(
                f"journal record at byte {off}: rid flag with no rid")
        rid = _RID.unpack_from(body)[0]
        body = body[_RID.size:]
    if kind == J_ACK:
        return kind, None, _decode_acks(body, n, off), rid
    if kind == J_HEAP_PUT:
        fixed = n * 8 * 2 + n * 4
        if len(body) < fixed:
            raise JournalCorruptError(
                f"journal record at byte {off}: heap-put nrows={n} "
                f"does not fit its {len(body)}-byte body")
        keys = np.frombuffer(body[: n * 8], np.uint64).copy()
        handles = np.frombuffer(body[n * 8: n * 16], np.uint64).copy()
        lens = np.frombuffer(body[n * 16: fixed], np.uint32)
        blob = body[fixed:]
        if int(lens.sum()) != len(blob):
            raise JournalCorruptError(
                f"journal record at byte {off}: heap-put blob length "
                f"{len(blob)} does not match its length table")
        payloads = []
        pos = 0
        for ln in lens.tolist():
            payloads.append(blob[pos: pos + ln])
            pos += ln
        return kind, keys, (handles, payloads), rid
    want = n * 8 * (2 if kind in _TWO_LANE else 1)
    if kind not in KINDS or len(body) != want:
        raise JournalCorruptError(
            f"journal record at byte {off}: kind={kind} nrows={n} does "
            f"not match its {len(body)}-byte body")
    keys = np.frombuffer(body[: n * 8], np.uint64).copy()
    vals = (np.frombuffer(body[n * 8:], np.uint64).copy()
            if kind in _TWO_LANE else None)
    return kind, keys, vals, rid


class Journal:
    """Appender for one journal segment file.

    ``sync=True`` (default) makes every append durable before it
    returns — the RPO-zero contract; ``sync=False`` trades durability
    of the last few records for throughput (still torn-tail-safe).
    Thread-safe appends; one writer process per file.

    **Group commit** (``group_commit_ms > 0``, with ``sync=True``):
    bounded-delay batched acks.  An append still BLOCKS until an fsync
    covers its record — RPO zero holds by construction — but instead
    of one fsync per record, the first committer of a group becomes
    the LEADER: it holds the commit open for up to ``group_commit_ms``
    so concurrent appends can join (their records land in the OS file
    during the window), then issues ONE fsync covering everything
    written and releases every joined ack at once.  A per-op fsync
    re-serializes any pipelined or multi-client write path on the
    fsync latency; group commit amortizes it at the cost of up to
    ``group_commit_ms`` of added ack latency — the measured tradeoff
    is published by ``python -m sherman_tpu_torch.ckpt_bench`` (acks/s,
    added ack latency, acks per fsync).  ``fsyncs`` counts REAL fsyncs,
    so ``appends / fsyncs`` is the measured coalescing ratio.

    The window only opens UNDER CONTENTION: a leader with no other
    appender in flight (tracked at ``append`` entry) skips the wait
    entirely, so a lone writer pays per-op-fsync latency — not
    ``group_commit_ms`` per ack — while concurrent writers always get
    the full window to coalesce into.

    Failure contract: a raising fsync POISONS the journal (see
    :class:`JournalSyncError`) — the failed append raises, every
    parked follower raises, and every later append raises until a
    fresh segment is opened.  Retrying the fsync instead would be
    unsound: Linux reports a writeback error to ONE fsync caller and
    may drop the dirty pages, so the retry can spuriously succeed
    over records that never hit disk.
    """

    def __init__(self, path: str, sync: bool = True,
                 group_commit_ms: float = 0.0):
        self.path = path
        self.sync = bool(sync)
        self.group_commit_ms = float(group_commit_ms)
        self._lock = threading.Lock()
        # per-instance accounting: a receipt needs THIS segment's
        # appends/fsyncs to publish its acks-per-fsync coalescing ratio
        self.appends = 0
        self.rows = 0
        self.fsyncs = 0
        # group-commit state (guarded by _lock via the condition):
        # records are sequenced as they hit the OS file; an ack may
        # only release once _synced_seq covers its sequence number
        self._commit_cv = threading.Condition(self._lock)
        self._written_seq = 0
        self._synced_seq = 0
        self._leader = False
        self._failed: BaseException | None = None  # fsync poison
        # appenders currently inside append() (own lock: counted at
        # ENTRY, before the main lock, so writers blocked on it still
        # register) — a leader holds the commit window open only when
        # this shows company; a lone writer fsyncs immediately
        self._entrants = 0
        self._entrants_lock = threading.Lock()
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        # format pinning: a fresh segment is v2; appending to an
        # existing segment keeps ITS format (one segment never mixes —
        # a v1 segment's appends stay rid-less and ack records are
        # refused as no-ops: dedup disabled for that segment, the
        # back-compat contract)
        self.format = 2
        if not fresh:
            with open(path, "rb") as rf:
                head = rf.read(len(MAGIC))
            if head == MAGIC_V1:
                self.format = 1
        self._f = open(path, "ab")
        # the memory accountant's host source: the live segment's on-disk
        # bytes as ``device.host_journal_bytes`` (re-registering the one
        # name is the rotation contract: a fresh segment supersedes)
        _ref = weakref.ref(self)
        obs.get_accountant().register(
            "journal", (lambda r=_ref: (
                os.path.getsize(r().path)
                if r() is not None and os.path.exists(r().path) else 0)),
            kind="host")
        if fresh:
            self._f.write(MAGIC)
            self._f.flush()
            if self.sync:
                _fsync(self._f.fileno())
                # make the DIRECTORY ENTRY durable too: records fsync'd
                # into a file whose name is lost to power failure are
                # RPO > 0 that recovery cannot even detect
                dfd = os.open(os.path.dirname(os.path.abspath(path)),
                              os.O_RDONLY)
                try:
                    _fsync(dfd)
                finally:
                    os.close(dfd)

    def append(self, kind: int, keys, values=None, rid=None) -> int:
        """Append one batch record; returns bytes written.  Durable on
        return when ``sync`` (the ack gate for RPO zero) — via one
        fsync per record, or one fsync per group under
        ``group_commit_ms``.  ``rid`` tags the record with a client
        request id (v2 segments; silently dropped on a v1 segment —
        dedup disabled there by the back-compat contract)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        if keys.size == 0:
            return 0  # nothing applied: no record
        rec = encode_record(kind, keys, values,
                            rid=rid if self.format >= 2 else None)
        return self._append_rec(rec, int(keys.size))

    def append_acks(self, acks) -> int:
        """Append one client-contract ack-batch record (see
        :func:`encode_ack_record`) under the same durability gate as
        :meth:`append` — the front door calls this AFTER the engine
        batch record and BEFORE resolving any of the batch's futures,
        so a crash can lose an unacked result but never an acked one.
        No-op (returns 0) on an empty batch or a v1 segment."""
        if not acks or self.format < 2:
            return 0
        rec = encode_ack_record(acks)
        return self._append_rec(rec, len(acks))

    def sync_now(self) -> None:
        """Push a covering fsync for everything appended so far — the
        graceful-drain epilogue (``ShermanServer.drain``).  Redundant
        under ``sync=True`` (every ack already gated on a covering
        fsync); for a ``sync=False`` journal it is the only flush."""
        with self._lock:
            if self._f.closed:
                return
            if self._failed is not None:
                raise JournalSyncError(
                    f"journal {self.path} poisoned by an earlier fsync "
                    "failure; rotate to a fresh segment") from self._failed
            self._f.flush()
            _fsync(self._f.fileno())
            self._synced_seq = self._written_seq
            _OBS_FSYNCS.inc()
            self.fsyncs += 1

    def append_heap(self, kind: int, keys, handles, payloads) -> int:
        """Append one value-heap batch record (keys + handles + payload
        bytes; see :func:`encode_heap_record`) under the same
        durability/group-commit contract as :meth:`append`."""
        keys = np.ascontiguousarray(keys, np.uint64)
        if keys.size == 0:
            return 0
        rec = encode_heap_record(kind, keys, handles, payloads)
        return self._append_rec(rec, int(keys.size))

    def _append_rec(self, rec: bytes, nrows: int) -> int:
        with self._entrants_lock:
            self._entrants += 1
        try:
            with self._lock:
                if self._f.closed:
                    raise StateError(f"journal {self.path} is closed")
                if self._failed is not None:
                    raise JournalSyncError(
                        f"journal {self.path} poisoned by an earlier "
                        "fsync failure; rotate to a fresh segment") \
                        from self._failed
                self._f.write(rec)
                self._f.flush()
                self._written_seq += 1
                seq = self._written_seq
                # per-instance receipt counters under the SAME lock as
                # the sequence they describe (concurrent group-commit
                # appenders would otherwise lose increments)
                self.appends += 1
                self.rows += nrows
                if self.sync and self.group_commit_ms <= 0:
                    try:
                        _fsync(self._f.fileno())
                    except BaseException as e:
                        self._failed = e
                        obs.record_event("journal.poisoned",
                                         path=self.path, error=repr(e))
                        raise
                    self._synced_seq = seq
                    _OBS_FSYNCS.inc()
                    self.fsyncs += 1
            if self.sync and self.group_commit_ms > 0:
                self._commit(seq)
        finally:
            with self._entrants_lock:
                self._entrants -= 1
        _OBS_APPENDS.inc()
        _OBS_ROWS.inc(nrows)
        _OBS_BYTES.inc(len(rec))
        return len(rec)

    def _commit(self, seq: int) -> None:
        """Block until an fsync covers record ``seq`` (leader/follower
        group commit; see the class docstring)."""
        with self._commit_cv:
            while self._synced_seq < seq:
                if self._failed is not None:
                    # a leader's fsync failed after our record was
                    # written: the kernel may have dropped our dirty
                    # pages and consumed the error, so NO retry can
                    # prove durability — raise, never ack
                    raise JournalSyncError(
                        f"journal {self.path} poisoned by an fsync "
                        "failure; this record is NOT durable") \
                        from self._failed
                if self._leader:
                    # a leader's commit is in flight: its fsync will
                    # cover this record iff it was written before the
                    # leader snapshots; either way the notify wakes us
                    self._commit_cv.wait(1.0)
                    continue
                self._leader = True
                if self._entrants > 1:
                    # the commit window: release the lock so concurrent
                    # appends can land and join this group.  Skipped
                    # when no other appender is in flight — a lone
                    # writer must not pay the window per ack for
                    # coalescing that cannot happen.
                    self._commit_cv.wait(self.group_commit_ms / 1e3)
                cover = self._written_seq
                try:
                    if not self._f.closed:
                        try:
                            _fsync(self._f.fileno())
                        except BaseException as e:
                            # advance NOTHING and poison: a raising
                            # fsync must not release any follower's
                            # ack, now or via a spuriously-succeeding
                            # retry (silent RPO > 0 — the exact loss
                            # the per-op path cannot produce)
                            self._failed = e
                            obs.record_event("journal.poisoned",
                                             path=self.path,
                                             error=repr(e),
                                             group_commit=True)
                            raise
                        _OBS_FSYNCS.inc()
                        self.fsyncs += 1
                    self._synced_seq = max(self._synced_seq, cover)
                finally:
                    self._leader = False
                    self._commit_cv.notify_all()

    def stats(self) -> dict:
        """Per-instance accounting snapshot: {appends, rows, fsyncs,
        appends_per_fsync} — the front door's durability receipt
        (each append covers one engine batch record, so client write
        acks per fsync = acked requests / fsyncs on the caller's
        side)."""
        return {
            "appends": self.appends,
            "rows": self.rows,
            "fsyncs": self.fsyncs,
            "appends_per_fsync": (self.appends / self.fsyncs
                                  if self.fsyncs else None),
        }

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                if self.sync and self._failed is None:
                    # a poisoned journal skips the final fsync: it
                    # could spuriously succeed over dropped pages, and
                    # parked followers raise off _failed regardless
                    _fsync(self._f.fileno())
                    # release any followers parked on the condition:
                    # the final fsync covered everything written
                    self._synced_seq = self._written_seq
                self._f.close()
            self._commit_cv.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, truncate_torn: bool = False,
                 with_rids: bool = False) -> list[tuple]:
    """Parse a segment -> [(kind, keys, values|None), ...] — or
    4-tuples ``(kind, keys, values, rid)`` when ``with_rids`` (the
    exactly-once consumers; rid is None on v1 segments and untagged
    records).

    Applies the torn-tail contract (see module docstring):
    partially-appended tail frames are dropped (and physically truncated
    from the file when ``truncate_torn`` — recovery does this so the
    next appender starts from a clean frame boundary); mid-file
    corruption raises :class:`JournalCorruptError`.
    """
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < len(MAGIC):
        # a file torn inside the magic itself: an append never succeeded
        _truncate(path, 0, len(blob), truncate_torn)
        return []
    if blob[: len(MAGIC)] == MAGIC:
        fmt = 2
    elif blob[: len(MAGIC)] == MAGIC_V1:
        fmt = 1  # pre-rid segment: flags byte decodes as 0
    else:
        raise JournalCorruptError(
            f"{path}: bad journal magic {blob[:8]!r}")
    out: list[tuple] = []
    off = len(MAGIC)
    size = len(blob)
    while off < size:
        if off + _HDR.size > size:
            _truncate(path, off, size, truncate_torn)  # torn header
            break
        length, crc = _HDR.unpack_from(blob, off)
        end = off + _HDR.size + length
        if length > MAX_PAYLOAD:
            if end > size or end < 0:
                # the claimed frame runs past EOF: equally consistent
                # with a torn length word — tail rule applies
                _truncate(path, off, size, truncate_torn)
                break
            raise JournalCorruptError(
                f"{path}: frame at byte {off} claims {length} bytes "
                f"(> {MAX_PAYLOAD}) with bytes following")
        if end > size:
            _truncate(path, off, size, truncate_torn)  # torn payload
            break
        payload = blob[off + _HDR.size: end]
        if zlib.crc32(payload) != crc:
            if end == size:
                # tail frame with bad CRC: torn append (length landed,
                # payload only partially)
                _truncate(path, off, size, truncate_torn)
                break
            raise JournalCorruptError(
                f"{path}: CRC mismatch at byte {off} with "
                f"{size - end} bytes following — content corruption, "
                "refusing to replay")
        row = _decode_payload(payload, off, fmt)
        out.append(row if with_rids else row[:3])
        off = end
    return out


def read_acks(path: str) -> dict:
    """Reconstruct one segment's exactly-once window:
    ``{(tenant, rid): entry}`` over every J_ACK record, in ack order
    (later entries override earlier — the front door's own last-writer
    window semantics).  Entries are the raw ack tuples
    ``(rid, tenant, op, ok[, handles])`` — provenance-bearing heap
    entries (5-tuples) carry through whole so re-encoding preserves the
    handles.  Journal rotation's ack carry-forward
    (``RecoveryPlane._rotate_journal``) reads it."""
    window: dict = {}
    for kind, _keys, aux in read_records(path):
        if kind == J_ACK:
            for entry in aux:
                window[(entry[1], entry[0])] = entry
    return window


def crc_of_range(path: str, start: int, end: int) -> int:
    """CRC32 of the raw segment bytes ``[start, end)`` — the anti-
    entropy audit's ground truth.  A follower's tailer accumulates the
    same rolling CRC over every byte it CONSUMED; re-reading the range
    from the primary's file must reproduce it exactly, or the follower
    applied bytes the chain never shipped (divergence, not lag)."""
    with open(path, "rb") as f:
        f.seek(max(0, int(start)))
        crc = 0
        left = int(end) - int(start)
        while left > 0:
            chunk = f.read(min(left, 1 << 20))
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            left -= len(chunk)
    return crc


def frame_blob(payload: bytes) -> bytes:
    """One journal-framed blob: ``[u32 len | u32 crc32 | payload]`` —
    the same ``_HDR`` frame every segment record rides, reused by the
    host-failure plane's durable control records (lease heartbeats and
    the ownership map of the reference's ``hostlease.py``) so their
    corruption discipline is the journal's own."""
    payload = bytes(payload)
    if len(payload) > MAX_PAYLOAD:
        raise ConfigError(f"frame payload {len(payload)} B > MAX_PAYLOAD")
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def unframe_blob(blob: bytes) -> bytes:
    """Decode exactly one :func:`frame_blob` frame -> payload.  Raises
    :class:`JournalCorruptError` on a short header, a length that
    disagrees with the blob, or a CRC mismatch — torn and corrupt
    records are the same typed refusal."""
    if len(blob) < _HDR.size:
        raise JournalCorruptError(
            f"framed blob of {len(blob)} B is shorter than the header")
    length, crc = _HDR.unpack_from(blob, 0)
    end = _HDR.size + length
    if length > MAX_PAYLOAD or end > len(blob):
        raise JournalCorruptError(
            f"framed blob claims {length} B payload with "
            f"{len(blob) - _HDR.size} B present — torn record")
    payload = blob[_HDR.size:end]
    if zlib.crc32(payload) != crc:
        raise JournalCorruptError("framed blob CRC mismatch — content "
                                  "corruption, refusing to decode")
    return payload


def iter_frames(blob: bytes):
    """Walk consecutive :func:`frame_blob` frames -> (payloads, clean):
    every CRC-valid complete frame from the front, stopping at the
    first torn/invalid frame; ``clean`` is True when the walk consumed
    the whole blob.  The append-only control-log reader (ownership map
    adoptions survive an adopter crash mid-append by truncating at the
    last clean frame, exactly the journal's torn-tail rule)."""
    out = []
    pos = 0
    size = len(blob)
    while pos + _HDR.size <= size:
        length, crc = _HDR.unpack_from(blob, pos)
        end = pos + _HDR.size + length
        if length > MAX_PAYLOAD or end > size:
            break
        payload = blob[pos + _HDR.size:end]
        if zlib.crc32(payload) != crc:
            break
        out.append(payload)
        pos = end
    return out, pos == size


def _truncate(path: str, off: int, size: int, do_truncate: bool) -> None:
    """The torn-tail cut: every torn tail a reader meets passes here once,
    counted in ``journal.truncated_tails`` and recorded as a
    ``journal.torn_tail`` flight event."""
    _OBS_TORN.inc()
    obs.record_event("journal.torn_tail", path=path, at_byte=off,
                     dropped_bytes=size - off, truncated=do_truncate)
    # a file torn inside the magic itself keeps nothing (a fresh
    # appender then rewrites the magic); otherwise cut at the last
    # clean frame boundary
    keep = off if off >= len(MAGIC) else 0
    if do_truncate and size > keep:
        with open(path, "r+b") as f:
            f.truncate(keep)
            f.flush()
            _fsync(f.fileno())


def apply_records(records, eng, ack_sink=None, stats=None) -> dict:
    """Apply decoded journal records through a (writable) engine, in
    record order — the SHARED apply core of recovery replay
    (:func:`replay` / ``RecoveryPlane.recover``) and, in the reference,
    the replication followers (``replica.py``): both planes converge on
    this one dispatch loop, so a follower applies a shipped segment
    exactly the way recovery would replay it, by construction.

    ``records`` is any iterable of decoded tuples — 3-tuples
    ``(kind, keys, aux)`` or the ``with_rids`` 4-tuples; extra
    elements are ignored.  The engine's own journaling must be
    detached by the caller (RecoveryPlane and followers both do) so
    applying does not re-journal.  ``ack_sink`` (a list) collects
    J_ACK entries in record order — the dedup-window reconstruction
    feed; with no sink they are counted and skipped.  ``stats`` (an
    existing dict) accumulates in place across calls — the follower's
    incremental tail applies batches as they ship.  Returns the stats
    dict {"records", "rows", "upserts", "deletes", "heap_puts",
    "heap_frees", "acks"}."""
    if stats is None:
        stats = {}
    for k in ("records", "rows", "upserts", "deletes", "heap_puts",
              "heap_frees", "acks"):
        stats.setdefault(k, 0)
    for rec in records:
        kind, keys, vals = rec[0], rec[1], rec[2]
        if kind == J_ACK:
            # contract plane: cached client results, no engine state —
            # replayed into the dedup window, never applied
            if ack_sink is not None:
                ack_sink.extend(vals)
            stats["acks"] += len(vals)
            stats["records"] += 1
            _OBS_RP_RECORDS.inc()
            continue
        if kind in (J_HEAP_PUT, J_HEAP_FREE):
            # value-heap records: slab rewrites at their RECORDED
            # addresses — the engine must carry an attached heap, or
            # replay cannot honor the record
            heap = getattr(eng, "value_heap", None)
            if heap is None:
                raise StateError(
                    "journal carries value-heap records but the engine "
                    "has no attached ValueHeap (attach_value_heap "
                    "before replay)")
            if kind == J_HEAP_PUT:
                handles, payloads = vals
                heap.replay_put(keys, handles, payloads)
                stats["heap_puts"] += 1
            else:
                heap.replay_free(keys, vals)
                stats["heap_frees"] += 1
        elif kind == J_UPSERT:
            eng.insert(keys, vals)
            stats["upserts"] += 1
        else:
            eng.delete(keys)
            stats["deletes"] += 1
        stats["records"] += 1
        stats["rows"] += int(keys.size)
        _OBS_RP_RECORDS.inc()
        _OBS_RP_ROWS.inc(int(keys.size))
    return stats


def replay(path: str, eng, ack_sink=None) -> dict:
    """Re-apply one segment's records through a (writable) engine, in
    record order — :func:`read_records` (torn tails truncated, the
    recovery contract) fed through the shared :func:`apply_records`
    core.  See ``apply_records`` for the sink/stats semantics."""
    return apply_records(read_records(path, truncate_torn=True), eng,
                         ack_sink=ack_sink)
