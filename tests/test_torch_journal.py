"""Port parity: the write-ahead op journal
(``sherman_tpu_torch/utils/journal.py``) against the JAX package's
``sherman_tpu/utils/journal.py``.

The reference's own journal cases (tests/test_recovery.py) run here on
the port's ``Journal`` as cases of parametrised tests: round trip, torn
tail, mid-file corruption, deterministic bytes, group-commit order,
coalescing, and the fsync poison under group and per-op commit.  Then
the two packages are held to each other: the same records give
byte-equal segments (upserts, deletes, request ids, ack batches with and
without provenance, heap puts), each package reads the other's segments
(v1 segments included), and both cut the same torn tails.  Every
comparison is exact.
"""

import os
import threading

import numpy as np
import pytest

from sherman_tpu.utils import journal as JJ
from sherman_tpu_torch.utils import journal as J

U64 = np.uint64


def _same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            if isinstance(u, np.ndarray) or u is None:
                if u is None:
                    assert v is None
                else:
                    np.testing.assert_array_equal(u, v)
            elif isinstance(u, tuple):          # heap put: handles, blobs
                np.testing.assert_array_equal(u[0], v[0])
                assert list(u[1]) == list(v[1])
            elif isinstance(u, list):           # ack entries
                assert len(u) == len(v)
                for e, f in zip(u, v):
                    assert e[:3] == f[:3]
                    for p, q in zip(e[3:], f[3:]):
                        np.testing.assert_array_equal(p, q)
            else:
                assert u == v


# ---------------------------------------------------------------------------
# The reference's journal cases on the port's Journal.
# ---------------------------------------------------------------------------

def _case_roundtrip(tmp_path):
    path = str(tmp_path / "seg.wal")
    with J.Journal(path) as j:
        k1 = np.asarray([3, 1, 2], U64)
        v1 = k1 * U64(7)
        j.append(J.J_UPSERT, k1, v1)
        j.append(J.J_DELETE, np.asarray([9], U64))
        assert j.append(J.J_UPSERT, np.asarray([], U64),
                        np.asarray([], U64)) == 0  # no empty records
    recs = J.read_records(path)
    assert len(recs) == 2
    kind, keys, vals = recs[0]
    assert kind == J.J_UPSERT
    np.testing.assert_array_equal(keys, k1)
    np.testing.assert_array_equal(vals, v1)
    kind, keys, vals = recs[1]
    assert kind == J.J_DELETE and vals is None
    np.testing.assert_array_equal(keys, [9])
    # appending to an existing segment continues after the last record
    with J.Journal(path) as j:
        j.append(J.J_DELETE, np.asarray([4], U64))
    assert len(J.read_records(path)) == 3


def _case_torn_tail(tmp_path):
    path = str(tmp_path / "seg.wal")
    with J.Journal(path) as j:
        j.append(J.J_UPSERT, np.asarray([1], U64), np.asarray([2], U64))
    rec = J.encode_record(J.J_UPSERT, np.asarray([5], U64),
                          np.asarray([6], U64))
    # every torn prefix of a crash mid-append: drop to the clean record
    for cut in (1, J._HDR.size - 1, J._HDR.size + 3, len(rec) - 1):
        good = open(path, "rb").read()
        with open(path, "ab") as f:
            f.write(rec[:cut])
        recs = J.read_records(path, truncate_torn=True)
        assert len(recs) == 1, cut
        assert os.path.getsize(path) == len(good), cut  # physically cut
    # after truncation the segment accepts appends again
    with J.Journal(path) as j:
        j.append(J.J_DELETE, np.asarray([8], U64))
    assert len(J.read_records(path)) == 2


def _case_midfile_corruption(tmp_path):
    path = str(tmp_path / "seg.wal")
    with J.Journal(path) as j:
        j.append(J.J_UPSERT, np.asarray([1], U64), np.asarray([2], U64))
        j.append(J.J_DELETE, np.asarray([3], U64))
    blob = bytearray(open(path, "rb").read())
    # flip a payload byte of the FIRST record: bytes follow -> corruption
    blob[len(J.MAGIC) + J._HDR.size + 2] ^= 0x40
    open(path, "wb").write(bytes(blob))
    with pytest.raises(J.JournalCorruptError):
        J.read_records(path)
    # bad magic is typed too
    open(path, "wb").write(b"NOTAJRNL" + bytes(blob[8:]))
    with pytest.raises(J.JournalCorruptError):
        J.read_records(path)


def _case_deterministic_bytes(tmp_path):
    blobs = []
    for i in range(2):
        path = str(tmp_path / f"seg{i}.wal")
        with J.Journal(path) as j:
            j.append(J.J_UPSERT, np.arange(1, 9, dtype=U64),
                     np.arange(11, 19, dtype=U64))
            j.append(J.J_DELETE, np.asarray([2, 4], U64))
        blobs.append(open(path, "rb").read())
    assert blobs[0] == blobs[1]


def _case_group_commit_single_writer_order(tmp_path):
    path = str(tmp_path / "gc.wal")
    want = []
    with J.Journal(path, sync=True, group_commit_ms=0.5) as j:
        for i in range(12):
            ks = np.asarray([i * 3 + 1, i * 3 + 2], U64)
            if i % 4 == 0:
                j.append(J.J_DELETE, ks)
                want.append((J.J_DELETE, ks, None))
            else:
                j.append(J.J_UPSERT, ks, ks ^ U64(0xABC))
                want.append((J.J_UPSERT, ks, ks ^ U64(0xABC)))
            # durable-on-return: the records so far parse cleanly
            assert len(J.read_records(path)) == i + 1
        assert j.appends == 12 and j.rows == 24
    _same_records(J.read_records(path), want)


def _case_group_commit_coalesces(tmp_path):
    path = str(tmp_path / "gc_mt.wal")
    j = J.Journal(path, sync=True, group_commit_ms=2.0)
    T, N = 4, 16

    def writer(t):
        for i in range(N):
            ks = np.asarray([t * 1000 + i], U64)
            j.append(J.J_UPSERT, ks, ks ^ U64(7))

    ths = [threading.Thread(target=writer, args=(t,)) for t in range(T)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
        assert not t.is_alive()
    j.close()
    recs = J.read_records(path)
    assert len(recs) == T * N
    # per-writer subsequences keep their append order
    per = {t: [] for t in range(T)}
    for kind, keys, vals in recs:
        assert kind == J.J_UPSERT
        k = int(keys[0])
        per[k // 1000].append(k % 1000)
    for t in range(T):
        assert per[t] == list(range(N)), f"writer {t} reordered"
    st = j.stats()
    assert st["appends"] == T * N
    assert st["appends_per_fsync"] >= 2.0, st


def _flaky(monkeypatch):
    real_fsync = J._fsync
    boom = {"arm": False}

    def flaky_fsync(fd):
        if boom["arm"]:
            boom["arm"] = False
            raise OSError(5, "injected EIO")
        return real_fsync(fd)

    monkeypatch.setattr(J, "_fsync", flaky_fsync)
    return boom


def _case_group_commit_fsync_failure_poisons(tmp_path, monkeypatch):
    path = str(tmp_path / "gc_eio.wal")
    j = J.Journal(path, sync=True, group_commit_ms=0.5)
    boom = _flaky(monkeypatch)
    ks = np.asarray([1, 2], U64)
    j.append(J.J_UPSERT, ks, ks)  # healthy baseline
    boom["arm"] = True
    with pytest.raises(OSError):
        j.append(J.J_UPSERT, ks + U64(10), ks)
    # poisoned: even with the device healed, no later append may ack
    with pytest.raises(J.JournalSyncError):
        j.append(J.J_DELETE, ks)
    j.close()
    # rotation (a fresh segment) is the resume path
    j2 = J.Journal(str(tmp_path / "gc_eio2.wal"), sync=True,
                   group_commit_ms=0.5)
    j2.append(J.J_DELETE, ks)
    j2.close()
    recs = J.read_records(path)
    assert [r[0] for r in recs] == [J.J_UPSERT, J.J_UPSERT]


def _case_per_op_fsync_failure_poisons(tmp_path, monkeypatch):
    path = str(tmp_path / "eio.wal")
    j = J.Journal(path, sync=True)
    boom = _flaky(monkeypatch)
    ks = np.asarray([3, 4], U64)
    j.append(J.J_UPSERT, ks, ks)
    boom["arm"] = True
    with pytest.raises(OSError):
        j.append(J.J_DELETE, ks)
    with pytest.raises(J.JournalSyncError):
        j.append(J.J_DELETE, ks)
    j.close()


_CASES = {
    "roundtrip": _case_roundtrip,
    "torn_tail": _case_torn_tail,
    "midfile_corruption": _case_midfile_corruption,
    "deterministic_bytes": _case_deterministic_bytes,
    "group_commit_single_writer_order":
        _case_group_commit_single_writer_order,
    "group_commit_coalesces": _case_group_commit_coalesces,
}
_POISON_CASES = {
    "group_commit": _case_group_commit_fsync_failure_poisons,
    "per_op": _case_per_op_fsync_failure_poisons,
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_reference_journal_cases(tmp_path, case):
    _CASES[case](tmp_path)


@pytest.mark.parametrize("commit", sorted(_POISON_CASES))
def test_fsync_failure_poisons(tmp_path, monkeypatch, commit):
    _POISON_CASES[commit](tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# Cross-package byte identity and cross reading.
# ---------------------------------------------------------------------------

def _ops(rng):
    """A mixed op stream: upserts, deletes, rid-tagged records, ack
    batches (plain and with provenance) and a heap put."""
    k = rng.integers(1, 1 << 62, 64, dtype=U64)
    v = rng.integers(0, 1 << 63, 64, dtype=U64)
    ok = rng.random(9) < 0.5
    return [
        ("append", (1, k[:40], v[:40]), {}),
        ("append", (2, k[40:52]), {}),
        ("append", (1, k[52:], v[52:]), {"rid": 0xDEAD_BEEF_0123}),
        ("append", (2, k[:3]), {"rid": 7}),
        ("append_acks", ([(11, "tenant-a", 1, ok),
                          (12, "b", 2, ok[:3]),
                          (13, "c", 3, ok[:4],
                           np.arange(4, dtype=U64) + U64(1 << 40))],), {}),
        ("append_heap", (3, k[:3], v[:3], [b"x", b"", b"hello"]), {}),
        ("append", (4, k[3:6], v[3:6]), {}),
    ]


def _write(mod, path, ops, **kw):
    with mod.Journal(path, **kw) as j:
        for name, args, akw in ops:
            getattr(j, name)(*args, **akw)


@pytest.mark.parametrize("kw", [{}, {"group_commit_ms": 0.5},
                                {"sync": False}],
                         ids=["per_op", "group_commit", "no_sync"])
def test_same_records_give_byte_equal_segments(tmp_path, kw):
    ops = _ops(np.random.default_rng(3))
    pj, pt = str(tmp_path / "jax.wal"), str(tmp_path / "port.wal")
    _write(JJ, pj, ops, **kw)
    _write(J, pt, ops, **kw)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for rids in (False, True):
        _same_records(J.read_records(pj, with_rids=rids),
                      JJ.read_records(pt, with_rids=rids))
        _same_records(J.read_records(pt, with_rids=rids),
                      JJ.read_records(pj, with_rids=rids))
    assert J.read_acks(pj).keys() == JJ.read_acks(pt).keys()
    assert J.crc_of_range(pj, 8, 200) == JJ.crc_of_range(pt, 8, 200)


def test_encoders_and_frames_match():
    rng = np.random.default_rng(5)
    k = rng.integers(1, 1 << 62, 17, dtype=U64)
    for kind, vals in ((J.J_UPSERT, k ^ U64(9)), (J.J_DELETE, None),
                       (J.J_HEAP_FREE, k + U64(1))):
        for rid in (None, 0, (1 << 64) - 1):
            assert J.encode_record(kind, k, vals, rid=rid) == \
                JJ.encode_record(kind, k, vals, rid=rid)
    acks = [(5, "t", 1, rng.random(70) < 0.3)]
    assert J.encode_ack_record(acks) == JJ.encode_ack_record(acks)
    assert J.encode_heap_record(3, k[:2], k[:2], [b"ab", b"c"]) == \
        JJ.encode_heap_record(3, k[:2], k[:2], [b"ab", b"c"])
    blob = J.frame_blob(b"payload") + J.frame_blob(b"") + b"\x01\x02"
    assert blob[:-2] == JJ.frame_blob(b"payload") + JJ.frame_blob(b"")
    assert J.iter_frames(blob) == JJ.iter_frames(blob)
    assert J.unframe_blob(blob) == JJ.unframe_blob(blob) == b"payload"
    for mod in (J, JJ):
        with pytest.raises(mod.JournalCorruptError):
            mod.unframe_blob(blob[:6])
        with pytest.raises(ValueError):
            mod.encode_record(J.J_ACK, k)


def test_v1_segments_read_alike_and_stay_v1(tmp_path):
    """A v1 segment (``SHJRNL01``, flags byte zero pad) reads in both
    packages with no request ids; an append to it keeps writing v1
    records (rid dropped, ack records refused as no-ops), byte-equal in
    both packages."""
    k = np.arange(1, 6, dtype=U64)
    segs = {}
    for name, mod in (("jax", JJ), ("port", J)):
        path = str(tmp_path / f"{name}.wal")
        with open(path, "wb") as f:
            f.write(mod.MAGIC_V1)
            # a v1 writer put a zero pad where v2 carries the flags
            f.write(mod.encode_record(mod.J_UPSERT, k, k ^ U64(3)))
        with mod.Journal(path) as j:
            assert j.format == 1
            j.append(mod.J_DELETE, k[:2], rid=99)
            assert j.append_acks([(1, "t", 1, np.ones(2, bool))]) == 0
        segs[name] = path
    assert open(segs["port"], "rb").read() == open(segs["jax"], "rb").read()
    for mod in (J, JJ):
        for path in segs.values():
            recs = mod.read_records(path, with_rids=True)
            assert [r[0] for r in recs] == [1, 2]
            assert [r[3] for r in recs] == [None, None]


@pytest.mark.parametrize("cut", [1, 5, 11, 40])
def test_torn_tails_cut_alike(tmp_path, cut):
    """A torn tail is cut at the same byte by both packages, and a
    mid-file CRC failure is refused by both."""
    k = np.arange(1, 9, dtype=U64)
    rec = J.encode_record(J.J_UPSERT, k, k)
    sizes = []
    for name, mod in (("jax", JJ), ("port", J)):
        path = str(tmp_path / f"{name}.wal")
        with mod.Journal(path) as j:
            j.append(mod.J_DELETE, k[:3])
        with open(path, "ab") as f:
            f.write(rec[:cut])
        assert len(mod.read_records(path, truncate_torn=True)) == 1
        sizes.append(os.path.getsize(path))
        # the other package reads the cut segment the same way
        other = J if mod is JJ else JJ
        assert len(other.read_records(path)) == 1
    assert sizes[0] == sizes[1]
    blob = bytearray(open(str(tmp_path / "port.wal"), "rb").read())
    blob += J.encode_record(J.J_DELETE, k)
    blob[len(J.MAGIC) + J._HDR.size + 1] ^= 0x10
    bad = str(tmp_path / "bad.wal")
    open(bad, "wb").write(bytes(blob))
    for mod in (J, JJ):
        with pytest.raises(mod.JournalCorruptError):
            mod.read_records(bad)


class _Recorder:
    """An engine stand-in that records what replay applies."""

    def __init__(self):
        self.calls = []
        self.value_heap = None

    def insert(self, keys, vals):
        self.calls.append(("insert", keys.tolist(), vals.tolist()))

    def delete(self, keys):
        self.calls.append(("delete", keys.tolist()))


def test_replay_applies_alike(tmp_path):
    """``replay``/``apply_records`` dispatch a segment the same way in
    both packages (stats, ack sink, the order of engine calls), and both
    refuse value-heap records on an engine without a heap."""
    ops = _ops(np.random.default_rng(9))
    heap = [o[0] == "append_heap" or o[1][0] == J.J_HEAP_FREE for o in ops]
    path = str(tmp_path / "seg.wal")
    _write(J, path, [o for o, h in zip(ops, heap) if not h])
    outs = []
    for mod in (JJ, J):
        eng, sink = _Recorder(), []
        st = mod.apply_records(mod.read_records(path), eng, ack_sink=sink)
        outs.append((st, eng.calls, [e[:3] for e in sink]))
    assert outs[0] == outs[1]
    for i in np.nonzero(heap)[0]:
        _write(J, path + f"h{i}", [ops[i]])
        for mod in (JJ, J):
            with pytest.raises(RuntimeError, match="ValueHeap"):
                mod.replay(path + f"h{i}", _Recorder())
