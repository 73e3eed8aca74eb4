"""Port parity: the native host tier (``sherman_tpu_torch/native``) against
the JAX package's (``sherman_tpu/native``) on the CPU.

Both libraries are built with g++ from their own copies of the sources
and loaded side by side.  Every case of ``tests/test_native.py`` runs on
the port with the same seeds: where one thread drives a deterministic
sequence (the skiplist, the cache's add / lookup / invalidate /
split-narrowing / ``lookup_many``, the zipf draws, the histogram, the
batch prep in both key modes, ``synthetic_keyspace`` and ``mix64``) the
port's outputs and stats must equal the reference's; where threads or the
cache's eviction clock decide the outcome (the concurrent skiplist, the
eviction under pressure, the lock hand-over protocol, its bound, mutual
exclusion, the ``WRLock``'s writer preference) the reference test's
invariants are asserted on the port.  The tier is never skipped: g++ is
part of the toolchain, so a build failure is a failure.  Last, several
processes import a copy of the tier at once into an empty build
directory.

Every tolerance is exact equality, except the reference's own bounds on
sampled shares and histogram percentiles, kept as they are.
"""

import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from sherman_tpu import native as JN
from sherman_tpu_torch import native as TN
from sherman_tpu_torch.errors import NativeUnavailableError, ShermanError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tier_builds_and_loads():
    assert TN.available(), TN.load_error()
    assert TN.load_error() is None
    assert os.path.exists(TN._LIB)
    assert os.path.dirname(TN._LIB) == os.path.join(
        REPO, "sherman_tpu_torch", "native", "build")
    assert issubclass(NativeUnavailableError, ShermanError)
    assert issubclass(TN.PrepOverflow, ShermanError)


def test_sources_are_the_reference_copies():
    """The port's sources carry the reference's C ABI: every ``shn_*``
    entry point of the reference is defined in the port's copy."""
    import re
    pat = re.compile(r"SHN_EXPORT [\w\s\*]+?\b(shn_\w+)\(")

    def exports(d):
        out = set()
        for f in os.listdir(d):
            with open(os.path.join(d, f)) as fh:
                out |= set(pat.findall(fh.read()))
        return out

    ref = exports(os.path.join(REPO, "sherman_tpu", "native", "src"))
    port = exports(os.path.join(REPO, "sherman_tpu_torch", "native", "src"))
    assert ref and port == ref


# -- skiplist ----------------------------------------------------------------

def _skiplist_run(mod):
    sl = mod.SkipList(100_000)
    rng = np.random.default_rng(0)
    keys = rng.choice(1 << 40, size=10_000, replace=False).astype(np.uint64)
    ins = [sl.insert(int(k), int(k) * 3) for k in keys]
    skeys = np.sort(keys)
    exact = [sl.seek_ge(int(k)) for k in skeys[::97]]
    between = [sl.seek_ge(int(skeys[i]) + 1)
               for i in range(0, len(skeys) - 1, 131)]
    past = sl.seek_ge(int(skeys[-1]) + 1)
    return keys, skeys, ins, len(sl), exact, between, past


def test_skiplist_insert_seek():
    keys, skeys, ins, n, exact, between, past = _skiplist_run(TN)
    assert n == keys.size
    for k, got in zip(skeys[::97], exact):
        assert got == (int(k), int(k) * 3)
    for j, i in enumerate(range(0, len(skeys) - 1, 131)):
        if int(skeys[i]) + 1 != int(skeys[i + 1]):
            assert between[j] == (int(skeys[i + 1]), int(skeys[i + 1]) * 3)
    assert past is None
    ref = _skiplist_run(JN)
    assert (ins, n, exact, between, past) == ref[2:]


def test_skiplist_overwrite():
    out = []
    for mod in (TN, JN):
        sl = mod.SkipList(16)
        out.append((sl.insert(7, 1), sl.insert(7, 2), len(sl),
                    sl.seek_ge(0)))
    assert out[0] == out[1] == (0, 1, 1, (7, 2))


def test_skiplist_concurrent_insert():
    sl = TN.SkipList(200_000)
    n_threads, per = 8, 5_000

    def worker(tid):
        for i in range(per):
            k = tid * per + i
            sl.insert(k, k + 1)

    ts = [threading.Thread(target=worker, args=(t,))
          for t in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(sl) == n_threads * per
    for k in range(0, n_threads * per, 977):
        assert sl.seek_ge(k) == (k, k + 1)


def test_skiplist_arena_full_raises():
    for mod in (TN, JN):
        sl = mod.SkipList(2)
        sl.insert(1, 1)
        sl.insert(2, 2)
        with pytest.raises(MemoryError):
            for k in range(3, 64):
                sl.insert(k, k)


# -- index cache -------------------------------------------------------------

def _cache_seq(mod):
    c = mod.IndexCache(1024)
    adds = [c.add(0, 100, 11), c.add(100, 200, 22), c.add(200, 300, 33)]
    looks = [c.lookup(k) for k in (0, 99, 100, 299, 300)]
    inv = c.invalidate(150)
    after = [c.lookup(150), c.lookup(250)]
    return adds, looks, inv, after, c.stats(), c.hit_rate()


def test_cache_add_lookup_invalidate():
    adds, looks, inv, after, s, rate = _cache_seq(TN)
    assert looks == [11, 11, 22, 33, 0]
    assert inv and after == [0, 33]
    assert s["invalidates"] == 1 and s["hits"] == 5 and s["misses"] == 2
    assert sorted(s) == sorted(TN.STAT_FIELDS)
    assert TN.STAT_FIELDS == JN.STAT_FIELDS
    assert (adds, looks, inv, after, s, rate) == _cache_seq(JN)


def test_cache_refresh_same_range():
    out = []
    for mod in (TN, JN):
        c = mod.IndexCache(64)
        c.add(10, 20, 1)
        c.add(10, 20, 2)
        out.append((c.lookup(15), c.stats()))
    assert out[0][0] == 2 and out[0][1]["used_slots"] == 1
    assert out[0] == out[1]


def test_cache_split_narrowing():
    out = []
    for mod in (TN, JN):
        c = mod.IndexCache(64)
        r = [c.add(0, 1000, 7), c.add(0, 500, 7), c.add(500, 1000, 8)]
        out.append((r, c.lookup(250), c.lookup(750), c.stats()))
    assert out[0][1:3] == (7, 8)
    assert out[0] == out[1]


def test_cache_eviction_under_pressure():
    c = TN.IndexCache(128)
    for i in range(128):
        c.add(i * 10, i * 10 + 10, i + 1)
    for _ in range(50):
        for i in range(0, 64):
            c.lookup(i * 10)
    added = 0
    for i in range(128, 256):
        r = c.add(i * 10, i * 10 + 10, i + 1)
        if r == -1:  # every victim still inside the delay-free window
            time.sleep(0.0001)
            r = c.add(i * 10, i * 10 + 10, i + 1)
        added += (r >= 0)
    s = c.stats()
    assert s["evictions"] > 0
    assert added > 64
    hot_alive = sum(c.lookup(i * 10) != 0 for i in range(64))
    cold_alive = sum(c.lookup(i * 10) != 0 for i in range(64, 128))
    assert hot_alive > cold_alive


def test_cache_lookup_many():
    out = []
    for mod in (TN, JN):
        c = mod.IndexCache(64)
        c.add_many([0, 100], [100, 200], [5, 6])
        out.append((c.lookup_many(np.array([0, 50, 150, 999], np.uint64)),
                    c.stats()))
    np.testing.assert_array_equal(out[0][0], [5, 5, 6, 0])
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


def test_cache_random_sequence_matches():
    """A longer seeded single-thread sequence of adds, lookups (single and
    batched) and invalidations, within capacity: every answer and the
    stats equal."""
    out = []
    for mod in (TN, JN):
        rng = np.random.default_rng(31)
        c = mod.IndexCache(4096)
        bounds = np.sort(rng.choice(1 << 40, 1025, replace=False)
                         ).astype(np.uint64)
        got = []
        for i in rng.permutation(1024)[:900]:
            got.append(c.add(int(bounds[i]), int(bounds[i + 1]), int(i) + 1))
        probes = rng.integers(0, 1 << 40, 3000, dtype=np.uint64)
        got.append(c.lookup_many(probes).tolist())
        for k in probes[:300]:
            got.append(c.invalidate(int(k)))
        got.append([c.lookup(int(k)) for k in probes[::7]])
        out.append((got, c.stats()))
    assert out[0] == out[1]


# -- local ticket locks ------------------------------------------------------

def test_lock_handover_protocol():
    lt = TN.LocalLockTable(8)
    assert lt.acquire(3) is False
    assert lt.release(3) is False
    got_handover = []

    def waiter():
        got_handover.append(lt.acquire(3))
        lt.release(3)

    t = threading.Thread(target=waiter)
    assert lt.acquire(3) is False
    t.start()
    time.sleep(0.05)     # the waiter joins the queue
    assert lt.can_handover(3) is True
    handed = lt.release(3)
    t.join()
    assert handed is True
    assert got_handover == [True]


def test_lock_uncontended_matches():
    """One thread: no waiter, so no hand-over, on both libraries."""
    out = []
    for mod in (TN, JN):
        lt = mod.LocalLockTable(4)
        seq = []
        for i in (0, 3, 0, 1):
            seq += [lt.acquire(i), lt.can_handover(i), lt.release(i, True)]
        out.append(seq)
    assert out[0] == out[1] == [False] * 12


def test_lock_handover_bounded():
    lt = TN.LocalLockTable(1)
    results = []
    n = 12

    def worker():
        lt.acquire(0)
        results.append(lt.release(0))

    ts = [threading.Thread(target=worker) for _ in range(n)]
    lt.acquire(0)
    for t in ts:
        t.start()
    time.sleep(0.1)
    results.append(lt.release(0))
    for t in ts:
        t.join()
    # the last release (empty queue) and the bound past 8 hand-overs
    assert sum(r is False for r in results) >= 2


def test_lock_mutual_exclusion():
    lt = TN.LocalLockTable(1)
    counter = {"v": 0}

    def worker():
        for _ in range(2000):
            lt.acquire(0)
            counter["v"] += 1
            lt.release(0)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert counter["v"] == 8000


# -- zipf --------------------------------------------------------------------

@pytest.mark.parametrize("n,theta,seed", [(1_000_000, 0.99, 7),
                                          (1_000_000, 0.0, 7),
                                          (1000, 0.5, 3), (7, 0.99, 0)])
def test_zipf_draws_bit_identical(n, theta, seed):
    t, j = TN.ZipfGen(n, theta, seed), JN.ZipfGen(n, theta, seed)
    for size in (1, 1000, 65_536):
        np.testing.assert_array_equal(t.sample(size), j.sample(size))


def test_zipf_skew_and_range():
    z = TN.ZipfGen(1_000_000, 0.99, seed=7)
    s = z.sample(200_000)
    assert s.dtype == np.uint64
    assert s.min() >= 0 and s.max() < 1_000_000
    share = (s < 10).mean()
    assert 0.10 < share < 0.35
    su = TN.ZipfGen(1_000_000, 0.0, seed=7).sample(200_000)
    assert (su < 10).mean() < 0.001
    assert su.max() < 1_000_000


def test_zipf_python_wrapper_prefers_native():
    from sherman_tpu.workload.zipf import ZipfGen as JZipf
    from sherman_tpu_torch.workload.zipf import ZipfGen
    z = ZipfGen(1000, 0.99, seed=3)
    assert z._native is not None
    s = z.sample(1000)
    assert s.dtype == np.int64 and s.min() >= 0 and s.max() < 1000
    np.testing.assert_array_equal(s, JZipf(1000, 0.99, seed=3).sample(1000))
    # an explicit generator keeps the numpy path
    assert ZipfGen(1000, 0.99, rng=np.random.default_rng(3))._native is None


# -- histogram ---------------------------------------------------------------

def _hist_run(mod):
    h = mod.LatencyHistogram()
    h.record_many_ns(np.arange(1_000, 100_001, 1_000, dtype=np.uint64)
                     .repeat(10))
    p = h.percentiles_us()
    n = h.count
    h.reset()
    return p, n, h.count


def test_histogram_percentiles():
    p, n, n_after = _hist_run(TN)
    assert abs(p["p50"] - 50) < 2
    assert abs(p["p99"] - 99) < 2
    assert p["p999"] <= 101
    assert (n, n_after) == (1000, 0)
    assert (p, n, n_after) == _hist_run(JN)


def test_histogram_batch_record():
    out = []
    for mod in (TN, JN):
        h = mod.LatencyHistogram()
        h.record_batch(5_000, 100)
        h.record_ns(12_345)
        h.record_batch(200_000_000, 3)     # past the range: top bucket
        out.append((h.count, h.percentiles_us([0.5, 0.97, 0.99]),
                    h.percentiles_us()))
    assert out[0][0] == 104
    assert abs(out[0][1]["p50"] - 5.0) < 0.2
    assert out[0] == out[1]


# -- WRLock ------------------------------------------------------------------

def test_wrlock_writer_preference_and_counts():
    rw = TN.WRLock()
    rw.rlock()
    done = []
    t2 = threading.Thread(target=lambda: (rw.rlock(), done.append(1),
                                          rw.runlock()))
    t2.start()
    t2.join(timeout=5)
    assert done, "second reader blocked under a held read lock"
    rw.runlock()
    rw.wlock()
    seen = []

    def reader():
        rw.rlock()
        seen.append(time.monotonic())
        rw.runlock()

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.05)
    assert not seen
    t0 = time.monotonic()
    rw.wunlock()
    t.join(timeout=5)
    assert seen and seen[0] >= t0


def test_wrlock_waiting_writer_blocks_new_readers():
    """Writer preference: once a writer waits, a new reader queues
    behind it even though a read lock is still held."""
    rw = TN.WRLock()
    rw.rlock()
    order = []
    w = threading.Thread(target=lambda: (rw.wlock(), order.append("w"),
                                         rw.wunlock()))
    w.start()
    time.sleep(0.05)               # the writer is now waiting
    r = threading.Thread(target=lambda: (rw.rlock(), order.append("r"),
                                         rw.runlock()))
    r.start()
    time.sleep(0.05)
    assert order == []             # the new reader did not get in
    rw.runlock()
    w.join(timeout=5)
    r.join(timeout=5)
    assert order == ["w", "r"]


# -- BatchPrep ---------------------------------------------------------------

def _rebuild_keys(buf, n):
    return ((buf.khi[:n].view(np.uint32).astype(np.uint64) << np.uint64(32))
            | buf.klo[:n].view(np.uint32).astype(np.uint64))


def _bufs_equal(a, b, with_keys=False):
    assert a.n_uniq == b.n_uniq
    for f in ("khi", "klo", "start", "active", "inv") + (
            ("keys",) if with_keys else ()):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _prep_keys_run(mod):
    rng = np.random.default_rng(5)
    keys = rng.integers(1, 5000, 100_000, dtype=np.uint64)
    table = rng.integers(1, 1 << 20, 1 << 14,
                         dtype=np.int64).astype(np.int32)
    prep = mod.BatchPrep(batch=100_000, capacity=8192)
    buf = prep.run_keys(keys, prep.buffers(), table, shift=50,
                        default_start=3)
    return keys, table, buf


def test_prep_keys_matches_numpy_unique():
    keys, table, buf = _prep_keys_run(TN)
    n = buf.n_uniq
    uk = _rebuild_keys(buf, n)
    ref = np.unique(keys)
    assert n == ref.size
    np.testing.assert_array_equal(np.sort(uk), ref)
    np.testing.assert_array_equal(uk[buf.inv], keys)
    assert buf.active[:n].all() and not buf.active[n:].any()
    b = np.minimum(uk >> np.uint64(50), np.uint64(table.size - 1))
    np.testing.assert_array_equal(buf.start[:n], table[b.astype(np.int64)])
    assert (buf.start[n:] == 3).all()
    _bufs_equal(buf, _prep_keys_run(JN)[2])


def test_prep_overflow_raises():
    keys = np.arange(1, 1001, dtype=np.uint64)
    for mod in (TN, JN):
        prep = mod.BatchPrep(batch=1000, capacity=8)
        with pytest.raises(mod.PrepOverflow):
            prep.run_keys(keys, prep.buffers(), None)
    prep = TN.BatchPrep(batch=64, capacity=64, n_keys=1 << 16, theta=0.0,
                        seed=1, salt=0x5E17_AB1E_5A17)
    small = TN.PrepBuffers(64, 64)
    prep.run_zipf(None, small, None)
    tight = TN.BatchPrep(batch=64, capacity=4, n_keys=1 << 16, theta=0.0,
                         seed=1, salt=0x5E17_AB1E_5A17)
    with pytest.raises(TN.PrepOverflow):
        tight.run_zipf(None, tight.buffers(), None)


def test_prep_epoch_isolation_across_batches():
    out = []
    for mod in (TN, JN):
        prep = mod.BatchPrep(batch=1000, capacity=1000)
        buf = prep.buffers()
        a = np.arange(1, 501, dtype=np.uint64).repeat(2)
        prep.run_keys(a, buf, None)
        n0 = buf.n_uniq
        prep.run_keys(a, buf, None)
        out.append((n0, buf.n_uniq, np.sort(_rebuild_keys(buf, 500))))
    assert out[0][:2] == (500, 500)
    np.testing.assert_array_equal(out[0][2],
                                  np.arange(1, 501, dtype=np.uint64))
    assert out[0][:2] == out[1][:2]


def _synthetic_run(mod, table, shift, batches=3):
    n_keys, batch, salt = 1 << 20, 65_536, 0x5E17_AB1E_5A17
    prep = mod.BatchPrep(batch=batch, capacity=batch, n_keys=n_keys,
                         theta=0.99, seed=7, salt=salt)
    bufs = [prep.buffers(with_keys=True) for _ in range(batches)]
    for b in bufs:
        prep.run_zipf(None, b, table, shift, default_start=0,
                      want_keys=True)
    return bufs


@pytest.mark.parametrize("with_table", [False, True])
def test_prep_zipf_synthetic_mode(with_table):
    n_keys, batch, salt = 1 << 20, 65_536, 0x5E17_AB1E_5A17
    keyspace, rank_to_key = TN.synthetic_keyspace(n_keys, salt)
    table = (np.random.default_rng(4).integers(1, 1 << 20, 1 << 12)
             .astype(np.int32) if with_table else None)
    bufs = _synthetic_run(TN, table, 52)
    buf = bufs[0]
    n = buf.n_uniq
    assert 0 < n < batch
    uk = _rebuild_keys(buf, n)
    np.testing.assert_array_equal(uk[buf.inv], buf.keys)
    assert np.isin(buf.keys[:1000], keyspace).all()
    assert (buf.keys == rank_to_key[0]).sum() > batch // 100
    if with_table:
        b = np.minimum(uk >> np.uint64(52), np.uint64(table.size - 1))
        np.testing.assert_array_equal(buf.start[:n],
                                      table[b.astype(np.int64)])
    for a, b in zip(bufs, _synthetic_run(JN, table, 52)):
        _bufs_equal(a, b, with_keys=True)


def _gather_run(mod):
    n_keys, batch = 1 << 18, 32_768
    rng = np.random.default_rng(2)
    keyspace = np.sort(rng.choice(1 << 40, n_keys, replace=False)
                       .astype(np.uint64))
    prep = mod.BatchPrep(batch=batch, capacity=batch, n_keys=n_keys,
                         theta=0.99, seed=7)
    buf = prep.buffers(with_keys=True)
    prep.run_zipf(keyspace, buf, None, want_keys=True)
    return keyspace, buf


def test_prep_zipf_keyspace_gather_mode():
    keyspace, buf = _gather_run(TN)
    assert np.isin(buf.keys, keyspace).all()
    uk = _rebuild_keys(buf, buf.n_uniq)
    np.testing.assert_array_equal(uk[buf.inv], buf.keys)
    _bufs_equal(buf, _gather_run(JN)[1], with_keys=True)


def test_prep_zipf_distribution_matches_exact_sampler():
    n_keys, batch, salt = 1 << 22, 200_000, 0x5E17_AB1E_5A17
    bufs = []
    for mod in (TN, JN):
        prep = mod.BatchPrep(batch=batch, capacity=batch, n_keys=n_keys,
                             theta=0.99, seed=11, salt=salt)
        bufs.append(prep.run_zipf(None, prep.buffers(with_keys=True), None,
                                  want_keys=True))
    _bufs_equal(bufs[0], bufs[1], with_keys=True)
    buf = bufs[0]
    lut_n = 1 << 12
    r2k = TN.mix64(np.arange(lut_n, dtype=np.uint64) ^ np.uint64(salt))
    exact = TN.ZipfGen(n_keys, 0.99, seed=23).sample(batch)
    for rank in (0, 1, 10):
        fast_share = (buf.keys == r2k[rank]).mean()
        exact_share = (exact == rank).mean()
        assert abs(fast_share - exact_share) < 0.004, (
            rank, fast_share, exact_share)
    fast_head = np.isin(buf.keys, r2k).mean()
    exact_head = (exact < lut_n).mean()
    assert abs(fast_head - exact_head) < 0.02, (fast_head, exact_head)


# -- keyspace ----------------------------------------------------------------

@pytest.mark.parametrize("n_keys,salt", [(1, 0x5E17_AB1E_5A17),
                                         (100_000, 0x5E17_AB1E_5A17),
                                         (5000, 1 << 40)])
def test_synthetic_keyspace_and_mix64_match(n_keys, salt):
    tk, tr = TN.synthetic_keyspace(n_keys, salt)
    jk, jr = JN.synthetic_keyspace(n_keys, salt)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tr, jr)
    assert tk.dtype == tr.dtype == np.uint64
    x = np.random.default_rng(n_keys).integers(0, 2**64 - 1, 1000,
                                               dtype=np.uint64)
    np.testing.assert_array_equal(TN.mix64(x), JN.mix64(x))


def test_synthetic_keyspace_salt_collision_raises():
    # salt < n_keys: rank == salt maps to mix64(0) == 0, out of range
    for mod in (TN, JN):
        with pytest.raises(ValueError, match="collides"):
            mod.synthetic_keyspace(100, 5)


# -- the build ---------------------------------------------------------------

_IMPORT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location(
    "native_copy", sys.argv[1], submodule_search_locations=[sys.argv[2]])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
assert m.available(), m.load_error()
print(int(m.ZipfGen(1000, 0.99, 5).sample(4096).sum()))
"""


def test_concurrent_build_into_empty_dir(tmp_path):
    """Four processes import a copy of the tier at once, with no library
    built yet: each builds into a temporary file and renames it, so every
    one loads a whole library and draws the same numbers, and the build
    directory ends with the library alone."""
    src = os.path.join(REPO, "sherman_tpu_torch", "native")
    d = tmp_path / "native_copy"
    shutil.copytree(os.path.join(src, "src"), d / "src")
    shutil.copy(os.path.join(src, "__init__.py"), d / "__init__.py")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _IMPORT, str(d / "__init__.py"), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    want = int(TN.ZipfGen(1000, 0.99, 5).sample(4096).sum())
    assert [int(o.strip()) for o, _ in outs] == [want] * 4
    assert os.listdir(d / "build") == ["libsherman_native.so"]
