"""The native host tier of the port: C++ components behind a ctypes C ABI
(counterpart of ``sherman_tpu/native``, whose sources ``src/`` copies with
the same ``shn_*`` ABI).

Everything host-side on the serving path but outside the card's kernels:

- ``ZipfGen``          — Zipf(theta) rank sampler (the workload generator)
- ``LatencyHistogram`` — 0.1 us-bucket latency histogram and percentiles
- ``SkipList``         — concurrent (u64 -> u64) skiplist
- ``IndexCache``       — range -> leaf-address cache with invalidation,
                         delay-free epochs, 2-random eviction, hit stats
- ``LocalLockTable``   — node-local ticket locks with bounded hand-over of
                         the global lock (the host Tree's local tier)
- ``WRLock``           — spinning writer-preference RW lock (the router's
                         guard)
- ``BatchPrep``        — fused batch prep: zipf sample, key map, unique and
                         inverse, router probe

Built at first use with ``g++ -O3 -std=c++17 -shared -fPIC -pthread``
into ``build/libsherman_native.so`` (rebuilt when a source is newer; the
build writes a temporary file and renames it, so concurrent builders
never load a half-written library).  ``available()`` says whether the
library loaded, ``load_error()`` why not.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import tempfile

import numpy as np

from sherman_tpu_torch.errors import (ConfigError, NativeBuildError,
                                      NativeUnavailableError, ShermanError)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_BUILD = os.path.join(_DIR, "build")
_LIB = os.path.join(_BUILD, "libsherman_native.so")

_lib = None
_load_error: str | None = None


def _sources() -> list[str]:
    return sorted(
        os.path.join(_SRC, f) for f in os.listdir(_SRC) if f.endswith(".cc"))


def _stale() -> bool:
    if not os.path.exists(_LIB):
        return True
    t = os.path.getmtime(_LIB)
    deps = _sources() + [
        os.path.join(_SRC, f) for f in os.listdir(_SRC) if f.endswith(".h")]
    return any(os.path.getmtime(s) > t for s in deps)


def _build() -> None:
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-fvisibility=hidden", "-o", tmp] + _sources()
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB)  # atomic under concurrent builders
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(f"native build failed:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _sig(name: str, res, args) -> None:
    fn = getattr(_lib, name)
    fn.restype = res
    fn.argtypes = args
    globals()["_" + name] = fn


def _load() -> None:
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return
    try:
        if _stale():
            _build()
        _lib = ct.CDLL(_LIB)
    except (OSError, RuntimeError) as e:  # no g++ / bad toolchain
        _load_error = str(e)
        return
    P, U64, I32, F64 = ct.c_void_p, ct.c_uint64, ct.c_int, ct.c_double
    PU64, PF64 = ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_double)
    _sig("shn_zipf_new", P, [U64, F64, U64])
    _sig("shn_zipf_fill", None, [P, PU64, U64])
    _sig("shn_zipf_free", None, [P])
    _sig("shn_hist_new", P, [])
    _sig("shn_hist_free", None, [P])
    _sig("shn_hist_reset", None, [P])
    _sig("shn_hist_record", None, [P, U64])
    _sig("shn_hist_record_many", None, [P, PU64, U64])
    _sig("shn_hist_record_batch", None, [P, U64, U64])
    _sig("shn_hist_count", U64, [P])
    _sig("shn_hist_percentiles", None, [P, PF64, U64, PF64])
    _sig("shn_skl_new", P, [U64])
    _sig("shn_skl_free", None, [P])
    _sig("shn_skl_insert", I32, [P, U64, U64])
    _sig("shn_skl_seek_ge", I32, [P, U64, PU64, PU64])
    _sig("shn_skl_count", U64, [P])
    _sig("shn_cache_new", P, [U64])
    _sig("shn_cache_free", None, [P])
    _sig("shn_cache_add", I32, [P, U64, U64, U64])
    _sig("shn_cache_add_many", None, [P, PU64, PU64, PU64, U64])
    _sig("shn_cache_lookup", U64, [P, U64])
    _sig("shn_cache_lookup_many", None, [P, PU64, U64, PU64])
    _sig("shn_cache_invalidate", I32, [P, U64])
    _sig("shn_cache_stats", None, [P, PU64])
    _sig("shn_lt_new", P, [U64])
    _sig("shn_lt_free", None, [P])
    _sig("shn_lt_acquire", I32, [P, U64])
    _sig("shn_lt_can_handover", I32, [P, U64])
    _sig("shn_lt_release", I32, [P, U64, I32])
    I64, PI32, PU8 = ct.c_int64, ct.POINTER(ct.c_int32), ct.POINTER(ct.c_uint8)
    _sig("shn_prep_new", P, [U64, F64, U64, U64, U64, U64])
    _sig("shn_prep_free", None, [P])
    _sig("shn_prep_run_keys", I64,
         [P, PU64, U64, PI32, U64, ct.c_uint32, ct.c_int32,
          PI32, PI32, PI32, PU8, PI32])
    _sig("shn_prep_run_zipf", I64,
         [P, PU64, PU64, PI32, U64, ct.c_uint32, ct.c_int32,
          PI32, PI32, PI32, PU8, PI32])
    _sig("shn_rw_new", P, [])
    _sig("shn_rw_free", None, [P])
    _sig("shn_rw_rlock", None, [P])
    _sig("shn_rw_runlock", None, [P])
    _sig("shn_rw_wlock", None, [P])
    _sig("shn_rw_wunlock", None, [P])


def available() -> bool:
    _load()
    return _lib is not None


def load_error() -> str | None:
    _load()
    return _load_error


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_uint64))


def _require() -> None:
    if not available():
        raise NativeUnavailableError(f"native library unavailable: {_load_error}")


class ZipfGen:
    """Zipf(theta) ranks over [0, n); theta <= 0 means uniform."""

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0):
        _require()
        self._h = _shn_zipf_new(n, float(theta), seed)
        if not self._h:
            raise MemoryError("zipf_new failed")

    def sample(self, size: int) -> np.ndarray:
        out = np.empty(size, np.uint64)
        _shn_zipf_fill(self._h, _u64p(out), size)
        return out

    def __del__(self):
        h, f = getattr(self, "_h", None), globals().get("_shn_zipf_free")
        if h and f:
            f(h)
            self._h = None


class LatencyHistogram:
    """Thread-safe 0.1 µs-bucket histogram; percentiles in µs."""

    def __init__(self):
        _require()
        self._h = _shn_hist_new()
        if not self._h:
            raise MemoryError("hist_new failed")

    def record_ns(self, ns: int) -> None:
        _shn_hist_record(self._h, int(ns))

    def record_many_ns(self, ns: np.ndarray) -> None:
        ns = np.ascontiguousarray(ns, np.uint64)
        _shn_hist_record_many(self._h, _u64p(ns), ns.size)

    def record_batch(self, span_ns: int, count: int) -> None:
        """count ops that completed together after span_ns (one step)."""
        _shn_hist_record_batch(self._h, int(span_ns), int(count))

    @property
    def count(self) -> int:
        return int(_shn_hist_count(self._h))

    def percentiles_us(self, qs=(0.5, 0.9, 0.95, 0.99, 0.999)) -> dict:
        q = np.asarray(qs, np.float64)
        out = np.empty(q.size, np.float64)
        _shn_hist_percentiles(self._h, q.ctypes.data_as(
            ct.POINTER(ct.c_double)), q.size,
            out.ctypes.data_as(ct.POINTER(ct.c_double)))
        return {"p" + ("%g" % (v * 100)).replace(".", ""): float(o)
                for v, o in zip(qs, out)}

    def reset(self) -> None:
        _shn_hist_reset(self._h)

    def __del__(self):
        h, f = getattr(self, "_h", None), globals().get("_shn_hist_free")
        if h and f:
            f(h)
            self._h = None


class SkipList:
    """Concurrent (key: u64 -> value: u64) skiplist; seek_ge iteration."""

    def __init__(self, capacity: int):
        _require()
        self._h = _shn_skl_new(capacity)
        if not self._h:
            raise MemoryError(f"skiplist alloc failed (capacity={capacity})")

    def insert(self, key: int, value: int) -> int:
        r = _shn_skl_insert(self._h, key, value)
        if r < 0:
            raise MemoryError("skiplist arena full")
        return r

    def seek_ge(self, key: int):
        k, v = ct.c_uint64(), ct.c_uint64()
        if _shn_skl_seek_ge(self._h, key, ct.byref(k), ct.byref(v)):
            return int(k.value), int(v.value)
        return None

    def __len__(self) -> int:
        return int(_shn_skl_count(self._h))

    def __del__(self):
        h, f = getattr(self, "_h", None), globals().get("_shn_skl_free")
        if h and f:
            f(h)
            self._h = None


STAT_FIELDS = ("hits", "misses", "adds", "evictions", "invalidates",
               "used_slots", "capacity", "skiplist_nodes", "add_fails")


class IndexCache:
    """Range -> leaf-address cache (IndexCache.h role); see src docs."""

    def __init__(self, capacity: int = 1 << 16):
        _require()
        self._h = _shn_cache_new(capacity)
        if not self._h:
            raise MemoryError(
                f"index cache alloc failed (capacity={capacity}; "
                "max 2**28 entries)")

    def add(self, from_key: int, to_key: int, ptr: int) -> int:
        return _shn_cache_add(self._h, from_key, to_key, ptr)

    def add_many(self, from_keys, to_keys, ptrs) -> None:
        f = np.ascontiguousarray(from_keys, np.uint64)
        t = np.ascontiguousarray(to_keys, np.uint64)
        p = np.ascontiguousarray(ptrs, np.uint64)
        assert f.size == t.size == p.size
        _shn_cache_add_many(self._h, _u64p(f), _u64p(t), _u64p(p), f.size)

    def lookup(self, key: int) -> int:
        """-> leaf addr, or 0 on miss."""
        return int(_shn_cache_lookup(self._h, key))

    def lookup_many(self, keys) -> np.ndarray:
        k = np.ascontiguousarray(keys, np.uint64)
        out = np.empty(k.size, np.uint64)
        _shn_cache_lookup_many(self._h, _u64p(k), k.size, _u64p(out))
        return out

    def invalidate(self, key: int) -> bool:
        return bool(_shn_cache_invalidate(self._h, key))

    def stats(self) -> dict:
        out = np.zeros(9, np.uint64)
        _shn_cache_stats(self._h, _u64p(out))
        return dict(zip(STAT_FIELDS, (int(x) for x in out)))

    def hit_rate(self) -> float:
        s = self.stats()
        tot = s["hits"] + s["misses"]
        return s["hits"] / tot if tot else 0.0

    def __del__(self):
        h, f = getattr(self, "_h", None), globals().get("_shn_cache_free")
        if h and f:
            f(h)
            self._h = None


class PrepBuffers:
    """One reusable output buffer set for :class:`BatchPrep` — hold two and
    alternate to double-buffer host prep against device steps."""

    __slots__ = ("khi", "klo", "start", "active", "inv", "keys", "n_uniq")

    def __init__(self, batch: int, capacity: int, with_keys: bool = False):
        self.khi = np.empty(capacity, np.int32)
        self.klo = np.empty(capacity, np.int32)
        self.start = np.empty(capacity, np.int32)
        self.active = np.empty(capacity, np.uint8)
        self.inv = np.empty(batch, np.int32)
        self.keys = np.empty(batch, np.uint64) if with_keys else None
        self.n_uniq = 0


class BatchPrep:
    """Fused single-pass batch prep: zipf sample -> keyspace gather ->
    unique+inverse (epoch-tagged hash table) -> router-table probe.

    The native replacement for the numpy prep pipeline (sort-based
    ``np.unique`` + separate router gather); see ``src/prep.cc``.  The
    reference's clients do this work inline in the open benchmark loop
    (``test/benchmark.cpp:159-188``); this class makes the batched engine's
    equivalent cheap enough to sit inside the timed serving loop.

    ``capacity`` bounds the unique keys per batch (the padded device batch
    width); ``run_*`` raises :class:`PrepOverflow` when a batch exceeds it
    so the caller can re-plan with a wider buffer set.
    """

    def __init__(self, batch: int, capacity: int, n_keys: int = 0,
                 theta: float = 0.0, seed: int = 0, salt: int = 0):
        """``salt`` != 0 enables the synthetic rank->key mode: the client
        key for zipf rank r is ``mix64(r ^ salt)`` computed arithmetically
        (build the matching tree keyspace with :func:`synthetic_keyspace`),
        so no keyspace gather sits in the serving loop — the reference
        benchmark's own convention (its key IS the zipf rank)."""
        _require()
        self.batch, self.capacity = int(batch), int(capacity)
        self._h = _shn_prep_new(int(n_keys), float(theta), int(seed),
                                int(batch), int(capacity), int(salt))
        if not self._h:
            raise MemoryError("prep_new failed")

    def buffers(self, with_keys: bool = False) -> PrepBuffers:
        return PrepBuffers(self.batch, self.capacity, with_keys)

    @staticmethod
    def _table_args(table: np.ndarray | None, shift: int, default_start: int):
        if table is None:
            return None, 0, 0, np.int32(default_start)
        t = np.ascontiguousarray(table, np.int32)
        return (t.ctypes.data_as(ct.POINTER(ct.c_int32)), t.size,
                int(shift), np.int32(default_start))

    def _finish(self, n: int, buf: PrepBuffers) -> PrepBuffers:
        if n == -1:
            raise PrepOverflow(
                f"batch exceeded unique capacity {self.capacity}")
        if n < 0:
            raise ConfigError("bad prep arguments")
        buf.n_uniq = int(n)
        return buf

    def run_keys(self, keys: np.ndarray, buf: PrepBuffers,
                 table: np.ndarray | None, shift: int = 0,
                 default_start: int = 0) -> PrepBuffers:
        """Dedup + probe an explicit key batch (<= batch keys)."""
        k = np.ascontiguousarray(keys, np.uint64)
        tp, nb, sh, ds = self._table_args(table, shift, default_start)
        i32 = ct.POINTER(ct.c_int32)
        n = _shn_prep_run_keys(
            self._h, _u64p(k), k.size, tp, nb, sh, ds,
            buf.khi.ctypes.data_as(i32), buf.klo.ctypes.data_as(i32),
            buf.start.ctypes.data_as(i32),
            buf.active.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            buf.inv.ctypes.data_as(i32))
        return self._finish(n, buf)

    def run_zipf(self, keyspace: np.ndarray | None, buf: PrepBuffers,
                 table: np.ndarray | None, shift: int = 0,
                 default_start: int = 0,
                 want_keys: bool = False) -> PrepBuffers:
        """Sample `batch` zipf ops over ``keyspace`` (or the synthetic map
        when constructed with a salt — pass ``keyspace=None``) and prep
        them; with ``want_keys`` the raw client keys land in ``buf.keys``
        (skipped by default: the extra batch*8-byte memcpy is pure waste
        in a timed serving loop)."""
        ksp = None
        if keyspace is not None:
            ks = np.ascontiguousarray(keyspace, np.uint64)
            ksp = _u64p(ks)
        tp, nb, sh, ds = self._table_args(table, shift, default_start)
        i32 = ct.POINTER(ct.c_int32)
        okp = (_u64p(buf.keys) if want_keys and buf.keys is not None
               else None)
        n = _shn_prep_run_zipf(
            self._h, ksp, okp, tp, nb, sh, ds,
            buf.khi.ctypes.data_as(i32), buf.klo.ctypes.data_as(i32),
            buf.start.ctypes.data_as(i32),
            buf.active.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            buf.inv.ctypes.data_as(i32))
        return self._finish(n, buf)

    def __del__(self):
        h, f = getattr(self, "_h", None), globals().get("_shn_prep_free")
        if h and f:
            f(h)
            self._h = None


class PrepOverflow(ShermanError, RuntimeError):
    """A batch's unique-key count exceeded the planned device width."""


def mix64(x) -> np.ndarray:
    """Vectorized splitmix64 finalizer, bit-exact with prep.cc's mix64 (an
    alias of :func:`sherman_tpu_torch.ops.bits.mix64_np`, so the two
    cannot drift)."""
    from sherman_tpu_torch.ops.bits import mix64_np
    return mix64_np(x)


def synthetic_keyspace(n_keys: int, salt: int):
    """The sorted tree keyspace matching BatchPrep's synthetic mode: rank
    r's client key is ``mix64(r ^ salt)``.  Returns (sorted_keys,
    rank_to_key) where rank_to_key[r] is rank r's key.  mix64 is a
    bijection, so distinct ranks never collide; the only failure mode is
    an out-of-range key (0 or KEY_POS_INF), which is CERTAIN for key 0
    when ``salt < n_keys`` (rank == salt maps to mix64(0) == 0) — pick a
    salt with bits above the rank range and the retry loop is one-shot."""
    from sherman_tpu_torch import config as C
    rank_to_key = mix64(np.arange(n_keys, dtype=np.uint64)
                        ^ np.uint64(salt))
    keys = np.sort(rank_to_key)
    if (np.diff(keys) == 0).any() or keys[0] < C.KEY_MIN \
            or keys[-1] > C.KEY_MAX:
        raise ConfigError(f"salt {salt} collides; pick another")
    return keys, rank_to_key


class WRLock:
    """Spinning writer-preference RW lock (``include/WRLock.h`` parity:
    the reference guards the DSM singleton + the IndexCache delay-free
    list with it)."""

    def __init__(self):
        _require()
        self._h = _shn_rw_new()
        if not self._h:
            raise MemoryError("rw lock alloc failed")

    def rlock(self) -> None:
        _shn_rw_rlock(self._h)

    def runlock(self) -> None:
        _shn_rw_runlock(self._h)

    def wlock(self) -> None:
        _shn_rw_wlock(self._h)

    def wunlock(self) -> None:
        _shn_rw_wunlock(self._h)

    def __del__(self):
        h, f = getattr(self, "_h", None), globals().get("_shn_rw_free")
        if h and f:
            f(h)
            self._h = None


class LocalLockTable:
    """Node-local ticket locks with bounded global-lock hand-over."""

    def __init__(self, n_locks: int):
        _require()
        self.n = n_locks
        self._h = _shn_lt_new(n_locks)
        if not self._h:
            raise MemoryError(f"lock table alloc failed (n={n_locks})")

    def acquire(self, i: int) -> bool:
        """Blocks. -> True if the GLOBAL lock was handed over too."""
        return bool(_shn_lt_acquire(self._h, i))

    def can_handover(self, i: int) -> bool:
        """Holder-only probe: would release(True) hand over right now?
        True is binding-safe (waiters block); after a False probe the
        holder must release(False) — see locks.cc."""
        return bool(_shn_lt_can_handover(self._h, i))

    def release(self, i: int, handover_ok: bool = True) -> bool:
        """-> True if handed over (do NOT release the global lock)."""
        return bool(_shn_lt_release(self._h, i, int(handover_ok)))

    def __del__(self):
        h, f = getattr(self, "_h", None), globals().get("_shn_lt_free")
        if h and f:
            f(h)
            self._h = None
