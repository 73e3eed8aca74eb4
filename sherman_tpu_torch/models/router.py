"""LeafRouter — the compute-side index cache (counterpart of
``sherman_tpu/models/router.py``).

A host numpy table maps buckets of the uint64 key space (``lb`` bits
starting at ``shift``) to a page address whose ``lowest`` fence is <=
every key of the bucket, normally the key's leaf.  A batch's start
addresses are one vectorized host gather; a stale entry only costs a
B-link sibling chase.  The native writer-preference ``WRLock``
(:mod:`sherman_tpu_torch.native`) keeps (shift, table) from being
observed torn: probes read-lock, maintenance write-locks.
"""

from __future__ import annotations

import threading

import numpy as np

from sherman_tpu_torch import config as C
from sherman_tpu_torch.ops import bits


class _PyRW:
    """Mutex stand-in for the native WRLock where the library cannot
    load: probes serialize with writers, but the (shift, table) pair is
    never observed torn."""

    def __init__(self):
        self._m = threading.Lock()

    def rlock(self):
        self._m.acquire()

    def runlock(self):
        self._m.release()

    wlock, wunlock = rlock, runlock


class _Held:
    """Context manager over explicit acquire/release callables."""

    __slots__ = ("_acq", "_rel")

    def __init__(self, acq, rel):
        self._acq, self._rel = acq, rel

    def __enter__(self):
        self._acq()

    def __exit__(self, *exc):
        self._rel()
        return False


class LeafRouter:
    def __init__(self, tree, log2_buckets: int):
        if not 1 <= log2_buckets <= 32:
            raise ValueError(f"log2_buckets={log2_buckets}: want 1..32")
        self.tree = tree
        self.lb = log2_buckets
        self.nb = 1 << log2_buckets
        self.shift = 64 - log2_buckets
        self.table_np = np.full(self.nb, np.int32(tree._root_addr))
        self.splits_noted = 0
        self.span_grows = 0
        from sherman_tpu_torch import native
        self._rw = native.WRLock() if native.available() else _PyRW()
        tree.router = self

    def _read_locked(self):
        """Context that holds (shift, table) still while it is open: the
        staged loops copy ``table_np`` under it."""
        return _Held(self._rw.rlock, self._rw.runlock)

    def _write_locked(self):
        return _Held(self._rw.wlock, self._rw.wunlock)

    # -- maintenance ---------------------------------------------------------

    def seed_from_leaves(self, leaf_addrs: np.ndarray,
                         leaf_lows: np.ndarray) -> None:
        """Rebuild from a leaf directory (lows sorted ascending, the first
        KEY_NEG_INF), adapting ``shift`` to the observed key span."""
        hi = int(np.max(leaf_lows)) if len(leaf_lows) else 0
        span_bits = max(1, hi.bit_length())
        with self._write_locked():
            self.shift = min(64 - self.lb, max(0, span_bits - self.lb))
            starts = (np.arange(self.nb, dtype=np.uint64)
                      << np.uint64(self.shift))
            idx = np.searchsorted(leaf_lows, starts, side="right") - 1
            self.table_np = (leaf_addrs[np.clip(idx, 0, len(leaf_addrs) - 1)]
                             .astype(np.int32))

    def _grow_span(self, new_max: int) -> None:
        """A split landed beyond the seeded span: widen ``shift`` and remap
        each new bucket to the old bucket holding its start key."""
        span_bits = max(1, int(new_max).bit_length())
        ns = min(64 - self.lb, max(0, span_bits - self.lb))
        if ns <= self.shift:
            return
        step = ns - self.shift
        idx = np.minimum(
            np.arange(self.nb, dtype=np.uint64) << np.uint64(step),
            np.uint64(self.nb - 1))
        self.table_np = self.table_np[idx.astype(np.int64)]
        self.shift = ns
        self.span_grows += 1

    def note_split(self, split_key: int, new_addr: int,
                   old_high: int) -> None:
        """Leaf [.., old_high) split at split_key; right half -> new_addr."""
        with self._write_locked():
            if (split_key >> self.shift) >= self.nb:
                self._grow_span(split_key)
            b_lo = (split_key + (1 << self.shift) - 1) >> self.shift
            if old_high >= C.KEY_POS_INF:
                b_hi = self.nb
            else:
                b_hi = min(self.nb,
                           (old_high + (1 << self.shift) - 1) >> self.shift)
            if b_lo < b_hi:
                self.table_np[b_lo:b_hi] = np.int32(new_addr)
            self.splits_noted += 1

    def note_splits_batch(self, split_keys, new_addrs, old_highs) -> None:
        """:meth:`note_split` for a whole device split log in one
        vectorized table pass.  The splits are of distinct leaves, so
        their bucket ranges are disjoint and their order does not matter;
        an out-of-span split grows the span first."""
        sk = np.asarray(split_keys, np.uint64)
        na = np.asarray(new_addrs, np.int64)
        oh = np.asarray(old_highs, np.uint64)
        if not sk.size:
            return
        with self._write_locked():
            mx = int(sk.max())
            if (mx >> self.shift) >= self.nb:
                self._grow_span(mx)
            # ceil-div without the scalar form's overflow (k + 2^s - 1
            # wraps near the top of the uint64 range)
            sh = np.uint64(self.shift)
            frac = np.uint64((1 << self.shift) - 1)
            b_lo = ((sk >> sh) + ((sk & frac) != 0)).astype(np.int64)
            b_hi = np.where(oh >= np.uint64(C.KEY_POS_INF), self.nb,
                            np.minimum((oh >> sh) + ((oh & frac) != 0),
                                       self.nb)).astype(np.int64)
            b_lo = np.minimum(b_lo, self.nb)
            n = np.maximum(b_hi - b_lo, 0)
            tgt = np.repeat(na.astype(np.int32), n)
            idx = (np.repeat(b_lo, n)
                   + (np.arange(tgt.size) - np.repeat(np.cumsum(n) - n, n)))
            self.table_np[idx] = tgt
            self.splits_noted += int(sk.size)

    def remap_addrs(self, old_to_new: dict[int, int]) -> None:
        """Repoint every bucket seeded at a reclaimed page to its absorber
        (``BatchedEngine.reclaim_empty_leaves``).  The absorber's
        ``lowest`` fence is <= every key of the remapped buckets (it
        absorbed exactly that range), so the router invariant holds.  One
        vectorized ``searchsorted`` pass over the table, whatever the
        number of entries."""
        if not old_to_new:
            return
        to_i32 = lambda v: v.astype(np.uint32).view(np.int32)
        olds = np.array([int(o) & 0xFFFFFFFF for o in old_to_new], np.uint64)
        news = np.array([int(n) & 0xFFFFFFFF for n in old_to_new.values()],
                        np.uint64)
        o32, n32 = to_i32(olds), to_i32(news)
        order = np.argsort(o32)
        o32, n32 = o32[order], n32[order]
        with self._write_locked():
            pos = np.searchsorted(o32, self.table_np)
            pos_c = np.minimum(pos, o32.size - 1)
            hit = o32[pos_c] == self.table_np
            self.table_np[hit] = n32[pos_c[hit]]

    # -- lookup --------------------------------------------------------------

    def host_start(self, khi: np.ndarray, klo: np.ndarray) -> np.ndarray:
        """Start addresses [B] int32 for keys given as int32 word views."""
        key = bits.pairs_to_keys(np.asarray(khi), np.asarray(klo))
        with self._read_locked():
            bucket = np.minimum(key >> np.uint64(self.shift),
                                np.uint64(self.nb - 1))
            return self.table_np[bucket.astype(np.int64)]


def default_log2_buckets(n_leaves: int) -> int:
    """~32 buckets per leaf, capped at 2^26 entries (256 MB of host RAM)."""
    lb = max(8, int(np.ceil(np.log2(max(1, n_leaves) * 32))))
    return min(lb, 26)
