"""Plain reference of the served semantics: a value table by rank.

Sherman serves linearizable point reads and updates of 8-byte values
under 8-byte keys.  The benchmark draws every op as a key *rank* and
maps it to a key with :func:`mix64`; this reference never needs the
keys, only the ranks.

Batches are sequential.  Within a batch the configuration states the
semantics of the port's ``BatchedEngine.mixed``, and
:meth:`KVReference.check_batch` holds a batch's answers to exactly it:

- of one key's updates in a batch the first applies (acknowledged
  ``APPLIED``, its value stored) and the later are ``SUPERSEDED``; an
  update refused with ``ST_LOCK_TIMEOUT`` is not applied (a refused
  first update leaves the key as it was, and none of its later ones may
  apply);
- a read answers ``found`` and its key's value before the batch, or the
  value the batch's applied update of the key stored (a read that
  overran the descent retries after the batch's writes, as ``mixed``'s
  docstring allows).

A batch whose answers the check did not keep (:meth:`apply_batch`)
advances the table by the same rule.

This module imports numpy only: nothing of the program under test.  It
carries its own frozen copies of the key map (:func:`mix64`, the
splitmix64 finalizer) and of the zipfian rank sampler (:class:`ZipfRanks`,
Gray et al.'s method as YCSB's ``ZipfianGenerator`` draws it).
"""

from __future__ import annotations

import numpy as np

# write acknowledgements, as the port's ``models/batched.py`` numbers them
ST_APPLIED = 1
ST_SUPERSEDED = 2
ST_LOCK_TIMEOUT = 8      # a refusal: the update was not applied
# the open key range (the fences -inf = 0 and +inf = 2**64 - 1 excluded)
KEY_MIN = 1
KEY_MAX = (1 << 64) - 2


def mix64(x) -> np.ndarray:
    """splitmix64's finalizer on uint64 (wrapping), a bijection."""
    x = np.asarray(x, np.uint64).copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def zeta(n: int, theta: float) -> float:
    """sum_{i=1..n} i**-theta.  Exact below 2**22 terms; above, the exact
    head to 2**20 plus the Euler-Maclaurin tail (three correction terms,
    error far under 1e-12 of the sum)."""
    if theta == 0.0:
        return float(n)
    head = min(n, 1 << 22 if n <= 1 << 22 else 1 << 20)
    total = 0.0
    for lo in range(1, head + 1, 1 << 20):
        hi = min(head, lo + (1 << 20) - 1)
        total += float(np.sum(np.arange(lo, hi + 1, dtype=np.float64)
                              ** -theta))
    if head == n:
        return total
    m, t = float(head), theta
    f = lambda x: x ** -t
    d1 = lambda x: -t * x ** (-t - 1)
    d3 = lambda x: -t * (t + 1) * (t + 2) * x ** (-t - 3)
    tail = ((n ** (1 - t) - m ** (1 - t)) / (1 - t)
            + (f(float(n)) - f(m)) / 2
            + (d1(float(n)) - d1(m)) / 12
            - (d3(float(n)) - d3(m)) / 720)
    return total + tail


class ZipfRanks:
    """Zipf(theta) ranks over [0, n), rank 0 the hottest (theta 0:
    uniform).  ``sample(rng, size)`` draws from a numpy Generator."""

    def __init__(self, n: int, theta: float):
        if not (n >= 1 and 0.0 <= theta < 1.0):
            raise ValueError(f"ZipfRanks(n={n}, theta={theta})")
        self.n, self.theta = int(n), float(theta)
        self.zetan = zeta(self.n, self.theta)
        self.zeta2 = zeta(2, self.theta)
        self.alpha = 1.0 / (1.0 - self.theta)
        self.eta = ((1.0 - (2.0 / self.n) ** (1.0 - self.theta))
                    / (1.0 - self.zeta2 / self.zetan)) if self.n > 2 else 1.0

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        u = rng.random(size)
        uz = u * self.zetan
        r = (self.n * (self.eta * u - self.eta + 1.0) ** self.alpha
             ).astype(np.int64)
        r = np.where(uz < 1.0, 0, r)
        r = np.where((uz >= 1.0) & (uz < 1.0 + 0.5 ** self.theta), 1, r)
        return np.clip(r, 0, self.n - 1)


def first_writes(ranks: np.ndarray, is_read: np.ndarray):
    """One order's outcome of a batch's updates, the first of a key
    applying: -> (op indices of the applied updates, each op's ack;
    reads 0)."""
    w = np.flatnonzero(~is_read)
    order = np.argsort(ranks[w], kind="stable")
    sr = ranks[w][order]
    head = np.ones(sr.shape[0], bool)
    head[1:] = sr[1:] != sr[:-1]
    applied = w[order[head]]
    ack = np.zeros(ranks.shape[0], np.int32)
    ack[w] = ST_SUPERSEDED
    ack[applied] = ST_APPLIED
    return applied, ack


def unique_sorted(a: np.ndarray) -> np.ndarray:
    """Sorted distinct values (by a sort: numpy's unique may hash)."""
    s = np.sort(a)
    keep = np.ones(s.shape[0], bool)
    keep[1:] = s[1:] != s[:-1]
    return s[keep]


class KVReference:
    """The value table by rank, advanced batch by batch."""

    def __init__(self, values: np.ndarray):
        self.table = np.array(values, np.uint64, copy=True)

    def read(self, ranks: np.ndarray) -> np.ndarray:
        return self.table[ranks]

    def apply(self, ranks: np.ndarray, values: np.ndarray,
              applied: np.ndarray) -> None:
        """Store updates known to land (:func:`first_writes`' indices)."""
        self.table[ranks[applied]] = values[applied]

    def apply_batch(self, ranks, is_read, values, refused=()) -> None:
        """Advance the table by one batch: the first update of each key
        lands unless it was refused (``refused``: op indices)."""
        applied, _ = first_writes(ranks, is_read)
        if len(refused):
            applied = np.setdiff1d(applied, refused)
        self.apply(ranks, values, applied)

    def check_batch(self, ranks, is_read, values, got_vals, got_found,
                    got_acks) -> dict:
        """Hold one batch's answers to the semantics above and advance
        the table.  -> {"wrong_reads", "wrong_acks", "refused",
        "multi_applied"} counts (``multi_applied``: updates acknowledged
        ``APPLIED`` after their key's first, each also a wrong ack)."""
        applied, want = first_writes(ranks, is_read)
        upd = ~is_read
        refused = upd & (got_acks == ST_LOCK_TIMEOUT)
        bad = upd & ~refused & (got_acks != want)
        multi = bad & (got_acks == ST_APPLIED)
        ri = np.flatnonzero(is_read)
        before = self.table[ranks[ri]]
        self.apply(ranks, values, applied[~refused[applied]])
        after = self.table[ranks[ri]]
        ans = got_vals[ri]
        ok = got_found[ri] & ((ans == before) | (ans == after))
        return {"wrong_reads": int(np.count_nonzero(~ok)),
                "wrong_acks": int(np.count_nonzero(bad)),
                "refused": int(np.count_nonzero(refused)),
                "multi_applied": int(np.count_nonzero(multi))}

    def check_readback(self, ranks, got_vals, got_found) -> int:
        """-> reads of ``ranks`` after the last batch that are not
        ``found`` with the key's value."""
        return int(np.count_nonzero(
            ~(got_found & (got_vals == self.table[ranks]))))
