"""Zipfian workload generator — YCSB-style skewed ranks over [0, n)
(the numpy path of ``sherman_tpu/workload/zipf.py``), after Gray et al.,
"Quickly Generating Billion-Record Synthetic Databases" (SIGMOD '94).
theta = 0.99 is the canonical YCSB skew.
"""

from __future__ import annotations

import numpy as np


def _zeta(n: int, theta: float, chunk: int = 1 << 22) -> float:
    """zeta(n, theta) = sum_{i=1..n} 1/i^theta, chunked to bound memory."""
    total = 0.0
    i = 1
    while i <= n:
        j = min(n, i + chunk - 1)
        ks = np.arange(i, j + 1, dtype=np.float64)
        total += float(np.sum(ks ** -theta))
        i = j + 1
    return total


class ZipfGen:
    """Zipf(theta) rank sampler over [0, n); rank 0 is the hottest.
    Draws come from ``rng`` (a ``numpy.random.Generator``), else from
    ``numpy.random.default_rng(seed)``."""

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0,
                 rng: np.random.Generator | None = None):
        if not (n >= 1 and 0.0 <= theta < 1.0):
            raise ValueError(f"ZipfGen(n={n}, theta={theta}): want n >= 1, "
                             "0 <= theta < 1")
        self.n = n
        self.theta = theta
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self.zetan = _zeta(n, theta)
        self.zeta2 = _zeta(2, theta)
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = ((1.0 - (2.0 / n) ** (1.0 - theta))
                    / (1.0 - self.zeta2 / self.zetan))

    def sample(self, size: int) -> np.ndarray:
        """-> int64 ranks [size] in [0, n)."""
        u = self.rng.random(size)
        uz = u * self.zetan
        ranks = (self.n * (self.eta * u - self.eta + 1.0) ** self.alpha
                 ).astype(np.int64)
        ranks = np.where(uz < 1.0, 0, ranks)
        ranks = np.where((uz >= 1.0) & (uz < 1.0 + 0.5 ** self.theta),
                         1, ranks)
        return np.clip(ranks, 0, self.n - 1)


def uniform_ranks(n: int, size: int, rng: np.random.Generator) -> np.ndarray:
    """theta=0 degenerate case: uniform over [0, n)."""
    return rng.integers(0, n, size, dtype=np.int64)


def expected_hit_ratio(n: int, theta: float, k: int) -> float:
    """Analytic Zipf(theta) CDF at rank ``k``: the chance that one sample
    over [0, n) lands in the hottest ``k`` ranks, i.e. the hit ratio a
    hot-key cache holding exactly the top ``k`` keys should measure
    (``zeta(k, theta) / zeta(n, theta)``; theta 0 gives ``k / n``)."""
    assert n >= 1 and 0.0 <= theta < 1.0
    k = max(0, min(int(k), int(n)))
    if k == 0:
        return 0.0
    if theta == 0.0:
        return k / n
    return _zeta(k, theta) / _zeta(n, theta)
