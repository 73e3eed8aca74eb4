"""Zipfian workload generator — YCSB-style skewed ranks over [0, n)
(counterpart of ``sherman_tpu/workload/zipf.py``), after Gray et al.,
"Quickly Generating Billion-Record Synthetic Databases" (SIGMOD '94).
theta = 0.99 is the canonical YCSB skew.
"""

from __future__ import annotations

import numpy as np

from sherman_tpu_torch.errors import PreconditionError


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

    Without ``rng`` it prefers the native sampler
    (:mod:`sherman_tpu_torch.native`, bit-identical with the reference's
    for one seed) and falls back to the vectorized numpy path when the
    library cannot load.  With ``rng`` (a ``numpy.random.Generator``) it
    always takes the numpy path and draws from ``rng``."""

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0,
                 rng: np.random.Generator | None = None):
        if not (n >= 1 and 0.0 <= theta < 1.0):
            raise PreconditionError(f"ZipfGen(n={n}, theta={theta}): want "
                                    "n >= 1, 0 <= theta < 1")
        self.n = n
        self.theta = theta
        self._native = None
        if rng is None:
            from sherman_tpu_torch import native
            if native.available():
                self._native = native.ZipfGen(n, theta, seed)
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        if self._native is None:
            self._init_fallback()

    def _init_fallback(self) -> None:
        """The numpy path's constants: two O(n) zeta sums, paid only when
        the native sampler is not used."""
        n, theta = self.n, self.theta
        self.zetan = _zeta(n, theta)
        self.zeta2 = _zeta(2, theta)
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = ((1.0 - (2.0 / n) ** (1.0 - theta))
                    / (1.0 - self.zeta2 / self.zetan))

    def sample(self, size: int) -> np.ndarray:
        """-> int64 ranks [size] in [0, n)."""
        if self._native is not None:
            return self._native.sample(size).astype(np.int64)
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
