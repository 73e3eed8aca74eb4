"""YCSB A-F workload matrix (counterpart of
``sherman_tpu/workload/ycsb.py``): the core workloads as named,
reproducible batch generators, each with the analytic expectations
published next to its measured row:

========  =============================================  ============
workload  mix                                            distribution
========  =============================================  ============
A         50% read / 50% update                          zipf
B         95% read /  5% update                          zipf
C         100% read                                      zipf
D         95% read /  5% insert (read-latest)            latest
E         95% scan /  5% insert                          zipf
F         50% read / 50% read-modify-write               zipf
========  =============================================  ============

Keys are the repo's standard hashed keyspace (``bits.mix64_np(rank ^
salt)`` — the bulk-load/staged-loop key map), so zipf RANK skew lands
on uniformly scattered keys.  Scans therefore select by KEY SPAN, not
rank span: a scan of expected length L covers ``L * 2^64 / n_keys`` of
the key space (the ``tools/benchmark.py --scan-span`` construction),
and the measured rows-per-scan is published against that analytic
expectation.  "latest" (YCSB-D) skews toward the INSERT FRONTIER:
rank = frontier - 1 - Zipf(theta) sample, so freshly inserted records
are the hottest — the standard YCSB-D shape.

Payload sizes (the value heap's axis): ``value_bytes`` with
``value_dist`` "fixed" (every record exactly that size) or "uniform"
(per-key deterministic uniform in [1, value_bytes], hashed from the
key so regenerating a record is stable across processes).
``payload_for_key`` is the one deterministic record constructor every
driver and verifier shares.
"""

from __future__ import annotations

import numpy as np

from sherman_tpu_torch import config as C
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.workload.zipf import ZipfGen

__all__ = ["WORKLOADS", "YcsbGen", "payload_for_key"]

WORKLOADS = {
    "A": {"read": 0.50, "update": 0.50, "dist": "zipf"},
    "B": {"read": 0.95, "update": 0.05, "dist": "zipf"},
    "C": {"read": 1.00, "dist": "zipf"},
    "D": {"read": 0.95, "insert": 0.05, "dist": "latest"},
    "E": {"scan": 0.95, "insert": 0.05, "dist": "zipf",
          "max_scan": 100},
    "F": {"read": 0.50, "rmw": 0.50, "dist": "zipf"},
}


def payload_for_key(key: int, value_bytes: int,
                    value_dist: str = "fixed") -> bytes:
    """Deterministic variable-length record for ``key`` — the shared
    constructor (drivers write it, verifiers regenerate it).  "fixed"
    -> exactly ``value_bytes``; "uniform" -> stable per-key length in
    [1, value_bytes] (hashed from the key)."""
    if value_dist == "fixed":
        n = int(value_bytes)
    elif value_dist == "uniform":
        n = 1 + int(bits.mix64_host(int(key) ^ 0x5CAB) % int(value_bytes))
    else:
        raise ConfigError(
            f"value_dist={value_dist!r}: want fixed|uniform")
    seed = np.uint64(bits.mix64_host(int(key)))
    block = seed.tobytes()
    return (block * (n // 8 + 1))[:n]


class YcsbGen:
    """Batched op-stream generator for one YCSB core workload.

    ``batch(n)`` draws one closed-loop batch as class-separated arrays
    (the repo's batched execution model — no per-op scalar loop):
    ``{"read": keys, "update": keys, "insert": keys, "scan": [(lo,
    hi)], "rmw": keys}``, advancing the insert frontier for D/E.
    ``expectations()`` is the analytic twin every receipt publishes.
    """

    def __init__(self, workload: str, n_keys: int, *,
                 theta: float = 0.99, seed: int = 0,
                 salt: int = 0x5E17_AB1E_5A17,
                 value_bytes: int = 64, value_dist: str = "fixed"):
        if workload not in WORKLOADS:
            raise ConfigError(
                f"unknown YCSB workload {workload!r}: want one of "
                f"{sorted(WORKLOADS)}")
        self.workload = workload
        self.mix = WORKLOADS[workload]
        self.n_keys = int(n_keys)
        self.theta = float(theta)
        self.salt = int(salt)
        self.value_bytes = int(value_bytes)
        self.value_dist = value_dist
        self.rng = np.random.default_rng(seed)
        self.zipf = ZipfGen(self.n_keys, theta, seed=seed + 1)
        #: next fresh rank D/E inserts append at (read-latest skews
        #: toward it)
        self.frontier = self.n_keys
        self.ops_drawn = 0

    # -- keyspace -------------------------------------------------------------

    def keys_of_ranks(self, ranks) -> np.ndarray:
        k = bits.mix64_np(np.asarray(ranks, np.uint64)
                          ^ np.uint64(self.salt))
        # keep clear of the fence sentinels (astronomically rare, but a
        # generator must not be able to emit an illegal key)
        return np.clip(k, np.uint64(C.KEY_MIN), np.uint64(C.KEY_MAX))

    def payloads_for_keys(self, keys) -> list:
        return [payload_for_key(int(k), self.value_bytes,
                                self.value_dist) for k in keys]

    def _hot_ranks(self, n: int) -> np.ndarray:
        if self.mix["dist"] == "latest":
            # read-latest: hottest = newest (frontier - 1 - zipf)
            z = self.zipf.sample(n)
            return np.maximum(0, self.frontier - 1 - z)
        return self.zipf.sample(n)

    def scan_span(self, length: int) -> int:
        """Key-space span expected to cover ``length`` records in the
        hashed keyspace (uniform key scatter)."""
        live = max(1, self.frontier)
        return max(1, int(length * (2.0 ** 64) / live))

    # -- batches --------------------------------------------------------------

    def batch(self, n: int) -> dict:
        """One n-op batch as class-separated arrays (see class doc)."""
        u = self.rng.random(n)
        out: dict = {}
        edges = 0.0
        kinds = np.empty(n, dtype="U6")
        for kind, frac in self.mix.items():
            if kind in ("dist", "max_scan"):
                continue
            kinds[(u >= edges) & (u < edges + frac)] = kind
            edges += frac
        kinds[u >= edges] = next(k for k in self.mix
                                 if k not in ("dist", "max_scan"))
        for kind in ("read", "update", "rmw"):
            m = int((kinds == kind).sum())
            if m:
                out[kind] = self.keys_of_ranks(self._hot_ranks(m))
        m_ins = int((kinds == "insert").sum())
        if m_ins:
            ranks = np.arange(self.frontier, self.frontier + m_ins,
                              dtype=np.uint64)
            self.frontier += m_ins
            out["insert"] = self.keys_of_ranks(ranks)
        m_scan = int((kinds == "scan").sum())
        if m_scan:
            max_scan = int(self.mix.get("max_scan", 100))
            lens = self.rng.integers(1, max_scan + 1, m_scan)
            starts = self.keys_of_ranks(self._hot_ranks(m_scan))
            out["scan"] = [
                (int(s), min(int(s) + self.scan_span(int(ln)),
                             (1 << 64) - 1))
                for s, ln in zip(starts, lens)]
            out["scan_expected_rows"] = int(lens.sum())
        self.ops_drawn += n
        return out

    # -- analytics ------------------------------------------------------------

    def expectations(self) -> dict:
        """The receipt's analytic block: op-class fractions by
        construction, plus mean scan length (E)."""
        exp = {k: v for k, v in self.mix.items()
               if k not in ("dist", "max_scan")}
        out = {"mix": exp, "dist": self.mix["dist"],
               "theta": self.theta,
               "value_bytes": self.value_bytes,
               "value_dist": self.value_dist}
        if "scan" in exp:
            out["scan_len_mean"] = (1 + self.mix["max_scan"]) / 2.0
        return out
