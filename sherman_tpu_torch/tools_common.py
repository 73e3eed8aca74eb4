"""Shared plumbing of the port's drivers (the counterpart of
``tools/common.py``, the ``test/*.cpp`` prologue: cluster construction,
tree and engine set-up from CLI knobs, and the open-loop admission pacer).

The reference's ``setup_platform`` forces a virtual CPU mesh whenever a
driver asks for more than one node.  The port has no such fallback: N
nodes are emulated in node-major tensors on whichever device the driver
runs on, the card by default, so :func:`require_device` is the whole
platform choice.  Without a card a driver exits with code 2 unless it was
given ``--device cpu`` (the tests do).
"""

from __future__ import annotations

import sys
import time

import numpy as np


def add_device_arg(p) -> None:
    """The drivers' ``--device`` argument (``cuda`` by default)."""
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for a rehearsal at a small "
                        "size")


def require_device(device: str, what: str) -> None:
    """Exit with code 2 when ``device`` is the card and there is none."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"sherman_tpu_torch.{what}: no CUDA device; it runs on the GPU "
              "(--device cpu rehearses it)", file=sys.stderr)
        raise SystemExit(2)


def run_cli(main) -> int:
    """``python -m`` entry: run ``main()``, which raises on a failure and
    exits 2 without a card; a receipt means 0."""
    main()
    return 0


def build_cluster(n_nodes: int, pages_per_node: int, batch_per_node: int,
                  locks_per_node: int = 65_536, chunk_pages: int = 4096, *,
                  device: str = "cuda", keeper=None, **cfg):
    """``tools/common.build_cluster`` on ``device``: cluster, tree and an
    engine at ``sibling_chase_budget=1``; ``cfg`` goes to ``DSMConfig``.
    ``keeper``: ``init_multihost``'s, whose ranks then share the nodes."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    c = DSMConfig(machine_nr=n_nodes, pages_per_node=pages_per_node,
                  locks_per_node=locks_per_node,
                  step_capacity=batch_per_node, chunk_pages=chunk_pages,
                  device=device, **cfg)
    cluster = Cluster(c, keeper=keeper)
    tree = Tree(cluster)
    eng = batched.BatchedEngine(tree, batch_per_node=batch_per_node,
                                tcfg=TreeConfig(sibling_chase_budget=1))
    return cluster, tree, eng


def pages_for_keys(n_keys: int, fill: float = 0.75) -> int:
    """Pages a node for ``n_keys`` keys at ``fill``: 1.1 x the leaves plus
    8,192, rounded up to a power of two (at least 4,096)."""
    from sherman_tpu_torch.config import LEAF_CAP
    per_leaf = max(1, int(LEAF_CAP * fill))
    est = int(n_keys / per_leaf * 1.10) + 8192
    return 1 << max(12, (est - 1).bit_length())


def unique_keys(n_keys: int, seed: int, hi: int = 1 << 63,
                over: float = 1.05) -> np.ndarray:
    """The reference drivers' keyspace: ``np.unique`` of ``over x n``
    draws in ``[1, hi)`` from ``default_rng(seed)``, the first ``n``, by
    one sort."""
    from sherman_tpu_torch.utils import sorted_unique
    rng = np.random.default_rng(seed)
    return sorted_unique(rng.integers(1, hi, int(n_keys * over),
                                      dtype=np.uint64))[:n_keys]


def drill_keyspace(n_keys: int, seed: int = 3) -> np.ndarray:
    """The reference drills' keys: :func:`unique_keys` below 2^56."""
    return unique_keys(n_keys, seed, hi=1 << 56)


def in_sorted(keys: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    """``np.isin(keys, sorted_set)`` for a sorted ``sorted_set``."""
    if sorted_set.size == 0:
        return np.zeros(keys.shape, bool)
    pos = np.searchsorted(sorted_set, keys)
    return sorted_set[np.minimum(pos, sorted_set.size - 1)] == keys


def verify_all(eng, keys: np.ndarray, xor) -> None:
    """``search_combined`` every key in batches of the engine's width: each
    must be found with the value ``key ^ xor``."""
    bad = 0
    for i in range(0, keys.size, eng.total):
        k = keys[i:i + eng.total]
        v, f = eng.search_combined(k)
        bad += int((~f | (v != (k ^ np.uint64(xor)))).sum())
    if bad:
        raise AssertionError(f"{bad} of {keys.size} keys missing or wrong")


def sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class AdmissionPacer:
    """The ``perf_counter_ns`` sleep+spin admission pacer of the open-loop
    drivers (``serve_bench`` and ``latency_bench``; the counterpart of
    ``tools/common.py``'s, in one copy).

    ``time.sleep`` alone cannot pace sub-ms periods, so the pacer sleeps
    until ``spin_ns`` before each deadline, then spins on the ns clock;
    the spin budget is capped at half the period.  Every admission's
    pacing error (dispatch time - due time) is recorded;
    :meth:`jitter_receipt` publishes its p50/p99 and an ``adm_feasible``
    verdict (p99 error small against the period).

    Usage::

        pacer = AdmissionPacer(period_s, spin_ms=2.0)
        pacer.start()                 # schedule anchored 2 periods out
        for i in range(n):
            pacer.wait_turn(i)        # blocks until deadline i
            ... dispatch ...

    One pacer paces one admission stream; ``merge_errors`` merges
    several pacers' errors into one receipt."""

    def __init__(self, period_s: float, spin_ms: float = 2.0):
        assert period_s > 0
        self._clock = time.perf_counter_ns
        self._sleep = time.sleep
        self.period_ns = int(period_s * 1e9)
        # duty-cycle bound: never spin more than half the period
        self.spin_ns = int(min(spin_ms * 1e6, 0.5 * self.period_ns))
        self.errors_ns: list[int] = []
        self._t_base: int | None = None

    def start(self, lead_periods: int = 2) -> None:
        """Anchor the schedule ``lead_periods`` periods from now."""
        self._t_base = self._clock() + lead_periods * self.period_ns

    def due_ns(self, i: int) -> int:
        assert self._t_base is not None, "call start() first"
        return self._t_base + i * self.period_ns

    def wait_turn(self, i: int) -> int:
        """Block (sleep, then spin) until deadline ``i``; returns and
        records the pacing error in ns (>= 0: late dispatch)."""
        due = self.due_ns(i)
        now = self._clock()
        if now < due - self.spin_ns:
            self._sleep((due - self.spin_ns - now) / 1e9)
        while True:
            now = self._clock()
            if now >= due:
                break
        err = now - due
        self.errors_ns.append(err)
        return err

    def absorb_stall(self, next_i: int, cap_ns: int) -> None:
        """Re-anchor the schedule by at most ``cap_ns`` after an observer
        stall; uncapped re-anchoring would hide genuine backlog
        (coordinated omission)."""
        lag = self._clock() - self.due_ns(next_i)
        if lag > 0:
            self._t_base += min(lag, cap_ns)

    def merge_errors(self, other: "AdmissionPacer") -> None:
        self.errors_ns.extend(other.errors_ns)

    def jitter_receipt(self, feasible_frac: float = 0.25) -> dict:
        """{adm_jitter_p50_ms, adm_jitter_p99_ms, adm_spin_budget_ms,
        adm_feasible, pacing}."""
        errs = self.errors_ns or [0]
        p50 = float(np.percentile(errs, 50)) / 1e6
        p99 = float(np.percentile(errs, 99)) / 1e6
        return {
            "adm_jitter_p50_ms": round(p50, 3),
            "adm_jitter_p99_ms": round(p99, 3),
            "adm_spin_budget_ms": round(self.spin_ns / 1e6, 3),
            "adm_feasible": bool(
                p99 < feasible_frac * self.period_ns / 1e6),
            "pacing": "sleep+spin",
        }
