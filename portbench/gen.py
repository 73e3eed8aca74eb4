"""The benchmark's inputs, the same for the same seed: the loaded values,
the keys, and the ring of client batches.

- Values: 8-byte words drawn at random from the seed, one a rank, so that
  an answer is right only where it was read from the tree.
- Keys: ``mix64(rank ^ key_salt)`` with the configuration's salt (the
  scrambled zipfian of YCSB: hot ranks land all over the keyspace),
  computed on the card by :func:`mix64_torch` and checked against the
  reference's numpy copy on a sample.  The salt is not drawn from the
  seed: where the hottest keys fall decides how much work a batch is
  (PERF.md), and every seed has to get the same work.
- The ring: ``ring_batches`` distinct batches of the configuration's
  width, made before the window from the traffic file's parameters by
  one general generator (:func:`make_ring`): per op a read or an update
  (YCSB's operation chooser), a rank from the zipfian sampler over the
  loaded ranks, and for an update a fresh value from the seed.  The
  window sends the ring's batches in turn.

Every seed gives the same sizes; only the draws move.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import kv

_C1 = 0xBF58476D1CE4E5B9 - (1 << 64)    # the constants as int64 bits
_C2 = 0x94D049BB133111EB - (1 << 64)

# the generator's independent streams under one seed
_VALUES, _SAMPLE, _RING = 1, 2, 3
KEEP = 4         # the window batches whose answers the check keeps


def rng(seed: int, stream: int) -> np.random.Generator:
    """One independent stream of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 words holding uint64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64_torch(x: torch.Tensor) -> torch.Tensor:
    """:func:`portbench.reference.kv.mix64` on int64 tensors (wrapping)."""
    x = x ^ _srl(x, 30)
    x = x * _C1
    x = x ^ _srl(x, 27)
    x = x * _C2
    return x ^ _srl(x, 31)


def make_values(seed: int, n: int) -> np.ndarray:
    return rng(seed, _VALUES).integers(0, 1 << 64, n, dtype=np.uint64,
                                       endpoint=False)


def make_keys(salt: int, n: int, device, seed: int = 0
              ) -> tuple[int, np.ndarray]:
    """-> (salt, key by rank, uint64 [n]): distinct keys inside the open
    key range (the salt moves on by one while a key falls on a fence);
    ``seed`` picks the sample the card's arithmetic is checked on."""
    ranks = torch.arange(n, dtype=torch.int64, device=device)
    while True:
        k = mix64_torch(ranks ^ salt)
        if not bool(((k == 0) | (k == -1)).any()):
            break
        salt += 1
    keys = k.cpu().numpy().view(np.uint64)
    del k, ranks
    # the card's arithmetic against the reference's on a sample
    pick = np.unique(np.concatenate([
        np.arange(min(n, 4096)),
        rng(seed, _SAMPLE).integers(0, n, 4096)]))
    want = kv.mix64(pick.astype(np.uint64) ^ np.uint64(salt))
    if not np.array_equal(keys[pick], want):
        raise RuntimeError("mix64 on the card disagrees with the reference")
    return salt, keys


@dataclass
class Batch:
    """One client batch: ``ranks`` (the reference's view), ``keys`` (the
    program's), per op ``is_read``, and ``values`` (read rows unused)."""
    slot: int
    ranks: np.ndarray
    keys: np.ndarray
    is_read: np.ndarray
    values: np.ndarray

    @property
    def n(self) -> int:
        return self.ranks.shape[0]


def make_ring(traffic: dict, n_keys: int, width: int, seed: int,
              keys: np.ndarray) -> list[Batch]:
    """The ring of ``traffic["ring_batches"]`` batches of ``width`` ops."""
    if traffic["request_distribution"] == "zipfian":
        sampler = kv.ZipfRanks(n_keys, float(traffic["zipf_theta"]))
    elif traffic["request_distribution"] == "uniform":
        sampler = kv.ZipfRanks(n_keys, 0.0)
    else:
        raise ValueError(f"request_distribution "
                         f"{traffic['request_distribution']!r}")
    p_read = float(traffic["read_proportion"])
    if abs(p_read + float(traffic["update_proportion"]) - 1.0) > 1e-12:
        raise ValueError("read_proportion + update_proportion must be 1")
    g = rng(seed, _RING)
    ring = []
    for slot in range(int(traffic["ring_batches"])):
        ranks = sampler.sample(g, width)
        is_read = g.random(width) < p_read
        values = g.integers(0, 1 << 64, width, dtype=np.uint64,
                            endpoint=False)
        ring.append(Batch(slot, ranks, keys[ranks], is_read, values))
    return ring
