"""Carry a tree's state into the port: the counterpart of loading weights.

A tree built by the JAX package (or saved from it) is plain arrays: the
pool, the lock table, the op counters, the root, the allocators'
high-water marks, their reclaimed-page pools and, with a value heap, the
heap region.  :func:`from_jax_arrays` takes them as numpy arrays —
``np.asarray(cluster.dsm.pool)`` and friends — and returns a port
cluster, tree and engine serving the same tree on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, PAGE_WORDS, TreeConfig
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.models.batched import BatchedEngine
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.models.router import LeafRouter
from sherman_tpu_torch.parallel.dsm import N_COUNTERS
from sherman_tpu_torch.utils.checkpoint import set_free_pools


def from_jax_arrays(pool, locks, counters, root_addr, root_level, alloc_next,
                    leaf_dir=None, *, device, batch_per_node: int = 1024,
                    tcfg: TreeConfig | None = None, router_table=None,
                    router_shift: int | None = None, free_pages=(),
                    heap=None, **cfg_kw):
    """-> (cluster, tree, engine) whose pool, locks, counters, root,
    allocator high-water marks and free pools equal the given arrays'.

    The arrays are the reference's global, node-major ones for ``N``
    nodes: ``pool`` ``[N*P, 256]`` int32, ``locks`` ``[N*L]`` int32,
    ``counters`` ``[N*N_COUNTERS]`` uint32; ``alloc_next`` holds each
    node's ``GlobalAllocator.pages_used`` (one int for one node), and its
    length is ``N``.  ``leaf_dir`` optionally the bulk-load leaf
    directory ``(addrs, lows)`` that seeds the router.  ``free_pages``
    the allocators' reclaimed-page pools as packed page addresses, each
    node's in its ``GlobalAllocator.free_pages_list`` order (the last is
    popped first), e.g. the concatenation of every directory's list
    through ``bits.make_addr``; a tree that ran ``reclaim_empty_leaves``
    must carry them, or its next page-grain allocation takes fresh bump
    space where the reference pops the pool.  ``router_table``
    optionally the reference router's ``table_np`` (a power-of-two number
    of int32 start addresses) with its ``router_shift``: the engine gets
    a router holding exactly that table, so a staged loop carried across
    probes the same start pages.  ``heap`` optionally the reference's
    value-heap region (``[N*H, 256]`` int32, ``np.asarray(dsm.heap)``):
    the cluster gets a heap of ``H`` pages a node holding it, and the
    engine an attached ``ValueHeap`` whose allocator is rebuilt from the
    region, as recovery rebuilds it.  Extra keyword arguments go to
    :class:`DSMConfig`."""
    # writable host copies only where needed: torch refuses to wrap the
    # read-only buffers np.asarray gives for a JAX array
    pool = np.require(pool, np.int32, ("C", "W"))
    locks = np.require(locks, np.int32, ("C", "W"))
    counters = np.asarray(counters).astype(np.uint32).ravel()
    alloc_next = np.atleast_1d(np.asarray(alloc_next, np.int64))
    N = alloc_next.shape[0]
    if pool.ndim != 2 or pool.shape[1] != PAGE_WORDS or pool.shape[0] % N:
        raise ConfigError(f"pool shape {pool.shape}: want [{N}*P, "
                          f"{PAGE_WORDS}]")
    if locks.ndim != 1 or locks.shape[0] % N:
        raise ConfigError(f"locks shape {locks.shape}: want [{N}*L]")
    if counters.shape != (N * N_COUNTERS,):
        raise ConfigError(f"counters shape {counters.shape}: want "
                          f"[{N * N_COUNTERS}] ({N} nodes)")
    if int(pool[0, 0]) != int(root_addr):
        raise ConfigError(
            f"root_addr={root_addr} disagrees with the pool's meta word "
            f"{int(pool[0, 0])}")
    if heap is not None:
        heap = np.require(heap, np.int32, ("C", "W"))
        if heap.ndim != 2 or heap.shape[1] != PAGE_WORDS \
                or heap.shape[0] % N or not heap.shape[0]:
            raise ConfigError(f"heap shape {heap.shape}: want [{N}*H, "
                              f"{PAGE_WORDS}]")
        cfg_kw["heap_pages_per_node"] = heap.shape[0] // N
    cfg = DSMConfig(machine_nr=N, pages_per_node=pool.shape[0] // N,
                    locks_per_node=locks.shape[0] // N, device=device,
                    **cfg_kw)
    cluster = Cluster(cfg)
    dsm = cluster.dsm
    dsm.pool.copy_(torch.from_numpy(pool))
    dsm.locks.copy_(torch.from_numpy(locks))
    if heap is not None:
        dsm.heap.copy_(torch.from_numpy(heap))
    for d in cluster.directories:
        d.allocator._next = int(alloc_next[d.node_id])
    set_free_pools(cluster, free_pages)
    # the root is installed, so the tree adopts it instead of building one
    tree = Tree(cluster)
    if (tree._root_addr, tree._root_level) != (int(root_addr),
                                               int(root_level)):
        raise ConfigError(
            f"root (addr {root_addr}, level {root_level}) disagrees with "
            f"the pool's root page (addr {tree._root_addr}, level "
            f"{tree._root_level})")
    # after the tree's own root read, which counts one page read
    dsm.counters.copy_(torch.from_numpy(counters.astype(np.int64)))
    if leaf_dir is not None:
        tree._bulk_leaf_dir = (np.asarray(leaf_dir[0]).copy(),
                               np.asarray(leaf_dir[1], np.uint64).copy())
    cluster.broadcast_new_root(tree._root_addr, tree._root_level)
    engine = BatchedEngine(tree, batch_per_node=batch_per_node, tcfg=tcfg)
    if router_table is not None:
        engine.router = _router_of(tree, router_table, router_shift)
    if heap is not None:
        from sherman_tpu_torch.models.value_heap import ValueHeap
        ValueHeap(engine).rebuild()
    return cluster, tree, engine


def _router_of(tree, table, shift):
    """A :class:`LeafRouter` of ``tree`` holding ``table`` and ``shift``
    as they are."""
    table = np.array(table, np.int32).ravel()
    nb = table.shape[0]
    if nb < 2 or nb & (nb - 1):
        raise ConfigError(f"router_table of {nb} entries: want a power of "
                          "two >= 2")
    lb = nb.bit_length() - 1
    if shift is None or not 0 <= int(shift) <= 64 - lb:
        raise ConfigError(f"router_shift={shift!r}: want 0..{64 - lb} "
                          "beside router_table")
    r = LeafRouter(tree, lb)
    with r._read_locked():
        r.table_np, r.shift = table, int(shift)
    return r

