"""Elastic cluster resize: rewrite a checkpoint for another node count (the
port's copy of ``sherman_tpu/utils/reshard.py``; numpy only).

A Sherman tree bakes packed ``{node, page}`` addresses into every internal
entry, sibling link and the root meta word, so moving a dataset from N to
M nodes is an address-space rewrite, not a copy.  This module does that
rewrite OFFLINE on a checkpoint:

1. the live page rows of every old node: the allocators' ``dir_next``
   high-water marks (page 0 a node is reserved), minus leased-but-never-
   written chunk tails and the reclaimed-page free pool (:func:`live_rows`),
2. repacked contiguously onto the new node partition (block assignment,
   page 1 upward on each new node),
3. every pointer word rewritten through the old->new address map: header
   ``leftmost``/``sibling`` of every page, the valid ``InternalEntry`` ptr
   slots (slots >= nkeys are dead and never dereferenced) and the root
   meta word; leaf key and value words are user data and stay as they are,
4. a fresh checkpoint emitted: the single-process format, or with
   ``hosts > 1`` per-host shard files beside an epoch-tagged manifest
   (the reference's multihost format; restoring it in the port is ROADMAP.md
   item 7c-ii, refused by ``utils.checkpoint.restore``).

Locks are emitted cleared (no client of the old incarnation survives) and
the op counters keep their cluster totals on node 0.  The value heap's
handles address the heap by global row, so the heap region is copied
verbatim and its node split padded.  The online migrator
(:mod:`sherman_tpu_torch.migrate`) feeds its staged image through the same
:func:`reshard_arrays`, so the two transforms cannot diverge.

CLI: ``python -m sherman_tpu_torch.utils.reshard <src> <dst> --nodes M
[--hosts H] [--pages-per-node P] [--locks-per-node L]`` prints the summary
as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from sherman_tpu_torch import config as C
from sherman_tpu_torch.errors import ConfigError, ReshardError
from sherman_tpu_torch.parallel.dsm import N_COUNTERS
from sherman_tpu_torch.utils.checkpoint import (_MANIFEST_FIELDS,
                                                _savez_atomic, cfg_from_json,
                                                cfg_to_json, make_epoch)

_PTR_HEADER_WORDS = (C.W_LEFTMOST, C.W_SIBLING)


def _load_checkpoint(path: str):
    """-> (manifest dict, pool [N*P, PW], locks, counters), a multihost
    source's shard files reassembled in node order."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path += ".npz"
    with np.load(path) as z:
        man = {k: np.asarray(z[k]) for k in z.files}
    saved_mh = int(man["multihost"][0]) if "multihost" in man else 0
    if saved_mh == 0:
        pool = man.pop("pool")
        locks = man.pop("locks")
        counters = man.pop("counters")
        return man, pool, locks, counters
    blocks = []
    for h in range(saved_mh):
        with np.load(f"{path}.host{h}.npz") as z:
            blk = {k: np.asarray(z[k]) for k in z.files}
        # a mixed legacy/tagged pair IS torn: skipping the comparison would
        # launder two checkpoints' state into one consistently tagged output
        if ("epoch" in man) != ("epoch" in blk):
            raise ReshardError(
                f"host {h} shard and the manifest disagree on epoch "
                "tagging (mixed legacy/tagged files = torn checkpoint)")
        if "epoch" in blk and not np.array_equal(
                blk["epoch"].ravel(), man["epoch"].ravel()):
            raise ReshardError(
                f"host {h} shard is from a different checkpoint epoch "
                "than the manifest (torn checkpoint)")
        blocks.append(blk)
    blocks.sort(key=lambda b: int(b["nodes"][0]))
    nodes = np.concatenate([b["nodes"] for b in blocks])
    if not np.array_equal(nodes, np.arange(nodes.size)):
        raise ReshardError(f"host shards do not cover nodes 0..N-1: {nodes}")
    return (man,
            np.concatenate([b["pool"] for b in blocks]),
            np.concatenate([b["locks"] for b in blocks]),
            np.concatenate([b["counters"] for b in blocks]))


def _map_ptrs(ptrs: np.ndarray, amap: np.ndarray, P_old: int,
              what: str) -> np.ndarray:
    """Rewrite packed addresses through the old->new map; NULL stays NULL.
    Raises if a nonzero pointer leaves the source address space or targets
    a page outside the live set (a corrupt source checkpoint)."""
    u = ptrs.view(np.uint32) if ptrs.dtype == np.int32 else \
        ptrs.astype(np.uint32)
    node = (u >> np.uint32(C.ADDR_PAGE_BITS)).astype(np.int64)
    page = (u & np.uint32(C.ADDR_PAGE_MASK)).astype(np.int64)
    live = ptrs != 0
    # both fields: a page >= P_old would alias into the next node's rows
    N_old = amap.size // P_old
    oob = live & ((node >= N_old) | (page >= P_old))
    if oob.any():
        raise ReshardError(
            f"{what}: {int(oob.sum())} pointer(s) outside the source "
            f"address space (e.g. {ptrs[oob][:4].tolist()})")
    mapped = amap[np.clip(node * P_old + page, 0, amap.size - 1)]
    dead = live & (mapped == 0)
    if dead.any():
        raise ReshardError(
            f"{what}: {int(dead.sum())} pointer(s) target pages outside "
            f"the live set (e.g. {ptrs[dead][:4].tolist()}) — source "
            "checkpoint is corrupt or allocator marks are wrong")
    return np.where(live, mapped, 0).astype(np.int32)


def live_rows(front_ver: np.ndarray, next_by_node: np.ndarray,
              dir_free, P_old: int, N_old: int) -> np.ndarray:
    """Global pool rows a repack carries, ascending: every allocated page
    (``[1, dir_next)`` a node: the bump allocators never reuse, so the
    mark bounds every allocated page) minus the leased-but-never-written
    chunk tails (``front_ver == 0``, the pool's ``W_FRONT_VER`` column:
    every written page has a nonzero front version) minus the reclaimed-
    page free pool (written but unreachable).  The offline transform and
    the online migrator's copy plan share this one definition."""
    rows = np.concatenate([
        n * P_old + np.arange(1, int(next_by_node[n]), dtype=np.int64)
        for n in range(N_old)]) if N_old else np.zeros(0, np.int64)
    if rows.size:
        rows = rows[front_ver[rows] != 0]
    if rows.size and dir_free is not None and np.asarray(dir_free).size:
        fa = np.asarray(dir_free).astype(np.int64)
        frow = ((fa >> C.ADDR_PAGE_BITS) & 0xFF) * P_old \
            + (fa & C.ADDR_PAGE_MASK)
        # a mask over the pool, not np.isin: the same set, one pass
        free = np.zeros(N_old * P_old, bool)
        free[frow[(frow >= 0) & (frow < free.size)]] = True
        rows = rows[~free[rows]]
    return rows


def reshard_arrays(man: dict, pool: np.ndarray, locks: np.ndarray,
                   counters: np.ndarray, machine_nr: int, *,
                   pages_per_node: int | None = None,
                   locks_per_node: int | None = None,
                   heap: np.ndarray | None = None):
    """The array-level rewrite: (manifest, state arrays) of an N-node pool
    -> (arrays, new_cfg, summary) for an M-node pool, no file I/O.
    ``arrays`` holds ``pool``/``locks``/``counters`` (and ``heap``) and the
    new manifest fields."""
    old_cfg = cfg_from_json(man["cfg"])  # raises on a layout mismatch
    N_old, P_old = old_cfg.machine_nr, old_cfg.pages_per_node
    if pool.shape != (N_old * P_old, C.PAGE_WORDS):
        raise ReshardError(f"pool shape {pool.shape} does not match the "
                           f"manifest config ({N_old}x{P_old} pages)")

    # 1. the live rows (dir_next of the new checkpoint comes from the
    # packed counts: dropped rows return to the allocatable tail)
    next_by_node = np.ones(N_old, np.int64)
    for nid, nxt in zip(man["dir_nodes"], man["dir_next"]):
        next_by_node[int(nid)] = int(nxt)
    rows = live_rows(pool[:, C.W_FRONT_VER], next_by_node,
                     man.get("dir_free"), P_old, N_old)
    L = rows.size

    # 2. the new geometry and block assignment (page 0 a node reserved)
    per_new = -(-L // machine_nr) if L else 0
    if pages_per_node is None:
        pages_per_node = max((N_old * P_old) // machine_nr, per_new + 1)
    # the heap region re-splits over the new node count, padded up so
    # every old row keeps its index (the tail pages are spare capacity)
    H_old = old_cfg.heap_pages_per_node
    if (heap is None) != (H_old == 0):
        raise ReshardError(
            "heap array and manifest heap_pages_per_node disagree "
            f"(heap {'present' if heap is not None else 'absent'}, "
            f"cfg says {H_old} pages/node)")
    heap_per_new = -(-(N_old * H_old) // machine_nr) if H_old else 0
    new_cfg = dataclasses.replace(
        old_cfg, machine_nr=machine_nr, pages_per_node=pages_per_node,
        heap_pages_per_node=heap_per_new,
        **({"locks_per_node": locks_per_node} if locks_per_node else {}))
    if per_new + 1 > pages_per_node:
        raise ConfigError(
            f"{L} live pages need {per_new} pages/node on {machine_nr} "
            f"nodes; pages_per_node={pages_per_node} is too small")
    idx = np.arange(L, dtype=np.int64)
    new_node = idx // max(per_new, 1)
    new_page = idx - new_node * per_new + 1
    amap = np.zeros(N_old * P_old, np.int32)
    amap[rows] = ((new_node << C.ADDR_PAGE_BITS) | new_page).astype(np.int32)

    # 3. repack, rewriting every address word through the map
    new_pool = np.zeros((machine_nr * pages_per_node, C.PAGE_WORDS), np.int32)
    dst_rows = new_node * pages_per_node + new_page
    sub = pool[rows]  # fancy indexing: a fresh writable array
    for w in _PTR_HEADER_WORDS:
        sub[:, w] = _map_ptrs(sub[:, w], amap, P_old, f"header word {w}")
    internal = sub[:, C.W_LEVEL] > 0
    ptrs = sub[:, C.I_PTR_W:C.I_PTR_W + C.INTERNAL_CAP]
    valid = (internal[:, None]
             & (np.arange(C.INTERNAL_CAP)[None, :]
                < sub[:, C.W_NKEYS][:, None]))
    # dead slots (>= nkeys) may hold stale addresses that nothing
    # dereferences: left as they are.  ptrs is a view of sub.
    ptrs[valid] = _map_ptrs(ptrs[valid], amap, P_old, "internal entry")
    new_pool[dst_rows] = sub

    # the root meta word (reserved page 0 of node 0 in both spaces)
    old_root = int(pool[0, C.META_ROOT_ADDR_W])
    new_root = 0
    root_level = -1
    if old_root:
        new_root = int(_map_ptrs(np.asarray([old_root], np.int32), amap,
                                 P_old, "root meta")[0])
        u = np.uint32(np.int64(old_root) & 0xFFFFFFFF)
        root_level = int(pool[int(u >> C.ADDR_PAGE_BITS) * P_old
                              + int(u & C.ADDR_PAGE_MASK), C.W_LEVEL])
    new_pool[0, C.META_ROOT_ADDR_W] = new_root

    # 4. cleared locks; the counters' cluster totals on node 0
    new_locks = np.zeros(machine_nr * new_cfg.locks_per_node, np.int32)
    new_counters = np.zeros(machine_nr * N_COUNTERS, np.uint32)
    new_counters[:N_COUNTERS] = (
        counters.reshape(-1, N_COUNTERS).astype(np.uint64).sum(0)
        & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    counts = np.bincount(new_node, minlength=machine_nr) if L else \
        np.zeros(machine_nr, np.int64)
    new_man = dict(
        cfg=np.frombuffer(cfg_to_json(new_cfg), np.uint8),
        dir_nodes=np.arange(machine_nr, dtype=np.int64),
        dir_next=(counts + 1).astype(np.int64),
        dir_root=np.asarray([[new_root, root_level]] * machine_nr, np.int64),
        # the repack compacts: the old free pool is not carried
        dir_free=np.zeros(0, np.int64),
    )
    assert set(new_man) == set(_MANIFEST_FIELDS)
    arrays = dict(pool=new_pool, locks=new_locks, counters=new_counters,
                  **new_man)
    if heap is not None:
        if heap.shape != (N_old * H_old, C.PAGE_WORDS):
            raise ReshardError(
                f"heap shape {heap.shape} does not match the manifest "
                f"config ({N_old}x{H_old} heap pages)")
        new_heap = np.zeros((machine_nr * heap_per_new, C.PAGE_WORDS),
                            np.int32)
        new_heap[: heap.shape[0]] = heap  # global rows preserved
        arrays["heap"] = new_heap
    summary = {
        "live_pages": int(L),
        "old": {"machine_nr": N_old, "pages_per_node": P_old},
        "new": {"machine_nr": machine_nr, "pages_per_node": pages_per_node},
        "pages_per_new_node": counts.tolist(),
        "root": new_root,
        "root_level": root_level,
    }
    return arrays, new_cfg, summary


def write_resharded(dst: str, arrays: dict, new_cfg, hosts: int = 1) -> str:
    """Persist a :func:`reshard_arrays` result: the single-process npz, or
    with ``hosts > 1`` one shard file a host beside an epoch-tagged
    manifest.  -> the manifest path written."""
    machine_nr = new_cfg.machine_nr
    pages_per_node = new_cfg.pages_per_node
    new_man = {k: arrays[k] for k in _MANIFEST_FIELDS}
    if not dst.endswith(".npz"):
        dst += ".npz"
    if hosts == 1:
        extra = ({"heap": arrays["heap"]} if "heap" in arrays else {})
        _savez_atomic(dst, 0, pool=arrays["pool"], locks=arrays["locks"],
                      counters=arrays["counters"], **extra, **new_man)
        return dst
    if "heap" in arrays:
        raise ConfigError(
            "the value heap is single-process only: emit hosts=1 "
            "checkpoints for heap-bearing clusters")
    if machine_nr % hosts:
        raise ConfigError(f"hosts={hosts} must divide machine_nr="
                          f"{machine_nr} (contiguous node blocks)")
    nph = machine_nr // hosts
    L = new_cfg.locks_per_node
    epoch = make_epoch(new_man, 0)
    for h in range(hosts):
        sl = slice(h * nph * pages_per_node, (h + 1) * nph * pages_per_node)
        _savez_atomic(
            f"{dst}.host{h}.npz", h,
            pool=arrays["pool"][sl],
            locks=arrays["locks"][h * nph * L:(h + 1) * nph * L],
            counters=arrays["counters"][h * nph * N_COUNTERS:
                                        (h + 1) * nph * N_COUNTERS],
            nodes=np.arange(h * nph, (h + 1) * nph, dtype=np.int64),
            epoch=epoch)
    _savez_atomic(dst, 0, multihost=np.asarray([hosts], np.int64),
                  epoch=epoch, **new_man)
    return dst


def reshard(src: str, dst: str, machine_nr: int, *,
            pages_per_node: int | None = None,
            locks_per_node: int | None = None,
            hosts: int = 1) -> dict:
    """Rewrite checkpoint ``src`` for a ``machine_nr``-node cluster into
    ``dst``.  -> summary (live pages, pages a new node, geometry).

    ``pages_per_node`` defaults to keeping the total pool size.  ``hosts >
    1`` emits the multihost format (``machine_nr`` must divide evenly).
    The source may be either format."""
    man, pool, locks, counters = _load_checkpoint(src)
    heap = man.pop("heap", None)
    arrays, new_cfg, summary = reshard_arrays(
        man, pool, locks, counters, machine_nr,
        pages_per_node=pages_per_node, locks_per_node=locks_per_node,
        heap=heap)
    write_resharded(dst, arrays, new_cfg, hosts=hosts)
    summary["new"]["hosts"] = hosts
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Elastic cluster resize: rewrite a checkpoint for a "
                    "new node count")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--nodes", type=int, required=True,
                   help="target machine_nr")
    p.add_argument("--hosts", type=int, default=1,
                   help="emit the multihost format for this many processes")
    p.add_argument("--pages-per-node", type=int, default=None)
    p.add_argument("--locks-per-node", type=int, default=None)
    a = p.parse_args(argv)
    out = reshard(a.src, a.dst, a.nodes, pages_per_node=a.pages_per_node,
                  locks_per_node=a.locks_per_node, hosts=a.hosts)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
