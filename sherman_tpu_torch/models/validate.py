"""Whole-pool scans of the B-link tree on its device (counterpart of
``sherman_tpu/models/validate.py``).

Each function is one pass of plain torch ops over every page of the pool:
no page is read twice, and nothing walks the chain page by page.  A page
counts when it is allocated (below its node's bump pointer, page 0
reserved) and written (front version != 0).  A page whose ``highest``
fence is 0 is *retired*: bulk load poisons the replaced root that way, and
``BatchedEngine.reclaim_empty_leaves`` retires an unlinked empty leaf that
way (its sibling points back at the absorbing leaf), so every fence check
fails on it.  A retired page is never *active*.

- :func:`leaf_directory` — every active leaf, sorted by its ``lowest``
  fence: the router's seed for a tree that was not bulk-loaded.
- :func:`leaf_chain_info` — the reclaim scanner's view of the leaf chain:
  every active leaf with its fences, sibling and live-slot count, and the
  retired leaves.

The full structure validator and the online scrubber are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch.ops import bits, layout


def _page_classes(tree):
    """-> (pool, allocated & written [N*P], retired [N*P]) on the pool's
    device."""
    pool = tree.dsm.pool
    cfg = tree.cfg
    N, P = cfg.machine_nr, cfg.pages_per_node
    nxt = torch.ones(N, dtype=torch.int64)
    for d in tree.cluster.directories:
        nxt[d.node_id] = d.allocator.pages_used
    ridx = torch.arange(N * P, device=pool.device)
    pg_i = ridx % P
    allocated = (pg_i >= 1) & (pg_i < nxt.to(pool.device)[ridx // P])
    live = allocated & (pool[:, C.W_FRONT_VER] != 0)
    retired = live & (pool[:, C.W_HIGH_HI] == 0) & (pool[:, C.W_HIGH_LO] == 0)
    return pool, live, retired


def _addrs_of_rows(rows: np.ndarray, P: int) -> np.ndarray:
    return ((rows // P).astype(np.int64) << C.ADDR_PAGE_BITS) | (rows % P)


def leaf_directory(tree) -> tuple[np.ndarray, np.ndarray]:
    """Every active leaf on every node, sorted by its lowest fence:
    -> (addrs int64, lows uint64), the shape of the bulk-load leaf
    directory (``tree._bulk_leaf_dir``) for any tree."""
    pool, live, retired = _page_classes(tree)
    leaf = live & ~retired & (pool[:, C.W_LEVEL] == 0)
    rows = torch.nonzero(leaf).squeeze(1)
    lh = pool[rows, C.W_LOW_HI].cpu().numpy()
    ll = pool[rows, C.W_LOW_LO].cpu().numpy()
    addrs = _addrs_of_rows(rows.cpu().numpy(), tree.cfg.pages_per_node)
    lows = bits.pairs_to_keys(lh, ll)
    order = np.argsort(lows)
    return addrs[order], lows[order]


def leaf_chain_info(tree):
    """One scan of the pool: every active leaf's (addr, low, high,
    sibling, n_live), sorted by low, and the retired leaves' (addr, low)
    in row order.  A retired leaf was unlinked by an earlier reclaim and
    not released yet; surfacing it lets a reclaim pass take it up again.
    -> (addrs int64, lows uint64, highs uint64, sibs int64 (uint32
    values), n_live int32, retired_addrs int64, retired_lows uint64)."""
    pool, live, retired = _page_classes(tree)
    is_leaf = pool[:, C.W_LEVEL] == 0
    rows = torch.nonzero(live & ~retired & is_leaf).squeeze(1)
    rrows = torch.nonzero(retired & is_leaf).squeeze(1)
    pg = pool[rows]
    cols = pg[:, [C.W_LOW_HI, C.W_LOW_LO, C.W_HIGH_HI, C.W_HIGH_LO,
                  C.W_SIBLING]].cpu().numpy()
    n_live = layout.leaf_slot_used(pg).sum(-1).to(torch.int32).cpu().numpy()
    del pg
    P = tree.cfg.pages_per_node
    addrs = _addrs_of_rows(rows.cpu().numpy(), P)
    lows = bits.pairs_to_keys(cols[:, 0], cols[:, 1])
    highs = bits.pairs_to_keys(cols[:, 2], cols[:, 3])
    order = np.argsort(lows)
    rr = rrows.cpu().numpy()
    rlows = bits.pairs_to_keys(pool[rrows, C.W_LOW_HI].cpu().numpy(),
                               pool[rrows, C.W_LOW_LO].cpu().numpy())
    return (addrs[order], lows[order], highs[order],
            cols[:, 4][order].astype(np.int64) & 0xFFFFFFFF, n_live[order],
            _addrs_of_rows(rr, P), rlows)
