"""Whole-pool scans of the B-link tree on its device (counterpart of
``sherman_tpu/models/validate.py``).

Each function is one pass of plain torch ops over every page of the pool:
no page is read twice, and nothing walks the chain page by page.  A page
is *allocated* when it lies below its node's bump pointer (page 0 is
reserved) and *live* when it is allocated and written (front version !=
0).  A live page whose ``highest`` fence is 0 is *retired*: bulk load
poisons the replaced root that way, and
``BatchedEngine.reclaim_empty_leaves`` retires an unlinked empty leaf that
way (its sibling points back at the absorbing leaf), so every fence check
fails on it.  A live page that is not retired is *active*.

- :func:`check_structure_device` — the whole-tree structure check, every
  invariant a vectorized predicate over the pool:

  1. version pairs consistent (front == rear) on every active page;
  2. fences strictly ordered (lowest < highest) on every active page;
  3. every live leaf slot's key inside the page's [lowest, highest) fence,
     and no leaf slot torn (fver != rver, which a legal write never
     leaves behind);
  4. internal entries strictly ascending;
  5. B-link continuity on every link: the sibling is active, on the same
     level, and its lowest fence is my highest;
  6. the leaf chain's shape without walking it: exactly one head
     (in-degree 0, lowest == NEG_INF), exactly one tail (sibling NULL,
     highest == POS_INF), in-degree <= 1 everywhere.  With 2 and 5 this
     proves one gap-free chain over the keyspace: fences strictly increase
     along links, so no disjoint cycle can hide;
  7. parent/child coherence: every valid internal entry's child is active
     (or retired and not in an allocator's free pool: in-flight reclaim or
     a parked leftmost child) with level == parent - 1 and lowest == the
     entry key, and the leftmost child's lowest is the page's own lowest.

- :func:`scrub_pass` — the same local predicates (1-5) reduced per page
  to a violation bitmask (:data:`SCRUB_BITS`), the online scrubber's view
  (``models/scrub.py``).
- :func:`leaf_directory` — every active leaf, sorted by its ``lowest``
  fence: the router's seed for a tree that was not bulk-loaded.
- :func:`leaf_chain_info` — the reclaim scanner's view of the leaf chain.

The reference fuses the predicates into one XLA program.  Eager torch
materialises every temporary, so the slot and entry matrices (49 and 82
words a page) are read only for the leaf and the internal rows, in chunks
of :data:`_CHUNK_ROWS`; every result is the reference's exactly.

When the nodes span several processes, every scan is a COLLECTIVE (every
rank calls it together): each rank scans its own block of the pool, the
predicates that follow a link to another page (siblings, children, the
leftmost child, the leaf chain's in-degrees) read one all-gathered table
of the few header columns they need, and the counts, masks and
directories are reduced over the ranks, so every rank returns the
single-process result.
"""

from __future__ import annotations

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch.errors import TreeCorruptError
from sherman_tpu_torch.ops import bits, layout

_STATS = ("keys", "leaves", "internal_pages", "retired", "bad_version",
          "bad_fence", "bad_leaf_slot", "bad_torn_slot",
          "bad_internal_order", "bad_sibling", "heads", "bad_head",
          "tails", "bad_tail", "multi_indegree", "bad_leftmost",
          "bad_child")

# violation classes, one bit each, in the per-page scrub mask.  STRUCTURAL
# classes mean the page cannot be trusted as a unit (the scrubber degrades
# the engine); entry-level classes (torn / out-of-fence slots) are
# contained by quarantining the page.
SCRUB_BITS = {
    "bad_version": 1,
    "bad_fence": 2,
    "bad_leaf_slot": 4,
    "torn_slot": 8,
    "bad_internal_order": 16,
    "bad_sibling": 32,
}
SCRUB_STRUCTURAL = (SCRUB_BITS["bad_version"] | SCRUB_BITS["bad_fence"]
                    | SCRUB_BITS["bad_internal_order"]
                    | SCRUB_BITS["bad_sibling"])

# rows of the slot and entry matrices read at a time (512 Ki leaf rows of
# 49 slots are about 100 MB an int32 matrix)
_CHUNK_ROWS = 1 << 19


def _next_by_node(tree) -> torch.Tensor:
    """Every node's bump pointer, on the pool's device."""
    nxt = torch.ones(tree.cfg.machine_nr, dtype=torch.int64)
    for d in tree.cluster.directories:
        nxt[d.node_id] = d.allocator.pages_used
    return nxt.to(tree.dsm.pool.device)


def _mesh(tree):
    from sherman_tpu_torch.parallel import mesh as MESH
    return MESH.of(tree.cfg)


def _classes(pool, nxt, P: int, row0: int = 0):
    """-> (live [N*P], retired [N*P]): allocated and written pages, and
    the live ones whose highest fence is 0 (``pool`` holds the global
    rows from ``row0`` on)."""
    ridx = torch.arange(pool.shape[0], device=pool.device) + row0
    pg_i = ridx % P
    allocated = (pg_i >= 1) & (pg_i < nxt[ridx // P])
    live = allocated & (pool[:, C.W_FRONT_VER] != 0)
    retired = live & (pool[:, C.W_HIGH_HI] == 0) & (pool[:, C.W_HIGH_LO] == 0)
    return live, retired


def _page_classes(tree):
    """-> (pool, live [N*P], retired [N*P], row0) on the pool's device:
    this process's block of the pool and its first global row."""
    pool = tree.dsm.pool
    row0 = _mesh(tree).lo * tree.cfg.pages_per_node
    return (pool, *_classes(pool, _next_by_node(tree),
                            tree.cfg.pages_per_node, row0), row0)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the value of its low 32 bits as an int32 (the reference's
    int32 arithmetic wraps)."""
    x = x & 0xFFFFFFFF
    return x - ((x >> 31) << 32)


def _rows_of(addr: torch.Tensor, N: int, P: int):
    """Packed addresses -> (pool row, ok).  The row is clipped into the
    pool, never dropped: an address out of range lands on row 0 or the
    last row, with ok False.  Both fields are bounds-checked, since a page
    >= P would alias into the next node's rows."""
    u = addr.long() & 0xFFFFFFFF
    node = u >> C.ADDR_PAGE_BITS
    page = u & C.ADDR_PAGE_MASK
    ok = (addr != 0) & (node < N) & (page < P)
    return _wrap32(node * P + page).clamp(0, N * P - 1), ok


def _per_row(rows: int, idx: torch.Tensor, fn, n: int) -> list:
    """``fn(chunk of idx)`` -> ``n`` per-row counts [len(chunk)]; -> each
    count scattered into a [rows] int64 vector (0 elsewhere)."""
    out = [torch.zeros(rows, dtype=torch.int64, device=idx.device)
           for _ in range(n)]
    for ck in idx.split(_CHUNK_ROWS):
        for o, v in zip(out, fn(ck)):
            o[ck] = v
    return out


def _global_table(mesh, cols: dict) -> dict:
    """The header columns a link predicate reads on the page it points
    at, for every global row: the local columns themselves in one
    process, one all-gather of them across ranks."""
    if not mesh.spans:
        return cols
    from sherman_tpu_torch.parallel import transport as T
    names = list(cols)
    local = torch.stack([cols[k].to(torch.int32) for k in names], dim=1)
    g = T.rank_all_gather(local, mesh.world_size)
    return {k: (g[:, i] != 0 if cols[k].dtype == torch.bool else g[:, i])
            for i, k in enumerate(names)}


def _local_invariants(pool, nxt, P: int, N: int, freed=None,
                      mesh=None) -> dict:
    """Per-page predicates over the pool: the shared core of the
    validator (``freed`` given: also the per-row bad child entries) and
    of the scrub mask.  Every mask and count is [rows] of this process's
    block (the whole pool in one process); ``g`` is the global header
    table the link predicates read."""
    rows = pool.shape[0]
    row0 = 0 if mesh is None else mesh.lo * P
    live, retired = _classes(pool, nxt, P, row0)
    act = live & ~retired
    col = lambda w: pool[:, w]
    fv = col(C.W_FRONT_VER)
    hi_hi, hi_lo = col(C.W_HIGH_HI), col(C.W_HIGH_LO)
    lo_hi, lo_lo = col(C.W_LOW_HI), col(C.W_LOW_LO)
    lvl = col(C.W_LEVEL)
    ref_ok = None if freed is None else retired & ~freed
    g = {"act": act, "lvl": lvl, "lo_hi": lo_hi, "lo_lo": lo_lo}
    if ref_ok is not None:
        g["ref_ok"] = ref_ok
    if mesh is not None:
        g = _global_table(mesh, g)
    leaf = act & (lvl == 0)
    internal = act & (lvl > 0)
    bad_ver = act & (fv != col(C.W_REAR_VER))
    # beyond local sanity this closes the chain proof: with lowest <
    # highest on every page and sibling.lowest == highest per link, a
    # disjoint leaf cycle cannot exist
    bad_fence = act & ~bits.key_lt(lo_hi, lo_lo, hi_hi, hi_lo)

    # leaf slots: liveness, fence containment and the torn pair
    LC = C.LEAF_CAP

    def leaf_rows(ix):
        sfv, srv = layout.ver_unpack(pool[ix, C.L_VER_W:C.L_VER_W + LC])
        skh = pool[ix, C.L_KHI_W:C.L_KHI_W + LC]
        skl = pool[ix, C.L_KLO_W:C.L_KLO_W + LC]
        s_live = (sfv == srv) & (sfv != 0)
        in_f = (bits.key_le(lo_hi[ix, None], lo_lo[ix, None], skh, skl)
                & bits.key_lt(skh, skl, hi_hi[ix, None], hi_lo[ix, None]))
        return (s_live.sum(-1), (s_live & ~in_f).sum(-1),
                (sfv != srv).sum(-1))

    live_slot_rows, bad_slot_rows, torn_slot_rows = _per_row(
        rows, torch.nonzero(leaf).squeeze(1), leaf_rows, 3)

    # internal entries strictly ascending; with ``freed``, each valid
    # entry's child checked too
    IC = C.INTERNAL_CAP
    pos = torch.arange(IC, device=pool.device)

    def internal_rows(ix):
        ikh = pool[ix, C.I_KHI_W:C.I_KHI_W + IC]
        ikl = pool[ix, C.I_KLO_W:C.I_KLO_W + IC]
        nk = pool[ix, C.W_NKEYS]
        asc = bits.key_lt(ikh[:, :-1], ikl[:, :-1], ikh[:, 1:], ikl[:, 1:])
        pair_valid = pos[None, 1:] < nk[:, None]
        out = ((pair_valid & ~asc).sum(-1),)
        if ref_ok is None:
            return out
        # a RETIRED child with matching level and lowest is in-flight
        # reclaim (its parent entry's removal pending) or a parked page,
        # not corruption; a freed page is not accepted (the free-pool
        # mask), and a freed-and-reused one fails the lowest clause
        crow, c_ok = _rows_of(pool[ix, C.I_PTR_W:C.I_PTR_W + IC], N, P)
        e_valid = pos[None, :] < nk[:, None]
        bad_child = e_valid & (
            ~c_ok | ~(g["act"][crow] | g["ref_ok"][crow])
            | (g["lvl"][crow] != (lvl[ix] - 1)[:, None])
            | (g["lo_hi"][crow] != ikh) | (g["lo_lo"][crow] != ikl))
        return out + (bad_child.sum(-1),)

    by_internal = _per_row(rows, torch.nonzero(internal).squeeze(1),
                           internal_rows, 1 if freed is None else 2)

    # B-link continuity per link
    sib = col(C.W_SIBLING)
    srow, s_in_range = _rows_of(sib, N, P)
    has_sib = act & (sib != 0)
    bad_sib = has_sib & (
        ~s_in_range | ~g["act"][srow] | (g["lvl"][srow] != lvl)
        | (g["lo_hi"][srow] != hi_hi) | (g["lo_lo"][srow] != hi_lo))

    return dict(rows=rows, row0=row0, g=g, act=act, retired=retired,
                leaf=leaf, internal=internal, lvl=lvl, sib=sib, srow=srow,
                lo_hi=lo_hi, lo_lo=lo_lo, hi_hi=hi_hi, hi_lo=hi_lo,
                bad_ver=bad_ver, bad_fence=bad_fence,
                live_slot_rows=live_slot_rows, bad_slot_rows=bad_slot_rows,
                torn_slot_rows=torn_slot_rows,
                bad_order_rows=by_internal[0],
                bad_child_rows=by_internal[-1],
                bad_sib=bad_sib, has_sib=has_sib, ref_ok=ref_ok)


def _validate_kernel(pool, nxt, freed, P: int, N: int,
                     mesh=None) -> list[int]:
    """The validator's counts, in :data:`_STATS` order (this process's
    block's counts across ranks; the caller sums them)."""
    m = _local_invariants(pool, nxt, P, N, freed, mesh)
    g, row0 = m["g"], m["row0"]
    rows, act, leaf, internal = m["rows"], m["act"], m["leaf"], m["internal"]
    lvl, sib, srow = m["lvl"], m["sib"], m["srow"]
    lo_hi, lo_lo, hi_hi, hi_lo = m["lo_hi"], m["lo_lo"], m["hi_hi"], m["hi_lo"]

    # the leaf chain's shape via in-degrees: a link whose sibling is out
    # of range counts on the row its address clips to, as the reference's
    # scatter does
    link_src = leaf & m["has_sib"]
    G = N * P
    indeg = torch.bincount(torch.where(link_src, srow, G),
                           minlength=G + 1)[:G]
    if mesh is not None and mesh.spans:
        from sherman_tpu_torch.parallel import transport as T
        indeg = T.rank_all_reduce(indeg)
    indeg = indeg[row0:row0 + rows]
    heads = leaf & (indeg == 0)
    bad_head = heads & ~((lo_hi == 0) & (lo_lo == 0))
    tails = leaf & (sib == 0)
    inf_hi, inf_lo = bits.key_to_pair(C.KEY_POS_INF)
    bad_tail = tails & ~((hi_hi == inf_hi) & (hi_lo == inf_lo))
    multi_in = leaf & (indeg > 1)

    # the leftmost child: a PARKED page (retired, still its parent's
    # leftmost child, since reclaim cannot drop a leftmost pointer) is
    # legal; level and lowest must still match
    lm = pool[:, C.W_LEFTMOST]
    lmrow, lm_ok = _rows_of(lm, N, P)
    lm_live_ok = g["act"][lmrow] | g["ref_ok"][lmrow]
    bad_lm = internal & (
        (lm == 0) | ~lm_ok | ~lm_live_ok | (g["lvl"][lmrow] != lvl - 1)
        | (g["lo_hi"][lmrow] != lo_hi) | (g["lo_lo"][lmrow] != lo_lo))

    return torch.stack([
        m["live_slot_rows"].sum(), leaf.sum(), internal.sum(),
        m["retired"].sum(), m["bad_ver"].sum(), m["bad_fence"].sum(),
        m["bad_slot_rows"].sum(), m["torn_slot_rows"].sum(),
        m["bad_order_rows"].sum(), m["bad_sib"].sum(), heads.sum(),
        bad_head.sum(), tails.sum(), bad_tail.sum(), multi_in.sum(),
        bad_lm.sum(), m["bad_child_rows"].sum()]).tolist()


def _scrub_kernel(pool, nxt, P: int, N: int, mesh=None):
    """Per-page violation bitmask over the pool (the validator's local
    predicates, reduced per row, so the scrubber can quarantine the
    violating pages) -> (mask [rows] int32, active page count)."""
    m = _local_invariants(pool, nxt, P, N, mesh=mesh)
    bit = lambda name, cond: torch.where(
        cond, SCRUB_BITS[name], 0).to(torch.int32)
    mask = (bit("bad_version", m["bad_ver"])
            | bit("bad_fence", m["bad_fence"])
            | bit("bad_leaf_slot", m["bad_slot_rows"] > 0)
            | bit("torn_slot", m["torn_slot_rows"] > 0)
            | bit("bad_internal_order", m["bad_order_rows"] > 0)
            | bit("bad_sibling", m["bad_sib"]))
    return mask, m["act"].sum()


def scrub_pass(tree) -> dict:
    """One online-scrub pass over the live pool, on its device:
    -> {"pages_checked", "violations", "bad": [(addr, mask), ...] in row
    order, "classes": {name: pages}}."""
    cfg = tree.cfg
    P = cfg.pages_per_node
    mesh = _mesh(tree)
    mask, checked = _scrub_kernel(tree.dsm.pool, _next_by_node(tree), P,
                                  cfg.machine_nr, mesh)
    rows = torch.nonzero(mask).squeeze(1)
    masks = mask[rows].cpu().numpy()
    rows = rows.cpu().numpy() + mesh.lo * P
    checked = int(checked)
    if mesh.spans:
        from sherman_tpu_torch.parallel import bootstrap
        parts = bootstrap.allgather_object((rows, masks, checked))
        rows = np.concatenate([p[0] for p in parts])
        masks = np.concatenate([p[1] for p in parts])
        checked = sum(p[2] for p in parts)
    bad = [(bits.make_addr(int(r) // P, int(r) % P), int(mk))
           for r, mk in zip(rows, masks)]
    classes = {name: int(sum(1 for _, mk in bad if mk & b))
               for name, b in SCRUB_BITS.items()}
    return {"pages_checked": checked, "violations": len(bad),
            "bad": bad, "classes": classes}


def check_structure_device(tree) -> dict:
    """Validate the whole tree on its device.  -> stats dict (keys,
    leaves, internal_pages, levels, retired); raises
    :class:`TreeCorruptError` naming every violated invariant."""
    tree._refresh_root()
    cfg = tree.cfg
    P = cfg.pages_per_node
    # pages in the allocators' free pools: retired pages a parent entry
    # must not reference any more
    freed = np.zeros(cfg.machine_nr * P, bool)
    for d in tree.cluster.directories:
        fp = d.allocator.free_pages_list
        if fp:
            freed[d.node_id * P + np.asarray(fp, np.int64)] = True
    pool = tree.dsm.pool
    mesh = _mesh(tree)
    row0 = mesh.lo * P
    out = _validate_kernel(pool, _next_by_node(tree),
                           torch.from_numpy(freed[row0:row0 + pool.shape[0]]
                                            ).to(pool.device), P,
                           cfg.machine_nr, mesh)
    if mesh.spans:
        from sherman_tpu_torch.parallel import bootstrap
        out = bootstrap.process_allgather(
            np.asarray(out, np.int64)).sum(axis=0).tolist()
    s = dict(zip(_STATS, out))
    problems = [f"{k}={s[k]}" for k in (
        "bad_version", "bad_fence", "bad_leaf_slot", "bad_torn_slot",
        "bad_internal_order", "bad_sibling", "bad_head", "bad_tail",
        "multi_indegree", "bad_leftmost", "bad_child") if s[k]]
    if s["heads"] != 1:
        problems.append(f"heads={s['heads']} (want exactly 1)")
    if s["tails"] != 1:
        problems.append(f"tails={s['tails']} (want exactly 1)")
    if problems:
        raise TreeCorruptError("tree structure invalid: "
                               + ", ".join(problems))
    return {"keys": s["keys"], "leaves": s["leaves"],
            "internal_pages": s["internal_pages"],
            "levels": tree._root_level + 1, "retired": s["retired"]}


def _addrs_of_rows(rows: np.ndarray, P: int) -> np.ndarray:
    return ((rows // P).astype(np.int64) << C.ADDR_PAGE_BITS) | (rows % P)


def leaf_directory(tree) -> tuple[np.ndarray, np.ndarray]:
    """Every active leaf on every node, sorted by its lowest fence:
    -> (addrs int64, lows uint64), the shape of the bulk-load leaf
    directory (``tree._bulk_leaf_dir``) for any tree."""
    pool, live, retired, row0 = _page_classes(tree)
    leaf = live & ~retired & (pool[:, C.W_LEVEL] == 0)
    rows = torch.nonzero(leaf).squeeze(1)
    lh = pool[rows, C.W_LOW_HI].cpu().numpy()
    ll = pool[rows, C.W_LOW_LO].cpu().numpy()
    addrs = _addrs_of_rows(rows.cpu().numpy() + row0,
                           tree.cfg.pages_per_node)
    lows = bits.pairs_to_keys(lh, ll)
    addrs, lows = _gather_parts(tree, addrs, lows)
    order = np.argsort(lows)
    return addrs[order], lows[order]


def leaf_chain_info(tree):
    """One scan of the pool: every active leaf's (addr, low, high,
    sibling, n_live), sorted by low, and the retired leaves' (addr, low)
    in row order.  A retired leaf was unlinked by an earlier reclaim and
    not released yet; surfacing it lets a reclaim pass take it up again.
    -> (addrs int64, lows uint64, highs uint64, sibs int64 (uint32
    values), n_live int32, retired_addrs int64, retired_lows uint64)."""
    pool, live, retired, row0 = _page_classes(tree)
    is_leaf = pool[:, C.W_LEVEL] == 0
    rows = torch.nonzero(live & ~retired & is_leaf).squeeze(1)
    rrows = torch.nonzero(retired & is_leaf).squeeze(1)
    pg = pool[rows]
    cols = pg[:, [C.W_LOW_HI, C.W_LOW_LO, C.W_HIGH_HI, C.W_HIGH_LO,
                  C.W_SIBLING]].cpu().numpy()
    n_live = layout.leaf_slot_used(pg).sum(-1).to(torch.int32).cpu().numpy()
    del pg
    P = tree.cfg.pages_per_node
    addrs = _addrs_of_rows(rows.cpu().numpy() + row0, P)
    rr = rrows.cpu().numpy() + row0
    rlows = bits.pairs_to_keys(pool[rrows, C.W_LOW_HI].cpu().numpy(),
                               pool[rrows, C.W_LOW_LO].cpu().numpy())
    addrs, cols, n_live, rr, rlows = _gather_parts(tree, addrs, cols, n_live,
                                                  rr, rlows)
    lows = bits.pairs_to_keys(cols[:, 0], cols[:, 1])
    highs = bits.pairs_to_keys(cols[:, 2], cols[:, 3])
    order = np.argsort(lows)
    return (addrs[order], lows[order], highs[order],
            cols[:, 4][order].astype(np.int64) & 0xFFFFFFFF, n_live[order],
            _addrs_of_rows(rr, P), rlows)


def _gather_parts(tree, *arrays):
    """Each process's host arrays (of its own block's rows, in row order)
    joined in rank order, which is global row order: the single-process
    arrays on every rank.  Identity in one process."""
    if not _mesh(tree).spans:
        return arrays
    from sherman_tpu_torch.parallel import bootstrap
    parts = bootstrap.allgather_object(arrays)
    return tuple(np.concatenate([p[i] for p in parts])
                 for i in range(len(arrays)))
