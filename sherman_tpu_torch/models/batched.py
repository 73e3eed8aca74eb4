"""Batched device-side tree operations on one card — the serving hot path
(counterpart of ``sherman_tpu/models/batched.py``).

One step carries a whole batch of keys through the B-link tree with the
page kernels of :mod:`sherman_tpu_torch.ops.page_kernels`.  On one node:

- every descent round is one ``descent_round`` launch (page fetch and
  in-page search fused, no ``[B, 256]`` intermediate);
- the leaf snapshot of a descent and of the write apply is one
  ``gather_pages`` launch;
- the write-back of applied entries is one ``writeback`` launch.

With ``machine_nr > 1`` nodes on the card (the reference's ``shard_map``
branches), a batch is ``N`` node blocks of ``B`` rows, node ``n`` owning
rows ``n*B:(n+1)*B``.  Every page read of a descent is bucket-routed to
the page's owner and back (``dsm.read_pages_spmd``: the exchange kernel,
then ``gather_pages`` on the owner's shard) and searched elementwise, as
the reference does; writes are routed to their leaf's owner, applied
there on its own shard and lock table, and their statuses routed back.
Every loop exits on the sum of all nodes' pending counts, so all nodes
run the same rounds.

Consistency is the reference's: a step's reads see one snapshot of the
pool, its writes land together at the step boundary, and same-key writes
in a step are linearized by request order (the lowest index wins).

The reference's ``lax.while_loop`` with a data-dependent exit is a Python
loop here that reads one pending count back per round (one host sync per
descent round; ROADMAP.md lists removing it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import ConfigError, KeyRangeError, NotPortedError
from sherman_tpu_torch.models.btree import META_ADDR
from sherman_tpu_torch.ops import bits, layout
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import dsm as D
from sherman_tpu_torch.parallel import transport as T

# Per-key write status codes (reply of one write step).
ST_INVALID = 0      # inactive slot (padding)
ST_APPLIED = 1      # written in this step
ST_SUPERSEDED = 2   # an earlier-ordered same-key request won AND applied
ST_FULL = 3         # leaf full -> split path
ST_LOCKED = 4       # page lock held -> retry
ST_RETRY = 5        # descent incomplete / winner did not apply -> retry
ST_BAD = 6          # failed sanity checks (not a level-0 page / fence)
ST_NOT_FOUND = 7    # delete: key absent

_PW = C.PAGE_WORDS
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Descent.
# ---------------------------------------------------------------------------

def descend_spmd(pool, counters, khi, klo, root, active, *, cfg: DSMConfig,
                 iters: int, start=None, stop_level: int = 0):
    """Walk each active key from ``root`` (or its ``start`` seed) to its
    ``stop_level`` page, one ``descent_round`` per level, then gather the
    final pages.  Counts one read per page fetched into ``counters``.
    Returns (addr [B], page [B, 256], done [B]); done=False keys exhausted
    the ``iters`` budget."""
    if cfg.machine_nr > 1:
        return _descend_nodes(pool, counters, khi, klo, root, active,
                              cfg=cfg, iters=iters, start=start,
                              stop_level=stop_level)
    B = khi.shape[0]
    if start is None:
        start = torch.full((B,), int(root), dtype=torch.int32,
                           device=khi.device)
    addr = start
    done = ~active
    nreads = torch.zeros((), dtype=torch.int64, device=khi.device)
    it = 0
    while it < iters and bool((~done).any()):   # one host sync per round
        nreads += (~done).sum()
        nxt, at_leaf, _, ok, _, _, _ = PK.descent_round(
            pool, addr, khi, klo, ~done, stop_level=stop_level)
        step_ok = ok & ~done
        addr = torch.where(step_ok & ~at_leaf, nxt, addr)
        done = done | (step_ok & at_leaf)
        it += 1
    page, ok_f = D.read_pages_spmd(pool, addr, cfg=cfg, active=done & active)
    nreads += (done & active).sum()
    done = done & active & ok_f
    D.count(counters, D.CNT_READ_OPS, nreads)
    D.count(counters, D.CNT_READ_PAGES, nreads)
    return addr, page, done


def _node_sum(mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Per-node count of a node-major ``[N*R]`` mask -> ``[N]``."""
    return mask.view(n_nodes, -1).sum(1)


def _descend_nodes(pool, counters, khi, klo, root, active, *,
                   cfg: DSMConfig, iters: int, start=None,
                   stop_level: int = 0):
    """``descend_spmd`` over ``machine_nr > 1`` node blocks: each round
    reads the pending rows' pages through the routed exchange and picks
    the next hop elementwise; the loop exits on the all-node pending
    count (the reference's psum)."""
    N = cfg.machine_nr
    if start is None:
        start = torch.full(khi.shape, int(root), dtype=torch.int32,
                           device=khi.device)
    addr = start
    done = ~active
    nreads = torch.zeros(N, dtype=torch.int64, device=khi.device)
    it = 0
    while it < iters and bool((~done).any()):   # one host sync per round
        nreads += _node_sum(~done, N)
        pages, ok = D.read_pages_spmd(pool, addr, cfg=cfg, active=~done)
        chase = layout.needs_sibling_chase(pages, khi, klo)
        at_leaf = (layout.h_level(pages) == stop_level) & ~chase
        nxt = torch.where(chase, layout.h_sibling(pages),
                          layout.internal_pick_child(pages, khi, klo))
        del pages
        step_ok = ok & ~done
        addr = torch.where(step_ok & ~at_leaf, nxt, addr)
        done = done | (step_ok & at_leaf)
        it += 1
    page, ok_f = D.read_pages_spmd(pool, addr, cfg=cfg, active=done & active)
    nreads += _node_sum(done & active, N)
    done = done & active & ok_f
    D.count_nodes(counters, D.CNT_READ_OPS, nreads)
    D.count_nodes(counters, D.CNT_READ_PAGES, nreads)
    return addr, page, done


def search_routed_spmd(pool, counters, khi, klo, root, active, start, *,
                       cfg: DSMConfig, iters: int):
    """Cache-seeded search: one full-batch round from the router seeds,
    then a compacted straggler loop.  -> (done, found, vhi, vlo)."""
    done, _, found, vhi, vlo = _routed_resolve(
        pool, counters, khi, klo, active, start, iters=iters, cfg=cfg)
    return done, found, vhi, vlo


def _routed_resolve(pool, counters, khi, klo, active, start, *, iters: int,
                    cfg: DSMConfig):
    """Walk every active key from its cache seed to its leaf.

    Round 1 runs the whole batch; the rows it leaves pending are
    compacted ONCE, in row order, into an S-row buffer padded with row
    index B, and later rounds run on that buffer only.  Rows beyond the
    buffer stay not-done (callers retry them by full descent).
    -> (done, addr, found, vhi, vlo)."""
    if cfg.machine_nr > 1:
        return _routed_resolve_nodes(pool, counters, khi, klo, active,
                                     start, iters=iters, cfg=cfg)
    B = khi.shape[0]
    dev = khi.device
    S = max(min(1024, B), B // 16)
    max_rounds = iters * 4

    nxt1, leaf1, chase, ok, f, vh, vl = PK.descent_round(
        pool, start, khi, klo, active)
    at_leaf = ok & leaf1
    done = ~active | at_leaf
    found = active & at_leaf & f
    vhi = torch.where(found, vh, 0)
    vlo = torch.where(found, vl, 0)
    addr = torch.where(ok & chase, nxt1, start)

    pend_idx = torch.nonzero(~done).squeeze(1)[:S]
    n_pend = pend_idx.numel()
    sidx = torch.full((S,), B, dtype=torch.int64, device=dev)
    sidx[:n_pend] = pend_idx
    valid = sidx < B
    ci = sidx.clamp(0, B - 1)
    s_kh, s_kl, s_addr = khi[ci], klo[ci], addr[ci]
    s_done = ~valid
    s_f = torch.zeros(S, dtype=torch.bool, device=dev)
    s_vh = torch.zeros(S, dtype=torch.int32, device=dev)
    s_vl = torch.zeros(S, dtype=torch.int32, device=dev)
    loop_reads = torch.zeros((), dtype=torch.int64, device=dev)

    it, pend = 1, n_pend
    while it < max_rounds and pend > 0:
        loop_reads += (~s_done).sum()
        nxt, leafb, _, ok, f, vh, vl = PK.descent_round(
            pool, s_addr, s_kh, s_kl, ~s_done)
        fin = ok & leafb
        s_f = torch.where(fin, f, s_f)
        s_vh = torch.where(fin & f, vh, s_vh)
        s_vl = torch.where(fin & f, vl, s_vl)
        s_done = s_done | fin
        s_addr = torch.where(ok & ~leafb, nxt, s_addr)
        it += 1
        pend = int((~s_done).sum())              # one host sync per round

    # one scatter of the compacted results back to [B]
    res = valid & s_done
    tgt = sidx[res]
    done[tgt] = True
    found[tgt] = s_f[res]
    vhi[tgt] = torch.where(s_f, s_vh, 0)[res]
    vlo[tgt] = torch.where(s_f, s_vl, 0)[res]
    addr[tgt] = s_addr[res]

    n_reads = active.sum() + loop_reads
    D.count(counters, D.CNT_READ_OPS, n_reads)
    D.count(counters, D.CNT_READ_PAGES, n_reads)
    done = done & active
    return done, addr, found & done, vhi, vlo


def _routed_resolve_nodes(pool, counters, khi, klo, active, start, *,
                          iters: int, cfg: DSMConfig):
    """``_routed_resolve`` over ``machine_nr > 1`` node blocks of ``B``
    rows.  Round 1 reads every active row's seed page through the routed
    exchange at ``step_capacity``; each node then compacts its first
    ``S`` pending rows, in row order, into its own ``S``-row buffer, and
    the straggler rounds read through an exchange of capacity ``S``
    (both per node, as the reference sizes them).  The loop exits on
    the all-node pending count.  -> (done, addr, found, vhi, vlo)."""
    N = cfg.machine_nr
    B = khi.shape[0] // N
    dev = khi.device
    S = max(min(1024, B), B // 16)
    max_rounds = iters * 4
    loop_cfg = dataclasses.replace(cfg, step_capacity=S)

    pg, ok = D.read_pages_spmd(pool, start, cfg=cfg, active=active)
    chase = layout.needs_sibling_chase(pg, khi, klo)
    at_leaf = ok & (layout.h_level(pg) == 0) & ~chase
    f, vh, vl, _ = layout.leaf_find_key(pg, khi, klo)
    sib1 = layout.h_sibling(pg)
    del pg
    done = ~active | at_leaf
    found = active & at_leaf & f
    vhi = torch.where(found, vh, 0)
    vlo = torch.where(found, vl, 0)
    addr = torch.where(ok & chase, sib1, start)

    # per node: the first S pending rows in row order; fill slots hold B
    pend = (~done).view(N, B)
    rank = torch.cumsum(pend, 1) - 1
    n_i, r_i = torch.nonzero(pend & (rank < S), as_tuple=True)
    sidx = torch.full((N, S), B, dtype=torch.int64, device=dev)
    sidx[n_i, rank[n_i, r_i]] = r_i
    valid = (sidx < B).view(-1)
    gidx = (torch.arange(N, device=dev)[:, None] * B
            + sidx.clamp(0, B - 1)).view(-1)
    s_kh, s_kl, s_addr = khi[gidx], klo[gidx], addr[gidx]
    s_done = ~valid
    s_f = torch.zeros(N * S, dtype=torch.bool, device=dev)
    s_vh = torch.zeros(N * S, dtype=torch.int32, device=dev)
    s_vl = torch.zeros(N * S, dtype=torch.int32, device=dev)
    loop_reads = torch.zeros(N, dtype=torch.int64, device=dev)

    it, n_pend = 1, int((~s_done).sum())
    while it < max_rounds and n_pend > 0:
        loop_reads += _node_sum(~s_done, N)
        pg, ok = D.read_pages_spmd(pool, s_addr, cfg=loop_cfg,
                                   active=~s_done)
        ok = ok & ~s_done
        chase = layout.needs_sibling_chase(pg, s_kh, s_kl)
        at_leaf = ok & (layout.h_level(pg) == 0) & ~chase
        nxt = torch.where(chase, layout.h_sibling(pg),
                          layout.internal_pick_child(pg, s_kh, s_kl))
        f, vh, vl, _ = layout.leaf_find_key(pg, s_kh, s_kl)
        del pg
        fin = ok & at_leaf
        s_f = torch.where(fin, f, s_f)
        s_vh = torch.where(fin & f, vh, s_vh)
        s_vl = torch.where(fin & f, vl, s_vl)
        s_done = s_done | fin
        s_addr = torch.where(ok & ~at_leaf, nxt, s_addr)
        it += 1
        n_pend = int((~s_done).sum())           # one host sync per round

    # one scatter of the compacted results back to the node blocks
    res = valid & s_done
    tgt = gidx[res]
    done[tgt] = True
    found[tgt] = s_f[res]
    vhi[tgt] = torch.where(s_f, s_vh, 0)[res]
    vlo[tgt] = torch.where(s_f, s_vl, 0)[res]
    addr[tgt] = s_addr[res]

    n_reads = _node_sum(active, N) + loop_reads
    D.count_nodes(counters, D.CNT_READ_OPS, n_reads)
    D.count_nodes(counters, D.CNT_READ_PAGES, n_reads)
    done = done & active
    return done, addr, found & done, vhi, vlo


def search_spmd(pool, counters, khi, klo, root, active, start=None, *,
                cfg: DSMConfig, iters: int):
    """Batched ``Tree::search`` by full descent.
    -> (done, found, vhi, vlo)."""
    _, page, done = descend_spmd(pool, counters, khi, klo, root, active,
                                 cfg=cfg, iters=iters, start=start)
    found, vhi, vlo, _ = layout.leaf_find_key(page, khi, klo)
    return done, found & done, vhi, vlo


def _resolve_leaves(pool, counters, khi, klo, root, active, start, *,
                    cfg: DSMConfig, iters: int):
    """Walk every active key to its leaf: the cache-seeded compacted loop
    when seeds exist, else the full descent.
    -> (done, addr, found, vhi, vlo)."""
    if start is not None:
        return _routed_resolve(pool, counters, khi, klo, active, start,
                               iters=iters, cfg=cfg)
    addr, page, done = descend_spmd(pool, counters, khi, klo, root, active,
                                    cfg=cfg, iters=iters)
    f, vh, vl, _ = layout.leaf_find_key(page, khi, klo)
    found = f & done
    return (done, addr, found, torch.where(found, vh, 0),
            torch.where(found, vl, 0))


# ---------------------------------------------------------------------------
# Owner-side leaf apply: the write fast path.
# ---------------------------------------------------------------------------

def _lex_order(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows lexicographically by ``keys`` (most
    significant first), ties by row index: stable sorts from the least
    significant key up."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def leaf_apply_spmd(pool, locks, counters, inc, *, cfg: DSMConfig,
                    update_only: bool = False):
    """Apply routed upserts to their leaf pages (``leaf_page_store``):
    update an existing key in place, or insert into a free slot, writing
    only the touched 5-word entry.  Same-key requests are deduplicated
    (the lowest row index wins).  This slice has no split grants: an
    insert that does not fit reports ST_FULL.

    ``update_only`` is the steady-state update kernel: a winner whose key
    is absent reports ST_FULL (the caller escalates it to the insert
    path) instead of inserting, no insert rank is computed, and the
    write-back carries the 3 words an update changes (version pair, vhi,
    vlo).

    inc: dict of [M] tensors — active, addr (leaf), khi, klo, vhi, vlo.
    Updates ``pool``/``counters`` in place; returns status [M]."""
    M = inc["addr"].shape[0]
    P = pool.shape[0]
    L = locks.shape[0]
    dev = pool.device
    act = inc["active"]
    khi, klo = inc["khi"], inc["klo"]
    page_idx = bits.addr_page(inc["addr"])
    safe_page = page_idx.clamp(0, P - 1)
    pg = PK.gather_pages(pool, safe_page)                 # [M, PW] snapshot

    lock_idx = bits.lock_index(inc["addr"], cfg.locks_per_node)
    locked = locks[lock_idx.clamp(0, L - 1).long()] != 0
    sane = act & (page_idx >= 0) & (page_idx < P) \
        & (layout.h_level(pg) == 0) & layout.in_fence(pg, khi, klo) \
        & layout.page_consistent(pg)
    ok_req = sane & ~locked

    found, _, _, fslot = layout.leaf_find_key(pg, khi, klo)
    if not update_only:
        free = ~layout.leaf_slot_used(pg)                   # [M, CAP]
        cumfree = torch.cumsum(free.to(torch.int32), dim=-1)
        freec = cumfree[:, -1]                              # page free slots

    # --- dedupe + insert rank in one sorted pass -----------------------------
    # rows ordered by (page, key as uint64, row index): groups of the same
    # (page, key) are contiguous and their head is the lowest row index
    idx0 = torch.arange(M, device=dev)
    pk = torch.where(ok_req, page_idx, P).long()
    ukhi = khi.long() & _U32
    uklo = klo.long() & _U32
    sidx = _lex_order(pk, ukhi, uklo)
    sp, skhi, sklo = pk[sidx], ukhi[sidx], uklo[sidx]
    sfound = found[sidx]
    sok = sp < P
    same_prev = torch.zeros(M, dtype=torch.bool, device=dev)
    same_prev[1:] = ((sp[1:] == sp[:-1]) & (skhi[1:] == skhi[:-1])
                     & (sklo[1:] == sklo[:-1]) & sok[1:])
    winner_s = sok & ~same_prev
    escalate = 2 * M     # update_only's key-absent code, above any rank
    if update_only:
        # winners apply iff their key exists; absent-key winners escalate
        applied_s = winner_s & sfound
        ins_code_s = torch.full((M,), escalate, dtype=torch.int64,
                                device=dev)
    else:
        sfreec = freec[sidx]
        need_ins_s = winner_s & ~sfound
        # rank among the page's fresh inserts: running count minus the
        # count at the page segment's head
        page_head = torch.ones(M, dtype=torch.bool, device=dev)
        page_head[1:] = sp[1:] != sp[:-1]
        cum = torch.cumsum(need_ins_s.long(), 0)
        cum_excl = cum - need_ins_s.long()
        base = torch.cummax(torch.where(page_head, cum_excl, -1), 0).values
        rank_s = cum_excl - base
        applied_s = winner_s & (sfound | (rank_s < sfreec))
        ins_code_s = rank_s
    # hand the group head's verdict to its losers (position-encoded
    # running max: groups are contiguous, heads are winners)
    enc = torch.cummax(torch.where(winner_s, idx0 * 2 + applied_s.long(),
                                   -1), 0).values
    grp_winner_applied = (enc & 1) == 1
    # verdicts: -4 loser whose winner did not apply (retry), -3 dropped,
    # -2 superseded, -1 winner-found (update), r >= 0 insert rank,
    # ``escalate`` update_only's key-absent winner
    code_s = torch.where(
        ~sok, -3,
        torch.where(~winner_s, torch.where(grp_winner_applied, -2, -4),
                    torch.where(sfound, -1, ins_code_s)))
    code = torch.empty_like(code_s)
    code[sidx] = code_s                                     # un-sort
    winner_upd = code == -1
    superseded = code == -2
    loser_retry = code == -4
    if update_only:
        full = code == escalate
        applied = winner_upd
        slot = fslot
    else:
        winner_ins = code >= 0
        rank = torch.where(winner_ins, code, 0)
        have_slot = freec >= (rank + 1)
        full = winner_ins & ~have_slot
        applied = winner_upd | (winner_ins & have_slot)
        islot = torch.argmax(
            (cumfree >= (rank + 1)[:, None]).to(torch.uint8),
            dim=-1).to(torch.int32)
        slot = torch.where(found, fslot, islot)

    # --- single-entry write-back ------------------------------------------------
    ver_blk = pg[:, C.L_VER_W:C.L_VER_W + C.LEAF_CAP]
    slot_oh = torch.arange(C.LEAF_CAP, device=dev)[None, :] == slot[:, None]
    old_fv = (torch.where(slot_oh, ver_blk, 0).sum(-1).to(torch.int32)
              >> 16) & C.ENTRY_VER_MASK
    new_ver = (old_fv + 1) & C.ENTRY_VER_MASK
    new_ver = torch.where(new_ver == 0, 1, new_ver)
    new_pair = layout.ver_pack(new_ver)
    if update_only:
        ent = torch.stack([new_pair, inc["vhi"], inc["vlo"]], dim=-1)
        lanes = (C.L_VER_W, C.L_VHI_W, C.L_VLO_W)
    else:
        ent = torch.stack([new_pair, khi, klo, inc["vhi"], inc["vlo"]],
                          dim=-1)
        lanes = (C.L_VER_W, C.L_KHI_W, C.L_KLO_W, C.L_VHI_W, C.L_VLO_W)
    PK.writeback(pool, safe_page.contiguous(), slot.contiguous(),
                 applied.contiguous(), ent.contiguous(), lanes)

    status = torch.full((M,), ST_INVALID, dtype=torch.int32, device=dev)
    status = torch.where(act, ST_BAD, status)
    status = torch.where(act & sane & locked, ST_LOCKED, status)
    status = torch.where(loser_retry, ST_RETRY, status)
    status = torch.where(superseded, ST_SUPERSEDED, status)
    status = torch.where(full, ST_FULL, status)
    status = torch.where(applied, ST_APPLIED, status)

    n_app = applied.sum()
    D.count(counters, D.CNT_WRITE_OPS, n_app)
    D.count(counters, D.CNT_WRITE_WORDS,
            n_app * (3 if update_only else C.LEAF_ENTRY_WORDS))
    return status


def _mark_dirty_pages(dirty, page_idx, active) -> None:
    """Mark the pages the apply MAY write (over-marks, never misses)."""
    P = dirty.shape[0]
    sel = active & (page_idx >= 0) & (page_idx < P)
    dirty[page_idx[sel].long()] = True


def _route_and_apply(pool, locks, counters, dirty, addr, eligible, fields, *,
                     cfg: DSMConfig, update_only: bool = False):
    """Apply ``eligible`` upserts at their leaf's owner.  One node applies
    directly; with ``machine_nr > 1`` each node bucketizes its rows by
    owner, the request fields are exchanged, every owner applies its
    source-major incoming buffer on its own shard, and the statuses are
    exchanged back.  Returns status [B], ST_RETRY for rows that were not
    eligible or missed their bucket's capacity."""
    if cfg.machine_nr > 1:
        return _route_and_apply_nodes(pool, locks, counters, dirty, addr,
                                      eligible, fields, cfg=cfg,
                                      update_only=update_only)
    inc = {"active": eligible, "addr": addr, **fields}
    if dirty is not None:
        _mark_dirty_pages(dirty, bits.addr_page(addr), eligible)
    st = leaf_apply_spmd(pool, locks, counters, inc, cfg=cfg,
                         update_only=update_only)
    return torch.where(eligible, st, ST_RETRY)


def _route_and_apply_nodes(pool, locks, counters, dirty, addr, eligible,
                           fields, *, cfg: DSMConfig,
                           update_only: bool = False):
    N, cap = cfg.machine_nr, cfg.step_capacity
    P = cfg.pages_per_node
    nd = lambda x: x.view(N, -1)
    elig = nd(eligible)
    bucket_idx, routed = T.bucketize(bits.addr_node(nd(addr)), elig, N, cap)
    out = {"active": elig & routed, "addr": nd(addr),
           **{k: nd(v) for k, v in fields.items()}}
    inc = T.exchange({k: T.scatter_to_buckets(v, bucket_idx, N * cap)
                      for k, v in out.items()})
    st = torch.empty((N, N * cap), dtype=torch.int32, device=pool.device)
    for d in range(N):
        inc_d = {k: v[d] for k, v in inc.items()}
        if dirty is not None:
            _mark_dirty_pages(dirty[d * P:(d + 1) * P],
                              bits.addr_page(inc_d["addr"]), inc_d["active"])
        st[d] = leaf_apply_spmd(*D.shards(cfg, d, pool, locks, counters),
                                inc_d, cfg=cfg, update_only=update_only)
    rep = T.exchange(st)
    safe_b = torch.where(routed, bucket_idx, 0)
    return torch.where(elig & routed, T.take_local(rep, safe_b),
                       ST_RETRY).view(-1)


def mixed_step_spmd(pool, locks, counters, khi, klo, vhi, vlo, root,
                    active_r, active_w, start=None, *, cfg: DSMConfig,
                    iters: int, dirty=None, write_lo: int | None = None,
                    update_only: bool = False):
    """One fused step of searches (``active_r``) and upserts
    (``active_w``) through a single descent.  Reads that resolve see the
    pre-step pool and writes land at the step boundary, so the serial
    order is (resolved reads) < (writes); reads that overran the budget
    (done_r False) are retried later and may see this step's writes.

    ``write_lo``: when every node's block is laid out ``[reads |
    writes]`` with its writes in rows ``[write_lo:]``, the apply runs on
    those rows of each node only (its snapshot gather, dedup sort and
    write-back cost per row).  ``update_only``: the steady-state update
    apply (see :func:`leaf_apply_spmd`).
    -> (status [B], done_r [B], found [B], vhi [B], vlo [B])."""
    active = active_r | active_w
    done, addr, found, rvh, rvl = _resolve_leaves(
        pool, counters, khi, klo, root, active, start, cfg=cfg, iters=iters)
    done_r = done & active_r
    found = found & done_r
    rvh = torch.where(found, rvh, 0)
    rvl = torch.where(found, rvl, 0)
    N = cfg.machine_nr
    lo = 0 if write_lo is None else int(write_lo)
    # each node's rows [lo:] of a node-major [N*B] tensor
    w = (lambda x: x) if not lo else \
        (lambda x: x.view(N, -1)[:, lo:].reshape(-1))
    st_w = _route_and_apply(
        pool, locks, counters, dirty, w(addr), w(done & active_w),
        {"khi": w(khi), "klo": w(klo), "vhi": w(vhi), "vlo": w(vlo)},
        cfg=cfg, update_only=update_only)
    if lo:
        st_w = torch.cat([torch.full((N, lo), ST_INVALID, dtype=st_w.dtype,
                                     device=st_w.device),
                          st_w.view(N, -1)], dim=1).view(-1)
    status = torch.where(active_w, st_w, ST_INVALID)
    return status, done_r, found, rvh, rvl


# ---------------------------------------------------------------------------
# Host-facing engine.
# ---------------------------------------------------------------------------

def _leaf_directory(tree) -> tuple[np.ndarray, np.ndarray]:
    """Every live leaf of any tree, on every node, sorted by lowest fence:
    -> (addrs int64, lows uint64) — the shape of the bulk-load leaf
    directory."""
    pool = tree.dsm.pool
    N, P = tree.cfg.machine_nr, tree.cfg.pages_per_node
    nxt = torch.ones(N, dtype=torch.int64)
    for d in tree.cluster.directories:
        nxt[d.node_id] = d.allocator.pages_used
    ridx = torch.arange(N * P, device=pool.device)
    pg_i = ridx % P
    allocated = (pg_i >= 1) & (pg_i < nxt.to(pool.device)[ridx // P])
    hi_hi, hi_lo = pool[:, C.W_HIGH_HI], pool[:, C.W_HIGH_LO]
    act = allocated & (pool[:, C.W_FRONT_VER] != 0) \
        & ~((hi_hi == 0) & (hi_lo == 0))
    leaf = act & (pool[:, C.W_LEVEL] == 0)
    rows = torch.nonzero(leaf).squeeze(1)
    lh = pool[rows, C.W_LOW_HI].cpu().numpy()
    ll = pool[rows, C.W_LOW_LO].cpu().numpy()
    rows = rows.cpu().numpy().astype(np.int64)
    addrs = ((rows // P) << C.ADDR_PAGE_BITS) | (rows % P)
    lows = bits.pairs_to_keys(lh, ll)
    order = np.argsort(lows)
    return addrs[order], lows[order]


class BatchedEngine:
    """Batched ops over a :class:`~sherman_tpu_torch.models.btree.Tree`:
    every call pads its batch to ``machine_nr * batch_per_node`` rows
    (node ``n`` owning rows ``n*B:(n+1)*B``), so the compacted straggler
    buffers and the counters match the reference step for step."""

    def __init__(self, tree, batch_per_node: int = 1024,
                 tcfg: TreeConfig | None = None):
        self.tree = tree
        self.dsm = tree.dsm
        self.cfg = tree.cfg
        self.tcfg = tcfg if tcfg is not None else TreeConfig()
        self.B = batch_per_node
        self.total = self.cfg.machine_nr * batch_per_node
        self.device = self.dsm.device
        self.router = None
        self._search_cache = {}
        # engine steps and host DSM steps both mutate the pool in place
        self._step_mutex = self.dsm._step_mutex

    def _iters(self) -> int:
        # descent budget: max height + sibling-chase slack
        return self.tcfg.max_level + self.tcfg.sibling_chase_budget

    def attach_router(self, log2_buckets: int | None = None,
                      scan: bool = True):
        """Create and seed the index cache from the bulk-load leaf
        directory, else (``scan=True``) from a scan of the pool;
        ``scan=False`` keeps the cold root-seeded table."""
        from sherman_tpu_torch.models.router import (LeafRouter,
                                                     default_log2_buckets)
        leaf_dir = getattr(self.tree, "_bulk_leaf_dir", None)
        if leaf_dir is None and scan:
            leaf_dir = _leaf_directory(self.tree)
        if log2_buckets is None:
            n_leaves = len(leaf_dir[0]) if leaf_dir else 1024
            log2_buckets = default_log2_buckets(n_leaves)
        r = LeafRouter(self.tree, log2_buckets)
        if leaf_dir is not None and len(leaf_dir[0]):
            r.seed_from_leaves(*leaf_dir)
        self.router = r
        return r

    # -- helpers -------------------------------------------------------------

    def _pad(self, arr: np.ndarray, fill=0) -> np.ndarray:
        n = arr.shape[0]
        if n > self.total:
            raise ConfigError(f"batch of {n} exceeds machine_nr * "
                              f"batch_per_node={self.total}")
        if n == self.total:
            return arr
        pad = np.full((self.total - n,) + arr.shape[1:], fill, arr.dtype)
        return np.concatenate([arr, pad])

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @staticmethod
    def _check_range(keys: np.ndarray) -> None:
        if keys.size and (keys.min() < C.KEY_MIN or keys.max() > C.KEY_MAX):
            raise KeyRangeError("keys outside [KEY_MIN, KEY_MAX]")

    # -- public ops ----------------------------------------------------------

    def search(self, keys, _depth: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Batched lookup of uint64 ``keys`` (chunked to
        ``machine_nr * batch_per_node`` rows).
        -> (values uint64 [n], found bool [n])."""
        keys = np.asarray(keys, np.uint64)
        self._check_range(keys)
        n = keys.shape[0]
        if n > self.total:
            parts = [self.search(keys[i:i + self.total])
                     for i in range(0, n, self.total)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        khi, klo = bits.keys_to_pairs(keys)
        khi, klo = self._pad(khi), self._pad(klo)
        active = self._dev(self._pad(np.ones(n, bool)))
        # retries (depth > 0) bypass the index cache and descend from root
        use_router = self.router is not None and _depth == 0
        start = (self._dev(self.router.host_start(khi, klo))
                 if use_router else None)
        kt, lt = self._dev(khi), self._dev(klo)
        with self._step_mutex:
            if use_router:
                done, found, vhi, vlo = search_routed_spmd(
                    self.dsm.pool, self.dsm.counters, kt, lt,
                    self.tree._root_addr, active, start, cfg=self.cfg,
                    iters=self._iters())
            else:
                done, found, vhi, vlo = search_spmd(
                    self.dsm.pool, self.dsm.counters, kt, lt,
                    self.tree._root_addr, active, cfg=self.cfg,
                    iters=self._iters())
        done, found, vhi, vlo = (t.cpu().numpy()
                                 for t in (done, found, vhi, vlo))
        done = done[:n]
        vals = bits.pairs_to_keys(vhi[:n], vlo[:n])
        fnd = found[:n].copy()
        if not done.all():
            if _depth >= 8:
                raise KeyRangeError("search stragglers not converging")
            # stale cache / height growth / buffer overflow: refresh the
            # root and fully descend the stragglers
            self.tree._refresh_root()
            miss = ~done
            vals[miss], fnd[miss] = self.search(keys[miss], _depth=_depth + 1)
        return vals, fnd

    def _get_search_fanout(self, iters: int):
        """The combined-search serve: search over the unique-key rows,
        then the packed fan-out of every client request's answer.  One
        function object per ``iters``, shared by :meth:`search_combined`
        and the device-staged loop
        (``workload.device_prep.make_staged_step``), so the two serve
        through one code path.

        ``fn(pool, counters, khi, klo, root, active, start, inv) ->
        (done, found, vhi, vlo)``: ``done`` per unique row, the rest per
        client row; ``inv`` holds each client's unique row, a global
        index into the node-major answer table with several nodes (each
        node's answers are gathered for every node, as the reference's
        all-gather does).  ``counters`` is updated in place."""
        fn = self._search_cache.get(("fanout", iters))
        if fn is None:
            cfg = self.cfg
            N = cfg.machine_nr

            def fn(pool, counters, khi, klo, root, active, start, inv):
                done, found, vhi, vlo = search_routed_spmd(
                    pool, counters, khi, klo, root, active, start, cfg=cfg,
                    iters=iters)
                # one gather of packed [U, 3] rows per client (the
                # reference's table adds a zero fourth lane, TPU padding)
                ans = torch.stack([found.to(torch.int32), vhi, vlo], dim=1)
                if N > 1:
                    ans = T.gather_rows(ans.view(N, -1, 3))
                out = ans[inv.clamp(0, ans.shape[0] - 1)]
                return done, out[:, 0] != 0, out[:, 1], out[:, 2]

            self._search_cache[("fanout", iters)] = fn
        return fn

    def search_combined(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Batched lookup with request combining: duplicate keys share one
        descent, and every request's answer is fanned out on the device
        (through :meth:`_get_search_fanout`).
        -> (values uint64 [n], found bool [n])."""
        keys = np.asarray(keys, np.uint64)
        uk, inv = np.unique(keys, return_inverse=True)
        if self.router is None or not 0 < uk.size <= self.total:
            vals, found = self.search(uk)
            return vals[inv], found[inv]
        self._check_range(keys)
        khi, klo = bits.keys_to_pairs(uk)
        khi, klo = self._pad(khi), self._pad(klo)
        active = self._dev(self._pad(np.ones(uk.size, bool)))
        start = self._dev(self.router.host_start(khi, klo))
        kt, lt = self._dev(khi), self._dev(klo)
        inv_t = self._dev(inv.astype(np.int64))
        fn = self._get_search_fanout(self._iters())
        with self._step_mutex:
            done, found, vhi, vlo = fn(
                self.dsm.pool, self.dsm.counters, kt, lt,
                self.tree._root_addr, active, start, inv_t)
        if not bool(done[:uk.size].all()):
            vals, fnd = self.search(uk)      # straggler rescue
            return vals[inv], fnd[inv]
        # one device-to-host copy of the packed answers
        ans = torch.stack([found.to(torch.int32), vhi, vlo], dim=1)
        ans = ans.cpu().numpy()
        return bits.pairs_to_keys(ans[:, 1], ans[:, 2]), ans[:, 0] != 0

    def mixed(self, keys, values, is_read):
        """One fused step of reads and upserts over one key batch.

        keys u64 [n], values u64 [n] (ignored where is_read), is_read
        bool [n].  -> (out_values u64 [n], found bool [n] for read rows,
        status int32 [n] for write rows).  Reads that overran the descent
        budget retry as a later search.  Writes that need a split or a
        retry (ST_FULL / ST_RETRY / ST_LOCKED) raise NotPortedError: the
        host insert path comes with the write slice."""
        keys = np.asarray(keys, np.uint64)
        self._check_range(keys)
        values = np.asarray(values, np.uint64)
        is_read = np.asarray(is_read, bool)
        n = keys.shape[0]
        khi, klo = bits.keys_to_pairs(keys)
        vhi, vlo = bits.keys_to_pairs(values)
        khi, klo, vhi, vlo = (self._pad(x) for x in (khi, klo, vhi, vlo))
        ar = self._dev(self._pad(is_read))       # pad rows neither read
        aw = self._dev(self._pad(~is_read))      # nor write
        start = (self._dev(self.router.host_start(khi, klo))
                 if self.router is not None else None)
        t = [self._dev(x) for x in (khi, klo, vhi, vlo)]
        with self._step_mutex:
            status, done_r, found, rvh, rvl = mixed_step_spmd(
                self.dsm.pool, self.dsm.locks, self.dsm.counters, *t,
                self.tree._root_addr, ar, aw, start, cfg=self.cfg,
                iters=self._iters(), dirty=self.dsm.dirty)
        status, done_r, found, rvh, rvl = (
            x.cpu().numpy()[:n] for x in (status, done_r, found, rvh, rvl))
        status = status.copy()
        found = found.copy()
        out_vals = bits.pairs_to_keys(rvh, rvl)
        miss_r = is_read & ~done_r
        if miss_r.any():
            out_vals[miss_r], found[miss_r] = self.search(keys[miss_r])
        miss_w = ~is_read & np.isin(status, (ST_FULL, ST_RETRY, ST_LOCKED))
        if miss_w.any():
            raise NotPortedError(
                f"{int(miss_w.sum())} write(s) of this mixed step need the "
                "host insert/split path (statuses FULL/RETRY/LOCKED), which "
                "comes with the write slice (ROADMAP.md section 1 item 6); "
                "the step's other writes have landed")
        return out_vals, found, status


# ---------------------------------------------------------------------------
# Bulk load: bottom-up tree construction.
# ---------------------------------------------------------------------------

def _addr_rows(addrs: np.ndarray, pages_per_node: int) -> np.ndarray:
    """Packed addrs -> pool row indices (host)."""
    a = np.asarray(addrs).astype(np.uint32).astype(np.uint64)
    return ((a >> C.ADDR_PAGE_BITS) * np.uint64(pages_per_node)
            + (a & np.uint64(C.ADDR_PAGE_MASK))).astype(np.int64)


def _install_pages(pool, rows, pages) -> None:
    """Write whole pages into the pool rows, in place."""
    pool[rows] = pages


def _leaf_pages(blk_khi, blk_klo, blk_vhi, blk_vlo, blk_live, ver, low_hi,
                low_lo, high_hi, high_lo, sibling):
    """Assemble [R] whole leaf pages from [R, LEAF_CAP] field blocks and
    [R] header words.  Dead slots are zeroed; the version pairs carry the
    liveness."""
    R = blk_khi.shape[0]
    CAP = C.LEAF_CAP
    page = torch.zeros((R, _PW), dtype=torch.int32, device=blk_khi.device)
    page[:, C.W_FRONT_VER] = ver
    page[:, C.W_REAR_VER] = ver
    page[:, C.W_SIBLING] = sibling
    page[:, C.W_LOW_HI] = low_hi
    page[:, C.W_LOW_LO] = low_lo
    page[:, C.W_HIGH_HI] = high_hi
    page[:, C.W_HIGH_LO] = high_lo
    page[:, C.L_VER_W:C.L_VER_W + CAP] = \
        blk_live.to(torch.int32) * layout.ver_pack(1)
    z = lambda b: torch.where(blk_live, b, 0)
    page[:, C.L_KHI_W:C.L_KHI_W + CAP] = z(blk_khi)
    page[:, C.L_KLO_W:C.L_KLO_W + CAP] = z(blk_klo)
    page[:, C.L_VHI_W:C.L_VHI_W + CAP] = z(blk_vhi)
    page[:, C.L_VLO_W:C.L_VLO_W + CAP] = z(blk_vlo)
    return page


def _build_install_leaves(pool, rows, khi, klo, vhi, vlo, live,
                          lhi, llo, hhi, hlo, sib, *, per_leaf: int) -> None:
    """Build every leaf page on the device and install it.  Entries are
    packed ``per_leaf`` per page in key order, so the [L, CAP] field
    blocks are reshapes of the flat word tensors."""
    L = rows.shape[0]

    def blk(x):
        return torch.nn.functional.pad(x.reshape(L, per_leaf),
                                       (0, C.LEAF_CAP - per_leaf))

    ones = torch.ones(L, dtype=torch.int32, device=pool.device)
    page = _leaf_pages(blk(khi), blk(klo), blk(vhi), blk(vlo),
                       blk(live).to(torch.bool), ones, lhi, llo, hhi, hlo,
                       sib)
    _install_pages(pool, rows, page)


def _u64_sort_on(device, keys: np.ndarray, values: np.ndarray):
    """Sort (keys, values) by key as uint64 on ``device`` (the sign flip
    makes the int64 order the unsigned one).  -> int64 tensors holding
    the uint64 bit patterns."""
    sign = -(1 << 63)
    kt = torch.from_numpy(keys.view(np.int64)).to(device) ^ sign
    kt, order = torch.sort(kt, stable=True)
    vt = torch.from_numpy(values.view(np.int64)).to(device)[order]
    return kt ^ sign, vt


def bulk_load(tree, keys, values, fill: float | None = None) -> dict:
    """Build the tree bottom-up from unique keys and install it: leaf
    pages are built on the device, the internal levels (a few percent of
    the pages) in numpy on the host.  Returns stats."""
    cfg = tree.cfg
    dsm = tree.dsm
    dev = dsm.device
    if fill is None:
        fill = TreeConfig().bulk_fill
    tree._refresh_root()
    old_root = tree._root_addr
    old_pg = dsm.read_page(old_root)
    if tree._root_level != 0 or layout.np_leaf_entries(old_pg):
        raise ConfigError("bulk_load requires an empty tree")

    keys = np.ascontiguousarray(keys, np.uint64)
    values = np.ascontiguousarray(values, np.uint64)
    kt, vt = _u64_sort_on(dev, keys, values)
    keys = kt.cpu().numpy().view(np.uint64)
    n = keys.shape[0]
    if n and not bool((np.diff(keys) > 0).all()):
        raise ConfigError("bulk_load requires unique keys")

    per_leaf = max(1, min(C.LEAF_CAP, int(C.LEAF_CAP * fill)))
    n_leaves = max(1, -(-n // per_leaf))

    # --- leaf level: built on the device --------------------------------
    alloc = tree.ctx.alloc
    leaf_addrs = alloc.alloc_many(n_leaves)
    total = n_leaves * per_leaf
    pad = lambda t: torch.nn.functional.pad(t, (0, total - n))
    khi, klo = pad((kt >> 32).to(torch.int32)), pad(kt.to(torch.int32))
    vhi, vlo = pad((vt >> 32).to(torch.int32)), pad(vt.to(torch.int32))
    live = (torch.arange(total, device=dev) < n).to(torch.int32)

    # fences: lowest = first key of the leaf (leaf 0: -inf); highest =
    # next leaf's first key (last: +inf); siblings left to right
    first_keys = keys[::per_leaf][:n_leaves]
    lows = np.empty(n_leaves, np.uint64)
    lows[0] = C.KEY_NEG_INF
    lows[1:] = first_keys[1:]
    highs = np.empty(n_leaves, np.uint64)
    highs[:-1] = first_keys[1:]
    highs[-1] = C.KEY_POS_INF
    lhi, llo = bits.keys_to_pairs(lows)
    hhi, hlo = bits.keys_to_pairs(highs)
    sib = np.zeros(n_leaves, np.int32)
    sib[:-1] = leaf_addrs[1:].astype(np.int32)
    leaf_rows = _addr_rows(leaf_addrs, cfg.pages_per_node)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rows_t = T(leaf_rows)
    _build_install_leaves(dsm.pool, rows_t, khi, klo, vhi, vlo, live,
                          T(lhi), T(llo), T(hhi), T(hlo), T(sib),
                          per_leaf=per_leaf)
    del khi, klo, vhi, vlo, live, kt, vt
    dsm.dirty[rows_t] = True   # direct installs bypass the step path

    all_pages = []
    all_addrs = []
    stats = {"leaves": n_leaves, "internal": 0, "levels": 1}

    # --- internal levels ------------------------------------------------------
    level = 0
    child_addrs = leaf_addrs
    child_lows = lows
    while len(child_addrs) > 1:
        level += 1
        # children per internal page (incl. leftmost): the same fill slack
        # as the leaves
        fan = max(2, int(C.INTERNAL_CAP * fill))
        m = len(child_addrs)
        n_pages = -(-m // fan)
        addrs = alloc.alloc_many(n_pages)
        ipages = np.zeros((n_pages, _PW), np.int32)
        ipages[:, C.W_FRONT_VER] = 1
        ipages[:, C.W_REAR_VER] = 1
        ipages[:, C.W_LEVEL] = level

        pg_of = np.arange(m) // fan
        pos = np.arange(m) % fan
        # first child of each page -> leftmost; the rest -> entries keyed
        # by the child's lowest fence
        is_first = pos == 0
        ipages[pg_of[is_first], C.W_LEFTMOST] = \
            child_addrs[is_first].astype(np.int32)
        ei = ~is_first
        eslot = (pos - 1)[ei]
        ckhi, cklo = bits.keys_to_pairs(child_lows[ei])
        ipages[pg_of[ei], C.I_KHI_W + eslot] = ckhi
        ipages[pg_of[ei], C.I_KLO_W + eslot] = cklo
        ipages[pg_of[ei], C.I_PTR_W + eslot] = child_addrs[ei].astype(np.int32)
        counts = np.bincount(pg_of, minlength=n_pages) - 1
        ipages[:, C.W_NKEYS] = counts.astype(np.int32)

        pfirst = child_lows[::fan][:n_pages]
        plows = np.empty(n_pages, np.uint64)
        plows[0] = C.KEY_NEG_INF
        plows[1:] = pfirst[1:]
        phighs = np.empty(n_pages, np.uint64)
        phighs[:-1] = pfirst[1:]
        phighs[-1] = C.KEY_POS_INF
        ipages[:, C.W_LOW_HI], ipages[:, C.W_LOW_LO] = \
            bits.keys_to_pairs(plows)
        ipages[:, C.W_HIGH_HI], ipages[:, C.W_HIGH_LO] = \
            bits.keys_to_pairs(phighs)
        ipages[:-1, C.W_SIBLING] = addrs[1:].astype(np.int32)

        all_pages.append(ipages)
        all_addrs.append(addrs)
        stats["internal"] += n_pages
        stats["levels"] += 1
        child_addrs, child_lows = addrs, plows

    root_addr = int(child_addrs[0])
    root_level = level

    if all_addrs:
        rows = _addr_rows(np.concatenate(all_addrs), cfg.pages_per_node)
        _install_pages(dsm.pool, T(rows), T(np.concatenate(all_pages)))
        dsm.mark_dirty_rows(rows)

    # Install the root (bulk load is quiescent) and POISON the old root:
    # a stale root handle chases into the new tree (highest = -inf, so
    # every key overshoots; sibling = the new root).
    old_poison = old_pg.copy()
    old_poison[C.W_HIGH_HI] = 0
    old_poison[C.W_HIGH_LO] = 0
    old_poison[C.W_SIBLING] = root_addr
    dsm.write_rows([
        {"op": D.OP_WRITE, "addr": old_root, "woff": 0,
         "nw": C.PAGE_WORDS, "payload": old_poison},
        {"op": D.OP_WRITE_WORD, "addr": META_ADDR,
         "woff": C.META_ROOT_ADDR_W, "arg1": root_addr},
    ])
    tree.cluster.broadcast_new_root(root_addr, root_level)
    tree._root_addr, tree._root_level = root_addr, root_level
    stats["root_level"] = root_level

    # leaf directory for index-cache seeding (router.seed_from_leaves)
    tree._bulk_leaf_dir = (leaf_addrs.copy(), lows.copy())
    if tree.router is not None:
        tree.router.seed_from_leaves(leaf_addrs, lows)
    return stats
