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

When the nodes span several processes ("ranks", ``init_multihost``),
every rank runs the same host program on the same batch (replicated-driver
SPMD, checked with input digests by ``_check_replicated``): a rank uploads
only its own nodes' rows (``_shard``), the device steps work on its block
of ``L`` nodes and cross ranks in the transport, and their results come
back through one tiled all-gather (``_unshard``), so the host logic after
every step sees the same arrays on every rank.  Every count that decides
how many collective steps a rank takes (a loop's pending rows) is reduced
over the ranks first (``Mesh.any``/``Mesh.total``): a count that stayed
local would desynchronize the collectives.

Consistency is the reference's: a step's reads see one snapshot of the
pool, its writes land together at the step boundary, and same-key writes
in a step are linearized by request order (the lowest index wins).

Inserts run in rounds (``BatchedEngine.insert``): a leaf that overflows
splits on its owner into a page the host granted before the round, and
the split log defers the parent entries to ``flush_parents``; rows the
rounds cannot place fall back to the host ``Tree`` path.  Deletes clear
the slot's version word on the owner (``BatchedEngine.delete``), and
``BatchedEngine.reclaim_empty_leaves`` unlinks the leaves they empty and
recycles their pages through the allocators' free pools.

With a write-ahead journal attached (:meth:`BatchedEngine.attach_journal`,
done by the recovery plane), every write entry point appends one record
of the rows it applied before it returns (``utils/journal.py``).

After damage the online scrubber (``models/scrub.py``) cannot contain,
the engine serves read-only (:meth:`BatchedEngine.enter_degraded`): every
mutating entry point raises :class:`DegradedError` while searches and
all-read ``mixed`` batches keep serving.

The reference's ``lax.while_loop`` with a data-dependent exit is a Python
loop here that reads one pending count back per round (one host sync per
descent round; ROADMAP.md lists removing it).

Observability (``sherman_tpu_torch.obs``), at the reference's sites and
under its names: every entry point's device step runs inside a span
(``engine.<op>.descend_lock_apply``, ``engine.search.descend``,
``engine.search.combine``, ``engine.insert.split_drain``,
``engine.insert.flush_parents``), every top-level batch wall is
attributed to its SLO op class, the per-op device functions go through
the program ledger (``engine.search``, ``engine.search_fanout``,
``engine.insert``, ``engine.delete``, ``engine.mixed``,
``engine.parent_descend``), degraded mode keeps the ``engine.degraded``
gauge and its flight events, and write combining publishes the
``combine.*`` collector.  Every span argument and SLO count is a host
value: none reads a device tensor.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
import weakref

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import (ConfigError, InvariantError,
                                      KeyRangeError, PreconditionError,
                                      ProtocolError, ShermanError,
                                      StateError)
from sherman_tpu_torch.models import validate
from sherman_tpu_torch.models.btree import META_ADDR
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.obs import recorder as FR
from sherman_tpu_torch.obs import slo as SLO
from sherman_tpu_torch.ops import bits, layout
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import dsm as D
from sherman_tpu_torch.parallel import mesh as MESH
from sherman_tpu_torch.parallel import transport as T
from sherman_tpu_torch.utils import journal as J

# Per-key write status codes (reply of one write step).
ST_INVALID = 0      # inactive slot (padding)
ST_APPLIED = 1      # written in this step
ST_SUPERSEDED = 2   # an earlier-ordered same-key request won AND applied
ST_FULL = 3         # leaf full -> split path
ST_LOCKED = 4       # page lock held -> retry
ST_RETRY = 5        # descent incomplete / winner did not apply -> retry
ST_BAD = 6          # failed sanity checks (not a level-0 page / fence)
ST_NOT_FOUND = 7    # delete: key absent
ST_LOCK_TIMEOUT = 8  # host-side terminal: the key's page lock was still held
                     # by a LIVE lease when the insert round budget ran out

_PW = C.PAGE_WORDS
_U32 = 0xFFFFFFFF


class DegradedError(ShermanError, RuntimeError):
    """Typed write rejection: the engine is in read-only degraded mode.

    Raised by every mutating engine entry point after data-plane damage
    that quarantine could not contain (a structural violation the
    scrubber found, or a quarantine that could not take its lock).
    Searches keep being served; the exit is a repair of the flagged pages,
    a green validation, then :meth:`BatchedEngine.exit_degraded`."""

    def __init__(self, reason: str):
        super().__init__(
            "engine degraded (read-only): write rejected — " + reason
            + "; repair the flagged pages, re-validate, then exit_degraded")
        self.reason = reason


# degraded-mode gauge + lock-timeout counter (data-plane failure story)
_OBS_DEGRADED = obs.gauge("engine.degraded")
_OBS_LOCK_TIMEOUTS = obs.counter("engine.lock_timeouts")


def _slo_observe(op_class: str, ops: int, t0: float | None) -> None:
    """Attribute one host-path batch wall to its SLO op class (a client
    op's completion latency is its batch's wall).  ``t0`` None = a retry
    or chunk frame whose parent (or whose own chunks) account the ops."""
    if t0 is not None and ops:
        SLO.observe(op_class, int(ops), time.perf_counter() - t0)


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
        # shermanlint: disable=SL001 root: the tree's root address, an int
        start = torch.full((B,), int(root), dtype=torch.int32,
                           device=khi.device)
    addr = start
    done = ~active
    nreads = torch.zeros((), dtype=torch.int64, device=khi.device)
    it = 0
    # one host sync per round: the unseeded descent (no router seed) stops
    # when no row still walks.  The serve resolves from router seeds, so
    # ROADMAP's held item on the serve's host syncs does not target it.
    # shermanlint: disable=SL001 reads the descent's round count
    while it < iters and bool((~done).any()):
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
    M = MESH.of(cfg)
    N = M.n_local
    if start is None:
        # shermanlint: disable=SL001 root: the tree's root address, an int
        start = torch.full(khi.shape, int(root), dtype=torch.int32,
                           device=khi.device)
    addr = start
    done = ~active
    nreads = torch.zeros(N, dtype=torch.int64, device=khi.device)
    it = 0
    while it < iters and M.any(~done):   # one host sync per round
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
        # one host sync per straggler round: the serve's resolve (staged
        # steps, the front door's dispatch).  ROADMAP's held item on the
        # serve's host syncs targets it.
        # shermanlint: disable=SL001 reads the straggler round count
        pend = int((~s_done).sum())

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
    M = MESH.of(cfg)
    N = M.n_local
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

    it, n_pend = 1, M.total(~s_done)
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
        n_pend = M.total(~s_done)               # one host sync per round

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


def _leaf_snapshot(pool, inc, cfg: DSMConfig):
    """The write applies' common start: each row's page (and clipped
    page), the ``[M, PW]`` page snapshot (K2), the row's lock-word index
    and whether the row is sane (active, a level-0 page in range whose
    fences hold its key and whose versions agree).
    -> (page_idx, safe_page, pg, lock_idx, sane)."""
    P = pool.shape[0]
    page_idx = bits.addr_page(inc["addr"])
    safe_page = page_idx.clamp(0, P - 1)
    pg = PK.gather_pages(pool, safe_page)
    lock_idx = bits.lock_index(inc["addr"], cfg.locks_per_node)
    sane = inc["active"] & (page_idx >= 0) & (page_idx < P) \
        & (layout.h_level(pg) == 0) \
        & layout.in_fence(pg, inc["khi"], inc["klo"]) \
        & layout.page_consistent(pg)
    return page_idx, safe_page, pg, lock_idx, sane


def leaf_apply_spmd(pool, locks, counters, inc, fresh=None, *,
                    cfg: DSMConfig, update_only: bool = False,
                    combine: bool = False):
    """Apply routed upserts to their leaf pages (``leaf_page_store``):
    update an existing key in place, or insert into a free slot, writing
    only the touched 5-word entry.  Same-key requests are deduplicated
    (the lowest row index wins).

    ``fresh``: optional [F] int32 pre-allocated pages of this node (0 = no
    grant) enabling device leaf splits.  The first overflowing insert
    winner of a page (its in-page rank equals the page's free-slot count)
    becomes the page's splitter and takes the next grant; after the
    write-back the owner sorts the page's slots plus the pending entry,
    writes the upper half to the fresh right sibling and rewrites the left
    page with new fences and sibling (:func:`_leaf_split_apply`).  On a
    splitting page, updates and inserts that fit still apply (the split
    reads the post-apply page); inserts ranked past the free slots report
    ST_RETRY.  Without a grant an insert that does not fit reports
    ST_FULL.

    ``update_only`` is the steady-state update kernel: a winner whose key
    is absent reports ST_FULL (the caller escalates it to the insert
    path) instead of inserting, no insert rank is computed, and the
    write-back carries the 3 words an update changes (version pair, vhi,
    vlo).

    ``combine`` is write combining, the counterpart of Sherman's HOCL
    local-lock hand-over: the lock word is consulted once per page group
    of the sorted rows (at the group's head) and its verdict handed down
    the group, instead of one lock-word gather a row.  The rows of a page
    hash to one lock word, so the per-row verdicts of a group were always
    equal: statuses and pool bits are those of the uncombined apply, and
    only the ``CNT_COMBINE_GROUPS``/``CNT_COMBINE_SAVED`` counters differ.

    inc: dict of [M] tensors — active, addr (leaf), khi, klo, vhi, vlo.
    Updates ``pool``/``counters`` in place; returns status [M], and with
    ``fresh`` also the split log (dict of [F] tensors)."""
    M = inc["addr"].shape[0]
    P = pool.shape[0]
    L = locks.shape[0]
    dev = pool.device
    act = inc["active"]
    khi, klo = inc["khi"], inc["klo"]
    page_idx, safe_page, pg, lock_idx, sane = _leaf_snapshot(pool, inc, cfg)
    if not combine:
        locked = locks[lock_idx.clamp(0, L - 1).long()] != 0
    # combined: sane rows enter the sort, and their page group's head
    # decides the lock verdict below
    ok_req = sane if combine else sane & ~locked

    found, _, _, fslot = layout.leaf_find_key(pg, khi, klo)
    if update_only:
        assert fresh is None, "update_only excludes the split path"
    else:
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
    if combine:
        # one lock consult at each page group's head, handed down the
        # group with a position-encoded running max; a locked group's
        # rows leave ``sok`` as the per-row gather would have dropped them
        group_head = sok.clone()
        group_head[1:] &= sp[1:] != sp[:-1]
        slidx = lock_idx[sidx].clamp(0, L - 1)
        head_lw = locks[torch.where(group_head, slidx, 0).long()]
        head_locked = group_head & (head_lw != 0)
        enc_l = torch.cummax(torch.where(group_head,
                                         idx0 * 2 + head_locked.long(), -1),
                             0).values
        locked_s = sok & ((enc_l & 1) == 1)
        n_heads = group_head.sum()
        D.count(counters, D.CNT_COMBINE_GROUPS, n_heads)
        D.count(counters, D.CNT_COMBINE_SAVED, sok.sum() - n_heads)
        sok = sok & ~locked_s
    same_prev = torch.zeros(M, dtype=torch.bool, device=dev)
    same_prev[1:] = ((sp[1:] == sp[:-1]) & (skhi[1:] == skhi[:-1])
                     & (sklo[1:] == sklo[:-1]) & sok[1:])
    winner_s = sok & ~same_prev
    # sorted-space codes: ranks lie below M (at most M rows per page), a
    # granted splitter holds split_code + its fresh slot, and update_only's
    # key-absent winner holds escalate
    split_code, escalate = M, 2 * M
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
    # -2 superseded, -1 winner-found (update), r >= 0 insert rank
    code_s = torch.where(
        ~sok, -3,
        torch.where(~winner_s, torch.where(grp_winner_applied, -2, -4),
                    torch.where(sfound, -1, ins_code_s)))
    if fresh is not None:
        F = fresh.shape[0]
        # the page's FIRST overflowing insert (rank == free count) splits,
        # taking the grant of its running count over the sorted rows
        splitter_s = need_ins_s & (rank_s == sfreec)
        sf_idx = torch.cumsum(splitter_s.long(), 0) - 1
        grant = fresh[sf_idx.clamp(0, F - 1)]
        granted_s = splitter_s & (sf_idx < F) & (grant != 0)
        code_s = torch.where(granted_s, split_code + sf_idx, code_s)
    code = torch.empty_like(code_s)
    code[sidx] = code_s                                     # un-sort
    if combine:
        # the group verdict back in row space, for the status
        locked = torch.empty_like(locked_s)
        locked[sidx] = locked_s
    winner_upd = code == -1
    superseded = code == -2
    loser_retry = code == -4
    splitter = torch.zeros(M, dtype=torch.bool, device=dev)
    suppressed = splitter
    if update_only:
        full = code == escalate
        applied = winner_upd
        slot = fslot
    else:
        if fresh is not None:
            splitter = (code >= split_code) & (code < escalate)
        winner_ins = (code >= 0) & ~splitter
        rank = torch.where(winner_ins, code, 0)
        have_slot = freec >= (rank + 1)
        if fresh is not None:
            has_split = torch.zeros(P, dtype=torch.bool, device=dev)
            has_split[safe_page[splitter].long()] = True
            page_splitting = has_split[safe_page.long()]
            # inserts past the free slots of a splitting page land in its
            # halves next round
            suppressed = winner_ins & page_splitting & ~have_slot
            full = winner_ins & ~have_slot & ~page_splitting
        else:
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

    # --- device splits (they read the POST-apply page) -------------------------
    if fresh is not None:
        log = _leaf_split_apply(pool, counters, inc, splitter,
                                code - split_code, fresh, safe_page)

    status = torch.full((M,), ST_INVALID, dtype=torch.int32, device=dev)
    status = torch.where(act, ST_BAD, status)
    status = torch.where(act & sane & locked, ST_LOCKED, status)
    status = torch.where(loser_retry | suppressed, ST_RETRY, status)
    status = torch.where(superseded, ST_SUPERSEDED, status)
    status = torch.where(full, ST_FULL, status)
    status = torch.where(applied | splitter, ST_APPLIED, status)

    n_app = applied.sum()
    D.count(counters, D.CNT_WRITE_OPS, n_app)
    D.count(counters, D.CNT_WRITE_WORDS,
            n_app * (3 if update_only else C.LEAF_ENTRY_WORDS))
    if fresh is not None:
        return status, log
    return status


def _leaf_split_apply(pool, counters, inc, splitter, fidx, fresh,
                      safe_page) -> dict:
    """Execute the granted leaf splits in a compacted [F] buffer, in place.

    ``splitter``/``fidx`` select the granted rows and their fresh slots.
    Each split reads the POST-apply page (this step's fitting inserts and
    updates have landed, so the page splits exactly full), sorts its
    ``LEAF_CAP`` slots plus the pending entry by key with dead slots last,
    keeps the lower half on the left page and writes the upper half to the
    fresh right sibling; both are whole-page rewrites.  Returns the log
    for the lazy parent insert and the router: valid, skhi/sklo (split
    key), new_addr, old_hhi/old_hlo (the left page's old high fence)."""
    M = splitter.shape[0]
    P = pool.shape[0]
    F = fresh.shape[0]
    CAP = C.LEAF_CAP
    dev = pool.device

    # the granted rows in row order, padded with M to F slots (at most F
    # rows are granted); a stable sort keeps the compaction on the device
    order = torch.argsort((~splitter).to(torch.uint8), stable=True)[:F]
    sidx2 = torch.full((F,), M, dtype=torch.int64, device=dev)
    sidx2[:order.shape[0]] = torch.where(splitter[order], order, M)
    valid = sidx2 < M
    ci = sidx2.clamp(0, M - 1)
    left_row = safe_page[ci].long()
    spg = pool[left_row]                           # [F, PW] POST-apply
    pkhi, pklo = inc["khi"][ci], inc["klo"][ci]
    pvhi, pvlo = inc["vhi"][ci], inc["vlo"][ci]
    new_addr = fresh[fidx[ci].clamp(0, F - 1)]
    right_row = bits.addr_page(new_addr).clamp(0, P - 1).long()
    valid = valid & (new_addr != 0)

    # sort the slots + pending entry by key as uint64 (one stable sort on
    # the sign-flipped int64 word); dead slots take the largest word, so
    # sorted column j is live iff j < n
    sv = layout.leaf_slots_view(spg)
    live = torch.cat([layout.leaf_slot_used(spg),
                      torch.ones((F, 1), dtype=torch.bool, device=dev)], 1)
    cat = lambda blk, pend: torch.cat([blk, pend[:, None]], dim=1)
    k_hi, k_lo = cat(sv["khi"], pkhi), cat(sv["klo"], pklo)
    v_hi, v_lo = cat(sv["vhi"], pvhi), cat(sv["vlo"], pvlo)
    word = bits._ux(k_hi).long() * (1 << 32) + (k_lo.long() & _U32)
    word = torch.where(live, word, torch.iinfo(torch.int64).max)
    perm = torch.sort(word, dim=1, stable=True).indices
    gkh, gkl, gvh, gvl = (x.gather(1, perm) for x in (k_hi, k_lo, v_hi, v_lo))

    n = live.sum(1).to(torch.int32)                # live incl pending
    m = n // 2                                     # left keeps m entries
    cols = torch.arange(CAP + 1, dtype=torch.int32, device=dev)[None, :]
    at_m = cols == m[:, None]                      # split key: column m
    skhi = torch.where(at_m, gkh, 0).sum(1).to(torch.int32)
    sklo = torch.where(at_m, gkl, 0).sum(1).to(torch.int32)

    colsC = cols[:, :CAP]
    l_live = colsC < m[:, None]
    ridx = (m[:, None] + colsC).clamp(0, CAP).long()
    r_live = colsC < (n - m)[:, None]
    take = lambda a: a.gather(1, ridx)

    old_ver = spg[:, C.W_FRONT_VER]
    bumped = ((old_ver.long() + 1) & 0x7FFFFFFF).to(torch.int32)
    lver = torch.where(bumped == 0, 1, bumped)
    old_hhi, old_hlo = spg[:, C.W_HIGH_HI], spg[:, C.W_HIGH_LO]
    left = _leaf_pages(gkh[:, :CAP], gkl[:, :CAP], gvh[:, :CAP],
                       gvl[:, :CAP], l_live, lver, spg[:, C.W_LOW_HI],
                       spg[:, C.W_LOW_LO], skhi, sklo, new_addr)
    right = _leaf_pages(take(gkh), take(gkl), take(gvh), take(gvl), r_live,
                        torch.ones(F, dtype=torch.int32, device=dev), skhi,
                        sklo, old_hhi, old_hlo, spg[:, C.W_SIBLING])
    # both halves land together at the step boundary
    pool[right_row[valid]] = right[valid]
    pool[left_row[valid]] = left[valid]

    n_valid = valid.sum()
    D.count(counters, D.CNT_WRITE_OPS, n_valid * 2)
    D.count(counters, D.CNT_WRITE_WORDS, n_valid * (2 * _PW))
    return {"valid": valid, "skhi": skhi, "sklo": sklo,
            "new_addr": torch.where(valid, new_addr, 0),
            "old_hhi": old_hhi, "old_hlo": old_hlo}


def _mark_dirty_pages(dirty, page_idx, active) -> None:
    """Mark the pages the apply MAY write (over-marks, never misses)."""
    P = dirty.shape[0]
    sel = active & (page_idx >= 0) & (page_idx < P)
    dirty[page_idx[sel].long()] = True


def _route_and_apply(pool, locks, counters, dirty, apply_fn, addr, eligible,
                     fields, *, cfg: DSMConfig, fresh=None):
    """Apply ``eligible`` requests at their leaf's owner with ``apply_fn``
    (``apply_fn(pool, locks, counters, inc, fresh, cfg=cfg)``, returning
    the status or ``(status, extra)``).  One node applies directly; with
    ``machine_nr > 1`` each node bucketizes its rows by owner, the request
    fields are exchanged, every owner applies its source-major incoming
    buffer on its own shard (with its own slice of the node-major
    ``fresh``), and the statuses are exchanged back.  ``extra`` (the split
    log) stays with its owner: node-major, not routed back.  Returns
    (status [B], extra); status is ST_RETRY for rows that were not
    eligible or missed their bucket's capacity."""
    if cfg.machine_nr > 1:
        return _route_and_apply_nodes(pool, locks, counters, dirty,
                                      apply_fn, addr, eligible, fields,
                                      cfg=cfg, fresh=fresh)
    inc = {"active": eligible, "addr": addr, **fields}
    if dirty is not None:
        _mark_dirty_pages(dirty, bits.addr_page(addr), eligible)
    st, extra = _split_out(apply_fn(pool, locks, counters, inc, fresh,
                                    cfg=cfg))
    return torch.where(eligible, st, ST_RETRY), extra


def _split_out(out):
    return out if isinstance(out, tuple) else (out, None)


def _route_and_apply_nodes(pool, locks, counters, dirty, apply_fn, addr,
                           eligible, fields, *, cfg: DSMConfig, fresh=None):
    N, cap = cfg.machine_nr, cfg.step_capacity
    P = cfg.pages_per_node
    M = MESH.of(cfg)
    L = M.n_local
    nd = lambda x: x.view(L, -1)
    elig = nd(eligible)
    bucket_idx, routed = T.bucketize(bits.addr_node(nd(addr)), elig, N, cap)
    out = {"active": elig & routed, "addr": nd(addr),
           **{k: nd(v) for k, v in fields.items()}}
    out = {k: T.scatter_to_buckets(v, bucket_idx, N * cap)
           for k, v in out.items()}
    if M.spans:
        # across ranks only the buckets' filled rows cross; the owners
        # apply those (the order of the active rows is unchanged)
        fill = T.bucket_fill(bucket_idx, cap, M)
        out = {k: T.trim_buckets(v, N, cap, fill) for k, v in out.items()}
        bucket_idx = T.trimmed_slot(bucket_idx, cap, fill)
    inc = T.exchange(out, M)
    st = torch.empty(inc["active"].shape, dtype=torch.int32,
                     device=pool.device)
    extras = []
    for d in range(L):
        inc_d = {k: v[d] for k, v in inc.items()}
        if dirty is not None:
            _mark_dirty_pages(dirty[d * P:(d + 1) * P],
                              bits.addr_page(inc_d["addr"]), inc_d["active"])
        fresh_d = None if fresh is None else nd(fresh)[d]
        st[d], extra = _split_out(apply_fn(
            *D.shards(cfg, d, pool, locks, counters), inc_d, fresh_d,
            cfg=cfg))
        extras.append(extra)
    rep = T.exchange(st, M)
    safe_b = torch.where(routed, bucket_idx, 0)
    extra = None
    if extras[0] is not None:
        extra = {k: torch.cat([e[k] for e in extras]) for k in extras[0]}
    return (torch.where(elig & routed, T.take_local(rep, safe_b),
                        ST_RETRY).view(-1), extra)


def insert_step_spmd(pool, locks, counters, khi, klo, vhi, vlo, root,
                     active, start=None, fresh=None, *, cfg: DSMConfig,
                     iters: int, update_only: bool = False,
                     combine: bool = False, dirty=None):
    """One batched insert step: descend, route to the owners, leaf apply.

    With ``fresh`` (node-major pre-allocated pages, ``split_slots`` a
    node), full leaves split owner-side and the node-major split log is
    returned too.  ``update_only``, ``combine``: the steady-state update
    apply and write combining (see :func:`leaf_apply_spmd`).  ``dirty``:
    the dirty-page mask; target leaves and every OFFERED grant are marked
    (an unconsumed grant is a spare delta row, never a miss).  Updates the
    state in place; returns status [B], or (status, log) with ``fresh``."""
    done, addr, _, _, _ = _resolve_leaves(
        pool, counters, khi, klo, root, active, start, cfg=cfg, iters=iters)
    if fresh is not None and dirty is not None:
        N, P = MESH.of(cfg).n_local, cfg.pages_per_node
        for d, f in enumerate(fresh.view(N, -1)):
            _mark_dirty_pages(dirty[d * P:(d + 1) * P], bits.addr_page(f),
                              f != 0)
    status, log = _route_and_apply(
        pool, locks, counters, dirty,
        functools.partial(leaf_apply_spmd, update_only=update_only,
                          combine=combine), addr,
        done, {"khi": khi, "klo": klo, "vhi": vhi, "vlo": vlo}, cfg=cfg,
        fresh=fresh)
    status = torch.where(active, status, ST_INVALID)
    if fresh is not None:
        return status, log
    return status


# ---------------------------------------------------------------------------
# Batched delete: descend, route to the owners, clear the slot.
# ---------------------------------------------------------------------------

def leaf_delete_apply_spmd(pool, locks, counters, inc, fresh=None, *,
                           cfg: DSMConfig):
    """Clear routed delete requests on this node's leaf pages (the leaf
    step of ``Tree::del``): zero the slot's packed version word, which
    frees the slot.  The sanity, lock and found checks are the upsert
    apply's.  Clearing is idempotent, so same-key rows are not
    deduplicated: they write the same zero to the same word, which the
    write-back allows (applied rows may share a word only with equal
    values).  ``fresh`` is unused (the ``apply_fn`` signature of
    :func:`_route_and_apply`).  Updates ``pool``/``counters`` in place;
    returns status [M]."""
    M = inc["addr"].shape[0]
    L = locks.shape[0]
    act = inc["active"]
    _, safe_page, pg, lock_idx, sane = _leaf_snapshot(pool, inc, cfg)
    locked = locks[lock_idx.clamp(0, L - 1).long()] != 0
    ok_req = sane & ~locked
    found, _, _, slot = layout.leaf_find_key(pg, inc["khi"], inc["klo"])
    del pg
    applied = ok_req & found
    # one lane: the slot's packed version word; page versions move only
    # on structural rewrites, as in the reference's Tree::del
    PK.writeback(pool, safe_page.contiguous(),
                 slot.clamp(0, C.LEAF_CAP - 1).contiguous(),
                 applied.contiguous(),
                 torch.zeros((M, 1), dtype=torch.int32, device=pool.device),
                 (C.L_VER_W,))

    status = torch.full((M,), ST_INVALID, dtype=torch.int32,
                        device=pool.device)
    status = torch.where(act, ST_BAD, status)
    status = torch.where(act & sane & locked, ST_LOCKED, status)
    status = torch.where(ok_req & ~found, ST_NOT_FOUND, status)
    status = torch.where(applied, ST_APPLIED, status)
    n_app = applied.sum()
    D.count(counters, D.CNT_WRITE_OPS, n_app)
    D.count(counters, D.CNT_WRITE_WORDS, n_app)
    return status


def delete_step_spmd(pool, locks, counters, khi, klo, root, active,
                     start=None, *, cfg: DSMConfig, iters: int, dirty=None):
    """One batched delete step: descend, route to the owners, clear the
    slot.  Updates the state in place; returns status [B]."""
    done, addr, _, _, _ = _resolve_leaves(
        pool, counters, khi, klo, root, active, start, cfg=cfg, iters=iters)
    status, _ = _route_and_apply(
        pool, locks, counters, dirty, leaf_delete_apply_spmd, addr, done,
        {"khi": khi, "klo": klo}, cfg=cfg)
    return torch.where(active, status, ST_INVALID)


def mixed_step_spmd(pool, locks, counters, khi, klo, vhi, vlo, root,
                    active_r, active_w, start=None, *, cfg: DSMConfig,
                    iters: int, dirty=None, write_lo: int | None = None,
                    update_only: bool = False, combine: bool = False):
    """One fused step of searches (``active_r``) and upserts
    (``active_w``) through a single descent.  Reads that resolve see the
    pre-step pool and writes land at the step boundary, so the serial
    order is (resolved reads) < (writes); reads that overran the budget
    (done_r False) are retried later and may see this step's writes.

    ``write_lo``: when every node's block is laid out ``[reads |
    writes]`` with its writes in rows ``[write_lo:]``, the apply runs on
    those rows of each node only (its snapshot gather, dedup sort and
    write-back cost per row).  ``update_only``, ``combine``: the
    steady-state update apply and write combining (see
    :func:`leaf_apply_spmd`).
    -> (status [B], done_r [B], found [B], vhi [B], vlo [B])."""
    active = active_r | active_w
    done, addr, found, rvh, rvl = _resolve_leaves(
        pool, counters, khi, klo, root, active, start, cfg=cfg, iters=iters)
    done_r = done & active_r
    found = found & done_r
    rvh = torch.where(found, rvh, 0)
    rvl = torch.where(found, rvl, 0)
    N = MESH.of(cfg).n_local
    # shermanlint: disable=SL001 write_lo: a Python int row offset
    lo = 0 if write_lo is None else int(write_lo)
    # each node's rows [lo:] of a node-major [N*B] tensor
    w = (lambda x: x) if not lo else \
        (lambda x: x.view(N, -1)[:, lo:].reshape(-1))
    st_w, _ = _route_and_apply(
        pool, locks, counters, dirty,
        functools.partial(leaf_apply_spmd, update_only=update_only,
                          combine=combine),
        w(addr), w(done & active_w),
        {"khi": w(khi), "klo": w(klo), "vhi": w(vhi), "vlo": w(vlo)},
        cfg=cfg)
    if lo:
        st_w = torch.cat([torch.full((N, lo), ST_INVALID, dtype=st_w.dtype,
                                     device=st_w.device),
                          st_w.view(N, -1)], dim=1).view(-1)
    status = torch.where(active_w, st_w, ST_INVALID)
    return status, done_r, found, rvh, rvl


# ---------------------------------------------------------------------------
# Host-facing engine.
# ---------------------------------------------------------------------------

class BatchedEngine:
    """Batched ops over a :class:`~sherman_tpu_torch.models.btree.Tree`:
    every call pads its batch to ``machine_nr * batch_per_node`` rows
    (node ``n`` owning rows ``n*B:(n+1)*B``), so the compacted straggler
    buffers and the counters match the reference step for step."""

    def __init__(self, tree, batch_per_node: int = 1024,
                 tcfg: TreeConfig | None = None,
                 split_slots: int | None = None,
                 write_combine: bool | None = None):
        self.tree = tree
        self.dsm = tree.dsm
        self.cfg = tree.cfg
        self.tcfg = tcfg if tcfg is not None else TreeConfig()
        self.B = batch_per_node
        self.total = self.cfg.machine_nr * batch_per_node
        self.device = self.dsm.device
        # across processes: replicated-driver SPMD (every rank calls the
        # engine with IDENTICAL request streams, _check_replicated guards
        # it; host-API ops execute once through cluster.host_dsm and the
        # device batch is split over the ranks' node blocks)
        self._mesh = MESH.of(self.cfg)
        self._mh = self.dsm.multihost
        # write combining in the insert and mixed applies (see
        # leaf_apply_spmd's ``combine``): None reads the
        # SHERMAN_WRITE_COMBINE knob, True/False pins it (A/B runs)
        self._write_combine = (C.write_combine() if write_combine is None
                               else bool(write_combine))
        # batches and rows that went through the combined apply; the
        # group and saved-consult counts are the DSM counter slots
        self._combine_steps = 0
        self._combine_rows = 0
        # device-split grant slots per node per insert round; unconsumed
        # grants stay in the host cache and are offered again (free() is
        # a no-op, so dropping them would leak pages every round).  A
        # split-storm benchmark raises it so one round splits many leaves.
        self.split_slots = (min(256, batch_per_node) if split_slots is None
                            else min(split_slots, batch_per_node))
        # flush the deferred parent entries once this many are pending
        # (insert() always flushes at its end): 1 flushes every round; a
        # storm benchmark raises it to about split_slots, since the router's
        # split notes keep descents short between flushes
        self.parent_flush_threshold = 1
        self._fresh_cache: dict[int, list[int]] = {}
        self._pending_parents: list[tuple[int, int, int]] = []
        # empty-leaf reclaim bookkeeping (reclaim_empty_leaves): pages
        # waiting out their grace rounds, retired pages still owed a
        # parent-entry removal (page, old low fence, absorber), and
        # retired pages parked for good because a parent holds them as
        # its leftmost child (about 1/INTERNAL_CAP of the reclaimed)
        self._reclaim_state: dict = {"round": 0, "quarantine": [],
                                     "pending_parent": [], "parked": set()}
        # a reclaim pass is a maintenance pass over many steps, not a
        # concurrent op: an overlapping call is refused
        self._reclaim_mutex = threading.Lock()
        self.router = None
        # the hot-key tier (models/leaf_cache.py, attach_leaf_cache): a
        # versioned leaf/value cache probed in front of the descent by
        # search, search_combined and mixed; the write entry points
        # invalidate it and degraded entry flushes it.  None costs one
        # ``is None`` test a read batch.
        self.leaf_cache = None
        # the out-of-line value heap (models/value_heap.py,
        # attach_value_heap): leaf values become versioned slab handles;
        # journal replay finds it here.  None = inline 64-bit values.
        self.value_heap = None
        self._search_cache = {}
        self._insert_cache = {}
        self._delete_cache = {}
        self._mixed_cache = {}
        self._parent_descend_cache = {}
        # engine steps and host DSM steps both mutate the pool in place
        self._step_mutex = self.dsm._step_mutex
        # the write-ahead op journal (utils/journal.py, attached by the
        # recovery plane): every write op appends ONE record of its
        # APPLIED rows before returning, durable before the caller sees
        # the ack, so restore chain + replay journal loses no acknowledged
        # op (RPO 0).  Record order must match apply order, so a journaled
        # engine is driven from one thread.
        self.journal = None
        # read-only degraded mode: once set, every mutating entry point
        # raises DegradedError while searches keep serving.  A fresh
        # engine is healthy, so the gauge resets here.
        self._degraded_reason: str | None = None
        _OBS_DEGRADED.set(0)
        # the combine.* pull collector names the DSM's combine counter
        # slots and this engine's batch/row counts; registered only with
        # combining on, bound by weakref like the dsm collector
        if self._write_combine:
            _dref = weakref.ref(self.dsm)
            _eref = weakref.ref(self)

            def _combine_collect():
                d = _dref()
                e = _eref()
                if d is None or e is None:
                    return {}
                snap = d.counter_snapshot()
                groups = snap["combine_groups"]
                saved = snap["combine_locks_saved"]
                return {"groups": groups, "locks_saved": saved,
                        "ops_combined": saved,
                        "steps": float(e._combine_steps),
                        "rows": float(e._combine_rows)}
            obs.register_collector("combine", _combine_collect)

    # -- degraded mode (read-only serving after unrecoverable damage) --------

    @property
    def degraded(self) -> bool:
        return self._degraded_reason is not None

    @property
    def degraded_reason(self) -> str | None:
        return self._degraded_reason

    def enter_degraded(self, reason: str) -> None:
        """Flip to read-only degraded serving: searches continue, writes
        raise :class:`DegradedError`.  Idempotent: the first reason, the
        root cause, stays.  Sets the ``engine.degraded`` gauge, records
        an ``engine.degraded_enter`` flight event and auto-dumps the black
        box, and flushes the hot-key tier: it must not serve answers
        certified against a pool the engine no longer trusts."""
        if self._degraded_reason is None:
            self._degraded_reason = reason
            _OBS_DEGRADED.set(1)
            obs.counter("engine.degraded_entries").inc()
            if self.leaf_cache is not None:
                self.leaf_cache.flush()
            FR.record_event("engine.degraded_enter", reason=reason)
            FR.auto_dump("degraded_entry")

    def exit_degraded(self) -> None:
        """Clear degraded mode, only once the damage is gone (repaired and
        validated again)."""
        self._degraded_reason = None
        _OBS_DEGRADED.set(0)
        FR.record_event("engine.degraded_exit")

    def _require_writable(self) -> None:
        if self._degraded_reason is not None:
            FR.record_event("engine.typed_error", error="DegradedError",
                            reason=self._degraded_reason)
            FR.auto_dump("typed_error")
            raise DegradedError(self._degraded_reason)

    def attach_journal(self, journal) -> None:
        """Attach (or detach, with ``None``) the write-ahead op journal;
        see the ``journal`` attribute's contract in ``__init__``."""
        self.journal = journal

    def _journal_applied(self, kind: int, keys, values=None) -> None:
        if self.journal is None or keys.size == 0:
            return
        self.journal.append(kind, keys, values)

    def _note_combine_step(self, rows: int) -> None:
        """Count one batch of ``rows`` write rows through the combined
        apply."""
        self._combine_steps += 1
        self._combine_rows += rows

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
            leaf_dir = validate.leaf_directory(self.tree)
        if log2_buckets is None:
            n_leaves = len(leaf_dir[0]) if leaf_dir else 1024
            log2_buckets = default_log2_buckets(n_leaves)
        r = LeafRouter(self.tree, log2_buckets)
        if leaf_dir is not None and len(leaf_dir[0]):
            r.seed_from_leaves(*leaf_dir)
        self.router = r
        return r

    def attach_leaf_cache(self, slots: int | None = None,
                          admit_every: int = 0):
        """Create and attach the hot-key tier (models/leaf_cache.py),
        probed in front of the descent by every read entry point.
        ``slots`` defaults to the ``SHERMAN_LEAF_CACHE`` knob (65,536 when
        it only says "on"); ``admit_every`` > 0 arms auto-admission every
        that many observed read batches (0: manual ``fill``).  Across
        ranks every rank attaches, fills and probes it together: each
        probes its nodes' rows against one replicated table."""
        from sherman_tpu_torch.models.leaf_cache import LeafCache
        self.leaf_cache = LeafCache(self, slots=slots,
                                    admit_every=admit_every)
        return self.leaf_cache

    def attach_value_heap(self, **kw):
        """Create and attach the out-of-line value heap
        (models/value_heap.py) over this engine's DSM heap region
        (``DSMConfig.heap_pages_per_node``): ``put``/``get``/``remove``/
        ``scan`` on the returned ``ValueHeap`` serve variable-length
        payloads behind versioned handles."""
        from sherman_tpu_torch.models.value_heap import ValueHeap
        return ValueHeap(self, **kw)

    def detach_leaf_cache(self) -> None:
        """Drop the hot-key tier (reads go back to full descents) and its
        ``cache`` collector."""
        if self.leaf_cache is not None:
            obs.get_registry().unregister_collector("cache")
        self.leaf_cache = None

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

    def _shard(self, x: np.ndarray) -> torch.Tensor:
        """A node-major host array ``[N*k, ...]`` -> this process's node
        block on the device (every rank holds the whole replicated batch;
        in one process, all of it)."""
        if not self._mh:
            return self._dev(x)
        per = x.shape[0] // self.cfg.machine_nr
        nodes = self._mesh.local_nodes
        return self._dev(x[nodes.start * per:nodes.stop * per])

    def _unshard(self, *ys):
        """Node-major device results -> host arrays of the whole batch on
        every rank (across ranks: each rank's block and ONE tiled
        all-gather for all of them, the blocks in rank order).  One array
        for one input, else a tuple."""
        out = tuple(y.cpu().numpy() for y in ys)
        if self._mh:
            from sherman_tpu_torch.parallel import bootstrap
            out = bootstrap.process_allgather(out, tiled=True)
        return out[0] if len(ys) == 1 else out

    def _check_replicated(self, *arrays) -> None:
        """Across processes every rank must drive identical request
        streams (the mirrored allocators and the collective step sequences
        depend on it): one crc32 digest all-gather, raising
        :class:`ProtocolError` on skew."""
        if not self._mh:
            return
        import zlib

        from sherman_tpu_torch.parallel import bootstrap
        dig = 0
        for a in arrays:
            dig = zlib.crc32(np.ascontiguousarray(a).tobytes(), dig)
        digs = bootstrap.process_allgather(
            np.asarray([dig], np.uint32)).ravel()
        if not (digs == np.uint32(dig)).all():
            raise ProtocolError(
                "multihost engine drivers diverged across processes: every "
                "process must drive identical request streams "
                "(replicated-driver SPMD)")

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
        if _depth == 0:
            self._check_replicated(keys)
        self._check_range(keys)
        n = keys.shape[0]
        if n > self.total:
            parts = [self.search(keys[i:i + self.total])
                     for i in range(0, n, self.total)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        # SLO accounting: one batch wall per top-level call (chunks
        # account their own; straggler retries fold into their parent's)
        t_slo = time.perf_counter() if _depth == 0 else None
        khi, klo = bits.keys_to_pairs(keys)
        khi, klo = self._pad(khi), self._pad(klo)
        active = self._pad(np.ones(n, bool))
        # the hot-key tier: validated hits (bit-identical to a descent)
        # leave the device batch, and the search serves the residual rows
        cache = self.leaf_cache if _depth == 0 and n else None
        c_hit = None
        if cache is not None:
            cache.observe(keys)
            c_hit, c_vhi, c_vlo = cache.probe(khi, klo, active)
            active = active & ~c_hit
        active = self._shard(active)
        # retries (depth > 0) bypass the index cache and descend from root
        use_router = self.router is not None and _depth == 0
        fn = self._get_search(self._iters(), use_router)
        args = [self._shard(khi), self._shard(klo), self.tree._root_addr,
                active]
        if use_router:
            args.append(self._shard(self.router.host_start(khi, klo)))
        # the span covers the launch and the replies' copy to the host
        with obs.span("engine.search.descend", n=int(n)):
            with self._step_mutex:
                done, found, vhi, vlo = fn(self.dsm.pool, self.dsm.counters,
                                           *args)
            done, found, vhi, vlo = self._unshard(done, found, vhi, vlo)
        done = done[:n]
        vals = bits.pairs_to_keys(vhi[:n], vlo[:n])
        fnd = found[:n].copy()
        if c_hit is not None and c_hit[:n].any():
            # merge the cache hits back (their device rows were inactive)
            hits = c_hit[:n]
            done = done.copy()
            done[hits] = True
            fnd[hits] = True
            vals[hits] = bits.pairs_to_keys(c_vhi[:n], c_vlo[:n])[hits]
        if not done.all():
            if _depth >= 8:
                raise KeyRangeError("search stragglers not converging")
            # stale cache / height growth / buffer overflow: refresh the
            # root and fully descend the stragglers
            self.tree._refresh_root()
            miss = ~done
            vals[miss], fnd[miss] = self.search(keys[miss], _depth=_depth + 1)
        _slo_observe("read", n, t_slo)
        return vals, fnd

    def _get_search(self, iters: int, with_start: bool):
        """The search step ``fn(pool, counters, khi, klo, root, active[,
        start]) -> (done, found, vhi, vlo)``, one ledgered callable per
        variant."""
        key = (iters, with_start)
        fn = self._search_cache.get(key)
        if fn is None:
            kernel = search_routed_spmd if with_start else search_spmd
            fn = DEV.wrap_program("engine.search", functools.partial(
                kernel, cfg=self.cfg, iters=iters))
            self._search_cache[key] = fn
        return fn

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
            M = MESH.of(cfg)
            N = M.n_local

            def fn(pool, counters, khi, klo, root, active, start, inv):
                done, found, vhi, vlo = search_routed_spmd(
                    pool, counters, khi, klo, root, active, start, cfg=cfg,
                    iters=iters)
                # one gather of packed [U, 3] rows per client (the
                # reference's table adds a zero fourth lane, TPU padding)
                ans = torch.stack([found.to(torch.int32), vhi, vlo], dim=1)
                if cfg.machine_nr > 1:
                    ans = T.gather_rows(ans.view(N, -1, 3), M)
                out = ans[inv.clamp(0, ans.shape[0] - 1)]
                return done, out[:, 0] != 0, out[:, 1], out[:, 2]

            fn = DEV.wrap_program("engine.search_fanout", fn)
            self._search_cache[("fanout", iters)] = fn
        return fn

    def search_combined(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Batched lookup with request combining: duplicate keys share one
        descent, and every request's answer is fanned out on the device
        (through :meth:`_get_search_fanout`).
        -> (values uint64 [n], found bool [n])."""
        keys = np.asarray(keys, np.uint64)
        self._check_replicated(keys)
        with obs.span("engine.search.combine", n=int(keys.size)):
            uk, inv = np.unique(keys, return_inverse=True)
        if self.router is None or not 0 < uk.size <= self.total:
            # host fan-out: search() attributes the unique-set batch
            vals, found = self.search(uk)
            return vals[inv], found[inv]
        t_slo = time.perf_counter()
        self._check_range(keys)
        n = keys.size
        khi, klo = bits.keys_to_pairs(uk)
        khi, klo = self._pad(khi), self._pad(klo)
        active = self._pad(np.ones(uk.size, bool))
        # the hot-key tier probes the unique set; hits leave the device
        # batch and merge back per client row through the inverse map.
        # The admission sketch sees the raw keys (their multiplicities).
        cache = self.leaf_cache if uk.size else None
        hit_u = None
        if cache is not None:
            cache.observe(keys)
            c_hit, c_vhi, c_vlo = cache.probe(khi, klo, active)
            active = active & ~c_hit
            hit_u = c_hit[:uk.size]
        active = self._shard(active)
        start = self._shard(self.router.host_start(khi, klo))
        kt, lt = self._shard(khi), self._shard(klo)
        # the client rows stay whole on every rank: the fan-out gathers
        # the node-major answer table for every node
        inv_t = self._dev(inv.astype(np.int64))
        fn = self._get_search_fanout(self._iters())
        with obs.span("engine.search.descend", n=int(uk.size),
                      fanout=int(n)):
            with self._step_mutex:
                done, found, vhi, vlo = fn(
                    self.dsm.pool, self.dsm.counters, kt, lt,
                    self.tree._root_addr, active, start, inv_t)
            done_h = self._unshard(done)[:uk.size]
            all_done = bool((done_h if hit_u is None
                             else done_h | hit_u).all())
            if all_done:
                # one device-to-host copy of the packed answers
                ans = torch.stack([found.to(torch.int32), vhi, vlo], dim=1)
                ans = ans.cpu().numpy()
        if not all_done:
            # straggler rescue: search() attributes the rescue batch
            vals, fnd = self.search(uk)
            return vals[inv], fnd[inv]
        if hit_u is not None and hit_u.any():
            # the hits' fan-out rows carried an inactive unique row:
            # overwrite them client-side through the inverse map
            chit = hit_u[inv]
            ans[chit, 0] = 1
            ans[chit, 1] = c_vhi[:uk.size][inv][chit]
            ans[chit, 2] = c_vlo[:uk.size][inv][chit]
        _slo_observe("read", n, t_slo)
        return bits.pairs_to_keys(ans[:, 1], ans[:, 2]), ans[:, 0] != 0

    def mixed(self, keys, values, is_read):
        """One fused step of reads and upserts over one key batch.

        keys u64 [n], values u64 [n] (ignored where is_read), is_read
        bool [n].  -> (out_values u64 [n], found bool [n] for read rows,
        status int32 [n] for write rows).  Reads that overran the descent
        budget retry as a later search (they may see this step's writes).
        Writes that missed the fast path (ST_FULL / ST_RETRY / ST_LOCKED:
        a split, a stale seed, a held lock) retry through :meth:`insert`,
        and their status is rewritten to its outcome: the first request of
        a key APPLIED, later duplicates SUPERSEDED, and ST_LOCK_TIMEOUT
        where a live lease held the key's lock past the round budget."""
        t_slo = time.perf_counter()
        keys = np.asarray(keys, np.uint64)
        self._check_range(keys)
        values = np.asarray(values, np.uint64)
        is_read = np.asarray(is_read, bool)
        self._check_replicated(keys, values, is_read)
        if not is_read.all():
            self._require_writable()    # degraded mode: reads-only batches
        n = keys.shape[0]
        khi, klo = bits.keys_to_pairs(keys)
        vhi, vlo = bits.keys_to_pairs(values)
        khi, klo, vhi, vlo = (self._pad(x) for x in (khi, klo, vhi, vlo))
        ar = self._pad(is_read)                  # pad rows neither read
        aw = self._shard(self._pad(~is_read))    # nor write
        # the hot-key tier probes the read rows only: hits see the same
        # pre-step pool the fused step's reads see, so the mixed
        # linearization (reads before the step's writes) holds
        cache = self.leaf_cache
        c_hit = None
        if cache is not None and bool(is_read.any()):
            c_hit, c_vhi, c_vlo = cache.probe(khi, klo, ar)
            ar = ar & ~c_hit
        ar = self._shard(ar)
        start = (self._shard(self.router.host_start(khi, klo))
                 if self.router is not None else None)
        t = [self._shard(x) for x in (khi, klo, vhi, vlo)]
        fn = self._get_mixed(self._iters())
        if self._write_combine:
            self._note_combine_step(int(np.count_nonzero(~is_read)))
        with obs.span("engine.mixed.descend_lock_apply", n=int(n)):
            with self._step_mutex:
                status, done_r, found, rvh, rvl = fn(
                    self.dsm.pool, self.dsm.locks, self.dsm.counters,
                    self.dsm.dirty, *t, self.tree._root_addr, ar, aw, start)
            status, done_r, found, rvh, rvl = (
                x[:n] for x in self._unshard(status, done_r, found, rvh,
                                             rvl))
        status = status.copy()
        found = found.copy()
        out_vals = bits.pairs_to_keys(rvh, rvl)
        if c_hit is not None and c_hit[:n].any():
            # merge the cache-served reads (the probe's active rows were
            # the read rows, so every hit is a read row)
            hits = c_hit[:n]
            done_r = done_r.copy()
            done_r[hits] = True
            found[hits] = True
            out_vals[hits] = bits.pairs_to_keys(c_vhi[:n], c_vlo[:n])[hits]
        # journal the fast path's applied writes BEFORE the retry through
        # insert() (which journals its own record): record order then
        # equals apply order, same-key duplicates across the two included
        fast_app = ~is_read & (status == ST_APPLIED)
        self._journal_applied(J.J_UPSERT, keys[fast_app], values[fast_app])
        if cache is not None and bool((~is_read).any()):
            # the write path's invalidation: these keys' entry versions
            # bump this step (the whole write class, conservatively;
            # retried writes go through insert(), which invalidates its
            # own keys)
            cache.invalidate_keys(keys[~is_read])
        miss_r = is_read & ~done_r
        if miss_r.any():
            out_vals[miss_r], found[miss_r] = self.search(keys[miss_r])
        miss_w = ~is_read & np.isin(status, (ST_FULL, ST_RETRY, ST_LOCKED))
        if miss_w.any():
            st = self.insert(keys[miss_w], values[miss_w])
            # the rewrite below rests on insert()'s postcondition: every
            # request ends applied, superseded, applied by the host path
            # or rejected with ST_LOCK_TIMEOUT
            resolved = (st["applied"] + st["superseded"] + st["host_path"]
                        + st["lock_timeouts"])
            assert resolved == int(miss_w.sum()), (
                f"insert() postcondition broken: {st} resolved != "
                f"{int(miss_w.sum())} retried writes")
            idx_w = np.nonzero(miss_w)[0]
            first = np.zeros(idx_w.shape[0], bool)
            first[np.unique(keys[idx_w], return_index=True)[1]] = True
            status[idx_w[first]] = ST_APPLIED
            status[idx_w[~first]] = ST_SUPERSEDED
            if st["lock_timeouts"]:
                to = np.isin(keys[idx_w],
                             np.asarray(st["lock_timeout_keys"], np.uint64))
                status[idx_w[to]] = ST_LOCK_TIMEOUT
        # the whole fused batch (retry sub-batches included, which also
        # report under their own classes) is the mixed class's wall
        _slo_observe("mixed", n, t_slo)
        return out_vals, found, status

    def _get_mixed(self, iters: int):
        """The fused read/upsert step ``fn(pool, locks, counters, dirty,
        khi, klo, vhi, vlo, root, active_r, active_w, start) -> (status,
        done_r, found, vhi, vlo)`` (``start`` None without a router), one
        ledgered callable per descent budget and combine setting."""
        combine = self._write_combine
        key = (iters, combine)
        fn = self._mixed_cache.get(key)
        if fn is None:
            cfg = self.cfg

            def fn(pool, locks, counters, dirty, khi, klo, vhi, vlo, root,
                   active_r, active_w, start):
                return mixed_step_spmd(
                    pool, locks, counters, khi, klo, vhi, vlo, root,
                    active_r, active_w, start, cfg=cfg, iters=iters,
                    dirty=dirty, combine=combine)

            fn = DEV.wrap_program("engine.mixed", fn)
            self._mixed_cache[key] = fn
        return fn

    # -- insert with device splits ------------------------------------------

    def _get_insert(self, iters: int, with_start: bool,
                    with_fresh: bool = True, update_only: bool = False):
        """The insert step ``fn(pool, locks, counters, dirty, khi, klo,
        vhi, vlo, root, active[, start][, fresh]) -> status`` (``(status,
        log)`` with ``fresh``), one callable per variant.  ``with_fresh``
        enables the device splits; rounds that offer no grant run without
        the split machinery.  ``update_only``: the 3-word update apply.
        The engine's ``_write_combine`` selects the combined apply; it is
        part of the cache key."""
        assert not (update_only and with_fresh)
        combine = self._write_combine
        key = (iters, with_start, with_fresh, update_only, combine)
        fn = self._insert_cache.get(key)
        if fn is None:
            cfg = self.cfg

            def fn(pool, locks, counters, dirty, khi, klo, vhi, vlo, root,
                   active, *rest):
                start = rest[0] if with_start else None
                fresh = rest[-1] if with_fresh else None
                return insert_step_spmd(
                    pool, locks, counters, khi, klo, vhi, vlo, root, active,
                    start, fresh, cfg=cfg, iters=iters,
                    update_only=update_only, combine=combine, dirty=dirty)

            fn = DEV.wrap_program("engine.insert", fn)
            self._insert_cache[key] = fn
        return fn

    def insert(self, keys, values, max_rounds: int | None = None) -> dict:
        """Batched upsert with device leaf splits and the host path as the
        fallback.  Returns stats {applied, superseded, host_path, rounds,
        st_locked, lock_timeouts, lock_timeout_keys[, device_splits]}:
        every request ends APPLIED, SUPERSEDED, applied through the host
        path, or, when a live lease held its page lock past the bounded
        retry budget, REJECTED with ST_LOCK_TIMEOUT (counted in
        lock_timeouts, keys in lock_timeout_keys)."""
        self._require_writable()
        t_slo = time.perf_counter()
        if max_rounds is None:
            max_rounds = self.tcfg.insert_rounds
        keys = np.asarray(keys, np.uint64)
        self._check_range(keys)
        values = np.asarray(values, np.uint64)
        self._check_replicated(keys, values)
        n = keys.shape[0]
        stats = {"applied": 0, "superseded": 0, "host_path": 0, "rounds": 0,
                 "st_locked": 0, "lock_timeouts": 0, "lock_timeout_keys": []}
        applied_rows = np.zeros(n, bool)
        for i in range(0, n, self.total):
            applied_rows[i:i + self.total] = self._insert_chunk(
                keys[i:i + self.total], values[i:i + self.total],
                max_rounds, stats)
        self.flush_parents()
        # ONE journal record of the rows that landed (superseded
        # duplicates carry the winner's value and lock-timeout rejections
        # never applied: both excluded), durable before the stats return
        self._journal_applied(J.J_UPSERT, keys[applied_rows],
                              values[applied_rows])
        if self.leaf_cache is not None and n:
            # the write path's invalidation (entry versions bumped), the
            # whole batch: superseded duplicates share their winner's key
            self.leaf_cache.invalidate_keys(keys)
        # the wall holds flush_parents and the durable journal append:
        # insert's ack latency, which an SLO target governs
        _slo_observe("insert", n, t_slo)
        return stats

    def _get_parent_descend(self, iters: int, stop_level: int = 1):
        """``fn(pool, counters, khi, klo, root, active) -> (addr, page,
        done)``: the descent to ``stop_level``."""
        key = (iters, stop_level)
        fn = self._parent_descend_cache.get(key)
        if fn is None:
            fn = DEV.wrap_program("engine.parent_descend", functools.partial(
                descend_spmd, cfg=self.cfg, iters=iters,
                stop_level=stop_level))
            self._parent_descend_cache[key] = fn
        return fn

    def _descend_to_level(self, keys: np.ndarray, level: int = 1):
        """Batched root -> level-``level`` descent.  -> (addrs [n],
        done [n])."""
        n = keys.shape[0]
        if n > self.total:
            parts = [self._descend_to_level(keys[i:i + self.total], level)
                     for i in range(0, n, self.total)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        khi, klo = bits.keys_to_pairs(keys)
        kt, lt = self._shard(self._pad(khi)), self._shard(self._pad(klo))
        active = self._shard(self._pad(np.ones(n, bool)))
        fn = self._get_parent_descend(self._iters(), level)
        with self._step_mutex:
            addr, _, done = fn(self.dsm.pool, self.dsm.counters, kt, lt,
                               self.tree._root_addr, active)
        addr, done = self._unshard(addr, done)
        return addr[:n], done[:n]

    def flush_parents(self) -> int:
        """Insert the deferred parent entries of the device splits,
        batched at every level: per pending level one device descent to
        that level, one host step that locks and reads every touched
        internal page, a host merge (an overflowing page splits in the
        batch, its promoted middle entry joining the next attempt one
        level up), and one step writing every rebuilt page with all the
        unlocks.  Root growth goes through the host path.  Searches are
        correct without any of this (the B-link reaches the new pages);
        it trims sibling chases.  Returns the entries flushed."""
        # swap the list out first, so an entry appended meanwhile is kept
        raw, self._pending_parents = self._pending_parents, []
        if not raw:
            return 0
        with obs.span("engine.insert.flush_parents", n=len(raw)):
            return self._flush_parents_drained(raw)

    def _flush_parents_drained(self, raw) -> int:
        pend = list(raw)
        tree, dsm = self.tree, self.dsm
        for _attempt in range(12):
            if not pend:
                break
            tree._refresh_root()
            # entries above the current root grow the tree (once a level)
            grow = [t for t in pend if t[2] > tree._root_level]
            pend = [t for t in pend if t[2] <= tree._root_level]
            for k, c, lv in grow:
                tree._insert_parent(int(k), int(c), int(lv), {})
            if not pend:
                continue

            next_pend = []
            for lv in sorted({t[2] for t in pend}):
                at_lv = [t for t in pend if t[2] == lv]
                keysu = np.array([k for k, _, _ in at_lv], np.uint64)
                addrs, done = self._descend_to_level(keysu, lv)

                # lock + read every distinct target page in ONE step; two
                # pages on one lock word: the second CAS loses and its
                # entries wait for the next attempt
                uaddr = [int(a) for a in np.unique(addrs[done])]
                rows = []
                for a in uaddr:
                    la = tree._lock_word_addr(a)
                    rows.append({"op": D.OP_CAS, "addr": la, "woff": 0,
                                 "arg0": 0, "arg1": tree.ctx.lease,
                                 "space": D.SPACE_LOCK})
                    rows.append({"op": D.OP_READ, "addr": a})
                rep = dsm._batch(rows)
                pages, unlock_rows = {}, []
                for i, a in enumerate(uaddr):
                    if bool(rep.ok[2 * i]):
                        pages[a] = np.array(rep.data[2 * i + 1])
                        unlock_rows.append(tree._unlock_row(
                            tree._lock_word_addr(a)))

                group = collections.defaultdict(list)
                for (k, c, _), a, d in zip(at_lv, addrs, done):
                    if d and int(a) in pages:
                        group[int(a)].append((int(k), int(c)))
                    else:
                        next_pend.append((k, c, lv))

                write_rows, host_fb = [], []
                for a, ents_new in group.items():
                    pg = pages[a]
                    lo, hi = layout.np_lowest(pg), layout.np_highest(pg)
                    stay = [(k, c) for k, c in ents_new if lo <= k < hi]
                    next_pend += [(k, c, lv) for k, c in ents_new
                                  if not (lo <= k < hi)]  # fence moved
                    if not stay:
                        continue
                    ents = sorted(set(layout.np_internal_entries(pg)
                                      + stay))
                    if len(ents) <= C.INTERNAL_CAP:
                        newpg = layout.np_internal_rebuild(pg, ents, lv)
                        write_rows.append({"op": D.OP_WRITE, "addr": a,
                                           "woff": 0, "nw": C.PAGE_WORDS,
                                           "payload": newpg})
                        continue
                    if len(ents) > 2 * C.INTERNAL_CAP:
                        host_fb += stay  # needs more than one split
                        continue
                    # split the locked page here: both halves join the
                    # same write step, the middle entry moves up a level
                    try:
                        sib_addr = tree.ctx.alloc.alloc()
                    except MemoryError:
                        host_fb += stay
                        continue
                    m = len(ents) // 2
                    up_key, up_child = ents[m]
                    old_sib = int(pg[C.W_SIBLING])
                    ver = ((int(pg[C.W_FRONT_VER]) + 1) & 0x7FFFFFFF) or 1
                    right = layout.np_empty_page(lv, up_key, hi,
                                                 sibling=old_sib,
                                                 leftmost=up_child)
                    for i, (k2, c2) in enumerate(ents[m + 1:]):
                        layout.np_internal_set_entry(right, i, k2, c2)
                    right[C.W_NKEYS] = len(ents) - m - 1
                    left = layout.np_empty_page(
                        lv, lo, up_key, sibling=sib_addr,
                        leftmost=int(pg[C.W_LEFTMOST]), version=ver)
                    for i, (k2, c2) in enumerate(ents[:m]):
                        layout.np_internal_set_entry(left, i, k2, c2)
                    left[C.W_NKEYS] = m
                    write_rows.append({"op": D.OP_WRITE, "addr": sib_addr,
                                       "woff": 0, "nw": C.PAGE_WORDS,
                                       "payload": right})
                    write_rows.append({"op": D.OP_WRITE, "addr": a,
                                       "woff": 0, "nw": C.PAGE_WORDS,
                                       "payload": left})
                    next_pend.append((up_key, sib_addr, lv + 1))
                if write_rows or unlock_rows:
                    dsm.write_rows(write_rows + unlock_rows)
                for k, c in host_fb:
                    tree._insert_parent(k, c, lv, {})
            pend = next_pend
        for k, c, lv in pend:
            tree._insert_parent(int(k), int(c), int(lv), {})
        return len(raw)

    def _fill_fresh(self, grant: bool) -> np.ndarray:
        """Per-node fresh-page grants for the next insert round ([N*F],
        0 = no grant).  A grant is a page of the node that owns the
        splitting leaf; unconsumed grants stay cached for the next
        round."""
        N, F = self.cfg.machine_nr, self.split_slots
        arr = np.zeros(N * F, np.int32)
        if not grant:
            return arr
        for nd in range(N):
            lst = self._fresh_cache.setdefault(nd, [])
            while len(lst) < F:
                try:
                    lst.append(self.tree.ctx.alloc.alloc(node=nd))
                except (KeyError, MemoryError):
                    break  # partition exhausted
            arr[nd * F:nd * F + len(lst[:F])] = lst[:F]
        return arr

    def _drain_split_log(self, log, stats) -> None:
        """Apply a round's split log: drop the consumed grants from the
        cache, note the splits in the router, and queue the parent
        entries (the B-link already reaches the new pages)."""
        valid, new_addr, skhi, sklo, ohhi, ohlo = self._unshard(
            *(log[k] for k in ("valid", "new_addr", "skhi", "sklo",
                               "old_hhi", "old_hlo")))
        if not valid.any():
            return
        new_addr = new_addr[valid]
        sk = bits.pairs_to_keys(skhi[valid], sklo[valid])
        oh = bits.pairs_to_keys(ohhi[valid], ohlo[valid])
        consumed = set(int(a) for a in new_addr)
        for nd, lst in self._fresh_cache.items():
            self._fresh_cache[nd] = [a for a in lst if a not in consumed]
        stats["device_splits"] = stats.get("device_splits", 0) + len(sk)
        if self.router is not None:
            self.router.note_splits_batch(sk, new_addr, oh)
        self._pending_parents += [(int(k), int(a), 1)
                                  for k, a in zip(sk, new_addr)]

    def _insert_chunk(self, keys, values, max_rounds, stats) -> np.ndarray:
        """-> applied [n] bool: rows whose OWN value landed in the pool
        (device round or host path), the journal's record set.
        Superseded duplicates and lock-timeout rejections stay False."""
        n = keys.shape[0]
        applied_rows = np.zeros(n, bool)
        pending = np.ones(n, bool)
        # consecutive rounds each row spent blocked on a held page lock
        locked_rounds = np.zeros(n, np.int32)
        fresh_np = self._fill_fresh(False)  # round 0: optimistic, no splits
        # Keep going past max_rounds while rounds make progress (an append
        # drains the rightmost leaf a few keys a round); stop after 2
        # stalled rounds or at 16x the budget.
        round_i, stalled = 0, 0
        router_usable = self.router is not None
        while round_i < max_rounds or (stalled < 2
                                       and round_i < max_rounds * 16):
            round_i += 1
            if not pending.any():
                return applied_rows
            n_before = int(pending.sum())
            stats["rounds"] += 1
            idx = np.nonzero(pending)[0]
            khi, klo = bits.keys_to_pairs(keys[idx])
            vhi, vlo = bits.keys_to_pairs(values[idx])
            khi, klo, vhi, vlo = (self._pad(x) for x in (khi, klo, vhi, vlo))
            active = self._pad(np.ones(idx.shape[0], bool))
            # once a round makes no progress, stop using the router for the
            # rest of the chunk: seeds far left of a key's leaf could cost
            # more chases than the descent budget, forever
            if stalled > 0:
                router_usable = False
            use_router = router_usable
            with_fresh = bool(fresh_np.any())
            fn = self._get_insert(self._iters(), use_router, with_fresh)
            if self._write_combine:
                self._note_combine_step(int(np.count_nonzero(active)))
            args = [self._shard(x) for x in (khi, klo, vhi, vlo)]
            args += [self.tree._root_addr, self._shard(active)]
            if use_router:
                args.append(self._shard(self.router.host_start(khi, klo)))
            if with_fresh:
                args.append(self._shard(fresh_np))
            # one device round (descend, lock, apply, splits); the span
            # ends at the round's one status read-back
            with obs.span("engine.insert.descend_lock_apply",
                          n=int(idx.shape[0]), round=round_i):
                with self._step_mutex:
                    out = fn(self.dsm.pool, self.dsm.locks,
                             self.dsm.counters, self.dsm.dirty, *args)
                status, log = out if with_fresh else (out, None)
                status = self._unshard(status)[:idx.shape[0]]
            stats["st_locked"] += int((status == ST_LOCKED).sum())
            if log is not None:
                with obs.span("engine.insert.split_drain"):
                    self._drain_split_log(log, stats)
            if len(self._pending_parents) >= self.parent_flush_threshold:
                self.flush_parents()

            stats["applied"] += int((status == ST_APPLIED).sum())
            stats["superseded"] += int((status == ST_SUPERSEDED).sum())
            applied_rows[idx[status == ST_APPLIED]] = True
            done = (status == ST_APPLIED) | (status == ST_SUPERSEDED)
            pending[idx[done]] = False

            # bounded lock retry: every lock_retry_rounds consecutive
            # blocked rounds, probe the lease table; a dead holder is
            # revoked and the row retries fresh, a live one keeps its count
            lr = status == ST_LOCKED
            locked_rounds[idx[lr]] += 1
            locked_rounds[idx[~lr]] = 0
            probe = np.zeros(n, bool)
            probe[idx] = lr & (locked_rounds[idx]
                               % self.tcfg.lock_retry_rounds == 0)
            if probe.any():
                live = self._recover_wedged_locks(keys[probe])
                rows_p = np.nonzero(probe)[0]
                locked_rounds[rows_p[~live]] = 0
            if lr.any():
                # backoff before spinning on held locks again (doubles per
                # consecutive blocked round, capped)
                time.sleep(min(2e-4 * (1 << min(int(locked_rounds.max()),
                                                6)), 2e-2))

            # ST_BAD should not happen: such rows go through the host path
            bad = status == ST_BAD
            for j in idx[bad]:
                self.tree.insert(int(keys[j]), int(values[j]))
                stats["host_path"] += 1
                applied_rows[j] = True
                pending[j] = False
            if bad.any():
                self.tree._refresh_root()
            # grant pages whenever anything retries: a suppressed writer on
            # a splitting page may need to split again next round
            fresh_np = self._fill_fresh(
                bool(((status == ST_FULL) | (status == ST_RETRY)).any()))
            stalled = stalled + 1 if int(pending.sum()) == n_before else 0
        # Budget spent: rows still blocked by a LIVE lease get the typed
        # ST_LOCK_TIMEOUT rejection (one last probe revokes a holder that
        # died after the last round); the rest go through the host path.
        still = np.nonzero(pending)[0]
        blocked = still[locked_rounds[still] > 0]
        if blocked.size:
            to = blocked[self._recover_wedged_locks(keys[blocked])]
            if to.size:
                stats["lock_timeouts"] += int(to.size)
                stats["lock_timeout_keys"] += [int(k) for k in keys[to]]
                pending[to] = False
                _OBS_LOCK_TIMEOUTS.inc(int(to.size))
        for j in np.nonzero(pending)[0]:
            self.tree.insert(int(keys[j]), int(values[j]))
            stats["host_path"] += 1
            applied_rows[j] = True
        return applied_rows

    def _recover_wedged_locks(self, keys: np.ndarray) -> np.ndarray:
        """For keys blocked on held page locks: find each key's leaf with
        one device descent, read the leaves' lock words in one step, and
        revoke every holder whose lease is dead (``Tree._try_revoke_lease``
        decides).  -> live_mask [bool, aligned with keys]: True where a
        LIVE lease holds the lock (never revoked here)."""
        tree = self.tree
        keys = np.asarray(keys, np.uint64)
        addrs, done = self._descend_to_level(keys, 0)
        la_by_key = np.array(
            [tree._lock_word_addr(int(a)) if d else -1
             for a, d in zip(addrs, done)], np.int64)
        las = sorted({int(la) for la in la_by_key if la != -1})
        if not las:
            return np.zeros(keys.shape[0], bool)
        rep = self.dsm._batch(
            [{"op": D.OP_READ_WORD, "addr": la, "woff": 0,
              "space": D.SPACE_LOCK} for la in las])
        live_las = {la for la, w in zip(las, rep.old)
                    if int(w) != 0
                    and not tree._try_revoke_lease(la, int(w))}
        return np.array([int(la) in live_las for la in la_by_key])

    # -- delete --------------------------------------------------------------

    def _get_delete(self, iters: int, with_start: bool):
        """The delete step ``fn(pool, locks, counters, dirty, khi, klo,
        root, active[, start]) -> status``, one callable per variant."""
        key = (iters, with_start)
        fn = self._delete_cache.get(key)
        if fn is None:
            cfg = self.cfg

            def fn(pool, locks, counters, dirty, khi, klo, root, active,
                   *rest):
                start = rest[0] if with_start else None
                return delete_step_spmd(
                    pool, locks, counters, khi, klo, root, active, start,
                    cfg=cfg, iters=iters, dirty=dirty)

            fn = DEV.wrap_program("engine.delete", fn)
            self._delete_cache[key] = fn
        return fn

    def delete(self, keys, max_rounds: int | None = None) -> np.ndarray:
        """Batched delete (``Tree::del``).  -> found bool [n]: True where
        the key existed and was removed."""
        self._require_writable()
        t_slo = time.perf_counter()
        if max_rounds is None:
            max_rounds = self.tcfg.insert_rounds
        keys = np.asarray(keys, np.uint64)
        self._check_range(keys)
        self._check_replicated(keys)
        n = keys.shape[0]
        out = np.zeros(n, bool)
        for i in range(0, n, self.total):
            out[i:i + self.total] = self._delete_chunk(
                keys[i:i + self.total], max_rounds)
        # journal the deletes that cleared a slot (not-found rows are
        # no-ops, left out so the record set is the applied set)
        self._journal_applied(J.J_DELETE, keys[out])
        if self.leaf_cache is not None and n:
            self.leaf_cache.invalidate_keys(keys)
        _slo_observe("delete", n, t_slo)
        return out

    def _delete_chunk(self, keys, max_rounds) -> np.ndarray:
        """Device rounds, the router seeding round 0 only: ST_APPLIED and
        ST_NOT_FOUND rows are done, ST_LOCKED and ST_RETRY rows retry
        from the root, ST_BAD rows and the rows left after the last round
        go through the host ``Tree.delete``."""
        n = keys.shape[0]
        found_out = np.zeros(n, bool)
        pending = np.ones(n, bool)
        for round_i in range(max_rounds):
            if not pending.any():
                return found_out
            idx = np.nonzero(pending)[0]
            khi, klo = bits.keys_to_pairs(keys[idx])
            khi, klo = self._pad(khi), self._pad(klo)
            active = self._pad(np.ones(idx.shape[0], bool))
            use_router = self.router is not None and round_i == 0
            fn = self._get_delete(self._iters(), use_router)
            args = [self._shard(khi), self._shard(klo),
                    self.tree._root_addr, self._shard(active)]
            if use_router:
                args.append(self._shard(self.router.host_start(khi, klo)))
            with obs.span("engine.delete.descend_lock_apply",
                          n=int(idx.shape[0])):
                with self._step_mutex:
                    status = fn(self.dsm.pool, self.dsm.locks,
                                self.dsm.counters, self.dsm.dirty, *args)
                status = self._unshard(status)[:idx.shape[0]]
            found_out[idx[status == ST_APPLIED]] = True
            done = (status == ST_APPLIED) | (status == ST_NOT_FOUND)
            pending[idx[done]] = False
            bad = status == ST_BAD
            for j in idx[bad]:
                found_out[j] = self.tree.delete(int(keys[j]))
                pending[j] = False
            if bad.any():
                self.tree._refresh_root()
        for j in np.nonzero(pending)[0]:
            found_out[j] = self.tree.delete(int(keys[j]))
        return found_out

    # -- range scans ---------------------------------------------------------

    def range_query(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """All (k, v) with lo <= k < hi, sorted by key.  See
        :meth:`range_query_many`."""
        return self.range_query_many([(lo, hi)])[0]

    def range_query_many(self, ranges) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched scans (``Tree.cpp:461-522``): one page gather prefetches
        the router's candidate leaves of every range, then each range
        walks its B-link chain over the shared prefetch.  ranges: iterable
        of (lo, hi); -> [(keys uint64, vals uint64)] per range, each
        sorted by key."""
        ranges = [(int(lo), int(hi)) for lo, hi in ranges]
        t_slo = time.perf_counter()
        out = range_query_many(self, ranges)
        # one op per range: the SLO unit is the client request
        _slo_observe("scan", len(ranges), t_slo)
        return out

    # -- empty-leaf reclaim --------------------------------------------------

    def reclaim_empty_leaves(self, quarantine_rounds: int = 2) -> dict:
        """Unlink empty leaves from the B-link chain and recycle their
        pages (beyond the reference, whose ``free()`` is a no-op,
        ``DSM.h:226``: a delete or churn workload leaks its pool dry
        there).  Protocol, per (left, empty) adjacent leaf pair:

        1. one scan of the pool (:func:`validate.leaf_chain_info`) finds
           the candidates: an active leaf with no live slot whose chain
           predecessor exists (the leftmost leaf is never reclaimed);
        2. one host step CAS-locks every pair's lock word(s) and reads
           both pages; under the locks each pair is verified again
           (left.sibling == empty, still empty, the fences abut), then one
           step rewrites the left page's header (``highest`` and
           ``sibling`` bypass the empty leaf, versions bumped) and RETIRES
           the empty leaf (``highest := 0`` refuses every fence check,
           ``sibling := left`` sends a stale reader back to the absorber),
           with every unlock;
        3. the retired leaf's parent entry is removed (lock and rebuild,
           as ``flush_parents`` merges); a retired page that is its
           parent's leftmost child is PARKED (retired for good, never
           freed); failures stay pending for the next call, and retired
           strays the scan finds re-enter this step;
        4. a cleaned page returns to its node's allocator free pool after
           ``quarantine_rounds`` more calls, the grace period for host
           clients holding pre-unlink addresses.

        -> {"unlinked", "freed", "candidates", "quarantined", "parked"}."""
        self._require_writable()    # reclaim rewrites pages
        if not self._reclaim_mutex.acquire(blocking=False):
            raise StateError(
                "reclaim_empty_leaves is not reentrant: another reclaim "
                "pass is already running on this engine")
        try:
            return self._reclaim_empty_leaves_locked(quarantine_rounds)
        finally:
            self._reclaim_mutex.release()

    def _reclaim_empty_leaves_locked(self, quarantine_rounds: int) -> dict:
        tree, dsm = self.tree, self.dsm
        # drain the deferred parent entries first: a leaf still owed its
        # parent entry looks unreferenced, and the flush would later point
        # an entry at a freed (reused) page
        if self._pending_parents:
            self.flush_parents()
        st = self._reclaim_state
        st["round"] += 1
        stats = {"unlinked": 0, "freed": 0, "candidates": 0,
                 "quarantined": len(st["quarantine"]),
                 "parked": len(st["parked"])}

        # pages already released (free pools, cached grants), taken BEFORE
        # the scan: a released page still looks retired until it is
        # rewritten, and sweeping it would free it twice
        released = set()
        for nd, d in tree.ctx.alloc._by_node.items():
            for pg in d.allocator.free_pages_list:
                released.add((nd << C.ADDR_PAGE_BITS) | pg)
        for lst in self._fresh_cache.values():
            for a in lst:
                released.add(int(a) & _U32)
        with self._step_mutex:
            (addrs, lows, highs, sibs, n_live,
             retired_addrs, retired_lows) = validate.leaf_chain_info(tree)
        tree._refresh_root()
        quarantined = {a for _, a in st["quarantine"]}
        # retired strays (unlinked by an earlier incarnation whose
        # in-flight state is gone) re-enter the parent cleanup
        known = (quarantined | st["parked"] | released
                 | {e for e, _, _ in st["pending_parent"]})
        for ra, rl in zip(retired_addrs.tolist(), retired_lows.tolist()):
            if ra not in known:
                st["pending_parent"].append((int(ra), int(rl), 0))
        # adjacent pairs with chain continuity, greedy-alternate so that a
        # pair's left member is not itself unlinked this round; pages owed
        # a deferred parent entry and the root are excluded
        pend_children = {int(t[1]) & _U32 for t in self._pending_parents}
        pairs = []
        taken = set()
        for i in range(1, addrs.size):
            L, E = int(addrs[i - 1]), int(addrs[i])
            if (n_live[i] == 0 and sibs[i - 1] == E and E not in taken
                    and L not in taken and E not in quarantined
                    and (E & _U32) not in pend_children
                    and E != tree._root_addr):
                pairs.append((L, E, int(lows[i]), int(highs[i])))
                taken.add(E)
                taken.add(L)
        stats["candidates"] = len(pairs)

        # two host steps for all pairs: lock + read, then every verified
        # unlink with every unlock; a pair sharing a lock word with an
        # earlier pair waits for the next call
        seen_words: set = set()
        plan = []
        for L, E, e_low, e_high in pairs:
            la, ea = tree._lock_word_addr(L), tree._lock_word_addr(E)
            words = (la,) if la == ea else (la, ea)
            if any(w in seen_words for w in words):
                continue
            seen_words.update(words)
            plan.append((L, E, e_low, e_high, words))
        rows = []
        base = {}
        for L, E, e_low, e_high, words in plan:
            base[E] = len(rows)
            for w in words:
                rows.append({"op": D.OP_CAS, "addr": w, "woff": 0,
                             "arg0": 0, "arg1": tree.ctx.lease,
                             "space": D.SPACE_LOCK})
            rows.append({"op": D.OP_READ, "addr": L})
            rows.append({"op": D.OP_READ, "addr": E})
        rep = dsm._batch(rows) if rows else None
        w1 = lambda a, w, v: {"op": D.OP_WRITE, "addr": a, "woff": w,
                              "nw": 1, "payload": np.array([v], np.int32)}
        out_rows = []
        mapping: dict[int, int] = {}
        for L, E, e_low, e_high, words in plan:
            i0 = base[E]
            got = [bool(rep.ok[i0 + j]) for j in range(len(words))]
            held = [w for w, g in zip(words, got) if g]
            if not all(got):
                out_rows += [tree._unlock_row(w) for w in held]
                continue
            lpg = np.array(rep.data[i0 + len(words)])
            epg = np.array(rep.data[i0 + len(words) + 1])
            ok = (int(lpg[C.W_SIBLING]) & _U32) == (E & _U32) \
                and layout.np_highest(lpg) == e_low \
                and layout.np_lowest(epg) == e_low \
                and layout.np_highest(epg) == e_high \
                and not layout.np_leaf_entries(epg)
            if not ok:
                out_rows += [tree._unlock_row(w) for w in held]
                continue
            ver = ((int(lpg[C.W_FRONT_VER]) + 1) & 0x7FFFFFFF) or 1
            hh, hl = bits.key_to_pair(e_high)
            out_rows += [
                # the left page absorbs the range: highest and sibling
                # bypass E
                w1(L, C.W_HIGH_HI, hh), w1(L, C.W_HIGH_LO, hl),
                w1(L, C.W_SIBLING, int(epg[C.W_SIBLING])),
                w1(L, C.W_FRONT_VER, ver), w1(L, C.W_REAR_VER, ver),
                # E retires: highest 0 refuses every fence check, and the
                # sibling (L's uint32 value as an int32 word) points back
                w1(E, C.W_HIGH_HI, 0), w1(E, C.W_HIGH_LO, 0),
                w1(E, C.W_SIBLING, np.int32(np.uint32(L & _U32)
                                            .view(np.int32))),
            ] + [tree._unlock_row(w) for w in held]
            st["pending_parent"].append((E, e_low, L))
            mapping[E] = L
            stats["unlinked"] += 1
        if out_rows:
            dsm._batch(out_rows)
        if mapping and self.router is not None:
            self.router.remap_addrs(mapping)
        if mapping and self.leaf_cache is not None:
            # drop every cached entry on either side of each unlinked
            # pair: the absorber's header changed, and a later reuse of
            # the retired page must never meet a stale cached position
            self.leaf_cache.invalidate_pages(
                list(mapping.keys()) + list(mapping.values()))

        # parent-entry removal; only cleaned pages go into quarantine
        if st["pending_parent"]:
            st["pending_parent"] = self._remove_parent_entries(
                st["pending_parent"], st)

        # release the pages past their grace rounds
        ready = [(r, a) for r, a in st["quarantine"]
                 if st["round"] - r >= quarantine_rounds]
        st["quarantine"] = [(r, a) for r, a in st["quarantine"]
                            if st["round"] - r < quarantine_rounds]
        by_node: dict[int, list[int]] = {}
        for _, a in ready:
            by_node.setdefault(bits.addr_node(a), []).append(
                bits.addr_page(a))
        for nd, pgs in by_node.items():
            d = tree.ctx.alloc._by_node.get(nd)
            if d is None:
                # no local directory for the node: keep them quarantined
                st["quarantine"].extend((st["round"], bits.make_addr(nd, p))
                                        for p in pgs)
                continue
            d.allocator.reclaim(pgs)
            stats["freed"] += len(pgs)
        stats["quarantined"] = len(st["quarantine"])
        stats["parked"] = len(st["parked"])
        return stats

    def _remove_parent_entries(self, pend, st) -> list:
        """Remove retired pages' parent entries: a descent to level 1 by
        each page's old low fence, one host step that locks and reads
        every parent, and one that writes every rebuilt parent with the
        unlocks.  Cleaned pages enter quarantine, a parent's leftmost
        child is parked; -> the items that stay pending."""
        tree, dsm = self.tree, self.dsm
        tree._refresh_root()
        if tree._root_level < 1:
            # the root is a leaf: no parent exists
            for e, _k, _l in pend:
                st["quarantine"].append((st["round"], e))
            return []
        keysu = np.array([k for _, k, _ in pend], np.uint64)
        paddrs, done = self._descend_to_level(keysu, 1)
        group: dict[int, list[tuple[int, int, int]]] = {}
        nxt: list = []
        for (e, k, ab), a, d_ok in zip(pend, paddrs, done):
            if d_ok:
                group.setdefault(int(a), []).append((e, k, ab))
            else:
                nxt.append((e, k, ab))
        # a parent sharing a lock word with an earlier one waits
        seen_words: set = set()
        plan = []
        for pa, items in group.items():
            la = tree._lock_word_addr(pa)
            if la in seen_words:
                nxt.extend(items)
                continue
            seen_words.add(la)
            plan.append((pa, la, items))
        rows = []
        for pa, la, _items in plan:
            rows.append({"op": D.OP_CAS, "addr": la, "woff": 0, "arg0": 0,
                         "arg1": tree.ctx.lease, "space": D.SPACE_LOCK})
            rows.append({"op": D.OP_READ, "addr": pa})
        rep = dsm._batch(rows) if rows else None
        out_rows = []
        decisions = []
        for i, (pa, la, items) in enumerate(plan):
            if not bool(rep.ok[2 * i]):
                nxt.extend(items)
                continue
            pg = np.array(rep.data[2 * i + 1])
            if int(pg[C.W_LEVEL]) != 1:
                out_rows.append(tree._unlock_row(la))
                nxt.extend(items)
                continue
            # fence re-check under the lock: a split of this parent since
            # the descent moved the entries at or past its split key to
            # the right sibling, so this page cannot say they are gone
            lo, hi = layout.np_lowest(pg), layout.np_highest(pg)
            covered = [t for t in items if lo <= t[1] < hi]
            nxt.extend(t for t in items if not (lo <= t[1] < hi))
            if not covered:
                out_rows.append(tree._unlock_row(la))
                continue
            items = covered
            drop = {e & _U32 for e, _, _ in items}
            ents = [(k, c) for k, c in layout.np_internal_entries(pg)
                    if (c & _U32) not in drop]
            kept = {c & _U32 for _, c in ents}
            newpg = layout.np_internal_rebuild(pg, ents, 1)
            lm = int(pg[C.W_LEFTMOST]) & _U32
            out_rows.append({"op": D.OP_WRITE, "addr": pa, "woff": 0,
                             "nw": C.PAGE_WORDS, "payload": newpg})
            out_rows.append(tree._unlock_row(la))
            decisions.append((items, kept, lm))
        # decide only after the write step landed: a failed step leaves
        # every item pending, never a page whose entry survived quarantined
        if out_rows:
            dsm._batch(out_rows)
        for items, kept, lm in decisions:
            for e, k, ab in items:
                eu = e & _U32
                if eu == lm:
                    # the leftmost pointer cannot be dropped, and pointing
                    # it at the absorber would dangle once that is reused
                    st["parked"].add(e)
                elif eu in kept:            # the entry is elsewhere: retry
                    nxt.append((e, k, ab))
                else:
                    st["quarantine"].append((st["round"], e))
        return nxt


# ---------------------------------------------------------------------------
# Range scans: a router-seeded batched leaf prefetch (Tree.cpp:461-522).
# ---------------------------------------------------------------------------

def _addr_rows(addrs: np.ndarray, pages_per_node: int) -> np.ndarray:
    """Packed addrs -> global rows of the node-major pool (host).  The
    int32 addr goes through uint32 first, so nodes whose addrs carry the
    sign bit still map to non-negative rows."""
    a = np.asarray(addrs).astype(np.uint32).astype(np.uint64)
    return ((a >> C.ADDR_PAGE_BITS) * np.uint64(pages_per_node)
            + (a & np.uint64(C.ADDR_PAGE_MASK))).astype(np.int64)


def _scan_candidates(router, ranges) -> np.ndarray:
    """The router entries of every bucket each range overlaps, unioned
    (sorted int32 addrs).  Both bucket ends are clamped into the table:
    a range past the keyspace the router was seeded on starts from the
    last bucket's entry instead of skipping the prefetch."""
    parts = []
    with router._read_locked():
        for lo, hi in ranges:
            b_lo = min(router.nb - 1, lo >> router.shift)
            b_hi = min(router.nb - 1, max(0, (hi - 1) >> router.shift))
            parts.append(router.table_np[b_lo:b_hi + 1])
    return np.unique(np.concatenate(parts))


def _scan_prefetch(eng, cand: np.ndarray) -> np.ndarray:
    """One ``gather_pages`` launch of the candidate pages, copied to the
    host at once.  -> [len(cand), PAGE_WORDS] int32.  Across processes
    each rank gathers the rows of its own node block (the one-process
    gather's clip taken over the whole pool) and one all-gather joins
    them on every rank: like the one-process gather, and unlike the
    reference's replicated host reads, it counts no read."""
    rows = _addr_rows(cand, eng.cfg.pages_per_node)
    if not eng._mh:
        with eng._step_mutex:
            got = PK.gather_pages(eng.dsm.pool,
                                  eng._dev(rows.astype(np.int32)))
        return got.cpu().numpy()
    from sherman_tpu_torch.parallel import bootstrap
    P, mesh = eng.cfg.pages_per_node, eng._mesh
    rows = np.clip(rows, 0, eng.cfg.machine_nr * P - 1) - mesh.lo * P
    own = (rows >= 0) & (rows < mesh.n_local * P)
    buf = np.zeros((cand.size, C.PAGE_WORDS), np.int32)
    if own.any():
        with eng._step_mutex:
            got = PK.gather_pages(eng.dsm.pool,
                                  eng._dev(rows[own].astype(np.int32)))
        buf[own] = got.cpu().numpy()
    # every row has one owner, so the sum over the ranks is that row
    return bootstrap.process_allgather(buf).sum(axis=0, dtype=np.int32)


def range_query_many(eng: "BatchedEngine", ranges
                     ) -> list[tuple[np.ndarray, np.ndarray]]:
    """All (k, v) with lo <= k < hi per range, each sorted by key.

    The router yields every range's candidate leaves; one device gather
    fetches their union; each range then finds its start leaf by binary
    search over the prefetch's ``lowest`` fences and walks the sibling
    chain, reading a page through the DSM only where the prefetch misses
    it (a stale router entry or a split since).  A start not in the
    prefetch comes from the pages earlier walks read, else from a host
    descent.  Stale entries may name internal pages (kept out by their
    level) or retired ones (``highest == 0``, which no start test
    picks)."""
    tree = eng.tree
    cfg = eng.cfg
    ranges = [(int(lo), int(hi)) for lo, hi in ranges]
    for lo, hi in ranges:
        if not (C.KEY_MIN <= lo and hi <= C.KEY_POS_INF and lo < hi):
            raise PreconditionError(f"malformed range [{lo}, {hi}): want "
                                    f"KEY_MIN <= lo < hi <= KEY_POS_INF")
    # replication guard: the chain walks issue a data-dependent number of
    # collective host reads, so divergent bounds would desync them.  The
    # bounds are checked first, so a range past KEY_POS_INF raises the
    # AssertionError above at any process count (the reference's engine
    # method builds this digest array first: OverflowError)
    eng._check_replicated(
        np.asarray([b for r in ranges for b in r], np.uint64))

    # pages by addr & 0xFFFFFFFF: the prefetch's leaves, then every page
    # the walks read
    fetched: dict[int, np.ndarray] = {}
    f_addrs = np.zeros(0, np.int64)
    f_lows = f_highs = np.zeros(0, np.uint64)
    if eng.router is not None and ranges:
        cand = _scan_candidates(eng.router, ranges)
        if cand.size:
            pages = _scan_prefetch(eng, cand)
            leaf = pages[:, C.W_LEVEL] == 0
            pages = pages[leaf]
            f_addrs = cand[leaf].astype(np.uint32).astype(np.int64)
            fetched = dict(zip(f_addrs.tolist(), pages))
            f_lows = bits.pairs_to_keys(pages[:, C.W_LOW_HI],
                                        pages[:, C.W_LOW_LO])
            f_highs = bits.pairs_to_keys(pages[:, C.W_HIGH_HI],
                                         pages[:, C.W_HIGH_LO])
            order = np.argsort(f_lows)
            f_addrs, f_lows, f_highs = (f_addrs[order], f_lows[order],
                                        f_highs[order])
    # pages the walks read (prefetch misses), in the order they were read:
    # a later range that starts inside one skips the host descent
    extras: dict[int, np.ndarray] = {}

    def get_page(addr: int) -> np.ndarray:
        p = fetched.get(addr & _U32)
        if p is None:
            p = tree.dsm.read_page(addr)
            fetched[addr & _U32] = p
            extras[addr & _U32] = p
        return p

    out: list[tuple[np.ndarray, np.ndarray]] = []
    for lo, hi in ranges:
        start = None
        i = int(np.searchsorted(f_lows, np.uint64(lo), side="right")) - 1
        if i >= 0 and lo < int(f_highs[i]):
            start = int(f_addrs[i])
        if start is None:
            for a, p in extras.items():
                if layout.np_lowest(p) <= lo < layout.np_highest(p):
                    start = a
                    break
        if start is None:
            start, _, _ = tree._descend(lo, 0)

        addr, chain, hops = start, [], 0
        while True:
            pg = get_page(addr)
            chain.append(pg)
            if layout.np_highest(pg) >= hi:
                break
            sib = int(pg[C.W_SIBLING])
            if bits.addr_is_null(sib):
                break
            addr = sib
            hops += 1
            if hops >= cfg.machine_nr * cfg.pages_per_node:
                raise InvariantError("chain runaway")
        keys, vals, live = layout.np_leaf_entries_batch(np.stack(chain))
        m = live & (keys >= np.uint64(lo)) & (keys < np.uint64(hi))
        out_k, out_v = keys[m], vals[m]
        order = np.argsort(out_k)
        out.append((out_k[order], out_v[order]))
    return out


# ---------------------------------------------------------------------------
# Bulk load: bottom-up tree construction.
# ---------------------------------------------------------------------------


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
    the pages) in numpy on the host.  Returns stats.  Across processes
    every rank calls it with the same keys (the mirrored allocators hand
    out the same pages everywhere) and builds and installs only the pages
    of its own node block."""
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
    row0, row1 = dsm.local_row_range()
    if dsm.multihost:
        # this rank's leaves only, their rows in its block
        mine = (leaf_rows >= row0) & (leaf_rows < row1)
        sel = T(mine)
        blk = lambda x: x.view(n_leaves, per_leaf)[sel].reshape(-1)
        khi, klo, vhi, vlo, live = (blk(x) for x in (khi, klo, vhi, vlo,
                                                     live))
        lhi, llo, hhi, hlo, sib = (x[mine] for x in (lhi, llo, hhi, hlo,
                                                     sib))
        rows_t = T(leaf_rows[mine] - row0)
    else:
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
        pages = np.concatenate(all_pages)
        if dsm.multihost:
            mine = (rows >= row0) & (rows < row1)
            _install_pages(dsm.pool, T(rows[mine] - row0), T(pages[mine]))
        else:
            _install_pages(dsm.pool, T(rows), T(pages))
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
