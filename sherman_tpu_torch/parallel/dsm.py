"""DSM — the one-sided remote-memory runtime on one card (counterpart of
``sherman_tpu/parallel/dsm.py``).

The ``machine_nr`` nodes of a cluster share the card.  Their state is the
reference's global arrays, node-major: a ``[N*P, 256]`` int32 pool beside
a ``[N*L]`` lock-word table, ``[N*N_COUNTERS]`` op counters (int64 holding
uint32 values, counted mod 2^32 as the reference's uint32 counters are)
and a ``[N*P]`` dirty-page mask; node ``n`` owns block ``n`` of each.  One
host *step* applies a batch of requests with the reference's semantics:
reads snapshot the pre-step pool, and the apply order within a step is
READ < CAS < FAA < WRITE_WORD < WRITE, with at most one CAS winner per
word per step (the lowest request index of the owner's incoming buffer
whose expected value matches) and serial prefix values for same-word
FAAs.  With more than one node, requests are bucket-routed to their owner
and the replies routed back (:mod:`sherman_tpu_torch.parallel.transport`),
as ``shard_map`` does on each device of the reference's mesh.

When the nodes span several processes ("ranks",
:mod:`sherman_tpu_torch.parallel.mesh`), a rank's DSM holds only its own
contiguous block of ``L`` nodes (``local_nodes``) of each tensor, while
addresses and pool rows stay global, so a handle is valid on every rank.
A host step is then a COLLECTIVE: every rank calls it with its own
nodes' ``[L*R]`` requests, the buckets cross ranks through the
transport, and each rank receives its own replies.  :class:`ReplicatedDSM`
is the replicated-driver host API over such a DSM: the leader posts the
rows, the other ranks post empty steps, and the replies are broadcast.

Where the reference mutates a functional array, this module updates the
pool tensors in place (the step mutex serializes host steps).  An owner's
apply is planned on the host, in numpy, from the step's requests and one
gather of the step-start words they touch; the card gathers and scatters
(a host step of a few rows is then a dozen small launches, not hundreds).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from sherman_tpu_torch import config as CFG
from sherman_tpu_torch import obs
from sherman_tpu_torch.config import DSMConfig, PAGE_WORDS
from sherman_tpu_torch.errors import (ConfigError,
                                      MultiprocessUnsupportedError,
                                      ProtocolError)
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import mesh as MESH
from sherman_tpu_torch.parallel import transport as T
from sherman_tpu_torch.utils import sorted_unique

# Request opcodes.
OP_NOP = 0
OP_READ = 1
OP_WRITE = 2
OP_WRITE_WORD = 3
OP_CAS = 4
OP_FAA = 5
OP_READ_WORD = 6
OP_MASKED_CAS = 7
OP_MASKED_FAA = 8

SPACE_POOL = 0
SPACE_LOCK = 1

REQ_FIELDS = ("op", "addr", "woff", "nw", "space", "arg0", "arg1",
              "arg2")

# Counter slots.
CNT_READ_OPS = 0
CNT_READ_PAGES = 1
CNT_WRITE_OPS = 2
CNT_WRITE_WORDS = 3
CNT_CAS_OPS = 4
CNT_FAA_OPS = 5
CNT_WW_OPS = 6
CNT_COMBINE_GROUPS = 7
CNT_COMBINE_SAVED = 8
N_COUNTERS = 10

# Host-side step counter: the device op counts surface through the
# registry's ``dsm`` pull collector; this one counts host-API step
# launches, the control plane's round-trip rate.
_OBS_HOST_STEPS = obs.counter("dsm.host_steps")

_U32 = 0xFFFFFFFF


def count(counters: torch.Tensor, slot: int, n) -> None:
    """``counters[slot] += n`` mod 2^32, in place and without a host sync
    (``n`` may be a device scalar)."""
    counters[slot] = (counters[slot] + n) & _U32


def count_nodes(counters: torch.Tensor, slot: int, n) -> None:
    """Every node's ``counters[slot] += n[node]`` mod 2^32 over the
    node-major ``[N*N_COUNTERS]`` counters; ``n`` is ``[N]``."""
    c = counters.view(-1, N_COUNTERS)
    c[:, slot] = (c[:, slot] + n) & _U32


def shards(cfg: DSMConfig, d: int, pool, locks, counters):
    """Node ``d``'s blocks of the cluster state: views that write
    through to the node-major tensors."""
    P, L = cfg.pages_per_node, cfg.locks_per_node
    return (pool[d * P:(d + 1) * P], locks[d * L:(d + 1) * L],
            counters[d * N_COUNTERS:(d + 1) * N_COUNTERS])


def empty_requests(n: int) -> dict[str, np.ndarray]:
    """Host-side all-NOP request batch of n slots."""
    reqs = {f: np.zeros(n, np.int32) for f in REQ_FIELDS}
    reqs["payload"] = np.zeros((n, PAGE_WORDS), np.int32)
    return reqs


# ---------------------------------------------------------------------------
# Owner-side apply.
# ---------------------------------------------------------------------------

# the counter slots a step's apply moves, in :func:`_apply`'s order
_STEP_COUNTERS = np.array([CNT_READ_OPS, CNT_READ_PAGES, CNT_WRITE_OPS,
                           CNT_WRITE_WORDS, CNT_CAS_OPS, CNT_FAA_OPS,
                           CNT_WW_OPS], np.int64)


def _word_plan(pre, widx, m_cas, m_faa, m_ww, m_rw, m_mcas, m_mfaa,
               arg0, arg1, arg2):
    """Linearized word ops of one space, planned on the host.

    ``pre[i]`` is the step-start value of row ``i``'s word (of word 0 for
    a row with no word op).  -> (old[M], ok[M], words, vals): ``old`` is
    the pre-step value for CAS/READ_WORD/masked ops and the serial
    pre-value for FAA; ``ok`` is the winner flag for CAS-like ops (True
    for everything else); the step stores ``flat[words] = vals``.  Masked
    CAS compares and swaps only the ``arg2`` bits; masked FAA adds
    ``arg0`` inside the ``arg2`` field and, like a CAS, lands at most once
    per word per step.
    """
    M = widx.shape[0]
    any_word = m_cas | m_faa | m_ww | m_rw | m_mcas | m_mfaa
    # one slot per distinct word, holding its value as the ops land
    words, inv = np.unique(widx[any_word], return_inverse=True)
    pos = np.zeros(M, np.int64)
    pos[any_word] = inv
    val = np.zeros(words.shape[0], np.int32)
    val[inv] = pre[any_word]
    start = val.copy()
    cur = pre

    # CAS-like: per word, the lowest-index request whose expected value
    # matches the step-start value wins.
    m_caslike = m_cas | m_mcas | m_mfaa
    exp_eff = np.where(m_mcas, (cur & ~arg2) | (arg0 & arg2),
                       np.where(m_mfaa, cur, arg0))
    des_eff = np.where(
        m_mcas, (cur & ~arg2) | (arg1 & arg2),
        np.where(m_mfaa, (cur & ~arg2) | (((cur & arg2) + arg0) & arg2),
                 arg1))
    winner = np.zeros(M, bool)
    e_idx = np.flatnonzero(m_caslike & (cur == exp_eff))
    if e_idx.size:
        _, first = np.unique(pos[e_idx], return_index=True)
        winner[e_idx[first]] = True
        val[pos[winner]] = des_eff[winner]

    # FAA: every request lands; each sees the serial prefix value of the
    # post-CAS word.
    old = cur.copy()
    f_idx = np.flatnonzero(m_faa)
    if f_idx.size:
        rows = f_idx[np.argsort(pos[f_idx], kind="stable")]
        p = pos[rows]
        d = arg0[rows].astype(np.int64)
        excl = np.cumsum(d) - d
        head = np.ones(rows.shape[0], bool)
        head[1:] = p[1:] != p[:-1]
        seg_base = excl[head][np.cumsum(head) - 1]
        old[rows] = (val[p] + excl - seg_base).astype(np.int32)
        tot = np.zeros(words.shape[0], np.int64)
        np.add.at(tot, p, d)
        val = (val + tot).astype(np.int32)

    # WRITE_WORD: plain store, wins over same-step CAS/FAA results (the
    # last of a word's stores stands).
    ww = np.flatnonzero(m_ww)
    val[pos[ww]] = arg1[ww]

    ok = np.where(m_caslike, winner, True)
    moved = val != start
    return old, ok, words[moved], val[moved]


def _apply(pool, locks, counters, req):
    """Apply one node's requests ``req`` (dict of host ``[M]`` int32
    arrays + ``payload [M, 256]``) to its pool, lock table and counters
    in place.  The masks, winners and values are planned on the host from
    the requests and the step-start words they touch; the card gathers
    those words and the read pages and scatters the stores.
    -> (read rows [k] (host), their pre-step pages [k, 256] (device),
    old [M] (host), ok [M] (host))."""
    P, PW = pool.shape
    L = locks.shape[0]
    dev = pool.device
    op, space = req["op"], req["space"]
    page = req["addr"] & CFG.ADDR_PAGE_MASK
    woff, nw = req["woff"], req["nw"]
    m_pool = space == SPACE_POOL
    m_lock = space == SPACE_LOCK

    page_ok = np.where(m_lock, page < L, page < P) & (page >= 0)
    word_ok = m_lock | ((woff >= 0) & (woff < PW))
    write_ok = (woff >= 0) & (nw >= 0) & (woff + nw <= PW)
    wordspace = m_pool | m_lock

    is_read = (op == OP_READ) & m_pool & page_ok
    wok = wordspace & page_ok & word_ok
    m_cas = (op == OP_CAS) & wok
    m_faa = (op == OP_FAA) & wok
    m_ww = (op == OP_WRITE_WORD) & wok
    m_rw = (op == OP_READ_WORD) & wok
    m_mcas = (op == OP_MASKED_CAS) & wok
    m_mfaa = (op == OP_MASKED_FAA) & wok
    is_write = (op == OP_WRITE) & m_pool & page_ok & write_ok
    any_word = m_cas | m_faa | m_ww | m_rw | m_mcas | m_mfaa
    widx_pool = page.astype(np.int64) * PW + woff
    widx_lock = page.astype(np.int64)

    # READ: snapshot of whole pages before any mutation.
    rd = np.flatnonzero(is_read)
    data = pool[torch.as_tensor(page[rd], device=dev).long()] \
        if rd.size else None

    # each space's words: the step-start value of every active row's word
    # (of word 0 for a row with no word op: what its reply's ``old``
    # carries), then the planned stores
    M = op.shape[0]
    active = op != OP_NOP
    flatpool = pool.view(-1)
    old = np.zeros(M, np.int32)
    ok = np.ones(M, bool)
    for flat, widx, m_sp, mine in ((flatpool, widx_pool, m_pool, ~m_lock),
                                   (locks, widx_lock, m_lock, m_lock)):
        rows = np.flatnonzero(active & mine)
        if not rows.size:
            continue
        pre = np.zeros(M, np.int32)
        g = np.where(any_word[rows], widx[rows], 0)
        # the host plan reads its step-start words: one sync a space a
        # step.  DSM host steps (host verbs, locks, the migrator) are not
        # the serve's steps: ROADMAP's held item on the serve's host syncs
        # does not target it.
        # shermanlint: disable=SL001 reads the step-start words it plans
        pre[rows] = flat[torch.as_tensor(g, device=dev)].cpu().numpy()
        o, k, words, vals = _word_plan(
            pre, widx, m_cas & m_sp, m_faa & m_sp, m_ww & m_sp,
            m_rw & m_sp, m_mcas & m_sp, m_mfaa & m_sp,
            req["arg0"], req["arg1"], req["arg2"])
        if words.size:
            flat[torch.as_tensor(words, device=dev)] = torch.as_tensor(
                vals, device=dev)
        old[mine] = o[mine]
        ok[mine] = k[mine]

    # Page WRITE: word-masked scatter of the payload.
    w_rows = np.flatnonzero(is_write)
    if w_rows.size:
        cols = np.arange(PW)
        wmask = cols[None, :] < nw[w_rows][:, None]
        idx = (widx_pool[w_rows][:, None] + cols[None, :])[wmask]
        flatpool[torch.as_tensor(idx, device=dev)] = torch.as_tensor(
            np.ascontiguousarray(req["payload"][w_rows][wmask]), device=dev)

    handled = is_read | is_write | any_word
    ok &= handled

    # shermanlint: disable=SL001 host numpy: counts of the planned masks
    n = lambda m: int(np.count_nonzero(m))
    # shermanlint: disable=SL001 host numpy: the words the page writes store
    n_words = int(nw[is_write].astype(np.int64).sum()) & _U32
    # shermanlint: disable=SL001 host numpy: the step's counter deltas
    delta = np.array([n(is_read), n(is_read), n(is_write), n_words,
                      n(m_cas | m_mcas), n(m_faa | m_mfaa), n(m_ww)],
                     np.int64)
    hit = np.flatnonzero(delta)
    if hit.size:
        s = torch.as_tensor(_STEP_COUNTERS[hit], device=dev)
        counters[s] = (counters[s] + torch.as_tensor(delta[hit],
                                                     device=dev)) & _U32
    return rd, data, old, ok


def dsm_step_spmd(pool, locks, counters, reqs, *, cfg: DSMConfig):
    """One DSM step of every node (``machine_nr > 1``): each node's
    requests are bucketized by owner, exchanged, applied by the owner on
    its own shard (:func:`_apply`, planned on the host), and the replies
    exchanged back.

    reqs: dict of global host ``[N*R]`` int32 arrays (+ payload
    ``[N*R, 256]``), node ``n``'s requests in rows ``n*R:(n+1)*R``.
    Updates the state in place; returns host {"data": [N*R, 256], "old":
    [N*R], "ok": [N*R]}.  When the nodes span ranks, every rank calls it
    with its own ``L`` nodes' ``[L*R]`` requests and state blocks and gets
    its own replies."""
    N, C = cfg.machine_nr, cfg.step_capacity
    M = MESH.of(cfg)
    L = M.n_local
    dev = pool.device
    F = len(REQ_FIELDS)
    # a request is one row, its fields then its payload: one copy to the
    # card, one bucket scatter, one exchange
    rows = np.empty((reqs["op"].shape[0], F + PAGE_WORDS), np.int32)
    for i, k in enumerate(REQ_FIELDS):
        rows[:, i] = reqs[k]
    rows[:, F:] = reqs["payload"]
    t = torch.as_tensor(rows, device=dev).view(L, -1, F + PAGE_WORDS)
    active = t[..., 0] != OP_NOP
    bucket_idx, routed = T.bucketize(bits.addr_node(t[..., 1]), active,
                                     N, C)
    inc = T.exchange(T.scatter_to_buckets(t, bucket_idx, N * C), M)
    # the owners plan their applies on the host: the request fields, and
    # the payloads only when a page write came in (a DSM host step, not
    # the serve's)
    # shermanlint: disable=SL001 reads the exchanged requests
    inc_h = inc[..., :F].cpu().numpy()
    # shermanlint: disable=SL001 reads the page-write payloads
    payload = inc[..., F:].cpu().numpy() \
        if (inc_h[..., 0] == OP_WRITE).any() else None
    # the reply row: the read page, old, ok
    rep = torch.zeros((L, N * C, PAGE_WORDS + 2), dtype=torch.int32,
                      device=dev)
    words = np.zeros((L, N * C, 2), np.int32)
    for d in range(L):
        req = {k: inc_h[d, :, i] for i, k in enumerate(REQ_FIELDS)}
        req["payload"] = None if payload is None else payload[d]
        rd, pages, words[d, :, 0], words[d, :, 1] = _apply(
            *shards(cfg, d, pool, locks, counters), req)
        if rd.size:
            rep[d, torch.as_tensor(rd, device=dev), :PAGE_WORDS] = pages
    rep[..., PAGE_WORDS:] = torch.as_tensor(words, device=dev)
    back = T.take_local(T.exchange(rep, M),
                        torch.where(routed, bucket_idx, 0))
    back = torch.cat([back, routed[..., None].to(torch.int32)], dim=2)
    # shermanlint: disable=SL001 returns the replies to the host
    back = back.view(-1, PAGE_WORDS + 3).cpu().numpy()
    act = rows[:, 0] != OP_NOP
    routed_h = back[:, -1] != 0
    served = act & routed_h
    return {
        "data": np.where(served[:, None], back[:, :PAGE_WORDS], 0),
        "old": np.where(served, back[:, PAGE_WORDS], 0),
        "ok": np.where(act, routed_h & (back[:, PAGE_WORDS + 1] != 0), True),
    }


def read_pages_spmd(pool, addrs, *, cfg: DSMConfig, active=None):
    """Fetch pages for a batch of addrs: (pages [R, 256] zeroed where not
    ok, ok [R]).  One node reads its pool through the gather kernel.
    With ``machine_nr > 1``, ``addrs`` are global ``[N*R]`` (node ``n``'s
    in rows ``n*R:(n+1)*R``): each node sends a 1-word request per page to
    its owner, the owners read their shards through the gather kernel,
    and ``{data, okb}`` replies come back; rows past the step capacity
    are not served.  When the nodes span ranks, ``addrs`` are the rank's
    ``[L*R]`` and ``pool`` its ``[L*P]`` block; the buckets cross ranks."""
    if active is None:
        active = torch.ones(addrs.shape, dtype=torch.bool,
                            device=addrs.device)
    N = cfg.machine_nr
    if N == 1:
        return PK.read_pages_local(pool, addrs, active)
    C, P = cfg.step_capacity, cfg.pages_per_node
    M = MESH.of(cfg)
    L = M.n_local
    R = addrs.shape[0] // L
    a, act = addrs.view(L, R), active.view(L, R)
    bucket_idx, routed = T.bucketize(bits.addr_node(a), act, N, C)
    req = T.scatter_to_buckets(bits.addr_page(a), bucket_idx, N * C)
    if M.spans:
        # across ranks only the buckets' filled rows cross (the fullest
        # bucket's count, agreed by the ranks), and the owners read those
        fill = T.bucket_fill(bucket_idx, C, M)
        req = T.trim_buckets(req, N, C, fill)
        bucket_idx = T.trimmed_slot(bucket_idx, C, fill)
    S = req.shape[1]
    inc = T.exchange(req, M)
    # owner d reads pool[d*P + clip(page, 0, P-1)]: its own shard of the
    # rank's block
    own = torch.arange(L, dtype=torch.int32, device=pool.device)[:, None]
    rows = own * P + inc.clamp(0, P - 1)
    data = PK.gather_pages(pool, rows.view(-1)).view(L, S, PAGE_WORDS)
    rep = T.exchange({"data": data, "okb": (inc >= 0) & (inc < P)}, M)
    del data
    safe_b = torch.where(routed, bucket_idx, 0)
    served = act & routed & T.take_local(rep["okb"], safe_b)
    pages = T.take_local(rep["data"], safe_b)
    pages.masked_fill_(~served[..., None], 0)
    return pages.view(L * R, PAGE_WORDS), served.view(-1)


# ---------------------------------------------------------------------------
# Host-facing runtime.
# ---------------------------------------------------------------------------

@dataclass
class Replies:
    data: np.ndarray
    old: np.ndarray
    ok: np.ndarray


class _HostOps:
    """Host convenience verbs over :meth:`_batch` (one small step each)."""

    def _batch(self, rows: list[dict]) -> Replies:  # pragma: no cover
        raise NotImplementedError

    @staticmethod
    def _require_ok(ok, what: str) -> None:
        if not bool(np.all(ok)):
            raise ProtocolError(f"host DSM op failed: {what}")

    def read_page(self, addr: int) -> np.ndarray:
        r = self._batch([{"op": OP_READ, "addr": addr}])
        self._require_ok(r.ok[0], "read_page (bad address?)")
        return r.data[0]

    def read_pages(self, addrs) -> np.ndarray:
        r = self._batch([{"op": OP_READ, "addr": int(a)} for a in addrs])
        self._require_ok(r.ok, "read_pages overflow: raise step_capacity")
        return r.data

    def write_page(self, addr: int, words: np.ndarray):
        r = self._batch([{"op": OP_WRITE, "addr": addr, "woff": 0,
                          "nw": PAGE_WORDS, "payload": words}])
        self._require_ok(r.ok[0], "write_page (bad address?)")

    def write_words(self, addr: int, woff: int, words: np.ndarray):
        words = np.asarray(words, np.int32)
        r = self._batch([{"op": OP_WRITE, "addr": addr, "woff": woff,
                          "nw": words.shape[0], "payload": words}])
        self._require_ok(r.ok[0], "write_words (bad address/range?)")

    def write_word(self, addr: int, woff: int, value: int,
                   space: int = SPACE_POOL):
        r = self._batch([{"op": OP_WRITE_WORD, "addr": addr, "woff": woff,
                          "arg1": value, "space": space}])
        self._require_ok(r.ok[0], "write_word (bad address?)")

    def write_rows(self, rows: list[dict]):
        """Batched writes in ONE step: all land at the step boundary."""
        r = self._batch(rows)
        self._require_ok(r.ok, "write_rows (bad address or overflow)")

    def cas(self, addr: int, woff: int, expected: int, desired: int,
            space: int = SPACE_POOL) -> tuple[int, bool]:
        r = self._batch([{"op": OP_CAS, "addr": addr, "woff": woff,
                          "arg0": expected, "arg1": desired, "space": space}])
        return int(r.old[0]), bool(r.ok[0])

    def faa(self, addr: int, woff: int, delta: int,
            space: int = SPACE_POOL) -> int:
        r = self._batch([{"op": OP_FAA, "addr": addr, "woff": woff,
                          "arg0": delta, "space": space}])
        self._require_ok(r.ok[0], "faa (bad address?)")
        return int(r.old[0])

    def read_word(self, addr: int, woff: int, space: int = SPACE_POOL) -> int:
        r = self._batch([{"op": OP_READ_WORD, "addr": addr, "woff": woff,
                          "space": space}])
        self._require_ok(r.ok[0], "read_word (bad address?)")
        return int(r.old[0])

    def masked_cas(self, addr: int, woff: int, expected: int, desired: int,
                   mask: int, space: int = SPACE_POOL) -> tuple[int, bool]:
        """CAS only the ``mask`` bits: other bits are untouched and left out
        of the comparison.  -> (old_word, won)."""
        r = self._batch([{"op": OP_MASKED_CAS, "addr": addr, "woff": woff,
                          "arg0": expected, "arg1": desired, "arg2": mask,
                          "space": space}])
        return int(r.old[0]), bool(r.ok[0])

    def masked_faa(self, addr: int, woff: int, delta: int, mask: int,
                   space: int = SPACE_POOL) -> tuple[int, bool]:
        """Fetch-and-add inside the ``mask`` field (``delta`` pre-shifted
        into it; carries never leave it).  One lands per word per step; a
        lost race returns won=False.  -> (old_word, won)."""
        r = self._batch([{"op": OP_MASKED_FAA, "addr": addr, "woff": woff,
                          "arg0": delta, "arg2": mask, "space": space}])
        return int(r.old[0]), bool(r.ok[0])

    # -- coalesced dependent-op chains: one step, landing together ------------

    def cas_read(self, cas_addr: int, woff: int, expected: int, desired: int,
                 read_addr: int, cas_space: int = SPACE_LOCK
                 ) -> tuple[int, bool, np.ndarray]:
        """CAS a word and read a page in ONE step (lock acquire fused with
        the page fetch).  The read is the pre-step snapshot, which holds
        the previous holder's write: its write and unlock landed in one
        earlier step.  -> (old_word, cas_won, page)."""
        r = self._batch([
            {"op": OP_CAS, "addr": cas_addr, "woff": woff,
             "arg0": expected, "arg1": desired, "space": cas_space},
            {"op": OP_READ, "addr": read_addr},
        ])
        self._require_ok(r.ok[1], "cas_read: bad page address")
        return int(r.old[0]), bool(r.ok[0]), r.data[1]

    def write_cas(self, waddr: int, woff: int, payload: np.ndarray,
                  cas_addr: int, cas_woff: int, expected: int, desired: int,
                  cas_space: int = SPACE_LOCK) -> bool:
        """Write words and CAS a word in ONE step; the CAS linearizes on
        the pre-step value.  -> cas_won."""
        payload = np.asarray(payload, np.int32)
        r = self._batch([
            {"op": OP_WRITE, "addr": waddr, "woff": woff,
             "nw": payload.shape[0], "payload": payload},
            {"op": OP_CAS, "addr": cas_addr, "woff": cas_woff,
             "arg0": expected, "arg1": desired, "space": cas_space},
        ])
        self._require_ok(r.ok[0], "write_cas: bad write address")
        return bool(r.ok[1])

    def write_faa(self, waddr: int, woff: int, payload: np.ndarray,
                  faa_addr: int, faa_woff: int, delta: int,
                  faa_space: int = SPACE_POOL) -> int:
        """Write words and fetch-and-add a word in ONE step.  -> the FAA's
        serial pre-value."""
        payload = np.asarray(payload, np.int32)
        r = self._batch([
            {"op": OP_WRITE, "addr": waddr, "woff": woff,
             "nw": payload.shape[0], "payload": payload},
            {"op": OP_FAA, "addr": faa_addr, "woff": faa_woff,
             "arg0": delta, "space": faa_space},
        ])
        self._require_ok(r.ok[0] and r.ok[1], "write_faa: bad address")
        return int(r.old[1])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DSM(_HostOps):
    """Host handle to the cluster: owns the node-major pool, lock table,
    counters and dirty mask on ``cfg.device`` (of this rank's
    ``local_nodes`` when the mesh spans processes)."""

    def __init__(self, cfg: DSMConfig):
        self.cfg = cfg
        self.device = cfg.torch_device()
        self.mesh = MESH.of(cfg)
        # the mesh spans processes: host steps are collectives, and this
        # rank holds its own contiguous block of nodes of every tensor
        self.multihost = self.mesh.spans
        self.local_nodes = self.mesh.local_nodes
        if self.multihost and cfg.heap_pages_per_node > 0:
            raise MultiprocessUnsupportedError(
                "the value heap is single-process: set "
                "heap_pages_per_node=0 on a mesh that spans processes")
        N, P, L = self.mesh.n_local, cfg.pages_per_node, cfg.locks_per_node
        z = lambda *shape, dtype: torch.zeros(shape, dtype=dtype,
                                              device=self.device)
        self.pool = z(N * P, PAGE_WORDS, dtype=torch.int32)
        self.locks = z(N * L, dtype=torch.int32)
        self.counters = z(N * N_COUNTERS, dtype=torch.int64)
        # dirty pages: the engine's write steps mark the device mask,
        # host steps and direct installs the host set
        self.dirty = z(N * P, dtype=torch.bool)
        self._dirty_host: set[int] = set()
        # dirty sinks (the online migrator's feed, migrate.py): a clear
        # hands them the rows it is about to drop, so a second consumer of
        # the dirty tracking never loses rows to a checkpoint
        self._dirty_sinks: list = []
        # the value heap, the second region (``models/value_heap.py`` owns
        # the slab/handle protocol): ``[N*H, 256]`` int32 node-major like
        # the pool, None without one; its written rows in a host set
        self.heap = None
        self._heap_dirty_host: set[int] = set()
        if cfg.heap_pages_per_node > 0:
            self.heap = z(N * cfg.heap_pages_per_node, PAGE_WORDS,
                          dtype=torch.int32)
        self.host_capacity = min(cfg.step_capacity, cfg.host_step_capacity)
        # the host step's own small routing capacity
        self._host_cfg = dataclasses.replace(
            cfg, step_capacity=self.host_capacity)
        self._step_mutex = threading.Lock()
        # the chaos hook (sherman_tpu_torch/chaos.py): a FaultPlan fired at
        # the host-step boundary; SHERMAN_CHAOS installs one here
        self.chaos = None
        if os.environ.get("SHERMAN_CHAOS"):
            from sherman_tpu_torch.chaos import FaultPlan
            self.chaos = FaultPlan.from_env()
        self.register_obs()

    def register_obs(self) -> None:
        """Make this DSM the one the registry's ``dsm`` pull collector
        (its op counters: snapshots read them, no per-op host cost) and
        the memory accountant's ``hbm`` sources (pool, locks, counters,
        dirty mask) read.  A new DSM does this itself and supersedes an
        earlier one; call it to point them back at a DSM built before
        another.  Both are bound by weakref: a dropped DSM reads {} and
        0 instead of keeping its pool alive."""
        ref = weakref.ref(self)
        obs.register_collector(
            "dsm", lambda: (lambda d: d.counter_snapshot() if d is not None
                            else {})(ref()))
        acct = obs.get_accountant()
        for _src in ("pool", "locks", "counters", "dirty"):
            acct.register(_src, (lambda r=ref, n=_src: (
                _nbytes(getattr(r(), n)) if r() is not None else 0)))
        if self.heap is not None:
            acct.register("heap", (lambda r=ref: (
                _nbytes(r().heap)
                if r() is not None and r().heap is not None else 0)))

    # -- raw step ------------------------------------------------------------

    def step(self, reqs: dict[str, np.ndarray]) -> Replies:
        """Run one DSM step over global request arrays [N*R] (node ``n``
        sends rows ``n*R:(n+1)*R``); thread-safe.  Active requests past a
        bucket's capacity, or addressed to no node of the cluster, are
        refused with ok=False (the reference's bucket overflow).  An
        installed chaos plan fires its due faults under the step mutex
        before the step (they may rewrite its requests) and may rewrite
        its replies after it; the caller's requests mark the dirty
        pages."""
        _OBS_HOST_STEPS.inc()
        self._mark_dirty_from_reqs(reqs)
        with self._step_mutex:
            if self.chaos is None:
                return self._step_locked(reqs)
            reqs0 = reqs
            reqs, post = self.chaos.on_step(self, reqs)
            rep = self._step_locked(reqs)
            return self.chaos.on_replies(self, reqs0, rep) if post else rep

    def _step_locked(self, reqs: dict[str, np.ndarray]) -> Replies:
        r = {k: np.asarray(v, np.int32) for k, v in reqs.items()}
        N = self.cfg.machine_nr
        if N > 1:
            L = self.mesh.n_local
            if r["op"].shape[0] % L:
                raise ConfigError(
                    f"DSM.step: {r['op'].shape[0]} request rows do not "
                    f"split into {L} equal node blocks")
            return Replies(**dsm_step_spmd(self.pool, self.locks,
                                           self.counters, r,
                                           cfg=self._host_cfg))
        active = r["op"] != OP_NOP
        to_me = active & (
            (r["addr"].astype(np.int64) & _U32) >> CFG.ADDR_PAGE_BITS == 0)
        routed = to_me & (np.cumsum(to_me) <= self.host_capacity)
        r["op"] = np.where(routed, r["op"], OP_NOP).astype(np.int32)
        rd, pages, old, ok = _apply(self.pool, self.locks, self.counters, r)
        served = active & routed
        data = np.zeros((r["op"].shape[0], PAGE_WORDS), np.int32)
        if rd.size:
            data[rd] = pages.cpu().numpy()
        return Replies(data=data, old=np.where(served, old, 0),
                       ok=np.where(active, routed & ok, True))

    def install_chaos(self, plan) -> None:
        """Install (or clear, with ``None``) a chaos
        :class:`~sherman_tpu_torch.chaos.FaultPlan`; its step indices
        count host steps from the moment of installation."""
        self.chaos = plan

    # -- dirty-page tracking ---------------------------------------------------

    _POOL_WRITE_OPS = (OP_WRITE, OP_WRITE_WORD, OP_CAS, OP_FAA,
                       OP_MASKED_CAS, OP_MASKED_FAA)

    def local_row_range(self) -> tuple[int, int]:
        """``[lo, hi)`` global pool rows this process owns (the whole pool
        in one process).  Rows are global, so a handle never changes
        meaning; ownership is which rank's dirty tracking and artifacts a
        row lands in."""
        P = self.cfg.pages_per_node
        return (self.local_nodes.start * P, self.local_nodes.stop * P)

    def _own_rows(self, rows: np.ndarray) -> np.ndarray:
        if not self.multihost:
            return rows
        lo, hi = self.local_row_range()
        return rows[(rows >= lo) & (rows < hi)]

    def _mark_dirty_from_reqs(self, reqs) -> None:
        """One address-set union per host step: every pool-space request
        that can mutate its page marks it dirty (CAS losers over-mark).
        Across ranks only the rows this rank owns are tracked: a remote
        write is its owner's to track, from its own copy of the step."""
        op = np.asarray(reqs["op"]).ravel()
        wr = np.isin(op, self._POOL_WRITE_OPS) \
            & (np.asarray(reqs["space"]).ravel() == SPACE_POOL)
        if not wr.any():
            return
        a = np.asarray(reqs["addr"]).ravel()[wr].astype(np.int64) & _U32
        node = a >> CFG.ADDR_PAGE_BITS
        page = a & CFG.ADDR_PAGE_MASK
        P = self.cfg.pages_per_node
        keep = (node < self.cfg.machine_nr) & (page < P)
        rows = self._own_rows(node[keep] * P + page[keep])
        self._dirty_host.update(int(r) for r in np.unique(rows))

    def mark_dirty_rows(self, rows) -> None:
        """Mark global pool rows dirty (direct installs that bypass the
        steps); across ranks, rows another rank owns are dropped (the
        owner marks them from its own call)."""
        rows = self._own_rows(np.asarray(rows, np.int64).ravel())
        self._dirty_host.update(int(r) for r in rows)

    def dirty_rows(self) -> np.ndarray:
        """Sorted global pool rows written since the last clear: the device
        mask united with the host set (this rank's rows only, across
        ranks: the union of every rank's return is the cluster's dirty
        set)."""
        dev = torch.nonzero(self.dirty).squeeze(1).cpu().numpy() \
            + self.local_row_range()[0]
        if not self._dirty_host:
            return dev.astype(np.int64)
        host = np.fromiter(self._dirty_host, np.int64, len(self._dirty_host))
        # not np.union1d: the host set holds every installed page after a
        # bulk load (millions of rows)
        return sorted_unique(np.concatenate([dev.astype(np.int64), host]))

    def add_dirty_sink(self, fn) -> None:
        """Register a callable handed the dirty rows at every
        :meth:`clear_dirty`, before the reset: the second-consumer
        contract of the dirty tracking (across ranks a sink sees only the
        rows its rank owns)."""
        self._dirty_sinks.append(fn)

    def remove_dirty_sink(self, fn) -> None:
        if fn in self._dirty_sinks:
            self._dirty_sinks.remove(fn)

    def clear_dirty(self) -> None:
        """Reset both dirty tiers and the heap's dirty rows (a checkpoint
        artifact captured them).  The registered dirty sinks see the rows
        first: a clear must not hide writes from a concurrent consumer
        (the migration's re-copy set)."""
        if self._dirty_sinks:
            rows = self.dirty_rows()
            if rows.size:
                for fn in list(self._dirty_sinks):
                    fn(rows)
        self.dirty.zero_()
        self._dirty_host.clear()
        self._heap_dirty_host.clear()

    def read_rows_local(self, rows, region: str = "pool") -> np.ndarray:
        """Global pool (or heap, ``region="heap"``) rows copied to the
        host from this rank's own block: the collective-free gather a
        per-rank save needs.  Rows outside :meth:`local_row_range` raise
        (read them on their owner)."""
        arr = self.heap if region == "heap" else self.pool
        if arr is None:
            raise ConfigError("no value heap configured")
        rows = np.asarray(rows, np.int64).ravel()
        if rows.size == 0:
            return np.zeros((0, arr.shape[1]), np.int32)
        if self.multihost:
            lo, hi = self.local_row_range()
            out = (rows < lo) | (rows >= hi)
            if out.any():
                raise ConfigError(
                    f"read_rows_local: {int(out.sum())} row(s) outside "
                    "this process's node block: gather them on their "
                    "owner")
            rows = rows - lo
        return arr[torch.as_tensor(rows, device=arr.device)].cpu().numpy()

    # -- the value-heap region (the second DSM region) -------------------------
    # Word-cell writes and page reads over ``self.heap``; the slab/handle
    # protocol lives in models/value_heap.py.  They sit on the DSM so that
    # dirty tracking and checkpoints see one owner of both regions.

    def _require_heap(self) -> None:
        if self.heap is None:
            raise ConfigError(
                "no value heap configured: set "
                "DSMConfig.heap_pages_per_node > 0 (SHERMAN_VALUE_HEAP)")

    def heap_write_cells(self, rows, woffs, vals) -> None:
        """``heap[rows[i], woffs[i]] = vals[i]`` in one in-place scatter
        under the step mutex; marks the touched heap rows dirty (the
        delta checkpoints' feed)."""
        self._require_heap()
        rows = np.asarray(rows, np.int64).ravel()
        if rows.size == 0:
            return
        woffs = np.asarray(woffs, np.int64).ravel()
        vals = np.asarray(vals).astype(np.int32).ravel()
        dev = self.heap.device
        with self._step_mutex:
            self.heap[torch.as_tensor(rows, device=dev),
                      torch.as_tensor(woffs, device=dev)] = \
                torch.as_tensor(vals, device=dev)
        self._heap_dirty_host.update(sorted_unique(rows).tolist())

    def heap_read_rows(self, rows) -> np.ndarray:
        """Heap pages by global heap row, copied to the host (the host
        resolver's and the scrub's convenience; the read path gathers on
        the device)."""
        self._require_heap()
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return np.zeros((0, PAGE_WORDS), np.int32)
        with self._step_mutex:
            return self.read_rows_local(rows, "heap")

    def heap_snapshot(self) -> np.ndarray:
        """A host copy of the whole heap region."""
        self._require_heap()
        with self._step_mutex:
            return self.heap.to("cpu", copy=True).numpy()

    def mark_heap_dirty_rows(self, rows) -> None:
        """Mark global heap rows dirty (restore and replay writes that
        bypass :meth:`heap_write_cells`)."""
        self._heap_dirty_host.update(
            int(r) for r in np.asarray(rows).ravel())

    def heap_dirty_rows(self) -> np.ndarray:
        """Sorted global heap rows written since the last clear."""
        if not self._heap_dirty_host:
            return np.zeros(0, np.int64)
        return np.sort(np.fromiter(self._heap_dirty_host, np.int64,
                                   len(self._heap_dirty_host)))

    # -- host convenience ops --------------------------------------------------

    def _batch(self, rows: list[dict]) -> Replies:
        # at most host_capacity rows per step, spread round-robin over the
        # source nodes (this rank's, across ranks), so no destination
        # bucket can overflow
        cap = self.host_capacity
        n_src = self.mesh.n_local
        if len(rows) > cap:
            if self.multihost:
                # each chunk is one COLLECTIVE step: a data-dependent
                # chunk count would desync the ranks' step sequences
                raise ConfigError(
                    f"multi-host host-API batch of {len(rows)} rows "
                    f"exceeds host_step_capacity={cap}: chunk the call "
                    "identically on every process (each chunk is one "
                    "collective step)")
            out = [self._batch(rows[i:i + cap])
                   for i in range(0, len(rows), cap)]
            return Replies(
                data=np.concatenate([r.data for r in out]),
                old=np.concatenate([r.old for r in out]),
                ok=np.concatenate([r.ok for r in out]))
        reqs = empty_requests(n_src * cap)
        slots = [(i % n_src) * cap + i // n_src for i in range(len(rows))]
        for slot, row in zip(slots, rows):
            for k, v in row.items():
                if k == "payload":
                    v = np.asarray(v, np.int32)
                    reqs["payload"][slot, :v.shape[0]] = v
                else:
                    # accept full uint32 bit patterns
                    reqs[k][slot] = np.uint32(int(v) & _U32).astype(np.int32)
        rep = self.step(reqs)
        sl = np.array(slots, np.int64)
        return Replies(data=rep.data[sl], old=rep.old[sl], ok=rep.ok[sl])

    # -- observability ---------------------------------------------------------

    def counters_np(self) -> np.ndarray:
        """Every node's counter slots, node-major, as uint32 (the
        reference's dtype)."""
        return self.counters.cpu().numpy().astype(np.uint32)

    def counter_snapshot(self) -> dict[str, int]:
        """Op counters summed over this process's nodes (the whole cluster
        in one process); across ranks, ``keeper.sum`` aggregates them, the
        reference's pattern (``dsm->sum``, test/benchmark.cpp:336-346)."""
        tot = self.counters_np().reshape(-1, N_COUNTERS).sum(
            axis=0, dtype=np.uint64)
        return {
            "read_ops": int(tot[CNT_READ_OPS]),
            "read_bytes": int(tot[CNT_READ_PAGES]) * CFG.PAGE_BYTES,
            "write_ops": int(tot[CNT_WRITE_OPS]),
            "write_bytes": int(tot[CNT_WRITE_WORDS]) * 4,
            "cas_ops": int(tot[CNT_CAS_OPS]),
            "faa_ops": int(tot[CNT_FAA_OPS]),
            "write_word_ops": int(tot[CNT_WW_OPS]),
            "combine_groups": int(tot[CNT_COMBINE_GROUPS]),
            "combine_locks_saved": int(tot[CNT_COMBINE_SAVED]),
        }


class ReplicatedDSM(_HostOps):
    """Replicated-driver host API over a DSM whose mesh spans processes.

    Every rank runs the SAME host program, so a host-API op (lock CAS,
    page read/write, the coalesced chains) is requested by every rank but
    must execute on the cluster exactly ONCE.  Every rank calls every
    method with identical arguments (the engine checks its inputs with
    digests); rank 0 posts the real request rows while the others
    contribute empty collective steps, and rank 0's replies are broadcast
    so every rank returns the same result (the reference's UD-RPC control
    plane, ``Directory.cpp:60-92``: one requester executes, everyone
    learns the outcome).

    Batches of any length are chunked to ``host_step_capacity`` rows a
    step; the chunk count derives from the replicated row list, so the
    ranks' collective step sequences cannot desync.  Device state is the
    wrapped DSM's: the engine keeps driving its tensors directly."""

    def __init__(self, dsm: DSM):
        from sherman_tpu_torch.parallel import bootstrap
        assert dsm.multihost, "ReplicatedDSM wraps a process-spanning DSM"
        self._dsm = dsm
        self._leader = dsm.mesh.rank == 0
        # the engine's tiled reassembly needs node blocks that ascend with
        # the rank: checked once per cluster
        firsts = bootstrap.process_allgather(
            np.asarray([dsm.local_nodes[0]], np.int32)).ravel()
        assert (np.diff(firsts) > 0).all(), (
            "mesh node blocks must ascend with process index")

    # -- the shared state (the engine mutates pool and counters in place) ----

    pool = property(lambda s: s._dsm.pool,
                    lambda s, v: setattr(s._dsm, "pool", v))
    locks = property(lambda s: s._dsm.locks,
                     lambda s, v: setattr(s._dsm, "locks", v))
    counters = property(lambda s: s._dsm.counters,
                        lambda s, v: setattr(s._dsm, "counters", v))
    dirty = property(lambda s: s._dsm.dirty,
                     lambda s, v: setattr(s._dsm, "dirty", v))
    heap = property(lambda s: s._dsm.heap)
    cfg = property(lambda s: s._dsm.cfg)
    device = property(lambda s: s._dsm.device)
    multihost = property(lambda s: s._dsm.multihost)
    _step_mutex = property(lambda s: s._dsm._step_mutex)

    def counter_snapshot(self) -> dict[str, int]:
        return self._dsm.counter_snapshot()

    def local_row_range(self) -> tuple[int, int]:
        return self._dsm.local_row_range()

    def mark_dirty_rows(self, rows) -> None:
        self._dsm.mark_dirty_rows(rows)

    def clear_dirty(self) -> None:
        self._dsm.clear_dirty()

    def _batch(self, rows: list[dict]) -> Replies:
        from sherman_tpu_torch.parallel import bootstrap
        if not rows:
            self._dsm._batch([])  # still one collective step
            return Replies(data=np.zeros((0, PAGE_WORDS), np.int32),
                           old=np.zeros(0, np.int32), ok=np.zeros(0, bool))
        cap = self._dsm.host_capacity
        parts = []
        for i in range(0, len(rows), cap):
            chunk = rows[i:i + cap]
            if self._leader:
                parts.append(self._dsm._batch(chunk))
            else:
                # the rows are replicated: this rank marks the rows it
                # owns from its own copy of the step
                self._dsm._mark_dirty_from_reqs({
                    k: np.asarray([int(r.get(k, 0)) & _U32 for r in chunk],
                                  np.uint32).view(np.int32)
                    for k in ("op", "addr", "space")})
                self._dsm._batch([])
                parts.append(Replies(
                    data=np.zeros((len(chunk), PAGE_WORDS), np.int32),
                    old=np.zeros(len(chunk), np.int32),
                    ok=np.zeros(len(chunk), bool)))
        rep = Replies(data=np.concatenate([p.data for p in parts]),
                      old=np.concatenate([p.old for p in parts]),
                      ok=np.concatenate([p.ok for p in parts]))
        # one broadcast of the leader's replies (the others pass
        # placeholders of the same shapes: the rows are replicated)
        g = bootstrap.broadcast_one_to_all((rep.data, rep.old, rep.ok))
        return Replies(data=g[0], old=g[1], ok=g[2])
