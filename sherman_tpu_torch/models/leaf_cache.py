"""Hot-key tier: a versioned compute-side leaf/value cache (counterpart of
``sherman_tpu/models/leaf_cache.py``).

At YCSB skew (zipf 0.99) a small set of keys takes most of the reads, yet
the router caches only where a key's leaf starts: every repeat read of a
hot key still pays a descent and a page gather.  This tier is a bounded,
fixed-shape table

    key -> (value, leaf addr, in-leaf slot, captured entry-version pair)

probed by one vectorized lookup in front of the descent.  Hits skip the
descent; misses go on to the fan-out as the residual, smaller batch.

The coherence token is the packed fver/rver entry version the write path
already bumps: every probe match is re-certified against the live pool
(one page read of the cached leaf, 8 word gathers on one node).  A hit
needs all of: the address still holds a level-0 page with equal front
and rear versions; the cached slot is live (fver == rver != 0) and holds
the probed key; the slot's version word and value words equal the
captured ones.  A match that fails is stale: it is counted, its slot is
cleared on the device, and the key falls back to the descent, so answers
are bit-identical to the uncached path by construction.

Table: open addressing over ``slots`` (a power of two) with a probe
window of ``DEFAULT_WINDOW`` consecutive slots (a fixed ``[B, window]``
gather, no data-dependent shape); it admits ``slots // 2`` keys, placed
hottest first on the host.  Admission: :meth:`LeafCache.fill` with a
known hot set (the benchmarks' zipf ranks), or :meth:`LeafCache.observe`
with a decayed top-K frequency sketch every ``admit_every`` read batches.

Invalidation (conservative; validation stays the guard): the engine's
``insert``/``delete``/``mixed`` drop their write keys; reclaim drops the
pages it unlinks; the scrubber drops a flagged page's keys; degraded
entry and targeted repair flush it all.  The cache is volatile: it is
never checkpointed, and recovery starts cold.

Metrics ride the ``cache`` pull collector (hits, misses, invalidations,
evictions, the hit ratio, the payload sidecar's counts).  The knob:
``config.leaf_cache_slots()`` / ``SHERMAN_LEAF_CACHE`` (off by default).
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.ops import bits, layout
from sherman_tpu_torch.parallel import dsm as D

DEFAULT_WINDOW = 8  # open-addressing probe window (slots per key)

_TABLE_FIELDS = ("khi", "klo", "vhi", "vlo", "ver", "addr", "slot")


# ---------------------------------------------------------------------------
# Slot hash: device and host forms must agree, or every fill would miss.
# ---------------------------------------------------------------------------

def slot_hash_np(khi: np.ndarray, klo: np.ndarray) -> np.ndarray:
    """Host table hash of (hi, lo) int32 key pairs -> uint32 [B]."""
    h = bits.hash32_np(np.asarray(klo).view(np.uint32))
    return bits.hash32_np(np.asarray(khi).view(np.uint32) ^ h)


def slot_hash(khi, klo) -> torch.Tensor:
    """Device twin of :func:`slot_hash_np`: int32 pairs -> the uint32
    hash in int64."""
    return bits.hash32(bits.u32(khi) ^ bits.hash32(klo))


# ---------------------------------------------------------------------------
# The device probe (shared by the engine's probe and the staged loop's
# cache_probe).
# ---------------------------------------------------------------------------

def probe_rows(pool, tbl, khi, klo, active, *, cfg):
    """Probe and validate one key batch against the pool.

    ``tbl``: dict of ``[S]`` int32 tensors (khi, klo, vhi, vlo, ver, addr,
    slot); khi == klo == 0 marks an empty slot (key 0 is below
    ``KEY_MIN``).  ``khi``/``klo``/``active`` are node-major ``[N*B]``.
    -> per row ``(hit, vhi, vlo, stale, tidx)``: ``hit`` the cached value
    is current in this pool (serve it), ``stale`` the table matched but
    validation failed (clear slot ``tidx`` and descend)."""
    S = tbl["khi"].shape[0]
    W = min(DEFAULT_WINDOW, S)
    idx = slot_hash(khi, klo) & (S - 1)
    cand = (idx[:, None] + torch.arange(W, device=idx.device)) & (S - 1)
    ck_hi, ck_lo = tbl["khi"][cand], tbl["klo"][cand]
    m = (active[:, None] & (ck_hi == khi[:, None])
         & (ck_lo == klo[:, None]) & ((ck_hi != 0) | (ck_lo != 0)))
    # the first match (placement keeps keys unique: at most one): its
    # slot, then one [B] gather a table (the same words as the
    # reference's one-hot sums over the window; 0 without a match)
    pmatch = m.any(dim=1)
    first = torch.argmax(m.to(torch.int32), dim=1, keepdim=True)
    tsel = cand.gather(1, first)[:, 0]

    def pick(a):
        return torch.where(pmatch, a[tsel], 0)

    c_addr, c_slot, c_ver = pick(tbl["addr"]), pick(tbl["slot"]), \
        pick(tbl["ver"])
    c_vhi, c_vlo = pick(tbl["vhi"]), pick(tbl["vlo"])
    tidx = torch.where(pmatch, tsel, 0).to(torch.int32)

    if cfg.machine_nr == 1:
        # narrow validation: 8 word gathers (headers + the slot's five
        # fields) instead of a 256-word page row per hit
        P = pool.shape[0]
        row = bits.addr_page(c_addr)
        okr = pmatch & (row >= 0) & (row < P)
        r = row.clamp(0, P - 1).long()
        s = c_slot.clamp(0, C.LEAF_CAP - 1).long()
        pv = pool[r, C.L_VER_W + s]
        fv, rv = layout.ver_unpack(pv)
        hit = (okr
               & (pool[r, C.W_LEVEL] == 0)
               & (pool[r, C.W_FRONT_VER] == pool[r, C.W_REAR_VER])
               & (fv == rv) & (fv != 0)
               & (pool[r, C.L_KHI_W + s] == khi)
               & (pool[r, C.L_KLO_W + s] == klo)
               & (pv == c_ver)
               & (pool[r, C.L_VHI_W + s] == c_vhi)
               & (pool[r, C.L_VLO_W + s] == c_vlo))
    else:
        # several nodes: the cached leaf may live on a peer, so its page
        # comes through the routed read exchange (one round, like a
        # router-seeded round-1 descent read)
        page, okr = D.read_pages_spmd(pool, c_addr, cfg=cfg, active=pmatch)
        so = (torch.arange(C.LEAF_CAP, dtype=torch.int32,
                           device=page.device)[None, :]
              == c_slot.clamp(0, C.LEAF_CAP - 1)[:, None])

        def blk(st):
            return layout._wsum(page[:, st:st + C.LEAF_CAP], so)

        pv = blk(C.L_VER_W)
        fv, rv = layout.ver_unpack(pv)
        hit = (pmatch & okr
               & (layout.h_level(page) == 0)
               & layout.page_consistent(page)
               & (fv == rv) & (fv != 0)
               & (blk(C.L_KHI_W) == khi) & (blk(C.L_KLO_W) == klo)
               & (pv == c_ver)
               & (blk(C.L_VHI_W) == c_vhi) & (blk(C.L_VLO_W) == c_vlo))
    hit = hit & pmatch
    stale = pmatch & ~hit
    return (hit, torch.where(hit, c_vhi, 0), torch.where(hit, c_vlo, 0),
            stale, tidx)


def invalidation_mask(stale, tidx, n_slots: int) -> torch.Tensor:
    """``[S]`` int32 count of stale probe matches per table slot over
    every node's rows: the table is one copy shared by the emulated
    nodes, so this sum is the reference's psum, the same on each."""
    idx = torch.where(stale, tidx.long(), n_slots)
    inval = torch.zeros(n_slots + 1, dtype=torch.int32, device=stale.device)
    inval.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return inval[:n_slots]


class LeafCache:
    """Batched, versioned hot-key value cache over a
    :class:`~sherman_tpu_torch.models.batched.BatchedEngine` (see the
    module docstring).  Attach it with ``engine.attach_leaf_cache()``;
    the engine's read entry points then probe it and its write entry
    points invalidate it."""

    def __init__(self, eng, slots: int | None = None,
                 window: int = DEFAULT_WINDOW, admit_every: int = 0):
        if slots is None:
            slots = C.leaf_cache_slots() or 65536
        if slots < 2 * window:
            slots = 2 * window
        S = 1 << (int(slots) - 1).bit_length()  # round up to pow2
        if window != DEFAULT_WINDOW:
            raise ConfigError(
                "the leaf cache's probe window is fixed at "
                f"DEFAULT_WINDOW={DEFAULT_WINDOW}")
        self.eng = eng
        self.cfg = eng.cfg
        self.slots = S
        self.window = window
        #: admitted-key budget: load <= 0.5 keeps the bounded window
        #: near-lossless under hottest-first placement
        self.capacity = S // 2
        #: auto-admission cadence in observed batches (0 = manual fill)
        self.admit_every = int(admit_every)
        # host mirror of the device table (placement and invalidation
        # bookkeeping; the device copies are pushed lazily)
        self._khi = np.zeros(S, np.int32)
        self._klo = np.zeros(S, np.int32)
        self._vhi = np.zeros(S, np.int32)
        self._vlo = np.zeros(S, np.int32)
        self._ver = np.zeros(S, np.int32)
        self._addr = np.zeros(S, np.int32)
        self._slot = np.zeros(S, np.int32)
        self._keys = np.zeros(S, np.uint64)  # u64 view for isin lookups
        self._dev: tuple | None = None
        self._dirty = True
        self._lock = threading.RLock()
        self._probe_cache: dict = {}
        self._fill_cache: dict = {}
        # frequency sketch for auto-admission (decayed counts)
        self._freq: dict[int, float] = {}
        self._observed_batches = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.fills = 0
        self.placement_failures = 0
        # payload sidecar: {key: (heap handle, payload bytes)} pinned by a
        # serving read path after a heap gather.  A later read whose live
        # handle equals the pinned one (a rewrite always changes it)
        # returns the pinned bytes; any mismatch drops the pin.
        self._sidecar: dict[int, tuple[int, bytes]] = {}
        self.sidecar_hits = 0
        self.sidecar_stale = 0
        self.sidecar_pins = 0
        ref = weakref.ref(self)

        def _collect():
            c = ref()
            return c.stats() if c is not None else {}

        obs.register_collector("cache", _collect)

    # -- metrics --------------------------------------------------------------

    def _note_probe(self, hits: int, misses: int, stale: int) -> None:
        """Per probed batch: plain integer adds only."""
        self.hits += hits
        self.misses += misses
        self.invalidations += stale

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "invalidations": self.invalidations,
            "evictions": self.evictions,
            "fills": self.fills,
            "placement_failures": self.placement_failures,
            "sidecar_hits": self.sidecar_hits,
            "sidecar_stale": self.sidecar_stale,
            "sidecar_pins": self.sidecar_pins,
            "sidecar_keys": len(self._sidecar),
            "hit_ratio": (self.hits / total) if total else 0.0,
            "cached_keys": int((self._keys != 0).sum()),
            "slots": self.slots,
            "capacity": self.capacity,
        }

    # -- device table ---------------------------------------------------------

    def _table_host(self) -> tuple:
        return (self._khi, self._klo, self._vhi, self._vlo, self._ver,
                self._addr, self._slot)

    def device_tables(self) -> tuple:
        """The seven ``[S]`` int32 device tables (khi, klo, vhi, vlo, ver,
        addr, slot), copied from the host mirror when it changed.  The
        staged loop stages them once before its window."""
        with self._lock:
            if self._dirty or self._dev is None:
                dev = self.eng.device
                self._dev = tuple(torch.tensor(a, device=dev)
                                  for a in self._table_host())
                self._dirty = False
            return self._dev

    # -- probe ----------------------------------------------------------------

    def _get_probe(self, width: int):
        """The engine-path probe: probe, validate and clear the stale
        slots on the device.  ``fn(pool, *tables, khi, klo, active) ->
        (hit, vhi, vlo, khi table, klo table, n_hits, n_stale)``."""
        fn = self._probe_cache.get(width)
        if fn is None:
            cfg, S = self.cfg, self.slots

            def fn(pool, tkhi, tklo, tvhi, tvlo, tver, taddr, tslot, khi,
                   klo, active):
                tbl = dict(zip(_TABLE_FIELDS, (tkhi, tklo, tvhi, tvlo, tver,
                                               taddr, tslot)))
                hit, vhi, vlo, stale, tidx = probe_rows(
                    pool, tbl, khi, klo, active, cfg=cfg)
                keep = invalidation_mask(stale, tidx, S) == 0
                return (hit, vhi, vlo, torch.where(keep, tkhi, 0),
                        torch.where(keep, tklo, 0), hit.sum(), stale.sum())

            fn = DEV.wrap_program("engine.cache_probe", fn)
            self._probe_cache[width] = fn
        return fn

    def probe(self, khi: np.ndarray, klo: np.ndarray, active: np.ndarray):
        """Probe one padded batch (host int32 pairs and active mask of the
        engine's ``machine_nr * B`` width) -> (hit, vhi, vlo) numpy arrays
        of the same width.  Stale matches are cleared on the device and
        counted; hits and misses land in the ``cache`` collector."""
        eng = self.eng
        dev = self.device_tables()
        fn = self._get_probe(khi.shape[0])
        with eng._step_mutex:
            out = fn(eng.dsm.pool, *dev, eng._dev(khi), eng._dev(klo),
                     eng._dev(active))
        hit, vhi, vlo, tkhi2, tklo2, nh, ns = out
        with self._lock:
            if not self._dirty:
                # adopt the device-side invalidations; a concurrent host
                # fill or invalidation marked the mirror dirty and wins
                self._dev = (tkhi2, tklo2) + self._dev[2:]
        hit, vhi, vlo = (t.cpu().numpy() for t in (hit, vhi, vlo))
        nh_i = int(nh)
        ns_i = int(ns)
        self._note_probe(nh_i, int(active.sum()) - nh_i, ns_i)
        return hit, vhi, vlo

    # -- fill (admission) -----------------------------------------------------

    def _get_fill(self, iters: int, with_start: bool):
        """The fill's resolve: descend candidate keys to their leaves and
        capture (addr, slot, packed version, value); off the hot path.
        ``fn(pool, counters, khi, klo, root, active, start) -> (ok, addr,
        slot, ver, vhi, vlo)``, ``counters`` updated in place."""
        key = (iters, with_start)
        fn = self._fill_cache.get(key)
        if fn is None:
            from sherman_tpu_torch.models.batched import _resolve_leaves
            cfg = self.cfg

            def fn(pool, counters, khi, klo, root, active, start):
                done, addr, found, _, _ = _resolve_leaves(
                    pool, counters, khi, klo, root, active, start, cfg=cfg,
                    iters=iters)
                page, okp = D.read_pages_spmd(pool, addr, cfg=cfg,
                                              active=done & found)
                f2, _, _, slot = layout.leaf_find_key(page, khi, klo)
                ok = done & found & okp & f2
                so = (torch.arange(C.LEAF_CAP, dtype=torch.int32,
                                   device=page.device)[None, :]
                      == slot.clamp(0, C.LEAF_CAP - 1)[:, None])

                def blk(s):
                    return layout._wsum(page[:, s:s + C.LEAF_CAP], so)

                def z(a):
                    return torch.where(ok, a, 0)

                return (ok, z(addr), z(slot), z(blk(C.L_VER_W)),
                        z(blk(C.L_VHI_W)), z(blk(C.L_VLO_W)))

            fn = DEV.wrap_program("engine.cache_fill", fn)
            self._fill_cache[key] = fn
        return fn

    def _resolve(self, keys: np.ndarray):
        """-> (ok, addr, slot, ver, vhi, vlo) host arrays [len(keys)]:
        each key's live leaf position with its captured version and value,
        chunked through the engine's padded batch width."""
        eng = self.eng
        n = keys.shape[0]
        total = eng.total
        outs = [np.zeros(n, bool)] + [np.zeros(n, np.int32)
                                      for _ in range(5)]
        use_router = eng.router is not None
        fn = self._get_fill(eng._iters(), use_router)
        for i in range(0, n, total):
            chunk = keys[i:i + total]
            khi, klo = bits.keys_to_pairs(chunk)
            khi, klo = eng._pad(khi), eng._pad(klo)
            active = eng._pad(np.ones(chunk.shape[0], bool))
            start = (eng._dev(eng.router.host_start(khi, klo))
                     if use_router else None)
            with eng._step_mutex:
                res = fn(eng.dsm.pool, eng.dsm.counters, eng._dev(khi),
                         eng._dev(klo), eng.tree._root_addr,
                         eng._dev(active), start)
            for o, r in zip(outs, res):
                o[i:i + total] = r.cpu().numpy()[:chunk.shape[0]]
        return tuple(outs)

    def fill(self, keys) -> dict:
        """Rebuild the table from ``keys`` (uint64, hottest first).  Each
        key is resolved to its live leaf position in one batched pass;
        placement is host-side open addressing, hottest first, within the
        window; a key whose window is full stays uncached (counted).
        -> {"placed", "failed", "resolved"}."""
        keys = np.asarray(keys, np.uint64)[:self.capacity]
        ok, addr, slot, ver, vhi, vlo = self._resolve(keys) \
            if keys.size else ((np.zeros(0, bool),)
                               + (np.zeros(0, np.int32),) * 5)
        khi, klo = bits.keys_to_pairs(keys)
        h = slot_hash_np(khi, klo)
        S, W = self.slots, self.window
        nkhi = np.zeros(S, np.int32)
        nklo = np.zeros(S, np.int32)
        nvhi = np.zeros(S, np.int32)
        nvlo = np.zeros(S, np.int32)
        nver = np.zeros(S, np.int32)
        naddr = np.zeros(S, np.int32)
        nslot = np.zeros(S, np.int32)
        nkeys = np.zeros(S, np.uint64)
        placed = failed = 0
        base = (h & np.uint32(S - 1)).astype(np.int64)
        for i in np.nonzero(ok)[0].tolist():
            for o in range(W):
                j = int((base[i] + o) & (S - 1))
                if nkeys[j] == 0:
                    nkhi[j], nklo[j] = khi[i], klo[i]
                    nvhi[j], nvlo[j] = vhi[i], vlo[i]
                    nver[j], naddr[j], nslot[j] = ver[i], addr[i], slot[i]
                    nkeys[j] = keys[i]
                    placed += 1
                    break
            else:
                failed += 1  # window full of hotter keys: stay uncached
        with self._lock:
            evicted = int(np.setdiff1d(
                self._keys[self._keys != 0], nkeys,
                assume_unique=False).size)
            self.evictions += evicted
            (self._khi, self._klo, self._vhi, self._vlo, self._ver,
             self._addr, self._slot) = (nkhi, nklo, nvhi, nvlo, nver,
                                        naddr, nslot)
            self._keys = nkeys
            self._dirty = True
            self.fills += 1
            self.placement_failures += failed
        return {"placed": placed, "failed": failed,
                "resolved": int(ok.sum())}

    # -- admission (frequency sketch) ----------------------------------------

    def observe(self, keys) -> None:
        """Feed one read batch's keys into the decayed frequency sketch;
        every ``admit_every`` batches rebuild the table from the top
        ``capacity`` keys.  A no-op with ``admit_every == 0``."""
        if self.admit_every <= 0:
            return
        uk, cnt = np.unique(np.asarray(keys, np.uint64),
                            return_counts=True)
        with self._lock:
            f = self._freq
            for k, c in zip(uk.tolist(), cnt.tolist()):
                f[k] = f.get(k, 0.0) + c
            self._observed_batches += 1
            due = self._observed_batches % self.admit_every == 0
            if due:
                # decay and bound the sketch, then admit the top keys
                top = sorted(f.items(), key=lambda kv: -kv[1])
                self._freq = {k: v * 0.5
                              for k, v in top[:4 * self.capacity]}
                cand = np.array([k for k, _ in top[:self.capacity]],
                                np.uint64)
        if due and cand.size:
            self.fill(cand)

    def sketch_stats(self) -> dict:
        """The admission sketch's receipt: batches observed, keys tracked
        and the cadence (zeros in manual-``fill`` mode)."""
        with self._lock:
            return {
                "admit_every": self.admit_every,
                "observed_batches": self._observed_batches,
                "tracked_keys": len(self._freq),
            }

    # -- invalidation ---------------------------------------------------------

    def invalidate_keys(self, keys) -> int:
        """Drop every cached entry whose key is in ``keys`` (the write
        path's hook: these keys' entry versions bump)."""
        keys = np.asarray(keys, np.uint64)
        if keys.size == 0:
            return 0
        with self._lock:
            if self._sidecar:
                # a pin needs no table slot, so drop by key directly
                for k in keys:
                    self._sidecar.pop(int(k), None)
            m = (self._keys != 0) & np.isin(self._keys, keys)
            return self._clear(m)

    def invalidate_pages(self, addrs) -> int:
        """Drop every cached entry resident on the given packed page
        addresses (reclaim, scrub quarantine)."""
        a = np.asarray(list(addrs), np.int64).astype(np.int32)
        if a.size == 0:
            return 0
        with self._lock:
            m = (self._keys != 0) & np.isin(self._addr, a)
            return self._clear(m)

    def flush(self) -> int:
        """Drop everything: degraded entry, recovery and targeted repair
        (the cache is volatile)."""
        with self._lock:
            self._sidecar.clear()
            return self._clear(self._keys != 0)

    def _clear(self, m: np.ndarray) -> int:
        n = int(m.sum())
        if n:
            if self._sidecar:
                # a write to the key bumps its handle: the pin is dead
                for k in self._keys[m]:
                    self._sidecar.pop(int(k), None)
            for a in self._table_host():
                a[m] = 0
            self._keys[m] = 0
            self._dirty = True
            self.invalidations += n
        return n

    # -- payload sidecar ------------------------------------------------------

    def pin_payloads(self, keys, handles, blobs) -> int:
        """Pin gathered payload bytes under (key, heap handle) so the next
        read of the key can skip the heap gather; the handle is the
        staleness token.  -> pins stored; past ``capacity`` the oldest
        pins are evicted first."""
        n = 0
        with self._lock:
            for k, h, b in zip(keys, handles, blobs):
                if b is None:
                    continue
                while len(self._sidecar) >= self.capacity:
                    self._sidecar.pop(next(iter(self._sidecar)))
                    self.evictions += 1
                self._sidecar[int(k)] = (int(h), bytes(b))
                n += 1
            self.sidecar_pins += n
        return n

    def payload_hits(self, keys, handles) -> list:
        """Per position: the pinned bytes when the sidecar holds the key
        under exactly the given live handle, else ``None``.  A key pinned
        under another handle is stale: dropped and counted."""
        out = []
        hits = stale = 0
        with self._lock:
            for k, h in zip(keys, handles):
                ent = self._sidecar.get(int(k))
                if ent is None:
                    out.append(None)
                elif ent[0] == int(h):
                    hits += 1
                    out.append(ent[1])
                else:
                    stale += 1
                    del self._sidecar[int(k)]
                    out.append(None)
            self.sidecar_hits += hits
            self.sidecar_stale += stale
        return out

    def cached_keys(self) -> np.ndarray:
        """The admitted key set (uint64, unordered)."""
        with self._lock:
            return self._keys[self._keys != 0].copy()
