"""Out-of-line value heap: variable-length payloads behind leaf handles
(counterpart of ``sherman_tpu/models/value_heap.py``).

Leaf slots hold fixed 64-bit values.  This module adds a second DSM
region (``DSMConfig.heap_pages_per_node``; ``dsm.heap``) of 1 KB heap
pages carved into size-class slabs of variable-length payloads, while the
leaf value lanes hold versioned handles.  The tree is untouched: a handle
is a 64-bit value to every tree step.

- **Heap page**: words ``[0, 255)`` are the slab region; word 255 is the
  page tag ``TAG_MAGIC | size_class`` written when the page is carved
  (the allocator state can be rebuilt from the region alone).
- **Slab** of class ``c``: ``HEAP_CLASSES[c]`` words; word 0 is the
  header ``(version << 16) | nbytes``, the rest payload (28/60/124/252
  bytes).  The 16-bit version skips 0; ``nbytes == 0`` marks a free slab.
- **Handle** (the leaf value, hi/lo int32 words): ``hi`` the global heap
  row, ``lo`` = ``slab << 24 | class << 20 | version``.  The version is
  the coherence token: a read gathers the slab on the device and checks
  the header's version against the handle's.  A mismatch is a stale
  handle (the slab was freed or rewritten after the descent read the
  leaf): the reader retries through a fresh descent, and a mismatch that
  persists fails typed (:class:`HeapCorruptError`), never a wrong
  payload.
- **Writes** allocate from per-client size-class freelists (carving fresh
  pages node-round-robin when a list runs dry) under free-after-install:
  every record gets a fresh slab, and the superseded slab is freed only
  after the new handle's install succeeded.  A free whose header version
  no longer matches raises :class:`~sherman_tpu_torch.errors.
  DoubleFreeError`.
- **Durability**: slab writes land through ``dsm.heap_write_cells`` and
  are journaled before the ack (``J_HEAP_PUT``/``J_HEAP_FREE`` before the
  engine's ``J_UPSERT``/``J_DELETE``, the apply order), dirty-tracked for
  delta checkpoints and carried by full checkpoints.
- **Scrub** (:meth:`ValueHeap.scrub`): orphan handles (a live leaf handle
  whose slab version disagrees) are counted; leaked slabs (allocated,
  unreferenced) go back on the freelists.

Reads resolve every handle with one ``read_pages_spmd`` over the heap
region (the page-gather kernel; with several nodes, the exchange too).
The counters ``heap.*`` and the ``heap`` pull collector report the work;
the resolve programs are ledgered as ``heap.resolve`` and
``heap.fanout_resolve``.

Not here (ROADMAP.md item 7c): the reshard and the online migration of a
heap tree.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.config import PAGE_WORDS
from sherman_tpu_torch.errors import ConfigError, DoubleFreeError, \
    ShermanError
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.parallel import transport as T
from sherman_tpu_torch.parallel.dsm import read_pages_spmd

__all__ = [
    "HEAP_CLASSES", "HeapFullError", "HeapCorruptError", "ValueHeap",
    "class_for_bytes", "pack_handles", "unpack_handles",
]

# Slab words per size class (word 0 of each slab is the header).
HEAP_CLASSES = (8, 16, 32, 64)
#: heap-page word reserved for the carve-time class tag
TAG_W = PAGE_WORDS - 1
TAG_MAGIC = 0x48450000  # "HE" << 16
#: slab region words per heap page (word TAG_W excluded)
SLAB_REGION_WORDS = TAG_W
#: widest payload any class carries, in words (the resolve's output width)
MAX_PAYLOAD_WORDS = HEAP_CLASSES[-1] - 1

_SLABS_PER_PAGE = tuple(SLAB_REGION_WORDS // w for w in HEAP_CLASSES)
_CLASS_CAP_BYTES = tuple((w - 1) * 4 for w in HEAP_CLASSES)
_VER_MASK = 0xFFFF

_OBS_PUTS = obs.counter("heap.puts")
_OBS_GETS = obs.counter("heap.gets")
_OBS_FREES = obs.counter("heap.frees")
_OBS_CARVES = obs.counter("heap.pages_carved")
_OBS_STALE = obs.counter("heap.stale_retries")
_OBS_ORPHANS = obs.counter("heap.orphan_handles")
_OBS_LEAKS = obs.counter("heap.leaks_reclaimed")
_OBS_DOUBLE = obs.counter("heap.double_frees")


class HeapFullError(ShermanError, RuntimeError):
    """Every node's heap region is carved and the size class's freelists
    are empty: grow ``heap_pages_per_node``."""


class HeapCorruptError(ShermanError, RuntimeError):
    """A handle's slab failed version validation on every retry (a torn
    or corrupt slab): the payload cannot be served."""


def class_for_bytes(n: int) -> int:
    """Smallest size class whose payload capacity fits ``n`` bytes."""
    for c, cap in enumerate(_CLASS_CAP_BYTES):
        if n <= cap:
            return c
    raise ConfigError(
        f"payload of {n} bytes exceeds the largest value-heap class "
        f"({_CLASS_CAP_BYTES[-1]} bytes); chunk the record client-side")


def pack_handles(rows, slabs, clss, vers) -> np.ndarray:
    """(row, slab, class, version) arrays -> uint64 handle values."""
    hi = np.asarray(rows, np.uint64) & np.uint64(0xFFFFFFFF)
    lo = ((np.asarray(slabs, np.uint64) << np.uint64(24))
          | (np.asarray(clss, np.uint64) << np.uint64(20))
          | (np.asarray(vers, np.uint64) & np.uint64(_VER_MASK)))
    return (hi << np.uint64(32)) | lo


def unpack_handles(vals) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """uint64 handles -> (rows, slabs, classes, versions) int64."""
    v = np.asarray(vals, np.uint64)
    rows = (v >> np.uint64(32)).astype(np.int64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return (rows, (lo >> 24) & 0xFF, (lo >> 20) & 0xF, lo & _VER_MASK)


def _header_word(ver: int, nbytes: int) -> int:
    return int(np.uint32(((ver & _VER_MASK) << 16)
                         | (nbytes & 0xFFFF)).view(np.int32))


# ---------------------------------------------------------------------------
# Device-side handle resolution.
# ---------------------------------------------------------------------------

def resolve_rows(heap, vhi, vlo, active, *, hcfg):
    """Resolve handle pairs (node-major ``[N*R]`` int32) to payload rows
    on the device.  -> (payload ``[N*R, MAX_PAYLOAD_WORDS]`` int32, nbytes
    ``[N*R]`` int32, ver_ok ``[N*R]`` bool).

    One heap-page gather a row (``read_pages_spmd`` over the heap region,
    the descent's page-read path), then a fixed-width slab slice and the
    header's version check.  Payload words past the record's length are
    zeroed, so results are deterministic."""
    Hpp = hcfg.pages_per_node
    row = vhi                               # global heap row
    slab = (vlo >> 24) & 0xFF
    cls = (vlo >> 20) & 0xF
    hver = vlo & _VER_MASK
    addr = bits.make_addr(row // Hpp, row % Hpp)
    pages, ok = read_pages_spmd(heap, addr, cfg=hcfg, active=active)
    widths = torch.tensor(HEAP_CLASSES, dtype=torch.int32,
                          device=heap.device)
    sw = widths[cls.clamp(0, len(HEAP_CLASSES) - 1).long()]
    off = slab * sw
    hdr = pages.gather(1, off.clamp(0, PAGE_WORDS - 1)[:, None].long())[:, 0]
    # the arithmetic shift of a version >= 0x8000 sign-fills: the mask
    # keeps the 16 version bits
    sver = (hdr >> 16) & _VER_MASK
    nbytes = hdr & 0xFFFF
    ver_ok = ok & (sver == hver) & (hver != 0)
    colw = torch.arange(MAX_PAYLOAD_WORDS, dtype=torch.int32,
                        device=heap.device)
    idx = (off[:, None] + 1 + colw[None, :]).clamp(0, PAGE_WORDS - 1)
    payload = pages.gather(1, idx.long())
    nwords = (nbytes + 3) >> 2
    keep = (ver_ok[:, None] & (colw[None, :] < nwords[:, None])
            & (colw[None, :] < (sw - 1)[:, None]))
    payload = torch.where(keep, payload, 0)
    nbytes = torch.where(ver_ok, nbytes, 0)
    return payload, nbytes, ver_ok


# ---------------------------------------------------------------------------
# The heap itself.
# ---------------------------------------------------------------------------

class ValueHeap:
    """Slab allocator and payload API over the DSM's heap region (see the
    module docstring).  One writer a heap (the journaled engine's shape);
    ``client_id`` partitions the freelists."""

    def __init__(self, eng, *, default_client: int = 0):
        self.eng = eng
        self.dsm = eng.dsm
        self.cfg = eng.cfg
        if self.dsm.heap is None:
            raise ConfigError(
                "ValueHeap needs a DSM with heap_pages_per_node > 0 "
                "(SHERMAN_VALUE_HEAP)")
        self.Hpp = self.cfg.heap_pages_per_node
        self.N = self.cfg.machine_nr
        self.rows_total = self.N * self.Hpp
        self.default_client = int(default_client)
        # allocator state (host; rebuild() reconstructs it from the
        # region): per-page class (-1 = uncarved), per-slab version
        # mirror, per-(client, class) free slab sets, per-node bump mark
        self._page_cls = np.full(self.rows_total, -1, np.int8)
        self._ver = np.zeros((self.rows_total, max(_SLABS_PER_PAGE)),
                             np.uint16)
        self._free: dict[tuple[int, int], set] = {}
        self._next_page = np.zeros(self.N, np.int64)
        # uncarved pages below a node's bump mark (journal replay may
        # carve past them; the bump pointer alone would strand them)
        self._spare_pages: list[int] = []
        self._rr_node = 0
        self._lock = threading.Lock()
        self._resolve_cache: dict = {}
        self._fused_cache: dict = {}
        self.puts = 0
        self.gets = 0
        self.frees = 0
        self.stale_retries = 0
        self.pages_carved = 0
        eng.value_heap = self
        ref = weakref.ref(self)
        obs.register_collector(
            "heap", lambda: (lambda h: h._collect() if h is not None
                             else {})(ref()))

    # -- accounting (plain adds on the hot paths) -----------------------------

    def _note_put(self, n: int) -> None:
        self.puts += n

    def _note_get(self, n: int) -> None:
        self.gets += n

    def _note_free(self, n: int) -> None:
        self.frees += n

    def _collect(self) -> dict:
        with self._lock:
            free = sum(len(s) for s in self._free.values())
        return {
            "puts": float(self.puts),
            "gets": float(self.gets),
            "frees": float(self.frees),
            "stale_retries": float(self.stale_retries),
            "pages_carved": float(self.pages_carved),
            "free_slabs": float(free),
        }

    def stats(self) -> dict:
        with self._lock:
            carved = int((self._page_cls >= 0).sum())
            free = int(sum(len(s) for s in self._free.values()))
        return {
            "pages_total": self.rows_total,
            "pages_carved": carved,
            "free_slabs": free,
            "puts": self.puts,
            "gets": self.gets,
            "frees": self.frees,
            "stale_retries": self.stale_retries,
        }

    # -- allocation ----------------------------------------------------------

    def _carve(self, client: int, cls: int, tags: list | None = None) -> None:
        """Carve one fresh heap page into class-``cls`` slabs for
        ``client`` (spare pages first, then node-round-robin bump; typed
        HeapFullError when every node's region is used).  The page's tag
        is written now, or appended to ``tags`` as ``(row, value)`` for
        the caller's own heap write (the same cells land either way)."""
        row = None
        while self._spare_pages:
            cand = self._spare_pages.pop()
            if self._page_cls[cand] < 0:  # replay may have carved it
                row = cand
                break
        if row is None:
            for _ in range(self.N):
                node = self._rr_node
                self._rr_node = (self._rr_node + 1) % self.N
                if self._next_page[node] < self.Hpp:
                    page = int(self._next_page[node])
                    self._next_page[node] += 1
                    row = node * self.Hpp + page
                    break
        if row is None:
            raise HeapFullError(
                f"value heap exhausted ({self.rows_total} pages "
                f"carved; class {cls} freelist empty): grow "
                "heap_pages_per_node")
        self._page_cls[row] = cls
        if tags is None:
            self.dsm.heap_write_cells(
                [row], [TAG_W], [np.int32(TAG_MAGIC | cls)])
        else:
            tags.append((row, TAG_MAGIC | cls))
        self._free.setdefault((client, cls), set()).update(
            (row, s) for s in range(_SLABS_PER_PAGE[cls]))
        self.pages_carved += 1
        _OBS_CARVES.inc()

    def _alloc(self, client: int, cls: int, count: int,
               tags: list | None = None) -> list:
        """Pop ``count`` free (row, slab) pairs of class ``cls`` (page
        tags of fresh carves into ``tags``, see :meth:`_carve`)."""
        free = self._free.setdefault((client, cls), set())
        out = []
        while len(out) < count:
            if not free:
                self._carve(client, cls, tags)
            out.append(free.pop())
        return out

    # -- payload <-> words ---------------------------------------------------

    @staticmethod
    def _payload_words(b: bytes) -> np.ndarray:
        pad = (-len(b)) % 4
        return np.frombuffer(bytes(b) + b"\x00" * pad, "<i4").copy()

    @staticmethod
    def _words_to_bytes(words: np.ndarray, nbytes: int) -> bytes:
        return np.asarray(words, np.int32).tobytes()[:nbytes]

    @staticmethod
    def _rows_to_bytes(payload: np.ndarray, nbytes: np.ndarray, rows,
                       out: list) -> None:
        """``out[i]`` = the first ``nbytes[i]`` bytes of payload row ``i``
        for every ``i`` in ``rows``: one copy of the block, then a slice a
        record."""
        raw = np.ascontiguousarray(payload, np.int32).tobytes()
        w = payload.shape[1] * 4
        nb = np.asarray(nbytes).tolist()
        for i in rows:
            out[i] = raw[i * w: i * w + nb[i]]

    # -- writes --------------------------------------------------------------

    def put(self, keys, payloads, *, client: int | None = None) -> dict:
        """Upsert variable-length ``payloads`` (bytes) under uint64
        ``keys``; a key repeated in one batch: the last one wins.  ->
        {applied, allocated, freed, lock_timeouts, lock_timeout_keys,
        handle_map} (``handle_map``: each applied key's new handle).

        Free-after-install: every record gets a fresh slab (write the
        payload, journal ``J_HEAP_PUT``, install the handles through the
        engine's upsert); a superseded slab is freed only after its key's
        install succeeded, so an install that fails (``ST_LOCK_TIMEOUT``)
        leaves the old record readable.  For such keys the fresh slabs
        are freed and a journal record re-asserting the old state (old
        handle, or a delete for a fresh key) is appended, so a replay
        converges to the live outcome."""
        client = self.default_client if client is None else int(client)
        self.eng._require_writable()
        keys = np.asarray(keys, np.uint64)
        if keys.size != len(payloads):
            raise ConfigError("put needs one payload per key")
        if keys.size == 0:
            return {"applied": 0, "allocated": 0, "freed": 0,
                    "lock_timeouts": 0, "lock_timeout_keys": [],
                    "handle_map": {}}
        # dedup keeping the LAST occurrence (upsert semantics)
        _, last_idx = np.unique(keys[::-1], return_index=True)
        order = np.sort(keys.size - 1 - last_idx)
        ukeys = keys[order]
        upay = [bytes(payloads[i]) for i in order]
        old_vals, old_found = self.eng.search(ukeys)
        with self._lock:
            handles, rows_w, woffs_w, vals_w, old_live = \
                self._plan_puts(client, ukeys, upay, old_vals)
        self.dsm.heap_write_cells(rows_w, woffs_w, vals_w)
        self._journal_heap_put(ukeys, handles, upay)
        stats = self.eng.insert(ukeys, handles)
        to_keys = np.asarray(stats["lock_timeout_keys"], np.uint64) \
            if stats["lock_timeouts"] else np.zeros(0, np.uint64)
        failed = np.isin(ukeys, to_keys)
        ok = ~failed
        # free AFTER install: the superseded slabs of the keys that applied
        old_freeable = old_live & ok & old_found
        if old_freeable.any():
            self.free_handles(ukeys[old_freeable],
                              old_vals[old_freeable], client=client)
        # ...and the never-referenced fresh slabs of the keys that did not,
        # with the compensating journal records
        if failed.any():
            self.free_handles(ukeys[failed], handles[failed],
                              client=client)
            j = self.eng.journal
            if j is not None:
                from sherman_tpu_torch.utils import journal as J
                f_old = failed & old_found
                if f_old.any():
                    j.append(J.J_UPSERT, ukeys[f_old], old_vals[f_old])
                f_fresh = failed & ~old_found
                if f_fresh.any():
                    j.append(J.J_DELETE, ukeys[f_fresh])
        self._note_put(int(ukeys.size))
        _OBS_PUTS.inc(int(ukeys.size))
        return {"applied": int(stats["applied"]),
                "allocated": int(ukeys.size),
                "freed": int(old_freeable.sum()),
                "lock_timeouts": int(failed.sum()),
                "lock_timeout_keys": ukeys[failed].tolist(),
                "handle_map": {int(k): int(h) for k, h in
                               zip(ukeys[ok], handles[ok])}}

    def _live_mask(self, rows, slabs, clss, vers) -> np.ndarray:
        """Per handle (int64 arrays of its fields): True iff it names a
        live slab this allocator owns.  Guards against treating an inline
        value (from a tree loaded before the heap attached) as a
        handle."""
        spp = np.asarray(_SLABS_PER_PAGE, np.int64)
        ok = ((rows >= 0) & (rows < self.rows_total) & (clss >= 0)
              & (clss < len(HEAP_CLASSES)) & (slabs >= 0) & (vers != 0))
        c = np.where(ok, clss, 0)
        ok &= slabs < spp[c]
        r = np.where(ok, rows, 0)
        s = np.where(ok, slabs, 0)
        return (ok & (self._page_cls[r] == c)
                & (self._ver[r, s].astype(np.int64) == vers))

    def _plan_puts(self, client, ukeys, upay, old_vals):
        """Under the allocator lock: one fresh slab a record, its version
        bumped, and the cell-scatter arrays (the tags of freshly carved
        pages first, then each record's header and padded payload).  Old
        slabs are untouched (free-after-install).  -> (handles u64 [n],
        rows, woffs, vals, old_live bool [n])."""
        n = ukeys.size
        old_live = self._live_mask(*unpack_handles(old_vals))
        lens = np.fromiter((len(b) for b in upay), np.int64, n)
        caps = np.asarray(_CLASS_CAP_BYTES, np.int64)
        clss = np.searchsorted(caps, lens)
        if n and int(lens.max()) > caps[-1]:
            class_for_bytes(int(lens.max()))        # raises ConfigError
        # allocate class by class, in the order the records first use
        # them, each class's records in order
        rows = np.zeros(n, np.int64)
        slabs = np.zeros(n, np.int64)
        tags: list = []
        try:
            for cls in dict.fromkeys(clss.tolist()):
                idxs = np.nonzero(clss == cls)[0]
                got = self._alloc(client, cls, idxs.size, tags)
                rows[idxs] = [r for r, _ in got]
                slabs[idxs] = [sl for _, sl in got]
        except HeapFullError:
            # the pages carved before the heap ran out stay carved
            if tags:
                t = np.asarray(tags, np.int64)
                self.dsm.heap_write_cells(t[:, 0], np.full(len(tags), TAG_W),
                                          t[:, 1])
            raise
        vers = (self._ver[rows, slabs].astype(np.int64) + 1) & _VER_MASK
        vers[vers == 0] = 1
        self._ver[rows, slabs] = vers.astype(np.uint16)
        handles = ((rows.astype(np.uint64) << np.uint64(32))
                   | (slabs.astype(np.uint64) << np.uint64(24))
                   | (clss.astype(np.uint64) << np.uint64(20))
                   | vers.astype(np.uint64))
        # header + padded payload words a record: the headers at each
        # record's first word, the payload words in order in between
        m_arr = 1 + (lens + 3) // 4
        total = int(m_arr.sum())
        starts = np.cumsum(m_arr) - m_arr
        vals = np.empty(total, np.int32)
        vals[starts] = ((vers << 16) | (lens & 0xFFFF)).astype(
            np.uint32).view(np.int32)
        is_pay = np.ones(total, bool)
        is_pay[starts] = False
        vals[is_pay] = np.frombuffer(
            b"".join(b + b"\x00" * ((-len(b)) % 4) for b in upay), "<i4")
        rec_offs = slabs * np.asarray(HEAP_CLASSES, np.int64)[clss]
        rows_arr = np.repeat(rows, m_arr)
        woffs = (np.repeat(rec_offs, m_arr)
                 + np.arange(total, dtype=np.int64)
                 - np.repeat(starts, m_arr)).astype(np.int32)
        if tags:
            t = np.asarray(tags, np.int64)
            rows_arr = np.concatenate([t[:, 0], rows_arr])
            woffs = np.concatenate([np.full(len(tags), TAG_W, np.int32),
                                    woffs])
            vals = np.concatenate([t[:, 1].astype(np.int32), vals])
        return handles, rows_arr, woffs, vals, old_live

    def remove(self, keys, *, client: int | None = None) -> np.ndarray:
        """Delete ``keys`` and free their slabs.  -> found [n] (in the
        input order; duplicates share one delete)."""
        client = self.default_client if client is None else int(client)
        self.eng._require_writable()
        keys = np.asarray(keys, np.uint64)
        if keys.size == 0:
            return np.zeros(0, bool)
        uk = np.unique(keys)
        vals, found = self.eng.search(uk)
        out_u = self.eng.delete(uk)
        if found.any():
            live = found & self._live_mask(*unpack_handles(vals))
            if live.any():
                self.free_handles(uk[live], vals[live], client=client)
        return out_u[np.searchsorted(uk, keys)]

    def free_handles(self, keys, handles, *,
                     client: int | None = None) -> int:
        """Return slabs to the freelist, bumping their header versions so
        stale handles miss.  A handle whose slab is not live under it was
        already freed (or rewritten, or is malformed):
        :class:`~sherman_tpu_torch.errors.DoubleFreeError`."""
        client = self.default_client if client is None else int(client)
        keys = np.asarray(keys, np.uint64)
        handles = np.asarray(handles, np.uint64)
        rows, slabs, clss, vers = unpack_handles(handles)
        with self._lock:
            # the full liveness guard: a wrong-class or version-0 handle
            # would compute an offset inside another live slab
            dead = np.nonzero(~self._live_mask(rows, slabs, clss, vers))[0]
            if dead.size:
                _OBS_DOUBLE.inc()
                raise DoubleFreeError(
                    f"free of handle {int(handles[dead[0]]):#x}: slab "
                    "not live under this handle (already freed, "
                    "rewritten, or malformed)")
            nv = ((vers.astype(np.int64) + 1) & _VER_MASK)
            nv = np.where(nv == 0, 1, nv)
            self._ver[rows, slabs] = nv.astype(np.uint16)
            for i in range(handles.size):
                self._free.setdefault(
                    (client, int(clss[i])), set()).add(
                    (int(rows[i]), int(slabs[i])))
            woffs_w = (slabs * np.take(
                np.asarray(HEAP_CLASSES, np.int64), clss)).astype(np.int32)
            vals_w = (((nv & _VER_MASK) << 16).astype(np.uint32)
                      ).view(np.int32)
        if handles.size:
            self.dsm.heap_write_cells(rows, woffs_w, vals_w)
            self._journal_heap_free(keys, handles)
        self._note_free(int(handles.size))
        _OBS_FREES.inc(int(handles.size))
        return int(handles.size)

    # -- journaling ----------------------------------------------------------

    def _journal_heap_put(self, keys, handles, payloads) -> None:
        j = self.eng.journal
        if j is not None and keys.size:
            from sherman_tpu_torch.utils import journal as J
            j.append_heap(J.J_HEAP_PUT, keys, handles, payloads)

    def _journal_heap_free(self, keys, handles) -> None:
        j = self.eng.journal
        if j is not None and np.asarray(handles).size:
            from sherman_tpu_torch.utils import journal as J
            j.append(J.J_HEAP_FREE, keys, handles)

    def replay_put(self, keys, handles, payloads) -> None:
        """Journal replay: rewrite each record's slab at its recorded
        address with its recorded version (idempotent; a later record
        reusing the slab overwrites it), then install the record's
        handles through the engine.  The install must not wait for the
        op's own ``J_UPSERT``: a crash between the two appends would
        leave the leaf's old handle version over a rewritten slab, and
        the acked record unreadable."""
        handles = np.asarray(handles, np.uint64)
        rows, slabs, clss, vers = unpack_handles(handles)
        rows_w, woffs_w, vals_w = [], [], []
        with self._lock:
            for i in range(handles.size):
                row, slab, cls = int(rows[i]), int(slabs[i]), int(clss[i])
                ver = int(vers[i])
                if self._page_cls[row] < 0:
                    self._page_cls[row] = cls
                    node = row // self.Hpp
                    new_hw = row % self.Hpp + 1
                    if new_hw > self._next_page[node]:
                        # skipped pages become carvable spares (_carve
                        # re-checks that they stayed uncarved)
                        base = node * self.Hpp
                        self._spare_pages.extend(
                            base + p
                            for p in range(int(self._next_page[node]),
                                           new_hw - 1)
                            if self._page_cls[base + p] < 0)
                        self._next_page[node] = new_hw
                    rows_w.append(np.asarray([row], np.int64))
                    woffs_w.append(np.asarray([TAG_W], np.int32))
                    vals_w.append(np.asarray([TAG_MAGIC | cls],
                                             np.int32))
                self._ver[row, slab] = ver
                self._free.get((self.default_client, cls),
                               set()).discard((row, slab))
                b = payloads[i]
                off = slab * HEAP_CLASSES[cls]
                words = self._payload_words(b)
                m = words.size + 1
                rows_w.append(np.full(m, row, np.int64))
                woffs_w.append(off + np.arange(m, dtype=np.int32))
                vals_w.append(np.concatenate(
                    [np.asarray([_header_word(ver, len(b))], np.int32),
                     words]))
        if rows_w:
            self.dsm.heap_write_cells(np.concatenate(rows_w),
                                      np.concatenate(woffs_w),
                                      np.concatenate(vals_w))
        if handles.size:
            # replay runs with the journal detached, so this install
            # never journals itself
            self.eng.insert(np.asarray(keys, np.uint64), handles)

    def replay_free(self, keys, handles) -> None:
        """Journal replay of frees, conditional on the version
        (idempotent): a slab already past the recorded version stays."""
        handles = np.asarray(handles, np.uint64)
        rows, slabs, clss, vers = unpack_handles(handles)
        rows_w, woffs_w, vals_w = [], [], []
        with self._lock:
            for i in range(handles.size):
                row, slab, cls = int(rows[i]), int(slabs[i]), int(clss[i])
                if int(self._ver[row, slab]) != int(vers[i]):
                    continue
                nv = (int(vers[i]) + 1) if ((int(vers[i]) + 1)
                                            & _VER_MASK) else 1
                self._ver[row, slab] = nv
                self._free.setdefault((self.default_client, cls),
                                      set()).add((row, slab))
                rows_w.append(row)
                woffs_w.append(slab * HEAP_CLASSES[cls])
                vals_w.append(_header_word(nv, 0))
        if rows_w:
            self.dsm.heap_write_cells(rows_w, woffs_w, vals_w)

    # -- reads ---------------------------------------------------------------

    def _hcfg(self, capacity: int):
        """The heap region's ``DSMConfig`` for ``read_pages_spmd``: pages a
        node = heap pages, and a step capacity that covers every row
        going to one node."""
        return dataclasses.replace(
            self.cfg, pages_per_node=self.Hpp, heap_pages_per_node=0,
            step_capacity=max(self.cfg.step_capacity, capacity))

    def _get_resolve(self, width: int):
        """The resolve over ``[width]`` handle pairs: ``fn(heap, vhi, vlo,
        active) -> (payload, nbytes, ver_ok)``."""
        fn = self._resolve_cache.get(width)
        if fn is None:
            hcfg = self._hcfg(width)

            def fn(heap, vhi, vlo, active):
                return resolve_rows(heap, vhi, vlo, active, hcfg=hcfg)

            fn = DEV.wrap_program("heap.resolve", fn)
            self._resolve_cache[width] = fn
        return fn

    def _get_fused(self, iters: int, n_pad: int):
        """The engine's combined-search fan-out (search over the unique
        rows, then every client's answer), then the resolve of the
        fanned-out handles: ``fn(pool, counters, heap, khi, klo, root,
        active, start, inv) -> (done, found, vhi, vlo, payload, nbytes,
        ver_ok)``, ``counters`` updated in place."""
        fn = self._fused_cache.get((iters, n_pad))
        if fn is None:
            from sherman_tpu_torch.models.batched import search_routed_spmd
            N = self.N
            cfg = self.cfg
            hcfg = self._hcfg(n_pad // N)

            def fn(pool, counters, heap, khi, klo, root, active, start,
                   inv):
                done, found, vhi, vlo = search_routed_spmd(
                    pool, counters, khi, klo, root, active, start, cfg=cfg,
                    iters=iters)
                ans = torch.stack([found.to(torch.int32), vhi, vlo], dim=1)
                if N > 1:
                    ans = T.gather_rows(ans.view(N, -1, 3))
                out = ans[inv.clamp(0, ans.shape[0] - 1)]
                found_c = out[:, 0] != 0
                vhi_c, vlo_c = out[:, 1], out[:, 2]
                payload, nbytes, ver_ok = resolve_rows(
                    heap, vhi_c, vlo_c, found_c, hcfg=hcfg)
                return done, found_c, vhi_c, vlo_c, payload, nbytes, ver_ok

            fn = DEV.wrap_program("heap.fanout_resolve", fn)
            self._fused_cache[(iters, n_pad)] = fn
        return fn

    def resolve_u64(self, values, found):
        """Resolve uint64 handle values on the device -> (payload words
        ``[n, MAX_PAYLOAD_WORDS]``, nbytes ``[n]``, ver_ok ``[n]``).  The
        width is a power-of-two multiple of ``256 * machine_nr``, so the
        set of shapes stays bounded (and sealable)."""
        values = np.asarray(values, np.uint64)
        found = np.asarray(found, bool)
        n = values.size
        if n == 0:
            return (np.zeros((0, MAX_PAYLOAD_WORDS), np.int32),
                    np.zeros(0, np.int32), np.zeros(0, bool))
        width = 256 * self.N
        while width < n:
            width *= 2
        vhi, vlo = bits.keys_to_pairs(values)
        pv = np.zeros(width, np.int32)
        pl = np.zeros(width, np.int32)
        pa = np.zeros(width, bool)
        pv[:n], pl[:n], pa[:n] = vhi, vlo, found
        fn = self._get_resolve(width)
        d = self.eng._dev
        with self.eng._step_mutex:
            payload, nbytes, ver_ok = fn(self.dsm.heap, d(pv), d(pl), d(pa))
        return (payload[:n].cpu().numpy(), nbytes[:n].cpu().numpy(),
                ver_ok[:n].cpu().numpy())

    def resolve_host(self, values, found) -> tuple[list, np.ndarray]:
        """The host reference resolver (numpy over a copy of the heap):
        the oracle the device path is held to.  -> (payloads
        list[bytes | None], ver_ok [n])."""
        values = np.asarray(values, np.uint64)
        found = np.asarray(found, bool)
        heap = self.dsm.heap_snapshot()
        rows, slabs, clss, vers = unpack_handles(values)
        out: list = []
        ver_ok = np.zeros(values.size, bool)
        for i in range(values.size):
            if not found[i]:
                out.append(None)
                continue
            row, slab, cls = int(rows[i]), int(slabs[i]), int(clss[i])
            if not (0 <= row < heap.shape[0]
                    and cls < len(HEAP_CLASSES)
                    and slab < _SLABS_PER_PAGE[cls]):
                out.append(None)
                continue
            off = slab * HEAP_CLASSES[cls]
            hdr = int(np.uint32(np.int64(heap[row, off]) & 0xFFFFFFFF))
            if (hdr >> 16) != int(vers[i]) or int(vers[i]) == 0:
                out.append(None)
                continue
            nbytes = hdr & 0xFFFF
            nwords = (nbytes + 3) // 4
            out.append(self._words_to_bytes(
                heap[row, off + 1: off + 1 + nwords], nbytes))
            ver_ok[i] = True
        return out, ver_ok

    def get(self, keys, *, _max_retries: int = 3):
        """Payloads of uint64 ``keys``: the descent fan-out and the handle
        gather in one call (router attached), stale handles revalidated
        through fresh descents.  -> (payloads list[bytes | None], found
        [n])."""
        keys = np.asarray(keys, np.uint64)
        n = keys.size
        self._note_get(n)
        _OBS_GETS.inc(int(n))
        if n == 0:
            return [], np.zeros(0, bool)
        vals, found, payload, nbytes, ver_ok = self._read_once(keys)
        found = np.array(found)
        out: list = [None] * n
        self._rows_to_bytes(payload, nbytes,
                            np.nonzero(found & ver_ok)[0].tolist(), out)
        bad = found & ~ver_ok
        tries = 0
        while bad.any():
            if tries >= _max_retries:
                raise HeapCorruptError(
                    f"{int(bad.sum())} handle(s) failed slab version "
                    f"validation after {tries} revalidation retries "
                    "(torn or corrupt slab): refusing to serve a "
                    "payload the version token cannot certify")
            if tries:
                # back off: a read racing an overwrite resolves once the
                # writer's install lands
                time.sleep(0.0005 * tries)
            tries += 1
            self.stale_retries += int(bad.sum())
            _OBS_STALE.inc(int(bad.sum()))
            # a fresh descent re-reads the leaf (the handle may have
            # moved under an overwrite or a free)
            vals2, found2 = self.eng.search(keys[bad])
            pay2, nb2, ok2 = self.resolve_u64(vals2, found2)
            idx = np.nonzero(bad)[0]
            for k, i in enumerate(idx):
                if not found2[k]:
                    out[i] = None
                    found[i] = False
                    bad[i] = False
                elif ok2[k]:
                    out[i] = self._words_to_bytes(pay2[k], int(nb2[k]))
                    bad[i] = False
        return out, found

    def _read_once(self, keys):
        """One combined read: the fused fan-out and resolve with the
        router attached; otherwise (or with the hot-key tier attached, so
        that its hits resolve too) ``search_combined`` and the separate
        resolve."""
        eng = self.eng
        uk, inv = np.unique(keys, return_inverse=True)
        use_fused = (eng.router is not None and eng.leaf_cache is None
                     and 0 < uk.size <= eng.total)
        if not use_fused:
            vals, found = eng.search_combined(keys)
            payload, nbytes, ver_ok = self.resolve_u64(vals, found)
            return vals, found, payload, nbytes, ver_ok
        khi, klo = bits.keys_to_pairs(uk)
        khi, klo = eng._pad(khi), eng._pad(klo)
        active = eng._pad(np.ones(uk.size, bool))
        n = keys.size
        # the client width in quanta, so varying request counts reuse
        # one shape; pad rows fan out unique row 0 and are cut off
        quantum = 8192 * self.N
        n_pad = -(-n // quantum) * quantum
        inv_p = np.zeros(n_pad, np.int64)
        inv_p[:n] = inv
        fn = self._get_fused(eng._iters(), n_pad)
        d = eng._dev
        start = d(eng.router.host_start(khi, klo))
        with eng._step_mutex:
            res = fn(eng.dsm.pool, eng.dsm.counters, self.dsm.heap, d(khi),
                     d(klo), eng.tree._root_addr, d(active), start,
                     d(inv_p))
        done, found, vhi, vlo, payload, nbytes, ver_ok = (
            t.cpu().numpy() for t in res)
        if not bool(done[:uk.size].all()):
            # straggler rescue (stale router seeds, growth): the host
            # fan-out path reads and resolves everything again
            vals, found = eng.search_combined(keys)
            payload, nbytes, ver_ok = self.resolve_u64(vals, found)
            return vals, found, payload, nbytes, ver_ok
        vals = bits.pairs_to_keys(vhi[:n], vlo[:n])
        return vals, found[:n], payload[:n], nbytes[:n], ver_ok[:n]

    def scan(self, ranges):
        """Range scans with payloads (the YCSB-E path): one
        ``range_query_many`` walk for every range, then one device
        resolve of every hit's handle.  -> list of (keys uint64 [m],
        payloads list[bytes]) a range."""
        res = self.eng.range_query_many(ranges)
        all_vals = np.concatenate([v for _, v in res]) if res \
            else np.zeros(0, np.uint64)
        if all_vals.size == 0:
            return [(k, []) for k, _ in res]
        payload, nbytes, ver_ok = self.resolve_u64(
            all_vals, np.ones(all_vals.size, bool))
        flat: list = [None] * all_vals.size
        self._rows_to_bytes(payload, nbytes, np.nonzero(ver_ok)[0].tolist(),
                            flat)
        out = []
        off = 0
        for keys, vals in res:
            m = vals.size
            pay = flat[off:off + m]
            for i in np.nonzero(~ver_ok[off:off + m])[0].tolist():
                # a stale handle mid-scan: revalidate this key alone
                p, f = self.get(keys[i:i + 1])
                pay[i] = p[0] if f[0] else b""
            out.append((keys, pay))
            off += m
        return out

    # -- scrub / rebuild -----------------------------------------------------

    def live_handles(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys, handle values) of every live leaf entry: the scrub's
        reference set (one full-range scan)."""
        res = self.eng.range_query_many([(C.KEY_MIN, C.KEY_POS_INF)])
        return res[0]

    def scrub(self, repair: bool = True) -> dict:
        """Audit the heap region against the live tree: orphan handles (a
        live leaf handle whose slab header disagrees: damage) are counted
        and returned; leaked slabs (allocated, no handle references them)
        go back on the freelist when ``repair``.  -> {orphans,
        orphan_keys, leaked, checked}."""
        keys, vals = self.live_handles()
        rows, slabs, clss, vers = unpack_handles(vals)
        heap = self.dsm.heap_snapshot()
        referenced = set()
        orphans = []
        for i in range(vals.size):
            row, slab, cls = int(rows[i]), int(slabs[i]), int(clss[i])
            referenced.add((row, slab))
            off = slab * HEAP_CLASSES[cls]
            hdr = int(np.uint32(np.int64(heap[row, off]) & 0xFFFFFFFF))
            if (hdr >> 16) != int(vers[i]):
                orphans.append(int(keys[i]))
        leaked = []
        for row in np.nonzero(self._page_cls >= 0)[0]:
            cls = int(self._page_cls[row])
            for slab in range(_SLABS_PER_PAGE[cls]):
                off = slab * HEAP_CLASSES[cls]
                hdr = int(np.uint32(np.int64(heap[row, off])
                                    & 0xFFFFFFFF))
                if (hdr & 0xFFFF) and (int(row), slab) not in referenced:
                    leaked.append((int(row), slab, cls, hdr >> 16))
        if repair and leaked:
            rows_w, woffs_w, vals_w = [], [], []
            with self._lock:
                for row, slab, cls, ver in leaked:
                    nv = (ver + 1) if ((ver + 1) & _VER_MASK) else 1
                    self._ver[row, slab] = nv
                    self._free.setdefault((self.default_client, cls),
                                          set()).add((row, slab))
                    rows_w.append(row)
                    woffs_w.append(slab * HEAP_CLASSES[cls])
                    vals_w.append(_header_word(nv, 0))
            self.dsm.heap_write_cells(rows_w, woffs_w, vals_w)
            _OBS_LEAKS.inc(len(leaked))
        if orphans:
            _OBS_ORPHANS.inc(len(orphans))
        return {"orphans": len(orphans), "orphan_keys": orphans[:16],
                "leaked": len(leaked),
                "checked": int(vals.size)}

    def rebuild(self) -> dict:
        """Reconstruct the allocator state from the heap region alone (the
        restore and recover path): page tags -> the carve map, slab
        headers -> the version mirror and freelists (``nbytes == 0`` slabs
        are free), bump marks from each node's carved high-water, with
        uncarved holes below it kept as spare pages."""
        heap = self.dsm.heap_snapshot()
        with self._lock:
            self._page_cls[:] = -1
            self._ver[:] = 0
            self._free.clear()
            self._next_page[:] = 0
            self._spare_pages = []
            tags = heap[:, TAG_W].view(np.uint32)
            carved = (tags & np.uint32(0xFFFF0000)) == np.uint32(TAG_MAGIC)
            rows_c = np.nonzero(carved)[0]
            cls_c = (tags[rows_c] & np.uint32(0xF)).astype(np.int64)
            keep = cls_c < len(HEAP_CLASSES)
            rows_c, cls_c = rows_c[keep], cls_c[keep]
            self._page_cls[rows_c] = cls_c
            np.maximum.at(self._next_page, rows_c // self.Hpp,
                          rows_c % self.Hpp + 1)
            # the free slabs of each class in (row, slab) order: the
            # insertion order of a page-by-page walk, and the freelists'
            # keys in the order that walk first meets them
            free_of = []
            for cls in range(len(HEAP_CLASSES)):
                r = rows_c[cls_c == cls]
                offs = np.arange(_SLABS_PER_PAGE[cls]) * HEAP_CLASSES[cls]
                hdr = heap[r[:, None], offs[None, :]].view(np.uint32)
                self._ver[r, :offs.size] = (hdr >> np.uint32(16)) \
                    & np.uint32(_VER_MASK)
                fr, fs = np.nonzero((hdr & np.uint32(0xFFFF)) == 0)
                if fr.size:
                    free_of.append((int(r[fr[0]]), cls,
                                    list(zip(r[fr].tolist(),
                                             fs.tolist()))))
            for _, cls, slabs in sorted(free_of):
                self._free.setdefault((self.default_client, cls),
                                      set()).update(slabs)
            # carvable holes below each node's bump mark
            for node in range(self.N):
                hw = int(self._next_page[node])
                base = node * self.Hpp
                seg = self._page_cls[base: base + hw]
                self._spare_pages.extend(
                    int(base + p) for p in np.nonzero(seg < 0)[0])
            carved_n = int((self._page_cls >= 0).sum())
            self.pages_carved = carved_n
        return {"pages_carved": carved_n,
                "free_slabs": int(sum(len(s)
                                      for s in self._free.values()))}

    def detach(self) -> None:
        obs.get_registry().unregister_collector("heap")
        self.eng.value_heap = None
