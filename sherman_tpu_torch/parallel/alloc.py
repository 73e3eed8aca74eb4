"""Remote-memory allocation: chunk-grain directory service + client bumps
(the port's copy of ``sherman_tpu/parallel/alloc.py``).

Three cooperating pieces, mirroring the reference:

- :class:`GlobalAllocator` — per memory node, owned by its directory: hands
  out fixed-size chunks of the node's pool partition, bump-scan, no reuse
  (``GlobalAllocator.h:31-50``; 32 MB chunks, ``Common.h:80``).
- :class:`Directory` — the per-node memory-node agent serving MALLOC / FREE
  / NEW_ROOT (``Directory.cpp:60-92``).  In single-process SPMD the "RPC"
  is a method call; the interface is kept RPC-shaped (explicit request
  types) so a multi-host build can put a real host service behind it.
- :class:`LocalAllocator` — per client thread: bump-allocates pages inside
  leased chunks, round-robining target nodes per allocation the way
  ``DSM::alloc`` round-robins its chunk leases (``DSM.h:200-221``,
  ``LocalAllocator.h:21-43``).  ``free`` is a no-op, as in the reference
  (``DSM.h:226``); the engine's empty-leaf reclaim returns pages through
  :meth:`GlobalAllocator.reclaim` instead, and page-grain allocations take
  them back first.

Page 0 of every node is reserved (page 0 of node 0 carries the root-pointer
meta words; addr 0 doubles as NULL).
"""

from __future__ import annotations

import threading

import numpy as np

from sherman_tpu_torch.config import ADDR_PAGE_BITS, DSMConfig
from sherman_tpu_torch.errors import DoubleFreeError
from sherman_tpu_torch.ops import bits

RESERVED_PAGES = 1


class GlobalAllocator:
    """Bump chunk allocator over one node's pool partition."""

    def __init__(self, node_id: int, pages_per_node: int, chunk_pages: int,
                 reserved: int = RESERVED_PAGES):
        self.node_id = node_id
        self.chunk_pages = chunk_pages
        self._next = reserved
        self._limit = pages_per_node
        # Reclaimed single pages, fed by the engine's quarantined
        # empty-leaf reclaim (BatchedEngine.reclaim_empty_leaves) and
        # served LIFO before fresh bump space for page-grain allocations.
        self._free: list[int] = []
        # Concurrent host clients (the reference's 26-thread axis) lease
        # chunks from shared directories; the bump must be atomic or two
        # clients get the same chunk (silent page aliasing).
        self._mu = threading.Lock()

    def alloc_chunk(self) -> tuple[int, int]:
        """-> (first page index, size) of a fresh chunk; raises when
        exhausted.  The partition tail yields one truncated chunk (the
        reserved page 0 makes partitions non-multiples of chunk_pages, so
        insisting on full chunks would strand the tail — e.g. a
        single-chunk partition would be unusable)."""
        with self._mu:
            size = min(self.chunk_pages, self._limit - self._next)
            if size <= 0:
                raise MemoryError(
                    f"node {self.node_id}: DSM partition exhausted "
                    f"({self._limit} pages)")
            start = self._next
            self._next += size
            return start, size

    def reclaim(self, pages) -> None:
        """Return page indices to this node's free pool.  The caller owns
        the safety argument (quarantine): a returned page is unreachable
        from the tree and past any stale reader's grace period.  Raises
        :class:`DoubleFreeError` on a page pooled twice, which would be
        granted twice."""
        with self._mu:
            incoming = [int(p) for p in pages]
            dup = set(incoming) & set(self._free)
            if dup or len(set(incoming)) != len(incoming):
                raise DoubleFreeError(
                    f"node {self.node_id}: double-free into the reclaim "
                    f"pool (duplicates: {sorted(dup)[:4]})")
            self._free.extend(incoming)

    def pop_free_page(self) -> int:
        """-> one reclaimed page index (the last returned), or -1 when the
        free pool is empty."""
        with self._mu:
            return self._free.pop() if self._free else -1

    @property
    def pages_free(self) -> int:
        with self._mu:
            return len(self._free)

    @property
    def free_pages_list(self) -> list[int]:
        """Snapshot of the reclaimed-page pool."""
        with self._mu:
            return list(self._free)

    @property
    def pages_used(self) -> int:
        return self._next


class Directory:
    """Memory-node agent: chunk MALLOC + NEW_ROOT bookkeeping.

    The reference spawns one directory thread per node polling UD messages
    (``Directory.cpp:23-58``); here requests arrive as calls.  NEW_ROOT
    updates the node-local root hint exactly like ``Directory.cpp:75-86``.
    """

    def __init__(self, node_id: int, cfg: DSMConfig):
        self.node_id = node_id
        self.allocator = GlobalAllocator(
            node_id, cfg.pages_per_node, cfg.chunk_pages)
        self.root_ptr = 0      # g_root_ptr analogue
        self.root_level = -1   # g_root_level analogue

    def malloc_chunk(self) -> tuple[int, int]:
        """MALLOC RPC: -> (chunk base addr, chunk size in pages)."""
        start, size = self.allocator.alloc_chunk()
        return bits.make_addr(self.node_id, start), size

    def new_root(self, addr: int, level: int) -> None:
        """NEW_ROOT RPC (broadcast target, ``Tree.cpp:116-124``)."""
        self.root_ptr = addr
        self.root_level = level


class LocalAllocator:
    """Per-client page allocator over leased chunks, one lease per node.

    ``directories`` are the node agents this client can lease from — all
    nodes in single-process SPMD, only the host-local node(s) in a
    multi-host deployment (each host allocates from its own partition;
    remote-chunk RPC is not needed because any node's pages are reachable
    one-sidedly once allocated).  Addresses are always packed with the
    directory's REAL node id, which need not equal its list position.
    """

    def __init__(self, directories: list[Directory]):
        self._dirs = directories
        self._by_node = {d.node_id: d for d in directories}
        self._cur: dict[int, tuple[int, int]] = {}  # node -> (next_page, end)
        self._rr = 0

    def _pick(self, node: int | None) -> Directory:
        if node is None:
            d = self._dirs[self._rr % len(self._dirs)]
            self._rr += 1
            return d
        if node not in self._by_node:
            raise KeyError(
                f"node {node} has no local directory (locals: "
                f"{sorted(self._by_node)}); allocate from a local node")
        return self._by_node[node]

    def alloc(self, npages: int = 1, node: int | None = None) -> int:
        """Allocate npages *contiguous* pages; -> packed addr of the first.

        Target node round-robins per call unless pinned (DSM.h:200-203).
        Page-grain allocations are served from the node's reclaimed-page
        pool first (empty when reclamation is unused).
        """
        d = self._pick(node)
        nid = d.node_id
        if npages == 1:
            pg = d.allocator.pop_free_page()
            if pg >= 0:
                return bits.make_addr(nid, pg)
        nxt, end = self._cur.get(nid, (0, 0))
        if nxt + npages > end:
            base_addr, chunk_pages = d.malloc_chunk()
            nxt = bits.addr_page(base_addr)
            end = nxt + chunk_pages
            if npages > chunk_pages:
                # keep the (truncated) grant leased for smaller allocs
                self._cur[nid] = (nxt, end)
                raise MemoryError(
                    f"node {nid}: contiguous alloc of {npages} pages "
                    f"exceeds the granted chunk ({chunk_pages} pages)")
        self._cur[nid] = (nxt + npages, end)
        return bits.make_addr(nid, nxt)

    def alloc_many(self, count: int) -> np.ndarray:
        """Vectorized allocation of ``count`` single pages (bulk-load path).

        Leases whole chunks round-robin across nodes and fills them; any
        partial last chunk stays leased for future alloc() calls.  Returns
        an int64 array of packed addresses.
        """
        out = np.empty(count, np.int64)
        filled = 0
        while filled < count:
            d = self._dirs[self._rr % len(self._dirs)]
            self._rr += 1
            nid = d.node_id
            nxt, end = self._cur.pop(nid, (0, 0))
            if nxt >= end:
                base_addr, chunk_pages = d.malloc_chunk()
                nxt = bits.addr_page(base_addr)
                end = nxt + chunk_pages
            take = min(end - nxt, count - filled)
            out[filled:filled + take] = (
                (nid << ADDR_PAGE_BITS) | np.arange(nxt, nxt + take))
            filled += take
            if nxt + take < end:
                self._cur[nid] = (nxt + take, end)
        return out

    def free(self, addr: int, npages: int = 1) -> None:
        """No-op, like the reference (``DSM.h:226``,
        ``LocalAllocator.h:45-47``); reclaim goes through
        :meth:`GlobalAllocator.reclaim`."""
