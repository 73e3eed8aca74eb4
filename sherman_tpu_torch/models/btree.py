"""The B-link tree handle over the DSM (counterpart of the root
management in ``sherman_tpu/models/btree.py``).  The root and the meta
page live on node 0.

This slice carries what the batched serving path needs: adopting or
CAS-installing the root leaf, and re-reading the root.  The host insert,
split and delete paths come with the write slice (ROADMAP.md section 1
item 6).
"""

from __future__ import annotations

from sherman_tpu_torch import config as C
from sherman_tpu_torch.cluster import ClientContext, Cluster
from sherman_tpu_torch.ops import bits, layout

META_ADDR = bits.make_addr(0, 0)


class Tree:
    # index cache handle (models/router.py), attached by the engine
    router = None

    def __init__(self, cluster: Cluster, ctx: ClientContext | None = None):
        self.cluster = cluster
        self.dsm = cluster.host_dsm
        self.cfg = cluster.cfg
        self.ctx = ctx if ctx is not None else cluster.register_client()
        # Adopt an installed root, else build an empty root leaf and
        # CAS-install it (one winner); the pre-read avoids leaking a page
        # per client handle.
        existing = self.dsm.read_word(META_ADDR, C.META_ROOT_ADDR_W)
        if existing != 0:
            self._root_addr = existing
            self._root_level = int(self.dsm.read_page(existing)[C.W_LEVEL])
            return
        root = self.ctx.alloc.alloc()
        pg = layout.np_empty_page(level=0, lowest=C.KEY_NEG_INF,
                                  highest=C.KEY_POS_INF)
        self.dsm.write_page(root, pg)
        old, ok = self.dsm.cas(META_ADDR, C.META_ROOT_ADDR_W, 0, root)
        if ok:
            self.cluster.broadcast_new_root(root, 0)
            self._root_addr, self._root_level = root, 0
        else:
            self._root_addr = old
            self._root_level = int(self.dsm.read_page(old)[C.W_LEVEL])

    def _refresh_root(self) -> None:
        """Re-read the root pointer from the meta page and its level from
        the root page itself."""
        self._root_addr = self.dsm.read_word(META_ADDR, C.META_ROOT_ADDR_W)
        self._root_level = int(
            self.dsm.read_page(self._root_addr)[C.W_LEVEL])
