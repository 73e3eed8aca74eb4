"""Cluster — the top-level runtime handle for one process driving every
node of a card (counterpart of ``sherman_tpu/cluster.py``).

Bundles the DSM, the bootstrap Keeper and one Directory per node, and
hands out per-client contexts (``DSM::registerThread``) whose allocators
lease chunks round-robin over the nodes.
"""

from __future__ import annotations

from dataclasses import dataclass

from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.parallel.alloc import Directory, LocalAllocator
from sherman_tpu_torch.parallel.bootstrap import Keeper
from sherman_tpu_torch.parallel.dsm import DSM


@dataclass
class ClientContext:
    """Per-client state: a client id and a private page allocator."""

    client_id: int
    alloc: LocalAllocator
    epoch: int = 1

    @property
    def tag(self) -> int:
        """Lock-holder tag; nonzero."""
        return self.client_id + 1

    @property
    def lease(self) -> int:
        """The lock word this client writes when it takes a global lock."""
        return bits.lease_word(self.tag, self.epoch)


class Cluster:
    def __init__(self, cfg: DSMConfig, keeper: Keeper | None = None):
        self.cfg = cfg
        self.dsm = DSM(cfg)
        self.keeper = keeper if keeper is not None else Keeper(cfg.machine_nr)
        self.node_ids = [self.keeper.server_enter()
                         for _ in range(cfg.machine_nr)]
        self.directories = [Directory(n, cfg) for n in self.node_ids]
        # one process drives every node: host ops go straight to the DSM
        self.host_dsm = self.dsm
        self._next_client = 0
        self.keeper.barrier("DSM-init")

    def register_client(self) -> ClientContext:
        """Per-client context (``DSM::registerThread``)."""
        cid = self._next_client
        self._next_client += 1
        return ClientContext(client_id=cid,
                             alloc=LocalAllocator(self.directories))

    def broadcast_new_root(self, addr: int, level: int) -> None:
        """NEW_ROOT: update the directories' advisory root hints."""
        for d in self.directories:
            d.new_root(addr, level)
