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
    # lease epoch of this client's lock acquisitions (bumped by
    # Cluster.expire_client: a lock word holding an old epoch is revocable)
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
        # The hierarchical lock's local tier: one process-wide native
        # ticket-lock table indexed like the global lock space.  Host Tree
        # clients of this process queue here first and hand the global
        # lock down the ticket train (at most 8 hand-overs), paying one
        # global CAS and one global unlock a train.  The reference turns
        # it off on meshes that span processes; one process drives every
        # node here (``DSM.multihost`` is False), so it is on wherever the
        # native library loads.
        from sherman_tpu_torch import native
        self.local_locks = (
            native.LocalLockTable(cfg.machine_nr * cfg.locks_per_node)
            if not self.dsm.multihost and native.available() else None)
        self._next_client = 0
        # lock-lease epoch table: owner tag -> current lease epoch of every
        # registered client; a lock word whose (owner, epoch) is absent or
        # stale here belongs to a dead client and may be revoked
        self.lease_epochs: dict[int, int] = {}
        self.keeper.barrier("DSM-init")

    def register_client(self, replicated: bool | None = None
                        ) -> ClientContext:
        """Per-client context (``DSM::registerThread``); records its lease
        epoch.  ``replicated`` is the reference's multihost acknowledgment;
        one process drives every node here, so it changes nothing."""
        cid = self._next_client
        self._next_client += 1
        ctx = ClientContext(client_id=cid,
                            alloc=LocalAllocator(self.directories))
        self.lease_epochs[ctx.tag] = ctx.epoch
        return ctx

    def lease_is_live(self, owner_tag: int, epoch: int) -> bool:
        """True iff a lock word's (owner, epoch) names a live lease: the
        tag is registered and the epoch is its current one."""
        return self.lease_epochs.get(int(owner_tag)) == int(epoch)

    def expire_client(self, owner_tag: int) -> None:
        """Declare a client's current lease dead: bump its epoch so a lock
        word it still holds fails :meth:`lease_is_live` and becomes
        revocable."""
        t = int(owner_tag)
        self.lease_epochs[t] = self.lease_epochs.get(t, 0) + 1

    def broadcast_new_root(self, addr: int, level: int) -> None:
        """NEW_ROOT: update the directories' advisory root hints."""
        for d in self.directories:
            d.new_root(addr, level)
