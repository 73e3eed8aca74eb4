"""Cluster — the top-level runtime handle (counterpart of
``sherman_tpu/cluster.py``).

Bundles the DSM, the bootstrap Keeper and one Directory per node, and
hands out per-client contexts (``DSM::registerThread``) whose allocators
lease chunks round-robin over the nodes.  One process drives every node
of a card; when the mesh spans processes (``init_multihost``), every rank
runs the same host program and mirrors every node's directory
(replicated-driver SPMD), and host-API ops go through
:class:`~sherman_tpu_torch.parallel.dsm.ReplicatedDSM`.
"""

from __future__ import annotations

from dataclasses import dataclass

from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import MultiprocessUnsupportedError
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.parallel.alloc import Directory, LocalAllocator
from sherman_tpu_torch.parallel.bootstrap import Keeper
from sherman_tpu_torch.parallel.dsm import DSM, ReplicatedDSM


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
        # A process-spanning mesh REQUIRES the multihost keeper: with the
        # in-process keeper every rank would serve ALL nodes' directories
        # on its own and two ranks hand out the same chunks.
        assert not (self.dsm.multihost and not self.keeper.is_multihost), (
            "mesh spans processes but the keeper is single-process: pass "
            "bootstrap.init_multihost()'s keeper to Cluster on every host")
        if self.keeper.is_multihost:
            # every rank enters once, then mirrors ALL nodes' directories:
            # identical replicated control flow keeps the mirrors in
            # lock-step, so a client may lease chunks on any node
            self.keeper.server_enter()
            self.node_ids = list(range(cfg.machine_nr))
        else:
            self.node_ids = [self.keeper.server_enter()
                             for _ in range(cfg.machine_nr)]
        self.directories = [Directory(n, cfg) for n in self.node_ids]
        # the handle the Tree and the engine's host paths use: the DSM in
        # one process, the leader-posted replicated wrapper across ranks
        # (each host-API op executes once cluster-wide)
        self.host_dsm = (ReplicatedDSM(self.dsm) if self.dsm.multihost
                         else self.dsm)
        # The hierarchical lock's local tier: one process-wide native
        # ticket-lock table indexed like the global lock space.  Host Tree
        # clients of this process queue here first and hand the global
        # lock down the ticket train (at most 8 hand-overs), paying one
        # global CAS and one global unlock a train.  Off on meshes that span
        # processes: hand-over decisions depend on each process's thread
        # timing, and ReplicatedDSM needs identical step sequences.
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
        epoch.  Across processes the allocators are MIRRORED, so a client
        may only allocate from replicated control flow: registering one
        there requires ``replicated=True`` as an explicit acknowledgment
        (raw per-process drivers get :class:`MultiprocessUnsupportedError`
        here instead of colliding pages later)."""
        if self.dsm.multihost and replicated is not True:
            raise MultiprocessUnsupportedError(
                "multi-host clients allocate from MIRRORED directories: "
                "pass register_client(replicated=True) to acknowledge "
                "that this client runs identical (replicated) control "
                "flow on every process; raw per-process drivers must "
                "not allocate")
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

    def sweep_dead_processes(self, tags_by_process: dict[int, list[int]]
                             ) -> list[int]:
        """COLLECTIVE maintenance pass: take the liveness roll call
        (``failure.live_processes``; every live rank calls this together)
        and expire every client tag owned by a process that is no longer
        live.  ``tags_by_process`` maps a process index to the tags its
        non-replicated drivers registered.  Returns the expired tags; a
        single-process cluster expires nothing."""
        from sherman_tpu_torch.utils import failure
        live = set(failure.live_processes(
            self.keeper.machine_nr if self.keeper.is_multihost else 1))
        expired = []
        for proc, tags in tags_by_process.items():
            if int(proc) in live:
                continue
            for t in tags:
                self.expire_client(t)
                expired.append(int(t))
        return expired

    def broadcast_new_root(self, addr: int, level: int) -> None:
        """NEW_ROOT: update the directories' advisory root hints."""
        for d in self.directories:
            d.new_root(addr, level)
