"""The layout of a cluster's nodes over processes ("ranks"): the port's
counterpart of ``sherman_tpu/parallel/mesh.py``.

The reference's mesh is a 1-D ``jax.sharding.Mesh`` over every device of
every process, and a process serves the contiguous block of nodes whose
devices it holds (``dsm.py:513-518``).  Here a rank is one process of a
``torch.distributed`` group; the ``machine_nr`` nodes are split into
``world_size`` equal contiguous blocks, ascending with the rank.  Without
a process group (or with one rank) the mesh is every node of one process,
which is how every single-process path of the port runs.

The layout is process-wide, as ``jax.devices()`` is after
``jax.distributed.initialize``: :func:`of` derives it from the node count
and the process group alone, so the device steps need no extra argument.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from sherman_tpu_torch.errors import ConfigError


@dataclass(frozen=True)
class Mesh:
    """``machine_nr`` nodes over ``world_size`` ranks; this process is
    ``rank`` and serves ``local_nodes`` (a contiguous ``range``)."""

    machine_nr: int
    world_size: int = 1
    rank: int = 0

    def __post_init__(self):
        if self.world_size < 1 or not 0 <= self.rank < self.world_size:
            raise ConfigError(f"mesh rank {self.rank} of {self.world_size}")
        if self.machine_nr % self.world_size:
            raise ConfigError(
                f"machine_nr={self.machine_nr} nodes do not split into "
                f"{self.world_size} equal rank blocks")

    @property
    def spans(self) -> bool:
        """True when the nodes span more than one process."""
        return self.world_size > 1

    @property
    def n_local(self) -> int:
        return self.machine_nr // self.world_size

    @property
    def local_nodes(self) -> range:
        lo = self.rank * self.n_local
        return range(lo, lo + self.n_local)

    @property
    def lo(self) -> int:
        return self.local_nodes.start

    # -- replicated control flow -------------------------------------------

    def any(self, mask: torch.Tensor) -> bool:
        """True if any rank's ``mask`` holds a True: a data-dependent loop
        exit every rank takes together (one host sync, plus one all-reduce
        when the mesh spans ranks)."""
        return self.total(mask) > 0

    def total(self, mask: torch.Tensor) -> int:
        """The count of True in ``mask`` summed over the ranks."""
        n = int(mask.sum())
        if not self.spans:
            return n
        from sherman_tpu_torch.parallel import bootstrap
        return bootstrap.allreduce_int(n)


def process_layout() -> tuple[int, int]:
    """(world_size, rank) of this process's ``torch.distributed`` group;
    (1, 0) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@functools.lru_cache(maxsize=None)
def _mesh(machine_nr: int, world_size: int, rank: int) -> Mesh:
    return Mesh(machine_nr, world_size, rank)


def make_mesh(machine_nr: int) -> Mesh:
    """The mesh of ``machine_nr`` nodes over this process's group."""
    return _mesh(machine_nr, *process_layout())


def of(cfg) -> Mesh:
    """The mesh of a :class:`~sherman_tpu_torch.config.DSMConfig`."""
    return make_mesh(cfg.machine_nr)
