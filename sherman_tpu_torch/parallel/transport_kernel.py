"""K4, the exchange all-to-all of the emulated nodes, written by hand in
CUDA C++ for Hopper (``csrc/exchange.cu``), with its plain PyTorch version
(counterpart of ``sherman_tpu/parallel/transport_pallas.py::exchange_pallas``).

The nodes of a cluster live on one card as node-major blocks, so the
reference's per-node ``[N*C, W]`` send buffers stack into one
``[N, N*C, W]`` int32 tensor, and the all-to-all is the block permutation
``out[d, s*C:(s+1)*C] = x[s, d*C:(d+1)*C]`` (``lax.all_to_all(x, axis, 0,
0, tiled=True)`` on every node at once).

When the nodes span R processes ("ranks") of ``L = N / R`` nodes, a rank
holds ``x [L, N*C, W]`` and receives ``[L, N*C, W]`` with
``out[d_loc, s*C:(s+1)*C] = x_owner(s)[s_loc, d*C:(d+1)*C]``: the kernel
lays the send buffer out by destination rank (:func:`pack_for_ranks`), one
``all_to_all_single`` of equal splits carries it
(:mod:`sherman_tpu_torch.parallel.transport`), and the kernel puts the
received blocks in place (:func:`unpack_from_ranks`).  Both are the one
kernel with its layout as an argument: the block transpose
``out[j, i] = x[i, j]`` of an ``[A, B]`` grid of runs
(:func:`block_transpose`).  At one rank the exchange is one launch, as it
always was.

Dispatch is by the tensor's device: on a CUDA tensor a wrapper launches
the kernel (or raises :class:`KernelUnavailableError`); on a CPU tensor it
runs the plain version (:func:`all_to_all_ref`,
:func:`block_transpose_ref`).  Every launch adds one to
``LAUNCHES["exchange"]``.  The kernel is bound by bytes: each launch reads
and writes every word once (``2 * x.numel() * 4`` bytes at 3.35 TB/s).  The kernel is
built with the page kernels, at first use, by
:func:`sherman_tpu_torch.ops.page_kernels.load_library`.
"""

from __future__ import annotations

import torch

from sherman_tpu_torch.errors import KernelUnavailableError
from sherman_tpu_torch.ops import page_kernels as PK

# Kernel launches since the last reset_launches().
LAUNCHES = {"exchange": 0}


def reset_launches() -> None:
    LAUNCHES["exchange"] = 0


def all_to_all_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the block transpose of ``x [N, N*C, W]``."""
    N, NC, W = x.shape
    return x.view(N, N, NC // N, W).transpose(0, 1).reshape(N, NC, W)


def block_transpose_ref(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Plain version of the kernel's layout: ``x`` viewed ``[a, b, run]``
    -> ``[b, a, run]`` (``out[j, i] = x[i, j]``), flat as ``x``."""
    run = x.numel() // (a * b)
    return x.reshape(a, b, run).transpose(0, 1).contiguous().view(x.shape)


def _launch(x: torch.Tensor, a: int, b: int, out_shape) -> torch.Tensor:
    k = "exchange"
    if x.dtype != torch.int32 or not x.is_contiguous() or a < 1 or b < 1 \
            or x.numel() % (a * b):
        raise KernelUnavailableError(
            k, f"x: want a contiguous int32 grid of {a} x {b} runs, got "
               f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    PK._call(k, "sherman_exchange", PK._dev_index(x.device), x.data_ptr(),
             out.data_ptr(), a, b, x.numel() // (a * b), launches=LAUNCHES)
    return out


def block_transpose(x: torch.Tensor, a: int, b: int,
                    out_shape=None) -> torch.Tensor:
    """``x`` as an ``[a, b]`` grid of equal contiguous runs of int32 words
    -> the ``[b, a]`` grid (``out[j, i] = x[i, j]``), shaped ``out_shape``
    (default ``x.shape``)."""
    shape = tuple(x.shape) if out_shape is None else tuple(out_shape)
    if x.device.type != "cuda":
        return block_transpose_ref(x, a, b).reshape(shape)
    return _launch(x, a, b, shape)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Tiled all-to-all of the stacked send buffers ``x [N, N*C, W]``
    int32: ``out[d, s*C:(s+1)*C] = x[s, d*C:(d+1)*C]``."""
    if x.device.type != "cuda":
        return all_to_all_ref(x)
    if x.dim() != 3 or x.shape[0] < 1 or x.shape[1] % x.shape[0]:
        raise KernelUnavailableError(
            "exchange", f"x: want a contiguous int32 [N, N*C, W], got "
                        f"{x.dtype} {tuple(x.shape)}")
    N = x.shape[0]
    return _launch(x, N, N, x.shape)


def pack_for_ranks(x: torch.Tensor, ranks: int) -> torch.Tensor:
    """A rank's send buffers ``x [L, N*C, W]`` (``N = ranks * L``) laid out
    by destination rank: ``[ranks, L*L*C*W]``, block ``q`` holding what
    rank ``q``'s nodes receive, ready for one equal-split
    ``all_to_all_single``."""
    L = x.shape[0]
    return block_transpose(x, L, ranks, (ranks, x.numel() // ranks))


def unpack_from_ranks(recv: torch.Tensor, n_local: int,
                      shape) -> torch.Tensor:
    """The received blocks ``recv [R, L*L*C*W]`` (block ``p`` from rank
    ``p``) put in place: ``[L, N*C, W]`` with row block ``s`` of node
    ``d_loc`` from source node ``s``."""
    R = recv.shape[0]
    return block_transpose(recv, R * n_local, n_local, shape)
