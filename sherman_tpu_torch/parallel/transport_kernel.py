"""K4, the exchange all-to-all of the emulated nodes, written by hand in
CUDA C++ for Hopper (``csrc/exchange.cu``), with its plain PyTorch version
(counterpart of ``sherman_tpu/parallel/transport_pallas.py::exchange_pallas``).

The nodes of a cluster live on one card as node-major blocks, so the
reference's per-node ``[N*C, W]`` send buffers stack into one
``[N, N*C, W]`` int32 tensor, and the all-to-all is the block permutation
``out[d, s*C:(s+1)*C] = x[s, d*C:(d+1)*C]`` (``lax.all_to_all(x, axis, 0,
0, tiled=True)`` on every node at once).

Dispatch is by the tensor's device: on a CUDA tensor :func:`all_to_all`
launches the kernel (or raises :class:`KernelUnavailableError`); on a CPU
tensor it runs :func:`all_to_all_ref`.  It adds one to
``LAUNCHES["exchange"]`` where it launches the kernel.  The kernel is
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


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Tiled all-to-all of the stacked send buffers ``x [N, N*C, W]``
    int32: ``out[d, s*C:(s+1)*C] = x[s, d*C:(d+1)*C]``."""
    if x.device.type != "cuda":
        return all_to_all_ref(x)
    k = "exchange"
    if x.dim() != 3 or x.dtype != torch.int32 or not x.is_contiguous() \
            or x.shape[0] < 1 or x.shape[1] % x.shape[0]:
        raise KernelUnavailableError(
            k, f"x: want a contiguous int32 [N, N*C, W], got {x.dtype} "
               f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    N, NC, W = x.shape
    out = torch.empty_like(x)
    PK._call(k, "sherman_exchange", PK._dev_index(x.device), x.data_ptr(),
             out.data_ptr(), N, NC // N, W, launches=LAUNCHES)
    return out
