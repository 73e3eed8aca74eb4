"""Page-engine kernels for the one-node serving path, written by hand in
CUDA C++ for Hopper (``csrc/page_kernels.cu``), with their plain PyTorch
versions (counterpart of ``sherman_tpu/ops/pallas_page.py``).

================  ==================================  ======================
wrapper           replaces (TPU kernel)                plain version
================  ==================================  ======================
descent_round     pallas_page.py::descent_round       descent_round_ref
gather_pages      pallas_page.py::gather_pages        gather_pages_ref
writeback         pallas_page.py::writeback           writeback_ref
================  ==================================  ======================

Dispatch is by the tensors' device and nothing else: on a CUDA tensor a
wrapper launches its kernel (or raises :class:`KernelUnavailableError`
naming the cause — there is no fallback); on a CPU tensor it runs the
plain version.  Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, so a run can show that its path went through it, and
its row count to ``ROWS[name]``.  The ``kernels`` pull collector publishes
both (``kernels.<name>_launches``, ``kernels.<name>_rows``, and the
exchange's launches) in every registry snapshot; the reference's
``kernels.*_traced`` counters count program builds, which eager PyTorch
does not have.  The build itself is a ``build.page_kernels`` entry of the
program ledger (``obs/device.py``), with its wall.

The extension is built at first use with ``torch.utils.cpp_extension.load``
into ``ops/_build/`` (nvcc ``-gencode=arch=compute_90a,code=sm_90a``);
importing this module builds nothing.  The one build also holds the
exchange all-to-all of :mod:`sherman_tpu_torch.parallel.transport_kernel`
(``parallel/csrc/exchange.cu``), which counts its launches in its own
module.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import KernelUnavailableError
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.ops import bits, layout

_PW = C.PAGE_WORDS
_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_HERE, "csrc", "page_kernels.cpp"),
           os.path.join(_HERE, "csrc", "page_kernels.cu"),
           os.path.join(os.path.dirname(_HERE), "parallel", "csrc",
                        "exchange.cu"))
BUILD_DIR = os.path.join(_HERE, "_build")
_EXT_NAME = "sherman_page_kernels"

# Kernel launches and the rows they covered since the last
# reset_launches(), by kernel name.
LAUNCHES = {"descent_round": 0, "gather_pages": 0, "writeback": 0}
ROWS = {"descent_round": 0, "gather_pages": 0, "writeback": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        ROWS[k] = 0


def _collect() -> dict:
    """The ``kernels`` pull collector: launch and row counts of K1-K3 and
    the launches of the exchange kernel K4."""
    from sherman_tpu_torch.parallel import transport_kernel as TK
    out = {f"{k}_launches": v for k, v in LAUNCHES.items()}
    out.update({f"{k}_rows": v for k, v in ROWS.items()})
    out.update({f"{k}_launches": v for k, v in TK.LAUNCHES.items()})
    return out


obs.register_collector("kernels", _collect)


# ---------------------------------------------------------------------------
# Build and bind.
# ---------------------------------------------------------------------------

_lib = None
_lib_mu = threading.Lock()


def _build() -> ctypes.CDLL:
    """Compile every source with ninja (nvcc for the .cu files, the host
    compiler for the binding, in parallel) and load the library."""
    from torch.utils import cpp_extension
    os.environ["TORCH_CUDA_ARCH_LIST"] = "9.0a"
    os.makedirs(BUILD_DIR, exist_ok=True)
    cpp_extension.load(
        name=_EXT_NAME, sources=list(SOURCES), build_directory=BUILD_DIR,
        extra_cflags=["-O3"],
        extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
        with_cuda=True, is_python_module=False, verbose=False)
    lib = ctypes.CDLL(os.path.join(BUILD_DIR, _EXT_NAME + ".so"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sherman_descent_round.argtypes = (
        [i32, p, i64, p, p, p, p, i64, i32] + [p] * 7 + [ctypes.c_char_p, i64])
    lib.sherman_gather_pages.argtypes = [i32, p, i64, p, p, i64, p,
                                         ctypes.c_char_p, i64]
    lib.sherman_writeback.argtypes = [i32, p, i64, p, p, p, p, i64, i32, p,
                                      ctypes.c_char_p, i64]
    lib.sherman_exchange.argtypes = [i32, p, p, i64, i64, i64,
                                     ctypes.c_char_p, i64]
    for fn in (lib.sherman_descent_round, lib.sherman_gather_pages,
               lib.sherman_writeback, lib.sherman_exchange):
        fn.restype = ctypes.c_int
    return lib


def load_library(kernel: str = "page_kernels") -> ctypes.CDLL:
    """The built extension (built once per process)."""
    global _lib
    with _lib_mu:
        if _lib is None:
            t0 = time.perf_counter()
            try:
                lib = _build()
            except (OSError, RuntimeError, ImportError,
                    ctypes.ArgumentError) as e:
                # RuntimeError carries the ninja/nvcc output; OSError a
                # missing toolchain or an unloadable library
                raise KernelUnavailableError(
                    kernel, f"build of {', '.join(SOURCES)} failed: {e}"
                ) from e
            root = os.path.dirname(os.path.dirname(_HERE))
            DEV.get_ledger().record_build(
                "build.page_kernels", (time.perf_counter() - t0) * 1e3,
                [os.path.relpath(s, root) for s in SOURCES])
            _lib = lib
        return _lib


def _call(kernel: str, fn_name: str, *args, launches=None,
          rows: int | None = None) -> None:
    """Launch ``fn_name`` and count it in ``launches`` (this module's
    ``LAUNCHES`` unless the caller keeps its own), and ``rows`` in
    ``ROWS``."""
    lib = load_library(kernel)
    err = ctypes.create_string_buffer(1024)
    rc = getattr(lib, fn_name)(*args, err, len(err))
    if rc != 0:
        raise KernelUnavailableError(
            kernel, "launch failed: " + err.value.decode(errors="replace"))
    (LAUNCHES if launches is None else launches)[kernel] += 1
    if rows is not None:
        ROWS[kernel] += rows


def _dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check(kernel: str, t: torch.Tensor, dtype, name: str,
           shape=None) -> None:
    if t.dtype != dtype or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise KernelUnavailableError(
            kernel, f"{name}: want contiguous {dtype} of shape {shape}, "
                    f"got {t.dtype} {tuple(t.shape)} "
                    f"contiguous={t.is_contiguous()}")


def _on_cuda(kernel: str, pool: torch.Tensor, *ts: torch.Tensor) -> bool:
    if pool.device.type != "cuda":
        return False
    if any(t.device != pool.device for t in ts):
        raise KernelUnavailableError(
            kernel, "all tensors must lie on the pool's device "
                    f"{pool.device}")
    return True


# ---------------------------------------------------------------------------
# K1: fused descent round.
# ---------------------------------------------------------------------------

def descent_round_ref(pool, addr, khi, klo, active, *, stop_level: int = 0):
    """Plain version: gather the rows' pages (zeroed where not ok), then
    the ``ops/layout`` search — ``descent_round_xla``'s composition."""
    P = pool.shape[0]
    page = bits.addr_page(addr)
    ok = active & (page >= 0) & (page < P)
    pg = torch.where(ok[:, None], pool[page.clamp(0, P - 1).long()], 0)
    chase = layout.needs_sibling_chase(pg, khi, klo)
    is_leaf = (layout.h_level(pg) == stop_level) & ~chase
    nxt = torch.where(chase, layout.h_sibling(pg),
                      layout.internal_pick_child(pg, khi, klo))
    f, vh, vl, _ = layout.leaf_find_key(pg, khi, klo)
    return nxt, is_leaf, chase, ok, f, vh, vl


def descent_round(pool, addr, khi, klo, active, *, stop_level: int = 0):
    """One descent round over ``[B]`` rows: fetch each active row's page
    and search it, emitting ``(nxt, is_leaf, chase, ok, found, vhi,
    vlo)`` — next-level address, (level == stop_level and in fence),
    sibling-chase flag, page-read validity and the leaf lookup.  Bool
    outputs are bool tensors."""
    if not _on_cuda("descent_round", pool, addr, khi, klo, active):
        return descent_round_ref(pool, addr, khi, klo, active,
                                 stop_level=stop_level)
    B = addr.shape[0]
    P = pool.shape[0]
    k = "descent_round"
    _check(k, pool, torch.int32, "pool", (P, _PW))
    for name, t in (("addr", addr), ("khi", khi), ("klo", klo)):
        _check(k, t, torch.int32, name, (B,))
    _check(k, active, torch.bool, "active", (B,))
    dev = pool.device
    i32 = lambda: torch.empty(B, dtype=torch.int32, device=dev)
    b8 = lambda: torch.empty(B, dtype=torch.bool, device=dev)
    nxt, vhi, vlo = i32(), i32(), i32()
    is_leaf, chase, ok, found = b8(), b8(), b8(), b8()
    _call(k, "sherman_descent_round", _dev_index(dev), pool.data_ptr(), P,
          addr.data_ptr(), khi.data_ptr(), klo.data_ptr(), active.data_ptr(),
          B, int(stop_level), nxt.data_ptr(), is_leaf.data_ptr(),
          chase.data_ptr(), ok.data_ptr(), found.data_ptr(), vhi.data_ptr(),
          vlo.data_ptr(), rows=B)
    return nxt, is_leaf, chase, ok, found, vhi, vlo


# ---------------------------------------------------------------------------
# K2: snapshot gather (+ the single-node read_pages contract).
# ---------------------------------------------------------------------------

def gather_pages_ref(pool, rows, ok=None):
    """Plain version: ``pool[clip(rows, 0, P - 1)]``, zero rows where
    ``ok`` is given and false."""
    P = pool.shape[0]
    out = pool[rows.clamp(0, P - 1).long()]
    return out if ok is None else torch.where(ok[:, None], out, 0)


def gather_pages(pool, rows, ok=None):
    """Materialized ``[M, 256]`` page snapshot of ``pool`` at the clipped
    ``rows``; with ``ok``, rows that are not ok come back zeroed without
    being read."""
    if not _on_cuda("gather_pages", pool, rows,
                    *(() if ok is None else (ok,))):
        return gather_pages_ref(pool, rows, ok)
    M = rows.shape[0]
    P = pool.shape[0]
    k = "gather_pages"
    _check(k, pool, torch.int32, "pool", (P, _PW))
    _check(k, rows, torch.int32, "rows", (M,))
    if ok is not None:
        _check(k, ok, torch.bool, "ok", (M,))
    out = torch.empty((M, _PW), dtype=torch.int32, device=pool.device)
    _call(k, "sherman_gather_pages", _dev_index(pool.device), pool.data_ptr(),
          P, rows.data_ptr(), None if ok is None else ok.data_ptr(), M,
          out.data_ptr(), rows=M)
    return out


def read_pages_local(pool, addrs, active):
    """The single-node ``read_pages_spmd`` contract over the gather:
    (pages zeroed where not ok, ok = active & page in range)."""
    P = pool.shape[0]
    page = bits.addr_page(addrs)
    ok = active & (page >= 0) & (page < P)
    return gather_pages(pool, page, ok), ok


# ---------------------------------------------------------------------------
# K3: multi-lane write-back (in place).
# ---------------------------------------------------------------------------

def writeback_ref(pool, page, slot, applied, ent, field_w):
    """Plain version: the per-lane flat scatter of the reference's apply
    path.  Updates ``pool`` in place and returns it."""
    fw = torch.as_tensor(list(field_w), dtype=torch.int64, device=pool.device)
    idx = (page.long() * _PW)[:, None] + fw[None, :] + slot.long()[:, None]
    sel = applied[:, None].expand_as(idx)
    pool.view(-1)[idx[sel]] = ent[sel]
    return pool


def writeback(pool, page, slot, applied, ent, field_w):
    """For each row with ``applied``, write ``ent[r, l]`` to
    ``pool[page[r], field_w[l] + slot[r]]`` in place, every lane in one
    pass; returns ``pool``.  Contract (as the reference's): ``page`` is
    clipped to the pool and applied rows carry in-page word targets; two
    applied rows may share a target word only if they carry equal values
    there (the delete's same-key rows all write 0 to one version word), so
    the order of their stores does not matter."""
    if not _on_cuda("writeback", pool, page, slot, applied, ent):
        return writeback_ref(pool, page, slot, applied, ent, field_w)
    M = page.shape[0]
    P = pool.shape[0]
    L = len(field_w)
    k = "writeback"
    if not 1 <= L <= 5:
        raise KernelUnavailableError(k, f"{L} lanes: want 1..5")
    _check(k, pool, torch.int32, "pool", (P, _PW))
    _check(k, page, torch.int32, "page", (M,))
    _check(k, slot, torch.int32, "slot", (M,))
    _check(k, applied, torch.bool, "applied", (M,))
    _check(k, ent, torch.int32, "ent", (M, L))
    fw = (ctypes.c_int * 5)(*[int(w) for w in field_w])
    _call(k, "sherman_writeback", _dev_index(pool.device), pool.data_ptr(), P,
          page.data_ptr(), slot.data_ptr(), applied.data_ptr(),
          ent.data_ptr(), M, L, ctypes.cast(fw, ctypes.c_void_p), rows=M)
    return pool
