"""B+Tree page layout on [..., 256]-word int32 tensors, plus the numpy page
builders (counterpart of ``sherman_tpu/ops/layout.py``).

Sums follow the reference bit for bit: ``torch.sum`` of int32 returns
int64, so every masked sum is cast back with ``.to(torch.int32)``, which
wraps exactly as the reference's int32 sums do (garbage pages can make
several slots match).
"""

from __future__ import annotations

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch.ops import bits


# -- header accessors ---------------------------------------------------------

def h_front_ver(page):
    return page[..., C.W_FRONT_VER]


def h_rear_ver(page):
    return page[..., C.W_REAR_VER]


def h_leftmost(page):
    return page[..., C.W_LEFTMOST]


def h_sibling(page):
    return page[..., C.W_SIBLING]


def h_level(page):
    return page[..., C.W_LEVEL]


def h_nkeys(page):
    return page[..., C.W_NKEYS]


def h_lowest(page):
    return page[..., C.W_LOW_HI], page[..., C.W_LOW_LO]


def h_highest(page):
    return page[..., C.W_HIGH_HI], page[..., C.W_HIGH_LO]


def page_consistent(page):
    """Front/rear version match (torn-page check)."""
    return h_front_ver(page) == h_rear_ver(page)


def _wsum(vals, mask):
    """int32-wrapping masked sum over the last axis."""
    return torch.where(mask, vals, 0).sum(dim=-1).to(torch.int32)


# -- internal pages -----------------------------------------------------------

def internal_keys(page):
    return (page[..., C.I_KHI_W:C.I_KHI_W + C.INTERNAL_CAP],
            page[..., C.I_KLO_W:C.I_KLO_W + C.INTERNAL_CAP])


def internal_ptrs(page):
    return page[..., C.I_PTR_W:C.I_PTR_W + C.INTERNAL_CAP]


def internal_pick_child(page, khi, klo):
    """Child pick: keys below entry 0 go to leftmost_ptr, else the child
    of the last entry with entry.key <= k.  As in the reference, the
    child is the wrapping sum of ``ptr`` over every edge slot
    (``le & ~le_next``), which on unsorted garbage pages may be several."""
    ekhi, eklo = internal_keys(page)
    slots = torch.arange(C.INTERNAL_CAP, device=page.device)
    valid = slots < h_nkeys(page)[..., None]
    le = bits.key_le(ekhi, eklo, khi[..., None], klo[..., None]) & valid
    le_next = torch.cat([le[..., 1:], torch.zeros_like(le[..., :1])], dim=-1)
    edge = le & ~le_next
    child = _wsum(internal_ptrs(page), edge)
    return torch.where(le.any(dim=-1), child, h_leftmost(page))


# -- leaf pages ---------------------------------------------------------------

def _lf(page, start):
    return page[..., start:start + C.LEAF_CAP]


def ver_unpack(v):
    """Packed entry version word -> (fver, rver); tensors or numpy."""
    return (v >> 16) & C.ENTRY_VER_MASK, v & C.ENTRY_VER_MASK


def ver_pack(x):
    """Consistent entry version pair from one 16-bit value (int32 tensor
    shifts wrap two's-complement, matching the reference)."""
    return (x << 16) | x


def ver_pack_np(x) -> np.int32:
    """Host scalar packer: the int32 BIT PATTERN of (x << 16) | x."""
    p = ver_pack(int(x) & C.ENTRY_VER_MASK) & 0xFFFFFFFF
    return np.int32(p - (1 << 32) if p >= (1 << 31) else p)


def leaf_slots_view(page):
    """-> dict of [..., LEAF_CAP] tensors: ver (packed pair), khi, klo,
    vhi, vlo, plus the fver/rver halves."""
    ver = _lf(page, C.L_VER_W)
    fv, rv = ver_unpack(ver)
    return {"ver": ver, "fver": fv, "rver": rv,
            "khi": _lf(page, C.L_KHI_W), "klo": _lf(page, C.L_KLO_W),
            "vhi": _lf(page, C.L_VHI_W), "vlo": _lf(page, C.L_VLO_W)}


def leaf_slot_used(page):
    """A slot is live iff fver == rver != 0."""
    fv, rv = ver_unpack(_lf(page, C.L_VER_W))
    return (fv == rv) & (fv != 0)


def leaf_find_key(page, khi, klo):
    """Scan every slot -> (found, vhi, vlo, slot); slot = -1 when absent."""
    used = leaf_slot_used(page)
    hit = used & bits.key_eq(_lf(page, C.L_KHI_W), _lf(page, C.L_KLO_W),
                             khi[..., None], klo[..., None])
    found = hit.any(dim=-1)
    vhi = _wsum(_lf(page, C.L_VHI_W), hit)
    vlo = _wsum(_lf(page, C.L_VLO_W), hit)
    slots = torch.arange(C.LEAF_CAP, dtype=torch.int32, device=page.device)
    slot = _wsum(slots, hit)
    return found, vhi, vlo, torch.where(found, slot, -1)


def leaf_find_free_slot(page):
    """First free slot index, or -1 if the leaf is full."""
    free = ~leaf_slot_used(page)
    slot = torch.argmax(free.to(torch.uint8), dim=-1).to(torch.int32)
    return torch.where(free.any(dim=-1), slot, -1)


def in_fence(page, khi, klo):
    """lowest <= k < highest."""
    lhi, llo = h_lowest(page)
    hhi, hlo = h_highest(page)
    return bits.key_le(lhi, llo, khi, klo) & bits.key_lt(khi, klo, hhi, hlo)


def needs_sibling_chase(page, khi, klo):
    """k >= highest -> follow the B-link sibling."""
    hhi, hlo = h_highest(page)
    return ~bits.key_lt(khi, klo, hhi, hlo)


# -- host-side page construction (numpy) -------------------------------------

def np_empty_page(level: int, lowest: int, highest: int,
                  sibling: int = 0, leftmost: int = 0,
                  version: int = 1) -> np.ndarray:
    pg = np.zeros(C.PAGE_WORDS, dtype=np.int32)
    pg[C.W_FRONT_VER] = version
    pg[C.W_REAR_VER] = version
    pg[C.W_LEFTMOST] = leftmost
    pg[C.W_SIBLING] = sibling
    pg[C.W_LEVEL] = level
    pg[C.W_LOW_HI], pg[C.W_LOW_LO] = bits.key_to_pair(lowest)
    pg[C.W_HIGH_HI], pg[C.W_HIGH_LO] = bits.key_to_pair(highest)
    return pg


def leaf_slot_words(slot):
    """Word offsets of one leaf slot's five fields (ver, khi, klo, vhi, vlo)."""
    return (C.L_VER_W + slot, C.L_KHI_W + slot, C.L_KLO_W + slot,
            C.L_VHI_W + slot, C.L_VLO_W + slot)


def np_leaf_set_entry(pg: np.ndarray, slot: int, key: int, value: int,
                      ver: int = 1) -> None:
    wv, wkh, wkl, wvh, wvl = leaf_slot_words(slot)
    pg[wv] = ver_pack_np(ver)
    pg[wkh], pg[wkl] = bits.key_to_pair(key)
    pg[wvh], pg[wvl] = bits.key_to_pair(value)


def np_internal_set_entry(pg: np.ndarray, slot: int, key: int,
                          child: int) -> None:
    pg[C.I_KHI_W + slot], pg[C.I_KLO_W + slot] = bits.key_to_pair(key)
    pg[C.I_PTR_W + slot] = child


def np_internal_rebuild(pg: np.ndarray, ents: list, level: int) -> np.ndarray:
    """Rebuild an internal page around sorted ``ents`` [(key, child)],
    keeping fences, sibling and leftmost and bumping the version (the
    merge of the host parent insert and the engine's batched flush)."""
    ver = ((int(pg[C.W_FRONT_VER]) + 1) & 0x7FFFFFFF) or 1
    newpg = np_empty_page(
        level, np_lowest(pg), np_highest(pg), sibling=int(pg[C.W_SIBLING]),
        leftmost=int(pg[C.W_LEFTMOST]), version=ver)
    for i, (k, c) in enumerate(ents):
        np_internal_set_entry(newpg, i, k, c)
    newpg[C.W_NKEYS] = len(ents)
    return newpg


def np_slot_live(pg: np.ndarray, slot: int) -> bool:
    fv, rv = ver_unpack(int(pg[C.L_VER_W + slot]) & 0xFFFFFFFF)
    return bool(fv == rv and fv != 0)


def np_leaf_entries(pg: np.ndarray) -> list[tuple[int, int, int]]:
    """-> list of (key, value, slot) of live entries."""
    out = []
    for s in range(C.LEAF_CAP):
        if np_slot_live(pg, s):
            k = bits.pair_to_key(pg[C.L_KHI_W + s], pg[C.L_KLO_W + s])
            v = bits.pair_to_key(pg[C.L_VHI_W + s], pg[C.L_VLO_W + s])
            out.append((k, v, s))
    return out


def np_leaf_entries_batch(pages: np.ndarray):
    """Live entries of ``[W, PAGE_WORDS]`` leaf pages at once (the scan's
    extraction; host twin of :func:`leaf_slot_used`).  -> (keys uint64
    [W, LEAF_CAP], vals uint64 [W, LEAF_CAP], live bool [W, LEAF_CAP])."""
    fv, rv = ver_unpack(
        pages[:, C.L_VER_W:C.L_VER_W + C.LEAF_CAP].view(np.uint32))
    live = (fv == rv) & (fv != 0)
    keys = bits.pairs_to_keys(pages[:, C.L_KHI_W:C.L_KHI_W + C.LEAF_CAP],
                              pages[:, C.L_KLO_W:C.L_KLO_W + C.LEAF_CAP])
    vals = bits.pairs_to_keys(pages[:, C.L_VHI_W:C.L_VHI_W + C.LEAF_CAP],
                              pages[:, C.L_VLO_W:C.L_VLO_W + C.LEAF_CAP])
    return keys, vals, live


def np_internal_entries(pg: np.ndarray) -> list[tuple[int, int]]:
    """-> list of (key, child) of an internal page's entries."""
    out = []
    for s in range(int(pg[C.W_NKEYS])):
        k = bits.pair_to_key(pg[C.I_KHI_W + s], pg[C.I_KLO_W + s])
        out.append((k, int(pg[C.I_PTR_W + s])))
    return out


def np_lowest(pg: np.ndarray) -> int:
    return bits.pair_to_key(pg[C.W_LOW_HI], pg[C.W_LOW_LO])


def np_highest(pg: np.ndarray) -> int:
    return bits.pair_to_key(pg[C.W_HIGH_HI], pg[C.W_HIGH_LO])


def np_pick_child(pg: np.ndarray, key: int) -> int:
    """Host child pick: the child of the last entry with key <= ``key``,
    else leftmost."""
    child = int(pg[C.W_LEFTMOST])
    for k, ptr in np_internal_entries(pg):
        if k <= key:
            child = ptr
        else:
            break
    return child


def np_leaf_find(pg: np.ndarray, key: int) -> tuple[int, int | None]:
    """Host leaf scan: -> (slot, value) or (-1, None)."""
    for k, v, s in np_leaf_entries(pg):
        if k == key:
            return s, v
    return -1, None


def np_leaf_free_slot(pg: np.ndarray) -> int:
    """First free slot of a leaf, or -1 when it is full."""
    for s in range(C.LEAF_CAP):
        if not np_slot_live(pg, s):
            return s
    return -1
