"""Bit-level primitives on tensors and numpy arrays: 64-bit keys as int32
pairs, packed global addresses, unsigned compares and the lock hash
(counterpart of ``sherman_tpu/ops/bits.py``).

Torch shifts a signed int32 arithmetically, while the reference shifts
uint32 logically (``addr_node``, ``hash32``): those functions widen to
int64 and mask with ``0xFFFFFFFF`` so every bit matches.
"""

from __future__ import annotations

import numpy as np
import torch

from sherman_tpu_torch.config import ADDR_PAGE_BITS, ADDR_PAGE_MASK

_SIGN = -(1 << 31)            # int32 bit pattern 0x80000000
_U32_MASK = (1 << 32) - 1


# -- host-side scalar / numpy helpers ---------------------------------------

def key_to_pair(k: int) -> tuple[int, int]:
    """Split a Python uint64 key into (hi, lo) int32 bit patterns."""
    k = int(k) & ((1 << 64) - 1)
    hi = np.uint32(k >> 32).view(np.int32).item()
    lo = np.uint32(k & _U32_MASK).view(np.int32).item()
    return hi, lo


def pair_to_key(hi, lo) -> int:
    """Rebuild the Python uint64 key from (hi, lo) int32 bit patterns."""
    return ((int(hi) & _U32_MASK) << 32) | (int(lo) & _U32_MASK)


def keys_to_pairs(ks) -> tuple[np.ndarray, np.ndarray]:
    """uint64 array -> (hi, lo) int32 arrays."""
    ks = np.asarray(ks, dtype=np.uint64)
    hi = (ks >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (ks & np.uint64(_U32_MASK)).astype(np.uint32).view(np.int32)
    return hi, lo


def pairs_to_keys(hi, lo) -> np.ndarray:
    """(hi, lo) int32 arrays -> uint64 array."""
    hi = np.asarray(hi).view(np.uint32).astype(np.uint64)
    lo = np.asarray(lo).view(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


# -- tensor unsigned compares on (hi, lo) pairs ------------------------------

def _ux(x: torch.Tensor) -> torch.Tensor:
    """Flip the sign bit: signed compares of the result order the int32
    words as uint32."""
    return x ^ _SIGN


def u32_lt(a, b):
    return _ux(a) < _ux(b)


def u32_le(a, b):
    return _ux(a) <= _ux(b)


def key_lt(ahi, alo, bhi, blo):
    """(ahi, alo) < (bhi, blo) as uint64."""
    return u32_lt(ahi, bhi) | ((ahi == bhi) & u32_lt(alo, blo))


def key_le(ahi, alo, bhi, blo):
    return u32_lt(ahi, bhi) | ((ahi == bhi) & u32_le(alo, blo))


def key_eq(ahi, alo, bhi, blo):
    return (ahi == bhi) & (alo == blo)


# -- packed global page addresses -------------------------------------------

def _i32(v: int) -> int:
    v &= _U32_MASK
    return v - (1 << 32) if v >= (1 << 31) else v


def make_addr(node, page):
    """Pack (node, page) into an int32 address; ints or tensors."""
    if isinstance(node, (int, np.integer)) and isinstance(page, (int, np.integer)):
        return _i32((int(node) << ADDR_PAGE_BITS) | (int(page) & ADDR_PAGE_MASK))
    node = torch.as_tensor(node).to(torch.int64)
    page = torch.as_tensor(page).to(torch.int64)
    v = ((node << ADDR_PAGE_BITS) | (page & ADDR_PAGE_MASK)) & _U32_MASK
    return v.to(torch.int32)   # two's-complement wrap of the uint32 word


def addr_node(addr):
    """Node field of a packed address (logical shift of the uint32)."""
    if isinstance(addr, (int, np.integer)):
        return (int(addr) & _U32_MASK) >> ADDR_PAGE_BITS
    a = torch.as_tensor(addr).to(torch.int64) & _U32_MASK
    return (a >> ADDR_PAGE_BITS).to(torch.int32)


def addr_page(addr):
    if isinstance(addr, (int, np.integer)):
        return int(addr) & ADDR_PAGE_MASK
    return torch.as_tensor(addr) & ADDR_PAGE_MASK


def addr_is_null(addr) -> bool:
    return int(addr) == 0


# -- lock leases --------------------------------------------------------------

LEASE_OWNER_BITS = 16
LEASE_EPOCH_BITS = 15
LEASE_OWNER_MASK = (1 << LEASE_OWNER_BITS) - 1
LEASE_EPOCH_MASK = (1 << LEASE_EPOCH_BITS) - 1
# both fields: the bits a lease revocation's masked CAS compares and swaps
LEASE_MASK = (LEASE_EPOCH_MASK << LEASE_OWNER_BITS) | LEASE_OWNER_MASK


def lease_word(owner_tag: int, epoch: int = 1) -> int:
    """Pack (owner tag, lease epoch) into a held-lock word (int32 >= 0)."""
    if not 0 < int(owner_tag) <= LEASE_OWNER_MASK:
        raise ValueError("owner tag out of range")
    return ((int(epoch) & LEASE_EPOCH_MASK) << LEASE_OWNER_BITS) \
        | (int(owner_tag) & LEASE_OWNER_MASK)


def lease_owner(word: int) -> int:
    """Owner tag of a held-lock word (0 = free)."""
    return (int(word) & _U32_MASK) & LEASE_OWNER_MASK


def lease_epoch(word: int) -> int:
    """Lease epoch of a held-lock word."""
    return ((int(word) & _U32_MASK) >> LEASE_OWNER_BITS) & LEASE_EPOCH_MASK


# -- lock hash (32-bit Murmur3 finalizer) ------------------------------------

def hash32(x) -> torch.Tensor:
    """Murmur3 finalizer of the uint32 word; returns int64 in [0, 2^32)
    (torch has no full uint32 arithmetic, so the value rides int64)."""
    v = torch.as_tensor(x).to(torch.int64) & _U32_MASK
    v = v ^ (v >> 16)
    v = (v * 0x85EBCA6B) & _U32_MASK
    v = v ^ (v >> 13)
    v = (v * 0xC2B2AE35) & _U32_MASK
    v = v ^ (v >> 16)
    return v


def lock_index(addr, locks_per_node: int) -> torch.Tensor:
    """Lock word index for a page address (int32)."""
    return (hash32(addr) % locks_per_node).to(torch.int32)


def hash32_host(x: int) -> int:
    v = int(x) & _U32_MASK
    v ^= v >> 16
    v = (v * 0x85EBCA6B) & _U32_MASK
    v ^= v >> 13
    v = (v * 0xC2B2AE35) & _U32_MASK
    v ^= v >> 16
    return v


def lock_index_host(addr: int, locks_per_node: int) -> int:
    return hash32_host(addr) % locks_per_node


# -- splitmix64 finalizer (the bench's rank -> key map) ----------------------

def mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on uint64 arrays (numpy wraps on overflow)."""
    x = np.asarray(x, np.uint64).copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def mix64_host(x: int) -> int:
    """Scalar twin of :func:`mix64_np` on a Python int (the YCSB payload
    seed)."""
    x = int(x) & ((1 << 64) - 1)
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    return x


# -- 64-bit pair arithmetic on uint32 words ------------------------------------
# The device-resident workload generator composes a few uint64 operations
# (the splitmix64 finalizer, the router's bucket shift) from (hi, lo) uint32
# words.  Torch has no unsigned 32-bit type, so here a word is an int64
# tensor holding a value in [0, 2^32): every sum and shift is masked back
# to 32 bits, and a 32x32-bit product is built from 16-bit limbs, whose
# partial products fit in 32 bits (a full product would overflow int64's
# sign).  Shift amounts of the static forms are Python ints.

U32_MASK = _U32_MASK


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> uint32 words in int64."""
    return x.to(torch.int64) & _U32_MASK


def i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 words in int64 -> the same bits as int32."""
    return x.to(torch.int32)


def u32_mul_full(a, b):
    """Full 32x32 -> 64-bit product of uint32 words via 16-bit limbs:
    returns (hi, lo) words."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p00, p01 = a0 * b0, a0 * b1
    p10, p11 = a1 * b0, a1 * b1
    t = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = (p00 & 0xFFFF) | ((t & 0xFFFF) << 16)
    hi = (p11 + (p01 >> 16) + (p10 >> 16) + (t >> 16)) & _U32_MASK
    return hi, lo


def _u32_mul_lo(a, b):
    """Low word of the product of two uint32 words (the wrapping uint32
    multiply); the limb cross terms stay below 2^49."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    return (a0 * b0 + ((a0 * b1 + a1 * b0) << 16)) & _U32_MASK


def u64_mul(ahi, alo, bhi, blo):
    """(ahi, alo) * (bhi, blo) mod 2^64 -> (hi, lo) words.  The cross
    terms reach only the high word, so their low words suffice."""
    hi, lo = u32_mul_full(alo, blo)
    hi = (hi + _u32_mul_lo(alo, bhi) + _u32_mul_lo(ahi, blo)) & _U32_MASK
    return hi, lo


def u64_shr(hi, lo, s: int):
    """Logical right shift of a (hi, lo) word pair by a static ``s``."""
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> s, ((lo >> s) | (hi << (32 - s))) & _U32_MASK
    if s == 32:
        return torch.zeros_like(hi), hi
    return torch.zeros_like(hi), hi >> (s - 32)


def u64_shr_dyn(hi, lo, s):
    """Logical right shift of a (hi, lo) word pair by a tensor shift
    ``s`` (0 <= s <= 63, broadcast against the words).  Each branch
    shifts by an amount clamped into range and ``torch.where`` picks."""
    s = torch.as_tensor(s, dtype=torch.int64, device=hi.device)
    s_lo = s.clamp(max=31)
    s_hi = torch.where(s >= 32, s - 32, 0)
    lo_small = ((lo >> s_lo) | (hi << (32 - s_lo))) & _U32_MASK
    big = s >= 32
    out_hi = torch.where(big, 0, hi >> s_lo)
    out_lo = torch.where(big, hi >> s_hi, lo_small)
    return out_hi, out_lo


_MIX64_C1 = (0xBF58476D, 0x1CE4E5B9)  # splitmix64 finalizer constants
_MIX64_C2 = (0x94D049BB, 0x133111EB)


def mix64_pair(hi, lo):
    """splitmix64 finalizer on (hi, lo) uint32 words — the device twin of
    :func:`mix64_np`, so a device-generated batch hits exactly the keys
    the bulk load wrote."""
    h, l = u64_shr(hi, lo, 30)
    hi, lo = hi ^ h, lo ^ l
    hi, lo = u64_mul(hi, lo, _MIX64_C1[0], _MIX64_C1[1])
    h, l = u64_shr(hi, lo, 27)
    hi, lo = hi ^ h, lo ^ l
    hi, lo = u64_mul(hi, lo, _MIX64_C2[0], _MIX64_C2[1])
    h, l = u64_shr(hi, lo, 31)
    return hi ^ h, lo ^ l
