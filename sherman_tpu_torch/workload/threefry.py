"""Counter-based Threefry-2x32 random bits — the port's copy of what the
staged serving loop takes from ``jax.random`` (``PRNGKey``, ``fold_in``,
``bits`` in the partitionable form, the default of the JAX releases the
reference runs on).

A key is an int64 tensor ``[..., 2]`` of uint32 words; torch has no
unsigned 32-bit type, so every word rides int64 and is masked back to 32
bits after each add and rotate.  Leading dimensions of a key broadcast:
``fold_in`` of ``N`` data words gives ``N`` keys, and ``bits`` of ``N``
keys gives ``N`` independent streams in one pass.

- ``PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]`` of the seed as
  the reference's runtime holds it: with 64-bit types disabled (the
  JAX default) the seed is first cut to its low 32 bits, so the high
  word is 0.
- ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``.
- ``bits(key, shape)``: the counters are the flat uint64 iota over
  ``shape`` split into (hi, lo) words; the output word is the xor of the
  hash's two output words.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw key ``[0, seed mod 2^32]`` (int64 words) on ``device``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 hash of counter words ``(x0, x1)``
    under key words ``(k1, k2)``, elementwise with broadcasting; every
    operand is uint32 words in int64.  -> (y0, y1)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0.add(x1).bitwise_and_(MASK)
            x1 = (x1 << r).bitwise_or_(x1 >> (32 - r)).bitwise_and_(MASK)
            x1.bitwise_xor_(x0)
        x0 = x0.add(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1 = x1.add(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """New key(s) from ``key`` and uint32 ``data`` (an int or a tensor
    of any shape broadcasting against ``key[..., 0]``)."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """uint32 words (in int64) of ``shape`` from ``key``; a key with
    leading dimensions ``K`` gives ``K + shape``."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    y0, y1 = threefry2x32(k1, k2, count >> 32, count & MASK)
    return (y0 ^ y1).reshape(lead + shape)
