"""JAX's threefry-2x32 random draws, reproduced bit for bit in integers.

The reference keys its per-step randomness as ``fold_in(key(seed), step)``
(the augmentation's orientation, N2V's blind spots). These functions give
the same bits as ``jax.random`` with ``jax_threefry_partitionable`` on
(JAX's default):

* a key is a pair of uint32 words; ``key(seed)`` of an int32 seed is
  ``(0, seed)``;
* ``fold_in(k, d)`` and the ``i``-th key of ``split(k)`` hash the counter
  ``(0, d)`` / ``(0, i)`` with ``k``;
* ``random_bits(k, n)``: word ``i`` is the XOR of the two words that ``k``
  hashes from the counter ``(i >> 32, i & 0xffffffff)``.

:func:`threefry2x32` runs on Python ints and on int64 tensors alike (every
word is kept below 2³² by masking), so a draw the size of a training batch
runs on the card as plain tensor arithmetic and none is made on the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "threefry2x32",
    "key",
    "fold_in",
    "split",
    "random_bits",
    "uniform_below",
    "randint",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 words (ints, or int64
    tensors holding them), as ``jax._src.prng`` applies it: key schedule
    with 0x1BD11BDA, an injection after every 4 rounds."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed):
    """``jax.random.key(seed)`` of an int32 seed as its two words."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"the seed must be an int32, got {seed}")
    return 0, seed & _M32


def fold_in(k, data):
    """``jax.random.fold_in(k, data)`` (``data`` a uint32)."""
    return threefry2x32(*k, 0, int(data) & _M32)


def split(k, num=2):
    """``jax.random.split(k, num)`` as a tuple of keys."""
    return tuple(threefry2x32(*k, 0, i) for i in range(num))


def random_bits(k, shape, device="cuda"):
    """``jax.random.bits(k, shape)`` (uint32) as an int64 tensor on
    ``device``."""
    n = int(np.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(*k, i >> 32, i & _M32)
    return (w0 ^ w1).reshape(tuple(shape))


def uniform_below(k, shape, rate, device="cuda"):
    """``jax.random.uniform(k, shape) < rate`` as a bool tensor on
    ``device``, in integers: the float32 uniform is ``(bits >> 9) · 2⁻²³``,
    exactly, so it is below the float32 ``rate`` where ``bits >> 9`` is
    below ``ceil(rate · 2²³)``."""
    limit = int(np.ceil(float(np.float32(rate)) * 2.0 ** 23))
    return (random_bits(k, shape, device) >> 9) < limit


def randint(k, shape, minval, maxval):
    """``jax.random.randint(k, shape, minval, maxval)`` (int32) as an int64
    numpy array: two draws of bits from ``split(k)``, reduced as JAX does
    (``(hi mod span · (2¹⁶ mod span)² mod span + lo mod span) mod span``
    in uint32)."""
    span = max(int(maxval) - int(minval), 1) & _M32
    hi, lo = (random_bits(s, shape, "cpu").numpy() for s in split(k))
    mult = ((((1 << 16) % span) ** 2) & _M32) % span
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return int(minval) + off % span
