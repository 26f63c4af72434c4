"""Keyed counter-based RNG: threefry-2x32 as ``jax.random`` computes it.

The JAX package draws its bagging and feature-fraction masks from
``jax.random`` keys that are pure functions of (seed, counter)
(``boosting/gbdt.py:_device_bag_mask``/``_device_feature_mask``).  To
train the same models the port reproduces those bits exactly, with
``jax_threefry_partitionable`` on (JAX's default):

* :func:`PRNGKey` is ``jax.random.PRNGKey`` (``prng.threefry_seed``):
  the key ``[seed >> 32, seed & 0xFFFFFFFF]`` of a 32-bit seed;
* :func:`fold_in` is ``jax.random.fold_in`` (``prng.threefry_fold_in``):
  the threefry hash of the count pair ``(0, data)`` under the key;
* :func:`uniform` is ``jax.random.uniform`` for float32 in ``[0, 1)``
  (``random._uniform`` over ``prng._threefry_random_bits_partitionable``):
  the hash of the 64-bit counters ``(0, i)``, the two output words
  xored, the top 23 bits as a mantissa of ``[1, 2)``, minus one;
* :func:`threefry_2x32` is the hash itself (``prng._threefry2x32_lowering``,
  20 rounds with key injection every 4).

uint32 arithmetic is carried in int64 tensors and masked after each add
and shift.  Keys are host tuples of two ints; the bits are computed on
the ``device`` the caller names.  There is no global state.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry_2x32(key: Key, x0, x1):
    """The threefry-2x32 hash of the count words ``(x0, x1)`` (int64
    tensors holding uint32 values, or ints) under ``key``."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (torch.as_tensor(x0, dtype=torch.int64) + ks[0]) & _M32
    x1 = (torch.as_tensor(x1, dtype=torch.int64) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} outside the int32 range")
    return (0, seed & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: a new key from ``key`` and a
    32-bit counter."""
    a, b = threefry_2x32(key, torch.zeros(1, dtype=torch.int64),
                         torch.tensor([int(data) & _M32]))
    return int(a[0]), int(b[0])


def random_bits(key: Key, n: int, device="cpu") -> torch.Tensor:
    """``n`` 32-bit words (int64 tensor): the hash of the counters
    ``0 .. n-1``, both output words xored."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry_2x32(key, i >> 32, i & _M32)
    return hi ^ lo


def uniform(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in ``[0, 1)``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for d in shape:
        n *= int(d)
    bits = random_bits(key, n, device)
    one = 0x3F800000                      # float32 1.0
    f = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    return f.reshape(shape)
