"""JAX's default random numbers, reproduced bit for bit: threefry-2x32 and
`jax.random.uniform`'s mapping from bits to floats.

The fire-scene preprocessing adds noise drawn from `jax.random.key(0)` to the
model's input, so a frame gives the reference's depth only if the port draws
the same bits. This restates, in numpy uint32 arithmetic on the host, what
JAX computes with `jax_threefry_partitionable = True` (its default from 0.5
on): element i of a shape draws threefry2x32(key, (hi32(i), lo32(i))) over
the row-major flat index i, and its 32 bits are the XOR of the two output
words; `uniform` keeps the top 23 bits as the mantissa of a float in
[1, 2) and subtracts 1.

    uniform_f32((2, 3))[0, 0] == 0.947667  # jax.random.uniform(key(0), (2, 3))
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1),
    uint32 arrays of one shape, under the key pair `key`."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0]) ^ np.uint32(key[1]) ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits32(shape: Tuple[int, ...], key: Tuple[int, int] = (0, 0)) -> np.ndarray:
    """uint32 bits of `jax.random.bits(key, shape)` for a threefry key
    (`jax.random.key(0)` is the pair (0, 0)), partitionable layout."""
    n = int(np.prod(shape, dtype=np.int64))
    index = np.arange(n, dtype=np.uint64)
    hi = (index >> np.uint64(32)).astype(np.uint32)
    lo = (index & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


@functools.lru_cache(maxsize=16)
def uniform_f32(shape: Tuple[int, ...], key: Tuple[int, int] = (0, 0)) -> np.ndarray:
    """Read-only float32 `jax.random.uniform(key, shape)` in [0, 1), cached
    by shape (the fire-scene key is fixed, so each frame size is drawn once)."""
    bits = random_bits32(tuple(shape), key)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    out = np.maximum(np.float32(0.0), floats)
    out.flags.writeable = False
    return out
