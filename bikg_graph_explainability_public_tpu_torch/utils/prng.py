"""Counter-based PRNG keys, bit-exact with ``jax.random``'s threefry2x32.

Every random draw of an explanation derives from one integer seed: the
repeat index is folded into the root key and the result split into a mask
key and a surrogate-init key.  The mask sampler seeds numpy Philox streams
from those key words (:mod:`..explain.masks`), so reproducing the key words
bit for bit reproduces the masks bit for bit.

This module is plain numpy.  It follows jax 0.9 with
``jax_threefry_partitionable`` on (its default): ``split`` and the random
bits of ``uniform`` hash an iota counter pair ``(hi, lo)`` elementwise.
Keys are ``[2]`` uint32 arrays (what ``jax.random.key_data`` returns).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(
    key: np.ndarray, x0: np.ndarray, x1: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block cipher, elementwise over the counter
    words ``(x0, x1)`` (same shape, uint32) under the ``[2]`` uint32 key."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def root_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``."""
    y0, y1 = threefry2x32(
        key, np.zeros(1, np.uint32), np.array([int(data) & 0xFFFFFFFF], np.uint32)
    )
    return np.array([y0[0], y1[0]], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable form): ``[num, 2]`` uint32."""
    y0, y1 = threefry2x32(
        key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32)
    )
    return np.stack([y0, y1], axis=1)


def repeat_key(seed: int, repeat: int) -> np.ndarray:
    """Key for repeat ``repeat`` of an explanation run."""
    return fold_in(root_key(seed), repeat)


def repeat_split_key_data(seed: int, times: int) -> np.ndarray:
    """``key_data(split(repeat_key(seed, t)))`` for every repeat: ``[T, 2, 2]``
    uint32.  Row ``[t, 0]`` is the mask key, ``[t, 1]`` the surrogate-init
    key."""
    return np.stack([split(repeat_key(seed, t)) for t in range(int(times))])


def uniform(
    key: np.ndarray, size: int, minval: float, maxval: float
) -> np.ndarray:
    """``jax.random.uniform(key, (size,), float32, minval, maxval)``.

    The affine step ``u * (maxval - minval) + minval`` is evaluated in
    float64 and rounded once: the product of two float32 values is exact in
    float64, so this equals the fused multiply-add that XLA emits.
    """
    hi = np.zeros(size, np.uint32)
    y0, y1 = threefry2x32(key, hi, np.arange(size, dtype=np.uint32))
    bits = y0 ^ y1
    one = np.array(1.0, np.float32).view(np.uint32)
    u = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi_v = np.float32(minval), np.float32(maxval)
    span = np.float64(hi_v - lo)
    vals = (u.astype(np.float64) * span + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, vals)
