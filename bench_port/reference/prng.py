"""Counter-based keys and draws, bit for bit with ``jax.random``'s
threefry2x32 (jax 0.9, ``jax_threefry_partitionable`` on).

A frozen copy of the algorithm the program under test draws its keys,
Shapley masks and surrogate initialisations with, kept here so that the
reference derives every draw from the seed by itself.  The host functions
are numpy; the ``*_tensor`` functions are the same cipher on int64 torch
tensors (words masked to 32 bits after every add), for draws made on the
card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# the same cipher on tensors (keys [Q, 2], words held in int64)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotl_tensor(v: torch.Tensor, r: int) -> torch.Tensor:
    # v < 2**32 and r <= 29, so v << r stays inside int64
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32_tensor(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int64 tensors of 32-bit words; key words and
    counters broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a = (x0 + ks[0]) & _M32
    b = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl_tensor(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def fold_in_tensor(keys: torch.Tensor, data: int) -> torch.Tensor:
    """:func:`fold_in` of every key of a ``[Q, 2]`` int64 stack."""
    zero = torch.zeros((), dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32_tensor(
        keys[:, 0], keys[:, 1], zero, zero + (int(data) & _M32)
    )
    return torch.stack([y0, y1], dim=1)


def random_bits_tensor(keys: torch.Tensor, count: int) -> torch.Tensor:
    """The 32 random bits ``jax.random`` draws for ``count`` values under
    each key of a ``[Q, 2]`` int64 stack: threefry over the flattened
    counter ``0 .. count-1`` with high word 0, the two output words xored.
    Returns ``[Q, count]`` int64."""
    if count >= 1 << 32:
        raise ValueError("a draw of 2**32 or more values needs the high counter word")
    lo = torch.arange(count, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32_tensor(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return y0 ^ y1


def _unit_float_tensor(bits: torch.Tensor) -> torch.Tensor:
    """Bits -> float32 in [0, 1): 23 mantissa bits under exponent 0."""
    one = 0x3F800000
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def uniform_tensor(keys: torch.Tensor, size: int, minval: float, maxval: float) -> torch.Tensor:
    """:func:`uniform` for every key of a ``[Q, 2]`` stack: ``[Q, size]``
    float32 (the affine step rounded once, as there)."""
    u = _unit_float_tensor(random_bits_tensor(keys, size))
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    vals = (u.to(torch.float64) * span + lo).to(torch.float32)
    return torch.clamp(vals, min=lo)


def bernoulli_tensor(keys: torch.Tensor, p: float, m: int, n: int) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (m, n))`` for every key of a
    ``[Q, 2]`` int64 stack: ``[Q, m, n]`` bool on the keys' device, bit for
    bit with ``uniform(key, m * n, 0, 1).reshape(m, n) < p``."""
    u = _unit_float_tensor(random_bits_tensor(keys, m * n))
    return (u < float(np.float32(p))).view(keys.shape[0], m, n)
