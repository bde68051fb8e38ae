"""``jax.random.uniform(PRNGKey(seed), (n,), dtype)`` in NumPy, bit for bit.

The power solver's start vector is ``uniform - 0.5`` (gKL2.cu:322's
``srand(42)`` analog, ``eig_kl_tpu/spectral/power.py:189-190``).  The
port reproduces the JAX package's draw exactly, so that both packages
start the iteration from the same bits.

This is Threefry-2x32 with 20 rounds (Salmon et al., SC'11), counted
the way JAX's partitionable mode counts (the default since jax 0.5):
element ``i`` of a 1-D draw hashes the counter pair ``(0, i)``.  A
32-bit draw takes ``hi ^ lo`` of the hashed pair, a 64-bit draw takes
``hi << 32 | lo``.  The float is built from the top mantissa bits with
exponent 0 (a value in [1, 2)), minus 1.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Hash the counter pairs ``(x0[i], x1[i])`` under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as a pair of uint32 words."""
    seed = int(seed)
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def uniform(seed: int, n: int, dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype)``."""
    dtype = np.dtype(dtype)
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(
            prng_key(seed),
            (idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        )
    if dtype == np.float32:
        bits = (hi ^ lo) >> np.uint32(32 - 23)
        bits |= np.array(1.0, np.float32).view(np.uint32)
        return bits.view(np.float32) - np.float32(1.0)
    if dtype == np.float64:
        bits = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        bits = bits >> np.uint64(64 - 52)
        bits |= np.array(1.0, np.float64).view(np.uint64)
        return bits.view(np.float64) - np.float64(1.0)
    raise TypeError(f"uniform supports float32 and float64, got {dtype}")
