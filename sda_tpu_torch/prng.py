r"""JAX's default PRNG replayed in numpy, for inputs that the JAX package
drew from a fixed key.

The golden probes of the committed checkpoints
(``tests/golden/committed_artifacts.json``) were evaluated on
``jax.random.normal(jax.random.key(seed), shape)``. :func:`normal` rebuilds
that array without JAX: threefry2x32 over a 64-bit counter (JAX's
``threefry_partitionable`` layout, its default), the top 23 bits of each
word as a float in ``[1, 2)``, mapped to ``(-1, 1)`` and through
``sqrt(2) erfinv``. The bits are exact; ``erfinv`` is evaluated in float64
and rounded, so values may differ from XLA's float32 ``erfinv`` in the last
bit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    r"""The threefry2x32 block cipher (20 rounds) of the counters
    ``(x0, x1)`` under ``key``, in uint32 arithmetic."""

    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))

    with np.errstate(over='ignore'):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)

    return x0, x1


def random_bits(seed: int, shape: Sequence[int]) -> np.ndarray:
    r"""``jax.random.bits(jax.random.key(seed), shape, uint32)`` for a seed
    in ``[0, 2^31)`` (JAX's int32 seeds without 64-bit mode)."""

    if not 0 <= seed < 2**31:
        raise ValueError(f'seed {seed} is outside [0, 2^31)')
    key = (0, seed)
    count = np.arange(math.prod(shape), dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    bits0, bits1 = threefry2x32(key, hi, lo)

    return (bits0 ^ bits1).reshape(tuple(shape))


def normal(seed: int, shape: Sequence[int]) -> torch.Tensor:
    r"""``jax.random.normal(jax.random.key(seed), shape)`` as a float32
    tensor on the CPU."""

    bits = random_bits(seed, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)

    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    u = torch.from_numpy(u.astype(np.float64))

    return (math.sqrt(2) * torch.special.erfinv(u)).to(torch.float32)
