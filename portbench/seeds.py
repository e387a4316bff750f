r"""Generators on the device, seeded from the run's ``--seed`` and a path of
keys, so that every input of a run depends on the seed alone and the
program and the reference are handed the same draws."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def seed_of(seed: int, *keys) -> int:
    r"""A 63-bit seed from ``seed`` (any whole number) and ``keys`` (strings
    or whole numbers)."""

    words = [seed % 2**64] + [zlib.crc32(k.encode()) if isinstance(k, str) else k % 2**64 for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) % 2**63


def generator(seed: int, *keys, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, *keys))
