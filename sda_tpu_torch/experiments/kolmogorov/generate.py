r"""Kolmogorov truth simulation (``experiments/kolmogorov/generate.py:57-63``).

The JAX experiment writes 1024 trajectories to HDF5; the port simulates the
trajectories it needs on the device instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...dynamics import KolmogorovFlow, coarsen


def simulate(
    chain: KolmogorovFlow,
    batch: int = 1,
    length: int = 128,
    keep: int = 64,
    coarse: int = 4,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""Samples ``batch`` initial states from the prior (or from the white
    ``noise`` given), rolls out ``length`` transitions, keeps the last
    ``keep`` and coarsens them ``coarse`` times:
    ``(batch, keep, 2, size / coarse, size / coarse)``."""

    x = chain.prior((batch,), generator=generator, noise=noise)
    xs = chain.trajectory(x, length=length)  # (length, batch, 2, size, size)
    xs = coarsen(xs[length - keep:], coarse)

    return xs.transpose(0, 1)
