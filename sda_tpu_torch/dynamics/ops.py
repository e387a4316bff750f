r"""Differentiable grid operators on channel-first periodic fields.

Counterpart of :mod:`sda_tpu.dynamics.ops` (``coarsen`` and ``vorticity``;
``upsample`` is not ported yet). They build observation operators, so they
sit inside the guidance gradient.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def coarsen(x: Tensor, r: int = 2) -> Tensor:
    r"""Mean-pool coarsening by a factor ``r`` over the last two axes."""

    *batch, h, w = x.shape

    x = x.reshape(*batch, h // r, r, w // r, r)

    return x.mean(dim=(-3, -1))


def vorticity(x: Tensor) -> Tensor:
    r"""Central-difference vorticity of a velocity field ``(..., 2, H, W)``:
    ``du/d(axis -1) - dv/d(axis -2)`` with periodic boundaries."""

    u = x[..., 0, :, :]
    v = x[..., 1, :, :]

    du = (torch.roll(u, -1, dims=-1) - torch.roll(u, 1, dims=-1)) / 2
    dv = (torch.roll(v, -1, dims=-2) - torch.roll(v, 1, dims=-2)) / 2

    return du - dv
