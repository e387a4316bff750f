r"""Differentiable grid operators on channel-first periodic fields.

Counterpart of :mod:`sda_tpu.dynamics.ops` (``coarsen``, ``upsample`` and
``vorticity``). They build observation operators, so they sit inside the
guidance gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def coarsen(x: Tensor, r: int = 2) -> Tensor:
    r"""Mean-pool coarsening by a factor ``r`` over the last two axes."""

    *batch, h, w = x.shape

    x = x.reshape(*batch, h // r, r, w // r, r)

    return x.mean(dim=(-3, -1))


def upsample(x: Tensor, r: int = 2, mode: str = 'bilinear') -> Tensor:
    r"""Periodic upsampling by a factor ``r`` over the last two axes: pad one
    cell circularly, interpolate ``r`` times (half-pixel centred for
    ``'bilinear'``, as ``jax.image.resize``; each cell repeated for
    ``'nearest'``), then crop the padding back off."""

    *batch, h, w = x.shape
    x = x.reshape(-1, 1, h, w)

    x = F.pad(x, (1, 1, 1, 1), mode='circular')

    if mode == 'nearest':
        x = x.repeat_interleave(r, dim=-2).repeat_interleave(r, dim=-1)
    elif mode == 'bilinear':
        x = F.interpolate(x, scale_factor=r, mode='bilinear', align_corners=False)
    else:
        raise ValueError(f"unknown upsampling mode '{mode}'")

    x = x[..., r:-r, r:-r]

    return x.reshape(*batch, r * h, r * w)


def vorticity(x: Tensor) -> Tensor:
    r"""Central-difference vorticity of a velocity field ``(..., 2, H, W)``:
    ``du/d(axis -1) - dv/d(axis -2)`` with periodic boundaries."""

    u = x[..., 0, :, :]
    v = x[..., 1, :, :]

    du = (torch.roll(u, -1, dims=-1) - torch.roll(u, 1, dims=-1)) / 2
    dv = (torch.roll(v, -1, dims=-2) - torch.roll(v, 1, dims=-2)) / 2

    return du - dv
