r"""Modulated U-Net for 1-D/2-D/3-D fields, channel-first.

Counterpart of :mod:`sda_tpu.nn.unet`, run NCHW as torch prefers (the JAX
package runs channels-last inside and keeps channel-first at its public
boundary, ``ScoreUNet``). Convolutions and residual blocks are listed in
flax's creation order so that :func:`~sda_tpu_torch.train.params_from_flax`
maps ``Conv_i`` and ``ModResidualBlock_i`` by index.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, Dense, layer_norm

Tensor = torch.Tensor


class ModResidualBlock(nn.Module):
    r"""``x + residue(x + project(y))``: ``project`` is a Dense broadcast over
    space and ``residue`` is ``layer_norm -> conv -> activation -> conv``."""

    def __init__(
        self,
        channels: int,
        mod_features: int,
        kernel_size: Sequence[int],
        activation: Callable[[Tensor], Tensor],
        padding: str,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()

        self.activation = activation
        self.denses = nn.ModuleList([Dense(mod_features, channels, dtype)])
        self.convs = nn.ModuleList([
            Conv(channels, channels, kernel_size, padding=padding, dtype=dtype),
            Conv(channels, channels, kernel_size, padding=padding, dtype=dtype),
        ])

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        y = self.denses[0](y)
        y = y.reshape(y.shape + (1,) * (x.ndim - 2))

        h = x + y
        h = layer_norm(h, dim=1)
        h = self.convs[0](h)
        h = self.activation(h)
        h = self.convs[1](h)

        return x + h


class UNet(nn.Module):
    r"""U-Net with modulation over ``(N, C_in, *spatial)`` fields.

    Arguments:
        in_channels: The number of input channels (flax infers it).
        out_channels: The number of output channels.
        mod_features: The size of the modulation vector (flax infers it).
        hidden_channels: The number of channels at each depth.
        hidden_blocks: The number of modulated residual blocks at each depth.
        kernel_size: The convolution kernel size (int or per-axis sequence).
        stride: The down/upsampling factor (int or per-axis sequence).
        activation: The activation function.
        spatial: The number of spatial axes (1, 2 or 3).
        circular: Whether convolutions use circular (periodic) padding.
        dtype: The compute dtype (``None`` = float32).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        mod_features: int,
        hidden_channels: Sequence[int] = (32, 64, 128),
        hidden_blocks: Sequence[int] = (2, 3, 5),
        kernel_size: Union[int, Sequence[int]] = 3,
        stride: Union[int, Sequence[int]] = 2,
        activation: Callable[[Tensor], Tensor] = F.relu,
        spatial: int = 2,
        circular: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()

        kernel = (kernel_size,) * spatial if isinstance(kernel_size, int) else tuple(kernel_size)
        self.stride = (stride,) * spatial if isinstance(stride, int) else tuple(stride)
        self.hidden_blocks = tuple(hidden_blocks)

        padding = 'circular' if circular else 'same'
        channels = tuple(hidden_channels)

        def conv(cin, cout, stride=None):
            return Conv(cin, cout, kernel, stride=stride, padding=padding, dtype=dtype)

        def block(c):
            return ModResidualBlock(c, mod_features, kernel, activation, padding, dtype)

        convs, blocks = [], []

        # Descent, in flax creation order.
        for i, n in enumerate(self.hidden_blocks):
            if i == 0:
                convs.append(conv(in_channels, channels[0]))
            else:
                convs.append(conv(channels[i - 1], channels[i], self.stride))
            blocks.extend(block(channels[i]) for _ in range(n))

        # Ascent.
        for i in reversed(range(len(self.hidden_blocks))):
            blocks.extend(block(channels[i]) for _ in range(self.hidden_blocks[i]))
            if i > 0:
                convs.append(conv(channels[i], channels[i - 1]))
            else:
                convs.append(conv(channels[0], out_channels))

        self.convs = nn.ModuleList(convs)
        self.blocks = nn.ModuleList(blocks)

    def _upsample(self, h: Tensor) -> Tensor:
        for axis, r in enumerate(self.stride):
            h = torch.repeat_interleave(h, r, dim=2 + axis)
        return h

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        r"""
        Arguments:
            x: Input field ``(N, C_in, *spatial)``.
            y: Modulation vector ``(N, F)``.

        Returns:
            Output field ``(N, out_channels, *spatial)``.
        """

        convs = iter(self.convs)
        blocks = iter(self.blocks)
        depths = len(self.hidden_blocks)
        memory = []

        for n in self.hidden_blocks:
            x = next(convs)(x)
            for _ in range(n):
                x = next(blocks)(x, y)
            memory.append(x)

        memory.pop()

        for i in reversed(range(depths)):
            for _ in range(self.hidden_blocks[i]):
                x = next(blocks)(x, y)

            if i > 0:
                x = layer_norm(x, dim=1)
                x = self._upsample(x)
                x = next(convs)(x)
                x = x + memory.pop()
            else:
                x = next(convs)(x)

        return x
