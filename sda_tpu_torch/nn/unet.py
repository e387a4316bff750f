r"""Modulated U-Net for 1-D/2-D/3-D fields, channel-first.

Counterpart of :mod:`sda_tpu.nn.unet`, run NCHW as torch prefers (the JAX
package runs channels-last inside and keeps channel-first at its public
boundary, ``ScoreUNet``). Convolutions and residual blocks are listed in
flax's creation order so that :func:`~sda_tpu_torch.train.params_from_flax`
maps ``Conv_i`` and ``ModResidualBlock_i`` by index.

On a CUDA tensor, a 2-D, circular, bf16 U-Net with SiLU runs channels-last
between its first and last convolutions: the glue between convolutions is
the hand-written kernels of :mod:`~sda_tpu_torch.ops.unet_kernels`, which
write the wrap-padded NHWC input that cuDNN's convolutions read
(:meth:`UNet.forward_fused`). Every other input runs the channel-first
:meth:`UNet.forward_plain`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.unet_kernels import act_pad, norm_pad
from ..tracing import counters
from .layers import Conv, Dense, layer_norm

Tensor = torch.Tensor
Stream = Tuple[Tensor, Optional[Tensor], Optional[Tensor]]


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
        counters['unet.blocks'] += 1

        y = self.denses[0](y)
        y = y.reshape(y.shape + (1,) * (x.ndim - 2))

        h = x + y
        h = layer_norm(h, dim=1)
        h = self.convs[0](h)
        h = self.activation(h)
        h = self.convs[1](h)

        return x + h

    def forward_fused(self, stream: Stream, y: Tensor) -> Stream:
        r""":meth:`forward`'s function on the channels-last residual stream
        ``(x, r, b)``, meaning ``x + (r + b)`` (:meth:`UNet.forward_fused`),
        with ``y`` in the compute dtype; returns the next stream. The glue is
        :func:`~sda_tpu_torch.ops.unet_kernels.norm_pad` and
        :func:`~sda_tpu_torch.ops.unet_kernels.act_pad` with SiLU;
        ``unet.blocks_fused`` counts the call where ``norm_pad`` launched its
        kernel."""

        counters['unet.blocks'] += 1
        launches = counters['unet.norm_pad']
        first, second = self.convs

        s, p = norm_pad(*stream, m=self.denses[0].forward_kept(y), pads=first.wrap())
        if counters['unet.norm_pad'] > launches:
            counters['unet.blocks_fused'] += 1
        _, q = act_pad(first.forward_padded(p), b=first.bias, silu=True, pads=second.wrap(), dtype=p.dtype)

        return s, second.forward_padded(q), second.bias


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
        self.activation = activation
        self.spatial = spatial
        self.circular = circular
        self.compute_dtype = dtype

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

        if self.fused_for(x):
            return self.forward_fused(x, y)
        return self.forward_plain(x, y)

    def forward_plain(self, x: Tensor, y: Tensor) -> Tensor:
        r""":meth:`forward`'s function channel-first, every block a
        :class:`ModResidualBlock` call."""

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

    def fused_for(self, x: Tensor) -> bool:
        r"""Whether :meth:`forward` takes :meth:`forward_fused` for ``x``: a
        CUDA tensor into a 2-D, circular, bf16 U-Net with SiLU, what the
        kernels implement."""

        return (
            x.is_cuda and self.spatial == 2 and self.circular
            and self.compute_dtype == torch.bfloat16 and self.activation is F.silu
        )

    def forward_fused(self, x: Tensor, y: Tensor) -> Tensor:
        r""":meth:`forward`'s function, channels-last from the first
        convolution to the last, with the glue between convolutions in
        :func:`~sda_tpu_torch.ops.unet_kernels.norm_pad` and
        :func:`~sda_tpu_torch.ops.unet_kernels.act_pad` (their plain versions
        on a CPU tensor).

        The residual stream is carried as ``(x, r, b)``, meaning ``x + (r +
        b)``: each convolution runs without its bias, and the next kernel adds
        the bias, the residual or skip connection and the modulation, and
        writes the padded input of the convolution after it. The sums round as
        :meth:`forward`'s do, one at a time in the compute dtype. The
        parameters' casts to the compute dtype are kept between calls
        (:func:`~sda_tpu_torch.nn.layers.kept_cast`).
        """

        dtype = self.compute_dtype or torch.float32
        convs = iter(self.convs)
        blocks = iter(self.blocks)
        depths = len(self.hidden_blocks)
        memory = []
        y = y.to(dtype)  # once, for every block's Dense

        stream = (x, None, None)
        for i, n in enumerate(self.hidden_blocks):
            conv = next(convs)
            s, q = act_pad(*stream, pads=conv.wrap(), keep=i > 0, dtype=dtype)
            if i > 0:
                memory.append(s)
            stream = (conv.forward_padded(q), None, conv.bias)
            for _ in range(n):
                stream = next(blocks).forward_fused(stream, y)

        for i in reversed(range(depths)):
            for _ in range(self.hidden_blocks[i]):
                stream = next(blocks).forward_fused(stream, y)

            conv = next(convs)
            if i > 0:
                _, p = norm_pad(*stream, pads=conv.wrap(), up=self.stride)
                stream = (memory.pop(), conv.forward_padded(p), conv.bias)
            else:
                _, q = act_pad(*stream, pads=conv.wrap(), dtype=dtype)
                x = conv.forward_padded(q, bias=True)

        return x.contiguous()
