r"""Score networks: the MLP :class:`ScoreNet`, :class:`ScoreUNet` and the
forcing-conditioned window kernels :class:`LocalScoreUNet` and
:class:`LocalScoreDiT`.

Counterpart of :mod:`sda_tpu.diffusion.scorenet`, with the same channel-first
event layout ``(..., C, *spatial)`` at the call boundary. A torch module holds
its parameters, so an eps function is the module itself; :func:`bind_eps`
loads a parameter ``state_dict`` into it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.dit import DiT
from ..nn.layers import ResMLP, TimeEmbedding
from ..nn.unet import UNet
from ..utils import broadcast

Tensor = torch.Tensor


class ScoreNet(nn.Module):
    r"""MLP score network: ``eps(x, t, c) = ResMLP(concat(x, t_emb, c))``,
    with ``t`` and ``c`` broadcast over the leading axes of ``x``.

    Arguments:
        features: The number of features.
        context: The number of context features (flax infers it).
        embedding: The number of time-embedding features.
        hidden_features: The ResMLP hidden widths.
        activation: The activation function.
        dtype: The compute dtype (``None`` = float32).
    """

    def __init__(
        self,
        features: int,
        context: int = 0,
        embedding: int = 16,
        hidden_features: Sequence[int] = (64, 64),
        activation: Callable[[Tensor], Tensor] = F.relu,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()

        self.embedding = TimeEmbedding(embedding, dtype)
        self.mlp = ResMLP(features + embedding + context, features, hidden_features, activation, dtype)

    def forward(self, x: Tensor, t: Union[float, Tensor], c: Optional[Tensor] = None) -> Tensor:
        t = self.embedding(torch.as_tensor(t, device=x.device))

        if c is None:
            h = torch.cat(broadcast(x, t, ignore=1), dim=-1)
        else:
            h = torch.cat(broadcast(x, t, c, ignore=1), dim=-1)

        return self.mlp(h).to(x.dtype)


class ScoreUNet(nn.Module):
    r"""U-Net score network over channel-first fields.

    The context ``c`` is broadcast and concatenated along the channel axis,
    leading batch axes are flattened around the network, and ``t`` is a
    scalar or batched per leading element.

    Arguments:
        channels: The number of state channels.
        context: The number of context channels (flax infers it).
        embedding: The number of time-embedding features.
        hidden_channels / hidden_blocks / kernel_size / stride / activation:
            U-Net hyper-parameters (see :class:`~sda_tpu_torch.nn.UNet`).
        spatial: The number of spatial axes (1, 2 or 3).
        circular: Whether convolutions use periodic padding.
        dtype: The compute dtype (``None`` = float32).
    """

    def __init__(
        self,
        channels: int,
        context: int = 0,
        embedding: int = 64,
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

        self.spatial = spatial
        self.embedding = TimeEmbedding(embedding, dtype)
        self.unet = UNet(
            channels + context, channels, embedding,
            hidden_channels=hidden_channels,
            hidden_blocks=hidden_blocks,
            kernel_size=kernel_size,
            stride=stride,
            activation=activation,
            spatial=spatial,
            circular=circular,
            dtype=dtype,
        )

    def forward(self, x: Tensor, t: Union[float, Tensor], c: Optional[Tensor] = None) -> Tensor:
        dims = self.spatial + 1

        if c is None:
            y = x
        else:
            y, c = broadcast(x, c, ignore=dims)
            y = torch.cat((y, c), dim=-dims)

        batch = x.shape[:-dims]

        y = y.reshape((-1,) + y.shape[-dims:])
        t = torch.as_tensor(t, device=x.device).broadcast_to(batch).reshape(-1)
        t = self.embedding(t)

        y = self.unet(y, t)

        return y.reshape(x.shape).to(x.dtype)


def kolmogorov_forcing(size: int) -> Tensor:
    r"""The Kolmogorov forcing ``sin(4 b)`` at the cell centres of a
    ``size`` grid, varying along the last axis: ``(1, size, size)``."""

    domain = 2 * math.pi / size * (torch.arange(size, dtype=torch.float32) + 0.5)
    return torch.sin(4 * domain).expand(1, size, size).contiguous()


class LocalScoreUNet(nn.Module):
    r"""Score U-Net conditioned on the fixed Kolmogorov forcing ``sin(4 b)``
    (cell centres, varying along the last axis), which overrides any ``c``.

    Arguments:
        channels: The number of state channels.
        size: The spatial grid size.
        Remaining arguments as in :class:`ScoreUNet` (``spatial`` is 2).
    """

    def __init__(
        self,
        channels: int,
        size: int = 64,
        embedding: int = 64,
        hidden_channels: Sequence[int] = (32, 64, 128),
        hidden_blocks: Sequence[int] = (2, 3, 5),
        kernel_size: Union[int, Sequence[int]] = 3,
        stride: Union[int, Sequence[int]] = 2,
        activation: Callable[[Tensor], Tensor] = F.relu,
        circular: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()

        self.register_buffer('forcing', kolmogorov_forcing(size), persistent=False)

        self.score = ScoreUNet(
            channels,
            context=1,
            embedding=embedding,
            hidden_channels=hidden_channels,
            hidden_blocks=hidden_blocks,
            kernel_size=kernel_size,
            stride=stride,
            activation=activation,
            spatial=2,
            circular=circular,
            dtype=dtype,
        )

    def forward(self, x: Tensor, t: Union[float, Tensor], c: Optional[Tensor] = None) -> Tensor:
        return self.score(x, t, self.forcing)


class LocalScoreDiT(nn.Module):
    r"""The Kolmogorov window kernel as a diffusion transformer
    (:class:`~sda_tpu_torch.nn.dit.DiT`): the state channels and the forcing
    ``sin(4 b)`` in, the state channels out, leading axes flattened around the
    network and ``t`` broadcast over them, ``t`` in ``[0, 1]`` scaled by
    1000 into the DiT's timestep embedder, whose frequencies are set for
    steps up to 1000.

    Arguments:
        channels: The number of state channels.
        size: The spatial grid size.
        patch_size / hidden_size / depth / num_heads / mlp_ratio: The DiT's.
        dtype: The compute dtype (``None`` = float32).
    """

    def __init__(
        self,
        channels: int,
        size: int = 64,
        patch_size: int = 2,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()

        self.register_buffer('forcing', kolmogorov_forcing(size), persistent=False)

        self.dit = DiT(
            input_size=size,
            patch_size=patch_size,
            in_channels=channels + 1,
            out_channels=channels,
            hidden_size=hidden_size,
            depth=depth,
            num_heads=num_heads,
            mlp_ratio=mlp_ratio,
            dtype=dtype,
        )

    def forward(self, x: Tensor, t: Union[float, Tensor], c: Optional[Tensor] = None) -> Tensor:
        y, forcing = broadcast(x, self.forcing, ignore=3)
        y = torch.cat((y, forcing), dim=-3)

        batch = x.shape[:-3]
        y = y.reshape((-1,) + y.shape[-3:])
        t = torch.as_tensor(t, device=x.device).broadcast_to(batch).reshape(-1)

        return self.dit(y, 1000 * t).reshape(x.shape).to(x.dtype)


def bind_eps(module: nn.Module, params: Dict[str, Tensor]) -> nn.Module:
    r"""Loads ``params`` (a ``state_dict``, e.g. from
    :func:`~sda_tpu_torch.train.params_from_flax`) into ``module`` and returns
    it, frozen, as an eps function ``eps(x, t, c=None)``."""

    module.load_state_dict(params)
    module.requires_grad_(False)
    return module.eval()
