r"""The Kolmogorov score U-Net (``"arch": "unet"``): the port's
``LocalScoreUNet`` built by ``make_score``, the plain
``reference.unet.ScoreUNet``, and its forward FLOPs, frozen from the port's
``nn/flops.py``.

A tree holds flax's names (``ScoreUNet_0/UNet_0/Conv_0/kernel``, kernels HWIO
or ``(in, out)``), as the committed runs store them; the program loads it
through ``params_from_flax``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Union

import numpy as np
import torch

from portbench.archs import one_thread
from portbench.counts import conv_flops, dense_flops
from portbench.reference import unet as ref


def _host(tree: dict) -> dict:
    r"""``tree`` with its leaves as numpy arrays, which the program's
    converter reads."""

    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in tree.items()}


def program(config: dict, tree: dict, device: torch.device) -> torch.nn.Module:
    from sda_tpu_torch.experiments.kolmogorov.utils import make_score
    from sda_tpu_torch.train import params_from_flax

    with one_thread():
        module = make_score(**config)
        module.load_state_dict(params_from_flax(ref.nest(_host(tree))))
    return module.to(device)


reference = ref.ScoreUNet
init_tree = ref.init_tree


def names(tree: dict) -> Dict[str, str]:
    r"""The program's parameter name of each flax leaf, found by handing the
    program's converter leaves that hold their own index."""

    from sda_tpu_torch.train import params_from_flax

    keys = list(tree)
    marked = {k: np.full(tuple(v.shape), i, np.float32) for i, (k, v) in enumerate(tree.items())}
    return {name: keys[int(t.reshape(-1)[0])] for name, t in params_from_flax(ref.nest(marked)).items()}


# -- FLOPs -------------------------------------------------------------------


def _as_tuple(v: Union[int, Sequence[int]], n: int) -> tuple:
    return (v,) * n if isinstance(v, int) else tuple(v)


def unet_flops(
    in_channels: int,
    out_channels: int,
    hidden_channels: Sequence[int],
    hidden_blocks: Sequence[int],
    kernel_size: Union[int, Sequence[int]],
    size: Union[int, Sequence[int]],
    spatial: int = 2,
    stride: Union[int, Sequence[int]] = 2,
    embedding: int = 64,
) -> int:
    r"""Forward FLOPs of the modulated U-Net on one event: the head conv, per
    depth a strided conv and ``hidden_blocks[i]`` residual blocks (2 convs and
    a modulation dense each) down, the same blocks, an upsampling conv and the
    output conv up. Elementwise work is left out."""

    kernel = _as_tuple(kernel_size, spatial)
    strides = _as_tuple(stride, spatial)
    sizes = _as_tuple(size, spatial)
    k_elems = math.prod(kernel)

    def elems(depth: int) -> int:
        return math.prod(s // (r**depth) for s, r in zip(sizes, strides))

    def block(depth: int) -> int:
        c = hidden_channels[depth]
        return 2 * conv_flops(elems(depth), c, c, k_elems) + dense_flops(embedding, c)

    total = 0
    depths = len(hidden_blocks)
    for i in range(depths):
        c_in = in_channels if i == 0 else hidden_channels[i - 1]
        total += conv_flops(elems(i), c_in, hidden_channels[i], k_elems)
        total += hidden_blocks[i] * block(i)
    for i in reversed(range(depths)):
        total += hidden_blocks[i] * block(i)
        c_out = hidden_channels[i - 1] if i > 0 else out_channels
        total += conv_flops(elems(max(i - 1, 0)), hidden_channels[i], c_out, k_elems)

    return total


def score_unet_flops(
    channels: int,
    context_channels: int = 0,
    embedding: int = 64,
    hidden_channels: Sequence[int] = (32, 64, 128),
    hidden_blocks: Sequence[int] = (2, 3, 5),
    kernel_size: Union[int, Sequence[int]] = 3,
    size: Union[int, Sequence[int]] = 64,
    spatial: int = 2,
    stride: Union[int, Sequence[int]] = 2,
) -> int:
    r"""Forward FLOPs of one score U-Net evaluation: the U-Net over the state
    and context channels, and the time embedding's MLP (32 -> 256 ->
    ``embedding``)."""

    total = unet_flops(
        channels + context_channels, channels, hidden_channels, hidden_blocks,
        kernel_size, size, spatial, stride, embedding,
    )
    return total + dense_flops(32, 256) + dense_flops(256, embedding)


def window_flops(config: dict) -> int:
    r"""Forward FLOPs of the Kolmogorov window kernel of ``config``: ``window``
    frames of 2 channels plus the forcing channel."""

    return score_unet_flops(
        channels=config['window'] * 2,
        context_channels=1,
        embedding=config['embedding'],
        hidden_channels=config['hidden_channels'],
        hidden_blocks=config['hidden_blocks'],
        kernel_size=config['kernel_size'],
        size=config['size'],
    )
