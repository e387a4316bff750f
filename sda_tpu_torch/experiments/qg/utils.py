r"""Quasi-geostrophic experiment factories.

Counterpart of ``experiments/qg/utils.py`` (``make_chain``, ``make_score``,
``init_score``, ``load_score`` and ``make_trajectory_eps``, and the
rendering helpers of :mod:`sda_tpu_torch.viz`, re-exported).
States are two-layer potential-vorticity fields ``(L, 2, H, W)``; the window
kernel is a plain circular :class:`ScoreUNet` over ``window * 2`` channels,
with no forcing channel (the beta-plane background is homogeneous). The
committed runs under ``experiments/qg/storage/runs`` are read with the
port's own msgpack reader; their weights are converted in memory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import torch

from ...diffusion import MCScoreNet, ScoreUNet, bind_eps
from ...dynamics import QuasiGeostrophic
from ...nn import reset_parameters
from ...parallel import ShardedMCScoreNet
from ...parallel.mesh import axis_size
from ...train import load_params, params_from_flax
from ...utils import ACTIVATIONS, load_config, resolve_device
from ...viz import draw, sandwich, save_gif, vorticity2rgb  # noqa: F401

#: The JAX experiment's storage, which holds the committed runs, or
#: ``$SCRATCH/sda_tpu/qg`` where ``SCRATCH`` is set, as in the JAX pack.
if 'SCRATCH' in os.environ:
    PATH = Path(os.environ['SCRATCH']) / 'sda_tpu/qg'
else:
    PATH = Path(__file__).resolve().parents[3] / 'experiments' / 'qg' / 'storage'


def make_chain(size: int = 128, device: Union[str, torch.device] = 'cuda') -> QuasiGeostrophic:
    return QuasiGeostrophic(size=size, dt=0.1, device=device)


def make_score(
    window: int = 5,
    embedding: int = 64,
    hidden_channels: Sequence[int] = (96, 192, 384),
    hidden_blocks: Sequence[int] = (3, 3, 3),
    kernel_size: int = 3,
    activation: str = 'SiLU',
    size: int = 64,
    bf16: bool = False,
    **absorb,
) -> ScoreUNet:
    r"""The QG window kernel: a circular-padded ScoreUNet over
    ``window * 2`` channels (two PV layers per frame)."""

    return ScoreUNet(
        channels=window * 2,
        embedding=embedding,
        hidden_channels=tuple(hidden_channels),
        hidden_blocks=tuple(hidden_blocks),
        kernel_size=kernel_size,
        activation=ACTIVATIONS[activation],
        spatial=2,
        circular=True,
        dtype=torch.bfloat16 if bf16 else None,
    )


def init_score(module: ScoreUNet, generator: Optional[torch.Generator] = None) -> ScoreUNet:
    r"""Draws ``module``'s parameters from flax's initialisers (the JAX
    pack's ``init_score``) from ``generator`` (default: seed 0)."""

    if generator is None:
        generator = torch.Generator().manual_seed(0)

    return reset_parameters(module, generator)


def load_score(
    runpath: Path, device: Union[str, torch.device] = 'cuda', **kwargs,
) -> Tuple[ScoreUNet, dict]:
    r"""Rebuilds a run's score from ``config.json`` + ``state.msgpack``
    (``kwargs`` override the config)."""

    device = resolve_device(device)
    runpath = Path(runpath)
    config = load_config(runpath)
    config.update(kwargs)

    module = make_score(**config)
    params = params_from_flax(load_params(runpath / 'state.msgpack'))

    return bind_eps(module, params).to(device), config


def make_trajectory_eps(
    module, window: int = 5, chunk: Optional[int] = None, mesh=None,
) -> Union[MCScoreNet, ShardedMCScoreNet]:
    r"""Composes the window kernel into a full-trajectory eps function
    (Markov-blanket decomposition of order ``window // 2``), evaluated in
    chunks of ``chunk`` windows when given. With a ``mesh`` whose ``'sp'``
    axis has more than one rank, the windows are split over that axis
    instead, unchunked, as in the JAX pack."""

    if axis_size(mesh, 'sp') > 1:
        return ShardedMCScoreNet(module, order=window // 2, mesh=mesh)

    return MCScoreNet(module, order=window // 2, chunk=chunk)
