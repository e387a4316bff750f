r"""Kolmogorov experiment factories.

Counterpart of ``experiments/kolmogorov/utils.py`` (``make_chain``,
``make_score``, ``load_score`` and ``make_trajectory_eps``, and the
rendering helpers of :mod:`sda_tpu_torch.viz`, re-exported).
The committed runs under ``experiments/kolmogorov/storage/runs`` are read
with the port's own msgpack reader; their weights are converted in memory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import torch

from ...diffusion import LocalScoreUNet, MCScoreNet, bind_eps
from ...dynamics import KolmogorovFlow
from ...parallel import ShardedMCScoreNet
from ...parallel.mesh import axis_size
from ...train import load_params, params_from_flax
from ...utils import ACTIVATIONS, load_config, resolve_device
from ...viz import draw, sandwich, save_gif, vorticity2rgb  # noqa: F401

#: The JAX experiment's storage, which holds the committed runs, or
#: ``$SCRATCH/sda_tpu/kolmogorov`` where ``SCRATCH`` is set, as in the JAX pack.
if 'SCRATCH' in os.environ:
    PATH = Path(os.environ['SCRATCH']) / 'sda_tpu/kolmogorov'
else:
    PATH = Path(__file__).resolve().parents[3] / 'experiments' / 'kolmogorov' / 'storage'


def make_chain(size: int = 256, device: Union[str, torch.device] = 'cuda') -> KolmogorovFlow:
    return KolmogorovFlow(size=size, dt=0.2, device=device)


def make_score(
    window: int = 5,
    embedding: int = 64,
    hidden_channels: Sequence[int] = (64, 128, 256),
    hidden_blocks: Sequence[int] = (3, 3, 3),
    kernel_size: int = 3,
    activation: str = 'SiLU',
    size: int = 64,
    bf16: bool = False,
    **absorb,
) -> LocalScoreUNet:
    r"""The forcing-conditioned window kernel: a circular-padded ScoreUNet
    over ``window * 2`` channels with the fixed ``sin(4 b)`` context."""

    return LocalScoreUNet(
        channels=window * 2,
        size=size,
        embedding=embedding,
        hidden_channels=tuple(hidden_channels),
        hidden_blocks=tuple(hidden_blocks),
        kernel_size=kernel_size,
        activation=ACTIVATIONS[activation],
        circular=True,
        dtype=torch.bfloat16 if bf16 else None,
    )


def load_score(
    runpath: Path, device: Union[str, torch.device] = 'cuda', **kwargs,
) -> Tuple[LocalScoreUNet, dict]:
    r"""Rebuilds a run's score from ``config.json`` + ``state.msgpack``
    (``kwargs`` override the config, e.g. ``bf16=False``)."""

    device = resolve_device(device)
    runpath = Path(runpath)
    config = load_config(runpath)
    config.update(kwargs)

    module = make_score(**config)
    params = params_from_flax(load_params(runpath / 'state.msgpack'))

    return bind_eps(module, params).to(device), config


def make_trajectory_eps(
    module, window: int = 5, chunk: Optional[int] = None, remat: bool = False, mesh=None,
) -> Union[MCScoreNet, ShardedMCScoreNet]:
    r"""Composes the window kernel into a full-trajectory eps function,
    evaluated in chunks of ``chunk`` windows (each checkpointed if
    ``remat``) when given. With a ``mesh`` whose ``'sp'`` axis has more than
    one rank, the windows are split over that axis
    (:class:`~sda_tpu_torch.parallel.ShardedMCScoreNet`), and each shard
    evaluates its own in chunks: the two levers compose."""

    if axis_size(mesh, 'sp') > 1:
        return ShardedMCScoreNet(module, order=window // 2, mesh=mesh, chunk=chunk, remat=remat)

    return MCScoreNet(module, order=window // 2, chunk=chunk, remat=remat)


def reference_frames(x_test, device: Union[str, torch.device]) -> torch.Tensor:
    r"""Every 8th frame of each test trajectory ``(N, L, 2, H, W)``, as
    ``(N L / 8, 2, H, W)`` on ``device``: the sweeps' reference ensemble
    for the spectrum distance."""

    x = torch.as_tensor(x_test[:, ::8], dtype=torch.float32, device=device)
    return x.reshape((-1,) + tuple(x.shape[-3:]))
