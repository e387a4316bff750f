r"""Lorenz experiment factories and likelihoods.

Counterpart of ``experiments/lorenz/utils.py`` (``make_chain``,
``make_global_score``, ``make_local_score``, ``load_score``,
``make_trajectory_eps``, ``log_prior``, ``log_likelihood``). The committed
runs under ``experiments/lorenz/storage/runs`` are read with the port's own
msgpack reader. ``posterior`` (the particle filter) and ``weak_4d_var`` wait
for the port of ``sda_tpu/eval``.
"""

from __future__ import annotations

import os
import math
from pathlib import Path
from typing import Callable, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ...diffusion import MCScoreNet, MCScoreWrapper, ScoreNet, ScoreUNet, bind_eps
from ...dynamics import NoisyLorenz63
from ...train import load_params, params_from_flax
from ...utils import ACTIVATIONS, load_config, resolve_device

Tensor = torch.Tensor

#: The JAX experiment's storage, which holds the committed runs, or
#: ``$SCRATCH/sda_tpu/lorenz`` where ``SCRATCH`` is set, as in the JAX pack.
if 'SCRATCH' in os.environ:
    PATH = Path(os.environ['SCRATCH']) / 'sda_tpu/lorenz'
else:
    PATH = Path(__file__).resolve().parents[3] / 'experiments' / 'lorenz' / 'storage'


def make_chain(device: Union[str, torch.device] = 'cuda') -> NoisyLorenz63:
    return NoisyLorenz63(dt=0.025, device=device)


def make_global_score(
    embedding: int = 32,
    hidden_channels: Sequence[int] = (64,),
    hidden_blocks: Sequence[int] = (3,),
    activation: str = 'SiLU',
    **absorb,
) -> ScoreUNet:
    r"""The "global" model: a 1-D ScoreUNet over the 3 state channels with
    time as space (train and sample it through :class:`MCScoreWrapper`)."""

    return ScoreUNet(
        channels=3,
        embedding=embedding,
        hidden_channels=tuple(hidden_channels),
        hidden_blocks=tuple(hidden_blocks),
        activation=ACTIVATIONS[activation],
        spatial=1,
    )


def make_local_score(
    window: int = 5,
    embedding: int = 32,
    width: int = 128,
    depth: int = 5,
    activation: str = 'SiLU',
    **absorb,
) -> ScoreNet:
    r"""The window kernel of the local score, an MLP over flattened windows
    of ``window`` states (composed with :class:`MCScoreNet` to score
    trajectories)."""

    return ScoreNet(
        features=3 * window,
        embedding=embedding,
        hidden_features=[width] * depth,
        activation=ACTIVATIONS[activation],
    )


def load_score(
    runpath: Path, local: bool = False, device: Union[str, torch.device] = 'cuda', **kwargs,
) -> Tuple[nn.Module, dict]:
    r"""Rebuilds a run's score from ``config.json`` + ``state.msgpack``;
    returns ``(module, config)``."""

    device = resolve_device(device)
    runpath = Path(runpath)
    config = load_config(runpath)
    config.update(kwargs)

    module = make_local_score(**config) if local else make_global_score(**config)
    params = params_from_flax(load_params(runpath / 'state.msgpack'))

    return bind_eps(module, params).to(device), config


def make_trajectory_eps(module: nn.Module, local: bool, window: int = 5) -> Callable[..., Tensor]:
    r"""The full-trajectory eps function ``(B, L, 3)``: windowed composition
    of a local kernel, or the global model run with time as space."""

    if local:
        return MCScoreNet(module, order=window // 2)
    return MCScoreWrapper(module)


def log_prior(x: Tensor) -> Tensor:
    r"""Physics consistency: the exact log-density of a trajectory
    ``(..., L, 3)`` under the noisy Lorenz dynamics."""

    chain = make_chain(device=x.device)

    return chain.log_prob(x[..., :-1, :], x[..., 1:, :]).sum(dim=-1)


def log_likelihood(
    y: Tensor,
    x: Tensor,
    A: Callable[[Tensor], Tensor] = lambda x: x,
    sigma: float = 1.0,
    step: int = 1,
) -> Tensor:
    r"""Gaussian observation log-density of ``y`` given every ``step``-th
    state of ``x``."""

    x = x[..., ::step, :]
    log_p = -((A(x) - y) ** 2 / sigma**2 + math.log(2 * math.pi * sigma**2)) / 2

    return log_p.sum(dim=(-1, -2))
