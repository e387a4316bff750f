#!/usr/bin/env python
r"""QG zero-shot assimilation, the multi-field scenario catalog.

Counterpart of ``experiments/qg/assimilate.py``. The headline scenario is
``upper``: only the upper layer's PV is observed (coarsened), and the
posterior must reconstruct the unobserved bottom layer through the layers'
dynamical coupling. Scenarios:

- ``upper``: 4x-coarsened upper-layer PV of every 2nd frame (16 frames);
  the bottom layer is latent;
- ``coarse``: 4x-coarsened observations of both layers, every 2nd frame;
- ``subsample``: every 8th pixel of both layers of an 8-frame burst.

    python -m sda_tpu_torch.experiments.qg.assimilate --run qg_0 --scenario upper [--device cpu]

The command line reads ``storage/data/test.h5`` (``h5py``) and the run's
weights; :func:`assimilate` takes a score and a reference trajectory.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ...diffusion import VPSDE, GaussianScore
from ...dynamics import coarsen
from ...utils import resolve_device
from .utils import PATH, load_score, make_trajectory_eps

Tensor = torch.Tensor
Scenario = Tuple[Callable[[Tensor], Tensor], Tensor, float, int, float]

SCENARIOS = ('upper', 'coarse', 'subsample')
OBS_STD = 0.1  # the observation noise of every scenario


def get_scenario(name: str, x_star: Tensor, rng: np.random.RandomState) -> Scenario:
    r"""``(A, y, std, length, gamma)`` of a named scenario for a reference
    trajectory ``x_star (L, 2, H, W)`` in (standardised) model space, with
    the observation noise drawn from ``rng`` (one draw of ``y``'s shape)."""

    std = OBS_STD
    if name == 'upper':
        length = 16

        def A(x):
            return coarsen(x[..., ::2, :1, :, :], 4)

    elif name == 'coarse':
        length = 16

        def A(x):
            return coarsen(x[..., ::2, :, :, :], 4)

    elif name == 'subsample':
        length = 8

        def A(x):
            return x[..., ::8, ::8]

    else:
        raise ValueError(f'unknown scenario {name}')

    obs = A(x_star[:length])
    noise = rng.standard_normal(tuple(obs.shape)).astype(np.float32)
    y = obs + std * torch.from_numpy(noise).to(obs.device)

    return A, y, std, length, 1e-2


def assimilate(
    score,
    x_star: Tensor,
    scenario: str = 'upper',
    samples: int = 4,
    steps: int = 256,
    corrections: int = 1,
    tau: float = 0.5,
    seed: int = 0,
    init: Optional[Tensor] = None,
    noise: Optional[Callable[[int, int], Tensor]] = None,
) -> Tuple[Tensor, float, Optional[float]]:
    r"""Samples ``samples`` trajectories from the posterior of ``scenario``
    given observations of ``x_star (L, 2, H, W)``; returns them, the
    residual ``std(A(x) - y)`` and, for ``upper``, the RMSE of the posterior
    mean on the unobserved bottom layer (else ``None``).

    ``score`` is a trajectory eps function (see ``make_trajectory_eps``).
    The observation noise comes from ``numpy.random.RandomState(seed)``, the
    sampler's from a generator seeded with ``seed`` on ``x_star``'s device,
    unless ``init``/``noise`` are given (see :meth:`VPSDE.sample`).
    """

    A, y, std, length, gamma = get_scenario(scenario, x_star, np.random.RandomState(seed))

    sde = VPSDE(
        eps=GaussianScore(y=y, A=A, std=std, sde=VPSDE(eps=score, shape=()), gamma=gamma),
        shape=(length,) + tuple(x_star.shape[-3:]),
    )

    generator = torch.Generator(device=x_star.device).manual_seed(seed)
    xs = sde.sample(
        (samples,), steps=steps, corrections=corrections, tau=tau, generator=generator,
        init=None if init is None else init.to(x_star.device), noise=noise,
    )

    residual = float(torch.std(A(xs) - y, correction=0))
    print(f'{scenario}: residual std = {residual:.4f} (obs std = {std})')

    rmse = None
    if scenario == 'upper':
        err = (xs.mean(dim=0) - x_star[:length]).square().mean(dim=(0, 2, 3)).sqrt()
        rmse = float(err[1])
        base = float(torch.std(x_star[:length, 1], correction=0))
        print(f'upper: bottom-layer posterior-mean rmse = {rmse:.3f} (field std = {base:.3f})')

    return xs, residual, rmse


def main(
    run: str = 'qg_0',
    scenario: str = 'upper',
    samples: int = 4,
    steps: int = 256,
    corrections: int = 1,
    tau: float = 0.5,
    seed: int = 0,
    render: bool = False,
    device: Union[str, torch.device] = 'cuda',
) -> Tuple[float, float]:
    r"""Assimilates test trajectory ``seed`` with the run ``run`` as the JAX
    experiment's ``assimilate`` does; returns ``(residual, std)``."""

    if render:
        raise NotImplementedError('rendering waits for the port of sda_tpu/viz')

    from ...train import load_h5

    device = resolve_device(device)
    x_test = load_h5(PATH / 'data/test.h5')
    x_star = torch.from_numpy(np.asarray(x_test[seed % len(x_test)], np.float32)).to(device)

    module, config = load_score(PATH / f'runs/{run}', device=device)
    score = make_trajectory_eps(module, config.get('window', 5))

    _, residual, _ = assimilate(
        score, x_star, scenario, samples=samples, steps=steps, corrections=corrections, tau=tau, seed=seed,
    )

    return residual, OBS_STD


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', type=str, default='qg_0')
    parser.add_argument('--scenario', default='upper', choices=SCENARIOS)
    parser.add_argument('--samples', type=int, default=4)
    parser.add_argument('--steps', type=int, default=256)
    parser.add_argument('--corrections', type=int, default=1)
    parser.add_argument('--tau', type=float, default=0.5)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--render', action='store_true', help='refused: waits for the port of sda_tpu/viz')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.run, args.scenario, args.samples, args.steps, args.corrections, args.tau, args.seed,
         render=args.render, device=args.device)
