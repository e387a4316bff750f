r"""Zero-shot assimilation of a Kolmogorov trajectory, ``coarse`` scenario.

Counterpart of ``experiments/kolmogorov/assimilate.py`` (``get_scenario``'s
``coarse`` branch and the ``sda`` method of ``assimilate``): 8x-coarsened
observations of every 4th frame with noise 0.1, a :class:`GaussianScore`
posterior over the full trajectory, and the posterior-consistency residual
``std(A(x) - y)``, which should come out near the noise level.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...diffusion import VPSDE, GaussianScore
from ...dynamics import coarsen

Tensor = torch.Tensor


def coarse_observation(x: Tensor) -> Tensor:
    r"""``A(x)``: every 4th frame of ``(..., L, 2, H, W)``, coarsened 8x."""

    return coarsen(x[..., ::4, :, :, :], 8)


def coarse_scenario(
    x_star: Tensor, rng: np.random.RandomState,
) -> Tuple[Callable[[Tensor], Tensor], Tensor, float, int, float]:
    r"""``(A, y, std, length, gamma)`` for a reference trajectory
    ``x_star (L, 2, size, size)``; the observation noise comes from ``rng``
    as in the JAX experiment."""

    length = min(32, x_star.shape[0])
    std = 0.1
    obs = coarse_observation(x_star[:length])
    noise = rng.standard_normal(tuple(obs.shape)).astype(np.float32)
    y = obs + std * torch.from_numpy(noise).to(obs.device)

    return coarse_observation, y, std, length, 1e-2


def assimilate(
    score: Callable[..., Tensor],
    x_star: Tensor,
    samples: int = 4,
    steps: int = 256,
    corrections: int = 1,
    tau: float = 0.5,
    seed: int = 0,
    init: Optional[Tensor] = None,
    noise: Optional[Callable[[int, int], Tensor]] = None,
) -> Tuple[Tensor, float]:
    r"""Samples ``samples`` trajectories from the posterior given coarse
    observations of ``x_star`` and returns them with the residual
    ``std(A(x) - y)``.

    ``score`` is a trajectory eps function (see ``make_trajectory_eps``).
    The observation noise comes from ``numpy.random.RandomState(seed)``, the
    sampler's from a ``torch.Generator`` seeded with ``seed`` on
    ``x_star``'s device, unless ``init``/``noise`` are given (see
    :meth:`VPSDE.sample`).
    """

    A, y, std, length, gamma = coarse_scenario(x_star, np.random.RandomState(seed))
    size = x_star.shape[-1]

    guided = GaussianScore(y=y, A=A, std=std, sde=VPSDE(eps=score, shape=()), gamma=gamma)
    sde = VPSDE(eps=guided, shape=(length, 2, size, size))

    generator = torch.Generator(device=x_star.device).manual_seed(seed)
    if init is not None:
        init = init.to(x_star.device)
    xs = sde.sample(
        (samples,), steps=steps, corrections=corrections, tau=tau,
        generator=generator, init=init, noise=noise,
    )

    residual = float(torch.std(A(xs) - y, correction=0))

    return xs, residual
