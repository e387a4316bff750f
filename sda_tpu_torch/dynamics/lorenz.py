r"""Lorenz dynamical systems (1963 and 1996).

Counterpart of :mod:`sda_tpu.dynamics.lorenz`: the same drifts, priors,
standardization constants and transition log-density; draws come from a
``torch.Generator`` on the system's device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ..utils import resolve_device
from .ode import DiscreteODE

Tensor = torch.Tensor


class Lorenz63(DiscreteODE):
    r"""Chaotic Lorenz 1963 dynamics, with an MVN prior over the attractor
    region and per-dimension standardization constants.

    Arguments:
        sigma / rho / beta: The Lorenz parameters.
        device: Where the prior draws (``'cuda'`` by default).
        kwargs: ``dt`` and ``steps`` (see :class:`DiscreteODE`).
    """

    #: Standardization constants.
    LOC = (0.0, 0.0, 25.0)
    SCALE = (8.0, 9.0, 8.6)

    def __init__(
        self,
        sigma: float = 10.0,
        rho: float = 28.0,
        beta: float = 8 / 3,
        device: Union[str, torch.device] = 'cuda',
        **kwargs,
    ):
        super().__init__(**kwargs)

        self.sigma, self.rho, self.beta = sigma, rho, beta
        self.device = resolve_device(device)

    def prior(
        self,
        shape: Sequence[int] = (),
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
    ) -> Tensor:
        r"""``mean + L z`` with ``L`` the Cholesky factor of the prior
        covariance and ``z ~ N(0, 1)`` of shape ``shape + (3,)`` (drawn from
        ``generator`` unless ``noise`` is given)."""

        mean = torch.tensor([0.0, 0.0, 25.0], device=self.device)
        cov = torch.tensor([
            [64.0, 50.0, 0.0],
            [50.0, 81.0, 0.0],
            [0.0, 0.0, 75.0],
        ], dtype=torch.float64)
        factor = torch.linalg.cholesky(cov).to(torch.float32).to(self.device)

        if noise is None:
            noise = torch.randn(tuple(shape) + (3,), generator=generator, device=self.device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)

        return mean + noise @ factor.T

    def f(self, x: Tensor) -> Tensor:
        return torch.stack(
            (
                self.sigma * (x[..., 1] - x[..., 0]),
                x[..., 0] * (self.rho - x[..., 2]) - x[..., 1],
                x[..., 0] * x[..., 1] - self.beta * x[..., 2],
            ),
            dim=-1,
        )

    @classmethod
    def preprocess(cls, x: Tensor) -> Tensor:
        r"""Standardizes states for training."""

        return (x - x.new_tensor(cls.LOC)) / x.new_tensor(cls.SCALE)

    @classmethod
    def postprocess(cls, x: Tensor) -> Tensor:
        r"""Un-standardizes network-space states."""

        return x.new_tensor(cls.LOC) + x.new_tensor(cls.SCALE) * x


class NoisyLorenz63(Lorenz63):
    r"""Lorenz 1963 dynamics with Gaussian transition noise of scale
    :math:`\sqrt{dt}`; :meth:`log_prob` is the exact transition log-density,
    the physics-consistency metric."""

    def moments(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        mean = super().transition(x)
        return mean, torch.tensor(self.dt**0.5, dtype=x.dtype, device=x.device)

    def transition(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        mean, std = self.moments(x)
        return mean + std * torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def log_prob(self, x1: Tensor, x2: Tensor) -> Tensor:
        r"""Exact :math:`\log p(x_2 | x_1)`, summed over state dimensions."""

        mean, std = self.moments(x1)
        log_p = -(torch.log(2 * math.pi * std**2) + (x2 - mean) ** 2 / std**2) / 2

        return log_p.sum(dim=-1)


class Lorenz96(DiscreteODE):
    r"""Lorenz 1996 cyclic lattice dynamics.

    Arguments:
        n: The number of lattice sites.
        F: The forcing constant.
        device: Where the prior draws (``'cuda'`` by default).
    """

    def __init__(self, n: int = 32, F: float = 16.0, device: Union[str, torch.device] = 'cuda', **kwargs):
        super().__init__(**kwargs)

        self.n, self.F = n, F
        self.device = resolve_device(device)

    def prior(self, shape: Sequence[int] = (), generator: Optional[torch.Generator] = None) -> Tensor:
        return torch.randn(tuple(shape) + (self.n,), generator=generator, device=self.device)

    def f(self, x: Tensor) -> Tensor:
        x1 = torch.roll(x, 1, dims=-1)
        x2 = torch.roll(x, -2, dims=-1)
        x3 = torch.roll(x, -1, dims=-1)

        return (x1 - x2) * x3 - x + self.F
