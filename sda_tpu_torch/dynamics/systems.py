r"""Additional dynamical systems: damped spring and Lotka-Volterra.

Counterpart of :mod:`sda_tpu.dynamics.systems`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..utils import resolve_device
from .markov import MarkovChain
from .ode import DiscreteODE

Tensor = torch.Tensor


class DampedSpring(MarkovChain):
    r"""Linearized dynamics of a mass on a spring subject to wind and drag:
    a linear-Gaussian chain ``x' ~ N(A x + b, Sigma_x)``."""

    def __init__(self, dt: float = 0.01, device: Union[str, torch.device] = 'cuda'):
        super().__init__()

        self.device = resolve_device(device)
        self.mu_0 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.device)
        self.sigma_0 = torch.eye(4, device=self.device)

        self.A = torch.tensor([
            [1.0, dt, dt**2 / 2, 0.0],
            [0.0, 1.0, dt, 0.0],
            [-0.5, -0.1, 0.0, 0.2],
            [0.0, 0.0, 0.0, 0.99],
        ], device=self.device)
        self.b = torch.zeros(4, device=self.device)
        self.sigma_x = torch.diag(torch.tensor([0.1, 0.1, 0.1, 1.0], device=self.device)) * dt

    def _mvn(self, mean: Tensor, cov: Tensor, generator: Optional[torch.Generator]) -> Tensor:
        factor = torch.linalg.cholesky(cov.double()).to(mean.dtype)
        z = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        return mean + z @ factor.T

    def prior(self, shape: Sequence[int] = (), generator: Optional[torch.Generator] = None) -> Tensor:
        return self._mvn(self.mu_0.expand(tuple(shape) + (4,)), self.sigma_0, generator)

    def transition(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        return self._mvn(x @ self.A.T + self.b, self.sigma_x, generator)


class LotkaVolterra(DiscreteODE):
    r"""Log-space predator-prey dynamics."""

    def __init__(
        self,
        alpha: float = 1.0,
        beta: float = 1.0,
        delta: float = 1.0,
        gamma: float = 1.0,
        device: Union[str, torch.device] = 'cuda',
        **kwargs,
    ):
        super().__init__(**kwargs)

        self.alpha, self.beta = alpha, beta
        self.delta, self.gamma = delta, gamma
        self.device = resolve_device(device)

    def prior(self, shape: Sequence[int] = (), generator: Optional[torch.Generator] = None) -> Tensor:
        return torch.rand(tuple(shape) + (2,), generator=generator, device=self.device)

    def f(self, x: Tensor) -> Tensor:
        return torch.stack(
            (
                self.alpha - self.beta * torch.exp(x[..., 1]),
                self.delta * torch.exp(x[..., 0]) - self.gamma,
            ),
            dim=-1,
        )
