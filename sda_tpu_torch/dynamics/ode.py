r"""Discretized ODE systems with fourth-order Runge-Kutta integration.

Counterpart of :mod:`sda_tpu.dynamics.ode`, vectorized over any leading
batch axes.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional

import torch

from .markov import MarkovChain

Tensor = torch.Tensor


def rk4(f: Callable[[Tensor], Tensor], x: Tensor, dt: float) -> Tensor:
    r"""One step of the classical fourth-order Runge-Kutta scheme."""

    k1 = f(x)
    k2 = f(x + dt * k1 / 2)
    k3 = f(x + dt * k2 / 2)
    k4 = f(x + dt * k3)

    return x + dt * (k1 + 2 * k2 + 2 * k3 + k4) / 6


class DiscreteODE(MarkovChain):
    r"""Deterministic Markov chain defined by :math:`\dot{x} = f(x)`.

    Arguments:
        dt: The transition time step.
        steps: The number of RK4 substeps per transition.
    """

    def __init__(self, dt: float = 0.01, steps: int = 1):
        super().__init__()

        self.dt = dt
        self.steps = steps

    @abc.abstractmethod
    def f(self, x: Tensor) -> Tensor:
        r"""The drift :math:`f(x) = dx/dt`."""

    def transition(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        for _ in range(self.steps):
            x = rk4(self.f, x, self.dt / self.steps)

        return x
