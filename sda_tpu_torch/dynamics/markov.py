r"""Markov-chain core: priors, transitions and rollouts.

Counterpart of :mod:`sda_tpu.dynamics.markov`; a Python loop takes the place
of ``lax.scan``, and a ``torch.Generator`` the place of PRNG keys.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence

import torch

Tensor = torch.Tensor


class MarkovChain(abc.ABC):
    r"""Abstract first-order time-invariant Markov chain."""

    @abc.abstractmethod
    def prior(self, shape: Sequence[int] = (), generator: Optional[torch.Generator] = None) -> Tensor:
        r"""Samples :math:`x_0 \sim p(x_0)`."""

    @abc.abstractmethod
    def transition(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        r"""Samples :math:`x_i \sim p(x_i | x_{i-1})`."""

    def trajectory(
        self,
        x: Tensor,
        length: int,
        last: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        r"""Rolls out :math:`(x_1, ..., x_n)`: the time-major stack
        ``(length, *x.shape)``, or only the final state if ``last``."""

        xs = []
        for _ in range(length):
            x = self.transition(x, generator)
            if not last:
                xs.append(x)

        return x if last else torch.stack(xs)
