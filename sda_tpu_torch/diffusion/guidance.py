r"""Observation-likelihood guidance for zero-shot data assimilation.

Counterpart of :class:`sda_tpu.diffusion.guidance.GaussianScore`. The
gradient of the observation log-likelihood is taken with
``torch.autograd.grad`` through the eps network (unless ``detach``), inside
the sampler's ``no_grad`` loop.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from .sde import VPSDE

Tensor = torch.Tensor


class GaussianScore:
    r"""Posterior eps for :math:`p(y | x) = N(y | A(x), \Sigma_y)`:

    - Tweedie estimate ``x_hat = (x - sigma eps) / mu``;
    - ``err = y - A(x_hat)`` with variance ``std^2 + gamma (sigma / mu)^2``;
    - returns ``eps - sigma * grad_x log p`` with
      ``log p = -1/2 sum(err^2 / var)``.

    Arguments:
        y: The observation.
        A: The differentiable observation operator.
        std: The observation noise standard deviation.
        sde: The prior SDE (``mu``, ``sigma`` and the prior ``eps``).
        gamma: The variance-inflation coefficient.
        detach: If True, do not differentiate through the eps network.
    """

    def __init__(
        self,
        y: Tensor,
        A: Callable[[Tensor], Tensor],
        std: Union[float, Tensor],
        sde: VPSDE,
        gamma: Union[float, Tensor] = 1e-2,
        detach: bool = False,
    ):
        self.y = y
        self.A = A
        self.std = std
        self.gamma = gamma
        self.sde = sde
        self.detach = detach

    def __call__(self, x: Tensor, t: Tensor, c: Optional[Tensor] = None) -> Tensor:
        mu, sigma = self.sde.mu(t), self.sde.sigma(t)
        var = self.std**2 + self.gamma * (sigma / mu) ** 2

        with torch.enable_grad():
            x = x.detach().requires_grad_(True)

            if self.detach:
                with torch.no_grad():
                    e = self.sde.eps(x, t, c)
            else:
                e = self.sde.eps(x, t, c)

            x_hat = (x - sigma * e) / mu
            err = self.y - self.A(x_hat)
            log_p = -0.5 * torch.sum(err**2 / var)

            (grad,) = torch.autograd.grad(log_p, x)

        return e.detach() - sigma * grad
