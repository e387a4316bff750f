r"""Observation-likelihood guidance for zero-shot data assimilation.

Counterpart of :mod:`sda_tpu.diffusion.guidance` (``GaussianScore``, the SDA
guidance, and ``DPSGaussianScore``, the DPS baseline). The gradient of the
observation term is taken with ``torch.autograd.grad`` through the eps
network (unless ``detach``), inside the sampler's ``no_grad`` loop.
"""

from __future__ import annotations

from copy import copy
from typing import Callable, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..tracing import span
from .sde import VPSDE
from .windowed import MCScoreNet

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
        remat: If True, recompute the eps network in the backward pass
            instead of keeping its activations (``torch.utils.checkpoint``).
            A chunked :class:`MCScoreNet` or
            :class:`~sda_tpu_torch.parallel.ShardedMCScoreNet` without
            per-chunk remat is rebuilt with it, since checkpointing only the
            outer call would still keep every chunk's activations during the
            recomputation.
    """

    def __init__(
        self,
        y: Tensor,
        A: Callable[[Tensor], Tensor],
        std: Union[float, Tensor],
        sde: VPSDE,
        gamma: Union[float, Tensor] = 1e-2,
        detach: bool = False,
        remat: bool = False,
    ):
        self.y = y
        self.A = A
        self.std = std
        self.gamma = gamma
        self.sde = sde
        self.detach = detach
        self.remat = remat

        from ..parallel.windowed import ShardedMCScoreNet  # which imports this package

        inner = sde.eps
        chunked = (MCScoreNet, ShardedMCScoreNet)
        if remat and isinstance(inner, chunked) and inner.chunk is not None and not inner.remat:
            self.sde = copy(sde)
            self.sde.eps = copy(inner)
            self.sde.eps.remat = True

    def _eps(self, x: Tensor, t: Tensor, c: Optional[Tensor]) -> Tensor:
        r"""The prior eps, checkpointed when ``remat`` asks for it and the
        score does not already checkpoint each chunk."""

        eps_fn = self.sde.eps
        if self.remat and not (getattr(eps_fn, 'remat', False) and getattr(eps_fn, 'chunk', None) is not None):
            return checkpoint(eps_fn, x, t, c, use_reentrant=False)
        return eps_fn(x, t, c)

    def __call__(self, x: Tensor, t: Tensor, c: Optional[Tensor] = None) -> Tensor:
        mu, sigma = self.sde.mu(t), self.sde.sigma(t)
        var = self.std**2 + self.gamma * (sigma / mu) ** 2

        with torch.enable_grad():
            x = x.detach().requires_grad_(True)

            with span('guidance.forward'):
                if self.detach:
                    with torch.no_grad():
                        e = self.sde.eps(x, t, c)
                else:
                    e = self._eps(x, t, c)

            x_hat = (x - sigma * e) / mu
            err = self.y - self.A(x_hat)
            log_p = -0.5 * torch.sum(err**2 / var)

            with span('guidance.vjp'):
                (grad,) = torch.autograd.grad(log_p, x)

        return e.detach() - sigma * grad


class DPSGaussianScore:
    r"""Diffusion Posterior Sampling guidance (Chung et al., 2022), the
    baseline: ``err = ||y - A(x_hat)||^2`` summed over the whole batch,
    ``s = -zeta grad_x err / sqrt(err)``, returns ``eps - sigma s``.

    As in the JAX package, ``err`` is one sum over every sample of the batch,
    so the step of each sample depends on the batch it is called with.
    """

    def __init__(self, y: Tensor, A: Callable[[Tensor], Tensor], sde: VPSDE, zeta: float = 1.0):
        self.y = y
        self.A = A
        self.sde = sde
        self.zeta = zeta

    def __call__(self, x: Tensor, t: Tensor, c: Optional[Tensor] = None) -> Tensor:
        mu, sigma = self.sde.mu(t), self.sde.sigma(t)

        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            e = self.sde.eps(x, t, c)
            x_hat = (x - sigma * e) / mu
            err = torch.sum((self.y - self.A(x_hat)) ** 2)

            (grad,) = torch.autograd.grad(err, x)

        s = -grad * self.zeta / torch.sqrt(err.detach())

        return e.detach() - sigma * s
