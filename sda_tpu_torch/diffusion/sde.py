r"""The variance-preserving SDE and its predictor-corrector sampler.

Counterpart of :mod:`sda_tpu.diffusion.sde` (``make_alpha``, ``VPSDE`` with
``perturb`` and the denoising ``loss``, and ``VPSDE.sample`` with the ``ddim``
predictor and Langevin corrections). The JAX package runs the loop as one
``lax.scan``; here it is a Python loop over eager torch ops.

Torch cannot reproduce JAX's noise streams, so the random methods take their
draws from the caller when asked: :meth:`VPSDE.perturb` and
:meth:`VPSDE.loss` take ``t`` and the noise ``z``, :meth:`VPSDE.sample` its
initial state and its per-step, per-correction noise (``init``, ``noise``).
By default all of them come from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor
EpsFn = Callable[..., Tensor]


def make_alpha(alpha: str, eta: float) -> Callable[[Tensor], Tensor]:
    r"""The :math:`\alpha(t)` schedule: ``'lin'`` :math:`1 - (1 - \eta) t`,
    ``'cos'`` :math:`\cos(\arccos(\sqrt{\eta}) t)^2` or ``'exp'``
    :math:`\exp(\ln(\eta) t^2)`."""

    if alpha == 'lin':
        return lambda t: 1 - (1 - eta) * t
    elif alpha == 'cos':
        a = math.acos(math.sqrt(eta))
        return lambda t: torch.cos(a * t) ** 2
    elif alpha == 'exp':
        b = math.log(eta)
        return lambda t: torch.exp(b * t**2)
    else:
        raise ValueError(f"unknown alpha schedule '{alpha}'")


class VPSDE:
    r"""Variance-preserving SDE, :math:`\mu(t) = \alpha(t)` and
    :math:`\sigma(t)^2 = 1 - \alpha(t)^2 + \eta^2`.

    Arguments:
        eps: An optional noise estimator ``eps(x, t, c)``.
        shape: The event shape.
        alpha: The choice of :math:`\alpha(t)`.
        eta: A numerical stability term.
    """

    def __init__(
        self,
        eps: Optional[EpsFn] = None,
        shape: Sequence[int] = (),
        alpha: str = 'cos',
        eta: float = 1e-3,
    ):
        self.eps = eps
        self.shape = tuple(shape)
        self.dims = tuple(range(-len(self.shape), 0))
        self.eta = eta
        self.alpha = make_alpha(alpha, eta)

    def mu(self, t: Tensor) -> Tensor:
        return self.alpha(t)

    def sigma(self, t: Tensor) -> Tensor:
        return torch.sqrt(1 - self.alpha(t) ** 2 + self.eta**2)

    def perturb(
        self,
        x: Tensor,
        t: Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        z: Optional[Tensor] = None,
    ) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        r"""Samples :math:`x(t) = \mu(t) x + \sigma(t) z` from the
        perturbation kernel, ``t`` broadcast over the event axes and
        ``z ~ N(0, 1)`` drawn from ``generator`` unless given; returns
        ``(x(t), z)`` when ``train``."""

        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        t = t.reshape(t.shape + (1,) * len(self.shape))

        if z is None:
            z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        else:
            z = torch.as_tensor(z, dtype=x.dtype, device=x.device)
        xt = self.mu(t) * x + self.sigma(t) * z

        return (xt, z) if train else xt

    def loss(
        self,
        x: Tensor,
        c: Optional[Tensor] = None,
        w: Optional[Tensor] = None,
        eps: Optional[EpsFn] = None,
        generator: Optional[torch.Generator] = None,
        t: Optional[Tensor] = None,
        z: Optional[Tensor] = None,
    ) -> Tensor:
        r"""The denoising loss ``mean((eps(x(t), t, c) - z)^2)``, weighted by
        ``w`` (``mean(err w) / mean(w)``) if given.

        ``t ~ U(0, 1)`` per leading-batch element, then ``z ~ N(0, 1)``, both
        drawn from ``generator`` in that order unless given (the JAX package
        splits its key into the same two draws).
        """

        eps_fn = self.eps if eps is None else eps

        if t is None:
            t = torch.rand((x.shape[0],), generator=generator, device=x.device, dtype=x.dtype)
        else:
            t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        xt, z = self.perturb(x, t, train=True, generator=generator, z=z)
        err = (eps_fn(xt, t, c) - z).square()

        if w is None:
            return err.mean()
        return (err * w).mean() / w.mean()

    @torch.no_grad()
    def sample(
        self,
        shape: Sequence[int] = (),
        c: Optional[Tensor] = None,
        steps: int = 64,
        corrections: int = 0,
        tau: float = 1.0,
        eps: Optional[EpsFn] = None,
        generator: Optional[torch.Generator] = None,
        init: Optional[Tensor] = None,
        noise: Optional[Callable[[int, int], Tensor]] = None,
    ) -> Tensor:
        r"""Samples from :math:`p(x(0))` over a uniform time grid ``1 -> 0``.

        - predictor: ``x <- r x + (sigma(t - dt) - r sigma(t)) eps(x, t, c)``
          with ``r = mu(t - dt) / mu(t)``;
        - ``corrections`` Langevin steps at ``t - dt``:
          ``x <- x - (delta eps + sqrt(2 delta) z) sigma(t - dt)`` with
          ``delta = tau / mean(eps^2)`` over the event axes.

        Arguments:
            shape: The batch shape.
            c: The optional context.
            steps: The number of time steps.
            corrections: The number of Langevin corrections per step.
            tau: The amplitude of Langevin steps.
            eps: Optional override of the bound noise estimator.
            generator: The source of the initial state and of the noise;
                the sampler runs on its device.
            init: Optional initial state ``shape + self.shape`` in place of
                :math:`x(1) \sim N(0, 1)`; the sampler runs on its device.
            noise: Optional ``noise(i, j)`` giving the noise ``z`` of
                correction ``j`` at step ``i``, of shape
                ``(prod(shape),) + self.shape``.
        """

        eps_fn = self.eps if eps is None else eps
        shape = tuple(shape)

        if init is None:
            device = generator.device if generator is not None else None
            x = torch.randn(shape + self.shape, generator=generator, device=device)
        else:
            x = torch.as_tensor(init)
        x = x.reshape((-1,) + self.shape)

        if noise is None:
            def noise(i, j):
                return torch.randn(x.shape, generator=generator, device=x.device)

        dt = 1.0 / steps
        time = torch.linspace(1.0, 0.0, steps + 1, device=x.device)[:-1]

        for i in range(steps):
            t = time[i]

            e = eps_fn(x, t, c)

            r = self.mu(t - dt) / self.mu(t)
            x = r * x + (self.sigma(t - dt) - r * self.sigma(t)) * e

            for j in range(corrections):
                z = noise(i, j)
                e = eps_fn(x, t - dt, c)
                delta = tau / e.square().mean(dim=self.dims, keepdim=True)

                x = x - (delta * e + torch.sqrt(2 * delta) * z) * self.sigma(t - dt)

        return x.reshape(shape + self.shape)
