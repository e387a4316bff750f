r"""Weak-constraint 4D-Var by L-BFGS, the classical variational baseline.

Counterpart of :mod:`sda_tpu.eval.var4d`. The JAX package runs optax's L-BFGS
with a zoom line search; here it is ``torch.optim.LBFGS`` with a strong-Wolfe
line search and optax's memory of 10 pairs. The two are different
algorithms, so they agree on the minimum, not on the iterates.
"""

from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def lbfgs_minimize(fun: Callable[[Tensor], Tensor], x0: Tensor, iterations: int = 100) -> Tensor:
    r"""Minimises a scalar function of one tensor with L-BFGS from ``x0``,
    at most ``iterations`` updates (each line search may evaluate ``fun``
    up to 20 times, optax's ``max_linesearch_steps``)."""

    x = x0.detach().clone().requires_grad_(True)
    opt = torch.optim.LBFGS(
        [x], lr=1.0, max_iter=iterations, max_eval=20 * iterations, history_size=10,
        tolerance_grad=0.0, tolerance_change=0.0, line_search_fn='strong_wolfe',
    )

    def closure():
        opt.zero_grad()
        value = fun(x)
        value.backward()
        return value

    with torch.enable_grad():
        opt.step(closure)

    return x.detach()


def weak_4d_var_objective(
    x_b: Tensor,
    y: Tensor,
    log_prior: Callable[[Tensor], Tensor],
    log_likelihood: Callable[[Tensor, Tensor], Tensor],
) -> Callable[[Tensor], Tensor]:
    r"""The weak-constraint 4D-Var objective

    .. math:: J(x) = \|x_0 - x_b\|^2 - \log p(x) - \log p(y | x)

    with the background initial state ``x_b`` frozen."""

    x_b = x_b.detach()

    def objective(x: Tensor) -> Tensor:
        background = torch.sum((x[0] - x_b) ** 2)
        return background - torch.sum(log_prior(x)) - torch.sum(log_likelihood(y, x))

    return objective


def weak_4d_var(
    x: Tensor,
    y: Tensor,
    log_prior: Callable[[Tensor], Tensor],
    log_likelihood: Callable[[Tensor, Tensor], Tensor],
    iterations: int = 100,
) -> Tensor:
    r"""Weak-constraint 4D-Var estimate from the trajectory guess ``x``
    ``(L, *state)``, whose first state is the background (see
    :func:`weak_4d_var_objective`)."""

    return lbfgs_minimize(weak_4d_var_objective(x[0], y, log_prior, log_likelihood), x, iterations)
