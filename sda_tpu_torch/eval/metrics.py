r"""Distribution metrics: Wasserstein/EMD and MMD.

Counterpart of :mod:`sda_tpu.eval.metrics`:

- :func:`emd`: the exact W1 transport cost between equal-size sample sets
  with uniform weights, whose optimal plan is an assignment. The distance
  matrix is computed on the samples' device; the assignment is solved on the
  host with scipy's ``linear_sum_assignment``, as in the JAX package.
- :func:`sinkhorn`: entropy-regularised OT in the log domain, on the device,
  for unequal counts.
- :func:`mmd`: multi-scale RBF-kernel MMD.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor


def pairwise_distances(x: Tensor, y: Tensor) -> Tensor:
    r"""Euclidean distance matrix between flattened sample sets, as
    ``sqrt(max(|x|^2 + |y|^2 - 2 x y, 0))``."""

    x = x.reshape(x.shape[0], -1)
    y = y.reshape(y.shape[0], -1)

    sq = (x**2).sum(dim=1)[:, None] + (y**2).sum(dim=1)[None, :] - 2 * x @ y.T

    return torch.sqrt(torch.clamp(sq, min=0.0))


def emd(x: Tensor, y: Tensor) -> float:
    r"""Exact earth mover's distance between two sample sets of equal size:
    the mean transport cost under the optimal plan, a permutation. ``nan``
    when a distance is not finite (diverged samples)."""

    from scipy.optimize import linear_sum_assignment

    if x.shape[0] != y.shape[0]:
        raise ValueError('exact emd requires equal sample counts; use sinkhorn instead')

    cost = pairwise_distances(torch.as_tensor(x), torch.as_tensor(y)).cpu().numpy()

    if not np.all(np.isfinite(cost)):
        return float('nan')

    rows, cols = linear_sum_assignment(cost)

    return float(cost[rows, cols].mean())


def sinkhorn(x: Tensor, y: Tensor, reg: float = 0.01, iterations: int = 200) -> Tensor:
    r"""Entropy-regularised OT cost ``<P, C>`` under the log-domain Sinkhorn
    plan (no entropy term); it tends to :func:`emd` as ``reg -> 0``."""

    cost = pairwise_distances(x, y)
    m, n = cost.shape

    log_mu = torch.full((m,), -math.log(m), device=cost.device)
    log_nu = torch.full((n,), -math.log(n), device=cost.device)

    f = torch.zeros(m, device=cost.device)
    g = torch.zeros(n, device=cost.device)
    for _ in range(iterations):
        f = -reg * torch.logsumexp((g[None, :] - cost) / reg + log_nu[None, :], dim=1)
        g = -reg * torch.logsumexp((f[:, None] - cost) / reg + log_mu[:, None], dim=0)

    log_plan = (f[:, None] + g[None, :] - cost) / reg + log_mu[:, None] + log_nu[None, :]

    return torch.sum(torch.exp(log_plan) * cost)


def mmd(x: Tensor, y: Tensor) -> Tensor:
    r"""Empirical maximum mean discrepancy with the kernels
    ``exp(-d^2 / sigma)`` summed over ``sigma in 1e-3..1e3``."""

    x = x.reshape(x.shape[0], -1)
    y = y.reshape(y.shape[0], -1)

    xx, yy, xy = x @ x.T, y @ y.T, x @ y.T

    dxx = torch.diagonal(xx)[:, None]
    dyy = torch.diagonal(yy)[None, :]

    err_xx = dxx + dxx.T - 2 * xx
    err_yy = dyy + dyy.T - 2 * yy
    err_xy = dxx + dyy - 2 * xy

    total = 0.0
    for sigma in (1e-3, 1e-2, 1e-1, 1e0, 1e1, 1e2, 1e3):
        total = total + (
            torch.exp(-err_xx / sigma).mean()
            + torch.exp(-err_yy / sigma).mean()
            - 2 * torch.exp(-err_xy / sigma).mean()
        )

    return total
