r"""Bootstrap particle filter, the ground-truth posterior sampler.

Counterpart of :func:`sda_tpu.eval.bpf`: transitions batched over all
particles, ``step`` transitions per observation, and resampling of the whole
history from the log-weights after each observation. A Python loop takes the
place of ``lax.scan``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def bpf(
    x: Tensor,
    y: Tensor,
    transition: Callable[[Tensor, Optional[torch.Generator]], Tensor],
    log_likelihood: Callable[[Tensor, Tensor], Tensor],
    step: int = 1,
    generator: Optional[torch.Generator] = None,
    resample: Optional[Callable[[int, Tensor], Tensor]] = None,
) -> Tensor:
    r"""Samples :math:`p(x_{0:n} | y_{1:n})`; returns the particle histories
    ``(M, n step + 1, *state)``.

    Arguments:
        x: The initial particles ``(M, *state)``.
        y: The observations ``(n, *obs)``.
        transition: The transition sampler ``(x, generator) -> x'``.
        log_likelihood: Per-particle log-weights ``(y_i, x_i) -> (M,)``.
        step: The number of transitions per observation.
        generator: The source of the transitions' and the resampling's draws.
        resample: Optional ``resample(i, logw)`` giving the ``(M,)`` ancestor
            indices after observation ``i`` in place of the default draw
            from ``softmax(logw)`` (the JAX package draws them with
            ``jax.random.categorical``; tests feed its draws through here).
    """

    m, n = x.shape[0], y.shape[0]

    history = x.new_empty((m, n * step + 1) + x.shape[1:])
    history[:, 0] = x
    cur = x

    for i in range(n):
        for s in range(step):
            cur = transition(cur, generator)
            history[:, 1 + i * step + s] = cur

        logw = log_likelihood(y[i], cur)
        if resample is None:
            j = torch.multinomial(torch.softmax(logw, dim=0), m, replacement=True, generator=generator)
        else:
            j = torch.as_tensor(resample(i, logw), device=x.device).long()

        history = history[j]
        cur = cur[j]

    return history
