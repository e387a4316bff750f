r"""Windowed Markov-blanket score decomposition.

Counterpart of :mod:`sda_tpu.diffusion.windowed`: a kernel trained on windows
of ``2k + 1`` states scores trajectories of any length ``L`` by evaluating
all ``L - 2k`` sliding windows in one batched call and recombining them.
:class:`MCScoreWrapper` instead runs a spatial network over the time axis.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor
EpsFn = Callable[..., Tensor]


def unfold(x: Tensor, order: int) -> Tensor:
    r"""``(B, L, C, *spatial) -> (B, L - 2 order, (2 order + 1) C, *spatial)``,
    frame-major within each window."""

    k = 2 * order + 1
    length = x.shape[1] - k + 1

    windows = torch.stack([x[:, i:i + length] for i in range(k)], dim=2)

    return windows.reshape(windows.shape[:2] + (k * x.shape[2],) + windows.shape[4:])


def fold(x: Tensor, order: int) -> Tensor:
    r"""``(B, L', (2 order + 1) C, *spatial) -> (B, L' + 2 order, C, *spatial)``:
    the first window's leading ``order`` frames, every window's centre frame
    and the last window's trailing ``order`` frames."""

    k = 2 * order + 1
    x = x.reshape(x.shape[:2] + (k, x.shape[2] // k) + x.shape[3:])

    return torch.cat((x[:, 0, :order], x[:, :, order], x[:, -1, k - order:]), dim=1)


def chunked_eval(
    kernel: EpsFn,
    x: Tensor,
    t: Tensor,
    c: Optional[Tensor],
    chunk: int,
) -> Tensor:
    r"""Evaluates ``kernel`` over the window axis of an unfolded batch
    ``(B, n_windows, ...)`` in sequential chunks of ``chunk`` windows. The
    window axis is padded with copies of the last window up to a multiple of
    ``chunk``, and the pad windows' outputs are dropped."""

    batch, n_windows = x.shape[:2]
    chunk = min(chunk, n_windows)
    pad = (-n_windows) % chunk

    if pad:
        x = torch.cat((x, x[:, -1:].expand((batch, pad) + x.shape[2:])), dim=1)

    s = torch.cat(
        [kernel(x[:, i:i + chunk], t, c) for i in range(0, x.shape[1], chunk)],
        dim=1,
    )

    return s[:, :n_windows]


class MCScoreNet:
    r"""Composes a window-kernel eps function into a trajectory eps function
    over ``(B, L, C, *spatial)``.

    Arguments:
        kernel: The window eps function.
        order: The Markov order ``k`` (window size ``2k + 1``).
        chunk: Optional window-chunk size for sequential evaluation.
    """

    def __init__(self, kernel: EpsFn, order: int, chunk: Optional[int] = None):
        self.kernel = kernel
        self.order = order
        self.chunk = chunk

    def __call__(self, x: Tensor, t: Tensor, c: Optional[Tensor] = None) -> Tensor:
        x = unfold(x, self.order)

        if self.chunk is None:
            s = self.kernel(x, t, c)
        else:
            s = chunked_eval(self.kernel, x, t, c, self.chunk)

        return fold(s, self.order)


class MCScoreWrapper:
    r"""Runs a spatial score network over trajectories by treating time as a
    spatial axis: ``(B, L, C, *spatial)`` is transposed to
    ``(B, C, L, *spatial)`` around ``score`` (e.g. the 1-D ``ScoreUNet`` of
    the Lorenz "global" model)."""

    def __init__(self, score: EpsFn):
        self.score = score

    def __call__(self, x: Tensor, t: Tensor, c: Optional[Tensor] = None) -> Tensor:
        y = self.score(x.transpose(1, 2), t, c)

        return y.transpose(1, 2)
