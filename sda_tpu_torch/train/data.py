r"""Trajectory datasets: HDF5 I/O and device-resident windowed batching.

Counterpart of :mod:`sda_tpu.train.data`. The whole dataset lives on the
device; shuffles and random temporal crops are drawn there from a
``torch.Generator``, or taken from the caller (``perm``, ``starts``) so that
tests can replay the JAX package's draws.

``h5py`` is imported inside :func:`save_h5` and :func:`load_h5` only: the
training path takes tensors and runs without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils import resolve_device

Tensor = torch.Tensor


def save_h5(path: Path, x) -> None:
    r"""Writes a trajectory array to HDF5 under key ``'x'`` (float32)."""

    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    with h5py.File(path, mode='w') as f:
        f.create_dataset('x', data=np.asarray(x), dtype=np.float32)


def load_h5(path: Path) -> np.ndarray:
    r"""Reads the trajectory array ``'x'`` from HDF5."""

    import h5py

    with h5py.File(path, mode='r') as f:
        return f['x'][:]


class TrajectoryDataset:
    r"""Device-resident trajectory dataset.

    Arguments:
        data: The trajectories ``(N, L, C, *spatial)`` (array, tensor or
            HDF5 path).
        window: The temporal crop length (``None`` keeps full trajectories).
        flatten: Whether to merge ``(window, C) -> (window * C,)`` per item.
        device: Where the data lives.
    """

    def __init__(
        self,
        data,
        window: Optional[int] = None,
        flatten: bool = False,
        device: Union[str, torch.device] = 'cuda',
    ):
        if isinstance(data, (str, Path)):
            data = load_h5(data)

        self.data = torch.as_tensor(data, dtype=torch.float32).to(resolve_device(device))
        self.window = window
        self.flatten = flatten

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def length(self) -> int:
        return self.data.shape[1]

    def crop(
        self,
        x: Tensor,
        generator: Optional[torch.Generator] = None,
        starts: Optional[Tensor] = None,
    ) -> Tensor:
        r"""Random temporal crop of a batch ``(B, L, C, *spatial)`` to
        ``(B, window, C, *spatial)``: one start per item in
        ``[0, L - window]``, drawn from ``generator`` unless given."""

        if self.window is None:
            return x

        if starts is None:
            starts = torch.randint(
                0, x.shape[1] - self.window + 1, (x.shape[0],), generator=generator, device=x.device,
            )
        frames = starts.to(x.device)[:, None] + torch.arange(self.window, device=x.device)
        x = x[torch.arange(x.shape[0], device=x.device)[:, None], frames]

        if self.flatten:
            x = x.reshape(x.shape[:1] + (-1,) + x.shape[3:])

        return x

    def epoch_batches(
        self,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        perm: Optional[Tensor] = None,
    ) -> Tuple[Tensor, int]:
        r"""A shuffled index matrix ``(num_batches, batch_size)`` for one
        epoch, from a permutation drawn from ``generator`` unless given. The
        remainder (``N mod batch_size`` items) is dropped; a dataset smaller
        than ``batch_size`` makes one batch of all its items."""

        n = len(self)
        batch_size = min(batch_size, n)
        num_batches = n // batch_size

        if perm is None:
            perm = torch.randperm(n, generator=generator, device=self.data.device)
        idx = perm.to(self.data.device)[: num_batches * batch_size].reshape(num_batches, batch_size)

        return idx, num_batches
