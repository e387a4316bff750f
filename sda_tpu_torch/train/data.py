r"""Trajectory datasets: HDF5 I/O and device-resident windowed batching.

Counterpart of :mod:`sda_tpu.train.data`. The whole dataset lives on the
device; shuffles and random temporal crops are drawn there from a
``torch.Generator``, or taken from the caller (``perm``, ``starts``) so that
tests can replay the JAX package's draws.

Under data parallelism a dataset may hold only some rows of the global one
(:func:`~sda_tpu_torch.parallel.host_sharded_array`): its length, shuffles
and draws stay the global dataset's, and the trainer computes the batch
positions whose rows it holds.

``h5py`` is imported inside :func:`save_h5` and :func:`load_h5` only: the
training path takes tensors and runs without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import HostShardedRows
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
        data: The trajectories ``(N, L, C, *spatial)`` (array, tensor, HDF5
            path, or this rank's rows from
            :func:`~sda_tpu_torch.parallel.host_sharded_array`).
        window: The temporal crop length (``None`` keeps full trajectories).
        flatten: Whether to merge ``(window, C) -> (window * C,)`` per item.
        device: Where the data lives.

    ``data`` holds the rows ``[offset, offset + len(data))`` of the
    ``len(self)`` rows of the dataset (all of them unless host-sharded).
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

        self.sharded = isinstance(data, HostShardedRows)
        if self.sharded:
            self.offset, self.rows = data.offset, data.shape[0]
            data = data.local
        self.data = torch.as_tensor(data, dtype=torch.float32).to(resolve_device(device))
        if not self.sharded:
            self.offset, self.rows = 0, self.data.shape[0]
        self.window = window
        self.flatten = flatten

    def __len__(self) -> int:
        return self.rows

    @property
    def length(self) -> int:
        return self.data.shape[1]

    @property
    def item_shape(self) -> Tuple[int, ...]:
        r"""The shape of one cropped item."""

        shape = tuple(self.data.shape[1:])
        if self.window is None:
            return shape
        if self.flatten:
            return (self.window * shape[1],) + shape[2:]
        return (self.window,) + shape[1:]

    def draw_starts(self, n: int, generator: Optional[torch.Generator] = None) -> Optional[Tensor]:
        r"""``n`` crop starts in ``[0, L - window]`` from ``generator``
        (``None`` without a window)."""

        if self.window is None:
            return None
        return torch.randint(0, self.length - self.window + 1, (n,), generator=generator, device=self.data.device)

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
            starts = self.draw_starts(x.shape[0], generator)
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
