r"""Sequence-parallel windowed scoring: each rank of the ``'sp'`` axis scores
its own contiguous block of the trajectory's windows.

Counterpart of :mod:`sda_tpu.parallel.windowed`. The JAX package shards the
trajectory itself and moves ``k``-frame halos between neighbours
(``ppermute``). Here every rank of the axis holds the whole trajectory: the
sampler and the guidance, whose observation operator may couple any frames
(``loop`` compares the first with the last), run replicated on every rank
with the same noise. Each rank unfolds the trajectory (reading its halos
from its own copy, so no point-to-point traffic), evaluates only its block
of the ``L - 2k`` windows, and an all-gather assembles the windows' eps,
which :func:`~sda_tpu_torch.diffusion.fold` turns into the trajectory's as
in :class:`~sda_tpu_torch.diffusion.MCScoreNet`. The memory that sequence
parallelism splits, the network's activations, is split as in the JAX
package.

Two autograd functions, a conjugate pair, carry the gradient through the
guidance's VJP: into the shard, the rank's block forward and an all-gather
of the blocks' gradients backward; out of the shard, an all-gather forward
and the rank's block backward. With the cotangent the same on every rank,
the input gradient is ``sum_r J_r^T v_r``, once. (``all_gather`` of
``torch.distributed.nn`` reduce-scatters in its backward and would scale it
by ``n``.) Gathering the window gradients, where Megatron's pair all-reduces
the input gradients, leaves the sum over windows to ``unfold``'s backward on
every rank, in one process's order, so a sample is the one process's up to
the kernel's own rounding. The collectives sit outside the per-chunk
checkpoints, so a backward pass runs each of them once; a checkpoint of the
whole call (``GaussianScore(remat=True)`` on an unchunked score) re-runs
the forward all-gather while recomputing, which every rank does in the same
order.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..diffusion.windowed import chunked_eval, fold, unfold
from .mesh import axis_size

Tensor = torch.Tensor
Blocks = List[Tuple[int, int]]


def _gather(x: Tensor, group, blocks: Blocks) -> Tensor:
    r"""Concatenates every rank's ``x`` (its block of dim 1, ``blocks[r]``)
    along dim 1, padding each block to the largest for the all-gather."""

    size = max(hi - lo for lo, hi in blocks)
    padded = F.pad(x, (0, 0) * (x.dim() - 2) + (0, size - x.shape[1])).contiguous()
    parts = [torch.empty_like(padded) for _ in blocks]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([part[:, :hi - lo] for part, (lo, hi) in zip(parts, blocks)], dim=1)


class _IntoShard(torch.autograd.Function):
    r"""This rank's block of dim 1 forward; the all-gather of every rank's
    block gradient backward."""

    @staticmethod
    def forward(ctx, x, group, blocks):
        ctx.group, ctx.blocks = group, blocks
        lo, hi = blocks[dist.get_rank(group)]
        return x[:, lo:hi]

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.blocks), None, None


class _OutOfShard(torch.autograd.Function):
    r"""The all-gather of every rank's block along dim 1 forward; this rank's
    block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, blocks):
        ctx.block = blocks[dist.get_rank(group)]
        return _gather(x, group, blocks)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.block
        return grad[:, lo:hi], None, None


class ShardedMCScoreNet:
    r"""Trajectory eps function whose windows are split over the ranks of a
    mesh axis.

    Arguments:
        kernel: The window eps function (events ``((2k+1) C, *spatial)``).
        order: The Markov order ``k``.
        mesh: The process mesh.
        axis: The mesh axis to split the trajectory's windows over.
        chunk: Optional window-chunk size *within each shard*, the per-shard
            analog of ``MCScoreNet(chunk=...)``.
        remat: Checkpoint each chunk's kernel evaluation (as
            ``MCScoreNet(remat=True)``).

    Constraints: the trajectory length ``L`` must divide by the axis size,
    and each shard must hold at least ``2k + 1`` frames. Every rank of the
    axis calls it with the same ``x``, ``t`` and ``c``. The gradient reaches
    ``x`` only: the kernel's parameters get each rank's own share.
    """

    def __init__(
        self,
        kernel: Callable,
        order: int,
        mesh: DeviceMesh,
        axis: str = 'sp',
        chunk: Optional[int] = None,
        remat: bool = False,
    ):
        self.kernel = kernel
        self.order = order
        self.mesh = mesh
        self.axis = axis
        self.chunk = chunk
        self.remat = remat

    def __call__(self, x: Tensor, t: Tensor, c: Optional[Tensor] = None) -> Tensor:
        k = self.order
        n_shards = axis_size(self.mesh, self.axis)
        group = self.mesh.get_group(self.axis)

        length = x.shape[1]
        if length % n_shards:
            raise ValueError(f'trajectory length {length} must divide over {n_shards} shards')
        chunk = length // n_shards
        if chunk < 2 * k + 1:
            raise ValueError(f'chunk length {chunk} must hold a full window (2k+1 = {2 * k + 1})')

        windows = unfold(x, k)
        n = windows.shape[1]
        blocks = [(r * n // n_shards, (r + 1) * n // n_shards) for r in range(n_shards)]
        windows = _IntoShard.apply(windows, group, blocks)

        if self.chunk is None:
            s = self.kernel(windows, t, c)
        else:
            s = chunked_eval(self.kernel, windows, t, c, self.chunk, self.remat)

        return fold(_OutOfShard.apply(s, group, blocks), k)
