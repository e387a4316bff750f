r"""Process meshes for data- and sequence-parallel runs over ``torch.distributed``.

Counterpart of :mod:`sda_tpu.parallel.mesh`. The JAX package runs one program
over a ``jax.sharding.Mesh`` of devices; here each rank is a process with one
device (multi-controller), and a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` whose ``get_group(axis)``
is the process group of that axis. Data parallelism (``'dp'``) splits a
batch over the ranks and all-reduces the gradient
(:class:`~sda_tpu_torch.train.Trainer`); sequence parallelism (``'sp'``)
splits a trajectory's windows (:class:`~sda_tpu_torch.parallel.ShardedMCScoreNet`).

The backend is NCCL on the card and gloo on the CPU. Gloo also takes CUDA
tensors for ``all_reduce``, ``all_gather`` and ``broadcast``, staged through
the host, which lets several ranks share one card: NCCL refuses that.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

from ..utils import resolve_device

Tensor = torch.Tensor

#: How long a rank waits for the others at start-up and in each collective.
#: The longest gap between two collectives of a training run is rank 0
#: writing a checkpoint, seconds at the published widths.
TIMEOUT = timedelta(seconds=60)


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[str, torch.device] = 'cuda',
    backend: Optional[str] = None,
    timeout: timedelta = TIMEOUT,
) -> torch.device:
    r"""Brings up the default process group and binds this rank's device.

    Every process calls it once, before any collective. The arguments not
    given come from the environment that ``torchrun`` sets
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); without those,
    the group is a world of one.

    Arguments:
        coordinator_address: ``host:port`` of rank 0.
        num_processes: The world size.
        process_id: This rank, in ``[0, num_processes)``.
        device: ``'cuda'`` or ``'cpu'``. On the card the rank binds
            ``cuda:LOCAL_RANK`` (default: its rank modulo the cards seen), so
            ``'cuda'`` names its own card from then on.
        backend: NCCL on the card and gloo on the CPU unless given.
        timeout: The limit of the start-up and of each collective.

    Returns:
        This rank's device.
    """

    if dist.is_initialized():
        raise RuntimeError('init_multihost must run once, before any other process group is brought up')

    env = os.environ
    launched = coordinator_address is None and 'MASTER_ADDR' in env
    if num_processes is None:
        num_processes = int(env.get('WORLD_SIZE', 1))
    if process_id is None:
        process_id = int(env.get('RANK', 0))

    device = resolve_device(device)
    if device.type == 'cuda':
        index = int(env.get('LOCAL_RANK', process_id % torch.cuda.device_count()))
        torch.cuda.set_device(index)
        device = torch.device('cuda', index)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'

    if launched:  # torchrun's store, which its agent may already host
        init_method = 'env://'
    elif coordinator_address is not None:
        init_method = f'tcp://{coordinator_address}'
    elif num_processes == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=timeout)
        return device
    else:
        raise ValueError(f'{num_processes} processes need the address of rank 0')

    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id, timeout=timeout,
    )

    return device


def make_mesh(axes: Optional[Dict[str, int]] = None, device: Union[str, torch.device] = 'cuda') -> DeviceMesh:
    r"""Builds a mesh over the ranks of the default process group.

    Every rank of the group must call it, with the same ``axes``. Without a
    process group it first brings one up through :func:`init_multihost`
    (``torchrun``'s environment, else a world of one on ``device``), so a
    single-process caller needs no launcher.

    Arguments:
        axes: Mapping axis name -> size. A size of ``-1`` absorbs the
            remaining ranks. Defaults to ``{'dp': world_size}``.
        device: The device of this rank (``'cuda'`` or ``'cpu'``).

    A mesh smaller than the world takes the first ranks, as the JAX package
    takes the first devices. The other ranks are outside it: their
    ``mesh.get_coordinate()`` is ``None``, they must not join the mesh's
    collectives, and the command lines return at once on them.
    """

    if not dist.is_initialized():
        init_multihost(device=device)

    n = dist.get_world_size()
    if axes is None:
        axes = {'dp': n}

    names = list(axes)
    sizes = list(axes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known

    need = math.prod(sizes)
    if need > n:
        raise ValueError(f'mesh {dict(zip(names, sizes))} needs {need} ranks, have {n}')

    device_type = 'cuda' if torch.device(device).type == 'cuda' else 'cpu'

    return DeviceMesh(device_type, torch.arange(need).reshape(sizes), mesh_dim_names=tuple(names))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    r"""The size of ``axis`` in ``mesh``, 1 when the mesh lacks it or is ``None``."""

    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    r"""This rank's coordinate along ``axis`` (it must be in the mesh)."""

    coordinate = mesh.get_coordinate()
    if coordinate is None:
        raise RuntimeError(f'rank {dist.get_rank()} is outside the mesh {mesh}')
    return coordinate[mesh.mesh_dim_names.index(axis)]


def _part(n: int, parts: int, index: int) -> slice:
    return slice(index * n // parts, (index + 1) * n // parts)


def shard_batch(x: Tensor, mesh: DeviceMesh, axis: str = 'dp') -> Tensor:
    r"""This rank's slice of ``x``'s leading axis over ``axis`` (the leading
    axis must divide by the axis size)."""

    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f'leading axis {x.shape[0]} does not divide over {n} ranks of {axis!r}')

    return x[_part(x.shape[0], n, axis_index(mesh, axis))]


def batch_constraint(x: Tensor, mesh: DeviceMesh, axis: str = 'dp') -> Tensor:
    r"""This rank's part of a global batch ``x`` over ``axis``: rows
    ``[r B / n, (r + 1) B / n)`` for coordinate ``r`` of ``n``, so the parts
    cover the batch whatever its size. The trainer sums each part's loss
    terms and all-reduces, which gives the global batch's mean."""

    return x[_part(x.shape[0], axis_size(mesh, axis), axis_index(mesh, axis))]


def replicate(x: Union[Tensor, nn.Module], mesh: DeviceMesh) -> Union[Tensor, nn.Module]:
    r"""Broadcasts a tensor, or a module's parameters and buffers, in place
    from the mesh's first rank to every rank of the mesh (along each axis in
    turn); returns ``x``."""

    tensors = [x] if isinstance(x, Tensor) else list(x.parameters()) + list(x.buffers())
    for tensor in tensors:
        for dim in range(mesh.ndim):
            group = mesh.get_group(dim)
            dist.broadcast(tensor.data, src=dist.get_global_rank(group, 0), group=group)

    return x


class HostShardedRows:
    r"""A global array ``(N, ...)`` of which this rank holds only the rows
    ``[offset, offset + len(local))``; made by :func:`host_sharded_array`.

    Arguments:
        local: This rank's rows.
        offset: The global index of its first row.
        rows: The global number of rows ``N``.
    """

    def __init__(self, local: Tensor, offset: int, rows: int):
        self.local = local
        self.offset = offset
        self.shape = (rows,) + tuple(local.shape[1:])


def host_sharded_array(local_part, mesh: DeviceMesh, axis: str = 'dp', device: Union[str, torch.device] = 'cuda'):
    r"""Assembles a global array from per-rank row shards (leading axis).

    Each rank feeds only its own slice (e.g. its shard of a dataset too large
    for one host), the same shape on every rank, in rank order along
    ``axis``, which must span every rank. No row moves:
    :class:`~sda_tpu_torch.train.TrajectoryDataset` takes the result and the
    trainer computes the loss terms of the rows each rank holds.

    Arguments:
        local_part: This rank's slice of the leading axis.
        mesh: A mesh whose ``axis`` spans all ranks.
        axis: The mesh axis the rows are split over.
        device: Where the rows live.
    """

    n = axis_size(mesh, axis)
    if n != dist.get_world_size():
        raise ValueError(f'axis {axis!r} of size {n} must span all {dist.get_world_size()} ranks')

    local = torch.as_tensor(local_part, dtype=torch.float32).to(resolve_device(device))

    sizes = torch.tensor([local.shape[0], -local.shape[0]], device=local.device)
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX)
    if sizes[0] != -sizes[1]:
        raise ValueError(f'the ranks hold {-int(sizes[1])} to {int(sizes[0])} rows: the shards must be equal')

    return HostShardedRows(local, axis_index(mesh, axis) * local.shape[0], n * local.shape[0])
