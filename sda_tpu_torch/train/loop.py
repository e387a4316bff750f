r"""Training runtime: AdamW epochs over device-resident data, LR schedules.

Counterpart of :mod:`sda_tpu.train.loop`. The JAX package runs an epoch as
one jitted ``lax.scan``; here it is a Python loop of eager steps, each a
forward, a backward and a ``torch.optim.AdamW`` update. AdamW with decoupled
weight decay on every parameter and the learning rate set before each step
to ``lr * factor(step // steps_per_epoch, epochs)`` (``step`` counted before
the update) is optax's ``adamw`` with the same schedule:
``p (1 - lr wd) - lr adam = p - lr (adam + wd p)``.

Every draw (shuffles, crops, ``t`` and the noise) comes from the trainer's
``torch.Generator``, unless a ``draws(epoch)`` hook supplies them, as the
tests do to replay the JAX package's PRNG streams.

Data parallelism (``mesh`` with a ``'dp'`` axis) splits the single-process
batch: every rank makes the same draws for the whole batch, computes the loss
terms of its part (its slice of the batch positions, or the positions whose
rows it holds when the dataset is host-sharded), and one ``all_reduce`` per
step sums the parts' gradients and losses, each part weighted by its share
of the batch. Every rank then takes the same AdamW step, so the replicas stay
equal, bit for bit.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..diffusion.sde import VPSDE
from ..parallel.mesh import batch_constraint, replicate
from ..tracing import span
from .data import TrajectoryDataset

Tensor = torch.Tensor

#: Per-epoch LR decay factors, ``factor(epoch, epochs)``.
SCHEDULES: Dict[str, Callable[[float, int], float]] = {
    'linear': lambda t, epochs: 1 - (t / epochs),
    'cosine': lambda t, epochs: (1 + math.cos(math.pi * t / epochs)) / 2,
    'exponential': lambda t, epochs: math.exp(-7 * (t / epochs) ** 2),
    'constant': lambda t, epochs: 1.0,
}

#: ``draws(epoch)`` -> ``{'train': pass_draws, 'valid': pass_draws}``, where
#: ``pass_draws`` may hold ``perm`` (the shuffle) and, indexed by batch,
#: ``starts`` (crops), ``t`` and ``z`` (the loss's times and noise). A key
#: left out is drawn from the generator.
Draws = Callable[[int], Dict[str, Dict[str, Any]]]


class Trainer:
    r"""Denoising score-matching trainer.

    Arguments:
        sde: The noise schedule (supplies the loss).
        module: The score network, trained in place (its parameters stay
            float32 whatever its compute dtype).
        trainset / validset: Device-resident datasets.
        epochs: The total number of epochs (drives the LR schedule).
        batch_size: The batch size.
        optimizer: Only ``'AdamW'``.
        learning_rate: The base AdamW learning rate.
        weight_decay: The AdamW weight decay.
        scheduler: The LR decay schedule name.
        generator: The source of every draw (default: seed 0 on the data's
            device).
        eps_wrapper: Optional wrapper of the module into the eps function
            the loss calls (e.g. :class:`~sda_tpu_torch.diffusion.MCScoreWrapper`).
        draws: Optional hook supplying an epoch's draws (see ``Draws``).
        mesh: An optional process mesh; batches are split over its ``'dp'``
            axis (data parallelism) and the module is broadcast from its
            first rank. Every rank of the mesh builds the trainer alike.
    """

    def __init__(
        self,
        sde: VPSDE,
        module: nn.Module,
        trainset: TrajectoryDataset,
        validset: TrajectoryDataset,
        epochs: int = 256,
        batch_size: int = 64,
        optimizer: str = 'AdamW',
        learning_rate: float = 1e-3,
        weight_decay: float = 1e-3,
        scheduler: str = 'linear',
        generator: Optional[torch.Generator] = None,
        eps_wrapper: Optional[Callable] = None,
        draws: Optional[Draws] = None,
        mesh=None,
        **absorb,
    ):
        if optimizer != 'AdamW':
            raise ValueError(f"unknown optimizer '{optimizer}'")
        if scheduler not in SCHEDULES:
            raise ValueError(f"unknown scheduler '{scheduler}'")
        if mesh is None and (trainset.sharded or validset.sharded):
            raise ValueError('a host-sharded dataset needs the mesh it is sharded over')

        self.sde = sde
        self.module = module
        self.trainset = trainset
        self.validset = validset
        self.epochs = epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.factor = SCHEDULES[scheduler]
        self.steps_per_epoch = max(len(trainset) // batch_size, 1)
        self.eps = module if eps_wrapper is None else eps_wrapper(module)
        self.draws = draws
        if generator is None:
            generator = torch.Generator(device=trainset.data.device).manual_seed(0)
        self.generator = generator
        self.mesh = mesh
        self.group = None if mesh is None else mesh.get_group('dp')
        if mesh is not None:
            replicate(module, mesh)

        self.optimizer = torch.optim.AdamW(
            module.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
        )
        self.step = 0  # optimizer steps taken
        self.epoch = 0

    def lr(self, step: int) -> float:
        r"""The learning rate of optimizer step ``step`` (0-based)."""

        return self.learning_rate * self.factor(step // self.steps_per_epoch, self.epochs)

    def loss(self, x: Tensor, t: Optional[Tensor] = None, z: Optional[Tensor] = None) -> Tensor:
        r"""The denoising loss of a batch (draws ``t`` and ``z`` unless given)."""

        return self.sde.loss(x, eps=self.eps, generator=self.generator, t=t, z=z)

    def train_step(self, x: Tensor, t: Optional[Tensor] = None, z: Optional[Tensor] = None) -> Tensor:
        r"""One AdamW step on the batch ``x`` (under a mesh, the global batch,
        the same on every rank); returns its loss (detached)."""

        if t is None:
            t = torch.rand((x.shape[0],), generator=self.generator, device=x.device, dtype=x.dtype)
        if z is None:
            z = torch.randn(x.shape, generator=self.generator, device=x.device, dtype=x.dtype)
        part = torch.arange(x.shape[0], device=x.device)
        if self.mesh is not None:
            part = batch_constraint(part, self.mesh)

        return self._step(x[part], t[part], z[part], len(part) / x.shape[0])

    def _step(self, x: Tensor, t: Tensor, z: Tensor, share: float) -> Tensor:
        r"""One AdamW step on this rank's part ``x`` of a batch, ``share`` of
        it; returns the batch's loss."""

        for group in self.optimizer.param_groups:
            group['lr'] = self.lr(self.step)

        self.optimizer.zero_grad(set_to_none=True)
        if len(x):
            with span('train.forward'):
                loss = self.loss(x, t, z) * share
            with span('train.backward'):
                loss.backward()
        else:
            loss = torch.zeros((), device=t.device)
        if self.group is not None:
            loss = self._all_reduce(loss)
        with span('train.optimizer'):
            self.optimizer.step()
        self.step += 1

        return loss.detach()

    def _all_reduce(self, loss: Tensor) -> Tensor:
        r"""Sums ``loss`` and every gradient (zeros where a rank has none)
        over the ``'dp'`` axis in one flat bucket; returns the summed loss."""

        params = [p for p in self.module.parameters() if p.requires_grad]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        flat = torch.cat([loss.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)

        offset = 1
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return flat[0]

    def _part(self, dataset: TrajectoryDataset, rows: Tensor) -> Tensor:
        r"""The batch positions this rank computes, of a batch of global row
        indices ``rows``."""

        if dataset.sharded:
            held = (rows >= dataset.offset) & (rows < dataset.offset + len(dataset.data))
            return held.nonzero().squeeze(1)
        part = torch.arange(len(rows), device=rows.device)
        if self.mesh is None:
            return part
        return batch_constraint(part, self.mesh)

    def _pass(self, dataset: TrajectoryDataset, draws: Dict[str, Any], train: bool) -> Tensor:
        idx, num_batches = dataset.epoch_batches(self.batch_size, self.generator, perm=draws.get('perm'))
        device = dataset.data.device
        losses = []
        for i in range(num_batches):
            rows, batch = idx[i], len(idx[i])
            # The whole batch's draws, in the order a single process makes them.
            starts = _nth(draws, 'starts', i)
            if starts is None:
                starts = dataset.draw_starts(batch, self.generator)
            t = _nth(draws, 't', i)
            if t is None:
                t = torch.rand((batch,), generator=self.generator, device=device)
            z = _nth(draws, 'z', i)
            if z is None:
                z = torch.randn((batch,) + dataset.item_shape, generator=self.generator, device=device)

            part = self._part(dataset, rows)
            x = dataset.data[rows[part] - dataset.offset]
            x = dataset.crop(x, starts=None if starts is None else starts.to(device)[part])
            t, z, share = t.to(device)[part], z.to(device)[part], len(part) / batch
            if train:
                losses.append(self._step(x, t, z, share))
            else:
                with torch.no_grad():
                    loss = self.loss(x, t, z) * share if len(part) else torch.zeros((), device=device)
                if self.group is not None:
                    dist.all_reduce(loss, group=self.group)
                losses.append(loss)
        return torch.stack(losses).mean()

    def step_epoch(self) -> Dict[str, float]:
        r"""Runs one epoch, a training pass then a validation pass; returns
        ``{'loss_train', 'loss_valid', 'lr'}`` (``lr`` at the epoch's start)."""

        lr = self.lr(self.epoch * self.steps_per_epoch)
        draws = self.draws(self.epoch) if self.draws is not None else {}

        loss_train = self._pass(self.trainset, draws.get('train', {}), train=True)
        loss_valid = self._pass(self.validset, draws.get('valid', {}), train=False)
        self.epoch += 1

        return {'loss_train': float(loss_train), 'loss_valid': float(loss_valid), 'lr': lr}

    def __iter__(self) -> Iterator[Dict[str, float]]:
        while self.epoch < self.epochs:
            yield self.step_epoch()


def _nth(draws: Dict[str, Any], key: str, i: int) -> Optional[Tensor]:
    return draws[key][i] if key in draws else None


def loop(
    sde: VPSDE,
    module: nn.Module,
    trainset: TrajectoryDataset,
    validset: TrajectoryDataset,
    **kwargs,
) -> Trainer:
    r"""Builds a :class:`Trainer`; iterating it yields per-epoch stats."""

    return Trainer(sde, module, trainset, validset, **kwargs)
