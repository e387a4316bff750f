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
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional

import torch
import torch.nn as nn

from ..diffusion.sde import VPSDE
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
        **absorb,
    ):
        if optimizer != 'AdamW':
            raise ValueError(f"unknown optimizer '{optimizer}'")
        if scheduler not in SCHEDULES:
            raise ValueError(f"unknown scheduler '{scheduler}'")

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
        r"""One AdamW step on the batch ``x``; returns its loss (detached)."""

        for group in self.optimizer.param_groups:
            group['lr'] = self.lr(self.step)

        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(x, t, z)
        loss.backward()
        self.optimizer.step()
        self.step += 1

        return loss.detach()

    def _pass(self, dataset: TrajectoryDataset, draws: Dict[str, Any], train: bool) -> Tensor:
        idx, num_batches = dataset.epoch_batches(self.batch_size, self.generator, perm=draws.get('perm'))
        losses = []
        for i in range(num_batches):
            x = dataset.crop(dataset.data[idx[i]], self.generator, starts=_nth(draws, 'starts', i))
            t, z = _nth(draws, 't', i), _nth(draws, 'z', i)
            if train:
                losses.append(self.train_step(x, t, z))
            else:
                with torch.no_grad():
                    losses.append(self.loss(x, t, z))
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
