r"""Training: AdamW steps of the window kernel through ``Trainer.train_step``.

Set-up builds what ``experiments.kolmogorov.train`` builds, from the run's
parameters instead of a fresh draw: the window kernel (the arch's
``program``; for the U-Net ``make_score``, its parameters float32, its
products in the configuration's dtype), the
``VPSDE`` of a flattened window, a ``TrajectoryDataset`` of windows of
``window`` frames held on the device, and the ``Trainer`` with the
configuration's optimizer settings. The benchmark makes the trajectories
(unit normal fields, the published split's shape) and every draw from the
seed on the device: each epoch's shuffle, each batch's crop starts, times
and noise. The dataset crops the windows. Set-up warms the trainer up with
steps on draws of their own, then puts the run's parameters back in
place and resets AdamW's state and the step count, so that the window starts
the job afresh: one step per unit, each issued when the host is free, the
first ones recorded for the comparison.

The comparison, against a float32 AdamW reference of the window's first
steps on the same windows, times and noise (the reference crops the windows itself):
each step's loss (relative gap, the worst step); the first gradient as the
optimizer holds it (``exp_avg / (1 - beta1)`` after one step); and the
parameters' change over the first steps, read before the next step. Both by
the worst leaf: the gap between the two norms over the reference's norm of
that leaf or of the median leaf, whichever is larger. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of the
change (Adam moves them by round-off alone).
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import archs
from portbench.counts import PEAK_FLOPS, train_step_flops
from portbench.reference import unet as ref
from portbench.seeds import generator

Tensor = torch.Tensor
BETA1 = 0.9


def worst_leaf(program: Dict[str, float], reference: Dict[str, float], keys) -> Tuple[float, str]:
    r"""The largest gap of norms over ``max(reference leaf, median leaf)``
    and its leaf."""

    median = statistics.median(reference.values())
    return max((abs(program[k] - reference[k]) / max(reference[k], median), k) for k in keys)


class Driver:
    count_name = 'step'

    def __init__(self, config: dict, work: dict, seed: int, device: torch.device, tree: dict):
        from sda_tpu_torch.diffusion import VPSDE
        from sda_tpu_torch.train import TrajectoryDataset, Trainer

        tr = work['traffic']
        self.config, self.work, self.seed, self.device, self.tree = config, work, seed, device, tree
        self.arch = archs.of(config)
        self.batch, window, size = config['batch_size'], config['window'], config['size']
        self.gen = generator(seed, 'draws', device=device)

        data = torch.randn((tr['trajectories'], tr['frames'], 2, size, size),
                           generator=generator(seed, 'data', device=device), device=device)
        self.data = data
        self.dataset = TrajectoryDataset(data, window=window, flatten=True, device=device)

        self.module = self.arch.program(config, tree, device)
        self.names = self.arch.names(tree)
        sde = VPSDE(shape=(window * 2, size, size))
        self.trainer = Trainer(sde, self.module, self.dataset, self.dataset, epochs=config['epochs'],
                               batch_size=self.batch, optimizer=config['optimizer'],
                               learning_rate=config['learning_rate'], weight_decay=config['weight_decay'],
                               scheduler=config['scheduler'], generator=generator(seed, 'trainer', device=device))

        self.flops_per_count = train_step_flops(config, self.batch)
        self.peak_flops = PEAK_FLOPS['bfloat16' if config['bf16'] else 'float32']

        # The warm-up, on draws of its own; then the job starts afresh.
        self.p0 = {k: p.detach().clone() for k, p in self.module.named_parameters()}
        t0 = time.perf_counter()
        warm = generator(seed, 'warm-up', device=device)
        rows = torch.randperm(len(self.dataset), generator=warm, device=device)
        for k in range(tr['warmup_steps']):
            self._step(self._draw(rows[k * self.batch:(k + 1) * self.batch], warm))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        print(f'warm-up {time.perf_counter() - t0:.3f} s', file=sys.stderr)
        with torch.no_grad():
            for k, p in self.module.named_parameters():
                p.copy_(self.p0[k])
            for state in self.trainer.optimizer.state.values():
                for value in state.values():
                    value.zero_()
        self.trainer.step = self.trainer.epoch = 0

        self.checked: List[tuple] = []
        self.losses: List[Tensor] = []
        self.g1 = self.p_after = None
        self.perm, self.cursor = None, 0

    def _draw(self, rows: Tensor, gen: torch.Generator) -> tuple:
        starts = self.dataset.draw_starts(len(rows), gen)
        t = torch.rand((len(rows),), generator=gen, device=self.device)
        z = torch.randn((len(rows),) + self.dataset.item_shape, generator=gen, device=self.device)
        return rows, starts, t, z

    def _step(self, draw: tuple) -> Tensor:
        rows, starts, t, z = draw
        x = self.dataset.crop(self.dataset.data[rows], starts=starts)
        return self.trainer.train_step(x, t, z)

    def unit(self) -> int:
        if self.perm is None or self.cursor + self.batch > len(self.perm):
            self.perm = torch.randperm(len(self.dataset), generator=self.gen, device=self.device)
            self.cursor = 0
        rows = self.perm[self.cursor:self.cursor + self.batch]
        self.cursor += self.batch
        draw = self._draw(rows, self.gen)
        loss = self._step(draw)
        n = self.work['traffic']['checked_steps']
        if len(self.checked) < n:
            self.checked.append(draw)
            self.losses.append(loss)
            if len(self.checked) == 1:
                state = self.trainer.optimizer.state
                self.g1 = {name: state[p]['exp_avg'].detach() / (1 - BETA1)
                           for name, p in self.module.named_parameters()}
            if len(self.checked) == n:
                self.p_after = {k: p.detach().clone() for k, p in self.module.named_parameters()}
        return 1

    def release(self) -> None:
        self.trainer = self.module = self.dataset = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, precision: str, fault: Optional[str] = None) -> dict:
        r"""Readings of AdamW in ``precision`` over the checked steps'
        windows, which it crops from the trajectories itself. ``fault``
        plants one: ``'half_batch'`` (each loss over the first half of its
        batch) or ``'leaf_doubled'`` (the largest gradient leaf doubled where
        it is produced)."""

        window = self.config['window']
        batches = []
        for rows, starts, t, z in self.checked:
            frames = starts[:, None] + torch.arange(window, device=self.device)
            batch = (self.data[rows[:, None], frames].flatten(1, 2), t, z)
            if fault == 'half_batch':
                batch = tuple(a[:len(a) // 2] for a in batch)
            batches.append(batch)
        hook = None
        if fault == 'leaf_doubled':
            def hook(grads):
                top = max(grads, key=lambda k: float(grads[k].norm()))
                return {k: 2 * g if k == top else g for k, g in grads.items()}
        per_epoch = max(self.work['traffic']['trajectories'] // self.batch, 1)
        lrs = [self.config['learning_rate'] * (1 - (k // per_epoch) / self.config['epochs'])
               for k in range(len(batches))]
        p0 = ref.to_device(self.tree, self.device)
        with ref.true_float32():
            out = ref.adamw_steps(p0, lambda p: self.arch.reference(p, self.config, precision), batches, lrs,
                                  self.config['weight_decay'], hook=hook)
        return {'losses': out['losses'], 'grads': ref.leaf_norms(out['grads']),
                'change': ref.leaf_norms({k: out['params'][k] - p0[k] for k in p0})}

    def program(self) -> dict:
        r"""The program's readings, by leaf of the tree."""

        return {'losses': [float(v) for v in self.losses],
                'grads': {self.names[k]: v for k, v in ref.leaf_norms(self.g1).items()},
                'change': {self.names[k]: v for k, v in
                           ref.leaf_norms({k: p - self.p0[k] for k, p in self.p_after.items()}).items()}}

    def compare(self, got: dict, want: dict) -> list:
        limits = self.work['limits']
        loss = max(abs(a - b) / abs(b) for a, b in zip(got['losses'], want['losses']))
        median = statistics.median(want['grads'].values())
        moved = [k for k, v in want['grads'].items() if v >= 1e-3 * median]
        grad, grad_leaf = worst_leaf(got['grads'], want['grads'], want['grads'])
        change, change_leaf = worst_leaf(got['change'], {k: want['change'][k] for k in moved}, moved)
        print(f'worst leaves: first_grad {grad_leaf}, param_change {change_leaf} '
              f'({len(want["grads"]) - len(moved)} leaves left out of the change); loss gaps by step '
              f'{[abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]}; median leaf: first_grad '
              f'{statistics.median(abs(got["grads"][k] - want["grads"][k]) / want["grads"][k] for k in moved)}, '
              f'param_change {statistics.median(abs(got["change"][k] - want["change"][k]) / want["change"][k] for k in moved)}',
              file=sys.stderr)
        values = [('loss', loss), ('first_grad', grad), ('param_change', change)]
        return [(name, v if np.isfinite(v) else float('inf'), limits.get(name)) for name, v in values]

    def check(self) -> list:
        if self.p_after is None:
            return [(name, float('inf'), limit) for name, limit in self.work['limits'].items()]
        return self.compare(self.program(), self.reference('float32'))

    def control(self, fault: Optional[str] = None) -> list:
        r"""The reference in float8 in the program's place, or, with a
        ``fault``, the float32 reference with that fault planted."""

        want = self.reference('float32')
        if fault is None:
            return self.compare(self.reference('fp8'), want)
        return self.compare(self.reference('float32', fault), want)
