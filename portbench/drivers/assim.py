r"""Guided assimilation: the ``coarse`` scenario through the port's sampler.

Set-up builds what ``experiments.kolmogorov.assimilate.assimilate`` builds:
the run's window kernel (the arch's ``program``: ``make_score`` for the
U-Net), its trajectory eps
(``make_trajectory_eps``, with the cell's chunk and remat), the scenario's
operator, noise and inflation (``get_scenario('coarse')``), ``GaussianScore``
and the ``VPSDE`` over the trajectory. The benchmark makes the inputs from
the seed on the device: a truth (fields from the solver's prior, one per
frame), its observation ``y``, each grid's initial state and each
correction's noise. One unit of the window is one segment of the grid, as
``--segments`` runs it: one ``VPSDE.sample`` call from the previous
segment's output; when a grid ends, the next sample starts.

The comparison: the reference rolls each checked segment forward from its
input state, every step (predictor and corrections), in float32 and in the
configuration's bf16; the number is the widest gap over the samples in units
of bf16's own rounding over that segment, ``rms(x_program - x_f32) /
rms(x_bf16 - x_f32)``. That unit keeps the number alike at every point of the
grid, where the step's sensitivity to rounding grows tenfold towards ``t =
0``. The cell's ``checked`` names the segments: ``first``, the window's
first, whose input is the seeded initial state, and ``drawn``, one segment
drawn uniformly from the seed among the window's others (among all, where
``first`` is not checked), whose input is the program's state. A draw, and
not the window's last, because the last is the one that crossed the window's
end: a fault that made some segments fast would leave it a slow, sound one.
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from portbench import archs
from portbench.counts import PEAK_FLOPS, guided_step_flops
from portbench.reference import unet as ref
from portbench.reference.kolmogorov import KolmogorovReference
from portbench.seeds import generator, seed_of

Tensor = torch.Tensor


class Driver:
    count_name = 'step'

    def __init__(self, config: dict, work: dict, seed: int, device: torch.device, tree: dict):
        from sda_tpu_torch.diffusion import VPSDE, GaussianScore
        from sda_tpu_torch.experiments.kolmogorov.assimilate import get_scenario
        from sda_tpu_torch.experiments.kolmogorov.utils import make_trajectory_eps

        tr = work['traffic']
        self.config, self.work, self.seed, self.device, self.tree = config, work, seed, device, tree
        self.arch = archs.of(config)
        self.samples, self.length, size = tr['samples'], tr['length'], config['size']
        self.steps, self.corrections, self.tau, self.segment = tr['steps'], tr['corrections'], tr['tau'], tr['segment']
        self.shape = (self.samples, self.length, 2, size, size)

        white = torch.randn((self.length, 2, size, size), generator=generator(seed, 'truth', device=device),
                            device=device)
        with torch.no_grad():
            x_star = KolmogorovReference(size, config['dt'], device).prior(white)
        A, _, std, length, gamma = get_scenario(tr['scenario'], x_star, np.random.RandomState(0))
        if length != self.length:
            raise ValueError(f"scenario {tr['scenario']} observes {length} frames, the cell {self.length}")
        obs = ref.coarse(x_star[None])[0]
        self.y = obs + std * torch.randn(obs.shape, generator=generator(seed, 'y', device=device), device=device)
        self.std, self.gamma = std, gamma

        module = self.arch.program(config, tree, device).requires_grad_(False).eval()
        self.score = make_trajectory_eps(module, config['window'], chunk=tr['chunk'], remat=tr['remat'])
        guided = GaussianScore(y=self.y, A=A, std=std, sde=VPSDE(eps=self.score, shape=()), gamma=gamma,
                               remat=tr['remat'])
        self.sde = VPSDE(eps=guided, shape=self.shape[1:])

        self.flops_per_count = guided_step_flops(config, self.length, self.samples, self.corrections)
        self.peak_flops = PEAK_FLOPS['bfloat16' if config['bf16'] else 'float32']

        t0 = time.perf_counter()
        self._sample(self.init(-1), -1, 0, 1)  # warms up one step at the cell's shapes
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        print(f'warm-up {time.perf_counter() - t0:.3f} s', file=sys.stderr)
        self.grid, self.pos, self.x = 0, 0, self.init(0)
        self.first = self.drawn = self.params = None
        self.rollouts = {}
        self.pick = random.Random(seed_of(seed, 'checked'))
        self.units = 0

    def init(self, grid: int) -> Tensor:
        return torch.randn(self.shape, generator=generator(self.seed, 'init', grid, device=self.device),
                           device=self.device)

    def noise(self, grid: int):
        def noise(i, j):
            g = generator(self.seed, 'noise', grid, i, j, device=self.device)
            return torch.randn(self.shape, generator=g, device=self.device)
        return noise

    def _sample(self, x: Tensor, grid: int, i0: int, i1: int) -> Tensor:
        return self.sde.sample((self.samples,), steps=self.steps, corrections=self.corrections, tau=self.tau,
                               init=x, noise=self.noise(grid), segment=(i0, i1))

    def unit(self) -> int:
        i0 = self.pos
        i1 = min(i0 + self.segment, self.steps)
        x_in = self.x
        self.x = self._sample(x_in, self.grid, i0, i1)
        record = (self.grid, i0, i1, x_in, self.x)
        if self.first is None:
            self.first = record
        # One of the units after the first (or of all, where the first is
        # not checked) drawn uniformly from the seed, one kept at a time.
        k = self.units - ('first' in self.work['checked'])
        if k >= 0 and self.pick.random() * (k + 1) < 1:
            self.drawn = record
        self.units += 1
        if i1 == self.steps:
            self.grid, self.pos, self.x = self.grid + 1, 0, self.init(self.grid + 1)
        else:
            self.pos = i1
        return i1 - i0

    def release(self) -> None:
        self.sde = self.score = self.x = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def _segment(self, record, precision: str) -> Tensor:
        r"""The reference's rollout of a recorded segment from its input (kept,
        since the control reads it again)."""

        grid, i0, i1, x, _ = record
        key = (grid, i0, i1, precision)
        if key in self.rollouts:
            return self.rollouts[key]
        if self.params is None:
            self.params = ref.to_device(self.tree, self.device)
        net = self.arch.reference(self.params, self.config, precision)
        step = ref.GuidedStep(net, self.config['window'], self.y, self.std, self.gamma, self.steps,
                              self.corrections, self.tau, self.work['reference_chunk'])
        noise = self.noise(grid)
        with ref.true_float32():
            for i in range(i0, i1):
                x = step(x, i, noise)
        self.rollouts[key] = x
        return x

    @staticmethod
    def gap(x: Tensor, x_ref: Tensor, x_low: Tensor) -> float:
        num = (x - x_ref).square().flatten(1).mean(1).sqrt()
        den = (x_low - x_ref).square().flatten(1).mean(1).sqrt()
        return float((num / den).max())

    def checked(self) -> list:
        r"""``(name, record)`` of the segments the comparison reads."""

        records = {'first': self.first, 'drawn': self.drawn}
        return [(f'{which}_segment', records[which]) for which in self.work['checked'] if records[which]]

    def compare(self, candidate) -> list:
        r"""``(name, gap, limit)`` of each checked segment, with
        ``candidate(record)`` in the program's place."""

        out = []
        for name, record in self.checked():
            x_ref = self._segment(record, 'float32')
            x_low = self._segment(record, 'bfloat16')
            x = candidate(record)
            value = self.gap(x, x_ref, x_low) if ref.finite(x) else float('inf')
            print(f'{name}: grid {record[0]}, steps {record[1]}-{record[2]}', file=sys.stderr)
            out.append((name, value, self.work['limits'].get(name)))
        return out

    def check(self) -> list:
        return self.compare(lambda record: record[4])

    def control(self) -> list:
        r"""The reference in float8 in the program's place."""

        return self.compare(lambda record: self._segment(record, 'fp8'))
