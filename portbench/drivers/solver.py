r"""Data generation: rollouts of the Kolmogorov solver through the DFT kernels.

Set-up builds the solver as ``experiments.kolmogorov.generate`` does
(``make_chain``: ``KolmogorovFlow`` at the configuration's size and step,
``RealDFT2('auto')``, which is the CUDA kernel pair on the card) and draws a
chunk's prior from white noise that the benchmark makes from the seed on the
device. One transition warms up the shapes (and builds the kernels' library
on a checkout's first run). One unit of the window is one segment of
``trajectory``, continuing from the last frame of the one before.

The comparison: the plain ``torch.fft`` reference rolls out each checked
segment from its input and the number is the widest relative gap over the
fields, ``|x_program - x_ref| / |x_ref|`` over the segment's frames.
Checked: the window's first segment, which the reference computes from the
white noise (its prior included), and one of the others drawn uniformly from
the seed, from the program's state (a draw, and not the window's last, which
is the one that crossed the window's end, as in ``drivers/assim.py``).
"""

from __future__ import annotations

import random

import torch

from portbench.counts import PEAK_FLOPS, solver_flops
from portbench.reference.kolmogorov import KolmogorovReference
from portbench.seeds import generator, seed_of

Tensor = torch.Tensor


class Driver:
    count_name = 'transition'

    def __init__(self, config: dict, work: dict, seed: int, device: torch.device, tree: dict):
        from sda_tpu_torch.experiments.kolmogorov.utils import make_chain

        tr = work['traffic']
        self.config, self.work, self.device = config, work, device
        self.batch, self.segment, size = tr['batch'], tr['segment'], config['size']
        if config['dt'] != 0.2:
            raise ValueError('make_chain integrates steps of 0.2')
        self.chain = make_chain(size=size, device=device)
        self.white = torch.randn((self.batch, 2, size, size), generator=generator(seed, 'prior', device=device),
                                 device=device)
        self.x0 = self.chain.prior((self.batch,), noise=self.white)
        self.chain.trajectory(self.x0, length=1)  # warm-up
        self.x, self.done = self.x0, 0
        self.first = self.drawn = None
        self.pick = random.Random(seed_of(seed, 'checked'))

        self.flops_per_count = solver_flops(config, self.batch, self.segment) / self.segment
        self.peak_flops = PEAK_FLOPS['float32']

    def unit(self) -> int:
        x_in = self.x
        xs = self.chain.trajectory(x_in, length=self.segment)
        self.x = xs[-1]
        if self.first is None:
            self.first = (x_in, xs)
        else:
            k = self.done // self.segment - 1
            if self.pick.random() * (k + 1) < 1:
                self.drawn = (x_in, xs)
        self.done += self.segment
        return self.segment

    def release(self) -> None:
        self.chain = self.x = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    @staticmethod
    def gap(xs: Tensor, want: Tensor) -> float:
        num = torch.linalg.vector_norm((xs - want).transpose(0, 1).flatten(1), dim=1)
        return float((num / torch.linalg.vector_norm(want.transpose(0, 1).flatten(1), dim=1)).max())

    def compare(self, candidate) -> list:
        r"""``(name, gap, limit)`` of each checked segment, with
        ``candidate(x_in, first)`` in the program's place."""

        limits = self.work['limits']
        solver = KolmogorovReference(self.config['size'], self.config['dt'], self.device)
        out = []
        records = [('first_segment', self.first, True)]
        if self.drawn is not None:
            records.append(('drawn_segment', self.drawn, False))
        for name, record, first in records:
            x_in = solver.prior(self.white) if first else record[0]
            want = solver.trajectory(x_in, self.segment)
            xs = candidate(record, first)
            value = self.gap(xs, want) if bool(torch.isfinite(xs).all()) else float('inf')
            out.append((name, value, limits.get(name)))
        return out

    def check(self) -> list:
        return self.compare(lambda record, first: record[1])

    def control(self) -> list:
        r"""The reference in bfloat16 in the program's place."""

        low = KolmogorovReference(self.config['size'], self.config['dt'], self.device, precision='bfloat16')

        def candidate(record, first):
            return low.trajectory(low.prior(self.white) if first else record[0], self.segment)

        return self.compare(candidate)
