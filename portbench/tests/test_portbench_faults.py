r"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: a step that returns its state unchanged;
half of the batch left out (training's loss the mean over the rest, the
solver's fields copied from the rest, the sampler's rest returned as it came
in: at these sizes a random network's states grow with ``1 / mu(t)`` and a
copied sample would differ from its own by its noise alone); an answer
altered where it is produced. Besides, faults that spare what a warm-up or
a segment's first step would show: a sampler or a solver broken only in the
segments after the first or only after each segment's first step, a
trainer broken only after its warm-up. The cells run on one chip, so none
can leave out an exchange between chips. Tiny cells on the CPU, in float32,
against the cells' own limits; the same run unbroken is correct."""

import pytest
import torch

from sda_tpu_torch.diffusion.sde import VPSDE
from sda_tpu_torch.dynamics import KolmogorovFlow
from sda_tpu_torch.train import Trainer

from portbench import run
from portbench.tests.conftest import run_tiny


def sampler_fault(fault):
    sample = VPSDE.sample

    def broken(self, shape=(), **kw):
        x = kw['init']
        i0, i1 = kw['segment']
        if fault == 'unchanged':
            return x.clone()
        if fault == 'half_batch':  # the rest returned as it came in
            n = x.shape[0] // 2
            noise = kw['noise']
            out = sample(self, (n,), **dict(kw, init=x[:n], noise=lambda i, j: noise(i, j)[:n]))
            return torch.cat([out, x[n:]])
        if fault == 'later_segments':
            return sample(self, shape, **kw) if i0 == 0 else x.clone()
        if fault == 'later_steps':
            return sample(self, shape, **dict(kw, segment=(i0, i0 + 1)))
        out = sample(self, shape, **kw)
        out[0] *= 1.05
        return out

    return broken


def trainer_fault(fault):
    train_step = Trainer.train_step
    step = torch.optim.AdamW.step

    def unchanged(self, closure=None):
        saved = [p.detach().clone() for group in self.param_groups for p in group['params']]
        step(self, closure)
        with torch.no_grad():
            for p, s in zip((p for group in self.param_groups for p in group['params']), saved):
                p.copy_(s)

    def half_batch(self, x, t=None, z=None):
        n = x.shape[0] // 2
        return train_step(self, x[:n], t[:n], z[:n])

    def altered(self, closure=None):
        params = [p for group in self.param_groups for p in group['params'] if p.grad is not None]
        top = max(params, key=lambda p: float(p.grad.norm()))
        top.grad.mul_(2)
        step(self, closure)

    calls = [0]

    def after_warmup(self, closure=None):
        calls[0] += 1
        return step(self, closure) if calls[0] <= WARMUP else unchanged(self, closure)

    return {'unchanged': (torch.optim.AdamW, 'step', unchanged),
            'half_batch': (Trainer, 'train_step', half_batch),
            'altered': (torch.optim.AdamW, 'step', altered),
            'after_warmup': (torch.optim.AdamW, 'step', after_warmup)}[fault]


def solver_fault(fault):
    trajectory = KolmogorovFlow.trajectory
    calls = [0]

    def broken(self, x, length, **kw):
        calls[0] += 1
        if fault == 'later_segments':  # sound in the warm-up and the window's first segment
            return trajectory(self, x, length, **kw) if calls[0] <= 2 else x.expand((length,) + x.shape).clone()
        if fault == 'unchanged':
            return x.expand((length,) + x.shape).clone()
        if fault == 'half_batch':
            out = trajectory(self, x[:x.shape[0] // 2], length, **kw)
            return torch.cat([out, out], dim=1)
        out = trajectory(self, x, length, **kw)
        out[:, 0] += 0.1
        return out

    return broken


FAULTS = ('unchanged', 'half_batch', 'altered')
WARMUP = run.read_json(run.BENCH / 'workloads' / 'train64.json')['traffic']['warmup_steps']


@pytest.mark.parametrize('cell', ['assim64', 'assim256', 'train64', 'datagen256'])
def test_sound_run_is_correct(cell):
    assert run_tiny(cell)['correct']


class Clock:
    r"""``run``'s clock, moved on 50 ms at each reading, so that a window of a
    second holds the same units however fast the machine is."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 0.05
        return self.now


@pytest.mark.parametrize('fault', FAULTS + ('later_segments', 'later_steps'))
@pytest.mark.parametrize('cell', ['assim64', 'assim256'])
def test_assim_faults(cell, fault, monkeypatch):
    r"""``later_segments`` shows in a run whose grid holds more segments than
    the window runs, as at the cells' own sizes, so the window's last
    segment starts past the grid's first step. On the real clock a broken
    segment returns at once, the window runs into later grids, and the draw
    could land on a grid's first, sound, segment; the window's units are
    fixed here instead."""

    monkeypatch.setattr(VPSDE, 'sample', sampler_fault(fault))
    monkeypatch.setattr(run, 'time', Clock())
    result = run_tiny(cell, seconds=1.0, steps=64)
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('fault', FAULTS + ('after_warmup',))
def test_train_faults(fault, monkeypatch):
    monkeypatch.setattr(*trainer_fault(fault))
    result = run_tiny('train64')
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('fault', FAULTS + ('later_segments',))
def test_solver_faults(fault, monkeypatch):
    monkeypatch.setattr(KolmogorovFlow, 'trajectory', solver_fault(fault))
    result = run_tiny('datagen256')
    assert not result['correct'], result['checks']
