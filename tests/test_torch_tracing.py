r"""``sda_tpu_torch.tracing``: spans off by default and free of the profiler
when off, turned on by ``enable`` and ``profile_trace``, nested where the
work happens under the profiler; the ``unet.windows`` counter against its
formula; the DFT launch counts read from the registry. Tiny and on the CPU."""

import json
import math

import pytest
import torch
import torch.nn as nn

from sda_tpu_torch import tracing
from sda_tpu_torch.diffusion import VPSDE, GaussianScore, MCScoreNet
from sda_tpu_torch.dynamics import KolmogorovFlow
from sda_tpu_torch.ops import dft_kernels
from sda_tpu_torch.train import TrajectoryDataset, Trainer
from sda_tpu_torch.utils import profile_trace

LENGTH, BATCH, CHANNELS, SIZE, ORDER = 9, 2, 2, 4, 2  # 5 windows of 5 frames


class Kernel(nn.Module):
    r"""A window eps ``(B, W, 5 C, H, W) -> same`` of one weight."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x, t, c=None):
        return torch.tanh(self.w * x)


def guided(chunk=None, remat=False):
    score = MCScoreNet(Kernel(), ORDER, chunk=chunk)
    y = torch.randn(BATCH, LENGTH, CHANNELS, SIZE, SIZE, generator=torch.Generator().manual_seed(1))
    return GaussianScore(y=y, A=lambda x: x, std=0.1, sde=VPSDE(eps=score, shape=()), remat=remat)


def evaluate(score):
    x = torch.randn(BATCH, LENGTH, CHANNELS, SIZE, SIZE, generator=torch.Generator().manual_seed(2))
    return score(x, torch.tensor(0.5))


def training_step():
    sde = VPSDE(shape=(10,))
    data = torch.randn(6, 8, 2, generator=torch.Generator().manual_seed(3))
    dataset = TrajectoryDataset(data, window=5, flatten=True, device='cpu')
    module = nn.Sequential(nn.Linear(10, 10))
    eps = lambda x, t, c=None: module(x)  # noqa: E731
    trainer = Trainer(sde, module, dataset, dataset, batch_size=3, eps_wrapper=lambda m: eps)
    return trainer.train_step(dataset.crop(dataset.data[:3], starts=torch.zeros(3, dtype=torch.long)))


def test_off_by_default_and_free_of_the_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) called')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert not tracing.enabled()
    assert torch.isfinite(evaluate(guided(chunk=2, remat=True))).all()
    assert torch.isfinite(evaluate(guided())).all()
    assert torch.isfinite(training_step())
    chain = KolmogorovFlow(size=16, dt=0.2, device='cpu')
    w, _ = chain.to_spectral(chain.prior((1,), generator=torch.Generator().manual_seed(4)))
    assert all(torch.isfinite(part).all() for part in chain.substep(w))
    with tracing.enable():
        with pytest.raises(AssertionError, match='guidance.forward'):
            evaluate(guided())


def test_enable_restores_and_profile_trace_turns_on(tmp_path):
    with tracing.enable():
        assert tracing.enabled()
        with tracing.enable():
            assert tracing.enabled()
        assert tracing.enabled()
    assert not tracing.enabled()
    with pytest.raises(ZeroDivisionError):
        with tracing.enable():
            1 / 0
    assert not tracing.enabled()

    with profile_trace(tmp_path / 'trace'):
        assert tracing.enabled()
        evaluate(guided())
    assert not tracing.enabled()
    (path,) = (tmp_path / 'trace').glob('*.pt.trace.json')
    names = {e.get('name') for e in json.loads(path.read_text())['traceEvents']}
    assert {'guidance.forward', 'guidance.vjp', 'windowed.kernel'} <= names
    with pytest.raises(ZeroDivisionError):
        with profile_trace(tmp_path / 'again'):
            1 / 0
    assert not tracing.enabled()


def annotations(fn):
    r"""``{name: [(start, end), ...]}`` of the user annotations ``fn`` makes
    under the profiler."""

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def inside(spans, outer):
    return [s for s in spans if any(a <= s[0] and s[1] <= b for a, b in outer)]


def test_spans_nest_where_the_work_happens():
    r"""Chunks of 2 over 5 windows with remat: three kernel spans inside the
    forward, their three recomputes inside the VJP; a training step's three
    phases; a substep."""

    with tracing.enable():
        spans = annotations(lambda: evaluate(guided(chunk=2, remat=True)))
    forward, vjp, kernel = spans['guidance.forward'], spans['guidance.vjp'], spans['windowed.kernel']
    assert len(forward) == len(vjp) == 1 and len(kernel) == 6
    assert len(inside(kernel, forward)) == 3 and len(inside(kernel, vjp)) == 3
    assert forward[0][1] <= vjp[0][0]

    with tracing.enable():
        spans = annotations(training_step)
    phases = [spans[f'train.{p}'] for p in ('forward', 'backward', 'optimizer')]
    assert [len(p) for p in phases] == [1, 1, 1]
    assert phases[0][0][1] <= phases[1][0][0] <= phases[1][0][1] <= phases[2][0][0]

    chain = KolmogorovFlow(size=16, dt=0.2, device='cpu')
    x = chain.prior((1,), generator=torch.Generator().manual_seed(4))
    with tracing.enable():
        spans = annotations(lambda: chain.transition(x))
    assert len(spans['kolmogorov.substep']) == chain.steps
    assert annotations(lambda: chain.transition(x)) == {}


@pytest.mark.parametrize('chunk, remat', [(None, False), (None, True), (2, False), (2, True), (3, True), (8, True)])
def test_window_counter(chunk, remat):
    windows = LENGTH - 2 * ORDER
    c = windows if chunk is None else min(chunk, windows)
    tracing.counters['unet.windows'] = 0
    evaluate(guided(chunk, remat))
    assert tracing.counters['unet.windows'] == BATCH * math.ceil(windows / c) * c * (2 if remat else 1)


def test_dft_launches_read_the_registry():
    dft_kernels.reset_launches()
    assert dft_kernels.launches == {'rfft2': 0, 'irfft2': 0}
    tracing.counters['dft.rfft2'] += 1
    tracing.counters['dft.irfft2'] += 2
    assert dict(dft_kernels.launches) == {'rfft2': 1, 'irfft2': 2} == {
        k[4:]: v for k, v in tracing.counters.items() if k.startswith('dft.')}
    assert repr(dft_kernels.launches) == "{'rfft2': 1, 'irfft2': 2}"
    dft_kernels.reset_launches()
    assert tracing.counters['dft.rfft2'] == tracing.counters['dft.irfft2'] == 0
