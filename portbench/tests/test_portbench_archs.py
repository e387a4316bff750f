r"""The arch seam (``portbench/archs``): a second score network, written into a
copy of the benchmark beside the U-Net (its arch module and its reference
module) and found by the configuration's ``arch``, drives the assim and train
cells through ``run.run_cell`` with its parameters drawn from the seed, and
comes back correct; so does the U-Net of the tests' configuration, which
names no ``weights`` file."""

import shutil
import sys

import pytest
import torch

import portbench.reference
from portbench import archs, counts, run
from portbench.tests.conftest import TINY, tiny_cell
from portbench.tests.test_portbench_run import program_imports

#: A per-pixel two-layer network, ``eps = W1 silu(W0 [x, cos pi t, sin pi t]
#: + b0) + b1`` over the channels of each pixel: its reference, the products
#: written out, and its parameters, in ``reference/pixel.py``.
PIXEL_REFERENCE = r'''
import math

import torch
import torch.nn.functional as F

from portbench.reference import unet as ref


def features(x, t):
    t = torch.as_tensor(t, device=x.device).float().broadcast_to(x.shape[:-3])
    phase = math.pi * t[..., None, None, None].expand(x.shape[:-3] + (1,) + x.shape[-2:])
    return torch.cat((x, torch.cos(phase), torch.sin(phase)), dim=-3).movedim(-3, -1)


def reference(params, config, precision='float32'):
    cast = ref.caster(precision)

    def net(x, t):
        h = F.silu(cast(features(x, t)) @ cast(params['Dense_0/kernel']) + cast(params['Dense_0/bias']))
        return (cast(h) @ cast(params['Dense_1/kernel']) + cast(params['Dense_1/bias'])).movedim(-1, -3).float()

    return net


def init_tree(config, generator):
    c, h = 2 * config['window'], config['hidden']
    tree = {}
    for name, shape in (('Dense_0', (c + 2, h)), ('Dense_1', (h, c))):
        tree[name + '/kernel'] = torch.randn(shape, generator=generator, device=generator.device) / math.sqrt(shape[0])
        tree[name + '/bias'] = 0.1 * torch.randn(shape[-1:], generator=generator, device=generator.device)
    return tree
'''

#: The arch module, ``archs/pixel.py``: the program a plain module.
PIXEL = r'''
import torch
import torch.nn.functional as F

from portbench.counts import dense_flops
from portbench.reference import pixel as ref

NAMES = {'inner.weight': 'Dense_0/kernel', 'inner.bias': 'Dense_0/bias',
         'outer.weight': 'Dense_1/kernel', 'outer.bias': 'Dense_1/bias'}

reference = ref.reference
init_tree = ref.init_tree


class Pixel(torch.nn.Module):
    def __init__(self, channels, hidden):
        super().__init__()
        self.inner = torch.nn.Linear(channels + 2, hidden)
        self.outer = torch.nn.Linear(hidden, channels)

    def forward(self, x, t, c=None):
        return self.outer(F.silu(self.inner(ref.features(x, t)))).movedim(-1, -3)


def program(config, tree, device):
    module = Pixel(2 * config['window'], config['hidden'])
    leaves = {k: torch.as_tensor(tree[v]) for k, v in NAMES.items()}
    module.load_state_dict({k: v.T if k.endswith('weight') else v for k, v in leaves.items()})
    return module.to(device)


def window_flops(config):
    c, h = 2 * config['window'], config['hidden']
    return config['size'] ** 2 * (dense_flops(c + 2, h) + dense_flops(h, c))


def names(tree):
    return dict(NAMES)
'''


def seeded_run(cell: str, config: dict, device='cpu') -> dict:
    r"""A tiny cell's run with no ``tree``: its parameters come from the seed."""

    work, _, _ = tiny_cell(cell)
    return run.run_cell(cell, 2**33 + 11, 1.0, False, torch.device(device), work=work, config=config,
                        log=lambda s: None)


def assert_correct(result):
    checks = result['checks']
    assert result['correct'] and result['attempted'] > 0, checks
    assert all(c['value'] < c['limit'] / 50 for c in checks.values()), checks  # float32 against float32


@pytest.fixture
def pixel_bench(tmp_path, monkeypatch):
    r"""The benchmark's files copied, ``archs/pixel.py`` and
    ``reference/pixel.py`` added, and the benchmark's root pointed at the copy,
    with the search paths of ``portbench.archs`` and ``portbench.reference``,
    which find ``pixel`` there."""

    root = tmp_path / 'portbench'
    shutil.copytree(run.BENCH, root, ignore=shutil.ignore_patterns('__pycache__', '.cache'))
    (root / 'reference' / 'pixel.py').write_text(PIXEL_REFERENCE)
    (root / 'archs' / 'pixel.py').write_text(PIXEL)
    monkeypatch.setattr(run, 'BENCH', root)
    for package in (archs, portbench.reference):
        monkeypatch.setattr(package, '__path__', [str(root / package.__name__.split('.')[-1])])
    yield dict(TINY, arch='pixel', hidden=8)
    for package in (archs, portbench.reference):
        sys.modules.pop(package.__name__ + '.pixel', None)
        if hasattr(package, 'pixel'):
            delattr(package, 'pixel')


@pytest.mark.parametrize('cell', ['assim64', 'train64'])
def test_a_second_arch_runs_with_parameters_from_the_seed(cell, pixel_bench):
    assert counts.window_flops(pixel_bench) == 16 * 16 * 2 * (12 * 8 + 8 * 10)
    arch = archs.of(pixel_bench)
    assert arch.reference.__module__ == arch.init_tree.__module__ == 'portbench.reference.pixel'
    assert not program_imports(run.BENCH / 'reference' / 'pixel.py')
    assert_correct(seeded_run(cell, pixel_bench))


@pytest.mark.parametrize('cell', ['assim64', 'train64'])
def test_unet_parameters_from_the_seed(cell):
    assert 'weights' not in TINY
    assert_correct(seeded_run(cell, TINY))


def test_parameters_follow_the_seed():
    device = torch.device('cpu')
    a, b, c = (run.parameters(TINY, seed, device) for seed in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k]) for k in a)


@pytest.mark.gpu
@pytest.mark.parametrize('cell', ['assim64', 'train64'])
def test_unet_parameters_from_the_seed_on_the_card(cell, cuda):
    r"""The same on the card, the parameters drawn there."""

    tree = run.parameters(TINY, 2**33 + 11, cuda)
    assert all(v.device.type == 'cuda' for v in tree.values())
    result = seeded_run(cell, TINY, cuda)
    assert result['correct'] and result['attempted'] > 0, result['checks']
