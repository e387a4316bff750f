r"""The diffusion transformer's arch (``archs/dit.py``, ``reference/dit.py``):
its FLOP count pinned to the port's at ``dit_xl2``; tiny ``dit`` assim and
train cells on the CPU, their parameters drawn from the seed, correct in
float32 and in bf16, where the control fails a limit; the tiny DiT's spans and
counters in a guided segment; the two readers of those spans on a synthetic
reading."""

import pytest
import torch

from portbench import archs, counts, run, spans
from portbench.tests import conftest
from portbench.tests.test_portbench_archs import assert_correct
from portbench.tests.test_portbench_run import program_imports
from sda_tpu_torch.nn import flops

#: The diffusion transformer at a test's size: depth 2, width 64, 4 heads of
#: 16, patch 2 (64 tokens a 16^2 window).
TINY_DIT = dict(conftest.TINY, arch='dit', depth=2, hidden_size=64, num_heads=4, patch_size=2, mlp_ratio=4.0)
#: The cells a tiny DiT runs: its own, and the training driver's.
CELLS = ['assim64_dit', 'train64']


def tiny_cell(cell: str, bf16: bool = False):
    r"""``(work, config, tree)`` of a cell cut to a test's size
    (``conftest.tiny_cell``'s traffic) with the tiny DiT and seeded
    parameters."""

    work, _, _ = conftest.tiny_cell(cell)
    config = dict(TINY_DIT, bf16=bf16)
    return work, config, archs.of(config).init_tree(config, torch.Generator().manual_seed(0))


def test_window_flops_equal_the_port():
    config = run.read_json(run.BENCH / 'configs' / 'dit_xl2.json')
    arch = {k: config[k] for k in ('patch_size', 'hidden_size', 'depth', 'mlp_ratio')}
    ours = counts.window_flops(config)
    assert ours == flops.dit_flops(11, 10, config['size'], **arch) == 1_049_161_531_392
    assert counts.guided_step_flops(config, 32, 1, 1) == flops.guided_sampler_flops(ours, 28, 1, 1, 1, 2.0)
    assert archs.of(config).attention_flops(config) == 4 * 1024**2 * 1152


def test_reference_and_parameters_live_in_the_reference_module():
    arch = archs.of(TINY_DIT)
    assert arch.reference.__module__ == arch.init_tree.__module__ == 'portbench.reference.dit'
    assert not program_imports(run.BENCH / 'reference' / 'dit.py')
    tree = arch.init_tree(TINY_DIT, torch.Generator().manual_seed(0))
    module = arch.program(TINY_DIT, tree, torch.device('cpu'))
    assert arch.names(tree) == {k: k[len('dit.'):] for k, _ in module.named_parameters()}
    assert sum(v.numel() for v in tree.values()) == sum(p.numel() for p in module.parameters())


@pytest.mark.parametrize('cell', CELLS)
def test_tiny_dit_cell_from_the_seed(cell):
    r"""No ``tree`` handed in: ``run.parameters`` draws it from the seed."""

    work, config, _ = tiny_cell(cell)
    assert_correct(run.run_cell(cell, 2**33 + 11, 0.5, False, torch.device('cpu'), work=work, config=config,
                                log=lambda s: None))


@pytest.mark.parametrize('cell', CELLS)
def test_tiny_dit_bf16_and_its_control(cell):
    r"""In bf16 the program passes the cell's limits (its rounding points are
    the reference's); the control, the reference in fp8 in its place, fails
    one."""

    work, config, tree = tiny_cell(cell, bf16=True)
    result = run.run_cell(cell, 2**33 + 5, 0.3, False, torch.device('cpu'), work=work, config=config, tree=tree,
                          log=lambda s: None, inspect=lambda driver: driver.control())
    for name, c in result['checks'].items():
        assert c['value'] <= c['limit'], (name, c)
    assert any(value > limit for _, value, limit in result['readings']), result['readings']


def test_tiny_dit_spans_and_counters():
    r"""A guided segment of the tiny DiT opens ``dit.attention`` once a block
    per forward and ``dit.adaln`` three times, and counts the windows of
    every block and attention call: samples x windows x 2 blocks per
    evaluation, 2 evaluations a step."""

    work, config, tree = tiny_cell('assim64_dit')
    driver = run.load('drivers', 'assim').Driver(config, work, 2**33 + 5, torch.device('cpu'), tree)
    reading = spans.measure(driver, 1, torch.device('cpu'))
    tr, evaluations = work['traffic'], 2 * reading['counts']
    windows = tr['samples'] * (tr['length'] - config['window'] + 1) * evaluations
    assert len(reading['spans']['windowed.kernel']) == evaluations
    assert len(reading['spans']['dit.attention']) == 2 * evaluations
    assert len(reading['spans']['dit.adaln']) == 3 * 2 * evaluations
    assert reading['counters']['dit.blocks'] == reading['counters']['dit.attention'] == 2 * windows
    assert reading['counters']['unet.windows'] == windows


def test_readers_on_a_synthetic_reading():
    r"""Two window-kernel spans launch 190 us of device work, 20 us of it in
    attention spans and 30 us in adaLN spans; the counter saw 6 windows."""

    work, config, _ = tiny_cell('assim64_dit')
    dev = [('k', 0.0, 70.0, 1.0), ('attn', 70.0, 80.0, 11.0), ('ln', 80.0, 95.0, 21.0),
           ('k', 200.0, 270.0, 101.0), ('attn', 270.0, 280.0, 111.0), ('ln', 280.0, 295.0, 121.0)]
    reading = {'dev': dev, 'matched': 1.0, 'counters': {'dit.attention': 6},
               'spans': {'windowed.kernel': [(0.0, 100.0), (100.0, 200.0)], 'dit.attention': [(10.0, 12.0), (110.0, 112.0)],
                         'dit.adaln': [(20.0, 22.0), (120.0, 122.0)]}}
    cell = {'cuda': True, 'trace': {'dev': []}, 'work': work, 'config': config, 'spans': reading,
            'peak_flops': 1e12}
    flops = 4 * 64**2 * 64 * 6
    assert archs.of(config).attention_flops(config) == 4 * 64**2 * 64
    assert run.load('metrics', 'attn_peak_pct.assim').read(cell) == pytest.approx(100 * flops / 20e-6 / 1e12)
    assert run.load('metrics', 'adaln_share_pct.assim').read(cell) == pytest.approx(100 * 30 / 190)
    unet = dict(cell, spans=dict(reading, counters={}, spans={'windowed.kernel': reading['spans']['windowed.kernel']}))
    assert run.load('metrics', 'attn_peak_pct.assim').read(unet) is None
    assert run.load('metrics', 'adaln_share_pct.assim').read(unet) is None
