r"""``python -m sda_tpu_torch.mfu_attribution`` against
``tools/mfu_attribution.py``.

The JAX tool needs the committed ``unet_0`` and a device to time, so it is
not run here; what is held is its output's keys, the analytic FLOPs of
each leg (``sda_tpu.nn.flops``), the efficiencies as its ratios of the
legs' TFLOP/s, and that a CPU run writes no device metric. The port's
tool runs on the CPU at narrow widths, on a run whose weights come from a
seeded flax initialisation through ``params_from_flax``.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from sda_tpu.nn import flops as jflops
from sda_tpu.train import save_params
from sda_tpu_torch import mfu_attribution

REPO = Path(__file__).resolve().parents[1]
NARROW = dict(window=5, embedding=8, hidden_channels=[8, 16], hidden_blocks=[1, 1], kernel_size=3,
              activation='SiLU', size=16)
LENGTH, BATCH, STEPS, CORRECTIONS = 8, 2, 2, mfu_attribution.CORRECTIONS
LEGS = ('kernel_forward', 'score_forward', 'guided_eval', 'sampler_per_eval')


def jax_tool_keys():
    r"""The keys of the JSON object the JAX tool prints (its ``out`` dict
    and the ``record`` of a leg), read from its source."""

    tree = ast.parse((REPO / 'tools/mfu_attribution.py').read_text())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)]
    keys = [{k.value for k in d.keys if isinstance(k, ast.Constant)} for d in dicts]
    out = next(k for k in keys if 'legs' in k)
    leg = next(k for k in keys if 'wall_ms' in k)
    return out, leg


@pytest.fixture(scope='module')
def attribution(tmp_path_factory):
    r"""The port's tool on a narrow run at 16^2 on the CPU, with a trace."""

    from sda_tpu_torch.experiments.kolmogorov import utils as kutils

    import importlib.util
    import sys

    sys.path.insert(0, str(REPO / 'experiments/kolmogorov'))
    saved = sys.modules.pop('utils', None)
    try:
        spec = importlib.util.spec_from_file_location('kolmogorov_utils_for_mfu', REPO / 'experiments/kolmogorov/utils.py')
        jutils = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jutils)
    finally:
        sys.path.pop(0)
        sys.modules.pop('utils', None)
        if saved is not None:
            sys.modules['utils'] = saved

    path = tmp_path_factory.mktemp('mfu')
    run = path / 'narrow'
    run.mkdir()
    (run / 'config.json').write_text(json.dumps(NARROW))
    module = jutils.make_score(**NARROW)
    params = module.init(jax.random.key(0), jnp.zeros((1, 10, 16, 16)), jnp.ones((1,)))['params']
    save_params(params, run / 'state.msgpack')
    assert kutils.load_score(run, device='cpu')[1]['size'] == 16

    out = mfu_attribution.main(['--run', str(run), '--length', str(LENGTH), '--batch', str(BATCH), '--steps',
                                str(STEPS), '--device', 'cpu', '--trace', str(path / 'trace'), '--out',
                                str(path / 'out.json')])
    return out, path


def test_keys_and_no_device_metric_on_the_cpu(attribution):
    out, path = attribution
    want, want_leg = jax_tool_keys()
    assert want <= set(out)
    assert json.loads((path / 'out.json').read_text()) == out
    assert set(out['legs']) == set(LEGS)
    for name in LEGS:
        assert want_leg <= set(out['legs'][name])
        assert out['legs'][name]['wall_ms'] > 0 and out['legs'][name]['mfu_pct'] is None
        assert out['legs'][name]['busy_pct'] is None  # the profiler saw no device
        assert list((path / 'trace' / name).glob('*.pt.trace.json'))
    assert out['peak_tflops'] is None and out['conv_ceiling_mfu_pct'] is None
    assert (out['dtype'], out['device'], out['card']) == ('f32', 'cpu', None)
    assert out['workload'] == {'windows': (LENGTH - 4) * BATCH, 'length': LENGTH, 'batch': BATCH, 'window': 5,
                               'size': 16}


def test_flops_match_jax(attribution):
    r"""Each leg's analytic FLOPs equal ``sda_tpu.nn.flops``'s for the same
    architecture and shapes."""

    legs = attribution[0]['legs']
    arch = {k: NARROW[k] for k in ('embedding', 'hidden_channels', 'hidden_blocks', 'kernel_size', 'size')}
    window = jflops.score_unet_flops(channels=10, context_channels=1, **arch)
    forward = window * (LENGTH - 4) * BATCH
    evals = STEPS * (1 + CORRECTIONS)
    assert legs['kernel_forward']['flops'] == forward
    assert legs['score_forward']['flops'] == forward
    assert legs['guided_eval']['flops'] == 2.0 * forward
    assert legs['sampler_per_eval']['flops'] == \
        jflops.guided_sampler_flops(window, LENGTH - 4, BATCH, STEPS, CORRECTIONS) / evals


def test_efficiencies_are_ratios_of_the_legs(attribution):
    out = attribution[0]
    k, s, g, f = (out['legs'][n]['tflops'] for n in LEGS)
    for name, leg in out['legs'].items():
        assert leg['tflops'] == pytest.approx(leg['flops'] / leg['wall_ms'] / 1e9, rel=1e-12)
    assert out['windowing_efficiency'] == pytest.approx(s / k, rel=1e-12)
    assert out['vjp_efficiency'] == pytest.approx(g / s, rel=1e-12)
    assert out['sampler_body_efficiency'] == pytest.approx(f / g, rel=1e-12)


def test_peak_table():
    r"""The peak is the card's, by name and dtype; a card the table does not
    know raises, and the CPU has none."""

    import torch

    assert mfu_attribution.PEAK_TFLOPS['NVIDIA H100 80GB HBM3'] == {'bf16': 989.0, 'tf32': 495.0, 'f32': 67.0}
    assert mfu_attribution.peak_tflops(torch.device('cpu'), 'bf16') is None
    assert mfu_attribution.compute_dtype({'bf16': True}, torch.device('cpu')) == 'bf16'
    assert mfu_attribution.compute_dtype({}, torch.device('cpu')) == 'f32'


class _Event:
    def __init__(self, start_us, end_us, device='CUDA', annotation=False):
        self.start, self.end = int(start_us * 1e3), int(end_us * 1e3)
        self.device, self.annotation = device, annotation

    def device_type(self):
        import torch

        return getattr(torch.autograd.DeviceType, self.device)

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start


def test_busy_share_counts_overlapping_kernels_once():
    r"""Two kernels overlapping by 5 of their 10 us each, a third alone, a
    user annotation over all of them and a host operation: 20 us busy over a
    wall of 40 us."""

    from types import SimpleNamespace

    events = [_Event(10, 20), _Event(15, 25), _Event(30, 35), _Event(0, 40, annotation=True), _Event(0, 40, 'CPU')]
    profiler = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    assert mfu_attribution.busy_share(profiler, 40e-6) == pytest.approx(0.5)
    assert mfu_attribution.busy_share(profiler, 40e-6) != pytest.approx(sum(e.end - e.start for e in events[:3]) / 40e3)
    no_device = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events[3:])))
    assert mfu_attribution.busy_share(no_device, 40e-6) is None
