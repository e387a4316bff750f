r"""The frozen arithmetic of ``portbench.counts`` equals the port's own
functions today, at ``unet_0``'s and ``unet256_0``'s widths."""

import json
import math

import pytest

from portbench import counts, run
from sda_tpu_torch.nn import flops

CONFIGS = {name: run.read_json(run.BENCH / 'configs' / f'{name}.json') for name in ('unet_0', 'kolmogorov256')}


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_window_flops_equal_the_port(name):
    config = CONFIGS[name]
    arch = {k: config[k] for k in ('embedding', 'hidden_channels', 'hidden_blocks', 'kernel_size', 'size')}
    ours = counts.window_flops(config)
    assert ours == flops.score_unet_flops(channels=10, context_channels=1, **arch)
    assert ours == {'unet_0': 28_007_768_064, 'kolmogorov256': 448_115_810_304}[name]


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_step_flops_equal_the_port(name):
    config = CONFIGS[name]
    window = counts.window_flops(config)
    assert counts.guided_step_flops(config, 32, 4, 1) == flops.guided_sampler_flops(window, 28, 4, 1, 1, 2.0)
    assert counts.train_step_flops(config, 32) == 3.0 * window * 32


def test_dft_bound_equals_the_smoke():
    import chip_smoke

    for n in (1, 16, 32, 64, 112):
        for shape in ((256, 256, 171, 86), (128, 128, 85, 43), (64, 64, 64, 33)):
            assert counts.dft_bound_ms(n, *shape) == chip_smoke.dft_bound_ms(n, *shape)
    assert counts.PEAK_FLOPS == {'bfloat16': 989e12, 'float32': 67e12} and counts.PEAK_BYTES == 3.35e12
    assert chip_smoke.PEAK_F32 == counts.PEAK_FLOPS['float32'] and chip_smoke.PEAK_BYTES == counts.PEAK_BYTES


def test_solver_counts_match_the_solver():
    import torch

    from sda_tpu_torch.dynamics import KolmogorovFlow
    from sda_tpu_torch.ops import dft_kernels

    config = CONFIGS['kolmogorov256']
    assert counts.kolmogorov_substeps(256, 0.2) == 82
    assert counts.spectral_shape(config) == (171, 86)
    chain = KolmogorovFlow(size=32, dt=0.2, device='cpu', dft_method='kernel')
    small = dict(config, size=32)
    assert counts.kolmogorov_substeps(32, 0.2) == chain.steps
    calls = {'rfft2': {}, 'irfft2': {}}
    plain = {'rfft2': dft_kernels.rfft2, 'irfft2': dft_kernels.irfft2}

    def counting(kind):
        def fn(*args):
            n = args[0].shape[0]
            calls[kind][n] = calls[kind].get(n, 0) + 1
            return plain[kind](*args)
        return fn

    x = torch.randn(3, 2, 32, 32)
    try:
        dft_kernels.rfft2, dft_kernels.irfft2 = counting('rfft2'), counting('irfft2')
        chain.trajectory(x, length=2)
    finally:
        dft_kernels.rfft2, dft_kernels.irfft2 = plain['rfft2'], plain['irfft2']
    assert calls == counts.solver_transforms(small, 3, 2)
    fields = sum(n * c for kind in calls for n, c in calls[kind].items())
    fft = 2.5 * 32 * 32 * math.log2(32 * 32)
    assert counts.solver_flops(small, 3, 2) > fields * fft
