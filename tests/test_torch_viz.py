r"""The port's rendering (``sda_tpu_torch.viz``) against the JAX package's
(``sda_tpu.viz``, seaborn + PIL).

The colours, montages and stacks must be bitwise equal; the port's PNG and
GIF files, decoded by PIL here, must give back the exact arrays. The port
needs neither PIL, seaborn nor matplotlib, which one test hides.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import sda_tpu.viz as jviz
from sda_tpu_torch import viz

REPO = Path(__file__).resolve().parents[1]


def field(seed, shape, dtype=np.float32, scale=1.5):
    r"""Normal values of ``scale`` with the edges planted: values beyond
    the default range, exactly at it, and zero."""

    w = (np.random.RandomState(seed).standard_normal(shape) * scale).astype(dtype)
    edges = np.array([-1.25, 1.25, -4.0, 4.0, 0.0, 1.2499, -1.2501], dtype)
    w.flat[:len(edges)] = edges[:w.size]
    return w


def test_table_is_seaborns_and_never_wraps():
    import seaborn

    cmap = seaborn.cm.icefire
    np.testing.assert_array_equal(viz.ICEFIRE, np.asarray(cmap.colors, np.float64))
    assert viz.ICEFIRE.max() < 1.0  # 256 * lut stays below 256: the uint8 cast cannot wrap
    np.testing.assert_array_equal(viz.PALETTE[:256], (256 * np.asarray(cmap.colors)).astype(np.uint8))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('shape', [(16, 16), (3, 17, 19), (2, 3, 8, 8)])
def test_vorticity2rgb_bitwise(dtype, shape):
    w = field(0, shape, dtype)
    got = viz.vorticity2rgb(w)
    assert got.dtype == np.uint8 and got.shape == shape + (3,)
    np.testing.assert_array_equal(got, jviz.vorticity2rgb(w))


@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(0, 2**16),
    low=st.floats(-3.0, 0.5),
    width=st.floats(0.01, 4.0),
    scale=st.floats(0.1, 5.0),
    double=st.booleans(),
)
def test_vorticity2rgb_custom_range(seed, low, width, scale, double):
    r"""Custom ``vmin``/``vmax`` with values beyond them and exactly at
    them, in both dtypes."""

    dtype = np.float64 if double else np.float32
    w = field(seed, (5, 7), dtype, scale)
    w.flat[-2:] = [low, low + width]
    kwargs = dict(vmin=low, vmax=low + width)
    np.testing.assert_array_equal(viz.vorticity2rgb(w, **kwargs), jviz.vorticity2rgb(w, **kwargs))


def test_nan_takes_the_bad_colour():
    w = np.array([np.nan, 0.0], np.float32)
    np.testing.assert_array_equal(viz.vorticity2rgb(w), jviz.vorticity2rgb(w))
    assert viz.vorticity2rgb(w)[0].tolist() == [0, 0, 0]


@pytest.mark.parametrize('shape, kwargs', [
    ((16, 16), {}),
    ((3, 12, 10), dict(zoom=2)),
    ((2, 3, 8, 8), dict(pad=2, vmin=-0.5, vmax=2.0)),
    ((2, 3, 8, 8), dict(mask=True)),
    ((2, 3, 8, 8), dict(mask='broadcast', zoom=3)),
])
def test_draw_bitwise(shape, kwargs, tmp_path):
    w = field(1, shape)
    if kwargs.get('mask') is True:
        kwargs['mask'] = np.random.RandomState(2).rand(*shape) > 0.5
    elif kwargs.get('mask') == 'broadcast':
        kwargs['mask'] = np.random.RandomState(3).rand(*shape[-2:]) > 0.3

    got, want = viz.draw(w, **kwargs), jviz.draw(w, **kwargs)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.size == want.size

    got.save(tmp_path / 'draw.png')
    with Image.open(tmp_path / 'draw.png') as png:
        assert png.mode == 'RGB'
        np.testing.assert_array_equal(np.asarray(png), np.asarray(want))


def test_draw_refuses_five_axes_as_jax_does():
    w = field(4, (2, 2, 2, 4, 4))
    with pytest.raises(ValueError):
        jviz.draw(w)
    with pytest.raises(ValueError):
        viz.draw(w)


@pytest.mark.parametrize('kwargs', [{}, dict(mirror=True), dict(zoom=3, mirror=True), dict(offset=2, border=2)])
def test_sandwich_bitwise(kwargs, tmp_path):
    w = field(5, (4, 10, 12), np.float64)
    got, want = viz.sandwich(w, **kwargs), jviz.sandwich(w, **kwargs)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.size == want.size

    got.save(tmp_path / 'sandwich.png')
    with Image.open(tmp_path / 'sandwich.png') as png:
        np.testing.assert_array_equal(np.asarray(png), np.asarray(want))


@pytest.mark.parametrize('frames, size, zoom, dt', [(3, 16, 1, 0.2), (5, 64, 2, 0.05), (2, 90, 1, 1.0)])
def test_gif_holds_the_exact_frames(frames, size, zoom, dt, tmp_path):
    r"""Every frame decodes to ``vorticity2rgb`` of that frame, zoomed (the
    larger sizes fill the LZW table and clear it); the frame count,
    ``duration`` and ``loop`` are those of the JAX function's file."""

    w = field(6, (frames, size, size))
    viz.save_gif(w, tmp_path / 'port.gif', dt=dt, zoom=zoom)
    jviz.save_gif(w, tmp_path / 'jax.gif', dt=dt, zoom=zoom)

    with Image.open(tmp_path / 'port.gif') as got, Image.open(tmp_path / 'jax.gif') as want:
        assert got.n_frames == want.n_frames == frames
        for i in range(frames):
            got.seek(i)
            want.seek(i)
            assert got.info['duration'] == want.info['duration']
            assert got.info['loop'] == want.info['loop'] == 0
            expected = viz.vorticity2rgb(w[i]).repeat(zoom, axis=0).repeat(zoom, axis=1)
            np.testing.assert_array_equal(np.asarray(got.convert('RGB')), expected)


def test_gif_refuses_nan(tmp_path):
    w = field(7, (2, 8, 8))
    w[1, 3, 3] = np.nan
    with pytest.raises(ValueError, match='NaN'):
        viz.save_gif(w, tmp_path / 'nan.gif')


def test_sizes_as_the_jax_pack_tests_them():
    r"""The assertions of ``tests/test_experiments.py``'s viz test, on the
    port's objects through the pack's re-exports."""

    from sda_tpu_torch.experiments.kolmogorov import utils as kolmogorov_utils
    from sda_tpu_torch.experiments.qg import utils as qg_utils

    for utils in (kolmogorov_utils, qg_utils):
        rgb = utils.vorticity2rgb(np.random.randn(4, 16, 16))
        assert rgb.shape == (4, 16, 16, 3)
        assert rgb.dtype == np.uint8

        img = utils.draw(np.random.randn(2, 3, 16, 16))
        assert img.size == (3 * 20 + 4, 2 * 20 + 4)

        img = utils.sandwich(np.random.randn(3, 16, 16))
        assert img.size == (16 + 2 * 5, 16 + 2 * 5)


def test_new_modules_need_no_pil_seaborn_or_matplotlib(tmp_path):
    r"""With PIL, seaborn and matplotlib hidden, the new modules import and
    the renderers write their files; the port's matplotlib figures report
    themselves skipped."""

    code = f'''
import sys
for name in ('PIL', 'seaborn', 'matplotlib'):
    sys.modules[name] = None
import importlib
import numpy as np
for m in ('viz', 'entry', 'nn.flops', 'experiments.kolmogorov.figures', 'experiments.kolmogorov.sweep_methods',
          'experiments.kolmogorov.sweep_guidance', 'experiments.kolmogorov.sweep_solver',
          'experiments.kolmogorov.hbm_probe', 'experiments.lorenz.figures', 'experiments.lorenz.sweep_solver'):
    importlib.import_module('sda_tpu_torch.' + m)
from sda_tpu_torch import viz
w = np.random.RandomState(0).randn(3, 8, 8)
viz.draw(w).save({str(tmp_path / 'a.png')!r})
viz.sandwich(w).save({str(tmp_path / 'b.png')!r})
viz.save_gif(w, {str(tmp_path / 'c.gif')!r})
from sda_tpu_torch.experiments.lorenz import figures
figures.main(['global_0'])
'''
    done = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, SCRATCH=str(tmp_path)))
    assert done.returncode == 0, done.stderr[-3000:]
    assert "figure skipped: import of matplotlib halted" in done.stdout, done.stdout
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_file()) == ['a.png', 'b.png', 'c.gif']
