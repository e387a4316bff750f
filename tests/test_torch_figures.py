r"""The port's figure scripts, its rendering command lines and ``entry()``,
against the JAX package's.

- Lorenz ``figures.py`` prints the JAX script's bytes on the committed
  ``stats_lo.csv`` and ``stats_hi.csv``;
- Kolmogorov ``figures.py`` writes the JAX script's files, its PNGs the
  JAX script's pixels, its GIFs the exact frames;
- ``assimilate(render=True)`` of both packs writes the rendering of the
  samples it returns;
- ``entry()`` with the JAX function's weights carried over gives the JAX
  function's output.
"""

import contextlib
import importlib.util
import io
import json
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from sda_tpu.train import save_h5
from sda_tpu_torch.dynamics import vorticity
from sda_tpu_torch.experiments.kolmogorov import assimilate as kolmogorov_assimilate
from sda_tpu_torch.experiments.kolmogorov import figures as kolmogorov_figures
from sda_tpu_torch.experiments.lorenz import utils as lorenz_utils
from sda_tpu_torch.experiments.qg import assimilate as qg_assimilate
from sda_tpu_torch.train import params_from_flax, save_params
from sda_tpu_torch.viz import draw, vorticity2rgb

REPO = Path(__file__).resolve().parents[1]
NARROW = dict(window=5, embedding=8, hidden_channels=[8, 16], hidden_blocks=[1, 1], activation='SiLU', size=16)


def png(file):
    with Image.open(file) as image:
        assert image.mode == 'RGB'
        return np.asarray(image)


def run_script(run, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run(*args, run_name='__main__')
    return out.getvalue()


def test_lorenz_figures_print_the_jax_bytes(tmp_path, monkeypatch):
    r"""Both scripts at their defaults on copies of the committed CSVs, in
    one storage: the same standard output, byte for byte (the figure's
    path included)."""

    storage = tmp_path / 'sda_tpu/lorenz'
    (storage / 'results').mkdir(parents=True)
    for freq in ('lo', 'hi'):
        shutil.copy(REPO / f'experiments/lorenz/storage/results/stats_{freq}.csv', storage / 'results')
    monkeypatch.setenv('SCRATCH', str(tmp_path))
    monkeypatch.setattr(sys, 'argv', ['figures.py'])

    pack = str(REPO / 'experiments/lorenz')
    saved = sys.modules.pop('utils', None)
    monkeypatch.syspath_prepend(pack)
    try:
        want = run_script(runpy.run_path, f'{pack}/figures.py')
    finally:
        sys.modules.pop('utils', None)
        if saved is not None:
            sys.modules['utils'] = saved

    monkeypatch.setattr(lorenz_utils, 'PATH', storage)
    got = run_script(runpy.run_module, 'sda_tpu_torch.experiments.lorenz.figures')

    assert '### seed spread' in want and f'figure -> {storage}/results/statistics.png' in want
    assert got == want


def test_kolmogorov_figures_match_jax(tmp_path, monkeypatch):
    r"""A test set of 17 trajectories at 16^2 and one stored posterior:
    the same file names; every PNG equal to the JAX script's; each GIF's
    frames the exact icefire rendering of the posterior's vorticity, as
    many as the JAX script's GIF holds."""

    spec = importlib.util.spec_from_file_location('kolmogorov_figures_for_torch',
                                                  REPO / 'experiments/kolmogorov/figures.py')
    saved = sys.modules.pop('utils', None)
    sys.path.insert(0, str(REPO / 'experiments/kolmogorov'))
    try:
        jfigures = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jfigures)
    finally:
        sys.path.pop(0)
        sys.modules.pop('utils', None)
        if saved is not None:
            sys.modules['utils'] = saved

    rng = np.random.RandomState(0)
    xs = rng.standard_normal((2, 8, 2, 16, 16)).astype(np.float32)
    x_test = rng.standard_normal((17, 9, 2, 16, 16)).astype(np.float32)
    for name in ('jax', 'torch'):
        save_h5(tmp_path / name / 'data/test.h5', x_test)
        (tmp_path / name / 'results').mkdir()
        np.savez_compressed(tmp_path / name / 'results/samples_coarse_narrow.npz', xs=xs, x_star=xs[1])

    monkeypatch.setattr(jfigures, 'PATH', tmp_path / 'jax')
    jfigures.sandwich_figures()
    jfigures.assimilation_figures()
    kolmogorov_figures.sandwich_figures(path=tmp_path / 'torch')
    kolmogorov_figures.assimilation_figures(path=tmp_path / 'torch')

    files = sorted(p.name for p in (tmp_path / 'jax/results').iterdir())
    assert files == sorted(p.name for p in (tmp_path / 'torch/results').iterdir())
    assert len(files) == 7
    for name in files:
        if name.endswith('.png'):
            np.testing.assert_array_equal(png(tmp_path / 'torch/results' / name), png(tmp_path / 'jax/results' / name))

    frames = vorticity(torch.from_numpy(xs[0])).numpy()
    with Image.open(tmp_path / 'torch/results/assim_coarse_narrow.gif') as got, \
            Image.open(tmp_path / 'jax/results/assim_coarse_narrow.gif') as want:
        assert got.n_frames == want.n_frames == 8
        for i in range(8):
            got.seek(i)
            np.testing.assert_array_equal(np.asarray(got.convert('RGB')),
                                          vorticity2rgb(frames[i]).repeat(2, axis=0).repeat(2, axis=1))


def narrow_storage(path, make_score, init):
    r"""A storage with a narrow run ``narrow`` (the port's fresh weights,
    written as flax's msgpack) and a test set of 2 trajectories at 16^2."""

    (path / 'runs/narrow').mkdir(parents=True)
    (path / 'runs/narrow/config.json').write_text(json.dumps(NARROW))
    save_params(init(make_score(**NARROW), torch.Generator().manual_seed(0)), path / 'runs/narrow/state.msgpack')
    save_h5(path / 'data/test.h5', np.random.RandomState(2).standard_normal((2, 16, 2, 16, 16)).astype(np.float32))


def test_kolmogorov_assimilate_renders(tmp_path):
    r"""``main`` renders the posterior's vorticity, every 2nd frame of the
    ``coarse`` scenario's 16, to ``results/coarse_narrow.png``; ``render``
    is its default, as in the JAX pack."""

    from sda_tpu_torch.experiments.kolmogorov.utils import make_score
    from sda_tpu_torch.nn import reset_parameters

    narrow_storage(tmp_path, make_score, reset_parameters)
    residual, std, xs = kolmogorov_assimilate.main('narrow', 'coarse', samples=2, steps=2, corrections=0,
                                                   path=tmp_path, device='cpu')
    assert xs.shape == (2, 16, 2, 16, 16)
    want = np.asarray(draw(vorticity(xs[:, ::2]).numpy()))
    assert want.shape == (2 * 20 + 4, 8 * 20 + 4, 3)
    np.testing.assert_array_equal(png(tmp_path / 'results/coarse_narrow.png'), want)


def test_qg_assimilate_renders(tmp_path, monkeypatch):
    r"""``main`` renders the first sample's two layers, every 2nd frame of
    ``upper``'s 16, on the symmetric scale of their largest value, to
    ``results/upper_narrow.png``."""

    from sda_tpu_torch.experiments.qg.utils import init_score, make_score

    narrow_storage(tmp_path, make_score, init_score)
    monkeypatch.setattr(qg_assimilate, 'PATH', tmp_path)
    got = {}
    real = qg_assimilate.assimilate

    def keep(*args, **kwargs):
        got['xs'], residual, rmse = real(*args, **kwargs)
        return got['xs'], residual, rmse

    monkeypatch.setattr(qg_assimilate, 'assimilate', keep)
    qg_assimilate.main('narrow', 'upper', samples=2, steps=2, corrections=0, device='cpu')

    w = got['xs'][0, ::2].numpy()
    scale = float(np.abs(w).max())
    want = np.asarray(draw(np.swapaxes(w, 0, 1), vmin=-scale, vmax=scale))
    assert want.shape == (2 * 20 + 4, 8 * 20 + 4, 3)
    np.testing.assert_array_equal(png(tmp_path / 'results/upper_narrow.png'), want)


def test_entry_matches_jax():
    r"""``entry(device='cpu')`` with ``__graft_entry__.entry()``'s flax
    parameters carried over: the same output at rtol 1e-4, atol 1e-5
    (float32), on the same input."""

    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.pop(0)
    from sda_tpu_torch.entry import entry

    jfn, (jx, jt) = graft.entry()
    want = np.asarray(jfn(jx, jt))
    params = dict(zip(jfn.__code__.co_freevars, (c.cell_contents for c in jfn.__closure__)))['params']

    fn, (x, t) = entry(device='cpu')
    assert tuple(x.shape) == (2, 10, 64, 64) and torch.all(x == 0) and torch.all(t == 0.5)
    fn.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = fn(x, t).numpy()

    assert got.shape == (2, 10, 64, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
