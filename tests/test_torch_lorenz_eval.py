r"""The port's Lorenz evaluation against the JAX package, on the CPU: the
frozen observations (bit for bit against the committed ``obs.h5``), the
small input file the card reads in place of the HDF5 files, ``evaluate`` on
index 0 (the ground-truth row from the same particle-filter samples, the
guided rows through JAX's draws), its CSV and its skipping of rows already
written, and the multimodal demo.

The JAX samplers run compiled, with ``VPSDE.sigma`` written
``sqrt((1 - alpha)(1 + alpha) + eta^2)`` here in the test: XLA evaluates the
package's form at ``t = 0`` as 9.766e-4 instead of 1.000e-3 (``ROADMAP.md``,
faults, item 1).
"""

import contextlib
import functools
import importlib.util
import io
import re
import shutil
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.diffusion import VPSDE as JVPSDE
from sda_tpu_torch.experiments.lorenz import eval as leval
from sda_tpu_torch.experiments.lorenz import multimodal

REPO = Path(__file__).resolve().parents[1]
PACK = REPO / 'experiments/lorenz'
STORAGE = PACK / 'storage'
INPUTS = REPO / 'tests/golden/lorenz_eval_inputs.npz'


class JStableVPSDE(JVPSDE):
    def sigma(self, t):
        a = self.alpha(t)
        return jnp.sqrt((1 - a) * (1 + a) + self.eta**2)


def load_pack(name):
    r"""A module of the JAX Lorenz pack, loaded by path under a name of its
    own (every pack calls its helpers ``utils``)."""

    saved = sys.modules.pop('utils', None)
    sys.path.insert(0, str(PACK))
    try:
        spec = importlib.util.spec_from_file_location(f'lorenz_{name}_for_torch', PACK / f'{name}.py')
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
        sys.modules.pop('utils', None)
        if saved is not None:
            sys.modules['utils'] = saved
    return module


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def jax_noise(key, shape):
    k_init, k_scan = jax.random.split(key)

    def noise(i, j):
        return t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(k_scan, i), j), shape))

    return t(jax.random.normal(k_init, shape)), noise


def test_inputs_equal_their_sources():
    r"""``tests/golden/lorenz_eval_inputs.npz`` holds ``obs.h5``'s ``lo[0]``
    and ``hi[0]`` and ``test.h5``'s ``x[0, :65]``, bit for bit. It was
    written with ``numpy.savez`` from those slices."""

    inputs = np.load(INPUTS)
    with h5py.File(STORAGE / 'results/obs.h5') as f:
        lo, hi = f['lo'][0], f['hi'][0]
    with h5py.File(STORAGE / 'data/test.h5') as f:
        x = f['x'][0, :65]

    for got, want in ((inputs['obs_lo'], lo), (inputs['obs_hi'], hi), (inputs['x'], x)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_make_observations_reproduces_obs_h5(tmp_path):
    (tmp_path / 'data').mkdir()
    shutil.copy(STORAGE / 'data/test.h5', tmp_path / 'data/test.h5')

    leval.make_observations(path=tmp_path)

    for freq in ('lo', 'hi'):
        with h5py.File(STORAGE / 'results/obs.h5') as f:
            want = f[freq][:]
        got = leval.load_observations(freq, tmp_path)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_freq_params_and_indices():
    assert leval.freq_params('lo') == (0.05, 8) and leval.freq_params('hi') == (0.25, 1)
    assert leval.parse_indices('0-3,7') == [0, 1, 2, 3, 7]


@pytest.fixture(scope='module')
def evaluated(tmp_path_factory):
    r"""Both packages' ``evaluate`` of ``local_k2_0`` on index 0 of ``lo``,
    64 samples x 16 steps at 0 and 1 corrections (at 8 steps the samples
    leave the attractor and ``log_px`` is ``-inf`` in both). The port reads
    the JAX run's cached particle-filter samples, which the JAX filter
    draws here at 1,024 particles instead of 16,384 (its resampling draws
    M^2 Gumbel variables: 55 s on the CPU at 16,384)."""

    jeval = load_pack('eval')
    root = tmp_path_factory.mktemp('lorenz_eval')
    jpath, tpath = root / 'jax', root / 'torch'
    for path in (jpath, tpath):
        (path / 'results').mkdir(parents=True)
        shutil.copy(STORAGE / 'results/obs.h5', path / 'results/obs.h5')
        (path / 'runs').symlink_to(STORAGE / 'runs')

    jeval.PATH = jpath
    jeval.VPSDE = JStableVPSDE
    jeval.posterior = functools.partial(jeval.posterior, particles=1024)
    jeval.evaluate('local_k2_0', True, 'lo', [0], samples=64, steps=16, corrections=(0, 1), block=1)
    shutil.copytree(jpath / 'results/bpf_lo', tpath / 'results/bpf_lo')

    def draws(i, C):
        return jax_noise(jax.random.fold_in(jax.random.key(1000 + i), C), (64, 65, 3))

    rows = leval.evaluate('local_k2_0', True, 'lo', [0], samples=64, steps=16, corrections=(0, 1), path=tpath,
                          device='cpu', draws=draws)
    return jpath, tpath, rows


def read_rows(csv):
    return {tuple(line.split(',')[:3]): [float(v) for v in line.split(',')[3:]]
            for line in csv.read_text().splitlines()}


def test_evaluate_matches_jax(evaluated):
    r"""The same rows as the JAX package: log-prior, log-likelihood and W1
    (rtol 1e-4 on the ground truth, which reads the same samples; 1e-3 on
    the guided rows, sampled in float32 by two packages)."""

    jpath, tpath, rows = evaluated
    want, got = read_rows(jpath / 'results/stats_lo.csv'), read_rows(tpath / 'results/stats_lo.csv')

    assert set(got) == set(want) == {('0', 'ground-truth', ''), ('0', 'local_k2_0', '0'), ('0', 'local_k2_0', '1')}
    assert set(rows) == set(got)
    assert all(np.isfinite(v).all() for v in want.values())
    for key in want:
        rtol = 1e-4 if key[1] == 'ground-truth' else 1e-3
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=str(key))


def test_evaluate_skips_rows_already_written(evaluated):
    _, tpath, _ = evaluated
    csv = tpath / 'results/stats_lo.csv'
    before = csv.read_text()

    assert leval.evaluate('local_k2_0', True, 'lo', [0], samples=64, steps=16, corrections=(0, 1), path=tpath,
                          device='cpu') == {}
    assert csv.read_text() == before


def test_ensure_bpf_draws_a_posterior(tmp_path):
    r"""Without a cache the port's own filter runs, writes the JAX layout and
    reads it back; its samples track the observations."""

    y = np.load(INPUTS)['obs_lo']
    pairs = leval.ensure_bpf('lo', {0: y}, [0], samples=64, cache=tmp_path, device='cpu')
    again = leval.ensure_bpf('lo', {0: y}, [0], samples=64, cache=tmp_path, device='cpu')

    x, x_ = pairs[0]
    assert x.shape == x_.shape == (64, 65, 3) and (tmp_path / 'idx0.npz').exists()
    assert torch.equal(again[0][0], x) and not torch.equal(x, x_)
    observed = leval.observe_raw(x)[:, ::8, 0].mean(dim=0)
    assert float((observed - t(y[:, 0]).float()).abs().max()) < 0.2


def test_multimodal_matches_jax(tmp_path, monkeypatch):
    r"""``global_0``, 8 samples x 8 steps x 2 corrections through JAX's
    draws, then weak 4D-Var from 2 of them: the same residual (rtol 1e-3),
    the same number of modes, and each 4D-Var result below its start's
    objective."""

    jmm = load_pack('multimodal')
    (tmp_path / 'data').mkdir()
    (tmp_path / 'data/test.h5').symlink_to(STORAGE / 'data/test.h5')
    (tmp_path / 'runs').symlink_to(STORAGE / 'runs')
    monkeypatch.setattr(jmm, 'PATH', tmp_path)
    monkeypatch.setattr(jmm, 'VPSDE', JStableVPSDE)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jmm.main(samples=8, steps=8, corrections=2, var_starts=2)
    text = out.getvalue()
    want_residual = float(re.search(r'obs residual std = ([0-9.]+)', text).group(1))
    want_modes = int(re.search(r'found (\d+) distinct modes', text).group(1))

    x_star = np.load(INPUTS)['x'][:49]
    got = multimodal.main(samples=8, steps=8, corrections=2, var_starts=2, device='cpu', x_star=x_star,
                          draws=jax_noise(jax.random.key(0), (8, 49, 3)), path=tmp_path)

    np.testing.assert_allclose(got['residual'], want_residual, rtol=1e-3, atol=1e-4)
    assert len(got['modes']) == want_modes
    assert all(end < start for start, end in zip(got['objective_start'], got['objective_end']))
