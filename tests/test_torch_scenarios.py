r"""The port's Kolmogorov scenario catalog, grid operators and evaluation
against the JAX package, float32 on the CPU: ``upsample`` (bilinear and
nearest) and the ``KolmogorovFlow`` methods that use it, every scenario's
operator and observation at 64^2 and 128^2 with the geometry checks of
``tests/test_assimilate_scenarios.py``, one guided sample per scenario with
a narrow ``LocalScoreUNet`` (widths (8, 16), 16^2, 4 steps) through JAX's
draws, the DPS method, segmented assimilation, the ``circle``
re-simulation, and ``experiments/kolmogorov/eval.py``'s ``main`` with the
same JAX-initialised weights and draws.

The JAX samplers run compiled, as the JAX experiments run them, with one
change made here in the test: ``VPSDE.sigma`` is written
``sqrt((1 - alpha)(1 + alpha) + eta^2)``, equal in exact arithmetic, because
XLA evaluates the package's ``sqrt(1 - alpha^2 + eta^2)`` at ``t = 0`` as
9.766e-4 instead of 1.000e-3 (``ROADMAP.md``, faults, item 1), which moves
the last Langevin correction by ~1e-2. Running them eagerly instead
(``jax.disable_jit()``, as ``tests/test_torch_assimilate.py`` does) takes
~20 s per scenario on the CPU. Unless a test says otherwise the tolerance is
``atol=1e-4``.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.diffusion import VPSDE as JVPSDE
from sda_tpu.diffusion import DPSGaussianScore as JDPSGaussianScore
from sda_tpu.diffusion import GaussianScore as JGaussianScore
from sda_tpu.diffusion import LocalScoreUNet as JLocalScoreUNet
from sda_tpu.diffusion import MCScoreNet as JMCScoreNet
from sda_tpu.diffusion import bind_eps as jbind_eps
from sda_tpu.dynamics import KolmogorovFlow as JKolmogorovFlow
from sda_tpu.dynamics import coarsen as jcoarsen
from sda_tpu.dynamics import upsample as jupsample
from sda_tpu.train import save_params as jsave_params
from sda_tpu_torch.diffusion import VPSDE
from sda_tpu_torch.dynamics import KolmogorovFlow, upsample
from sda_tpu_torch.experiments.kolmogorov import eval as keval
from sda_tpu_torch.experiments.kolmogorov.assimilate import (
    SCENARIOS,
    assimilate,
    get_scenario,
    resimulate,
    scenario_label,
)
from sda_tpu_torch.experiments.kolmogorov.utils import make_score, make_trajectory_eps
from sda_tpu_torch.train import params_from_flax

REPO = Path(__file__).resolve().parents[1]
PACK = REPO / 'experiments/kolmogorov'
NARROW = dict(window=5, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1), activation='SiLU', size=16)


def load_pack(name):
    r"""A module of the JAX Kolmogorov pack, loaded by path under a name of
    its own (every pack calls its helpers ``utils``/``assimilate``)."""

    saved = {n: sys.modules.pop(n, None) for n in ('utils', 'assimilate')}
    sys.path.insert(0, str(PACK))
    try:
        spec = importlib.util.spec_from_file_location(f'kolmogorov_{name}_for_torch', PACK / f'{name}.py')
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
        for n, m in saved.items():
            sys.modules.pop(n, None)
            if m is not None:
                sys.modules[n] = m
    return module


JASSIM = load_pack('assimilate')


class JStableVPSDE(JVPSDE):
    r"""The JAX package's ``VPSDE`` with ``sigma`` free of the float32
    cancellation at ``t = 0`` (see the module's docstring)."""

    def sigma(self, t):
        a = self.alpha(t)
        return jnp.sqrt((1 - a) * (1 + a) + self.eta**2)


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


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_noise(key, shape):
    k_init, k_scan = jax.random.split(key)

    def noise(i, j):
        return t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(k_scan, i), j), shape))

    return t(jax.random.normal(k_init, shape)), noise


def gaussian_eps(sde, x, tt):
    mu, sigma = sde.mu(tt), sde.sigma(tt)
    return sigma * x / (mu**2 + sigma**2)


def narrow_params(seed=1):
    module = JLocalScoreUNet(
        channels=10, size=16, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1), activation=jax.nn.silu,
    )
    shapes = jax.eval_shape(module.init, jax.random.key(1), jnp.zeros((1, 10, 16, 16)), jnp.ones((1,)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1] or (10,))), jnp.float32),
        shapes['params'],
    )
    return module, params


@pytest.fixture(scope='module')
def nets():
    module, params = narrow_params()
    kernel = make_score(**NARROW)
    kernel.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return JMCScoreNet(jbind_eps(module, params), order=2), make_trajectory_eps(kernel, window=5)


# -- Grid operators -----------------------------------------------------------


@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
@pytest.mark.parametrize('r', [2, 4])
def test_upsample_matches_jax(mode, r):
    x = randn(r, 3, 2, 8, 8)

    want = np.asarray(jupsample(jnp.asarray(x), r, mode))
    got = upsample(t(x), r, mode)

    assert got.shape == (3, 2, 8 * r, 8 * r)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_upsample_unknown_mode():
    with pytest.raises(ValueError):
        upsample(torch.zeros(4, 4), 2, 'bicubic')


def test_kolmogorov_methods_match_jax():
    jchain = JKolmogorovFlow(32, dt=0.2, dft_method='matmul')
    chain = KolmogorovFlow(32, dt=0.2, device='cpu')
    x = np.asarray(jchain.prior(jax.random.key(0), (2,)))

    w_j, _ = jchain.to_spectral(jnp.asarray(x))
    w_t, _ = chain.to_spectral(t(x))
    np.testing.assert_allclose(chain.vorticity_field(w_t).numpy(), np.asarray(jchain.vorticity_field(w_j)), atol=1e-4)
    np.testing.assert_allclose(KolmogorovFlow.upsample(t(x), 2).numpy(),
                               np.asarray(JKolmogorovFlow.upsample(jnp.asarray(x), 2)), atol=1e-5)
    np.testing.assert_allclose(KolmogorovFlow.vorticity(t(x)).numpy(),
                               np.asarray(JKolmogorovFlow.vorticity(jnp.asarray(x))), atol=1e-5)


# -- Scenario operators -------------------------------------------------------

CASES = [('coarse', {}), ('subsample', {'stride': 8}), ('subsample', {'stride': 16, 'offset': 7}),
         ('subsample', {'stride': 2}), ('extrapolate', {}), ('patch', {}), ('saturation', {}), ('circle', {}),
         ('loop', {}), ('vorticity', {})]


@pytest.mark.parametrize('size', [64, 128])
@pytest.mark.parametrize('name,kwargs', CASES, ids=[scenario_label(n, **k) for n, k in CASES])
def test_scenario_matches_jax(name, kwargs, size):
    r"""``A(x)``, ``y``, ``std``, ``length`` and ``gamma`` of each scenario,
    with the observation noise drawn from the same ``RandomState``."""

    x_star = randn(size, 16, 2, size, size)
    jA, jy, jstd, jlength, jgamma = JASSIM.get_scenario(name, x_star, np.random.RandomState(0), **kwargs)
    A, y, std, length, gamma = get_scenario(name, t(x_star), np.random.RandomState(0), **kwargs)

    assert (std, length, gamma) == (jstd, jlength, jgamma)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)

    x = randn(1, 2, length, 2, size, size)
    np.testing.assert_allclose(A(t(x)).numpy(), np.asarray(jA(jnp.asarray(x))), atol=1e-5)


def test_scenario_catalog():
    assert set(SCENARIOS) == {'coarse', 'subsample', 'extrapolate', 'patch', 'saturation', 'loop', 'vorticity',
                              'circle'}
    with pytest.raises(ValueError):
        get_scenario('rings', torch.zeros(8, 2, 16, 16), np.random.RandomState(0))


def gradient_is_finite(A, x):
    x = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((A(x) ** 2).sum(), x)
    return bool(torch.isfinite(g).all())


def test_extrapolate_geometry():
    rng = np.random.RandomState(0)
    x_star = t(rng.standard_normal((16, 2, 64, 64)).astype(np.float32))

    A, y, std, length, gamma = get_scenario('extrapolate', x_star, rng)

    assert y.shape == (3, 2, 8, 8) and std == 0.01
    assert gradient_is_finite(A, x_star[:length])
    x2 = x_star[:length].clone()
    x2[..., :4, :4] += 7.0
    assert torch.allclose(A(x_star[:length]), A(x2))


def test_subsample_strides_and_offset():
    rng = np.random.RandomState(0)
    x_star = t(rng.standard_normal((16, 2, 64, 64)).astype(np.float32))

    for stride in (2, 4, 8, 16):
        A, y, std, length, gamma = get_scenario('subsample', x_star, rng, stride=stride)
        assert y.shape == (8, 2, 64 // stride, 64 // stride) and std == 0.1

    A, y, std, length, gamma = get_scenario('subsample', x_star, rng, stride=16, offset=7)
    assert y.shape == (8, 2, 4, 4)
    assert torch.equal(A(x_star[:8]), x_star[:8][..., 7::16, 7::16])


def test_saturation_geometry():
    rng = np.random.RandomState(0)
    x_star = t(rng.standard_normal((16, 2, 64, 64)).astype(np.float32))

    A, y, std, length, gamma = get_scenario('saturation', x_star, rng)

    assert length == 8 and y.shape == (3, 12, 12) and std == 0.05
    assert bool((A(x_star[:length]).abs() < 1.0).all())
    assert gradient_is_finite(A, x_star[:length])


def test_size_relative_geometry_128():
    rng = np.random.RandomState(0)
    x_star = t(rng.standard_normal((16, 2, 128, 128)).astype(np.float32))

    A, y, std, length, gamma = get_scenario('patch', x_star, rng)
    assert y.shape == (6, 2, 32, 32)
    assert torch.equal(A(x_star[:length]), x_star[:length][..., ::3, :, 48:80, 48:80])

    assert get_scenario('extrapolate', x_star, rng)[1].shape == (3, 2, 16, 16)
    assert get_scenario('saturation', x_star, rng)[1].shape == (3, 24, 24)
    assert get_scenario('circle', x_star, rng)[1].shape == (128, 128)
    A, y, std, length, gamma = get_scenario('loop', x_star, rng)
    assert y.shape == (2, 128, 128) and length == 127 and gamma == 1e-1
    assert get_scenario('loop', x_star, rng, length_override=128)[3] == 128
    assert gradient_is_finite(A, x_star[:8])


def test_circle_geometry():
    rng = np.random.RandomState(0)
    x_star = t(rng.standard_normal((16, 2, 64, 64)).astype(np.float32))

    A, y, std, length, gamma = get_scenario('circle', x_star, rng)

    assert length == 8 and y.shape == (64, 64) and std == 0.2
    mask = y > 0
    assert 0 < int(mask.sum()) < 64 * 64
    assert torch.allclose(y[mask], torch.tensor(0.6))
    x2 = x_star[:length].clone()
    x2[:-1] += 3.0
    assert torch.allclose(A(x_star[:length]), A(x2))
    assert gradient_is_finite(A, x_star[:length])


# -- Guided samples -----------------------------------------------------------

SAMPLED = [('coarse', {}), ('subsample', {'stride': 4}), ('subsample', {'stride': 8, 'offset': 3}),
           ('extrapolate', {}), ('patch', {}), ('saturation', {}), ('circle', {}), ('loop', {'length': 12}),
           ('vorticity', {})]


def jax_posterior(jnet, name, x_star, method='sda', steps=4, corrections=1, **kwargs):
    r"""``experiments/kolmogorov/assimilate.py``'s sampler with the JAX
    components (its own ``assimilate`` reads files)."""

    A, y, std, length, gamma = JASSIM.get_scenario(
        name, x_star, np.random.RandomState(0), kwargs.get('stride', 8), kwargs.get('offset', 0),
        length_override=kwargs.get('length'),
    )
    jsde = JStableVPSDE(shape=())

    def jscore(x, tt, c=None):
        return gaussian_eps(jsde, x, tt) + 0.01 * jnet(x, tt, c)

    if method == 'sda':
        guided = JGaussianScore(y=y, A=A, std=std, sde=JStableVPSDE(eps=jscore, shape=()), gamma=gamma)
    else:
        guided = JDPSGaussianScore(y=y, A=A, sde=JStableVPSDE(eps=jscore, shape=()), zeta=1.0)
    sde = JStableVPSDE(eps=guided, shape=(length, 2, 16, 16))
    key = jax.random.key(4)
    xs = np.asarray(sde.sample(key, (2,), steps=steps, corrections=corrections, tau=0.5))

    return xs, float(jnp.std(A(xs) - y)), key, length


def port_score(tnet):
    tsde = VPSDE(shape=())

    def tscore(x, tt, c=None):
        return gaussian_eps(tsde, x, tt) + 0.01 * tnet(x, tt, c)

    return tscore


@pytest.mark.parametrize('name,kwargs', SAMPLED, ids=[scenario_label(n, k.get('stride', 8), k.get('offset', 0))
                                                       + ('_l' if 'length' in k else '') for n, k in SAMPLED])
def test_guided_sample_matches_jax(nets, name, kwargs):
    r"""Two samples, 4 steps, 1 correction. Float32 rounding grows with the
    state, which the random network lets reach ~600, so the tolerance is
    ``atol = 1e-4 + 1e-5 max|x|``."""

    jnet, tnet = nets
    x_star = randn(3, 16, 2, 16, 16)
    want, want_residual, key, length = jax_posterior(jnet, name, x_star, **kwargs)

    init, noise = jax_noise(key, (2, length, 2, 16, 16))
    got, residual = assimilate(port_score(tnet), t(x_star), samples=2, steps=4, corrections=1, tau=0.5, seed=0,
                               init=init, noise=noise, scenario=name, **kwargs)

    assert got.shape == (2, length, 2, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 + 1e-5 * np.abs(want).max())
    np.testing.assert_allclose(residual, want_residual, rtol=1e-4)


def test_dps_sample_matches_jax(nets):
    jnet, tnet = nets
    x_star = randn(3, 16, 2, 16, 16)
    want, want_residual, key, length = jax_posterior(jnet, 'subsample', x_star, method='dps', stride=4)

    init, noise = jax_noise(key, (2, length, 2, 16, 16))
    got, residual = assimilate(port_score(tnet), t(x_star), samples=2, steps=4, corrections=1, tau=0.5, seed=0,
                               init=init, noise=noise, scenario='subsample', method='dps', stride=4)

    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 + 1e-5 * np.abs(want).max())
    np.testing.assert_allclose(residual, want_residual, rtol=1e-4)


@pytest.mark.parametrize('solver,corrections', [('ddim', 1), ('ddim', 0), ('dpm2m', 1)])
def test_segmented_assimilation_is_bitwise_one_run(nets, solver, corrections):
    r"""Segments, with and without per-chunk remat, give one run's samples
    bit for bit (``dpm2m`` with corrections is first order; without them
    its multistep history restarts at each segment, as in the JAX
    package)."""

    _, tnet = nets
    x_star = t(randn(3, 16, 2, 16, 16))

    def run(segments, remat):
        score = make_trajectory_eps(tnet.kernel, window=5, chunk=2, remat=remat)
        return assimilate(port_score(score), x_star, samples=2, steps=6, corrections=corrections, seed=1,
                          scenario='subsample', stride=4, solver=solver, segments=segments, remat=remat)

    one, residual = run(1, False)
    for segments, remat in ((3, False), (6, True)):
        xs, r = run(segments, remat)
        assert torch.equal(xs, one) and r == residual


def test_circle_resimulation_matches_jax():
    r"""The ``circle`` check's recipe (upsample the first frame, simulate,
    coarsen back, correlate), here at 64^2 from 16^2 samples."""

    xs = randn(5, 1, 4, 2, 16, 16)
    chain = JKolmogorovFlow(64, dt=0.2, dft_method='matmul')
    y0 = jupsample(jnp.asarray(xs[0, 0]), 4)
    sim = chain.trajectory(jax.random.key(0), y0, length=3)
    sim = jcoarsen(jnp.concatenate([y0[None], sim]), 4)
    want = float(jnp.sum(sim * xs[0])) / float(jnp.linalg.norm(sim) * jnp.linalg.norm(xs[0]))

    got_sim, got = resimulate(t(xs), size=64)

    np.testing.assert_allclose(got_sim.numpy(), np.asarray(sim), atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cli_refuses_mesh_and_render():
    r"""Rendering is still refused (it waits for ``viz``); ``--mesh`` is parsed
    as the JAX script parses it (``tests/test_torch_parallel.py`` runs the
    sharded score it builds)."""

    from sda_tpu_torch.experiments.kolmogorov.assimilate import main, parse_mesh

    assert parse_mesh('sp=4') == {'sp': 4}
    assert parse_mesh('dp=2,sp=4') == {'dp': 2, 'sp': 4}
    with pytest.raises(NotImplementedError, match='viz'):
        main(render=True, device='cpu')


# -- Evaluation ---------------------------------------------------------------


@pytest.fixture(scope='module')
def eval_storage(tmp_path_factory):
    r"""A storage directory both packages' ``eval.main`` read: a narrow run
    (JAX weights in flax's msgpack) and a 3 x 16-frame test set at 16^2."""

    import h5py

    path = tmp_path_factory.mktemp('kolmogorov_storage')
    run = path / 'runs/narrow'
    run.mkdir(parents=True)
    (run / 'config.json').write_text(json.dumps(dict(NARROW, hidden_channels=[8, 16], hidden_blocks=[1, 1])))
    _, params = narrow_params(seed=2)
    params = jax.tree_util.tree_map(lambda p: p * 0.1, params)
    jsave_params(params, run / 'state.msgpack')

    (path / 'data').mkdir()
    with h5py.File(path / 'data/test.h5', 'w') as f:
        f.create_dataset('x', data=randn(7, 3, 16, 2, 16, 16) * 0.5)
    return path


def test_eval_main_matches_jax(eval_storage, tmp_path, monkeypatch):
    r"""``main`` at 2 unconditional windows x 4 steps (the posterior at
    ``eval.py``'s fixed 4 x 256 steps x 1 correction), both packages with
    the same weights and JAX's draws; the CSV rows agree (rtol 1e-3: the
    posterior runs 256 guided steps) and a second run is skipped."""

    import shutil

    jeval = load_pack('eval')
    jpath, tpath = tmp_path / 'jax', tmp_path / 'torch'
    shutil.copytree(eval_storage, jpath)
    shutil.copytree(eval_storage, tpath)
    monkeypatch.setattr(jeval, 'PATH', jpath)
    monkeypatch.setattr(jeval, 'VPSDE', JStableVPSDE)

    jeval.main('narrow', samples=2, steps=4, seed=0)

    init_u = t(jax.random.normal(jax.random.split(jax.random.key(0))[0], (2, 10, 16, 16)))
    init_p, noise_p = jax_noise(jax.random.key(1), (4, 16, 2, 16, 16))
    metrics = keval.main('narrow', samples=2, steps=4, seed=0, device='cpu', path=tpath,
                         draws={'unconditional': init_u, 'posterior': (init_p, noise_p)})

    want = [float(v) for v in (jpath / 'results/eval.csv').read_text().split(',')[1:]]
    got_row = (tpath / 'results/eval.csv').read_text().strip().split(',')
    assert got_row[0] == 'narrow'
    assert all(np.isfinite(want))
    np.testing.assert_allclose([float(v) for v in got_row[1:]], want, rtol=1e-3)
    assert metrics['residual_ratio'] == pytest.approx(want[3], rel=1e-3)

    assert keval.main('narrow', samples=2, steps=4, seed=0, device='cpu', path=tpath) is None
    assert len((tpath / 'results/eval.csv').read_text().splitlines()) == 1
