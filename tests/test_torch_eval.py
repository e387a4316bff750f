r"""The port's evaluation stack against the JAX package, float32 on the CPU:
the distance matrix, the exact EMD, Sinkhorn and MMD (rtol 1e-5 against
JAX on the same numpy-seeded inputs), the bootstrap particle filter (JAX's
transition noise and resampling draws fed through the port's hooks), L-BFGS
and weak 4D-Var (held to the minimum, since torch's L-BFGS and optax's are
different algorithms), and the energy spectra (JAX's ``'fft'`` transform
against the port's plain DFT, rtol 1e-4). The behaviours that
``tests/test_eval.py`` and ``tests/test_spectra_metric.py`` check of the JAX
package are checked of the port too.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.dynamics import KolmogorovFlow as JKolmogorovFlow
from sda_tpu.dynamics import NoisyLorenz63 as JNoisyLorenz63
from sda_tpu.eval import bpf as jbpf
from sda_tpu.eval import emd as jemd
from sda_tpu.eval import energy_spectrum as jenergy_spectrum
from sda_tpu.eval import lbfgs_minimize as jlbfgs_minimize
from sda_tpu.eval import mmd as jmmd
from sda_tpu.eval import pairwise_distances as jpairwise_distances
from sda_tpu.eval import sinkhorn as jsinkhorn
from sda_tpu.eval import spectrum_distance as jspectrum_distance
from sda_tpu.eval import weak_4d_var as jweak_4d_var
from sda_tpu_torch import eval as port_eval
from sda_tpu_torch.dynamics import KolmogorovFlow, NoisyLorenz63
from sda_tpu_torch.eval import (
    bpf,
    emd,
    energy_spectrum,
    lbfgs_minimize,
    mmd,
    pairwise_distances,
    sinkhorn,
    spectrum_distance,
    weak_4d_var,
    weak_4d_var_objective,
)
from sda_tpu_torch.experiments.kolmogorov.eval import wasserstein_gate
from sda_tpu_torch.experiments.lorenz import utils as lu

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    r"""One torch thread per test: the suite runs several worker processes
    at once, whose thread pools would otherwise compete for the cores."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def randn(seed, *shape, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) + shift).astype(np.float32)


def test_exports():
    for name in ('bpf', 'emd', 'mmd', 'pairwise_distances', 'sinkhorn', 'energy_spectrum',
                 'spectrum_distance', 'lbfgs_minimize', 'weak_4d_var'):
        assert callable(getattr(port_eval, name)), name


# -- Metrics ------------------------------------------------------------------


@pytest.mark.parametrize('shape', [(32, 3), (24, 2, 4, 4)])
def test_pairwise_distances_matches_jax(shape):
    x, y = randn(0, *shape), randn(1, 40, *shape[1:], shift=0.5)

    want = np.asarray(jpairwise_distances(jnp.asarray(x), jnp.asarray(y)))
    got = pairwise_distances(t(x), t(y)).numpy()

    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pairwise_distances_clamps_at_zero():
    x = randn(2, 16, 8) * 100
    d = pairwise_distances(t(x), t(x))

    assert bool(torch.isfinite(d).all()) and float(d.min()) >= 0


@pytest.mark.parametrize('seed', [0, 1])
def test_emd_matches_jax(seed):
    x, y = randn(seed, 64, 3), randn(seed + 10, 64, 3, shift=1.0)

    np.testing.assert_allclose(emd(t(x), t(y)), jemd(jnp.asarray(x), jnp.asarray(y)), rtol=1e-5)


def test_emd_identical_sets_is_zero():
    x = t(randn(0, 64, 3))

    assert emd(x, x) < 1e-3


def test_emd_translation():
    x = t(randn(0, 256, 2)) * 0.01
    y = x + torch.tensor([3.0, 4.0])

    np.testing.assert_allclose(emd(x, y), 5.0, rtol=0.01)


def test_emd_is_symmetric():
    x, y = t(randn(1, 128, 4)), t(randn(2, 128, 4, shift=1.0))

    np.testing.assert_allclose(emd(x, y), emd(y, x), rtol=1e-5)


def test_emd_refuses_unequal_counts_and_reports_nan():
    with pytest.raises(ValueError):
        emd(t(randn(0, 8, 2)), t(randn(1, 9, 2)))

    x = t(randn(0, 8, 2))
    y = x.clone()
    y[3, 0] = float('inf')
    assert np.isnan(emd(x, y))


@pytest.mark.parametrize('reg', [0.05, 0.5])
def test_sinkhorn_matches_jax(reg):
    x, y = randn(3, 48, 2), randn(4, 64, 2, shift=2.0)

    want = float(jsinkhorn(jnp.asarray(x), jnp.asarray(y), reg=reg, iterations=100))
    got = float(sinkhorn(t(x), t(y), reg=reg, iterations=100))

    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sinkhorn_approximates_emd():
    x, y = t(randn(3, 128, 2)), t(randn(4, 128, 2, shift=2.0))

    exact = emd(x, y)
    approx = float(sinkhorn(x, y, reg=0.01, iterations=500))

    assert abs(approx - exact) / exact < 0.1


def test_wasserstein_gate_calibration():
    r"""The Kolmogorov eval's gate: ~1 for frames of the same distribution
    with unequal counts, clearly above for a shifted one."""

    test_frames = t(randn(8, 96, 2, 8, 8))
    same = t(randn(9, 40, 2, 8, 8))

    _, floor, ratio_same = wasserstein_gate(same, test_frames)
    _, _, ratio_shift = wasserstein_gate(same + 2.0, test_frames)

    assert floor > 0
    assert 0.8 < ratio_same < 1.3
    assert ratio_shift > ratio_same * 1.2


def test_wasserstein_gate_matches_jax():
    pack = REPO / 'experiments/kolmogorov'
    saved = {n: sys.modules.pop(n, None) for n in ('utils', 'assimilate')}
    sys.path.insert(0, str(pack))
    try:
        spec = importlib.util.spec_from_file_location('kolmogorov_eval_for_torch', pack / 'eval.py')
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.pop(0)
        for n, m in saved.items():
            sys.modules.pop(n, None)
            if m is not None:
                sys.modules[n] = m

    test_frames, frames = randn(8, 64, 2, 8, 8), randn(9, 30, 2, 8, 8, shift=0.3)
    want = mod.wasserstein_gate(jnp.asarray(frames), jnp.asarray(test_frames))
    got = wasserstein_gate(t(frames), t(test_frames))

    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_mmd_matches_jax():
    x, y = randn(5, 64, 3), randn(6, 80, 3, shift=0.5)

    np.testing.assert_allclose(float(mmd(t(x), t(y))), float(jmmd(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5,
                               atol=1e-6)


def test_mmd_zero_for_same_distribution():
    x, y, z = t(randn(5, 512, 3)), t(randn(6, 512, 3)), t(randn(7, 512, 3, shift=2.0))

    close, far = float(mmd(x, y)), float(mmd(x, z))

    assert close < 0.05
    assert far > 10 * close


# -- Bootstrap particle filter ----------------------------------------------


@pytest.mark.parametrize('step', [1, 3])
def test_bpf_matches_jax(step):
    r"""The port's filter with JAX's transition noise and JAX's categorical
    draws (taken on the port's own log-weights) reproduces JAX's histories
    to float32 rounding."""

    m, n = 64, 4
    jchain, chain = JNoisyLorenz63(dt=0.025), NoisyLorenz63(dt=0.025, device='cpu')
    x0 = np.asarray(jchain.prior(jax.random.key(0), (m,)))
    y = randn(1, n, 1) * 0.5

    def jlog_w(yi, xi):
        return jnp.sum(jax.scipy.stats.norm.logpdf(jchain.preprocess(xi)[..., :1], yi, 0.5), axis=-1)

    key = jax.random.key(2)
    want = np.asarray(jbpf(key, jnp.asarray(x0), jnp.asarray(y), jchain.transition, jlog_w, step))

    keys = jax.random.split(key, n)
    calls = iter(range(n * step))

    def transition(x, generator):
        c = next(calls)
        k = jax.random.split(keys[c // step], step + 1)[c % step]
        mean, std = chain.moments(x)
        return mean + std * t(jax.random.normal(k, tuple(x.shape)))

    def log_w(yi, xi):
        return (-((chain.preprocess(xi)[..., :1] - yi) ** 2 / 0.25 + np.log(2 * np.pi * 0.25)) / 2).sum(dim=-1)

    def resample(i, logw):
        k = jax.random.split(keys[i], step + 1)[-1]
        return t(jax.random.categorical(k, jnp.asarray(logw.numpy()), shape=(m,)))

    got = bpf(t(x0), t(y), transition, log_w, step, resample=resample).numpy()

    assert got.shape == (m, n * step + 1, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_bpf_linear_gaussian_posterior():
    r"""On a 1-D linear-Gaussian model the filter matches the Kalman
    posterior: x' = a x + noise(q), y = x + noise(r)."""

    a, q, r = 0.9, 0.1, 0.05
    m = 2**14
    ys = np.array([0.5, 0.8, 0.2, -0.1, 0.4], np.float32)

    mean, var = 0.0, 1.0
    for y in ys:
        mean, var = a * mean, a**2 * var + q
        gain = var / (var + r)
        mean, var = mean + gain * (y - mean), (1 - gain) * var

    generator = torch.Generator().manual_seed(9)

    def transition(x, g):
        return a * x + np.sqrt(q) * torch.randn(x.shape, generator=g)

    def log_likelihood(y, x):
        return -0.5 * (y - x[:, 0]) ** 2 / r

    x0 = torch.randn((m, 1), generator=torch.Generator().manual_seed(8))
    hist = bpf(x0, t(ys)[:, None], transition, log_likelihood, step=1, generator=generator)
    samples = hist[:, -1, 0].numpy()

    np.testing.assert_allclose(samples.mean(), mean, atol=0.05)
    np.testing.assert_allclose(samples.var(), var, rtol=0.25)


def test_bpf_history_shape_and_step():
    m, n, step = 128, 4, 3
    generator = torch.Generator().manual_seed(0)

    hist = bpf(
        torch.randn(m, 2, generator=generator), torch.randn(n, 2, generator=generator),
        lambda x, g: x + 0.1 * torch.randn(x.shape, generator=g),
        lambda y, x: -((y - x) ** 2).sum(dim=-1), step=step, generator=generator,
    )

    assert hist.shape == (m, n * step + 1, 2)
    assert bool(torch.isfinite(hist).all())


def test_posterior_matches_jax_statistically():
    r"""The Lorenz ground-truth posterior at 2,048 particles: the port's and
    JAX's samples, from their own streams, are as close as two JAX runs
    (W1 within 1.5x the JAX seed-to-seed distance, plus 0.2)."""

    pack = REPO / 'experiments/lorenz/utils.py'
    spec = importlib.util.spec_from_file_location('lorenz_pack_utils_for_torch_eval', pack)
    jutils = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jutils)

    y = np.load(REPO / 'tests/golden/lorenz_eval_inputs.npz')['obs_lo']
    chain = JNoisyLorenz63(dt=0.025)

    def A(x):
        return chain.preprocess(x)[..., :1]

    j0 = np.asarray(jutils.posterior(jax.random.key(0), jnp.asarray(y, jnp.float32), A, 0.05, 8, 2048))[:512]
    j1 = np.asarray(jutils.posterior(jax.random.key(1), jnp.asarray(y, jnp.float32), A, 0.05, 8, 2048))[:512]
    got = lu.posterior(t(y.astype(np.float32)), lambda x: NoisyLorenz63.preprocess(x)[..., :1], 0.05, 8, 2048,
                       generator=torch.Generator().manual_seed(0), device='cpu')[:512]

    assert got.shape == j0.shape == (512, 65, 3)
    floor = jemd(jnp.asarray(j0), jnp.asarray(j1))
    assert emd(got, t(j0)) < 1.5 * floor + 0.2


# -- L-BFGS and weak 4D-Var -------------------------------------------------


def test_lbfgs_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])

    x = lbfgs_minimize(lambda x: torch.sum((x - target) ** 2), torch.zeros(3), iterations=50)

    np.testing.assert_allclose(x.numpy(), target.numpy(), atol=1e-4)


def test_lbfgs_rosenbrock():
    def rosen(x):
        return torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    x = lbfgs_minimize(rosen, torch.zeros(4), iterations=200)
    want = np.asarray(jlbfgs_minimize(
        lambda x: jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2), jnp.zeros(4), iterations=200,
    ))

    np.testing.assert_allclose(x.numpy(), 1.0, atol=1e-3)
    np.testing.assert_allclose(x.numpy(), want, atol=1e-3)


def test_weak_4d_var_recovers_smooth_trajectory():
    generator = torch.Generator().manual_seed(10)
    truth = torch.cumsum(0.1 * torch.randn(20, 1, generator=generator), dim=0)
    y = truth + 0.01 * torch.randn(truth.shape, generator=generator)

    def log_prior(x):
        return -torch.sum((x[1:] - x[:-1]) ** 2) / (2 * 0.1**2)

    def log_likelihood(y, x):
        return -torch.sum((y - x) ** 2) / (2 * 0.01**2)

    x0 = torch.zeros_like(truth)
    x = weak_4d_var(x0, y, log_prior, log_likelihood, iterations=100)

    rmse_before = float(torch.sqrt(torch.mean((x0 - truth) ** 2)))
    rmse_after = float(torch.sqrt(torch.mean((x - truth) ** 2)))
    assert rmse_after < 0.2 * rmse_before


def test_weak_4d_var_lorenz_matches_jax_objective():
    r"""A small Lorenz problem (17 frames, the third coordinate of every 4th
    observed): from the same start, the port's L-BFGS reaches JAX's
    objective within 1e-3 relative."""

    pack = REPO / 'experiments/lorenz/utils.py'
    spec = importlib.util.spec_from_file_location('lorenz_pack_utils_for_torch_var', pack)
    jutils = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jutils)

    x_star = np.load(REPO / 'tests/golden/lorenz_eval_inputs.npz')['x'][:17]
    y = np.random.RandomState(0).normal(x_star[::4, 2:], 0.1).astype(np.float32)
    x0 = (NoisyLorenz63.postprocess(t(x_star)) + t(randn(3, 17, 3))).numpy()

    def j_A(x):
        return JNoisyLorenz63.preprocess(x)[..., 2:]

    def A(x):
        return NoisyLorenz63.preprocess(x)[..., 2:]

    want = np.asarray(jutils.weak_4d_var(jnp.asarray(x0), jnp.asarray(y), A=j_A, sigma=0.1, step=4))
    got = lu.weak_4d_var(t(x0), t(y), A=A, sigma=0.1, step=4)

    objective = weak_4d_var_objective(
        t(x0)[0], t(y), lu.log_prior, lambda y, x: lu.log_likelihood(y, x, A, 0.1, 4),
    )
    j_want, j_got, j_start = float(objective(t(want))), float(objective(got)), float(objective(t(x0)))

    assert j_got < j_start
    np.testing.assert_allclose(j_got, j_want, rtol=1e-3)


# -- Spectra ----------------------------------------------------------------


@pytest.mark.parametrize('size', [32, 64])
def test_energy_spectrum_matches_jax(size):
    x = randn(size, 3, 2, size, size)

    kw, ew = jenergy_spectrum(jnp.asarray(x))
    kg, eg = energy_spectrum(t(x))

    np.testing.assert_array_equal(kg, kw)
    np.testing.assert_allclose(eg, ew, rtol=1e-4)


def smooth(seed, n, size, power):
    r"""Random velocity fields whose spectrum falls as ``(1 + k)^-power``:
    every shell well above float32 rounding, unlike the solver's prior,
    whose band-pass leaves the highest shells at rounding level."""

    x = randn(seed, n, 2, size, size)
    k = np.sqrt(np.fft.fftfreq(size, 1 / size)[:, None] ** 2 + np.fft.rfftfreq(size, 1 / size)[None, :] ** 2)
    return np.fft.irfft2(np.fft.rfft2(x) / (1 + k) ** power, s=(size, size)).astype(np.float32)


@pytest.mark.parametrize('size', [32, 64])
def test_spectrum_distance_matches_jax(size):
    for a, b in ((smooth(1, 4, size, 1.0), randn(2, 4, 2, size, size)),
                 (smooth(3, 4, size, 1.5), smooth(4, 6, size, 1.0))):
        want = jspectrum_distance(jnp.asarray(a), jnp.asarray(b))
        got = spectrum_distance(t(a), t(b))
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_energy_spectrum_parseval():
    chain = KolmogorovFlow(size=64, dt=0.2, device='cpu')
    x = chain.prior((4,), generator=torch.Generator().manual_seed(0))

    _, spec = energy_spectrum(x)
    total_physical = float(0.5 * torch.mean(torch.sum(x**2, dim=1)))

    np.testing.assert_allclose(spec.sum(), total_physical, rtol=0.05)


def test_energy_spectrum_peak_location():
    n, k0 = 64, 4
    b = 2 * np.pi / n * np.arange(n)
    u = np.tile(np.sin(k0 * b), (n, 1))
    x = torch.tensor(np.stack([u, np.zeros_like(u)])[None], dtype=torch.float32)

    centers, spec = energy_spectrum(x)

    assert centers[np.argmax(spec)] == k0
    assert spec[np.argmax(spec)] > 0.99 * spec.sum()


def test_spectrum_distance_self_is_small():
    chain = KolmogorovFlow(size=64, dt=0.2, device='cpu')
    x = chain.prior((8,), generator=torch.Generator().manual_seed(1))
    y = chain.prior((8,), generator=torch.Generator().manual_seed(2))

    same = spectrum_distance(x, y)
    far = spectrum_distance(x, torch.randn(x.shape, generator=torch.Generator().manual_seed(3)))

    assert same < 0.2
    assert far > 5 * same
