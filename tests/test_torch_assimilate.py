r"""The port's sampler, guidance and the slice as a whole against the JAX
package: a Kolmogorov truth simulated at 64^2 and coarsened to 16^2, then
assimilated in the ``coarse`` scenario by a narrow ``LocalScoreUNet`` with
random weights, 4 steps.

Torch cannot reproduce JAX's noise streams, so the tests draw JAX's own
initial state and per-step, per-correction noise (``fold_in`` of the step,
then of the correction) and feed them through the port's sampler hook.
Everything runs float32 on the CPU.

The JAX samplers run with ``jax.disable_jit()``: under ``jit`` XLA evaluates
``sigma(0) = sqrt(1 - alpha(0)^2 + eta^2)`` as 9.766e-4 instead of 1.000e-3
(float32 cancellation at ``alpha(0) = 1``), which moves the last Langevin
correction by ~1e-2 whenever eps is not proportional to sigma. The port, like
eager JAX, gives 1.000e-3.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.diffusion import VPSDE as JVPSDE
from sda_tpu.diffusion import GaussianScore as JGaussianScore
from sda_tpu.diffusion import LocalScoreUNet as JLocalScoreUNet
from sda_tpu.diffusion import MCScoreNet as JMCScoreNet
from sda_tpu.diffusion import bind_eps as jbind_eps
from sda_tpu.diffusion import make_alpha as jmake_alpha
from sda_tpu.dynamics import KolmogorovFlow as JKolmogorovFlow
from sda_tpu.dynamics import coarsen as jcoarsen
from sda_tpu_torch.diffusion import VPSDE, GaussianScore, bind_eps, make_alpha
from sda_tpu_torch.dynamics import KolmogorovFlow
from sda_tpu_torch.experiments.kolmogorov.assimilate import assimilate, coarse_observation
from sda_tpu_torch.experiments.kolmogorov.generate import simulate
from sda_tpu_torch.experiments.kolmogorov.utils import make_score, make_trajectory_eps
from sda_tpu_torch.train import params_from_flax

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / 'experiments/kolmogorov'))
from assimilate import get_scenario  # noqa: E402

sys.path.pop(0)

NARROW = dict(window=5, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1), activation='SiLU', size=16)


def t(a):
    return torch.from_numpy(np.array(a))


def jax_noise(key, shape):
    r"""JAX's initial state and ``z(i, j)`` of ``VPSDE.sample(key, ...)``."""

    k_init, k_scan = jax.random.split(key)

    def noise(i, j):
        return t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(k_scan, i), j), shape))

    return t(jax.random.normal(k_init, shape)), noise


@pytest.fixture(scope='module')
def truth():
    r"""A 64^2 truth coarsened to 16^2, from JAX (8 frames) and the port."""

    key = jax.random.key(0)
    jk = JKolmogorovFlow(64, dt=0.2, dft_method='matmul')
    xs = jk.trajectory(None, jk.prior(key, (1,)), 10)[2:]
    want = np.asarray(jcoarsen(xs, 4))[:, 0]

    tk = KolmogorovFlow(64, dt=0.2, device='cpu')
    got = simulate(tk, batch=1, length=10, keep=8, coarse=4, noise=t(jax.random.normal(key, (1, 2, 64, 64))))

    return want, got[0]


@pytest.fixture(scope='module')
def scores():
    r"""The narrow window kernel in both packages, random weights at the
    shapes flax ``init`` gives (N(0, 1/fan_in); biases N(0, 1/10))."""

    module = JLocalScoreUNet(
        channels=10, size=16, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1),
        activation=jax.nn.silu,
    )
    shapes = jax.eval_shape(module.init, jax.random.key(1), jnp.zeros((1, 10, 16, 16)), jnp.ones((1,)))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1] or (10,))), jnp.float32),
        shapes['params'],
    )
    kernel = bind_eps(make_score(**NARROW), params_from_flax(jax.tree_util.tree_map(np.asarray, params)))

    return JMCScoreNet(jbind_eps(module, params), order=2), make_trajectory_eps(kernel, window=5)


@pytest.mark.parametrize('name', ['lin', 'cos', 'exp'])
def test_make_alpha(name):
    tt = np.linspace(0, 1, 11).astype(np.float32)

    np.testing.assert_allclose(
        make_alpha(name, 1e-3)(t(tt)).numpy(), np.asarray(jmake_alpha(name, 1e-3)(jnp.asarray(tt))), atol=1e-6,
    )


def gaussian_eps(sde, x, tt):
    r"""The exact eps of unit-variance Gaussian data, which keeps the
    sampler's first steps (``r = mu(t - dt) / mu(t)`` ~ 50-170 near
    ``t = 1``) cancelling as a trained network would."""

    mu, sigma = sde.mu(tt), sde.sigma(tt)
    return sigma * x / (mu**2 + sigma**2)


@pytest.mark.parametrize('corrections', [0, 2])
def test_sampler_matches_jax(corrections):
    r"""``VPSDE.sample`` with an analytic eps, JAX's noise fed in."""

    jsde, tsde = JVPSDE(shape=(3, 4)), VPSDE(shape=(3, 4))

    def jeps(x, tt, c):
        return gaussian_eps(jsde, x, tt) + 0.01 * jnp.tanh(x)

    def teps(x, tt, c):
        return gaussian_eps(tsde, x, tt) + 0.01 * torch.tanh(x)

    key = jax.random.key(3)
    with jax.disable_jit():
        want = jsde.sample(key, (5,), steps=8, corrections=corrections, tau=0.5, eps=jeps)

    init, noise = jax_noise(key, (5, 3, 4))
    got = tsde.sample((5,), steps=8, corrections=corrections, tau=0.5, eps=teps, init=init, noise=noise)

    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_truth_matches_jax(truth):
    want, got = truth

    assert got.shape == (8, 2, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize('detach', [False, True])
def test_gaussian_score_matches_jax(truth, scores, detach):
    r"""One guided eps evaluation: Tweedie estimate plus the observation
    log-likelihood gradient, through the network unless ``detach``."""

    want_truth, _ = truth
    jscore, tscore = scores
    A, y, std, length, gamma = get_scenario('coarse', want_truth, np.random.RandomState(0))
    x = np.random.RandomState(1).randn(2, length, 2, 16, 16).astype(np.float32)
    tt = np.float32(0.7)

    jguided = JGaussianScore(y, A, std, JVPSDE(eps=jscore), gamma=gamma, detach=detach)
    want = np.asarray(jax.jit(jguided.__call__)(jnp.asarray(x), jnp.asarray(tt)))

    tguided = GaussianScore(t(y), coarse_observation, std, VPSDE(eps=tscore), gamma=gamma, detach=detach)
    got = tguided(t(x), torch.tensor(tt)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize('corrections', [0, 1])
def test_slice_matches_jax(truth, scores, corrections):
    r"""Truth -> ``coarse`` observations -> guided posterior sample, against
    ``experiments/kolmogorov/assimilate.py``'s recipe at 4 steps.

    The prior eps is the narrow network plus the exact eps of Gaussian data
    (a random network alone does not cancel ``r x`` in the first steps, and
    the samples would grow to ~1e4).
    """

    want_truth, got_truth = truth
    jnet, tnet = scores
    jsde, tsde = JVPSDE(shape=()), VPSDE(shape=())

    def jscore(x, tt, c=None):
        return gaussian_eps(jsde, x, tt) + 0.01 * jnet(x, tt, c)

    def tscore(x, tt, c=None):
        return gaussian_eps(tsde, x, tt) + 0.01 * tnet(x, tt, c)

    A, y, std, length, gamma = get_scenario('coarse', want_truth, np.random.RandomState(0))
    guided = JGaussianScore(y=y, A=A, std=std, sde=JVPSDE(eps=jscore, shape=()), gamma=gamma)
    sde = JVPSDE(eps=guided, shape=(length, 2, 16, 16))
    key = jax.random.key(2)
    with jax.disable_jit():
        want = np.asarray(sde.sample(key, (2,), steps=4, corrections=corrections, tau=0.5))
    want_residual = float(jnp.std(A(want) - y))

    init, noise = jax_noise(key, (2, length, 2, 16, 16))
    got, residual = assimilate(
        tscore, got_truth, samples=2, steps=4, corrections=corrections, tau=0.5, seed=0,
        init=init, noise=noise,
    )

    assert got.shape == (2, length, 2, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(residual, want_residual, rtol=1e-4)
